# -*- coding: utf-8 -*-
"""Proposal generators on an explicit ``torch.Generator``.

Distribution semantics preserved (reference:
src/mcsas/bases/algorithm/numbergenerator.py:28-31,168-189 and the range
scaling at bases/algorithm/parameter.py:66-84):

- ``uniform``:   lo + U(0,1)·(hi−lo)
- ``logdecN``:   lo + g·(hi−lo) with g = (10^U(0,N) − 1)/10^N — inverse-log
  probability over N decades ("RandomExponential{1,2,3}")

The generator's device decides where the samples are drawn.
"""
from __future__ import annotations

import torch

DECADES = {"logdec1": 1.0, "logdec2": 2.0, "logdec3": 3.0}


def draw_unit(gen: torch.Generator, generators, count=None,
              dtype=torch.float32) -> torch.Tensor:
    """Draws unit-interval samples, one column per generator.

    Returns shape (P,) if count is None else (count, P).
    """
    p = len(generators)
    shape = (p,) if count is None else (count, p)
    un = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    cols = []
    for i, g in enumerate(generators):
        col = un[..., i]
        if g in DECADES:
            n = DECADES[g]
            col = (10.0 ** (col * n) - 1.0) / (10.0 ** n)
        elif g != "uniform":
            raise ValueError(f"unknown generator {g!r}")
        cols.append(col)
    return torch.stack(cols, dim=-1)


def range_vectors(ranges, dtype=torch.float32, device="cpu"):
    """The (lo, hi) vectors (P,) of the per-parameter ranges, as tensors
    of *dtype* on *device*.  Each is a copy from the host, which on the
    card waits for the stream: a caller that draws once a segment builds
    them once and passes them on (``ChunkSpec.bounds``)."""
    lo = torch.tensor([r[0] for r in ranges], dtype=dtype, device=device)
    hi = torch.tensor([r[1] for r in ranges], dtype=dtype, device=device)
    return lo, hi


def scale_to_ranges(unit_samples: torch.Tensor, ranges,
                    vectors=None) -> torch.Tensor:
    """Maps unit samples (…, P) onto the per-parameter (lo, hi) ranges;
    *vectors* are their :func:`range_vectors` on the samples' dtype and
    device where the caller holds them."""
    lo, hi = vectors or range_vectors(ranges, unit_samples.dtype,
                                      unit_samples.device)
    return unit_samples * (hi - lo) + lo


def draw_params(gen: torch.Generator, bound, count=None,
                dtype=torch.float32, vectors=None) -> torch.Tensor:
    """Draws proposal parameter vectors for a BoundModel's active set
    (*vectors* as for :func:`scale_to_ranges`)."""
    un = draw_unit(gen, bound.generators, count=count, dtype=dtype)
    return scale_to_ranges(un, bound.ranges, vectors)


def local_candidates(cur: torch.Tensor, uniforms: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor,
                     local_scale: float) -> torch.Tensor:
    """Local-move proposal transform: the slot's current value scaled by
    exp of a symmetric uniform, clipped to the active ranges — the same
    operations as the JAX scan path (mcsas_tpu/core/engine.py:120-132).

    *cur* is (..., P); *uniforms* is (..., k_local, P) unit uniforms.
    """
    factor = whole_vectors(
        lambda u: torch.exp((2.0 * u - 1.0) * local_scale), uniforms)
    return torch.clamp(cur[..., None, :] * factor, lo, hi)


# PyTorch's CPU elementwise loops run two vectors (32 float32 lanes at
# AVX-512) at a time and finish a tensor's remainder one element at a
# time, and there pow, exp, sin and cos round differently (libm) from the
# vector loop (Sleef): a value would depend on where it sits in its batch.
CPU_VECTOR_ROWS = 32


def whole_vectors(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an *fn* that maps each row x[..., :] of x (..., P) on
    its own to a row (..., W), or to one 0-dim value.  On the CPU, x runs
    as one flat batch (B, P) padded with copies of its last row to a
    multiple of :data:`CPU_VECTOR_ROWS` rows, so that every tensor of
    fn's that keeps the batch in front runs through whole vectors and a
    row's result does not depend on the batch it came in (a repetition
    shard computes what the whole ensemble computes for it); the result
    is shaped back to (..., W).  On the card it is ``fn(x)``."""
    if x.device.type != "cpu":
        return fn(x)
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    pad = (-n) % CPU_VECTOR_ROWS
    if pad and n:
        flat = torch.cat([flat, flat[-1:].expand(pad, -1)])
    out = fn(flat)
    if out.dim() == 0:
        return out
    return out[:n].reshape(*x.shape[:-1], out.shape[-1])
