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


def scale_to_ranges(unit_samples: torch.Tensor, ranges) -> torch.Tensor:
    """Maps unit samples (…, P) onto the per-parameter (lo, hi) ranges."""
    kw = dict(dtype=unit_samples.dtype, device=unit_samples.device)
    lo = torch.tensor([r[0] for r in ranges], **kw)
    hi = torch.tensor([r[1] for r in ranges], **kw)
    return unit_samples * (hi - lo) + lo


def draw_params(gen: torch.Generator, bound, count=None,
                dtype=torch.float32) -> torch.Tensor:
    """Draws proposal parameter vectors for a BoundModel's active set."""
    un = draw_unit(gen, bound.generators, count=count, dtype=dtype)
    return scale_to_ranges(un, bound.ranges)


def local_candidates(cur: torch.Tensor, uniforms: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor,
                     local_scale: float) -> torch.Tensor:
    """Local-move proposal transform: the slot's current value scaled by
    exp of a symmetric uniform, clipped to the active ranges — the same
    operations as the JAX scan path (mcsas_tpu/core/engine.py:120-132).

    *cur* is (..., P); *uniforms* is (..., k_local, P) unit uniforms.
    """
    factor = torch.exp((2.0 * uniforms - 1.0) * local_scale)
    return torch.clamp(cur[..., None, :] * factor, lo, hi)
