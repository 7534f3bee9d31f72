# -*- coding: utf-8 -*-
"""What the post pass's bank kernels share on the Python side: the grid
a bank is evaluated on (which their plain version, the eager bank, reads
too), the prologue of each wrapper's inputs, the input check, the
struct's shared fields and the counted launch.  Each wrapper
(``ops/bank_route.py`` lists them) declares its form factor
(``applies``), struct, C entry and own inputs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import profiling
from . import cuda_lib


def grid_inputs(data, smearing: bool, dev):
    """(grid, smear_w) float64 on *dev*: the points a bank is evaluated
    at, the fit q (Nq,) or, where *smearing*, the points of the smearing
    offsets (Nq, n_off) and their weights (n_off,) (else None)."""
    grid = torch.as_tensor(np.asarray(data.locs if smearing else data.q,
                                      np.float64)).to(dev)
    smear_w = (torch.as_tensor(np.asarray(data.smear_w, np.float64)).to(dev)
               if smearing else None)
    return grid, smear_w


def contributions(bound, data, comp2: float, rset: torch.Tensor):
    """The prologue of a bank kernel's inputs for contributions *rset*
    (R, N, P) on rset's device, computed as the eager bank computes it:
    ``(shared, pd, each)``, *shared* the inputs every bank kernel reads
    (grid (Nq, n_off), smear_w (n_off,) or None, weight volume^comp2
    (B,)), *pd* ``bound.pdict`` of the (B, P) contributions and
    ``each(v)`` *v* (a tensor or a number) as B contiguous float64
    values."""
    grid, smear_w = grid_inputs(
        data, data.uses_smearing and bound.model.can_smear, rset.device)
    flat = rset.reshape(-1, rset.shape[-1])
    pd = bound.pdict(flat)

    def each(v):
        return torch.broadcast_to(torch.as_tensor(
            v, dtype=torch.float64, device=rset.device),
            (len(flat),)).contiguous()
    shared = dict(grid=grid.reshape(len(data.q), -1), smear_w=smear_w,
                  weight=each(bound.model.volume(pd) ** comp2))
    return shared, pd, each


def check(inp, want: dict, wrapper: str):
    """Raises unless the grid of *inp* is (Nq, n_off) and its grid,
    radius and weight and the tensors named in *want* ({name: shape}) are
    float64 and contiguous in their shapes on the device of
    ``inp.radius``, a CUDA device; a grid of several offsets needs its
    ``smear_w``, and the bank a contribution and a point."""
    if inp.grid.dim() != 2:
        raise ValueError("grid must be (Nq, n_off)")
    dev = inp.radius.device
    nq, n_off = inp.grid.shape
    if n_off > 1 and inp.smear_w is None:
        raise ValueError(f"a grid of {n_off} offsets a point needs smear_w")
    b = inp.radius.numel()
    want = dict(want, grid=(nq, n_off), radius=(b,), weight=(b,))
    if inp.smear_w is not None:
        want["smear_w"] = (n_off,)
    for name, shape in want.items():
        cuda_lib.require(name, getattr(inp, name), torch.float64, shape, dev)
    if b < 1 or nq < 1 or n_off < 1:
        raise ValueError("the bank needs a contribution and a point")
    if dev.type != "cuda":
        raise ValueError(f"{wrapper} launches the CUDA kernel: its inputs "
                         f"must lie on a CUDA device, not {dev}")


def params(inp, out: Optional[torch.Tensor]) -> dict:
    """The fields every bank kernel's parameter struct has, for *inp*
    and the bank *out* (None for a shape query): the pointers of the
    grid, smear_w, radius, weight and out, and the sizes and device."""
    nq, n_off = inp.grid.shape
    return dict({k: cuda_lib.ptr(t) for k, t in (
        ("grid", inp.grid), ("smear_w", inp.smear_w), ("radius", inp.radius),
        ("weight", inp.weight), ("out", out))},
        n_contribs=inp.radius.numel(), nq=nq, n_off=n_off,
        device=cuda_lib.device_index(inp.radius.device))


def launch(entry: cuda_lib.Entry, make_params, inp, wrapper
           ) -> torch.Tensor:
    """Launches *entry*'s kernel with ``make_params(inp, out)`` on the
    current stream of the inputs' device into a new bank ``out`` (B, Nq)
    and returns it; raises on a refused launch.  Counts
    ``wrapper.launches`` and, under ``profiling.recording()``,
    ``post.bank.kernel``."""
    dev = inp.radius.device
    out = torch.empty((inp.radius.numel(), inp.grid.shape[0]),
                      dtype=torch.float64, device=dev)
    cuda_lib.launch(entry, make_params(inp, out), dev)
    wrapper.launches += 1
    profiling.count("post.bank.kernel")
    return out
