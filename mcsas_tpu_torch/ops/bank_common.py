# -*- coding: utf-8 -*-
"""What the post pass's bank kernels share on the Python side (their
wrappers are ``ops/cyl_bank.py`` and ``ops/kho_bank.py``; their shared
device code is ``csrc/bank_common.cuh``): the grid they read, one float64
value a contribution, the check of their inputs and the counted launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from . import mc_kernel


def grid_inputs(bound, data, dev):
    """(grid (Nq, n_off), smear_w (n_off,) or None) float64 on *dev*:
    the fit q (n_off 1), or for slit-smeared data the points of the
    smearing offsets and their weights, as the eager bank takes them."""
    smearing = data.uses_smearing and bound.model.can_smear
    grid = torch.as_tensor(np.asarray(data.locs if smearing else data.q,
                                      np.float64)).to(dev)
    smear_w = (torch.as_tensor(np.asarray(data.smear_w, np.float64)).to(dev)
               if smearing else None)
    return grid.reshape(len(data.q), -1), smear_w


def per_contribution(v, n: int, dev) -> torch.Tensor:
    """*v* (a tensor or a number) as *n* contiguous float64 values on
    *dev*, one a contribution."""
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float64,
                                              device=dev),
                              (n,)).contiguous()


def check(inp, want: dict, wrapper: str):
    """Raises unless the tensors of *inp* named in *want* ({name:
    shape}) are float64 and contiguous in their shapes on the device of
    ``inp.radius``, a CUDA device; a grid of several offsets needs its
    ``smear_w``, and the bank a contribution and a point."""
    dev = inp.radius.device
    nq, n_off = inp.grid.shape
    if n_off > 1 and inp.smear_w is None:
        raise ValueError(f"a grid of {n_off} offsets a point needs smear_w")
    if inp.smear_w is not None:
        want = dict(want, smear_w=(n_off,))
    for name, shape in want.items():
        t = getattr(inp, name)
        if (t.device != dev or t.dtype != torch.float64
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float64 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}"
                             + ("" if t.is_contiguous()
                                else ", not contiguous"))
    if inp.radius.numel() < 1 or nq < 1 or n_off < 1:
        raise ValueError("the bank needs a contribution and a point")
    if dev.type != "cuda":
        raise ValueError(f"{wrapper} launches the CUDA kernel: its inputs "
                         f"must lie on a CUDA device, not {dev}")


def launch(library: str, params, inp, wrapper) -> torch.Tensor:
    """Launches *library*'s kernel with ``params(inp, out)`` on the
    current stream of the inputs' device into a new bank ``out`` (B, Nq)
    and returns it; raises on a refused launch.  Counts
    ``wrapper.launches`` and, under ``profiling.recording()``,
    ``post.bank.kernel``."""
    dev = inp.radius.device
    out = torch.empty((inp.radius.numel(), inp.grid.shape[0]),
                      dtype=torch.float64, device=dev)
    mc_kernel._launch(library, params(inp, out), dev)
    wrapper.launches += 1
    profiling.count("post.bank.kernel")
    return out
