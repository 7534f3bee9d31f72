# -*- coding: utf-8 -*-
"""The post pass's float64 bank of orientation-averaged cylinders on the
card: one launch of ``csrc/cyl_bank.cu`` computes the whole (R·N, Nq)
partial-intensity bank of a CylindersIsotropic fit, ff²·w on the fit grid
or, for slit-smeared data, (ff²(locs) @ smear_w)·w, with the trapezoid of
``models/cylinders.py::_cyl_iso_ff_ab`` and the port's own J1
(``ops/special.py``) held in registers.

The route (:func:`applies`) follows what the binding declares: a model
whose form factor is the cylinders' orientation average
(``_cyl_iso_ff``) on 1D data, smeared or not, either ``useAspect``.
:func:`post.histogram._bank_f64` launches :func:`run_cyl_bank` where
:func:`launches_on` says so (such a bank on a CUDA device); everything
else, and every CPU call, keeps the eager path
(:func:`post.histogram._bank_eager`), which is this kernel's plain
version.  :func:`launch_shape` reports the launch (``chip_smoke.py``'s
``kernels`` line prints it).  The weight w =
volume^comp2, the radius and the length 2·half of each contribution are
computed in PyTorch (:func:`bank_inputs`).  The library is built and
bound with the chunk kernels (``ops/mc_kernel.py``, ``KERNELS``);
the grid, the checks and the counted launch are shared with the worm's
bank kernel (``ops/bank_common.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.cylinders import _cyl_half, _cyl_iso_ff
from . import bank_common, mc_kernel

LIBRARY = "cyl_bank"            # csrc/cyl_bank.cu


class BankInputs(NamedTuple):
    """What the kernel reads, float64 and contiguous on one device."""
    grid: torch.Tensor               # (Nq, n_off): q (n_off 1) or locs
    smear_w: Optional[torch.Tensor]  # (n_off,), None where unsmeared
    radius: torch.Tensor             # (B,)
    length: torch.Tensor             # (B,): 2·half-length
    weight: torch.Tensor             # (B,): volume^comp2
    x: torch.Tensor                  # (n - 2,): linspace(0, 1, n)[1:-1]
    s: torch.Tensor                  # (n - 2,): sqrt(1 - x²)
    step: float                      # the trapezoid's step


def applies(bound, data) -> bool:
    """True when the bank of *bound* on *data* is the kernel's: the
    model's form factor is the cylinders' orientation average and the
    data are 1D (smeared or not)."""
    return bound.model.ff is _cyl_iso_ff and data.psi is None


def launches_on(bound, data, device) -> bool:
    """True when a post pass of *bound* on *data* on *device* launches the
    kernel (and so needs its library)."""
    return torch.device(device).type == "cuda" and applies(bound, data)


def bank_inputs(bound, data, comp2: float, rset: torch.Tensor
                ) -> BankInputs:
    """The kernel's inputs for contributions *rset* (R, N, P) on rset's
    device, each per-contribution value computed as the eager bank
    computes it."""
    model, dev = bound.model, rset.device
    grid, smear_w = bank_common.grid_inputs(bound, data, dev)
    flat = rset.reshape(-1, rset.shape[-1])
    pd = bound.pdict(flat)

    def per_contribution(v):
        return bank_common.per_contribution(v, len(flat), dev)

    n = int(pd["intDiv"])
    x, step = np.linspace(0.0, 1.0, n, retstep=True)
    x = torch.as_tensor(x[1:-1], dtype=torch.float64, device=dev)
    return BankInputs(
        grid=grid, smear_w=smear_w,
        radius=per_contribution(pd["radius"]),
        length=per_contribution(2.0 * _cyl_half(pd)),
        weight=per_contribution(model.volume(pd) ** comp2),
        x=x, s=torch.sqrt(1.0 - x * x), step=float(step))


def _check(inp: BankInputs):
    """Raises unless *inp* is what the kernel takes: float64 and
    contiguous on one CUDA device, the shapes of :class:`BankInputs`."""
    if inp.grid.dim() != 2 or inp.x.dim() != 1:
        raise ValueError("grid must be (Nq, n_off) and x (n - 2,)")
    b, m = inp.radius.numel(), inp.x.numel()
    bank_common.check(inp, {"grid": tuple(inp.grid.shape), "radius": (b,),
                            "length": (b,), "weight": (b,), "x": (m,),
                            "s": (m,)}, "run_cyl_bank")


def _params(inp: BankInputs, out: torch.Tensor):
    """The kernel's parameter struct for *inp* and the bank *out*."""
    def ptr(t):
        return t.data_ptr() if t is not None else None
    nq, n_off = inp.grid.shape
    return mc_kernel._CylBankParams(
        grid=ptr(inp.grid), smear_w=ptr(inp.smear_w),
        radius=ptr(inp.radius), length=ptr(inp.length),
        weight=ptr(inp.weight), x=ptr(inp.x), s=ptr(inp.s), out=ptr(out),
        step=inp.step, n_contribs=inp.radius.numel(), nq=nq, n_off=n_off,
        n_nodes=inp.x.numel() + 2,
        device=mc_kernel._device_index(inp.radius.device))


def run_cyl_bank(inp: BankInputs) -> torch.Tensor:
    """Launches the kernel on the current stream of the inputs' device
    and returns the bank (B, Nq); raises on inputs it does not take and on
    a refused launch.  Counts ``run_cyl_bank.launches`` and, under
    ``profiling.recording()``, ``post.bank.kernel``."""
    _check(inp)
    return bank_common.launch(LIBRARY, _params, inp, run_cyl_bank)


run_cyl_bank.launches = 0


def launch_shape(inp: BankInputs) -> dict:
    """The kernel's launch shape for *inp*: lanes per output, threads,
    blocks, registers and local memory bytes per thread."""
    _check(inp)
    return mc_kernel._shape(LIBRARY, _params(inp, None))
