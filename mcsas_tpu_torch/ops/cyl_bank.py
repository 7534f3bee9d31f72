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
bound with the chunk kernels (``ops/mc_kernel.py``, ``KERNELS``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.cylinders import _cyl_half, _cyl_iso_ff
from ..utils import profiling
from . import mc_kernel

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
    f64 = torch.float64
    smearing = data.uses_smearing and model.can_smear
    grid = torch.as_tensor(np.asarray(data.locs if smearing else data.q,
                                      np.float64)).to(dev)
    smear_w = (torch.as_tensor(np.asarray(data.smear_w, np.float64)).to(dev)
               if smearing else None)
    flat = rset.reshape(-1, rset.shape[-1])
    pd = bound.pdict(flat)

    def per_contribution(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=f64, device=dev),
                                  (len(flat),)).contiguous()

    n = int(pd["intDiv"])
    x, step = np.linspace(0.0, 1.0, n, retstep=True)
    x = torch.as_tensor(x[1:-1], dtype=f64, device=dev)
    return BankInputs(
        grid=grid.reshape(len(data.q), -1), smear_w=smear_w,
        radius=per_contribution(pd["radius"]),
        length=per_contribution(2.0 * _cyl_half(pd)),
        weight=per_contribution(model.volume(pd) ** comp2),
        x=x, s=torch.sqrt(1.0 - x * x), step=float(step))


def _check(inp: BankInputs):
    """Raises unless *inp* is what the kernel takes: float64 and
    contiguous on one CUDA device, the shapes of :class:`BankInputs`."""
    dev = inp.radius.device
    if inp.grid.dim() != 2 or inp.x.dim() != 1:
        raise ValueError("grid must be (Nq, n_off) and x (n - 2,)")
    nq, n_off = inp.grid.shape
    b, m = inp.radius.numel(), inp.x.numel()
    if n_off > 1 and inp.smear_w is None:
        raise ValueError(f"a grid of {n_off} offsets a point needs smear_w")
    want = {"grid": (nq, n_off), "radius": (b,), "length": (b,),
            "weight": (b,), "x": (m,), "s": (m,)}
    if inp.smear_w is not None:
        want["smear_w"] = (n_off,)
    for name, shape in want.items():
        t = getattr(inp, name)
        if (t.device != dev or t.dtype != torch.float64
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float64 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}"
                             + ("" if t.is_contiguous()
                                else ", not contiguous"))
    if b < 1 or nq < 1 or n_off < 1:
        raise ValueError("the bank needs a contribution and a point")
    if dev.type != "cuda":
        raise ValueError(f"run_cyl_bank launches the CUDA kernel: its "
                         f"inputs must lie on a CUDA device, not {dev}")


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
    dev = inp.radius.device
    out = torch.empty((inp.radius.numel(), inp.grid.shape[0]),
                      dtype=torch.float64, device=dev)
    mc_kernel._launch(LIBRARY, _params(inp, out), dev)
    run_cyl_bank.launches += 1
    profiling.count("post.bank.kernel")
    return out


run_cyl_bank.launches = 0


def launch_shape(inp: BankInputs) -> dict:
    """The kernel's launch shape for *inp*: lanes per output, threads,
    blocks, registers and local memory bytes per thread."""
    _check(inp)
    return mc_kernel._shape(LIBRARY, _params(inp, None))
