# -*- coding: utf-8 -*-
"""The post pass's float64 bank of orientation-averaged cylinders on the
card: one launch of ``csrc/cyl_bank.cu`` computes the whole (R·N, Nq)
bank of a model whose form factor is ``_cyl_iso_ff`` on 1D data
(:func:`applies`), ff²·w or, smeared, (ff²(locs) @ smear_w)·w, with the
trapezoid of ``models/cylinders.py::_cyl_iso_ff_ab`` and the port's own
J1 in registers.  The route (``ops/bank_route.py``) launches it on a
CUDA device; everything else keeps the eager bank
(``post/histogram.py::_bank_eager``), its plain version.  The radius,
the length 2·half and the trapezoid's nodes come from PyTorch
(:func:`bank_inputs`); the rest is shared with the worm's bank kernel
(``ops/bank_common.py``), and ``ops/cuda_lib.py`` builds and launches
the kernel this module declares.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.cylinders import _cyl_half, _cyl_iso_ff
from . import bank_common, cuda_lib


class _CylBankParams(ctypes.Structure):
    """Mirror of ``CylBankParams`` in csrc/cyl_bank.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "grid", "smear_w", "radius", "length", "weight", "x", "s",
            "out")]
        + [("step", ctypes.c_double)]
        + [(name, ctypes.c_int32) for name in (
            "n_contribs", "nq", "n_off", "n_nodes", "device")])


ENTRY = cuda_lib.Entry("cyl_bank", _CylBankParams,
                       ("group", "threads", "blocks", "registers",
                        "local_bytes"))


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


def bank_inputs(bound, data, comp2: float, rset: torch.Tensor
                ) -> BankInputs:
    """The kernel's inputs for contributions *rset* (R, N, P) on rset's
    device, each per-contribution value computed as the eager bank
    computes it."""
    shared, pd, each = bank_common.contributions(bound, data, comp2, rset)
    x, step = np.linspace(0.0, 1.0, int(pd["intDiv"]), retstep=True)
    x = torch.as_tensor(x[1:-1], dtype=torch.float64, device=rset.device)
    return BankInputs(**shared, radius=each(pd["radius"]),
                      length=each(2.0 * _cyl_half(pd)), x=x,
                      s=torch.sqrt(1.0 - x * x), step=float(step))


def _check(inp: BankInputs):
    """Raises unless *inp* is what the kernel takes: float64 and
    contiguous on one CUDA device, the shapes of :class:`BankInputs`."""
    b, m = inp.radius.numel(), inp.x.numel()
    bank_common.check(inp, {"length": (b,), "x": (m,), "s": (m,)},
                      "run_cyl_bank")


def _params(inp: BankInputs, out: Optional[torch.Tensor]):
    """The kernel's parameter struct for *inp* and the bank *out*."""
    return _CylBankParams(
        **bank_common.params(inp, out), length=inp.length.data_ptr(),
        x=inp.x.data_ptr(), s=inp.s.data_ptr(), step=inp.step,
        n_nodes=inp.x.numel() + 2)


def run_cyl_bank(inp: BankInputs) -> torch.Tensor:
    """Launches the kernel on the current stream of the inputs' device
    and returns the bank (B, Nq); raises on inputs it does not take and on
    a refused launch.  Counts ``run_cyl_bank.launches`` and, under
    ``profiling.recording()``, ``post.bank.kernel``."""
    _check(inp)
    return bank_common.launch(ENTRY, _params, inp, run_cyl_bank)


run_cyl_bank.launches = 0
run = run_cyl_bank                   # the name the route calls


def launch_shape(inp: BankInputs) -> dict:
    """The kernel's launch shape for *inp*: lanes per output, threads,
    blocks, registers and local memory bytes per thread."""
    _check(inp)
    return cuda_lib.shape(ENTRY, _params(inp, None))
