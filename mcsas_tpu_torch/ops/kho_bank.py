# -*- coding: utf-8 -*-
"""The post pass's float64 bank of the Kholodenko worm on the card: one
launch of ``csrc/kho_bank.cu`` computes the whole (R·N, Nq) bank of a
model whose form factor is the worm's (``_kho_ff``) on 1D data
(:func:`applies`), ff²·w or, smeared, (ff²(locs) @ smear_w)·w, with the
converged Filon/Boole rule of ``models/chains.py::_kho_conv_rule`` (its
513-node recurrences, Si and the 64-node tail) and the port's own J1 in
registers and shared memory.  The route (``ops/bank_route.py``) launches
it on a CUDA device; everything else keeps the eager bank
(``post/histogram.py::_bank_eager``), its plain version.  The radius,
the Kuhn length and x = 3·contour/kuhn come from PyTorch
(:func:`bank_inputs`), the rule's constants from the modules that define
the plain version (:func:`rule_constants`); the rest is shared with the
cylinder's bank kernel (``ops/bank_common.py``), and
``ops/cuda_lib.py`` builds and launches the kernel this module declares.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import chains
from . import bank_common, cuda_lib, special


class _KhoBankParams(ctypes.Structure):
    """Mirror of ``KhoBankParams`` in csrc/kho_bank.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "grid", "smear_w", "radius", "kuhn", "x", "weight", "rule",
            "out")]
        + [(name, ctypes.c_double) for name in ("z_cut", "si_cut")]
        + [(name, ctypes.c_int32) for name in (
            "n_contribs", "nq", "n_off", "n_steps", "n_tail", "n_lag",
            "n_taylor", "device")])


ENTRY = cuda_lib.Entry("kho_bank", _KhoBankParams,
                       ("threads", "blocks", "smem_bytes", "registers",
                        "local_bytes"))


class BankInputs(NamedTuple):
    """What the kernel reads, float64 and contiguous on one device."""
    grid: torch.Tensor               # (Nq, n_off): q (n_off 1) or locs
    smear_w: Optional[torch.Tensor]  # (n_off,), None where unsmeared
    radius: torch.Tensor             # (B,)
    kuhn: torch.Tensor               # (B,): the Kuhn length
    x: torch.Tensor                  # (B,): 3·contour/kuhn
    weight: torch.Tensor             # (B,): volume^comp2
    rule: torch.Tensor               # (RULE_VALUES,): rule_constants()


N_TAIL = len(chains._TAIL_NODES)
N_LAG = len(special._SI_LAG_X)
N_TAYLOR = len(special._SI_TAYLOR)
RULE_VALUES = 2 * N_TAIL + 3 * N_LAG + N_TAYLOR


def rule_constants(device) -> torch.Tensor:
    """The rule's (RULE_VALUES,) float64 constants on *device*, in the
    kernel's order and as the plain version rounds them: the tail's
    Gauss-Legendre nodes and weights, Si's Gauss-Laguerre u², w and w·u,
    Si's Taylor coefficients of y²ᵏ."""
    u, w = special._SI_LAG_X, special._SI_LAG_W
    parts = (chains._TAIL_NODES, chains._TAIL_WEIGHTS, u * u, w, w * u,
             special._SI_TAYLOR)
    return torch.as_tensor(np.concatenate(parts),
                           dtype=torch.float64).to(device)


def applies(bound, data) -> bool:
    """True when the bank of *bound* on *data* is the kernel's: the
    model's form factor is the worm's and the data are 1D (smeared or
    not)."""
    return bound.model.ff is chains._kho_ff and data.psi is None


def bank_inputs(bound, data, comp2: float, rset: torch.Tensor
                ) -> BankInputs:
    """The kernel's inputs for contributions *rset* (R, N, P) on rset's
    device, each per-contribution value computed as the eager bank
    computes it."""
    shared, pd, each = bank_common.contributions(bound, data, comp2, rset)
    return BankInputs(**shared, radius=each(pd["radius"]),
                      kuhn=each(pd["lenKuhn"]),
                      x=each(3.0 * pd["lenContour"] / pd["lenKuhn"]),
                      rule=rule_constants(rset.device))


def _check(inp: BankInputs):
    """Raises unless *inp* is what the kernel takes: float64 and
    contiguous on one CUDA device, the shapes of :class:`BankInputs`."""
    b = inp.radius.numel()
    bank_common.check(inp, {"kuhn": (b,), "x": (b,),
                            "rule": (RULE_VALUES,)}, "run_kho_bank")


def _params(inp: BankInputs, out: Optional[torch.Tensor]):
    """The kernel's parameter struct for *inp* and the bank *out*."""
    return _KhoBankParams(
        **bank_common.params(inp, out), kuhn=inp.kuhn.data_ptr(),
        x=inp.x.data_ptr(), rule=inp.rule.data_ptr(), z_cut=chains._Z_CUT,
        si_cut=special._SI_CUT, n_steps=2 * chains._N_HALF, n_tail=N_TAIL,
        n_lag=N_LAG, n_taylor=N_TAYLOR)


def run_kho_bank(inp: BankInputs) -> torch.Tensor:
    """Launches the kernel on the current stream of the inputs' device
    and returns the bank (B, Nq); raises on inputs it does not take and on
    a refused launch.  Counts ``run_kho_bank.launches`` and, under
    ``profiling.recording()``, ``post.bank.kernel``."""
    _check(inp)
    return bank_common.launch(ENTRY, _params, inp, run_kho_bank)


run_kho_bank.launches = 0
run = run_kho_bank                   # the name the route calls


def launch_shape(inp: BankInputs) -> dict:
    """The kernel's launch shape for *inp*: threads and blocks, shared
    memory bytes per block, registers and local memory bytes per
    thread."""
    _check(inp)
    return cuda_lib.shape(ENTRY, _params(inp, None))
