# -*- coding: utf-8 -*-
"""The post pass's float64 bank of the Kholodenko worm on the card: one
launch of ``csrc/kho_bank.cu`` computes the whole (R·N, Nq)
partial-intensity bank of a worm fit, ff²·w on the fit grid or, for
slit-smeared data, (ff²(locs) @ smear_w)·w, with the converged
Filon/Boole rule of ``models/chains.py::_kho_conv_rule`` (its 513-node
recurrences, Si and the 64-node tail) and the port's own J1
(``ops/special.py``) held in registers and shared memory.

The route (:func:`applies`) follows what the binding declares: a model
whose form factor is the worm's (``_kho_ff``) on 1D data, smeared or not.
:func:`post.histogram._bank_f64` launches :func:`run_kho_bank` where
:func:`launches_on` says so (such a bank on a CUDA device); everything
else, and every CPU call, keeps the eager path
(:func:`post.histogram._bank_eager`), which is this kernel's plain
version.  :func:`launch_shape` reports the launch (``chip_smoke.py``'s
``kernels`` line prints it).  The weight w = volume^comp2, the radius,
the Kuhn length and x = 3·contour/kuhn of each contribution are computed
in PyTorch (:func:`bank_inputs`), as the eager bank computes them; the
rule's constants come from the modules that define the plain version
(:func:`rule_constants`).  The library is built and bound with the chunk
kernels (``ops/mc_kernel.py``, ``KERNELS``);
the grid, the checks and the counted launch are shared with the cylinder's
bank kernel (``ops/bank_common.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import chains
from . import bank_common, mc_kernel, special

LIBRARY = "kho_bank"            # csrc/kho_bank.cu


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

    return BankInputs(
        grid=grid, smear_w=smear_w,
        radius=per_contribution(pd["radius"]),
        kuhn=per_contribution(pd["lenKuhn"]),
        x=per_contribution(3.0 * pd["lenContour"] / pd["lenKuhn"]),
        weight=per_contribution(model.volume(pd) ** comp2),
        rule=rule_constants(dev))


def _check(inp: BankInputs):
    """Raises unless *inp* is what the kernel takes: float64 and
    contiguous on one CUDA device, the shapes of :class:`BankInputs`."""
    if inp.grid.dim() != 2:
        raise ValueError("grid must be (Nq, n_off)")
    b = inp.radius.numel()
    bank_common.check(inp, {"grid": tuple(inp.grid.shape), "radius": (b,),
                            "kuhn": (b,), "x": (b,), "weight": (b,),
                            "rule": (RULE_VALUES,)}, "run_kho_bank")


def _params(inp: BankInputs, out: Optional[torch.Tensor]):
    """The kernel's parameter struct for *inp* and the bank *out*."""
    def ptr(t):
        return t.data_ptr() if t is not None else None
    nq, n_off = inp.grid.shape
    return mc_kernel._KhoBankParams(
        grid=ptr(inp.grid), smear_w=ptr(inp.smear_w),
        radius=ptr(inp.radius), kuhn=ptr(inp.kuhn), x=ptr(inp.x),
        weight=ptr(inp.weight), rule=ptr(inp.rule), out=ptr(out),
        z_cut=chains._Z_CUT, si_cut=special._SI_CUT,
        n_contribs=inp.radius.numel(), nq=nq, n_off=n_off,
        n_steps=2 * chains._N_HALF, n_tail=N_TAIL, n_lag=N_LAG,
        n_taylor=N_TAYLOR,
        device=mc_kernel._device_index(inp.radius.device))


def run_kho_bank(inp: BankInputs) -> torch.Tensor:
    """Launches the kernel on the current stream of the inputs' device
    and returns the bank (B, Nq); raises on inputs it does not take and on
    a refused launch.  Counts ``run_kho_bank.launches`` and, under
    ``profiling.recording()``, ``post.bank.kernel``."""
    _check(inp)
    return bank_common.launch(LIBRARY, _params, inp, run_kho_bank)


run_kho_bank.launches = 0


def launch_shape(inp: BankInputs) -> dict:
    """The kernel's launch shape for *inp*: threads and blocks, shared
    memory bytes per block, registers and local memory bytes per
    thread."""
    _check(inp)
    return mc_kernel._shape(LIBRARY, _params(inp, None))
