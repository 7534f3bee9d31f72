# -*- coding: utf-8 -*-
"""Polymer chain models (the JAX package's mcsas_tpu/models/chains.py):
the Debye Gaussian chain.

Reference math: src/mcsas/models/gaussianchain.py:12-73.  The Kholodenko
worm comes with the table-model slice (ROADMAP Queue A).
"""
from __future__ import annotations

import torch

from ..ops.special import ipow
from ..utils.units import ANGSTROM_SLD, NM, NoUnit
from .base import ParamSpec, SASModel


def gauss_debye_over_u(u: torch.Tensor) -> torch.Tensor:
    """sqrt(2·(expm1(−u)+u))/u, stable near u→0 (limit 1), with the
    series below |u| < 0.3 (float32) or 1e-3 (float64).  As in the JAX
    package the closed form uses exp(−u) − 1 + u, not expm1: the
    cancellation-prone small-u regime is the series branch's."""
    thr = 0.3 if u.dtype == torch.float32 else 1e-3
    small = u.abs() < thr
    us = torch.where(small, torch.ones_like(u), u)
    closed = torch.sqrt(2.0 * (torch.exp(-us) - 1.0 + us)) / us
    # 2(expm1(−u)+u)/u² = 1 − u/3 + u²/12 − u³/60 + u⁴/360 …
    series = torch.sqrt(1.0 + u * (-1.0 / 3.0 + u * (
        1.0 / 12.0 + u * (-1.0 / 60.0 + u / 360.0))))
    return torch.where(small, series, closed)


def _gauss_ff(q, p):
    beta = p["bp"] - (p["k"] * ipow(p["rg"], 2)) * p["etas"]
    u = ipow(q * p["rg"], 2)
    res = gauss_debye_over_u(u) * beta
    return torch.where(q <= 0.0, beta * torch.ones_like(res), res)


def _gauss_volume(p):
    return p["k"] * ipow(p["rg"], 2)


GaussianChain = SASModel(
    name="GaussianChain",
    elementwise_q=True,
    can_smear=True,
    doc="Debye Gaussian polymer coil with excess scattering length β "
        "(SASfit Gauss2)",
    params=(
        ParamSpec("rg", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 1e2)), generator="logdec1",
                  is_fit=True, display_name="radius of gyration, Rg"),
        ParamSpec("bp", NM.to_si(100.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="uniform",
                  is_fit=True,
                  display_name="scattering length of the polymer"),
        ParamSpec("etas", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  active_range=ANGSTROM_SLD.to_si((0.1, 10.0)),
                  generator="uniform", is_fit=True,
                  display_name="scattering length density of the solvent"),
        ParamSpec("k", 1.0, NoUnit, (0.0, float("inf")),
                  active_range=(0.1, 10.0), generator="uniform", is_fit=True,
                  display_name="volumetric scaling factor of Rg"),
    ),
    ff=_gauss_ff,
    volume=_gauss_volume,
    default_active=("rg",),
)
