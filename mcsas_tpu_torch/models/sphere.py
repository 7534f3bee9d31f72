# -*- coding: utf-8 -*-
"""Sphere and LMA dense-sphere (hard-sphere structure factor) models.

Reference math: src/mcsas/models/sphere.py:12-65 and
src/mcsas/models/lmadensesphere.py:13-102.  Written with plain Python
operators, so that a sub-expression of fixed parameters alone (Python
floats) runs in float64 and is rounded once where it meets a tensor, as
in the JAX package; the CUDA chunk kernel repeats that rule.
"""
from __future__ import annotations

import math

import torch

from ..ops.special import ipow, py_G_over_A, sphere_ff
from ..utils.units import ANGSTROM_SLD, Fraction, NM, NoUnit
from .base import ParamSpec, SASModel

_PI43 = 4.0 * math.pi / 3.0


def _sphere_volume(p):
    return _PI43 * p["radius"] ** 3


def _sphere_absvolume(p):
    return _sphere_volume(p) * p["sld"] ** 2


def _sphere_surface(p):
    return 4.0 * math.pi * p["radius"] * p["radius"]


def _sphere_formfactor(q, p):
    return sphere_ff(q * p["radius"])


Sphere = SASModel(
    name="Sphere",
    elementwise_q=True,
    doc="Rayleigh sphere form factor F = 3(sin qr − qr cos qr)/(qr)³",
    can_smear=True,
    params=(
        ParamSpec("radius", NM.to_si(10.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 1000.0)), generator="uniform",
                  is_fit=True, display_name="Sphere radius"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="scattering length density difference"),
    ),
    ff=_sphere_formfactor,
    volume=_sphere_volume,
    absvolume=_sphere_absvolume,
    surface=_sphere_surface,
    default_active=("radius",),
)


def lma_standoff(mf, mu):
    """The standoff multiplier: *mf*, or the auto value (0.634/μ)^(1/3)
    for the sentinel −1.  ``mf`` is not fittable, so it is always a
    Python float."""
    return (0.634 / mu) ** (1.0 / 3.0) if mf == -1.0 else mf


def lma_coefficients(mu):
    """The LMA-PY coefficients α, β, γ of the volume fraction μ
    (Pedersen 1994 eqs. 15-17), integer powers in JAX's order."""
    d4 = ipow(1.0 - mu, 4)
    alpha = ipow(1.0 + 2.0 * mu, 2) / d4
    beta = -6.0 * mu * ipow(1.0 + mu / 2.0, 2) / d4
    gamma = mu * alpha / 2.0
    return alpha, beta, gamma


def _lma_formfactor(q, p):
    """Sphere form factor with the LMA-PY hard-sphere structure factor
    folded in as FF·√S (reference: models/lmadensesphere.py:68-102)."""
    r, mu = p["radius"], p["volFrac"]
    mf = lma_standoff(p["mf"], mu)
    ff = sphere_ff(q * r)
    alpha, beta, gamma = lma_coefficients(mu)
    A = 2.0 * q * (mf * r)
    g_over_a = py_G_over_A(A, alpha, beta, gamma)
    S = 1.0 / (1.0 + 24.0 * mu * g_over_a)
    return torch.sqrt(torch.clamp_min(ff * ff * S, 0.0))


LMADenseSphere = SASModel(
    name="LMADenseSphere",
    elementwise_q=True,
    doc="Sphere with local-monodisperse-approximation Percus-Yevick "
        "hard-sphere structure factor (Pedersen 1994 eqs. 15-17)",
    can_smear=True,
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  generator="uniform", is_fit=True,
                  display_name="Sphere radius"),
        ParamSpec("volFrac", Fraction("%").to_si(10.0), Fraction("%"),
                  (Fraction("%").to_si(0.001), Fraction("%").to_si(100.0)),
                  generator="uniform", is_fit=True,
                  display_name="Volume fraction of spheres"),
        ParamSpec("mf", -1.0, NoUnit, (-1.0, 1e6),
                  display_name="standoff multiplier (-1 = auto)"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="scattering length density difference"),
    ),
    ff=_lma_formfactor,
    volume=_sphere_volume,
    absvolume=_sphere_absvolume,
    surface=_sphere_surface,
    default_active=("radius",),
)
