# -*- coding: utf-8 -*-
"""Ellipsoid models (the JAX package's mcsas_tpu/models/ellipsoids.py):
the spherical core-shell.

Reference math: src/mcsas/models/sphericalcoreshell.py:12-78.  The
isotropic and core-shell ellipsoids come with the table-model slice
(ROADMAP Queue A).
"""
from __future__ import annotations

import math

from ..ops.special import ipow, sphere_ff
from ..utils.units import ANGSTROM_SLD, NM
from .base import ParamSpec, SASModel

_PI43 = 4.0 * math.pi / 3.0


def _sph_cs_ff(q, p):
    """Spherical Shell III (SASfit §3.1.4; reference:
    sphericalcoreshell.py:50-69): K(q,R+t,ηs−ηsol) − (vc/vt)·K(q,R,ηs−ηc)
    with K(q,r,Δη) = Δη·3(sin qr − qr cos qr)/(qr)³.  The SLDs are not
    fittable, so their differences are float64 Python numbers."""
    r, t = p["radius"], p["t"]
    vc = _PI43 * ipow(r, 3)
    vt = _PI43 * ipow(r + t, 3)
    v_ratio = vc / vt
    ks = (p["eta_s"] - p["eta_sol"]) * sphere_ff(q * (r + t))
    kc = (p["eta_s"] - p["eta_c"]) * sphere_ff(q * r)
    return ks - v_ratio * kc


def _sph_cs_volume(p):
    return _PI43 * ipow(p["radius"] + p["t"], 3)


def _sph_cs_surface(p):
    return 4.0 * math.pi * ipow(p["radius"] + p["t"], 2)


SphericalCoreShell = SASModel(
    name="SphericalCoreShell",
    elementwise_q=True,
    can_smear=True,
    doc="Core-shell sphere (SASfit Spherical Shell III, §3.1.4)",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Core Radius"),
        ParamSpec("t", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Thickness of Shell"),
        ParamSpec("eta_c", ANGSTROM_SLD.to_si(3.16e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Core SLD"),
        ParamSpec("eta_s", ANGSTROM_SLD.to_si(2.53e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Shell SLD"),
        ParamSpec("eta_sol", 0.0, ANGSTROM_SLD, (0.0, float("inf")),
                  display_name="Solvent SLD"),
    ),
    ff=_sph_cs_ff,
    volume=_sph_cs_volume,
    surface=_sph_cs_surface,
    default_active=("radius",),
)
