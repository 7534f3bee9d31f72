# -*- coding: utf-8 -*-
"""Sphere model.

Reference math: src/mcsas/models/sphere.py:12-65.
"""
from __future__ import annotations

import math

from ..ops.special import sphere_ff
from ..utils.units import ANGSTROM_SLD, NM
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
