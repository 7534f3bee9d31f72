# -*- coding: utf-8 -*-
"""Orientation-averaged isotropic cylinders (the JAX package's
mcsas_tpu/models/cylinders.py, ``CylindersIsotropic``).

Reference math: src/mcsas/models/cylindersisotropic.py:16-103.  The
orientation integral uses a fixed division count (``intDiv``), static
configuration that cannot be fitted.  The float32 MC loop reads the form
factor from a parameter table (ops/tables.py) baked with a converged rule;
the float64 post pass evaluates ``ff`` itself.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import tables
from ..ops.special import bessel_j1, j1_over_x, sinc_sin
from ..utils.units import ANGSTROM_SLD, NM, NoUnit
from .base import ParamSpec, SASModel


def _cyl_half(p):
    """Half-length: radius·aspect, or length/2 when ``useAspect`` is 0.
    ``useAspect`` is never fitted, so it is a plain number here."""
    if p["useAspect"] != 0.0:
        return p["radius"] * p["aspect"]
    return 0.5 * p["length"]


def _cyl_volume(p):
    return math.pi * p["radius"] ** 2 * (2.0 * _cyl_half(p))


def _cyl_absvolume(p):
    return _cyl_volume(p) * p["sld"] ** 2


def _cyl_iso_ff_ab(a, b, n, dtype):
    """The orientation average as a pure function of the scale invariants
    a = qR, b = qL (elementwise in a, b; quadrature on a new last axis)."""
    x, step = np.linspace(0.0, 1.0, n, retstep=True)
    step = float(step)
    a = torch.as_tensor(a, dtype=dtype)
    b = torch.as_tensor(b, dtype=dtype, device=a.device)
    x = torch.as_tensor(x[1:-1], dtype=dtype, device=a.device)
    qr_sqrtx = a[..., None] * torch.sqrt(1.0 - x * x)
    qlx = b[..., None] * x
    fmid = bessel_j1(qr_sqrtx) * torch.sin(qlx / 2.0) / (qr_sqrtx * qlx)
    f0 = 0.5 * j1_over_x(a)                           # x→0 limit
    f1 = sinc_sin(b / 2.0)                            # x→1 limit
    # trapezoid rule with uniform step, matching np.trapz(f², dx=step):
    # interior points at full weight, both endpoints at half weight
    integral = step * (torch.sum(fmid * fmid, dim=-1)
                       + 0.5 * (f0 * f0 + f1 * f1))
    return torch.sqrt(16.0 * integral)


def _cyl_iso_ff(q, p):
    """SASfit eq. 3.215 orientation average (reference:
    cylindersisotropic.py:50-90), integrating x = cos α over [0, 1] with
    the reference's explicit endpoint limits."""
    half = _cyl_half(p)
    return _cyl_iso_ff_ab(q * p["radius"], q * (2.0 * half),
                          int(p["intDiv"]), q.dtype)


def _cyl_iso_table_factory(bound, q_grid, dtype, device):
    """Fit-grade parameter-grid row table for the float32 MC loop: rows
    over the active size parameters, the q axis exact, baked on *device*
    with a converged rule (n=801; the default intDiv=100 trapezoid carries
    up to ~20 % discretization noise at qR in [10, 100]).  Returns
    ``(lookup, table)`` with ``lookup(table, pdict) -> (..., Nq)``, or
    None when the binding leaves ``useAspect`` active."""
    fixed = dict(bound.fixed)
    if "useAspect" not in fixed:        # not fittable, so always fixed
        return None
    n = max(801, int(fixed.get("intDiv", 100)))
    # only the parameters the form factor actually reads (half-length
    # comes from aspect or length depending on the useAspect switch)
    rele = (("radius", "aspect") if fixed["useAspect"] != 0.0
            else ("radius", "length"))
    tab_params = tuple(p for p in bound.active if p in rele)
    res = tables.cap_res({0: (), 1: (4096,),
                          2: (512, 64)}[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    q32 = torch.tensor(np.asarray(q_grid, np.float64), dtype=dtype,
                       device=device)

    def row_fn(vals):                   # (B, P) -> (B, Nq)
        p = dict(fixed)
        for i, name in enumerate(tab_params):
            p[name] = vals[:, i:i + 1]
        # active params outside `rele` do not enter the form factor
        for name in bound.active:
            p.setdefault(name, 1.0)
        return _cyl_iso_ff_ab(q32 * p["radius"],
                              q32 * (2.0 * _cyl_half(p)), n, dtype)

    key = ("CylindersIsotropic", n, tab_params,
           tables.grid_fingerprint(q_grid), None,
           tuple(sorted(fixed.items())))
    tab = tables.build_param_table(row_fn, grids, dtype, block=256,
                                   cache_key=key, device=device)
    return tables.make_lookup(tab_params), tab


CylindersIsotropic = SASModel(
    name="CylindersIsotropic",
    can_smear=True,
    doc="Orientation-averaged isotropic cylinders (SASfit eq. 3.215)",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM,
                  (NM.to_si(0.1), float("inf")), generator="logdec1",
                  is_fit=True, display_name="Cylinder Radius"),
        ParamSpec("useAspect", 1.0, NoUnit, (0.0, 1.0),
                  display_name="Use aspect ratio (1) or length (0)"),
        ParamSpec("length", NM.to_si(10.0), NM,
                  (NM.to_si(0.1), NM.to_si(1e10)), generator="logdec1",
                  is_fit=True, display_name="Length L of the Cylinder"),
        ParamSpec("aspect", 10.0, NoUnit, (1e-3, 1e3), generator="logdec1",
                  is_fit=True, display_name="Aspect ratio of the Cylinder"),
        ParamSpec("intDiv", 100.0, NoUnit, (1.0, 1e4),
                  display_name="Orientation Integration Divisions"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="Scattering length density difference"),
    ),
    ff=_cyl_iso_ff,
    ff_table_factory=_cyl_iso_table_factory,
    volume=_cyl_volume,
    absvolume=_cyl_absvolume,
    default_active=("radius",),
)
