# -*- coding: utf-8 -*-
"""Ellipsoid models (the JAX package's mcsas_tpu/models/ellipsoids.py):
isotropic spheroids and the core-shell variants.

Reference math: src/mcsas/models/ellipsoidsisotropic.py:15-86,
sphericalcoreshell.py:12-78, ellipsoidalcoreshell.py:14-99.  The
orientation integrals of the two ellipsoids take a fixed division count
(``intDiv``), static configuration that cannot be fitted; the float32 MC
loop reads their form factors from parameter tables (ops/tables.py) baked
with a converged rule, the float64 post pass evaluates ``ff`` itself.

Parameters arrive batched: an entry of shape (B, 1) against the fit grid
(Nq,), or (B, 1, 1) against the smearing offsets (Nq, n_off).  The
orientation axis is appended last, behind the grid's axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import tables
from ..ops.special import ipow, sphere_ff
from ..utils.units import ANGSTROM_SLD, NM, SLD, NoUnit
from .base import ParamSpec, SASModel

_PI43 = 4.0 * math.pi / 3.0


def _last(v):
    """A parameter with a new last axis (the orientation nodes); a plain
    number stays as it is."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def _smeared_rows(f, sw32):
    """Rows f (B, Nq, n_off) of amplitudes on the smearing offsets as the
    smeared intensity (B, Nq): ff²(locs) @ smear_w."""
    return (f * f) @ sw32


# ------------------------------------------------- EllipsoidsIsotropic

def _ell_iso_rc(p):
    """The c semi-axis: a·aspect, or c when ``useAspect`` is 0.
    ``useAspect`` is never fitted, so it is a plain number here."""
    if p["useAspect"] != 0.0:
        return p["a"] * p["aspect"]
    return p["c"]


def _ell_iso_ff_uv(u, v, n, dtype):
    """The orientation average as a pure function of the scale invariants
    u = q·a, v = q·c (elementwise in u, v; quadrature on a new last
    axis)."""
    u = torch.as_tensor(u, dtype=dtype)
    v = torch.as_tensor(v, dtype=dtype, device=u.device)
    alpha = torch.as_tensor(np.linspace(0.0, math.pi / 2.0, n), dtype=dtype,
                            device=u.device)
    sin_a = torch.sin(alpha)
    cos_a = torch.cos(alpha)
    x_plug = torch.sqrt((u[..., None] * sin_a) ** 2
                        + (v[..., None] * cos_a) ** 2)
    fsplit = sphere_ff(x_plug)
    return torch.sqrt(torch.mean(fsplit * fsplit * sin_a, dim=-1))


def _ell_iso_ff(q, p):
    """Orientation-averaged spheroid a=b, c (Pedersen 1997; reference:
    ellipsoidsisotropic.py:51-71): plug r(α)=√(a²sin²α+c²cos²α) into the
    Rayleigh function and average F²·sin α over α ∈ [0, π/2]."""
    return _ell_iso_ff_uv(q * p["a"], q * _ell_iso_rc(p),
                          int(p["intDiv"]), q.dtype)


def _ell_iso_table_factory(bound, q_grid, dtype, device, smear=None):
    """Fit-grade parameter-grid row table for the float32 MC loop, baked
    on *device* with a converged α-rule (n = max(801, intDiv): the true
    orientation integral, not the reference's intDiv=100 discretization
    of it).  Returns ``(lookup, table)``, or None when the binding leaves
    ``useAspect`` active.  With *smear* = (locs (Nq, n_off), smear_w) the
    rows are the smeared intensity ff²(locs) @ smear_w, baked in blocks
    of 8, and the return is ``(lookup, table, "intensity")``."""
    fixed = dict(bound.fixed)
    if "useAspect" not in fixed:        # not fittable, so always fixed
        return None
    n = max(801, int(fixed.get("intDiv", 100)))
    rele = (("a", "aspect") if fixed["useAspect"] != 0.0 else ("a", "c"))
    tab_params = tuple(p for p in bound.active if p in rele)
    res = tables.cap_res({0: (), 1: (4096,),
                          2: (512, 64)}[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    q32 = torch.tensor(np.asarray(q_grid if smear is None else smear[0],
                                  np.float64), dtype=dtype, device=device)
    grid_shape = tuple(q32.shape)
    if smear is not None:
        q32 = q32[None]                 # vals (B, 1, 1) against (Nq, n_off)
        sw32 = torch.tensor(np.asarray(smear[1], np.float64), dtype=dtype,
                            device=device)

    def row_fn(vals):                   # (B, P) -> (B, Nq)
        p = dict(fixed)
        for i, name in enumerate(tab_params):
            p[name] = (vals[:, i:i + 1] if smear is None
                       else vals[:, i:i + 1, None])
        # active params outside `rele` do not enter the form factor
        for name in bound.active:
            p.setdefault(name, 1.0)
        f = _ell_iso_ff_uv(q32 * p["a"], q32 * _ell_iso_rc(p), n, dtype)
        f = torch.broadcast_to(f, (vals.shape[0], *grid_shape))
        return f if smear is None else _smeared_rows(f, sw32)

    key = ("EllipsoidsIsotropic", n, tab_params,
           tables.grid_fingerprint(q_grid), tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    tab = tables.build_param_table(
        row_fn, grids, dtype, block=256 if smear is None else 8,
        cache_key=key, device=device)
    lookup = tables.make_lookup(tab_params)
    if smear is not None:
        return lookup, tab, "intensity"
    return lookup, tab


def _ell_iso_volume(p):
    return _PI43 * ipow(p["a"], 2) * _ell_iso_rc(p)


def _ell_iso_absvolume(p):
    return _ell_iso_volume(p) * p["sld"] ** 2


EllipsoidsIsotropic = SASModel(
    name="EllipsoidsIsotropic",
    can_smear=True,
    doc="Isotropic spheroid with semi-axes a=b, c (SASfit Ellipsoid II)",
    params=(
        ParamSpec("a", NM.to_si(1.0), NM, NM.to_si((0.1, 1e10)),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Radius of semi-axes a, b"),
        ParamSpec("useAspect", 1.0, NoUnit, (0.0, 1.0),
                  display_name="Use aspect ratio (1) or c-axis length (0)"),
        ParamSpec("c", NM.to_si(10.0), NM, NM.to_si((0.1, 1e10)),
                  active_range=NM.to_si((1.0, 1e4)), generator="logdec1",
                  is_fit=True, display_name="Radius of semi-axes c"),
        ParamSpec("aspect", 10.0, NoUnit, (1e-3, 1e3), generator="logdec1",
                  is_fit=True, display_name="aspect ratio of c to a, b"),
        ParamSpec("intDiv", 100.0, NoUnit, (1.0, 1e4),
                  display_name="Orientation Integration Divisions"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, SLD("Å⁻²").to_si(1e-2)),
                  display_name="Scattering length density difference"),
    ),
    ff=_ell_iso_ff,
    ff_table_factory=_ell_iso_table_factory,
    volume=_ell_iso_volume,
    absvolume=_ell_iso_absvolume,
    default_active=("a",),
)


# ------------------------------------------------- SphericalCoreShell

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


# ----------------------------------------------- EllipsoidalCoreShell

def _ell_cs_ff(q, p):
    """Core-shell ellipsoid (SASfit §3.2.3; reference:
    ellipsoidalcoreshell.py:59-90): orientation average over μ ∈ [0, 1] of
    the SLD-weighted sum of 3j1(x)/x terms (== the Rayleigh function).
    The JAX package writes the μ rule as ``outer(q, ·)`` of one
    contribution; here the μ axis is appended behind q's axes and the
    parameters' own, so a batch of contributions is one call."""
    n = int(p["intDiv"])
    mu = torch.as_tensor(np.linspace(0.0, 1.0, n), dtype=q.dtype,
                         device=q.device)
    a, b, t = p["a"], p["b"], p["t"]
    vc = _PI43 * a * ipow(b, 2)
    vt = _PI43 * (a + t) * ipow(b + t, 2)
    v_ratio = vc / vt
    mu2 = mu ** 2
    xc = q[..., None] * torch.sqrt(ipow(_last(a), 2) * mu2
                                   + ipow(_last(b), 2) * (1.0 - mu2))
    xt = q[..., None] * torch.sqrt(ipow(_last(a + t), 2) * mu2
                                   + ipow(_last(b + t), 2) * (1.0 - mu2))
    fsplit = ((p["eta_c"] - p["eta_s"]) * _last(v_ratio) * sphere_ff(xc)
              + (p["eta_s"] - p["eta_sol"]) * sphere_ff(xt))
    return torch.sqrt(torch.mean(fsplit ** 2, dim=-1))


def _ell_cs_table_factory(bound, q_grid, dtype, device, smear=None):
    """Fit-grade parameter-grid row table over the active size parameters
    (a, b, t), baked on *device*: up to trilinear (2³ row gathers; K2's
    table entry blends two axes, a 3-axis table runs through its rows-in
    entry); SLDs are never fittable and fold into the build.  The
    μ-integrand is smooth, so n = max(201, intDiv) is converged to ~1e-3.
    With *smear* = (locs (Nq, n_off), smear_w) the rows are baked on the
    flattened offsets, reshaped and contracted to ff²(locs) @ smear_w in
    blocks of 8, and the return is ``(lookup, table, "intensity")``."""
    fixed = dict(bound.fixed)
    n = max(201, int(fixed.get("intDiv", 100)))
    tab_params = tuple(p for p in bound.active if p in ("a", "b", "t"))
    # P=2 spends resolution evenly: shell-thickness phase error dominates
    # the core-shell oscillation, so t needs the same density as a
    res = tables.cap_res({0: (), 1: (4096,), 2: (384, 256),
                          3: (128, 64, 48)}[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    if smear is None:
        q32 = torch.tensor(np.asarray(q_grid, np.float64), dtype=dtype,
                           device=device)
    else:
        locs = np.asarray(smear[0], np.float64)             # (Nq, n_off)
        q32 = torch.tensor(locs.ravel(), dtype=dtype, device=device)
        sw32 = torch.tensor(np.asarray(smear[1], np.float64), dtype=dtype,
                            device=device)

    def row_fn(vals):                   # (B, P) -> (B, Nq)
        p = dict(fixed)
        p["intDiv"] = n          # converged μ-rule for the one-time build
        for i, name in enumerate(tab_params):
            p[name] = vals[:, i:i + 1]
        f = _ell_cs_ff(q32, p)
        f = torch.broadcast_to(f, (vals.shape[0], q32.numel()))
        if smear is not None:
            return _smeared_rows(f.reshape(-1, *locs.shape), sw32)
        return f

    key = ("EllipsoidalCoreShell", n, tab_params,
           tables.grid_fingerprint(q_grid), tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    tab = tables.build_param_table(
        row_fn, grids, dtype, block=128 if smear is None else 8,
        cache_key=key, device=device)
    lookup = tables.make_lookup(tab_params)
    if smear is not None:
        return lookup, tab, "intensity"
    return lookup, tab


def _ell_cs_volume(p):
    return _PI43 * (p["a"] + p["t"]) * ipow(p["b"] + p["t"], 2)


EllipsoidalCoreShell = SASModel(
    name="EllipsoidalCoreShell",
    can_smear=True,
    doc="Core-shell ellipsoid (SASfit §3.2.3)",
    params=(
        ParamSpec("a", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Principal Core Radius"),
        ParamSpec("b", NM.to_si(10.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 1e4)), generator="logdec1",
                  is_fit=True, display_name="Equatorial Core Radius"),
        ParamSpec("t", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Thickness of Shell"),
        ParamSpec("eta_c", ANGSTROM_SLD.to_si(3.15e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Core SLD"),
        ParamSpec("eta_s", ANGSTROM_SLD.to_si(2.53e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Shell SLD"),
        ParamSpec("eta_sol", 0.0, ANGSTROM_SLD, (0.0, float("inf")),
                  display_name="Solvent SLD"),
        ParamSpec("intDiv", 100.0, NoUnit, (1.0, 1e4),
                  display_name="Orientation Integration Divisions"),
    ),
    ff=_ell_cs_ff,
    ff_table_factory=_ell_cs_table_factory,
    volume=_ell_cs_volume,
    default_active=("a",),
)
