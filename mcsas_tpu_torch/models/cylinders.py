# -*- coding: utf-8 -*-
"""Cylinder model family (the JAX package's mcsas_tpu/models/cylinders.py):
orientation-averaged isotropic cylinders and the legacy ψ-grid variants
(CylindersIsotropicAspect, CylindersRadiallyIsotropic and
CylindersRadiallyIsotropicTilted, the last two with an anisotropic
``ff2d`` for 2D (q, ψ) fitting).

Reference math: src/mcsas/models/cylindersisotropic.py:16-103,
cylindersisotropicaspect.py:13-77, cylindersradiallyisotropic.py:14-84,
cylindersradiallyisotropictilted.py:20-108.  The orientation integrals use
fixed division counts (``intDiv``, ``psiAngleDivisions``), static
configuration that cannot be fitted.  The float32 MC loop reads the form
factor from a parameter table (ops/tables.py) baked with a converged rule
where the model has one (the ψ-grid tables only where the interpolation
probe engages them); the float64 post pass evaluates ``ff`` itself.

Parameters arrive batched (an entry of shape (B, 1) against the fit grid,
(B, 1, 1) against the smearing offsets); the ψ (and tilt) nodes of the
orientation rules go on a new last axis behind the grid's axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import tables
from ..ops.special import bessel_j1, ipow, j1_over_x, sinc_sin
from ..utils.units import ANGSTROM_SLD, DEG, NM, Angle, NoUnit
from .base import ParamSpec, SASModel
from .ellipsoids import _last, _smeared_rows

_D2R = math.pi / 180.0


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


def _cyl_iso_table_factory(bound, q_grid, dtype, device, smear=None):
    """Fit-grade parameter-grid row table for the float32 MC loop: rows
    over the active size parameters, the q axis exact, baked on *device*
    with a converged rule (n=801; the default intDiv=100 trapezoid carries
    up to ~20 % discretization noise at qR in [10, 100]).  Returns
    ``(lookup, table)`` with ``lookup(table, pdict) -> (..., Nq)``, or
    None when the binding leaves ``useAspect`` active.

    With *smear* = (locs (Nq, n_off), smear_w (n_off,)) the rows are the
    smeared intensity ff²(locs) @ smear_w, baked against the dataset's
    own contraction, and the return is ``(lookup, table, "intensity")``:
    the lookup then gives intensity, not amplitude (reference smearing
    path: src/mcsas/bases/model/sasmodel.py:56-73)."""
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
    # the grid the rule runs on: the fit grid, or the smearing offsets
    q32 = torch.tensor(np.asarray(q_grid if smear is None else smear[0],
                                  np.float64), dtype=dtype, device=device)
    if smear is not None:
        # vals (B, 1) against the grid (Nq, n_off): one axis more
        q32 = q32[None]
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
        f = _cyl_iso_ff_ab(q32 * p["radius"],
                           q32 * (2.0 * _cyl_half(p)), n, dtype)
        return f if smear is None else (f * f) @ sw32

    key = ("CylindersIsotropic", n, tab_params,
           tables.grid_fingerprint(q_grid), tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    # smeared rows evaluate on the full (Nq, n_off, n) block: keep the
    # per-block temporary bounded
    tab = tables.build_param_table(
        row_fn, grids, dtype, block=256 if smear is None else 8,
        cache_key=key, probe_rows_are_intensity=smear is not None,
        device=device)
    lookup = tables.make_lookup(tab_params)
    if smear is not None:
        return lookup, tab, "intensity"
    return lookup, tab


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


# ----------------------------------------- the ψ-grid cylinders' tables

# float32 values the largest temporary of one block of a ψ-table bake may
# hold (block rows × grid points × ψ nodes; 134 MB, a dozen of them alive
# in the Bessel chain): about 108 rows of the 100-point fit grid at the
# converged 3001 nodes.  Each row is its own computation, but CUDA's sum
# over the ψ axis reads a row in 16-byte vectors from where the row
# starts: a row's bits depend on its start modulo 4 floats, which blocks
# of a multiple of 4 rows keep as in one block of all rows (measured on
# an H100: 101 or 30 q points in blocks of 1, 3, 5 or 7 rows move the
# rows by an ulp).  So the blocks are whole multiples of 4 rows.
_PSI_BAKE_VALUES = 2 ** 25


def _psi_bake_block(width: int, nodes: int) -> int:
    """Rows a block of a ψ-table bake evaluates: the memory budget
    :data:`_PSI_BAKE_VALUES` over *width* grid points × *nodes* ψ nodes,
    rounded down to a multiple of 4 rows (at least 4)."""
    return max(4, _PSI_BAKE_VALUES // (width * nodes) // 4 * 4)


def _psi_grid_table_factory(ff_fn, reads, res_map,
                            div_param="psiAngleDivisions", div_conv=3001):
    """Fit-grade table factory for the legacy ψ-grid cylinder variants:
    rows over a log grid of the ACTIVE parameters the rule reads, the q
    axis exact, baked on *device* with a converged ψ rule (*div_conv*
    divisions: the verbatim 303-point grids under-resolve the orientation
    average at high qR, where their value is quadrature noise no
    interpolation can track).  Returns ``factory(bound, q_grid, dtype,
    device, smear=None)`` giving ``(lookup, table)``, or ``(lookup,
    table, "intensity")`` with *smear* = (locs (Nq, n_off), smear_w), or
    None.

    Probe-gated: these wedge / in-plane rules oscillate along the
    parameter axes with phase ~q·L, so over wide ranges no resolution
    interpolates fit-grade; the probe engages the table only where
    production-spacing interpolation meets the fit-grade contract, as in
    the JAX package (same seeded draws, so the same decision)."""
    def factory(bound, q_grid, dtype, device, smear=None):
        tab_params = tuple(p for p in bound.active if p in reads)
        if len(tab_params) not in res_map:
            return None
        res = tables.cap_res(res_map[len(tab_params)])
        if not res:
            return None
        grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
                 for p, nn in zip(tab_params, res)]
        fixed = dict(bound.fixed)
        fixed[div_param] = float(max(div_conv,
                                     int(fixed.get(div_param, 0))))
        locs = None if smear is None else np.asarray(smear[0], np.float64)
        qd = torch.tensor(np.asarray(q_grid, np.float64) if smear is None
                          else locs.ravel(), dtype=dtype, device=device)
        if smear is not None:
            sw = torch.tensor(np.asarray(smear[1], np.float64), dtype=dtype,
                              device=device)

        def row_fn(vals):               # (B, P) -> (B, Nq)
            p = dict(fixed)
            for i, name in enumerate(tab_params):
                p[name] = vals[:, i:i + 1]
            # active params the rule does not read never enter the rows
            for name in bound.active:
                p.setdefault(name, 1.0)
            f = torch.broadcast_to(ff_fn(qd, p), (vals.shape[0], qd.numel()))
            if smear is not None:
                return _smeared_rows(f.reshape(-1, *locs.shape), sw)
            return f

        key = (ff_fn.__name__, tab_params, int(fixed[div_param]),
               tables.grid_fingerprint(q_grid),
               tables.smear_fingerprint(smear),
               tuple(sorted(fixed.items())))
        block = _psi_bake_block(qd.numel(), int(fixed[div_param]))
        tab = tables.build_param_table(
            row_fn, grids, dtype, block=block, cache_key=key, probe=True,
            probe_rows_are_intensity=smear is not None, device=device)
        if tab is None:
            return None
        lookup = tables.make_lookup(tab_params)
        if smear is not None:
            return lookup, tab, "intensity"
        return lookup, tab

    return factory


def _psi_cyl_volume(p):
    return math.pi * ipow(p["radius"], 2) * (2.0 * p["radius"] * p["aspect"])


# --------------------------------------- CylindersIsotropicAspect (legacy)

def _cyl_iso_aspect_ff(q, p):
    """Legacy duplicate cylinder over a ψ grid (reference:
    cylindersisotropicaspect.py:46-71), including its double angle
    conversion of the SI ψ grid, kept for parity.  Upstream the grid's
    sin 0 = 0 makes the first column 0/0 and every q NaN; here the limits
    of ``j1_over_x`` and ``sinc_sin`` keep it finite."""
    n = int(p["psiAngleDivisions"])
    psi = torch.as_tensor(np.linspace(0.0, math.pi, n) * _D2R,
                          dtype=q.dtype, device=q.device)
    r = _last(p["radius"])
    qr_sina = q[..., None] * (r * torch.sin(psi))
    ql_cosa = q[..., None] * (r * _last(p["aspect"]) * torch.cos(psi))
    fsplit = (2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)
              * torch.sqrt(torch.abs(torch.sin(psi))))
    return torch.sqrt(torch.mean(fsplit ** 2, dim=-1))


CylindersIsotropicAspect = SASModel(
    name="CylindersIsotropicAspect",
    can_smear=True,
    doc="Legacy aspect-ratio cylinder over a ψ grid",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="uniform",
                  is_fit=True, display_name="Cylinder radius"),
        ParamSpec("aspect", 10.0, NoUnit, (0.0, float("inf")),
                  active_range=(1.0, 20.0), generator="uniform", is_fit=True,
                  display_name="Aspect ratio L/(2R) of the cylinder"),
        ParamSpec("psiAngle", DEG.to_si(10.0), DEG,
                  (0.0, DEG.to_si(180.0)), generator="uniform", is_fit=True,
                  display_name="in-plane cylinder rotation"),
        ParamSpec("psiAngleDivisions", 303.0, NoUnit, (1.0, float("inf")),
                  display_name="in-plane angle divisions"),
    ),
    ff=_cyl_iso_aspect_ff,
    ff_table_factory=_psi_grid_table_factory(
        _cyl_iso_aspect_ff, ("radius", "aspect"),
        {1: (4096,), 2: (512, 64)}),
    volume=_psi_cyl_volume,
    default_active=("radius", "psiAngle"),
)


# ------------------------------------------ CylindersRadiallyIsotropic

def _cyl_radial_ff2d(q, psi, p):
    """Anisotropic in-plane cylinder at detector azimuth ψ (Pedersen 1997;
    fig. 1 of Pauw et al., J. Appl. Cryst. 2010): the un-averaged
    integrand of :func:`_cyl_radial_ff` at the data's own ψ.  Elementwise
    in (q, ψ) and the parameters: it drives the 2D (q, ψ) fit."""
    a = psi - p["psiAngle"]
    qr_sina = q * p["radius"] * torch.sin(a)
    ql_cosa = q * (p["radius"] * p["aspect"]) * torch.cos(a)
    return 2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)


def _cyl_radial_ff(q, p):
    """In-plane isotropic cylinders (reference:
    cylindersradiallyisotropic.py:50-75): the ψ grid spans the psiAngle
    value range, rotated by the fitted psiAngle; the nodes on a new last
    axis."""
    n = int(p["psiAngleDivisions"])
    psi = torch.as_tensor(np.linspace(0.01, 2.0 * math.pi + 0.01, n),
                          dtype=q.dtype, device=q.device)
    fsplit = _cyl_radial_ff2d(q[..., None], psi,
                              {k: _last(v) for k, v in p.items()})
    return torch.sqrt(torch.mean(fsplit ** 2, dim=-1))


CylindersRadiallyIsotropic = SASModel(
    name="CylindersRadiallyIsotropic",
    doc="Radially (in-plane) isotropic cylinders",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM,
                  (NM.to_si(0.1), float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Cylinder radius"),
        ParamSpec("aspect", 10.0, NoUnit, (0.1, float("inf")),
                  active_range=(1.0, 20.0), generator="uniform", is_fit=True,
                  display_name="Aspect ratio L/(2R) of the cylinder"),
        ParamSpec("psiAngle", 0.17, Angle("rad"),
                  (0.01, 2.0 * math.pi + 0.01), generator="uniform",
                  is_fit=True, display_name="in-plane cylinder rotation"),
        ParamSpec("psiAngleDivisions", 303.0, NoUnit, (1.0, float("inf")),
                  display_name="in-plane angle divisions"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="scattering length density difference"),
    ),
    ff=_cyl_radial_ff,
    ff_table_factory=_psi_grid_table_factory(
        _cyl_radial_ff, ("radius", "aspect", "psiAngle"),
        {1: (4096,), 2: (512, 64), 3: (128, 32, 16)}),
    ff2d=_cyl_radial_ff2d,
    volume=_psi_cyl_volume,
    absvolume=lambda p: _psi_cyl_volume(p) * p["sld"] ** 2,
    default_active=("radius", "psiAngle"),
)


# ------------------------------------- CylindersRadiallyIsotropicTilted

def _phi_centroids(divisions: int) -> np.ndarray:
    """Equal-probability Gaussian segment centroids (positive z-scores).

    Reproduces scipy.stats.norm.interval over linspace(0, 0.99, n+1)
    (reference: cylindersradiallyisotropictilted.py:71-74) without scipy:
    interval(x)[1] == ppf(0.5 + x/2)."""
    from statistics import NormalDist
    x = np.linspace(0.0, 0.99, divisions + 1)
    ctr = x[:-1] + np.diff(x) / 2.0
    nd = NormalDist()
    return np.array([nd.inv_cdf(0.5 + c / 2.0) for c in ctr])


def _cyl_tilted_ff2d(q, psi, p):
    """Anisotropic tilted cylinder at detector azimuth ψ [rad]: the
    un-ψ-averaged integrand of :func:`_cyl_tilted_ff` with the Gaussian
    out-of-plane tilt average kept (upstream UNFINISHED:
    cylindersradiallyisotropictilted.py:61-102).  The upstream quirks are
    kept deliberately: the tilt centroids are standard z-scores read as
    DEGREES, and the degree-valued psiAngle rotates the in-plane
    azimuth."""
    a = psi - p["psiAngle"] * _D2R
    phi_ctr = _phi_centroids(int(p["phiDistDivisions"]))
    qr_sina = q * p["radius"] * torch.sin(a)
    f = 0.0
    for phi in phi_ctr:
        ql_cosa = (q * p["radius"] * p["aspect"]
                   * math.cos(phi * _D2R) * torch.cos(a))
        f = f + 2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)
    return f / len(phi_ctr)


def _cyl_tilted_ff(q, p):
    """Radially isotropic cylinders with Gaussian out-of-plane tilt,
    marked *UNFINISHED* upstream: the tilt centroids are standard
    z-scores read as degrees, phiDistWidth is unused and the radius has
    no unit; kept verbatim for parity (reference:
    cylindersradiallyisotropictilted.py:61-102).  The ψ nodes on a new
    last axis; the tilt centroids a loop."""
    n = int(p["psiAngleDivisions"])
    psi = torch.as_tensor(np.linspace(0.1, 180.1, n), dtype=q.dtype,
                          device=q.device)
    phi_ctr = _phi_centroids(int(p["phiDistDivisions"]))
    r, asp = _last(p["radius"]), _last(p["aspect"])
    qr_sina = q[..., None] * (r * torch.sin(psi * _D2R))
    fcyl = 0.0
    for phi in phi_ctr:
        ql_cosa = q[..., None] * (r * asp * math.cos(phi * _D2R)
                                  * torch.cos(psi * _D2R))
        fsplit = 2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)
        fcyl = fcyl + torch.sqrt(torch.mean(fsplit ** 2, dim=-1)) \
            / len(phi_ctr)
    return fcyl


CylindersRadiallyIsotropicTilted = SASModel(
    name="CylindersRadiallyIsotropicTilted",
    doc="Radially isotropic cylinders with Gaussian out-of-plane tilt "
        "(UNFINISHED upstream, kept for parity)",
    params=(
        ParamSpec("radius", 1.0, NoUnit, (0.1, float("inf")),
                  active_range=(0.1, 1e3), generator="uniform", is_fit=True,
                  display_name="Cylinder radius"),
        ParamSpec("aspect", 10.0, NoUnit, (0.1, float("inf")),
                  active_range=(1.0, 20.0), generator="uniform", is_fit=True,
                  display_name="Aspect ratio L/(2R) of the cylinder"),
        ParamSpec("psiAngle", 0.1, NoUnit, (0.1, 180.1), generator="uniform",
                  is_fit=True, display_name="in-plane cylinder rotation"),
        ParamSpec("psiAngleDivisions", 303.0, NoUnit, (1.0, float("inf")),
                  display_name="in-plane angle divisions"),
        ParamSpec("phiDistWidth", 10.0, NoUnit, (0.1, 90.1),
                  display_name="out-of-plane axis distribution width"),
        ParamSpec("phiDistDivisions", 9.0, NoUnit, (1.0, float("inf")),
                  display_name="out of plane integration divisions"),
    ),
    # no table: the upstream-UNFINISHED tilt rule does not converge with
    # its ψ grid at high qR, so there is no smooth target to tabulate
    ff=_cyl_tilted_ff,
    ff2d=_cyl_tilted_ff2d,
    volume=_psi_cyl_volume,
    default_active=("radius",),
)
