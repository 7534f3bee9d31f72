# -*- coding: utf-8 -*-
"""Polymer chain models (the JAX package's mcsas_tpu/models/chains.py):
the Debye Gaussian chain and the Kholodenko worm.

Reference math: src/mcsas/models/gaussianchain.py:12-73 and
src/mcsas/models/kholodenko.py:16-94.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import tables
from ..ops.special import gauss_legendre, ipow, j1_over_x, sine_integral
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


# --------------------------------------------------------- Kholodenko worm

# Quadrature layout: the Dirac-propagator kernel decays like e^(−z·rate); the
# oscillatory regime (q > 3/kuhn) is damped within z ≲ Z_CUT, so a dense
# composite Gauss-Legendre rule covers it and a coarse one the smooth
# tail.  This replaces the reference's adaptive scipy.integrate.quad
# (epsrel 1e-10, limit 1e4; reference: models/kholodenko.py:31-38).
_Z_CUT = 40.0
_HEAD_NODES, _HEAD_WEIGHTS = gauss_legendre(16, 128)  # 2048 points on [0,1]
_TAIL_NODES, _TAIL_WEIGHTS = gauss_legendre(8, 8)     # 64 points on [0,1]
# fit-grade rule (float32 MC loop without a table): ~4x cheaper, relative
# error ~1e-3 in the most oscillatory regime
_FAST_HEAD = gauss_legendre(16, 32)                   # 512 points


def _as_param(x, like: torch.Tensor) -> torch.Tensor:
    """A parameter (tensor or plain number) as a tensor of *like*'s dtype
    and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _kho_fz(z, t):
    """f(z) of the Kholodenko propagator, t = q·kuhn/3, stable for large z.

    t<1: sinh(Ez)/(E sinh z),  E=√(1−t²)
    t>1: sin(Fz)/(F sinh z),   F=√(t²−1)
    t=1: z/sinh z (both branches' limit)
    Evaluated with exponential scaling so sinh never overflows.
    """
    eps = 1e-12
    e = torch.sqrt(torch.clamp_min(1.0 - t * t, eps))
    f = torch.sqrt(torch.clamp_min(t * t - 1.0, eps))
    one_m_em2z = -torch.expm1(-2.0 * z)
    # sinh(Ez)/(E sinh z) = e^{(E−1)z}·(1−e^{−2Ez}) / (E·(1−e^{−2z}))
    sub = torch.exp((e - 1.0) * z) * -torch.expm1(-2.0 * e * z) / (
        e * (one_m_em2z + eps))
    # sin(Fz)/(F sinh z) = 2·sin(Fz)·e^{−z} / (F·(1−e^{−2z}))
    sup = 2.0 * torch.sin(f * z) * torch.exp(-z) / (f * (one_m_em2z + eps))
    fz = torch.where(t < 1.0, sub, sup)
    # z→0 limit of all branches is 1
    return torch.where(z <= 0.0, torch.ones_like(fz), fz)


def _kho_p0_sq_tx(t, x, head=None):
    """∫₀ˣ f(z)·(2/x)(1−z/x) dz as a pure function of the invariants
    t = q·kuhn/3, x = 3·contour/kuhn (elementwise in t, x; the nodes on a
    new last axis): the dense Gauss-Legendre head on [0, min(x, Z_CUT)]
    and the coarse tail beyond."""
    head_nodes, head_weights = head if head is not None else (
        _HEAD_NODES, _HEAD_WEIGHTS)
    x = _as_param(x, t)
    t3 = t[..., None]
    xs = x[..., None]
    head_hi = torch.clamp_max(xs, _Z_CUT)

    def integrate(nodes, weights, lo, hi):
        z = lo + (hi - lo) * _as_param(nodes, t)
        w = (hi - lo) * _as_param(weights, t)
        core = _kho_fz(z, t3) * (2.0 / xs) * (1.0 - z / xs)
        return torch.sum(w * core, dim=-1)

    total = integrate(head_nodes, head_weights, 0.0, head_hi)
    tail = integrate(_TAIL_NODES, _TAIL_WEIGHTS, head_hi, xs)
    total = total + torch.where(x > _Z_CUT, tail, torch.zeros_like(tail))
    return torch.clamp_min(total, 0.0)


def _kho_p0_sq(q, kuhn, contour, head=None):
    return _kho_p0_sq_tx(q * kuhn / 3.0, 3.0 * contour / kuhn, head)


# -------- converged rule: Filon (oscillatory) + Boole (smooth) -------------
#
# The composite-GL head above needs nodes ∝ the oscillation frequency
# F = √(t²−1) (2048 for this model's range corners).  This rule is
# frequency-robust on a fixed 513-node uniform grid:
#
# * t>1 (oscillatory): f(z) = sin(Fz)/(F·sinh z); splitting
#   1/sinh z = 1/z + 2·s(z) with s smooth gives a singular part with the
#   CLOSED FORM (2/x)[Si(FX) − (1−cos FX)/(Fx)] and a smooth remainder
#   g·s integrated by Filon-Simpson, whose error is O(h⁴) *independent of
#   F*.  sin(F z_i) on the uniform grid comes from a two-term rotation
#   recurrence: two transcendentals per (t, x) element instead of two per
#   node.
# * t<1 (smooth): composite Boole rule (O(h⁶)) on the same grid, with
#   sinh(e z_i) from the matching hyperbolic recurrence.
# * x > Z_CUT: the coarse GL tail on [Z_CUT, x] (for t>1 the integrand is
#   < e^(−Z_CUT) there; only the smooth branch has mass).

_N_HALF = 256          # 2N uniform intervals (2N % 4 == 0 for Boole)


def _filon_coeffs(th):
    """Filon-Simpson coefficients α, β, γ(θ) (Abramowitz & Stegun
    25.4.47-54), with the small-θ series below the cancellation
    threshold."""
    small = th < 0.05
    ts = torch.where(small, torch.ones_like(th), th)
    s, c = torch.sin(ts), torch.cos(ts)
    s2, c2 = 2.0 * s * c, c * c
    alpha = 1.0 / ts + s2 / (2.0 * ts ** 2) - 2.0 * s * s / ts ** 3
    beta = 2.0 * ((1.0 + c2) / ts ** 2 - s2 / ts ** 3)
    gamma = 4.0 * (s / ts ** 3 - c / ts ** 2)
    t2 = th * th
    alpha_s = th * t2 * (2.0 / 45.0 - t2 * (2.0 / 315.0
                                            - t2 * (2.0 / 4725.0)))
    beta_s = 2.0 / 3.0 + t2 * (2.0 / 15.0 - t2 * (4.0 / 105.0
                                                  - t2 * (2.0 / 567.0)))
    gamma_s = 4.0 / 3.0 - t2 * (2.0 / 15.0 - t2 * (1.0 / 210.0
                                                   - t2 / 11340.0))
    return (torch.where(small, alpha_s, alpha),
            torch.where(small, beta_s, beta),
            torch.where(small, gamma_s, gamma))


def _boole_weights(n2: int) -> np.ndarray:
    """Composite Boole weights [7, 32, 12, 32, 14, 32, 12, ..., 32, 7]."""
    wb = np.full(n2 + 1, 14.0)
    wb[1::2] = 32.0
    wb[2::4] = 12.0
    wb[0] = wb[n2] = 7.0
    return wb


def _kho_p0_sq_conv(t, x):
    """Converged ∫₀ˣ f(z)·(2/x)(1−z/x) dz, elementwise in *t* and *x*
    (x broadcasts against t: one x per contribution or table row, t over
    its q grid).  The JAX package evaluates this rule for a scalar x and
    vmaps over contributions; here each x has its own node grid z_i = h·i,
    h = min(x, Z_CUT)/512, held as a node axis in front of x's shape
    ((513, *x.shape): small, since x carries no q axis), and the 513
    steps of the recurrence run in the JAX package's order on a state of
    the broadcast shape of t and x.  The tail's 64 nodes are a loop too,
    so no temporary holds a node axis at the size of t: a (B, Nq)
    problem keeps (B, Nq) temporaries, whatever B (the float64 bank of
    ``post/histogram.py`` evaluates every contribution in one block, the
    bake every row of the table).  Validated ≤1e-6 relative against
    adaptive quadrature (the JAX package's tests, ported)."""
    dtype, dev = t.dtype, t.device
    x = _as_param(x, t)
    n2 = 2 * _N_HALF
    X = torch.clamp_max(x, _Z_CUT)
    h = X / n2
    # the node grid of each x, nodes first
    i = torch.arange(n2 + 1, dtype=dtype, device=dev).reshape(
        (n2 + 1,) + (1,) * x.dim())
    z = h * i
    g = (2.0 / x) * (1.0 - z / x)
    # s(z) = 1/(2 sinh z) − 1/(2z): smooth, s(0)=0; series below 0.1
    zc = torch.where(z < 0.1, torch.ones_like(z), z)   # series guard
    s_dir = 0.5 / torch.sinh(zc) - 0.5 / zc
    z2 = z * z
    s_ser = z * (-1.0 / 12.0 + z2 * (7.0 / 720.0
                                     - z2 * (31.0 / 30240.0)))
    phi = g * torch.where(z < 0.1, s_ser, s_dir)
    zp = torch.where(z <= 0.0, torch.ones_like(z), z)  # z==0 guard only
    inv_sinh = torch.where(z <= 0.0, torch.zeros_like(z),
                           1.0 / torch.sinh(zp))
    wb = torch.as_tensor(_boole_weights(n2), dtype=dtype, device=dev)
    gw = wb.reshape(i.shape) * (2.0 * h / 45.0) * g

    eps = 1e-12
    e = torch.sqrt(torch.clamp_min(1.0 - t * t, eps))
    F = torch.sqrt(torch.clamp_min(t * t - 1.0, eps))
    sin_d, cos_d = torch.sin(F * h), torch.cos(F * h)
    sinh_d, cosh_d = torch.sinh(e * h), torch.cosh(e * h)
    shape = torch.broadcast_shapes(t.shape, x.shape)
    one = torch.ones(shape, dtype=dtype, device=dev)
    sF, cF = torch.zeros_like(one), one
    she, che = torch.zeros_like(one), one
    # node 0 (z = 0): f_sub is its limit 1, sin(F·0) = 0
    a_sub = gw[0] * one
    a_e = phi[0] * sF
    a_o = torch.zeros_like(one)
    for k in range(1, n2 + 1):
        sF, cF = sF * cos_d + cF * sin_d, cF * cos_d - sF * sin_d
        she, che = she * cosh_d + che * sinh_d, che * cosh_d + she * sinh_d
        # f_sub(z_k) = sinh(e·z_k)/(e·sinh z_k)
        a_sub = a_sub + gw[k] * (she * inv_sinh[k] / e)
        if k % 2:
            a_o = a_o + phi[k] * sF
        else:
            a_e = a_e + phi[k] * sF

    # Filon assembly for the smooth remainder ∫ sin(Fz)·φ(z) dz
    sXF, cXF = torch.sin(F * X), torch.cos(F * X)
    alpha, beta, gamma = _filon_coeffs(F * h)
    phi_end = phi[n2]
    S_e = a_e - 0.5 * phi_end * sXF              # φ(0) = 0
    filon = h * (-alpha * phi_end * cXF + beta * S_e + gamma * a_o)
    # singular part: ∫ sin(Fz)·g(z)/z dz = (2/x)[Si(FX) − (1−cos FX)/(Fx)]
    sing = (2.0 / x) * (sine_integral(F * X)
                        - (1.0 - cXF) / (F * x))
    sup_head = (sing + 2.0 * filon) / F

    total = torch.where(t < 1.0, a_sub, sup_head)
    # smooth tail beyond the head window (x > Z_CUT only), node by node
    ztail_lo = torch.clamp_max(x, _Z_CUT)
    span = x - ztail_lo
    tail = torch.zeros_like(one)
    for node, weight in zip(_TAIL_NODES, _TAIL_WEIGHTS):
        zt = ztail_lo + span * float(node)
        core = _kho_fz(zt, t) * (2.0 / x) * (1.0 - zt / x)
        tail = tail + (span * float(weight)) * core
    total = total + torch.where(x > _Z_CUT, tail, torch.zeros_like(tail))
    return torch.clamp_min(total, 0.0)


def _col(v):
    """A parameter entry with a new last axis against the fit grid; a
    plain number stays as it is."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def _kho_ff_impl(q, p, head=None):
    p0 = torch.sqrt(_kho_p0_sq(q, p["lenKuhn"], p["lenContour"], head))
    pcs = 2.0 * j1_over_x(q * p["radius"])
    return p0 * pcs


def _kho_ff(q, p):
    """p0·pcs: worm backbone times circular cross-section
    (reference: models/kholodenko.py:81-90; non-squared like the
    original), with the converged Filon/Boole rule."""
    p0 = torch.sqrt(_kho_p0_sq_conv(q * p["lenKuhn"] / 3.0,
                                    3.0 * p["lenContour"] / p["lenKuhn"]))
    pcs = 2.0 * j1_over_x(q * p["radius"])
    return p0 * pcs


def _kho_ff_fast(q, p):
    """Fit-grade variant using the coarse head rule — ~4x cheaper, ~1e-3
    relative error in the most oscillatory regime, far below the
    measurement uncertainty the float32 MC loop fits against."""
    return _kho_ff_impl(q, p, head=_FAST_HEAD)


# float32 values one block of the worm's bake may hold in one temporary
# (16 MiB): the recurrence's state is (block, row width), about twenty
# such temporaries live; rows do not depend on the block they are baked in
_KHO_BAKE_VALUES = 2 ** 22


def _kho_table_factory(bound, q_grid, dtype, device, smear=None):
    """Fit-grade parameter-grid row table of the worm backbone p0 over
    (lenKuhn, lenContour), baked on *device* with the converged rule; the
    circular cross-section 2·j1(qr)/qr stays an exact elementwise factor,
    so the radius axis never needs tabulating.  Returns ``(lookup,
    table)``: ``lookup(table, pdict)`` = blend · 2·j1_over_x(q·radius),
    and the lookup declares what it does besides the blend
    (``lookup.tab_params``, ``lookup.row_factor = ("cross_section",
    "radius")``), so that K2's table entry computes the same row.

    The bake runs the 513-step recurrence once per block of rows, and a
    block is sized by memory (``_KHO_BAKE_VALUES``), not by the JAX
    package's 64 rows: on the card each step is a handful of launches, so
    the whole unsmeared table is one block.

    With *smear* = (locs (Nq, n_off), smear_w) the backbone rows are baked
    on the FLATTENED locs grid (Nq·n_off wide); the lookup applies the
    exact cross-section at each offset, contracts with smear_w and returns
    ``(lookup, table, "intensity")``.  That lookup declares nothing: its
    rows are wider than the fit grid, and K2 takes them through its
    rows-in entry."""
    tab_params = tuple(p for p in bound.active
                       if p in ("lenKuhn", "lenContour"))
    # smeared rows are n_off× wider: trade parameter-grid resolution for
    # bake time/memory (interpolation error stays fit-grade)
    res = tables.cap_res(
        ({0: (), 1: (2048,), 2: (256, 48)} if smear is None else
         {0: (), 1: (1024,), 2: (96, 24)})[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    fixed = dict(bound.fixed)
    locs = None if smear is None else np.asarray(smear[0], np.float64)
    qd = torch.tensor(np.asarray(q_grid, np.float64) if smear is None
                      else locs.ravel(), dtype=dtype, device=device)

    def row_fn(vals):                   # (B, P) -> (B, row width)
        p = dict(fixed)
        for i, name in enumerate(tab_params):
            p[name] = vals[:, i:i + 1]
        row = torch.sqrt(_kho_p0_sq_conv(
            qd * p["lenKuhn"] / 3.0, 3.0 * p["lenContour"] / p["lenKuhn"]))
        return torch.broadcast_to(row, (vals.shape[0], qd.numel()))

    key = ("Kholodenko", tab_params, tables.grid_fingerprint(q_grid),
           tables.smear_fingerprint(smear), tuple(sorted(fixed.items())))
    tab = tables.build_param_table(
        row_fn, grids, dtype, block=max(1, _KHO_BAKE_VALUES // qd.numel()),
        cache_key=key, device=device)
    blend = tables.make_lookup(tab_params)

    if smear is not None:
        locs32 = torch.tensor(locs, dtype=dtype, device=device)
        sw32 = torch.tensor(np.asarray(smear[1], np.float64), dtype=dtype,
                            device=device)

        def smeared(table, pdict):
            # backbone from the table, exact cross-section per smearing
            # offset, then the contraction
            p0 = blend(table, pdict)
            p0 = p0.reshape(*p0.shape[:-1], *locs32.shape)
            f = p0 * 2.0 * j1_over_x(locs32 * _col(_col(pdict["radius"])))
            return (f * f) @ sw32

        return smeared, tab, "intensity"

    q32 = torch.tensor(np.asarray(q_grid, np.float64), dtype=dtype,
                       device=device)
    return _kho_lookup(blend, q32), tab


def _kho_lookup(blend, q32):
    """The unsmeared worm's lookup on the fit grid *q32*: the backbone's
    blend times the exact cross-section 2·j1_over_x(q·radius).  It
    declares what it does besides the blend (``tab_params``,
    ``row_factor``) and how to move to the columns of another grid
    (``on_grid(q)``: a q shard's points, or the same grid on another
    device, with the table's matching columns)."""
    def lookup(table, pdict):
        # backbone rows are valid only on the baked fit grid (the engine
        # always passes it); the cross-section factor is exact in q
        p0 = blend(table, pdict)
        pcs = 2.0 * j1_over_x(q32 * _col(pdict["radius"]))
        return p0 * pcs

    lookup.tab_params = blend.tab_params
    lookup.row_factor = ("cross_section", "radius")
    lookup.on_grid = lambda q: _kho_lookup(blend, q)
    return lookup


def _kho_volume(p):
    return math.pi * p["lenContour"] * ipow(p["radius"], 2)


Kholodenko = SASModel(
    name="Kholodenko",
    can_smear=True,
    doc="Worm-like chain after Kholodenko (Macromolecules 26 (1993) 4179)",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 5.0)), generator="logdec1",
                  is_fit=True, display_name="Radius"),
        ParamSpec("lenKuhn", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((10.0, 50.0)), generator="uniform",
                  is_fit=True, display_name="kuhn length"),
        ParamSpec("lenContour", NM.to_si(2.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((100.0, 1000.0)), generator="uniform",
                  is_fit=True, display_name="contour length"),
    ),
    ff=_kho_ff,
    ff_fast=_kho_ff_fast,
    ff_table_factory=_kho_table_factory,
    volume=_kho_volume,
    default_active=("radius", "lenKuhn", "lenContour"),
)
