# -*- coding: utf-8 -*-
"""Scaling+background fit and reduced-χ² computation.

The reference runs a scipy Levenberg-Marquardt least-squares fit of the two
linear coefficients (scale A, background b) on *every* MC iteration
(reference: src/mcsas/mcsas/backgroundscalingfit.py:94-139 and its call at
mcsas/mcsas.py:376-377).  Because the model ``y ≈ A·x + b`` is linear in
(A, b), the weighted least-squares optimum has a closed form — the 2×2
normal equations — which is exact and costs four reductions over the q
grid.

Semantics preserved from the reference:
 - ``find_background=False`` pins b = 0 (backgroundscalingfit.py:130-131),
 - ``positive_background=True`` restricts b ≥ 0: since χ² is quadratic in
   b, the constrained optimum is b = max(0, b_unconstrained) with A refit
   at the boundary,
 - χ² is the *reduced* χ² without parameter-count correction
   (chiSqr, :72-77), and the alternative goodness-of-fit of [Henn 2016]
   is available as ``agofs`` (aGoFsAlpha, :79-84, 136-138).

Every function is batched over the leading dimensions of ``x`` (..., Nq).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FitConstants:
    """Data-side constants of the weighted linear fit, precomputed once.

    ``y`` is the measured intensity on the fit grid, ``u`` the weights
    1/σ² (σ==0 treated as 1, matching backgroundscalingfit.py:115-117).
    ``s_u`` and ``s_uy`` are float64 sums rounded to the tensors' dtype.
    """
    y: torch.Tensor       # (Nq,)
    u: torch.Tensor       # (Nq,)
    s_u: float            # Σu
    s_uy: float           # Σu·y
    n: int                # number of fit points


def make_constants(f, fu, dtype=torch.float32, device="cpu"
                   ) -> FitConstants:
    y = torch.as_tensor(np.asarray(f, np.float64)).to(dtype)
    sigma = np.asarray(fu, dtype=np.float64).copy()
    sigma[sigma == 0.0] = 1.0
    u = torch.as_tensor(1.0 / sigma ** 2).to(dtype)
    s_u = float(u.double().sum().to(dtype))
    s_uy = float((u * y).double().sum().to(dtype))
    return FitConstants(y=y.to(device), u=u.to(device), s_u=s_u,
                        s_uy=s_uy, n=int(y.shape[0]))


@dataclass
class ScaleBg:
    scale: torch.Tensor
    background: torch.Tensor
    chisqr: torch.Tensor   # reduced χ²


def _shards(x, c):
    """*x* and *c* as lists of q shards: one tensor and one FitConstants
    are one shard."""
    if isinstance(x, (list, tuple)):
        if not isinstance(c, (list, tuple)) or len(c) != len(x):
            raise ValueError("q shards need one FitConstants each")
        return list(x), list(c)
    return [x], [c]


def _shard_sum(parts):
    """Σ over the last axis of each shard's float64 values, the shards'
    partial sums added in shard order on the first shard's device."""
    home = parts[0].device
    total = None
    for v in parts:
        s = v.to(torch.float64).sum(dim=-1).to(home)
        total = s if total is None else total + s
    return total


def moments(x, c):
    """The float64 sums (s_x, s_xx, s_xy) of the solve: Σu·x, Σu·x², Σu·x·y
    over the q grid, of one tensor or of its q shards (lists of tensors
    and of FitConstants, as :func:`solve_scale_bg` takes them); products
    in x's dtype."""
    xs, cs = _shards(x, c)
    ux = [ci.u * xi for xi, ci in zip(xs, cs)]
    return (_shard_sum(ux),
            _shard_sum([a * xi for a, xi in zip(ux, xs)]),
            _shard_sum([a * ci.y for a, ci in zip(ux, cs)]))


def solve_scale_bg(x, c, find_background: bool,
                   positive_background: bool) -> ScaleBg:
    """Exact weighted least-squares for y ≈ A·x + b, plus reduced χ².

    Products are formed in x's dtype and every sum accumulates in
    float64, the same operation order as the JAX package's solve under
    its package-wide x64 (mcsas_tpu/core/fitcore.py:62-131).  χ² is
    evaluated in residual form so it stays stable near convergence.

    *x* may also be a list of q shards (..., Nq_j), with *c* a list of
    their FitConstants (their columns of y and u; ``s_u``, ``s_uy`` and
    ``n`` of the whole grid): the counterpart of the JAX solve's ``psum``
    over the mesh's "q" axis.  Each shard's float64 partial sums are
    added in shard order on the first shard's device, where the scale
    and background are solved; they go back to every shard for the
    second round, the χ² sum.  The result lies on the first shard's
    device.  One shard is the unsharded solve, bit for bit.
    """
    xs, cs = _shards(x, c)
    dt = xs[0].dtype
    acc = torch.float64
    home = xs[0].device

    s_x, s_xx, s_xy = moments(xs, cs)
    # filled on the device: a copy from the host would wait for the stream
    s_u = torch.full((), cs[0].s_u, dtype=acc, device=home)
    s_uy = torch.full((), cs[0].s_uy, dtype=acc, device=home)

    # scale-invariant guards: x may span absurd absolute magnitudes
    # (SI intensities ~1e-30), so degeneracy is judged relative to
    # s_u·s_xx (det = s_u·s_xx·(1 − corr²)), never against absolute eps
    rel_eps = 1e-6 if dt == torch.float32 else 1e-12
    xx_zero = s_xx <= 0.0
    a_nobg = torch.where(xx_zero, torch.zeros_like(s_xy),
                         s_xy / torch.where(xx_zero, torch.ones_like(s_xx),
                                            s_xx))
    if find_background:
        denom = s_u * s_xx
        det = denom - s_x * s_x
        degenerate = xx_zero | (det <= rel_eps * denom)
        safe_det = torch.where(degenerate, torch.ones_like(det), det)
        a_bg = (s_u * s_xy - s_x * s_uy) / safe_det
        b_bg = (s_uy - a_bg * s_x) / s_u
        a = torch.where(degenerate, a_nobg, a_bg)
        b_deg = (s_uy - a_nobg * s_x) / s_u
        b = torch.where(degenerate, b_deg, b_bg)
        if positive_background:
            neg = b < 0.0
            a = torch.where(neg, a_nobg, a)
            b = torch.clamp_min(b, 0.0)
    else:
        a = a_nobg
        b = torch.zeros_like(a)

    a = a.to(dt)
    b = b.to(dt)
    sq = []
    for xi, ci in zip(xs, cs):
        ai, bi = a.to(xi.device), b.to(xi.device)
        r = ci.y - ai[..., None] * xi - bi[..., None]
        sq.append(ci.u * r * r)
    chisqr = (_shard_sum(sq) / cs[0].n).to(dt)
    return ScaleBg(scale=a, background=b, chisqr=chisqr)


def chisqr_at(x, scale, background, c: FitConstants):
    """Reduced χ² at a given (A, b) — for re-evaluating stored fits."""
    r = c.y - scale * x - background
    return torch.sum(c.u * r * r, dim=-1) / c.n


def agofs(x, scale, background, c: FitConstants, num_params: int):
    """Alternative goodness-of-fit after Henn 2016
    (doi:10.1107/S2053273316013206); reference:
    backgroundscalingfit.py:79-84,136-138."""
    model = scale * x + background
    val = torch.sum((c.y - model) ** 2, dim=-1) / torch.sum(1.0 / c.u)
    # dof guard: a fit grid with <= num_params points must not divide
    # by zero/negative (mirrors the reference's n_pts/max(n-P, 1) clamp)
    return val * c.n / max(c.n - num_params, 1.0)
