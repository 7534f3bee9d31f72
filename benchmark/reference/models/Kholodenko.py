"""The Kholodenko worm (upstream McSAS ``models/kholodenko.py``; A. L.
Kholodenko, Macromolecules 26, 4179, 1993): a worm-like chain of Kuhn
length b and contour length L with a circular cross-section of radius r.

With t = q·b/3 and x = 3·L/b, the backbone's p0 = √I(t, x),

    I(t, x) = ∫₀ˣ f(z)·(2/x)(1 − z/x) dz,

where f is the Dirac propagator's kernel in its three branches:
sinh(E·z)/(E·sinh z), E = √(1 − t²), for t < 1; z/sinh z for t = 1;
sin(F·z)/(F·sinh z), F = √(t² − 1), for t > 1.  The amplitude is
ff = p0 · 2·J1(q·r)/(q·r), not squared, as upstream returns it; the
volume is π·r²·L and the absolute volume the volume (the model has no
contrast parameter).

Departures from upstream, none of which moves a value beyond float64
round-off and the quadrature's own error:

* Upstream integrates I by adaptive ``scipy.integrate.quad`` (epsrel
  1e-10) for each q.  Here I is composite Gauss-Legendre on panels
  (:data:`NODES` nodes each), batched over every (t, x) element: on the
  head [0, min(x, HEAD)] each panel spans at most :data:`PANEL_RADIANS`
  of the oscillation sin(F·z) and at most :data:`SMOOTH_WIDTH` of z, so
  the panel count of an element grows with its frequency F (1,910
  panels of the head at F = 167, the largest q·b of upstream's ranges
  on q ≤ 10 nm⁻¹); each branch's elements are sorted by that count and
  integrated in groups, each on the panels its largest member needs.
  Beyond HEAD the kernel for t ≥ 1 is below 2·z·e^(−z) (under 1e-14 of
  the integral) and is dropped; for t < 1 the smooth tail [HEAD, x] gets
  panels of :data:`TAIL_WIDTH`.  Against adaptive quadrature at epsrel
  1e-12 the rule is within 4e-13 relative, t from 0.01 to 167 and x
  from 6 to 300.
* The hyperbolic ratios are evaluated through e^(−z) and expm1, so that
  sinh never overflows: sinh(E·z)/sinh z = e^((E−1)·z)·expm1(−2E·z) /
  expm1(−2z), and 1/sinh z = −2·e^(−z)/expm1(−2z).
* J1(u)/u takes its limit 1/2 below |u| = 1e-8; J1 is
  ``torch.special.bessel_j1`` in float64.

``ff`` bounds its own temporaries: a group of elements is integrated
over blocks of panels, :data:`BLOCK_VALUES` float64 values a temporary.
"""
import math

import numpy as np
import torch

# upstream defaults, SI (radius 1 nm, Kuhn length 1 nm, contour 2 nm)
DEFAULTS = {"radius": 1e-9, "lenKuhn": 1e-9, "lenContour": 2e-9}
NODES = 8                 # Gauss-Legendre nodes a panel
PANEL_RADIANS = math.pi   # a panel's largest span of F·z where t > 1
SMOOTH_WIDTH = 2.0        # a panel's largest width in z
HEAD = 36.0               # the head [0, min(x, HEAD)]
TAIL_WIDTH = 4.0          # a tail panel's width in z (t < 1 only)
GROUPS = 16               # groups of elements sorted by their panel count
BLOCK_VALUES = 2 ** 23    # float64 values one temporary may hold

_GL_X, _GL_W = np.polynomial.legendre.leggauss(NODES)


def _below(z, t):
    """f(z) for t < 1: sinh(E·z)/(E·sinh z)."""
    e = torch.sqrt(1.0 - t * t)
    return torch.exp((e - 1.0) * z) * torch.expm1(-2.0 * e * z) / (
        e * torch.expm1(-2.0 * z))


def _above(z, t):
    """f(z) for t > 1: sin(F·z)/(F·sinh z)."""
    f = torch.sqrt(t * t - 1.0)
    return -2.0 * torch.sin(f * z) * torch.exp(-z) / (
        f * torch.expm1(-2.0 * z))


def _at_one(z, t):
    """f(z) for t = 1: z/sinh z."""
    return -2.0 * z * torch.exp(-z) / torch.expm1(-2.0 * z)


def _panels(kernel, t, x, lo, hi, n_panels):
    """∫ over [lo, hi] of kernel(z, t)·(2/x)(1 − z/x) for the elements t,
    x, lo, hi (M,), on *n_panels* equal panels of each element's
    interval, in blocks of panels."""
    dev = t.device
    gx = torch.as_tensor(_GL_X, dtype=torch.float64, device=dev)
    gw = torch.as_tensor(_GL_W, dtype=torch.float64, device=dev)
    width = (hi - lo) / n_panels                     # (M,)
    t1, x1, lo1, w1 = t[:, None], x[:, None], lo[:, None], width[:, None]
    per_block = max(1, BLOCK_VALUES // (t.numel() * NODES))
    total = torch.zeros_like(t)
    for p0 in range(0, n_panels, per_block):
        k = torch.arange(p0, min(p0 + per_block, n_panels),
                         dtype=torch.float64, device=dev)
        # the nodes of panels k, panel by panel: (M, len(k)·NODES)
        u = ((k[:, None] + 0.5 + 0.5 * gx[None, :]).reshape(-1))[None, :]
        z = lo1 + w1 * u
        g = (2.0 / x1) * (1.0 - z / x1)
        wts = (0.5 * gw).repeat(k.numel())[None, :] * w1
        total = total + (wts * kernel(z, t1) * g).sum(dim=-1)
    return total


def p0_squared(t, x):
    """I(t, x), float64, elementwise over the broadcast shape of *t* and
    *x*: each branch of f on its own elements, grouped by the panels of
    the head they need."""
    t, x = torch.broadcast_tensors(t, x)
    shape = t.shape
    t = t.reshape(-1).contiguous()
    x = x.reshape(-1).contiguous()
    out = torch.zeros_like(t)
    head = torch.clamp_max(x, HEAD)
    rate = torch.maximum(
        torch.sqrt(torch.clamp_min(t * t - 1.0, 0.0)) / PANEL_RADIANS,
        torch.full_like(t, 1.0 / SMOOTH_WIDTH))
    need = torch.ceil(head * rate).clamp_min(1.0)
    for kernel, mask in ((_below, t < 1.0), (_above, t > 1.0),
                         (_at_one, t == 1.0)):
        sel = torch.nonzero(mask).reshape(-1)
        if not sel.numel():
            continue
        sel = sel[torch.argsort(need[sel])]
        size = -(-sel.numel() // GROUPS)
        for idx in sel.split(size):
            ti, xi = t[idx], x[idx]
            out[idx] = _panels(kernel, ti, xi, torch.zeros_like(ti),
                               head[idx], int(need[idx].max()))
    tail = torch.nonzero((t < 1.0) & (x > HEAD)).reshape(-1)
    if tail.numel():
        ti, xi = t[tail], x[tail]
        n = int(math.ceil(float((xi - HEAD).max()) / TAIL_WIDTH))
        out[tail] += _panels(_below, ti, xi, torch.full_like(ti, HEAD), xi,
                             n)
    return out.reshape(shape)


def _tensor(v, like):
    return torch.as_tensor(v, dtype=torch.float64, device=like.device)


def ff(q, p):
    """The amplitude p0·2·J1(q·r)/(q·r) for q (..., Nq), float64."""
    kuhn = _tensor(p["lenKuhn"], q)
    contour = _tensor(p["lenContour"], q)
    radius = _tensor(p["radius"], q)
    p0 = torch.sqrt(torch.clamp_min(
        p0_squared(q * kuhn / 3.0, 3.0 * contour / kuhn), 0.0))
    u = q * radius
    small = u.abs() < 1e-8
    us = torch.where(small, torch.ones_like(u), u)
    cross = torch.where(small, torch.ones_like(u),
                        2.0 * torch.special.bessel_j1(us) / us)
    return p0 * cross


def volume(p):
    return math.pi * p["radius"] ** 2 * p["lenContour"]


def absvolume(p):
    return volume(p)


def engine_params(params):
    """The parameters the MC's χ² is evaluated with: the model's own, so
    that the χ² the check recomputes is the exact one."""
    return dict(params)
