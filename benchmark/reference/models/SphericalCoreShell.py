"""SphericalCoreShell (upstream McSAS ``models/sphericalcoreshell.py``:
SASfit "Spherical Shell III", manual section 3.1.4): a core of radius R
and SLD η_c in a shell of thickness t and SLD η_s, in a solvent of SLD
η_sol.

    F(q) = K(q, R + t, η_s − η_sol) − (v_c / v_t)·K(q, R, η_s − η_c)
    K(q, r, Δη) = Δη·3(sin qr − qr cos qr)/(qr)³

with v_c = 4/3 π R³ and v_t = 4/3 π (R + t)³ (upstream lines 50-69); the
volume is the whole particle's, v_t.  Departures from upstream, none of
which changes a value beyond float64 rounding:

* the Rayleigh function takes its series 1 − x²/10 + x⁴/280 below
  |x| = 1e-3, where the closed form cancels (upstream evaluates the
  closed form everywhere, and q = 0 is not in any frame);
* the model defines no absolute volume of its own, so it is the volume,
  as upstream's base class gives it;
* parameters arrive as tensors shaped against q (a batch of
  contributions) or as plain numbers, SI units throughout.
"""
import math

import torch

# upstream defaults, SI: SLDs of 3.16e-6, 2.53e-6 and 0 Å⁻²
DEFAULTS = {"eta_c": 3.16e14, "eta_s": 2.53e14, "eta_sol": 0.0}


def rayleigh(x):
    """3(sin x − x cos x)/x³ in float64, the series below |x| = 1e-3."""
    small = x.abs() < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    closed = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    x2 = x * x
    return torch.where(small, 1.0 - x2 / 10.0 + x2 * x2 / 280.0, closed)


def ff(q, p):
    """F(q) for q (..., Nq) and the parameters *p*."""
    r, t = p["radius"], p["t"]
    ratio = (r / (r + t)) ** 3                     # v_c / v_t
    shell = (p["eta_s"] - p["eta_sol"]) * rayleigh(q * (r + t))
    core = (p["eta_s"] - p["eta_c"]) * rayleigh(q * r)
    return shell - ratio * core


def volume(p):
    return 4.0 * math.pi / 3.0 * (p["radius"] + p["t"]) ** 3


def absvolume(p):
    return volume(p)


def engine_params(params):
    """The parameters the MC's χ² is evaluated with: the model's own."""
    return dict(params)
