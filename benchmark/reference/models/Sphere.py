"""Sphere (upstream McSAS ``models/sphere.py``; SASfit): the Rayleigh form
factor F(qr) = 3(sin qr − qr cos qr)/(qr)³, volume 4/3 π r³, absolute
volume v·sld²."""
import math

import torch

# upstream defaults, SI: sld 1e-6 Å⁻²
DEFAULTS = {"sld": 1e14}


def ff(q, p):
    """F(q·r) for q (..., Nq) and the parameters *p*, float64 with the
    series below |qr| = 1e-3 (where the closed form cancels)."""
    x = q * p["radius"]
    small = x.abs() < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    closed = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    x2 = x * x
    return torch.where(small, 1.0 - x2 / 10.0 + x2 * x2 / 280.0, closed)


def volume(p):
    return 4.0 * math.pi / 3.0 * p["radius"] ** 3


def absvolume(p):
    return volume(p) * p["sld"] ** 2


def engine_params(params):
    """The parameters the MC's χ² is evaluated with: the model's own."""
    return dict(params)
