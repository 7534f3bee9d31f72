"""Orientation-averaged cylinders (upstream McSAS
``models/cylindersisotropic.py``, SASfit eq. 3.215): the trapezoid over
x = cos α in [0, 1] on intDiv nodes of F² with
F = 2 J1(qR√(1−x²))/(qR√(1−x²)) · sin(qLx/2)/(qLx/2), L = 2·R·aspect,
and upstream's explicit endpoint values: J1(qR)/(2qR) at x = 0 and
sin(qL/2)/(qL/2) at x = 1.  The amplitude is √(16·∫).  J1 is
torch.special.bessel_j1 in float64."""
import math

import torch

# upstream defaults, SI (length is read only when useAspect is 0)
DEFAULTS = {"useAspect": 1.0, "length": 1e-8, "aspect": 10.0,
            "intDiv": 100.0, "sld": 1e14}
# the rule the MC's χ² is evaluated with: upstream's intDiv trapezoid
# carries up to ~20 % discretization noise at qR in [10, 100], so the fit
# evaluates the converged rule of at least this many nodes
ENGINE_NODES = 801


def _half(p):
    if float(p["useAspect"]) != 0.0:
        return p["radius"] * p["aspect"]
    return p["length"] / 2.0


def _sinc(z):
    small = z.abs() < 1e-8
    zs = torch.where(small, torch.ones_like(z), z)
    return torch.where(small, torch.ones_like(z), torch.sin(zs) / zs)


def ff(q, p):
    """The orientation-averaged amplitude for q (..., Nq), float64."""
    n = int(p["intDiv"])
    a = q * p["radius"]
    b = q * (2.0 * _half(p))
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=q.device)
    step = 1.0 / (n - 1)
    xi = x[1:-1]
    u = a[..., None] * torch.sqrt(1.0 - xi * xi)
    v = b[..., None] * xi
    mid = torch.special.bessel_j1(u) * torch.sin(v / 2.0) / (u * v)
    a_s = torch.where(a.abs() < 1e-8, torch.ones_like(a), a)
    f0 = torch.where(a.abs() < 1e-8, torch.full_like(a, 0.25),
                     0.5 * torch.special.bessel_j1(a_s) / a_s)
    f1 = _sinc(b / 2.0)
    integral = step * ((mid * mid).sum(dim=-1) + 0.5 * (f0 * f0 + f1 * f1))
    return torch.sqrt(16.0 * integral)


def volume(p):
    return math.pi * p["radius"] ** 2 * (2.0 * _half(p))


def absvolume(p):
    return volume(p) * p["sld"] ** 2


def engine_params(params):
    """The parameters the MC's χ² is evaluated with: the converged rule."""
    out = dict(params)
    out["intDiv"] = max(ENGINE_NODES, int(params["intDiv"]))
    return out
