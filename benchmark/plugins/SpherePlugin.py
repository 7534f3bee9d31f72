"""A user's drop-in model file: the Rayleigh sphere, written out as a user
writes a form factor that no built-in model describes, and loaded as
``python -m mcsas_tpu_torch --model-file SpherePlugin.py -m SpherePlugin``
loads it (upstream McSAS discovers such files at start-up,
``utils/findmodels.py``).

It declares ``elementwise_q`` and no parameter table, so the fused chunk
kernel, which keys on the built-in model objects, has no device function
for it: on the card the engine evaluates this ``ff`` over a whole segment's
candidates and hands the rows to the prefetch kernel's rows-in entry.

Its parameters, volume and absolute volume are upstream's Sphere's
(``models/sphere.py``): radius 1 nm to 1 µm active, SLD 1e-6 Å⁻².
"""
import math

import torch

from mcsas_tpu_torch.models import ParamSpec, SASModel
from mcsas_tpu_torch.utils.units import ANGSTROM_SLD, NM


def rayleigh(x):
    """3(sin x − x cos x)/x³; below 0.5 in float32 and 0.05 in float64,
    where the closed form cancels, its series to x⁶."""
    small = x.abs() < (0.5 if x.dtype == torch.float32 else 0.05)
    xs = torch.where(small, torch.ones_like(x), x)
    closed = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    x2 = x * x
    series = 1.0 - x2 / 10.0 + x2 * x2 / 280.0 - x2 * x2 * x2 / 15120.0
    return torch.where(small, series, closed)


def ff(q, p):
    return rayleigh(q * p["radius"])


def volume(p):
    return 4.0 * math.pi / 3.0 * p["radius"] ** 3


def absvolume(p):
    return volume(p) * p["sld"] ** 2


def surface(p):
    return 4.0 * math.pi * p["radius"] * p["radius"]


SpherePlugin = SASModel(
    name="SpherePlugin",
    elementwise_q=True,
    doc="a user's Rayleigh sphere, F = 3(sin qr − qr cos qr)/(qr)³",
    can_smear=True,
    params=(
        ParamSpec("radius", NM.to_si(10.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 1000.0)), generator="uniform",
                  is_fit=True, display_name="Sphere radius"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="scattering length density difference"),
    ),
    ff=ff,
    volume=volume,
    absvolume=absvolume,
    surface=surface,
    default_active=("radius",),
)
