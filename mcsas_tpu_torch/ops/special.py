# -*- coding: utf-8 -*-
"""Numerically-stable special functions for form-factor kernels.

Dtype-polymorphic torch versions: float32 in the MC hot loop, float64 in
the post pass.  Naive evaluation of ``3(sin x − x cos x)/x³`` loses all
precision for small x from catastrophic cancellation, so the kernel
switches to a Taylor series below a dtype-aware threshold.  The CUDA chunk
kernel (csrc/mc_chunk.cu, ``sphere_ff``) repeats the float32 branch.
"""
from __future__ import annotations

import torch


def _small_threshold(x: torch.Tensor) -> float:
    # series are accurate to ~eps below these thresholds for each dtype
    return 0.5 if x.dtype == torch.float32 else 0.05


def sphere_ff(x: torch.Tensor) -> torch.Tensor:
    """Rayleigh sphere form factor 3(sin x − x cos x)/x³ with x = q·r.

    Reference math: src/mcsas/models/sphere.py:55-63.  Series switch keeps
    full relative precision near x→0 where the closed form cancels.
    """
    small = x.abs() < _small_threshold(x)
    xs = torch.where(small, torch.ones_like(x), x)  # no 0-div in dead lane
    closed = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    x2 = x * x
    series = 1.0 + x2 * (-1.0 / 10.0 + x2 * (
        1.0 / 280.0 + x2 * (-1.0 / 15120.0)))
    return torch.where(small, series, closed)
