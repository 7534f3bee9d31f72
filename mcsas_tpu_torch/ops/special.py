# -*- coding: utf-8 -*-
"""Numerically-stable special functions for form-factor kernels.

Dtype-polymorphic torch versions: float32 in the MC hot loop, float64 in
the post pass.  Naive evaluation of ``3(sin x − x cos x)/x³`` loses all
precision for small x from catastrophic cancellation, so the kernel
switches to a Taylor series below a dtype-aware threshold.  The CUDA chunk
kernel (csrc/mc_chunk.cu, ``sphere_ff``) repeats the float32 branch.
"""
from __future__ import annotations

import numpy as np
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


def ipow(x, n: int):
    """x**n for an integer n ≥ 1 by binary exponentiation, in the order
    of JAX's ``lax.integer_pow`` (what ``jnp.power`` does for an integer
    exponent): x² = x·x, x³ = x·x², x⁴ = x²·x², x⁶ = x²·x⁴.  Works on
    Python floats (float64) and tensors alike; the CUDA kernel
    (csrc/mc_models.cuh) multiplies in the same order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def sinc_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with the x→0 limit handled."""
    small = x.abs() < _small_threshold(x)
    xs = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    series = 1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0))
    return torch.where(small, series, torch.sin(xs) / xs)


# --- cylindrical Bessel J1 -------------------------------------------------
# Rational approximations after Abramowitz & Stegun 9.4.4 / 9.4.6,
# |error| < 1.3e-8 relative to J1 (the JAX package's coefficients).

_J1_SMALL = np.array([
    0.5, -0.56249985, 0.21093573, -0.03954289, 0.00443319, -0.00031761,
    0.00001109])
_J1_F = np.array([
    0.79788456, 0.00000156, 0.01659667, 0.00017105, -0.00249511,
    0.00113653, -0.00020033])
_J1_THETA = np.array([
    -2.35619449, 0.12499612, 0.00005650, -0.00637879, 0.00074348,
    0.00079824, -0.00029166])


def _poly(coeffs: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """Horner evaluation; the coefficients are rounded to t's dtype first,
    as the JAX package rounds its numpy coefficient arrays."""
    c = [float(v) for v in np.asarray(coeffs).astype(
        np.float32 if t.dtype == torch.float32 else np.float64)]
    acc = torch.zeros_like(t) + c[-1]
    for v in c[-2::-1]:
        acc = acc * t + v
    return acc


def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """Cylindrical Bessel function of the first kind, order 1."""
    sign = torch.sign(x)
    ax = x.abs()
    small = ax <= 3.0
    # |x| <= 3: J1(x)/x as polynomial in (x/3)^2
    t_small = (ax / 3.0) ** 2
    j_small = ax * _poly(_J1_SMALL, t_small)
    # |x| > 3: amplitude/phase form
    ax_big = torch.where(small, torch.full_like(ax, 3.0), ax)
    t_big = 3.0 / ax_big
    f1 = _poly(_J1_F, t_big)
    theta1 = ax_big + _poly(_J1_THETA, t_big)
    j_big = f1 * torch.cos(theta1) / torch.sqrt(ax_big)
    return sign * torch.where(small, j_small, j_big)


def j1_over_x(x: torch.Tensor) -> torch.Tensor:
    """J1(x)/x with the x→0 limit 1/2 handled exactly."""
    tiny = x.abs() < 1e-6
    xs = torch.where(tiny, torch.ones_like(x), x)
    return torch.where(tiny, 0.5 - x * x / 16.0, bessel_j1(xs) / xs)


# --- Percus-Yevick / LMA structure factor ----------------------------------

def py_G_over_A(A: torch.Tensor, alpha, beta, gamma) -> torch.Tensor:
    """G(A)/A for the LMA-PY hard-sphere structure factor (Kinning &
    Thomas; reference: src/mcsas/models/lmadensesphere.py:76-86),
    evaluated as G/A so 24μG/A never divides by zero, with series
    switches below the cancellation threshold (float32 |A| < 1, float64
    |A| < 0.2):

    g1/A = (sin A − A cos A)/A³              → 1/3 − A²/30 + A⁴/840 …
    g2/A = (2A sin A + (2−A²)cos A − 2)/A⁴   → 1/4 − A²/36 + A⁴/960 …
    g3/A = (−A⁴cos A + 4((3A²−6)cos A + (A³−6A)sin A + 6))/A⁶
                                             → 1/6 − A²/48 + A⁴/1200 …

    The operation order is the JAX package's; the CUDA kernel's
    ``py_g_over_a`` repeats the float32 branch."""
    small = A.abs() < (1.0 if A.dtype == torch.float32 else 0.2)
    As = torch.where(small, torch.ones_like(A), A)
    s, c = torch.sin(As), torch.cos(As)
    a2, a3, a4, a6 = (ipow(As, n) for n in (2, 3, 4, 6))
    g1 = (s - As * c) / a3
    g2 = (2.0 * As * s + (2.0 - a2) * c - 2.0) / a4
    g3 = (-a4 * c + 4.0 * ((3.0 * a2 - 6.0) * c
                           + (a3 - 6.0 * As) * s + 6.0)) / a6
    A2 = A * A
    g1s = 1.0 / 3.0 + A2 * (-1.0 / 30.0 + A2 * (
        1.0 / 840.0 + A2 * (-1.0 / 45360.0)))
    g2s = 1.0 / 4.0 + A2 * (-1.0 / 36.0 + A2 * (
        1.0 / 960.0 + A2 * (-1.0 / 50400.0)))
    g3s = 1.0 / 6.0 + A2 * (-1.0 / 48.0 + A2 * (
        1.0 / 1200.0 + A2 * (-1.0 / 60480.0)))
    g1 = torch.where(small, g1s, g1)
    g2 = torch.where(small, g2s, g2)
    g3 = torch.where(small, g3s, g3)
    return alpha * g1 + beta * g2 + gamma * g3
