# -*- coding: utf-8 -*-
"""PyTorch port: the closed-form scale/background solve, held against the
JAX package's float64 solve on identical numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mcsas_tpu.core import fitcore as jax_fitcore  # noqa: E402
from mcsas_tpu_torch.core import fitcore  # noqa: E402


def _problem(seed=0, nq=60):
    rs = np.random.default_rng(seed)
    x = rs.uniform(0.1, 2.0, nq)
    y = 3.0 * x + 0.5 + rs.normal(0, 0.05, nq)
    fu = rs.uniform(0.02, 0.1, nq)
    fu[3] = 0.0                       # σ == 0 is treated as 1
    return x, y, fu


def _x_cases(x):
    """A regular curve plus every degenerate shape the guards handle."""
    return {
        "regular": x,
        "zero": np.zeros_like(x),                 # s_xx == 0
        "constant": np.full_like(x, 0.7),         # det == 0: x ∝ 1
        "negative-bg": x + 1.0,                   # b < 0 at the optimum
    }


@pytest.mark.parametrize("find_bg,pos_bg", [(True, False), (True, True),
                                            (False, False), (False, True)])
@pytest.mark.parametrize("case", ["regular", "zero", "constant",
                                  "negative-bg"])
def test_solve_matches_jax_float64(find_bg, pos_bg, case):
    # tolerance: 1e-12 relative, with an absolute floor of 1e-12·max|y|
    # for values that are zero up to rounding (the background of a
    # degenerate x is a cancellation remainder of either sign)
    x, y, fu = _problem()
    xv = _x_cases(x)[case]
    ours = fitcore.solve_scale_bg(
        torch.as_tensor(xv), fitcore.make_constants(y, fu, torch.float64),
        find_bg, pos_bg)
    ref = jax_fitcore.solve_scale_bg(
        jnp.asarray(xv), jax_fitcore.make_constants(y, fu, jnp.float64),
        find_bg, pos_bg)
    for name in ("scale", "background", "chisqr"):
        a = float(getattr(ours, name))
        b = float(getattr(ref, name))
        assert a == pytest.approx(b, rel=1e-12,
                                  abs=1e-12 * np.max(np.abs(y))), name
    if pos_bg:
        assert float(ours.background) >= 0.0


def test_solve_is_batched_over_leading_dims():
    x, y, fu = _problem(seed=1)
    c = fitcore.make_constants(y, fu, torch.float64)
    xs = np.stack([x * s for s in (0.5, 1.0, 2.0)])[:, None, :]  # (3, 1, Nq)
    batched = fitcore.solve_scale_bg(torch.as_tensor(xs), c, True, False)
    assert batched.scale.shape == (3, 1)
    for i in range(3):
        one = fitcore.solve_scale_bg(torch.as_tensor(xs[i, 0]), c, True,
                                     False)
        assert float(batched.chisqr[i, 0]) == pytest.approx(
            float(one.chisqr), rel=1e-14)


def test_solve_float32_keeps_dtype_and_matches_jax():
    # float32 products and float64 sums on both sides in the same order:
    # given the same constants the solve is bitwise equal.  The constants
    # themselves differ by at most one float32 ulp: JAX sums Σu and Σu·y
    # in float32 (XLA's order), the port rounds a float64 sum.
    x, y, fu = _problem(seed=2)
    x32 = torch.as_tensor(x.astype(np.float32))
    jc = jax_fitcore.make_constants(y, fu, jnp.float32)
    ours_c = fitcore.make_constants(y, fu, torch.float32)
    for name in ("s_u", "s_uy"):
        a, b = np.float32(getattr(ours_c, name)), np.float32(
            getattr(jc, name))
        assert abs(a - b) <= np.spacing(b), name
    same_c = fitcore.FitConstants(y=ours_c.y, u=ours_c.u,
                                  s_u=float(jc.s_u), s_uy=float(jc.s_uy),
                                  n=ours_c.n)
    ours = fitcore.solve_scale_bg(x32, same_c, True, False)
    ref = jax_fitcore.solve_scale_bg(jnp.asarray(x32.numpy()), jc, True,
                                     False)
    assert ours.chisqr.dtype == torch.float32
    for name in ("scale", "background", "chisqr"):
        assert float(getattr(ours, name)) == float(getattr(ref, name)), name


def test_chisqr_at_and_agofs_match_jax():
    x, y, fu = _problem(seed=4)
    c = fitcore.make_constants(y, fu, torch.float64)
    jc = jax_fitcore.make_constants(y, fu, jnp.float64)
    xt = torch.as_tensor(x)
    assert float(fitcore.chisqr_at(xt, 2.9, 0.4, c)) == pytest.approx(
        float(jax_fitcore.chisqr_at(jnp.asarray(x), 2.9, 0.4, jc)),
        rel=1e-12)
    assert float(fitcore.agofs(xt, 2.9, 0.4, c, 1)) == pytest.approx(
        float(jax_fitcore.agofs(jnp.asarray(x), 2.9, 0.4, jc, 1)),
        rel=1e-12)
