# -*- coding: utf-8 -*-
"""PyTorch port: special functions, the Sphere and CylindersIsotropic
models, the model registry and the proposal generators, held against the
JAX package on the same numpy inputs."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.ops import special as jax_special  # noqa: E402
from mcsas_tpu_torch.core import rng  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import special  # noqa: E402


def _x_grid(dtype):
    """Log grid over the useful range plus both series switch points and
    their neighbouring floats, signs included."""
    x = np.logspace(-4, 3, 2001)
    edges = []
    for t in (0.5, 0.05):
        t = dtype(t)
        edges += [np.nextafter(t, dtype(0)), t, np.nextafter(t, dtype(1))]
    x = np.concatenate([x, edges, [0.0]]).astype(dtype)
    return np.concatenate([x, -x])


def test_sphere_ff_float64_matches_jax():
    # tolerance: 1e-12 relative to the curve's magnitude — both sides
    # evaluate the same closed form / series in float64; only the libm
    # sin/cos differ (last-ulp), which the cancellation near the form
    # factor's zeros amplifies relative to |ff| there but not to max|ff|
    x = _x_grid(np.float64)
    ours = special.sphere_ff(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax_special.sphere_ff(jnp.asarray(x)))
    scale = np.maximum(np.abs(ref), 1e-3)
    assert np.max(np.abs(ours - ref) / scale) <= 1e-12


def test_sphere_ff_series_branch_is_bitwise():
    # below the switch both sides run the same polynomial in the same
    # operation order: equal to the last bit in either dtype
    for dt, t in ((np.float32, 0.5), (np.float64, 0.05)):
        x = np.linspace(-t, t, 4001, dtype=dt)[1:-1]
        ours = special.sphere_ff(torch.as_tensor(x)).numpy()
        ref = np.asarray(jax_special.sphere_ff(jnp.asarray(x)))
        np.testing.assert_array_equal(ours, ref)


def test_sphere_ff_float32_within_jax_error():
    # tolerance: the port's float32 error against the float64 truth is at
    # most twice JAX's own float32 error (+1 float32 ulp of slack)
    x32 = _x_grid(np.float32)
    truth = np.asarray(jax_special.sphere_ff(
        jnp.asarray(x32.astype(np.float64))))
    ours = special.sphere_ff(torch.as_tensor(x32)).numpy()
    ref = np.asarray(jax_special.sphere_ff(jnp.asarray(x32)))
    assert ours.dtype == np.float32
    scale = np.maximum(np.abs(truth), 1e-3)
    err_ours = np.max(np.abs(ours - truth) / scale)
    err_jax = np.max(np.abs(ref - truth) / scale)
    assert err_ours <= 2.0 * err_jax + 6e-8, (err_ours, err_jax)


@pytest.mark.parametrize("fn", ["ff", "volume", "absvolume", "surf"])
def test_sphere_model_matches_jax(fn):
    # tolerance: 1e-12 relative (float64, same formulas)
    rs = np.random.default_rng(3)
    radii = rs.uniform(1e-9, 1e-6, 64)
    q = np.logspace(6, 9.5, 80)
    ours_b = get_model("Sphere").bind()
    ref_b = jax_get_model("Sphere").bind()
    assert ours_b.ranges == ref_b.ranges and ours_b.fixed == ref_b.fixed
    pv = radii[:, None]
    if fn == "ff":
        # the port broadcasts (64, 1, 1) parameter vectors against (80,) q
        ours = ours_b.ff(torch.as_tensor(q),
                         torch.as_tensor(pv[:, None, :])).numpy()
        ref = np.stack([np.asarray(ref_b.ff(jnp.asarray(q), jnp.asarray(p)))
                        for p in pv])
    else:
        ours = np.asarray(getattr(ours_b, fn)(torch.as_tensor(pv)),
                          np.float64)
        ref = np.asarray([float(getattr(ref_b, fn)(jnp.asarray(p)))
                          for p in pv])
        ours = np.broadcast_to(ours, ref.shape)
    scale = np.maximum(np.abs(ref), 1e-3 * np.max(np.abs(ref)))
    assert np.max(np.abs(ours - ref) / scale) <= 1e-12


_CYL_FUNCS = ("sinc_sin", "bessel_j1", "j1_over_x")


@pytest.mark.parametrize("fn", _CYL_FUNCS)
def test_cylinder_special_float64_matches_jax(fn):
    # tolerance: 1e-13 relative to max(|ref|, 1e-3) — the same series,
    # polynomials and closed forms in float64; only libm's sin/cos/sqrt
    # differ in the last ulp
    x = _x_grid(np.float64)
    ours = getattr(special, fn)(torch.as_tensor(x)).numpy()
    ref = np.asarray(getattr(jax_special, fn)(jnp.asarray(x)))
    assert np.max(np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-3)) \
        <= 1e-13


@pytest.mark.parametrize("fn", _CYL_FUNCS)
def test_cylinder_special_float32_within_jax_error(fn):
    # tolerance: as for sphere_ff — the port's float32 error against the
    # float64 truth is at most twice JAX's own float32 error, plus one
    # float32 ulp of slack (the polynomial coefficients are rounded to
    # float32 on both sides)
    x32 = _x_grid(np.float32)
    truth = np.asarray(getattr(jax_special, fn)(
        jnp.asarray(x32.astype(np.float64))))
    ours = getattr(special, fn)(torch.as_tensor(x32)).numpy()
    ref = np.asarray(getattr(jax_special, fn)(jnp.asarray(x32)))
    assert ours.dtype == np.float32
    scale = np.maximum(np.abs(truth), 1e-3)
    err_ours = np.max(np.abs(ours - truth) / scale)
    err_jax = np.max(np.abs(ref - truth) / scale)
    assert err_ours <= 2.0 * err_jax + 6e-8, (err_ours, err_jax)


@pytest.mark.parametrize("fn", ["ff", "volume", "absvolume"])
@pytest.mark.parametrize("use_aspect", [1.0, 0.0])
def test_cylinder_model_matches_jax(fn, use_aspect):
    # tolerance: 1e-12 relative (float64, same formulas and the same
    # intDiv=100 trapezoid; the quadrature sums in another order)
    rs = np.random.default_rng(8)
    radii = rs.uniform(1e-9, 3e-7, 24)
    q = np.geomspace(1e7, 2e9, 60)
    kw = dict(active=("radius",),
              fixed={"useAspect": use_aspect, "length": 80e-9})
    ours_b = get_model("CylindersIsotropic").bind(**kw)
    ref_b = jax_get_model("CylindersIsotropic").bind(**kw)
    assert ours_b.ranges == ref_b.ranges and ours_b.fixed == ref_b.fixed
    pv = radii[:, None]
    if fn == "ff":
        ours = ours_b.ff(torch.as_tensor(q),
                         torch.as_tensor(pv[:, None, :])).numpy()
        ref = np.stack([np.asarray(ref_b.ff(jnp.asarray(q), jnp.asarray(p)))
                        for p in pv])
    else:
        ours = np.asarray(getattr(ours_b, fn)(torch.as_tensor(pv)),
                          np.float64).reshape(-1)
        ref = np.asarray([float(getattr(ref_b, fn)(jnp.asarray(p)))
                          for p in pv])
    scale = np.maximum(np.abs(ref), 1e-3 * np.max(np.abs(ref)))
    assert np.max(np.abs(ours - ref) / scale) <= 1e-12


def test_reference_volume_matches_jax():
    for name in ("Sphere", "CylindersIsotropic"):
        ours = get_model(name).bind().reference_volume()
        ref = jax_get_model(name).bind().reference_volume()
        assert ours == pytest.approx(ref, rel=1e-15)


def test_registry_names_unported_models():
    assert get_model("Sphere").name == "Sphere"
    assert get_model("CylindersIsotropic").name == "CylindersIsotropic"
    with pytest.raises(KeyError, match="later PR"):
        get_model("CylindersIsotropicAspect")
    with pytest.raises(KeyError, match="unknown model"):
        get_model("NoSuchModel")


@pytest.mark.parametrize("gen", ["uniform", "logdec1", "logdec2",
                                 "logdec3"])
def test_draw_unit_distribution(gen):
    # logdecN: g = (10^(N·U) − 1)/10^N, so P(g ≤ t) = log10(1 + t·10^N)/N
    g = torch.Generator().manual_seed(5)
    u = rng.draw_unit(g, (gen,), count=200_000).numpy()[:, 0]
    assert u.min() >= 0.0 and u.max() < 1.0
    n = rng.DECADES.get(gen)
    for t in (0.001, 0.01, 0.1, 0.5):
        want = t if n is None else math.log10(1.0 + t * 10 ** n) / n
        assert np.mean(u <= t) == pytest.approx(want, abs=5e-3)


def test_draw_params_in_range_and_seeded():
    bound = get_model("Sphere").bind()
    a = rng.draw_params(torch.Generator().manual_seed(1), bound, count=1000)
    b = rng.draw_params(torch.Generator().manual_seed(1), bound, count=1000)
    lo, hi = bound.ranges[0]
    assert a.shape == (1000, 1) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= np.float32(lo)
    assert float(a.max()) <= np.float32(hi)


def test_local_candidates_match_jax():
    # same operations in the same order: equal to float32 rounding
    from mcsas_tpu.core.engine import local_candidates as jax_local
    rs = np.random.default_rng(9)
    cur = rs.uniform(1e-9, 1e-6, (3, 1)).astype(np.float32)
    un = rs.uniform(0, 1, (3, 16, 1)).astype(np.float32)
    lo = np.asarray([1e-9], np.float32)
    hi = np.asarray([1e-6], np.float32)
    ours = rng.local_candidates(torch.as_tensor(cur), torch.as_tensor(un),
                                torch.as_tensor(lo), torch.as_tensor(hi),
                                0.2).numpy()
    ref = np.asarray(jax_local(jnp.asarray(cur), jnp.asarray(un),
                               jnp.asarray(lo), jnp.asarray(hi), 0.2))
    np.testing.assert_allclose(ours, ref, rtol=2e-7)
