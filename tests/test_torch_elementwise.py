# -*- coding: utf-8 -*-
"""PyTorch port: the elementwise models that the CUDA chunk kernel K1 runs
besides Sphere — LMADenseSphere, GaussianChain, SphericalCoreShell — with
their special functions and intensity rows, held against the JAX package
on the same numpy inputs, and their float64 curves against the running
reference McSAS (testdata/reference_ff_fixture.json) without JAX."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import api as jax_api  # noqa: E402
from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import chains as jax_chains  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.ops import special as jax_special  # noqa: E402
from mcsas_tpu_torch import api, data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import chains, get_model  # noqa: E402
from mcsas_tpu_torch.models.sphere import lma_coefficients  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, special  # noqa: E402

_TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
MODELS = ("LMADenseSphere", "GaussianChain", "SphericalCoreShell")


def _grid(switches, dtype, lo=-5, hi=3, signed=True):
    """Log grid plus each series switch point and its neighbouring floats
    (and 0), with negatives when *signed*."""
    x = [np.logspace(lo, hi, 2001)]
    for t in switches:
        t = dtype(t)
        x.append([np.nextafter(t, dtype(0)), t, np.nextafter(t, dtype(1))])
    x = np.concatenate(x + [[0.0]]).astype(dtype)
    return np.concatenate([x, -x]) if signed else x


def _f32_within_jax_error(ours, ref, truth):
    # the port's float32 error against the float64 truth is at most twice
    # JAX's own float32 error, plus one float32 ulp of slack (relative to
    # max(|truth|, 1e-3·max|truth|))
    assert ours.dtype == np.float32
    scale = np.maximum(np.abs(truth), 1e-3 * np.max(np.abs(truth)))
    err_ours = np.max(np.abs(ours - truth) / scale)
    err_jax = np.max(np.abs(ref - truth) / scale)
    assert err_ours <= 2.0 * err_jax + 6e-8, (err_ours, err_jax)


# ------------------------------------------------- special functions

def _g_over_a_truth(a):
    """py_G_over_A in long double: JAX's float64 series below |A| < 0.2,
    the closed form above (its cancellation costs long double ~1e-14
    there)."""
    a = np.asarray(a, np.longdouble)
    al, be, ga = (np.longdouble(c) for c in _ABG)
    a2 = a * a
    ser = [c0 + a2 * (c1 + a2 * (c2 + a2 * c3)) for c0, c1, c2, c3 in (
        (1 / 3, -1 / 30, 1 / 840, -1 / 45360), (1 / 4, -1 / 36, 1 / 960,
                                                -1 / 50400),
        (1 / 6, -1 / 48, 1 / 1200, -1 / 60480))]
    small = np.abs(a) < 0.2
    s = np.where(small, 1, a)
    sn, cs = np.sin(s), np.cos(s)
    g1 = (sn - s * cs) / s ** 3
    g2 = (2 * s * sn + (2 - s ** 2) * cs - 2) / s ** 4
    g3 = (-s ** 4 * cs + 4 * ((3 * s ** 2 - 6) * cs
                              + (s ** 3 - 6 * s) * sn + 6)) / s ** 6
    g = [np.where(small, gs, gc) for gs, gc in zip(ser, (g1, g2, g3))]
    return al * g[0] + be * g[1] + ga * g[2]


def _debye_truth(u):
    """gauss_debye_over_u in long double: JAX's float64 series below
    u < 1e-3, the closed form above."""
    u = np.asarray(u, np.longdouble)
    small = np.abs(u) < 1e-3
    us = np.where(small, 1, u)
    closed = np.sqrt(2 * (np.exp(-us) - 1 + us)) / us
    series = np.sqrt(1 + u * (-1 / np.longdouble(3) + u * (
        1 / np.longdouble(12) + u * (-1 / np.longdouble(60) + u / 360))))
    return np.where(small, series, closed)


# (the port's function of a numpy array, JAX's, the long-double truth,
# switches (float32, float64), signed grid); G/A at the LMA coefficients
# of μ = 0.3
_ABG = lma_coefficients(0.3)
_SPECIAL = {
    "py_G_over_A": (
        lambda x: special.py_G_over_A(torch.as_tensor(x), *_ABG).numpy(),
        lambda x: np.asarray(jax_special.py_G_over_A(jnp.asarray(x), *_ABG)),
        _g_over_a_truth, (1.0, 0.2), True),
    "gauss_debye_over_u": (
        lambda x: chains.gauss_debye_over_u(torch.as_tensor(x)).numpy(),
        lambda x: np.asarray(jax_chains._gauss_debye_over_u(jnp.asarray(x))),
        _debye_truth, (0.3, 1e-3), False),
}


@pytest.mark.parametrize("fn", sorted(_SPECIAL))
def test_special_float64_matches_jax(fn):
    # tolerance, relative to max(|truth|, 1e-3·max|truth|) against a long
    # double evaluation of the same series and closed forms: 1e-12, or
    # twice JAX's own float64 error where that is larger — one ulp of
    # libm's exp/sin/cos, which PyTorch and XLA round differently, grows
    # by the closed form's cancellation just above the float64 switch
    # (~1e-10 for the Debye function at u = 1e-3)
    ours_fn, ref_fn, truth_fn, (_, t64), signed = _SPECIAL[fn]
    x = _grid((t64,), np.float64, signed=signed)
    truth = truth_fn(x).astype(np.float64)
    scale = np.maximum(np.abs(truth), 1e-3 * np.max(np.abs(truth)))
    err_ours = np.max(np.abs(ours_fn(x) - truth) / scale)
    err_jax = np.max(np.abs(ref_fn(x) - truth) / scale)
    assert err_ours <= max(1e-12, 2.0 * err_jax), (err_ours, err_jax)


@pytest.mark.parametrize("fn", sorted(_SPECIAL))
def test_special_series_branch_is_bitwise(fn):
    """Below the switch both sides run the same polynomial in the same
    operation order: equal to the last bit in either dtype.  The Debye
    function ends in a square root, which PyTorch's CPU kernel does not
    round correctly in ~0.6 % of cases (XLA's and numpy's do; on the card
    both the plain version and the kernel do): there the polynomial is
    held bitwise and the function to one ulp."""
    ours_fn, ref_fn, _, switches, signed = _SPECIAL[fn]
    for dt, t in zip((np.float32, np.float64), switches):
        x = np.linspace(-t if signed else 0.0, t, 4001, dtype=dt)[1:-1]
        ours, ref = ours_fn(x), ref_fn(x)
        if fn != "gauss_debye_over_u":
            np.testing.assert_array_equal(ours, ref)
            continue
        u = jnp.asarray(x)
        poly = np.asarray(1.0 + u * (-1.0 / 3.0 + u * (
            1.0 / 12.0 + u * (-1.0 / 60.0 + u / 360.0))))
        np.testing.assert_array_equal(
            ours, torch.sqrt(torch.as_tensor(poly)).numpy())
        np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


@pytest.mark.parametrize("fn", sorted(_SPECIAL))
def test_special_float32_within_jax_error(fn):
    ours_fn, ref_fn, truth_fn, switches, signed = _SPECIAL[fn]
    x32 = _grid(switches, np.float32, signed=signed)
    truth = ref_fn(x32.astype(np.float64))
    _f32_within_jax_error(ours_fn(x32), ref_fn(x32), truth)


# ------------------------------------------------------------ models

# active sets per model: the suite row's, the default, and one with
# every fittable parameter where that differs; each with its fixed values
_SETS = {
    "LMADenseSphere": [(("radius", "volFrac"), {}), (("radius",), {}),
                       (("radius",), {"volFrac": 0.3, "mf": 2.0}),
                       (("radius", "volFrac"), {"mf": 1.5})],
    "GaussianChain": [(("rg",), {}), (("bp",), {"rg": 3e-9}),
                      (("rg", "bp", "etas", "k"), {})],
    "SphericalCoreShell": [(("radius", "t"), {}),
                           (("radius",), {"t": 5e-9, "eta_sol": 1e14})],
}
# sampling boxes of the fittable parameters (SI)
_BOX = {"radius": (1e-9, 1e-7), "volFrac": (1e-3, 0.4), "rg": (1e-9, 5e-8),
        "bp": (1e-10, 1e-6), "etas": (1e13, 1e15), "k": (0.1, 10.0),
        "t": (1e-10, 5e-8)}
_CASES = [(m, i) for m in MODELS for i in range(len(_SETS[m]))]


def _pv(active, n=48, seed=3):
    rs = np.random.default_rng(seed)
    return np.stack([np.exp(rs.uniform(*np.log(_BOX[a]), n))
                     for a in active], axis=1)


def _model_both(name, active, fixed, fn, pv, q, dtype):
    """(port, JAX) values of *fn* at the parameter vectors *pv* (M, P):
    ff as (M, Nq), the others as (M,)."""
    ours_b = get_model(name).bind(active=active, fixed=fixed)
    ref_b = jax_get_model(name).bind(active=active, fixed=fixed)
    assert ours_b.fixed == ref_b.fixed
    pv = pv.astype(dtype)
    if fn == "ff":
        ours = ours_b.ff(torch.as_tensor(q.astype(dtype)),
                         torch.as_tensor(pv)[:, None, :]).numpy()
        ref = jax.jit(jax.vmap(lambda p: ref_b.ff(jnp.asarray(q, dtype), p)))
    else:
        ours = getattr(ours_b, fn)(torch.as_tensor(pv))
        ours = np.broadcast_to(np.asarray(ours), (len(pv),))
        ref = jax.jit(jax.vmap(getattr(ref_b, fn)))
    ref = np.broadcast_to(np.asarray(ref(jnp.asarray(pv))), ours.shape)
    return ours, ref


@pytest.mark.parametrize("fn", ["ff", "volume", "absvolume", "surf"])
@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_matches_jax(case, fn):
    """Both dtypes, fixed and active parameters mixed.  float64: relative
    to max(|ref|, 1e-3·max|ref|), 1e-12 (the same formulas; libm's last
    ulp and, for a power of fixed values alone, multiplication against
    Python's pow) but for the form factors that the closed forms above
    amplify one ulp of exp/sin/cos in: GaussianChain (the Debye function
    just above its switch) and LMADenseSphere (its structure factor near
    the pole of 1/(1 + 24μG/A)) get 1e-9, the JAX package's tolerance for
    these families against the running reference (test_reference_parity,
    _FF_RTOL).  float32: see _f32_within_jax_error, the truth being JAX's
    float64 value at the float32-rounded inputs."""
    name, i = case
    active, fixed = _SETS[name][i]
    pv = _pv(active)
    q = np.logspace(7, 9.7, 70)
    ours, ref = _model_both(name, active, fixed, fn, pv, q, np.float64)
    assert ours.dtype == np.float64 and np.isfinite(ref).all()
    scale = np.maximum(np.abs(ref), 1e-3 * np.max(np.abs(ref)))
    if np.max(np.abs(ref)) > 0:
        rtol = (1e-9 if fn == "ff" and name in ("GaussianChain",
                                                "LMADenseSphere")
                else 1e-12)
        assert np.max(np.abs(ours - ref) / scale) <= rtol
    else:
        np.testing.assert_array_equal(ours, ref)
    ours32, ref32 = _model_both(name, active, fixed, fn, pv, q, np.float32)
    truth = _model_both(name, active, fixed, fn,
                        pv.astype(np.float32).astype(np.float64),
                        q.astype(np.float32).astype(np.float64),
                        np.float64)[1]
    if np.max(np.abs(truth)) > 0:
        _f32_within_jax_error(np.asarray(ours32, np.float32), ref32, truth)


_FF_FIXTURE = _TESTDATA / "reference_ff_fixture.json"


@pytest.mark.parametrize("name", MODELS)
def test_float64_curves_match_running_reference(name):
    """As test_crossval_formfactor_curves holds the JAX package, without
    it: ff(q) to 1e-9 relative and the volume to 1e-12 against the
    reference McSAS's own model code (tools/run_reference_ff.py)."""
    fix = json.loads(_FF_FIXTURE.read_text())
    q = torch.as_tensor(np.asarray(fix["q"], np.float64))
    model = get_model(name)
    for e in fix["models"][name]:
        full = model.defaults()
        full.update({k: float(v) for k, v in e["params"].items()})
        ff = model.ff(q, full).numpy()
        np.testing.assert_allclose(ff, np.asarray(e["ff"], np.float64),
                                   rtol=1e-9, err_msg=str(e["params"]))
        assert float(model.volume(full)) == pytest.approx(e["volume"],
                                                          rel=1e-12)


def test_registry_has_the_elementwise_models():
    for name in MODELS:
        assert get_model(name).name == name
        assert get_model(name).param_names == jax_get_model(name).param_names
    for name in ("CylindersIsotropicAspect", "CylindersRadiallyIsotropic",
                 "CylindersRadiallyIsotropicTilted"):
        with pytest.raises(KeyError, match="later PR"):
            get_model(name)


# -------------------------------------------------- engines and rows

# the bench suite rows of these models: data file, active set, ranges
SUITE = {"LMADenseSphere": ("sasfit_sphere-10-1.dat", ("radius", "volFrac"),
                            {"volFrac": (1e-4, 0.1)}),
         "GaussianChain": ("sasfit_gauss2-5-1.5-2-1.dat", ("rg",), None),
         "SphericalCoreShell": (
             "models/SphCoreShell_R100_dR150_c3p16_s2p53.csv",
             ("radius", "t"), None)}


def suite_engines(name, active=None, fixed=None, **kw):
    """The JAX and port engines of *name*'s suite row (or *active* with
    *fixed*), on the CPU with the plain chunk; unbounded ranges defaulted
    from the data by each package's own ``_default_unbounded_ranges``."""
    path, row_active, ranges = SUITE[name]
    active = row_active if active is None else active
    ranges = {k: v for k, v in (ranges or {}).items() if k in active}
    jd, td = jax_data.load(_TESTDATA / path), data.load(_TESTDATA / path)
    jb = jax_api._default_unbounded_ranges(
        jax_get_model(name).bind(active=active, active_ranges=ranges or None,
                                 fixed=fixed), jd)
    tb = api._default_unbounded_ranges(
        get_model(name).bind(active=active, active_ranges=ranges or None,
                             fixed=fixed), td)
    assert tb.ranges == jb.ranges and tb.fixed == jb.fixed
    assert np.isfinite(np.asarray(tb.ranges)).all()
    base = dict(num_reps=2, max_retries=0, use_pallas="off")
    base.update(kw)
    return (jax_engine.McSASEngine(jd, jb, JaxConfig(**base)),
            McSASEngine(td, tb, McSASConfig(**base), device="cpu"))


@pytest.mark.parametrize("name", MODELS)
def test_reference_volume_and_normalization_match_jax(name):
    je, te = suite_engines(name, num_contribs=40)
    assert te.bound.reference_volume() == pytest.approx(
        je.bound.reference_volume(), rel=1e-15)
    assert te.w_ref == pytest.approx(je.w_ref, rel=1e-13)
    np.testing.assert_array_equal(te.grid.numpy(), np.asarray(je.grid))


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_intensity_rows_match_jax(case):
    """The normalized float32 rows of the suite row's data at random
    parameters, the range corners included: 1e-5 relative with a floor of
    1e-6 of each row's maximum (sin/cos/exp differ in the last ulp, which
    cancellation amplifies near a form factor's zeros and, for
    LMADenseSphere, near the structure factor's pole); the same entries
    clamped, NaN where JAX has NaN.  Reports NaN rows, if any."""
    name, i = case
    active, fixed = _SETS[name][i]
    je, te = suite_engines(name, active, fixed, num_contribs=40)
    lo, hi = np.asarray(te.bound.ranges).T
    rs = np.random.default_rng(4)
    params = np.concatenate([[lo, hi], lo + rs.uniform(size=(62, len(lo)))
                             * (hi - lo)]).astype(np.float32)
    ours = te.kern.row(torch.as_tensor(params)).numpy()
    ref = np.asarray(jax.vmap(lambda p: je._intensity_row(je.grid, p))(
        jnp.asarray(params)))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    nan = np.isnan(ref)
    if nan.any():
        print(f"{name} {active}: {int(nan.any(axis=1).sum())} NaN rows")
    np.testing.assert_array_equal(np.isnan(ours), nan)
    ours, ref = np.where(nan, 0.0, ours), np.where(nan, 0.0, ref)
    floor = 1e-6 * np.max(np.abs(ref), axis=1, keepdims=True)
    assert np.all(np.abs(ours - ref) <= 1e-5 * np.abs(ref) + floor)
    clamp = np.float32(te.kern.row_clamp)
    np.testing.assert_array_equal(ours == clamp, ref == clamp)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_kernel_layout_rebuilds_the_parameter_dict(case):
    """ChunkSpec.model_layout, what K1 rebuilds BoundModel.pdict from:
    each parameter's active column or fixed value, in declaration order,
    LMADenseSphere's automatic standoff folded when volFrac is fixed, and
    √w precomputed when the volume depends on no active parameter."""
    name, i = case
    active, fixed = _SETS[name][i]
    bound = get_model(name).bind(active=active, fixed=fixed,
                                 active_ranges={a: _BOX[a] for a in active})
    te = McSASEngine(data.load(_TESTDATA / SUITE[name][0]), bound,
                     McSASConfig(num_contribs=40, num_reps=2), device="cpu")
    assert mc_kernel.supports(te) and not te.runs_cuda_kernel
    pfix, pcol, sw = te.spec.model_layout
    names = bound.model.param_names
    assert [names[j] for j, c in enumerate(pcol) if c >= 0] == list(active)
    for j, (n, c) in enumerate(zip(names, pcol)):
        if c >= 0:
            assert active[c] == n and pfix[j] == 0.0
        elif n == "mf" and dict(bound.fixed)["mf"] == -1.0:
            mu = dict(bound.fixed).get("volFrac")
            want = -1.0 if mu is None else (0.634 / mu) ** (1.0 / 3.0)
            assert pfix[j] == want
        else:
            assert pfix[j] == dict(bound.fixed)[n]
    fixed_volume = not set(active) & {"radius", "rg", "k", "t"}
    assert (sw is not None) == fixed_volume
    if fixed_volume:
        rows = te.kern.row(torch.ones((3, len(active))))
        w = te.kern.weight(bound.pdict(torch.ones(len(active))))
        assert isinstance(w, float)
        assert sw == float(torch.sqrt(torch.tensor(w, dtype=torch.float32)))
        assert torch.isfinite(rows).all()
