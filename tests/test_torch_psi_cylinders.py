# -*- coding: utf-8 -*-
"""PyTorch port, the legacy ψ-grid cylinders: CylindersIsotropicAspect,
CylindersRadiallyIsotropic and CylindersRadiallyIsotropicTilted — their
form factors with the ψ (and tilt) nodes behind batched parameters, the
probe-gated tables, the route each binding takes and the plain chunk,
held against the JAX package on the same inputs.  The probe is called
directly, so no test bakes a production-size table on the CPU; tables are
baked at 8 nodes an axis (MCSAS_TPU_TABLE_RES_CAP; 5 for three axes)
with the probe bypassed (MCSAS_TPU_TABLE_PROBE=off), since the probe
declines such coarse spacings."""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import scipy.special

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import cylinders as jax_cyl  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.ops import tables as jax_tables  # noqa: E402
from mcsas_tpu_torch import data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         state_from_numpy, state_to_numpy)
from mcsas_tpu_torch.models import cylinders, get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, tables  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
NM = 1e-9
Q = np.geomspace(1.05e6, 9.64e9, 100)        # the sasfit_sphere SI q grid
Q_NARROW = np.geomspace(1e7, 1e9, 100)       # the ψ rows' grid, SI
NEAR_TIE = 1e-6
PSI = ("CylindersIsotropicAspect", "CylindersRadiallyIsotropic",
       "CylindersRadiallyIsotropicTilted")
FNS = {"CylindersIsotropicAspect": "_cyl_iso_aspect_ff",
       "CylindersRadiallyIsotropic": "_cyl_radial_ff",
       "CylindersRadiallyIsotropicTilted": "_cyl_tilted_ff"}
# one parameter set each; the tilted radius keeps q·R physical on the SI
# grid (float32 range reduction at q·R ~ 1e9 means nothing in any package)
PARAMS = {
    "CylindersIsotropicAspect": dict(radius=3e-9, aspect=5.0, psiAngle=0.2,
                                     psiAngleDivisions=303.0),
    "CylindersRadiallyIsotropic": dict(radius=3e-9, aspect=5.0,
                                       psiAngle=0.17,
                                       psiAngleDivisions=303.0, sld=1e14),
    "CylindersRadiallyIsotropicTilted": dict(
        radius=2e-9, aspect=10.0, psiAngle=0.1, psiAngleDivisions=303.0,
        phiDistWidth=10.0, phiDistDivisions=9.0)}
# the bindings of the probe: the wide default ranges where JAX's probe
# declines (tests/test_tables.py:333-337) and the narrow ranges of the
# suite rows where it engages (:368-374)
PROBE = {
    "aspect-wide": ("CylindersIsotropicAspect", ("radius", "aspect"),
                    {"radius": (0.5 * NM, 300 * NM), "aspect": (1.0, 20.0)},
                    Q, False),
    "radial-wide": ("CylindersRadiallyIsotropic", ("radius", "psiAngle"),
                    {"radius": (0.5 * NM, 300 * NM)}, Q, False),
    "aspect-narrow": ("CylindersIsotropicAspect", ("radius", "aspect"),
                      {"radius": (1 * NM, 20 * NM), "aspect": (1.0, 4.0)},
                      Q_NARROW, True),
    "radial-narrow": ("CylindersRadiallyIsotropic", ("radius", "psiAngle"),
                      {"radius": (1 * NM, 30 * NM)}, Q_NARROW, True),
    "radial-3axes": ("CylindersRadiallyIsotropic",
                     ("radius", "aspect", "psiAngle"),
                     {"radius": (1 * NM, 10 * NM), "aspect": (1.0, 4.0)},
                     Q_NARROW, True)}


@pytest.fixture(scope="module", autouse=True)
def small_tables():
    """8 nodes a table axis with the probe bypassed, no disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "8")
        mp.setenv("MCSAS_TPU_TABLE_PROBE", "off")
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield


def _jax_ff(name, q, p):
    fn = getattr(jax_cyl, FNS[name])
    return np.asarray(jax.jit(lambda qq: fn(qq, p))(q))


# ----------------------------------------------------------- form factors

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", PSI)
def test_ff_matches_jax(name, dtype):
    """ff of one parameter set.  float64: against JAX's to 1e-12
    relative (the mean over ψ may sum in another order).  float32: the
    dtype kept and, as the JAX package's test_float32_consistency holds
    its own, within 1e-3 of the float64 curve scaled by its maximum."""
    p = PARAMS[name]
    ref = _jax_ff(name, Q, p)
    if dtype == "float64":
        ours = get_model(name).ff(torch.as_tensor(Q), p).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
        return
    out = get_model(name).ff(torch.as_tensor(Q, dtype=torch.float32), p)
    assert out.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy() / scale, ref / scale, atol=1e-3)


@pytest.mark.parametrize("name", ["CylindersRadiallyIsotropic",
                                  "CylindersRadiallyIsotropicTilted"])
def test_ff2d_matches_jax(name):
    """ff2d on (q, ψ) pairs in float64, batched parameters (B, 1) against
    JAX's ff2d of one parameter set vmapped over them: 1e-12 relative."""
    rs = np.random.default_rng(3)
    q = rs.uniform(1e7, 2e9, 60)
    psi = rs.uniform(0.0, 2 * math.pi, 60)
    active = ("radius", "aspect", "psiAngle")
    vals = np.column_stack([rs.uniform(1e-9, 2e-8, 5),
                            rs.uniform(1.0, 20.0, 5),
                            rs.uniform(0.1, 3.0, 5)])
    bound = get_model(name).bind(active=active)
    jbound = jax_get_model(name).bind(active=active)
    ours = get_model(name).ff2d(torch.as_tensor(q), torch.as_tensor(psi),
                                bound.pdict(torch.as_tensor(vals)[:, None]))
    ref = np.asarray(jax.jit(jax.vmap(lambda v: jbound.model.ff2d(
        jnp.asarray(q), jnp.asarray(psi), jbound.pdict(v))))(vals))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("name", PSI)
def test_batched_ff_equals_a_loop(name):
    """Contributions as (B, 1) entries (the bank and the table bake), as
    (R, K, 1) entries (the plain chunk) and one parameter set at a time
    give the same rows bit for bit (each row is its own computation), and
    JAX's ff vmapped over them to 1e-12 relative."""
    rs = np.random.default_rng(5)
    active = ("radius", "aspect")
    hi = 20.0 if name.endswith("Tilted") else 2e-8
    vals = np.column_stack([rs.uniform(0.05 * hi, hi, 6),
                            rs.uniform(1.0, 10.0, 6)])
    bound = get_model(name).bind(active=active)
    q = torch.as_tensor(Q / 1e9 if name.endswith("Tilted") else Q)
    tv = torch.as_tensor(vals)
    batched = bound.model.ff(q, bound.pdict(tv[:, None, :])).numpy()
    chunked = bound.model.ff(
        q, bound.pdict(tv.reshape(2, 3, 1, 2))).numpy().reshape(6, -1)
    looped = np.stack([bound.model.ff(q, {**dict(bound.fixed),
                                          "radius": float(v[0]),
                                          "aspect": float(v[1])}).numpy()
                       for v in vals])
    np.testing.assert_array_equal(batched, looped)
    np.testing.assert_array_equal(chunked, looped)
    jbound = jax_get_model(name).bind(active=active)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda v: jbound.ff(jnp.asarray(q.numpy()), v)))(vals))
    np.testing.assert_allclose(batched, ref, rtol=1e-12)


def test_radial_ff_against_scipy():
    """The JAX package's test_cylinders_radially_isotropic_cross: the
    in-plane average with scipy's J1 and numpy's sin, 1e-5 relative."""
    p = PARAMS["CylindersRadiallyIsotropic"]
    psi = np.linspace(0.01, 2 * math.pi + 0.01, 303)
    a = psi - p["psiAngle"]
    qr = np.outer(Q, p["radius"] * np.sin(a))
    ql = np.outer(Q, p["radius"] * p["aspect"] * np.cos(a))
    with np.errstate(invalid="ignore", divide="ignore"):
        fs = 2 * scipy.special.j1(qr) / qr * np.sin(ql) / ql
    expected = np.sqrt(np.mean(fs ** 2, axis=1))
    got = get_model("CylindersRadiallyIsotropic").ff(torch.as_tensor(Q), p)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5)


def _ff_fixture(name):
    fix = json.loads((REPO / "testdata" / "reference_ff_fixture.json")
                     .read_text())
    return np.asarray(fix["q"], np.float64), fix["models"][name]


@pytest.mark.parametrize("name,rtol", [
    ("CylindersRadiallyIsotropic", 1e-6),
    ("CylindersRadiallyIsotropicTilted", 1e-3),
    ("CylindersIsotropicAspect", None)])
def test_against_the_running_reference(name, rtol):
    """The reference McSAS's own curves (testdata/reference_ff_fixture.
    json, the JAX package's test_crossval_formfactor_curves): the radial
    model to 1e-6 relative, the tilted one to 1e-3 (upstream's scipy
    interval against NormalDist); the Aspect model is NaN upstream (its
    grid's sin 0 = 0 makes the first column 0/0) and finite, positive
    here.  Volumes to 1e-12."""
    q, entries = _ff_fixture(name)
    model = get_model(name)
    for e in entries:
        full = model.defaults()
        full.update({k: float(v) for k, v in e["params"].items()})
        got = model.ff(torch.as_tensor(q), full).numpy()
        ref = np.asarray(e["ff"], np.float64)
        if rtol is None:
            assert np.isnan(ref).all()
            assert np.isfinite(got).all() and (got > 0).all()
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol,
                                       err_msg=str(e["params"]))
        assert float(model.volume(full)) == pytest.approx(e["volume"],
                                                          rel=1e-12)


@pytest.mark.parametrize("name", PSI)
def test_volumes_and_reference_volume_match_jax(name):
    """volume and absvolume of batched contributions, and the host
    reference volume of the default and the suite bindings: to 1e-15."""
    active = ("radius", "aspect")
    ours_b = get_model(name).bind(active=active)
    ref_b = jax_get_model(name).bind(active=active)
    pv = np.random.default_rng(3).uniform(1e-9, 1e-7, (20, 2))
    for fn in ("volume", "absvolume"):
        ours = np.asarray(getattr(ours_b, fn)(torch.as_tensor(pv)))
        ref = np.asarray([float(getattr(ref_b, fn)(jnp.asarray(p)))
                          for p in pv])
        np.testing.assert_allclose(ours, ref, rtol=1e-15)
    for bind in ({}, dict(active=active)):
        assert get_model(name).bind(**bind).reference_volume() == \
            pytest.approx(jax_get_model(name).bind(
                **bind).reference_volume(), rel=1e-15)


def test_phi_centroids_match_jax():
    for n in (1, 2, 9, 25):
        np.testing.assert_array_equal(cylinders._phi_centroids(n),
                                      jax_cyl._phi_centroids(n))


# ------------------------------------------------------ probe and tables

def _captured(monkeypatch, key, torch_side):
    """The row function, grids and keywords a factory hands to
    build_param_table for the binding *key* of PROBE, without baking."""
    name, active, ranges, q, _ = PROBE[key]
    mod = tables if torch_side else jax_tables
    got = {}

    def capture(row_fn, grids, *args, **kw):
        got.update(row_fn=row_fn, grids=grids, kw=kw)
        return None

    monkeypatch.setattr(mod, "build_param_table", capture)
    if torch_side:
        b = get_model(name).bind(active=active, active_ranges=ranges)
        made = b.model.ff_table_factory(b, q, torch.float32,
                                        torch.device("cpu"))
    else:
        b = jax_get_model(name).bind(active=active, active_ranges=ranges)
        made = b.model.ff_table_factory(b, q, jnp.float32)
    assert made is None
    return got


@pytest.mark.parametrize("key", sorted(PROBE))
def test_probe_decides_like_jax(key, monkeypatch):
    """The interpolation probe on the production grids (512 × 64, 128 ×
    32 × 16) of each binding: the same nodes, the same decision as JAX's
    (decline on the wide default ranges, engage on the suite rows'
    narrow ones), the median and 90th percentile to 1e-2 relative and
    each error within 0.2 relative or 1e-5 absolute of JAX's: the errors
    are relative differences of float32 rows that round a few ulps apart
    between the two libraries."""
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    engage = PROBE[key][-1]
    ours = _captured(monkeypatch, key, True)
    ref = _captured(monkeypatch, key, False)
    assert ours["kw"]["probe"] and ref["kw"]["probe"]
    for g, h in zip(ours["grids"], ref["grids"]):
        np.testing.assert_array_equal(g, np.asarray(h))
    e1 = tables.probe_interp_errors(ours["row_fn"], ours["grids"])
    e2 = jax_tables.probe_interp_errors(ref["row_fn"], ref["grids"],
                                        jnp.float32)
    assert tables.probe_is_fit_grade(e1) == \
        jax_tables.probe_is_fit_grade(e2) == engage
    for stat in (np.median, lambda e: np.percentile(e, 90)):
        assert stat(e1) == pytest.approx(stat(e2), rel=1e-2)
    assert np.all(np.abs(e1 - e2) <= 0.2 * np.abs(e2) + 1e-5)


@pytest.mark.parametrize("name", ["CylindersIsotropicAspect",
                                  "CylindersRadiallyIsotropic"])
def test_declined_binding_has_no_table_and_no_kernel(name, monkeypatch):
    """On the wide default ranges the factory returns None as JAX's does
    (the probe declines before any bake); the engine then runs the
    in-loop quadrature, records the decline, and refuses use_pallas='on'
    naming it."""
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    key = "aspect-wide" if name.endswith("Aspect") else "radial-wide"
    _, active, ranges, _, _ = PROBE[key]
    q = np.geomspace(Q[0], Q[-1], 30)      # the sphere grid, thinned
    b = get_model(name).bind(active=active, active_ranges=ranges)
    d = data.from_raw(np.column_stack([q / 1e9, np.ones_like(q),
                                       0.05 * np.ones_like(q)]))
    cfg = McSASConfig(num_contribs=8, num_reps=1, max_iterations=64,
                      chunk_steps=32, candidates_per_step=2, seed=5,
                      max_retries=0, show_incomplete=True, table_ff="on")
    eng = McSASEngine(d, b, cfg, device="cpu")
    assert not eng.uses_table and eng.kern.table_declined
    assert eng.prefetch_entry is None and not eng.runs_cuda_kernel
    # the decline is memoized: asked again, the factory does not probe
    assert b.model.ff_table_factory(b, q, torch.float32,
                                    torch.device("cpu")) is None
    with pytest.raises(ValueError, match="declined") as err:
        McSASEngine(d, b, cfg.replace(use_pallas="on"), device="cpu")
    assert "use_pallas='off'" in str(err.value)


def _slit(mod):
    return mod.DataConfig(smearing=mod.TrapezoidSmearing(
        do_smear=True, n_steps=3, umbra=0.05e9, penumbra=0.2e9))


@pytest.mark.parametrize("key,smear", [("aspect-narrow", False),
                                       ("radial-narrow", False),
                                       ("aspect-narrow", True)],
                         ids=["aspect", "radial", "aspect-smeared"])
def test_bake_matches_jax(key, smear, monkeypatch):
    """The float32 tables at 8 nodes an axis (probe bypassed) against
    JAX's bake on 40 q points, unsmeared, and at 4 nodes on 20 points (the
    Aspect model, the one that can smear) smeared: the intensity
    ff²(locs) @ smear_w.
    Tolerance 2e-5 relative with a floor of 1e-6 of the largest value:
    both run the converged 3001-node rule in float32; the libraries'
    sin/cos/sqrt differ in the last ulp and the node sums run in another
    order."""
    name, active, ranges, _, _ = PROBE[key]
    q = np.geomspace(1e7, 1e9, 20 if smear else 40)
    kw = {}
    if smear:
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "4")
        d = data.from_raw(np.column_stack([q / 1e9, np.ones_like(q),
                                           0.01 * np.ones_like(q)]),
                          config=_slit(data))
        q = np.asarray(d.q)
        kw["smear"] = (np.asarray(d.locs), np.asarray(d.smear_w))
    b = get_model(name).bind(active=active, active_ranges=ranges)
    jb = jax_get_model(name).bind(active=active, active_ranges=ranges)
    made = b.model.ff_table_factory(b, q, torch.float32,
                                    torch.device("cpu"), **kw)
    ref = jb.model.ff_table_factory(jb, q, jnp.float32, **kw)
    assert len(made) == len(ref) == (3 if smear else 2)
    assert made[0].tab_params == active
    ours, want = made[1].values.numpy(), np.asarray(ref[1])
    assert ours.shape == want.shape == (16 if smear else 64, len(q))
    np.testing.assert_allclose(ours, want, rtol=2e-5,
                               atol=1e-6 * np.abs(want).max())


def test_bake_is_the_same_whatever_the_block():
    """The rows of a ψ table baked in blocks of 4, 8 and 12 rows and in
    one block of all: a row is its own computation, so the memory-sized
    blocks (whole multiples of 4 rows, _psi_bake_block) change no value.
    Here to 2 float32 ulps (the CPU's vectorized sin/cos and its scalar
    tail, which the block size moves, may differ in the last bit); on the
    card bit for bit (tests/test_torch_cuda.py, chip_smoke.py phase 18)."""
    assert cylinders._psi_bake_block(100, 3001) == 108
    assert cylinders._psi_bake_block(2600, 3001) == 4
    q32 = torch.as_tensor(np.geomspace(1e7, 1e9, 30), dtype=torch.float32)

    def row_fn(vals):
        return cylinders._cyl_radial_ff(q32, dict(
            radius=vals[:, 0:1], psiAngle=vals[:, 1:2], aspect=10.0,
            psiAngleDivisions=3001.0))

    grids = [tables.log_grid(1e-9, 3e-8, 5), tables.log_grid(0.01, 6.0, 5)]
    outs = [tables.build_param_table(row_fn, grids, block=blk).values
            for blk in (25, 4, 8, 12)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=2.4e-7,
                                   atol=0.0)


# ------------------------------------------------------ engine and routes

def _engines(key, **kw):
    """The JAX engine (scan path) and the port's CPU engine of the PROBE
    binding *key* on its golden-free grid (ones, 1 %), 40 q points."""
    name, active, ranges, _, _ = PROBE[key]
    q_nm = np.geomspace(0.01, 1.0, 40)
    raw = np.column_stack([q_nm, 1.0 + 0.1 * np.sin(20 * q_nm),
                           0.01 * np.ones_like(q_nm)])
    base = dict(num_contribs=20, num_reps=2, max_iterations=100_000,
                chunk_steps=60, candidates_per_step=4, seed=11,
                max_retries=0, use_pallas="off")
    base.update(kw)
    je = jax_engine.McSASEngine(
        jax_data.from_raw(raw),
        jax_get_model(name).bind(active=active, active_ranges=ranges),
        JaxConfig(**base))
    te = McSASEngine(data.from_raw(raw),
                     get_model(name).bind(active=active,
                                          active_ranges=ranges),
                     McSASConfig(**base), device="cpu")
    return je, te


def _engines_2d():
    """The JAX engine (scan path) and the port's CPU engine of the radial
    model's 2D fit on the 24 × 16 image of tests/test_2d.py."""
    d = suite.cylinder_2d_golden(24, 16, rel_sigma=0.02)
    raw = np.column_stack([d.q / 1e9, d.f, d.fu, np.degrees(d.psi)])
    bind = dict(active=("radius", "psiAngle"),
                active_ranges={"radius": (1 * NM, 20 * NM)})
    base = dict(num_contribs=20, num_reps=2, max_iterations=100_000,
                chunk_steps=60, candidates_per_step=4, seed=11,
                max_retries=0, use_pallas="off")
    je = jax_engine.McSASEngine(
        jax_data.from_raw(raw, config=jax_data.DataConfig(n_bin=0,
                                                          fit_2d=True)),
        jax_get_model("CylindersRadiallyIsotropic").bind(**bind),
        JaxConfig(**base))
    te = McSASEngine(d, get_model("CylindersRadiallyIsotropic").bind(**bind),
                     McSASConfig(**base), device="cpu")
    assert te.kern.psi is not None and not te.uses_table
    return je, te


def _jax_state_numpy(state, nq):
    out = {k: np.asarray(getattr(state, k)) for k in state._fields
           if k != "key"}
    out["ibank"] = out["ibank"][..., :nq]
    out["ft"] = out["ft"][..., :nq]
    return out


def _jax_table(je, nq):
    vals = np.asarray(je.grid[1])[:, :nq]
    for tab in jax_tables._TABLE_CACHE.values():
        if (isinstance(tab, jax_tables.ParamTable)
                and tab.values.shape == vals.shape
                and np.array_equal(np.asarray(tab.values), vals)):
            return np.asarray(tab.values), tab.axes
    raise AssertionError("the JAX engine's table is not in its memo")


def scan_pair(je, te, spec, steps):
    """JAX's scan step applied *steps* times from a JAX-initialized state
    on JAX's proposals, and the plain chunk on the same proposals with its
    trace (tests/test_torch_engine.py's injection)."""
    nq = te.consts.n
    r, n = te.cfg.num_reps, te.cfg.num_contribs
    state = je._init_batch(jax.random.split(jax.random.PRNGKey(7), r))
    keys = jax.vmap(jax.random.split)(state.key)
    props = np.asarray(je._draw_chunk_proposals(keys[:, 1],
                                                n_steps=steps), np.float32)
    step = jax.jit(lambda s, c, ri: jax.vmap(
        lambda sr, cr: je._step(sr, cr, ri))(s, c))
    js = state._replace(ft=jnp.sum(state.ibank, axis=1))
    j_steps = []
    for s in range(steps):
        js = step(js, jnp.asarray(props[s]), jnp.asarray(s % n, jnp.int32))
        j_steps.append(_jax_state_numpy(js, nq))
    start = _jax_state_numpy(state, nq)
    trace = {}
    t_final, t_ri = mc_kernel.chunk_reference(
        state_from_numpy(start), 0, te.consts, spec, torch.tensor(props),
        trace=trace)
    return dict(props=props, start=start, j_steps=j_steps, trace=trace,
                t_final=state_to_numpy(t_final), t_ri=t_ri, n=n)


def assert_scan_pair(run, consts, spec):
    """Exact decisions against JAX's scan path; a flip only at a near-tie
    (one float32 ulp of χ²), the trajectories equal up to it.  Counters
    exact; parameters to 1e-6 relative (one float32 ulp), bank rows to
    1e-5 relative with a floor of 1e-6 of each row's maximum, χ² to 1e-5,
    ft to 2e-4 (the port rebuilds ft with a float64 sum, JAX float32)."""
    tr, n = run["trace"], run["n"]
    prev = run["start"]["n_moves"]
    flip = None
    for s, js in enumerate(run["j_steps"]):
        j_acc = js["n_moves"] > prev
        prev = js["n_moves"]
        t_acc = tr["choice"][s].numpy() >= 0
        bad = (j_acc != t_acc) | ~np.all(np.isclose(
            js["rset"][:, s % n, :], tr["slot"][s].numpy(), rtol=1e-6,
            atol=0.0), axis=1)
        if bad.any():
            flip = (s, int(np.argmax(bad)))
            break
    if flip is None:
        ours, ref, upto = run["t_final"], run["j_steps"][-1], len(
            run["j_steps"])
    else:
        s, r = flip
        margin = float(mc_kernel.decision_margin(tr["chi"][s, r],
                                                 tr["conval"][s, r]))
        assert margin <= NEAR_TIE, (s, r, margin)
        assert s > 0
        st, _ = mc_kernel.chunk_reference(
            state_from_numpy(run["start"]), 0, consts, spec,
            torch.tensor(run["props"][:s]))
        ours, ref, upto = state_to_numpy(st), run["j_steps"][s - 1], s
    assert upto > 0
    np.testing.assert_array_equal(ours["n_moves"], ref["n_moves"])
    np.testing.assert_array_equal(ours["n_iter"], ref["n_iter"])
    np.testing.assert_allclose(ours["rset"], ref["rset"], rtol=1e-6)
    floor = 1e-6 * np.abs(ref["ibank"]).max(axis=2, keepdims=True)
    assert np.all(np.abs(ours["ibank"] - ref["ibank"])
                  <= 1e-5 * np.abs(ref["ibank"]) + floor)
    np.testing.assert_allclose(ours["conval"], ref["conval"], rtol=1e-5)
    np.testing.assert_allclose(ours["ft"], ref["ft"], rtol=2e-4,
                               atol=2e-4 * np.abs(ref["ft"]).max())


@pytest.mark.parametrize("key", ["radial-narrow", "radial-wide", "2d"],
                         ids=["table", "declined", "2d"])
def test_plain_chunk_matches_jax_scan(key, monkeypatch):
    """The plain chunk against JAX's scan step for step, with proposals
    injected: on a ψ table (8 × 8, JAX's own table carried over, probe
    bypassed), on the declined route (the probe in force on the wide
    ranges: the verbatim 303-node rule in the loop) and on a 2D (q, ψ)
    image of 24 × 16 pixels (ff2d in the loop), R=2, N=20, K=4."""
    if key == "radial-wide":
        monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    if key == "2d":
        je, te = _engines_2d()
    else:
        je, te = _engines(key)
    assert te.uses_table == bool(je.uses_table) == (key == "radial-narrow")
    spec = te.spec
    if te.uses_table:
        values, axes = _jax_table(je, te.consts.n)
        spec = dataclasses.replace(spec, kern=dataclasses.replace(
            te.kern, table=tables.table_from_numpy(values, axes)))
    run = scan_pair(je, te, spec, 60)
    assert run["t_final"]["n_moves"].min() > 0
    assert_scan_pair(run, te.consts, spec)


@pytest.mark.parametrize("key,active,entry,axes", [
    ("aspect-narrow", ("radius", "psiAngle"), "table", 1),
    ("aspect-narrow", None, "table", 2),
    ("radial-narrow", None, "table", 2),
    ("radial-3axes", None, "rows", 3)])
def test_routes_to_k2_entries(key, active, entry, axes, monkeypatch):
    """The ψ tables take K2's table entry at one or two axes (the Aspect
    model's default binding: radius tabulated, psiAngle active and
    unread, as the worm's table), the radial model with radius, aspect
    and psiAngle active its rows-in entry (three axes, 5 nodes each); a
    segment of the engine equals the plain version on the CPU."""
    name, act, ranges, _, _ = PROBE[key]
    if active is not None:
        act = active
        ranges = {k: v for k, v in ranges.items() if k in active}
    if axes == 3:
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "5")
    q_nm = np.geomspace(0.01, 1.0, 30)
    d = data.from_raw(np.column_stack([q_nm, 1.0 + 0.1 * np.sin(20 * q_nm),
                                       0.01 * np.ones_like(q_nm)]))
    b = get_model(name).bind(active=act, active_ranges=ranges)
    te = McSASEngine(d, b, McSASConfig(num_contribs=20, num_reps=2,
                                       chunk_steps=16, seed=3,
                                       candidates_per_step=4),
                     device="cpu")
    assert te.uses_table and te.prefetch_entry == entry
    assert len(te.kern.table.axes) == axes
    if entry == "table":
        assert len(te.spec.table_layout) == axes
        assert te.spec.factor_layout == (0, -1, 0.0)
    else:
        assert "at most 2 table axes" in mc_kernel.table_blend_refusal(
            te.kern)
    te.gen.manual_seed(3)
    state = te._init_batch()
    gen_state = te.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 0, te.spec, te._draw_chunk_proposals(te.seg_steps))
    want, _ = mc_kernel.prefetch_reference(
        state.clone(), 0, te.consts, te.spec, te.kern.row(cands), cands)
    te.gen.set_state(gen_state)
    got, _ = te._segment(state.clone(), 0)
    assert int(got.n_moves.sum()) > 0
    for k in ("rset", "ibank", "ft", "conval", "n_moves", "n_iter"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy())


def test_tilted_model_has_no_kernel():
    """The tilted model has no table and no device function: the plain
    chunk on the CPU, and use_pallas='on' refused naming that."""
    q_nm = np.geomspace(0.01, 1.0, 30)
    d = data.from_raw(np.column_stack([q_nm, np.ones_like(q_nm),
                                       0.01 * np.ones_like(q_nm)]))
    b = get_model("CylindersRadiallyIsotropicTilted").bind(
        active=("radius",), active_ranges={"radius": (1.0, 20.0)})
    cfg = McSASConfig(num_contribs=8, num_reps=1, chunk_steps=8,
                      max_iterations=64, candidates_per_step=2,
                      max_retries=0)
    eng = McSASEngine(d, b, cfg, device="cpu")
    assert not eng.uses_table and not eng.kern.table_declined
    with pytest.raises(ValueError, match="no device function"):
        McSASEngine(d, b, cfg.replace(use_pallas="on"), device="cpu")


# ------------------------------------------------------------ suite rows

def test_psi_rows_bind_as_specified():
    """The three ψ rows: models, active sets, ranges, K, budgets, the
    2D row's use_pallas='off'; the goldens' shapes and generating
    values."""
    rows = suite.PSI_ROWS
    assert list(rows) == ["cylinders-aspect", "cylinders-radial",
                          "cylinders-2d"]
    asp, rad, two = rows.values()
    b = asp.bound(asp.load())
    assert b.active == ("radius", "aspect")
    assert b.ranges == ((1 * NM, 20 * NM), (1.0, 4.0))
    b = rad.bound(rad.load())
    assert b.active == ("radius", "psiAngle")
    assert b.ranges[0] == (1 * NM, 30 * NM)
    d2 = two.load()
    assert d2.count == 3600 and d2.psi.shape == (3600,)
    assert two.bound(d2).ranges[0] == (1 * NM, 20 * NM)
    for row in rows.values():
        cfg = row.config()
        assert (cfg.num_contribs, cfg.num_reps, cfg.seed, cfg.max_retries,
                cfg.chunk_steps, cfg.candidates_per_step) == \
            (300, 10, 2026, 1, 1024, 128)
    assert [r.config().use_pallas for r in rows.values()] == \
        ["auto", "auto", "off"]
    assert [r.budget for r in rows.values()] == [1_000_000, 8_000_000,
                                                 1024 * 128]
    for row, fn, p in ((asp, "_cyl_iso_aspect_ff",
                        dict(radius=5e-9, aspect=2.0,
                             psiAngleDivisions=3001.0)),
                       (rad, "_cyl_radial_ff",
                        dict(radius=10e-9, aspect=10.0, psiAngle=0.17,
                             psiAngleDivisions=3001.0))):
        d = row.load()
        assert d.count == 100
        q = np.geomspace(0.01, 1.0, 100) * 1e9
        i = _jax_ff({"_cyl_iso_aspect_ff": "CylindersIsotropicAspect",
                     "_cyl_radial_ff": "CylindersRadiallyIsotropic"}[fn],
                    q, p) ** 2
        np.testing.assert_allclose(d.f, i / i.max(), rtol=1e-12)
        np.testing.assert_allclose(d.fu, 0.01 * d.f, rtol=1e-12)
