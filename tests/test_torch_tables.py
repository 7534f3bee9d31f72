# -*- coding: utf-8 -*-
"""PyTorch port, parameter-table tier: the bake, the lookup, the table
engine's rows, the plain version of the prefetch kernel K2 and a cylinder
fit, held against the JAX package on the same inputs.  Tables are baked
at 64 rows (MCSAS_TPU_TABLE_RES_CAP) unless a test says otherwise."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.models.cylinders import \
    _cyl_iso_ff_ab as jax_cyl_ff_ab  # noqa: E402
from mcsas_tpu.ops import mc_kernel as jax_mc_kernel  # noqa: E402
from mcsas_tpu.ops import tables as jax_tables  # noqa: E402
from mcsas_tpu_torch import data, fit  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         state_from_numpy, state_to_numpy)
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.models.cylinders import _cyl_iso_ff_ab  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, tables  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
R, N = 4, 50
NEAR_TIE = 1e-6    # relative χ² gap below which summation order may flip
_BIND = dict(active=("radius",), active_ranges={"radius": (1e-10, 5e-8)},
             fixed={"useAspect": 1.0, "aspect": 10.0})


@pytest.fixture(scope="module", autouse=True)
def small_tables():
    """64-row tables for the whole module, no disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield


@pytest.fixture(scope="module")
def sphere_path(refdata):
    return refdata / "sasfit_sphere-10-1.dat"


def _config(**kw):
    base = dict(num_reps=R, num_contribs=N, convergence_criterion=2.0,
                max_iterations=200000, chunk_steps=64,
                candidates_per_step=8, seed=7, max_retries=0)
    base.update(kw)
    return base


def _engines(path, **kw):
    """The JAX engine (use_pallas 'on': the prefetch kernel K2 in
    interpret mode) and the port's CPU engine, both on the table tier."""
    je = jax_engine.McSASEngine(
        jax_data.load(path), jax_get_model("CylindersIsotropic").bind(**_BIND),
        JaxConfig(**_config(use_pallas="on", **kw)))
    te = McSASEngine(data.load(path),
                     get_model("CylindersIsotropic").bind(**_BIND),
                     McSASConfig(**_config(table_ff="on", **kw)),
                     device="cpu")
    assert je.uses_prefetch and je.uses_table and te.uses_table
    return je, te


def _jax_table(je, nq):
    """The JAX engine's baked table (values and axes) from its memo; the
    engine holds only the lane-padded values."""
    vals = np.asarray(je.grid[1])[:, :nq]
    for tab in jax_tables._TABLE_CACHE.values():
        if (isinstance(tab, jax_tables.ParamTable)
                and tab.values.shape == vals.shape
                and np.array_equal(np.asarray(tab.values), vals)):
            return np.asarray(tab.values), tab.axes
    raise AssertionError("the JAX engine's table is not in its memo")


def _with_table(te, values, axes):
    """The port engine's spec with the table carried over from JAX."""
    kern = dataclasses.replace(
        te.kern, table=tables.table_from_numpy(values, axes))
    return dataclasses.replace(te.spec, kern=kern)


# ------------------------------------------------------ bake and lookup

def test_bake_matches_jax(sphere_path):
    # tolerance: 2e-6 relative — both bake the same n=801 trapezoid in
    # float32; the two libraries' sin/cos/sqrt differ in the last ulp and
    # the 799-node sums run in another order
    je, te = _engines(sphere_path)
    values, axes = _jax_table(je, te.consts.n)
    ours = te.kern.table
    assert ours.axes == tuple(axes)
    assert ours.values.dtype == torch.float32
    np.testing.assert_allclose(ours.values.numpy(), values, rtol=2e-6)


def test_lookup_matches_jax_off_grid(sphere_path):
    # tolerance: 1e-5 relative with a floor of 1e-6 of the largest row
    # value — the same float32 operations on the same table; a one-ulp
    # difference of the two libraries' float32 log moves the blend weight
    # by ulp(log v)/dl.  Below and above the grid both clamp to the end
    # rows exactly.
    je, te = _engines(sphere_path)
    values, axes = _jax_table(je, te.consts.n)
    jtab = jax_tables.ParamTable(values=jnp.asarray(values), axes=axes)
    lo, hi = np.exp(axes[0][0]), np.exp(axes[0][0] + 63 * axes[0][1])
    rs = np.random.default_rng(3)
    pts = np.concatenate([
        np.exp(rs.uniform(np.log(lo), np.log(hi), 120)),
        np.geomspace(lo, hi, 64)[1:-1],                 # on the grid
        [0.0, lo / 10, hi * 10]]).astype(np.float32)
    ours = tables.lookup_param_table(tables.table_from_numpy(values, axes),
                                     [torch.as_tensor(pts)]).numpy()
    look = jax.jit(lambda v: jax_tables.lookup_param_table(jtab, [v]))
    ref = np.stack([np.asarray(look(jnp.asarray(v))) for v in pts])
    assert ours.shape == (len(pts), te.consts.n)
    np.testing.assert_allclose(ours, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_array_equal(ours[-3:-1], values[[0, 0]])
    np.testing.assert_array_equal(ours[-1], values[-1])


def test_disk_cache_reads_the_jax_format(tmp_path, monkeypatch):
    """A table the JAX package stored in MCSAS_TPU_TABLE_CACHE_DIR is the
    port's table of the same key, bit for bit."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_CACHE_DIR", str(tmp_path))
    q = np.geomspace(0.02, 1.5, 37) * 1e9        # a grid no other test uses
    grids = [tables.log_grid(2e-9, 4e-8, 16)]
    key = ("disk-cache-test", tables.grid_fingerprint(q))

    def jax_row(vals):
        return jax_cyl_ff_ab(jnp.asarray(q, jnp.float32) * vals[0],
                             jnp.asarray(q, jnp.float32) * (20.0 * vals[0]),
                             101, jnp.float32)

    ref = jax_tables.build_param_table(jax_row, grids, jnp.float32,
                                       cache_key=key)
    assert len(list(tmp_path.glob("table-*.npz"))) == 1

    def never(vals):
        raise AssertionError("the table was baked, not read from disk")

    ours = tables.build_param_table(never, grids, torch.float32,
                                    cache_key=key)
    assert ours.axes == tuple(ref.axes)
    np.testing.assert_array_equal(ours.values.numpy(),
                                  np.asarray(ref.values))


def test_probe_matches_jax():
    # tolerance: 1e-3 relative with a floor of 2e-6 — the errors are
    # relative differences of float32 rows, so the rows' rounding (one
    # ulp, 6e-8, doubled by squaring, a few ulps apart between the two
    # libraries) puts a floor of ~1e-6 under them
    q = np.geomspace(0.01, 2.0, 50) * 1e9
    grids = [tables.log_grid(1e-9, 1e-7, 256)]
    q32 = torch.as_tensor(q, dtype=torch.float32)

    def ours_row(vals):
        return _cyl_iso_ff_ab(q32 * vals, q32 * (20.0 * vals), 801,
                              torch.float32)

    def jax_row(vals):
        return jax_cyl_ff_ab(jnp.asarray(q, jnp.float32) * vals[0],
                             jnp.asarray(q, jnp.float32) * (20.0 * vals[0]),
                             801, jnp.float32)

    ours = tables.probe_interp_errors(ours_row, grids)
    ref = jax_tables.probe_interp_errors(jax_row, grids, jnp.float32)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-6)
    assert tables.probe_is_fit_grade(ours) == \
        jax_tables.probe_is_fit_grade(ref)


def test_fingerprints_match_jax():
    """Cache keys are shared with the JAX package (disk cache): the same
    digests, exactly."""
    q = np.geomspace(0.01, 2.0, 100) * 1e9
    locs = np.outer(q, [0.9, 1.0, 1.1])
    sw = np.full((3, 1), 1.0 / 3.0)
    assert tables.grid_fingerprint(q) == jax_tables.grid_fingerprint(q)
    assert tables.smear_fingerprint((locs, sw)) == \
        jax_tables.smear_fingerprint((locs, sw))
    assert tables.smear_fingerprint(None) is None


@pytest.mark.parametrize("kind", ["smooth", "aliased"])
def test_probe_gate_decides_like_jax(kind, monkeypatch):
    """build_param_table(probe=True) engages or declines as the JAX
    package does; a decline is memoized per key, and the probe bypass
    (MCSAS_TPU_TABLE_PROBE=off) bakes under another key."""
    q = np.geomspace(0.01, 2.0, 40) * 1e9
    # a Lorentzian on a fine grid, or one under a cosine of phase q·L up
    # to 1e5 on a coarse grid
    freq, n = (0.0, 256) if kind == "smooth" else (500.0, 32)
    grids = [tables.log_grid(1e-9, 1e-7, n)]
    key = ("probe-gate-test", kind, tables.grid_fingerprint(q))
    q32 = torch.as_tensor(q, dtype=torch.float32)

    def ours_row(vals):                            # (B, 1) -> (B, Nq)
        return torch.cos(q32 * vals * freq) / (1.0 + (q32 * vals) ** 2)

    def jax_row(vals):                             # (1,) -> (Nq,)
        qj = jnp.asarray(q, jnp.float32)
        return jnp.cos(qj * vals[0] * freq) / (1.0 + (qj * vals[0]) ** 2)

    ours = tables.build_param_table(ours_row, grids, cache_key=key,
                                    probe=True)
    ref = jax_tables.build_param_table(jax_row, grids, jnp.float32,
                                       cache_key=key, probe=True)
    assert (ours is None) == (ref is None) == (kind == "aliased")
    if ours is None:
        def never(vals):
            raise AssertionError("a memoized decline probed again")
        assert tables.build_param_table(never, grids, cache_key=key,
                                        probe=True) is None
        monkeypatch.setenv("MCSAS_TPU_TABLE_PROBE", "off")
        ours = tables.build_param_table(ours_row, grids, cache_key=key,
                                        probe=True)
    assert tuple(ours.values.shape) == (n, len(q))


# ---------------------------------------------------- engine rows, K2

def test_engine_rows_match_jax(sphere_path):
    # tolerance: on JAX's own table the rows agree to 1e-5 relative (the
    # lookup as above; the port scales the volume by 1/v_ref where JAX
    # divides, ≤ 1 ulp); on the port's own bake to 2e-5 (plus the bake's
    # 2e-6); a floor of 1e-6 of each row's maximum in both
    je, te = _engines(sphere_path)
    nq = te.consts.n
    values, axes = _jax_table(je, nq)
    lo, hi = te.bound.ranges[0]
    rs = np.random.default_rng(5)
    params = np.concatenate([[[lo], [hi]], np.exp(rs.uniform(
        np.log(lo), np.log(hi), (40, 1)))]).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda p: je._intensity_row(je.grid, p))(
        jnp.asarray(params)))[:, :nq]
    floor = 1e-6 * np.max(np.abs(ref), axis=1, keepdims=True)
    on_jax = _with_table(te, values, axes).kern.row(
        torch.as_tensor(params)).numpy()
    on_ours = te.kern.row(torch.as_tensor(params)).numpy()
    assert on_ours.dtype == np.float32 and on_ours.shape == ref.shape
    assert np.all(np.abs(on_jax - ref) <= 1e-5 * np.abs(ref) + floor)
    assert np.all(np.abs(on_ours - ref) <= 2e-5 * np.abs(ref) + floor)


@pytest.fixture(scope="module", params=["global", "local"])
def k2_pair(request, sphere_path):
    """One segment from the same JAX-initialized state on JAX's own
    proposal stream and JAX's table: JAX's K2 (``_chunk_batch``, interpret
    mode), the same JAX step applied one step at a time (to locate a
    flip), and ``prefetch_reference`` with its trace."""
    kw = {"local_moves": 0.5} if request.param == "local" else {}
    je, te = _engines(sphere_path, **kw)
    nq = te.consts.n
    seg = mc_kernel.prefetch_seg_steps(te)
    assert seg == jax_mc_kernel.prefetch_seg_steps(je)
    assert seg == (N if kw else 64)          # local moves: capped at N
    spec = _with_table(te, *_jax_table(je, nq))
    state = je._init_batch(jax.random.split(jax.random.PRNGKey(0), R))
    keys = jax.vmap(jax.random.split)(state.key)
    props = np.asarray(je._draw_chunk_proposals(keys[:, 1], n_steps=seg),
                       np.float32)
    j_final, j_ri = je._chunk_batch(state, jnp.zeros((), jnp.int32))

    step = jax.jit(lambda s, c, ri: jax.vmap(
        lambda sr, cr: je._step(sr, cr, ri))(s, c))
    js = state._replace(ft=jnp.sum(state.ibank, axis=1))
    j_steps = []
    for s in range(seg):
        js = step(js, jnp.asarray(props[s]), jnp.asarray(s % N, jnp.int32))
        j_steps.append(_numpy(js, nq))

    start = _numpy(state, nq)
    t_state = state_from_numpy(start)
    cands = mc_kernel.segment_candidates(t_state, 0, spec,
                                         torch.tensor(props))
    rows = spec.kern.row(cands)
    trace = {}
    t_final, t_ri = mc_kernel.prefetch_reference(t_state, 0, te.consts,
                                                 spec, rows, cands, trace)
    return dict(te=te, spec=spec, cands=cands, rows=rows, start=start,
                j_final=_numpy(j_final, nq), j_ri=int(j_ri),
                j_steps=j_steps, t_final=state_to_numpy(t_final),
                t_ri=t_ri, trace=trace)


def _numpy(state, nq):
    """A JAX state's fields as numpy, lane padding cut off."""
    out = {k: np.asarray(getattr(state, k)) for k in state._fields
           if k != "key"}
    out["ibank"] = out["ibank"][..., :nq]
    out["ft"] = out["ft"][..., :nq]
    return out


def _first_flip(run):
    """First (step, rep) where the two trajectories decide differently:
    accept vs reject, or a different accepted parameter."""
    tr = run["trace"]
    prev = run["start"]["n_moves"]
    for s, js in enumerate(run["j_steps"]):
        j_acc = js["n_moves"] > prev
        prev = js["n_moves"]
        t_acc = tr["choice"][s].numpy() >= 0
        j_slot = js["rset"][:, s % N, :]
        t_slot = tr["slot"][s].numpy()
        bad = (j_acc != t_acc) | ~np.all(
            np.isclose(j_slot, t_slot, rtol=1e-6, atol=0.0), axis=1)
        if bad.any():
            return s, int(np.argmax(bad))
    return None


def _assert_states_match(ours, ref, ri_ours, ri_ref):
    # tolerances: counters and cursor exact; parameters to 1e-6 relative
    # (one float32 ulp of the accepted proposal), χ² to 1e-5, ft to 2e-4
    # (the port refreshes ft with a float64 sum, JAX with float32, and
    # the incremental updates then carry that difference along)
    assert ri_ours == ri_ref
    np.testing.assert_array_equal(ours["n_moves"], ref["n_moves"])
    np.testing.assert_array_equal(ours["n_iter"], ref["n_iter"])
    np.testing.assert_allclose(ours["rset"], ref["rset"], rtol=1e-6)
    np.testing.assert_allclose(ours["conval"], ref["conval"], rtol=1e-5)
    np.testing.assert_allclose(ours["ft"], ref["ft"], rtol=2e-4,
                               atol=2e-4 * np.abs(ref["ft"]).max())


def test_prefetch_twin_matches_jax_k2(k2_pair):
    """Exact decisions against JAX's K2 on the same state, proposals and
    table.  A decision may flip only where two χ² values are within
    float32 rounding of each other (the solve's sums associate
    differently); the first such flip must be a near-tie, and the
    trajectories must agree exactly up to it.  Without a flip the whole
    segment matches JAX's K2."""
    run = k2_pair
    assert run["t_final"]["n_moves"].min() > 0
    flip = _first_flip(run)
    if flip is None:
        _assert_states_match(run["t_final"], run["j_final"], run["t_ri"],
                             run["j_ri"])
        return
    s, r = flip
    tr = run["trace"]
    margin = float(mc_kernel.decision_margin(tr["chi"][s, r],
                                             tr["conval"][s, r]))
    print(f"first flip against JAX: step {s}, rep {r}, margin {margin:.3g}")
    assert margin <= NEAR_TIE, (
        f"first flip at step {s}, rep {r} is not a near-tie: margin "
        f"{margin:.3g}, candidate χ² {tr['chi'][s, r].tolist()}, "
        f"current χ² {float(tr['conval'][s, r])}")
    assert s > 0
    upto, ri = mc_kernel.prefetch_reference(
        state_from_numpy(run["start"]), 0, run["te"].consts, run["spec"],
        run["rows"][:s].contiguous(), run["cands"][:s].contiguous())
    _assert_states_match(state_to_numpy(upto), run["j_steps"][s - 1], ri,
                         s % N)


def test_segment_candidates_refuses_repeated_slots(sphere_path):
    _, te = _engines(sphere_path, local_moves=0.5)
    state = te._init_batch()
    props = te._draw_chunk_proposals(n_steps=N + 1)
    with pytest.raises(ValueError, match="distinct slots"):
        mc_kernel.segment_candidates(state, 0, te.spec, props)
    cands = mc_kernel.segment_candidates(state, 7, te.spec, props[:N])
    k_glob = te.spec.k_global
    np.testing.assert_array_equal(cands[:, :, :k_glob].numpy(),
                                  props[:N, :, :k_glob].numpy())
    lo, hi = te.bound.ranges[0]
    local = cands[:, :, k_glob:].numpy()
    assert local.min() >= np.float32(lo) and local.max() <= np.float32(hi)


def test_run_prefetch_chunk_on_cpu_runs_the_plain_version(sphere_path):
    _, te = _engines(sphere_path)
    assert mc_kernel.supports_prefetch(te) and not mc_kernel.supports(te)
    assert not te.runs_cuda_kernel and te.seg_steps == 64
    state = te._init_batch()
    cands = te._draw_chunk_proposals(n_steps=20)
    rows = te.kern.row(cands)
    before = mc_kernel.run_prefetch_chunk.launches
    a, ri_a = mc_kernel.run_prefetch_chunk(state.clone(), 45, te.consts,
                                           te.spec, rows, cands)
    b, ri_b = mc_kernel.prefetch_reference(state.clone(), 45, te.consts,
                                           te.spec, rows, cands)
    assert ri_a == ri_b == 15
    for k, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, getattr(b, k).numpy())
    assert mc_kernel.run_prefetch_chunk.launches == before
    with pytest.raises(ValueError, match="rows"):
        mc_kernel.run_prefetch_chunk(state, 0, te.consts, te.spec,
                                     rows.double(), cands)
    with pytest.raises(ValueError, match="rows"):
        mc_kernel.run_prefetch_chunk(state, 0, te.consts, te.spec,
                                     rows[:5], cands)
    with pytest.raises(ValueError, match="cands"):
        mc_kernel.run_prefetch_chunk(state, 0, te.consts, te.spec, rows,
                                     cands[..., :0])


# ------------------------------------------- K2's table entry on the CPU

_BIND2 = dict(active=("radius", "aspect"),
              active_ranges={"radius": (1e-10, 5e-8), "aspect": (1.0, 30.0)})


def _table_engine(path, bind=_BIND, **kw):
    return McSASEngine(data.load(path),
                       get_model("CylindersIsotropic").bind(**bind),
                       McSASConfig(**_config(table_ff="on", **kw)),
                       device="cpu")


def kernel_blend(values, layout, cands, sw, row_clamp, log=np.log):
    """K2's in-kernel row blend (csrc/mc_prefetch.cuh, mc2_axis_coords,
    mc2_blend_setup and K2Blend::blend) as a numpy model, operation by
    operation in float32 in the kernel's order: per table axis, last
    first, log, subtract, divide, the two clamps (comparisons, so that a
    NaN stays), floor, the corner weights chained over the axes; then the
    corner rows times their weights added in corner order, times sqrt(w),
    squared, clamped.  *cands* (B, P), *sw* (B,) float32; rows (B, Nq)."""
    f32 = np.float32
    n_c = cands.shape[0]
    idx, cw, stride = [np.zeros(n_c, np.int64)], [np.ones(n_c, f32)], 1
    with np.errstate(all="ignore"):
        for col, fixed, l0, dl, n, hi in reversed(layout):
            v = cands[:, col] if col >= 0 else np.full(n_c, fixed, f32)
            v = np.where(v < 0, f32(0), v)
            f = (log(v) - f32(l0)) / f32(dl)
            f = np.where(f < 0, f32(0), f)
            f = np.where(f > f32(hi), f32(hi), f)
            fl = np.floor(f)
            i = np.where(np.isnan(fl), 0, fl).astype(np.int64)
            w = f - fl
            w1 = f32(1) - w
            idx, cw = ([c + i * stride for c in idx]
                       + [c + (i + 1) * stride for c in idx],
                       [x * w1 for x in cw] + [x * w for x in cw])
            stride *= n
        assert all(x.dtype == f32 for x in cw)
        acc = None
        for c, x in zip(idx, cw):
            term = values[np.clip(c, 0, values.shape[0] - 1)] * x[:, None]
            acc = term if acc is None else acc + term
        fs = acc * sw[:, None]
        row = fs * fs
        assert row.dtype == f32
        return np.where(row > f32(row_clamp), f32(row_clamp), row)


def _torch_log(v):
    return torch.log(torch.as_tensor(v)).numpy()


def _fixed_axis_engine(path):
    """A radius-only engine on the two-axis (radius, aspect) table: the
    table's second axis is fed by the fixed aspect, not by a column."""
    te = _table_engine(path)
    kern = dataclasses.replace(
        te.kern, table=_table_engine(path, _BIND2).kern.table,
        table_fn=tables.make_lookup(("radius", "aspect")))
    te.kern = kern
    te.spec = dataclasses.replace(te.spec, kern=kern)
    return te


@pytest.mark.parametrize("axes", [1, 2, "fixed"])
def test_kernel_blend_model_equals_the_row(sphere_path, axes, monkeypatch):
    """The numpy model of K2's in-kernel blend equals IntensityKernel.row
    on the cylinder table of one axis, of two, and of two with the second
    fed by a fixed parameter: off the grid, on its nodes, below and above
    it (both ends of the clamp), at zero, at a negative and at a NaN
    candidate (the last two give NaN rows).  Tolerance: bit for bit with
    PyTorch's float32 log; with numpy's log, bit for bit wherever the two
    logs agree, and elsewhere (they may differ by one ulp, which moves
    the blend weight by ulp(log v)/dl) within 1e-5 relative with a floor
    of 1e-6 of the largest row value — those rows are counted."""
    if axes != 1:       # 16 x 16 nodes: a quick bake of the two-axis table
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    te = (_fixed_axis_engine(sphere_path) if axes == "fixed"
          else _table_engine(sphere_path, _BIND if axes == 1 else _BIND2))
    layout = te.spec.table_layout
    if axes == "fixed":
        assert [ax[:2] for ax in layout] == [(0, 0.0), (-1, 10.0)]
    else:
        assert [ax[0] for ax in layout] == list(range(axes))
    assert all(hi == np.float32(n - 1.000001) for *_, n, hi in layout)
    rs = np.random.default_rng(11)
    cols = []
    for (lo, hi), (_, _, l0, dl, n, _) in zip(te.bound.ranges, layout):
        nodes = np.exp(np.float64(l0) + np.arange(n) * np.float64(dl))
        cols.append(np.concatenate([
            np.exp(rs.uniform(np.log(lo), np.log(hi), 150)), nodes,
            [lo, hi, lo / 10, hi * 10, 0.0, -hi, np.nan]]))
    if axes == 2:       # every special radius with every kind of aspect
        cols = [np.concatenate([cols[0], rs.permutation(cols[0])]),
                np.concatenate([cols[1], cols[1]])]
    cands = np.stack(cols, axis=1).astype(np.float32)
    t_cands = torch.as_tensor(cands)
    want = te.kern.row(t_cands).numpy()
    sw = mc_kernel.sqrt_weights(te.spec, t_cands).numpy()
    values = te.kern.table.values.numpy()
    assert sw.shape == (len(cands),) and sw.dtype == np.float32
    # a NaN candidate, and a negative one (its volume to a fractional
    # power, so its sqrt(w), is a NaN): their rows are NaN
    nan_rows = np.isnan(cands).any(axis=1) | np.isnan(sw)
    assert nan_rows.sum() >= 2 and np.isnan(want[nan_rows]).all()
    assert np.isfinite(want[~nan_rows]).all()

    ours = kernel_blend(values, layout, cands, sw, te.kern.row_clamp,
                        log=_torch_log)
    np.testing.assert_array_equal(ours, want)

    with np.errstate(all="ignore"):
        pos = np.where(cands < 0, np.float32(0), cands)
        same_log = (np.log(pos).view(np.int32)
                    == _torch_log(pos).view(np.int32)).all(axis=1)
    ours = kernel_blend(values, layout, cands, sw, te.kern.row_clamp)
    np.testing.assert_array_equal(ours[same_log], want[same_log])
    other = ~same_log & ~nan_rows
    print(f"{int(other.sum())} of {len(cands)} candidates where numpy's "
          f"float32 log differs from PyTorch's")
    np.testing.assert_allclose(ours[other], want[other], rtol=1e-5,
                               atol=1e-6 * np.abs(want[~nan_rows]).max())


@pytest.mark.parametrize("mode", ["global", "local"])
def test_table_entry_plain_version_is_the_rows_reference(sphere_path, mode):
    """``prefetch_table_reference`` is ``prefetch_reference`` on the
    lookup's rows, bit for bit; the wrapper of K2's table entry runs it
    for CPU tensors; and a CPU ``_segment`` gives the state that drawing,
    moving, looking up and ``prefetch_reference`` give."""
    te = _table_engine(sphere_path,
                       **({"local_moves": 0.5} if mode == "local" else {}))
    te.gen.manual_seed(3)
    state = te._init_batch()
    gen_state = te.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 7, te.spec, te._draw_chunk_proposals(te.seg_steps))
    want, ri_w = mc_kernel.prefetch_reference(
        state.clone(), 7, te.consts, te.spec, te.kern.row(cands), cands)
    assert int(want.n_moves.sum()) > 0
    plain, ri_p = mc_kernel.prefetch_table_reference(
        state.clone(), 7, te.consts, te.spec, cands)
    before = mc_kernel.run_prefetch_table_chunk.launches
    wrapped, ri_r = mc_kernel.run_prefetch_table_chunk(
        state.clone(), 7, te.consts, te.spec, cands,
        mc_kernel.sqrt_weights(te.spec, cands))
    assert mc_kernel.run_prefetch_table_chunk.launches == before
    te.gen.set_state(gen_state)
    seg, ri_s = te._segment(state.clone(), 7)
    assert ri_w == ri_p == ri_r == ri_s == (7 + te.seg_steps) % N
    for k, v in state_to_numpy(want).items():
        for got in (plain, wrapped, seg):
            np.testing.assert_array_equal(getattr(got, k).numpy(), v)


def test_table_entry_refuses_bad_input(sphere_path):
    """The wrapper of K2's table entry refuses a table, sqrt(w) or axis
    layout of the wrong shape, dtype or device."""
    te = _table_engine(sphere_path)
    state = te._init_batch()
    cands = te._draw_chunk_proposals(n_steps=6)
    sw = mc_kernel.sqrt_weights(te.spec, cands)
    assert tuple(sw.shape) == (6, R, 8) and sw.is_contiguous()

    def run(spec=te.spec, sw=sw, cands=cands):
        return mc_kernel.run_prefetch_table_chunk(state.clone(), 0,
                                                  te.consts, spec, cands, sw)

    run()
    for bad in (sw.double(), sw[:5], sw[..., :4].contiguous(),
                sw.transpose(1, 2), sw.to("meta")):
        with pytest.raises(ValueError, match="sw"):
            run(sw=bad)
    with pytest.raises(ValueError, match="cands"):
        run(cands=cands[..., :0])
    table = te.kern.table

    def with_table(values=table.values, axes=table.axes,
                   table_fn=te.kern.table_fn):
        kern = dataclasses.replace(
            te.kern, table=tables.ParamTable(values=values, axes=axes),
            table_fn=table_fn)
        return dataclasses.replace(te.spec, kern=kern)

    for values in (table.values.double(), table.values[:, :5].contiguous(),
                   table.values.t(), table.values.to("meta")):
        with pytest.raises(ValueError, match="table"):
            run(spec=with_table(values=values))
    (l0, dl, n), = table.axes
    with pytest.raises(ValueError, match="table"):        # 64 rows, 63 nodes
        run(spec=with_table(axes=((l0, dl, n - 1),)))
    with pytest.raises(ValueError, match="2 parameters"):
        run(spec=with_table(table_fn=tables.make_lookup(("radius",
                                                         "aspect"))))
    with pytest.raises(ValueError, match="make_lookup"):
        run(spec=with_table(table_fn=lambda table, pdict: None))
    three = tables.make_lookup(("radius", "aspect", "length"))
    with pytest.raises(ValueError, match="at most 2 table axes"):
        run(spec=with_table(values=table.values[:8].contiguous(),
                            axes=((l0, dl, 2),) * 3, table_fn=three))
    no_table = dataclasses.replace(
        te.spec, kern=dataclasses.replace(te.kern, table=None))
    with pytest.raises(ValueError, match="table"):
        run(spec=no_table)


def test_table_engine_routing(sphere_path):
    """A table engine runs segments (K2's plain version on the CPU); with
    the table off the cylinder has no kernel, and 'on' raises."""
    d = data.load(sphere_path)
    bound = get_model("CylindersIsotropic").bind(**_BIND)
    on = McSASEngine(d, bound, McSASConfig(**_config(
        table_ff="on", use_pallas="on", local_moves=0.5,
        max_iterations=8 * 120)), device="cpu")
    assert on.uses_table and on.seg_steps == N and not on.runs_cuda_kernel
    chunks = []
    res = on.run(progress=chunks.append)
    # 120 steps in segments of N=50: 50, 50, 50 (the last one cut short
    # by max_iterations inside the segment), then the one retry that
    # max_retries=0 leaves (max_retries + 2 attempts) does the same
    per_chunk = [int(c["n_iter"][0]) for c in chunks]
    assert per_chunk == [8 * 50, 8 * 100, 8 * 120] * 2
    assert list(res.n_iter) == [8 * 120] * R and list(res.attempts) == [2] * R
    assert res.used_table and not res.used_prefetch and not res.used_pallas
    off = McSASEngine(d, bound, McSASConfig(**_config(table_ff="off")),
                      device="cpu")
    assert not off.uses_table and off.seg_steps is None
    with pytest.raises(ValueError, match="eligible"):
        McSASEngine(d, bound, McSASConfig(**_config(
            table_ff="off", use_pallas="on")), device="cpu")


# ------------------------------------------------------- the slice

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cylinder_golden_matches_bench():
    """chip_smoke.py's synthetic golden, built with the port's float64
    functions, against bench.synth_golden("cylinder"); tolerance 1e-12
    relative (the same n=801 rule in float64)."""
    with pytest.MonkeyPatch.context() as mp:
        # importing bench defaults the table disk cache into the repo
        mp.setenv("MCSAS_TPU_TABLE_CACHE_DIR", "")
        spec = importlib.util.spec_from_file_location("bench",
                                                      REPO / "bench.py")
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
        ref = bench.synth_golden("cylinder")
    ours = _chip_smoke().cylinder_golden()
    np.testing.assert_allclose(ours.q, ref.q, rtol=1e-15)
    np.testing.assert_allclose(ours.f, ref.f, rtol=1e-12)
    np.testing.assert_allclose(ours.fu, ref.fu, rtol=1e-12)
    assert ours.count == ref.count == 100


def test_cylinder_fit_on_the_cpu(monkeypatch):
    """fit() of the cylinder golden on the table tier converges.  The cut
    against the suite row: 3 repetitions of 60 contributions, K=32 with
    local moves 0.5, a 5-20 nm range and a 256-row table (64 rows stall
    at χ² ≈ 900, the interpolation then being coarser than the data's 1 %
    uncertainty)."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "256")
    golden = _chip_smoke().cylinder_golden()
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (5e-9, 20e-9)})
    cfg = McSASConfig(num_contribs=60, num_reps=3, max_iterations=2_000_000,
                      chunk_steps=1024, candidates_per_step=32, seed=2026,
                      max_retries=1, local_moves=0.5, show_incomplete=True)
    assert cfg.table_ff_enabled()
    res = fit(golden, bound, cfg, device="cpu")
    e = res.engine
    assert res.converged and e.conval.max() <= 1.0
    assert e.used_table and not e.used_prefetch and not e.used_pallas
    assert e.contribs.shape == (3, 60, 1)
    assert np.isfinite(res.fractions.measval).all()
    # the vol-weighted mean radius of the default histogram's moments
    mean_r = float(res.histograms[0].moments.mean[0])
    assert abs(mean_r - 10e-9) <= 0.1 * 10e-9
