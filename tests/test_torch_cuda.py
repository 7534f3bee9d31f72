# -*- coding: utf-8 -*-
"""PyTorch port on the card: the CUDA chunk kernels K1 (mc_chunk, every
model with a device function) and K2 (mc_prefetch) against their plain
PyTorch versions, the latency probe K3 (mc_probe) against K1, and the
engine's routing to them.  Marked ``cuda``; every test skips without a
CUDA device (decided inside the fixture).  On a machine with a card and
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import dataclasses
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch import load  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.data import (DataConfig, TrapezoidSmearing,  # noqa: E402
                                  from_raw)
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, tables  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402

pytestmark = pytest.mark.cuda
DATA = (pathlib.Path(__file__).resolve().parent.parent / "testdata"
        / "sasfit_sphere-10-1.dat")
CYL_BIND = dict(active=("radius",), active_ranges={"radius": (1e-10, 5e-8)})
# K1's comparison shapes: (repetitions R, candidates K, fit-grid bins,
# contributions N).  K1 runs a group of 8-32 lanes per candidate, lanes
# over q, and at most 1024 threads: these cover K below, at and above the
# groups in flight, a grid that is no multiple of the group, one smaller
# than the group, one longer than the rows a group keeps in registers
# (104 points), one longer than the block (read a step at a time, not a
# step ahead), and a bank of one slot (whose row each step rewrites).
SHAPES = {"r3-k48-bins100": (3, 48, 100, 64),
          "r1-k8-bins5": (1, 8, 5, 64),
          "r2-k64-bins100": (2, 64, 100, 64),
          "r2-k200-bins200": (2, 200, 200, 64),
          "r2-k8-bins100-n1": (2, 8, 100, 1)}
_ENGINES = {}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _first_flips(kt, tt):
    """{rep: first step} where the kernel's decisions leave the plain
    version's; each such step must be a near-tie (relative χ² gap
    ≤ 1e-6)."""
    kc, tc = kt["choice"].cpu().numpy(), tt["choice"].cpu().numpy()
    flips = {}
    for r in range(kc.shape[1]):
        diff = np.nonzero(kc[:, r] != tc[:, r])[0]
        if len(diff):
            s = int(diff[0])
            margin = float(mc_kernel.decision_margin(tt["chi"][s, r],
                                                     tt["conval"][s, r]))
            assert margin <= 1e-6, (r, s, margin)
            flips[r] = s
    return flips


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg = McSASConfig(num_contribs=64, num_reps=3, chunk_steps=128,
                      candidates_per_step=48, local_moves=0.5, seed=5,
                      max_iterations=1_000_000)
    eng = McSASEngine(load(DATA), get_model("Sphere").bind(), cfg,
                      device="cuda")
    assert eng.runs_cuda_kernel
    return eng


def _sphere_engine(shape):
    """A Sphere engine on the card at one of SHAPES (local moves 0.5),
    the data rebinned to the shape's grid."""
    if shape not in _ENGINES:
        reps, k, n_bin, n = SHAPES[shape]
        cfg = McSASConfig(num_contribs=n, num_reps=reps, chunk_steps=128,
                          candidates_per_step=k, local_moves=0.5, seed=5,
                          max_iterations=1_000_000)
        data = load(DATA, config=DataConfig(n_bin=n_bin))
        _ENGINES[shape] = McSASEngine(data, get_model("Sphere").bind(), cfg,
                                      device="cuda")
    return _ENGINES[shape]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_version(shape):
    """Injected proposals: identical accept decisions until a near-tie
    (relative χ² gap ≤ 1e-6); where no flip occurs, the same state.  The
    two run the same float32 operations, so ft matches the plain
    version's to 1e-6; against Σ bank it carries the incremental float32
    drift of 200 steps over N slots (rows of clamped, huge candidates
    enter and leave the total), bounded to 1e-3 of max |ft| by the
    refresh at every chunk start."""
    _needs_card()
    engine = _sphere_engine(shape)
    n = engine.cfg.num_contribs
    assert engine.consts.n == SHAPES[shape][2]
    engine.gen.manual_seed(2)
    state = engine._init_batch()
    props = engine._draw_chunk_proposals(n_steps=200)
    ks, kt = state.clone(), {}
    before = mc_kernel.run_chunk.launches
    _, ri = mc_kernel.run_chunk(ks, 7, engine.consts, engine.spec,
                                proposals=props, trace=kt)
    assert mc_kernel.run_chunk.launches == before + 1 and ri == 207 % n
    ts, tt = state.clone(), {}
    mc_kernel.chunk_reference(ts, 7, engine.consts, engine.spec, props,
                              trace=tt)
    torch.cuda.synchronize()
    assert (kt["choice"] >= 0).any()
    flips = _first_flips(kt, tt)
    for r in range(state.conval.shape[0]):
        if r in flips:
            continue
        np.testing.assert_allclose(ks.rset[r].cpu(), ts.rset[r].cpu(),
                                   rtol=1e-6)
        np.testing.assert_allclose(ks.conval[r].cpu(), ts.conval[r].cpu(),
                                   rtol=1e-5)
        np.testing.assert_allclose(ks.ft[r].cpu(), ts.ft[r].cpu(),
                                   rtol=1e-6)
        assert int(ks.n_moves[r]) == int(ts.n_moves[r])
    bank_sum = ks.ibank.double().sum(1).cpu()
    np.testing.assert_allclose(ks.ft.double().cpu(), bank_sum, rtol=0,
                               atol=1e-3 * float(bank_sum.abs().max()))


def test_philox_mode_draws_the_documented_stream(engine):
    engine.gen.manual_seed(3)
    state = engine._init_batch()
    ps, pt = state.clone(), {}
    mc_kernel.run_chunk(ps, 0, engine.consts, engine.spec, seed=77,
                        n_steps=60, trace=pt)
    host = mc_kernel.philox_proposals(engine.spec, 77, 3, 60)
    choice = pt["choice"].cpu().numpy()
    rset = ps.rset.cpu().numpy()
    hits = 0
    for s, r in zip(*np.nonzero((choice >= 0)
                                & (choice < engine.spec.k_global))):
        assert rset[r, s, 0] == host[s, r, choice[s, r], 0]
        hits += 1
    assert hits > 0
    assert (ps.conval <= state.conval).all()


def test_ineligible_config_on_the_card_raises(engine):
    """On the card only use_pallas='off' runs the plain chunk: a float64
    config under 'auto' raises instead of running it quietly."""
    d, bound = engine.data, engine.bound
    with pytest.raises(ValueError, match="eligible"):
        McSASEngine(d, bound, McSASConfig(num_contribs=64, dtype="float64"),
                    device="cuda")
    off = McSASEngine(d, bound, McSASConfig(num_contribs=64, dtype="float64",
                                            use_pallas="off"),
                      device="cuda")
    assert not off.runs_cuda_kernel


def test_kernel_refuses_bad_input(engine):
    state = engine._init_batch()
    bad = state.clone()
    bad.ft = bad.ft.double()
    with pytest.raises(ValueError, match="ft"):
        mc_kernel.run_chunk(bad, 0, engine.consts, engine.spec, seed=1,
                            n_steps=4)
    with pytest.raises(ValueError, match="seed"):
        mc_kernel.run_chunk(state, 0, engine.consts, engine.spec)


# ------------------------------------------------------------------ K2

def _cylinder_engine(**kw):
    cfg = dict(num_contribs=64, num_reps=3, chunk_steps=60,
               candidates_per_step=48, seed=5, max_iterations=1_000_000,
               table_ff="on")
    cfg.update(kw)
    return McSASEngine(load(DATA),
                       get_model("CylindersIsotropic").bind(**CYL_BIND),
                       McSASConfig(**cfg), device="cuda")


@pytest.fixture(scope="module")
def small_tables():
    """A card, and tables of at most 64 nodes an axis for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield


@pytest.fixture(scope="module")
def cylinder(small_tables):
    """Table engines on the card (64-row tables), without and with local
    moves."""
    return {"global": _cylinder_engine(),
            "local": _cylinder_engine(local_moves=0.5)}


@pytest.mark.parametrize("mode", ["global", "local"])
def test_prefetch_kernel_matches_plain_version(cylinder, mode):
    """One segment on the same candidates and rows: identical decisions
    until a near-tie (relative χ² gap ≤ 1e-6); where no flip occurs, the
    same state.  With the rows given there are no transcendentals and
    the kernel repeats the plain version's float32 operations, so ft
    agrees to 1e-6 and χ² to 1e-5 relative."""
    eng = cylinder[mode]
    assert eng.uses_table and eng.runs_cuda_kernel and eng.seg_steps == 60
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    cands = mc_kernel.segment_candidates(
        state, 9, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    rows = eng.kern.row(cands)
    ks, kt = state.clone(), {}
    before = mc_kernel.run_prefetch_chunk.launches
    _, ri = mc_kernel.run_prefetch_chunk(ks, 9, eng.consts, eng.spec, rows,
                                         cands, trace=kt)
    assert mc_kernel.run_prefetch_chunk.launches == before + 1
    assert ri == 69 % 64
    ts, tt = state.clone(), {}
    mc_kernel.prefetch_reference(ts, 9, eng.consts, eng.spec, rows, cands,
                                 trace=tt)
    torch.cuda.synchronize()
    kc, tc = kt["choice"].cpu().numpy(), tt["choice"].cpu().numpy()
    assert (kc >= 0).any()
    for r in range(kc.shape[1]):
        diff = np.nonzero(kc[:, r] != tc[:, r])[0]
        if len(diff):
            s = diff[0]
            margin = float(mc_kernel.decision_margin(tt["chi"][s, r],
                                                     tt["conval"][s, r]))
            assert margin <= 1e-6, (r, s, margin)
            continue
        np.testing.assert_allclose(ks.rset[r].cpu(), ts.rset[r].cpu(),
                                   rtol=1e-6)
        np.testing.assert_allclose(ks.conval[r].cpu(), ts.conval[r].cpu(),
                                   rtol=1e-5)
        np.testing.assert_allclose(ks.ft[r].cpu(), ts.ft[r].cpu(),
                                   rtol=1e-6, atol=1e-6 * float(
                                       ts.ft[r].abs().max()))
        np.testing.assert_array_equal(ks.ibank[r].cpu(), ts.ibank[r].cpu())
        assert int(ks.n_moves[r]) == int(ts.n_moves[r])
        assert int(ks.n_iter[r]) == int(ts.n_iter[r])


# K2's comparison shapes: K1's, which give its lane groups the same ragged
# edges (K = 200 at 200 bins also needs more shared memory than two staged
# blocks of rows may take, so its rows are read from global memory), and
# one whose step block K*Nq*4 bytes is no multiple of 16 (read directly
# too)
K2_SHAPES = dict(SHAPES, **{"r1-k3-bins5": (1, 3, 5, 64)})
K2_DIRECT = ("r2-k200-bins200", "r1-k3-bins5")
K2_AXES = {"1-axis": dict(CYL_BIND),
           "2-axis": dict(active=("radius", "aspect"),
                          active_ranges={"radius": (1e-10, 5e-8),
                                         "aspect": (1.0, 30.0)})}


_SMEARED = "-smeared"


def _k2_engine(shape, mode, axes="1-axis"):
    """A cylinder table engine on the card at one of K2_SHAPES, with or
    without local moves, on a table of one or two axes; 'fixed-axis': the
    radius alone active on the two-axis table, whose second axis the fixed
    aspect feeds.  With the suffix '-smeared' the data is slit-smeared
    (5 offsets) and the table holds intensities."""
    key = ("k2", shape, mode, axes)
    if key not in _ENGINES:
        reps, k, n_bin, n = K2_SHAPES[shape]
        cfg = McSASConfig(num_contribs=n, num_reps=reps, chunk_steps=60,
                          candidates_per_step=k, seed=5,
                          max_iterations=1_000_000, table_ff="on",
                          local_moves=0.5 if mode == "local" else 0.0)
        smeared = axes.endswith(_SMEARED)
        plain_axes = axes[:-len(_SMEARED)] if smeared else axes
        data = load(DATA, config=DataConfig(
            n_bin=n_bin, smearing=TrapezoidSmearing(
                do_smear=True, n_steps=4, umbra=0.05e9, penumbra=0.2e9)
            if smeared else None))
        assert data.uses_smearing == smeared
        bind = K2_AXES["1-axis" if plain_axes == "fixed-axis"
                       else plain_axes]
        eng = McSASEngine(data, get_model("CylindersIsotropic").bind(**bind),
                          cfg, device="cuda")
        assert eng.kern.table_is_intensity == smeared
        if plain_axes == "fixed-axis":
            two = "2-axis" + (_SMEARED if smeared else "")
            kern = dataclasses.replace(
                eng.kern, table=_k2_engine(shape, mode, two).kern.table,
                table_fn=tables.make_lookup(("radius", "aspect")))
            eng.kern = kern
            eng.spec = dataclasses.replace(eng.spec, kern=kern)
        _ENGINES[key] = eng
    return _ENGINES[key]


def _k2_segment(eng, ri=9):
    """(state, cursor, candidates) of one segment from a fresh state."""
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    ri = ri % eng.cfg.num_contribs
    cands = mc_kernel.segment_candidates(
        state, ri, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    return state, ri, cands


def _run_k2_entry(eng, entry, state, ri, cands, trace=None):
    """One segment through K2's *entry* ('rows' or 'table'), in place."""
    if entry == "rows":
        return mc_kernel.run_prefetch_chunk(
            state, ri, eng.consts, eng.spec, eng.kern.row(cands), cands,
            trace=trace)
    return mc_kernel.run_prefetch_table_chunk(
        state, ri, eng.consts, eng.spec, cands,
        mc_kernel.table_factors(eng.spec, cands), trace=trace)


# the intensity row (smeared tables) at K = 8, 48 and 200, grids of 5,
# 100 and 200 points, one and two table axes and a fixed-fed axis
_K2_CASES = ([(shape, "1-axis") for shape in sorted(K2_SHAPES)]
             + [("r3-k48-bins100", "2-axis"), ("r2-k200-bins200", "2-axis"),
                ("r3-k48-bins100", "fixed-axis")]
             + [(shape, "1-axis" + _SMEARED)
                for shape in ("r1-k8-bins5", "r3-k48-bins100",
                              "r2-k200-bins200")]
             + [("r3-k48-bins100", "2-axis" + _SMEARED),
                ("r3-k48-bins100", "fixed-axis" + _SMEARED)])


@pytest.mark.parametrize("entry", ["rows", "table"])
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("shape,axes", _K2_CASES)
def test_prefetch_entries_equal_plain_versions(small_tables, shape, axes,
                                               mode, entry):
    """Both entries of K2 against their plain versions over one segment:
    every decision and every bit of the state equal (the table entry's
    bank holds the rows the kernel blended, so the blend is bitwise the
    lookup's), for amplitude tables ((blend·√w)²) and for the intensity
    tables of smeared fits (blend·w)."""
    eng = _k2_engine(shape, mode, axes)
    assert eng.uses_table and eng.runs_cuda_kernel
    assert eng.prefetch_entry == "table"
    assert eng.kern.table_is_intensity == axes.endswith(_SMEARED)
    assert len(eng.spec.table_layout) == (1 if axes.startswith("1-axis")
                                          else 2)
    assert (eng.spec.table_layout[-1][0] < 0) == axes.startswith(
        "fixed-axis")
    state, ri, cands = _k2_segment(eng)
    counter = (mc_kernel.run_prefetch_chunk if entry == "rows"
               else mc_kernel.run_prefetch_table_chunk)
    before = counter.launches
    ks, kt = state.clone(), {}
    _, ri_k = _run_k2_entry(eng, entry, ks, ri, cands, kt)
    assert counter.launches == before + 1
    ts, tt = state.clone(), {}
    if entry == "table":
        _, ri_t = mc_kernel.prefetch_table_reference(
            ts, ri, eng.consts, eng.spec, cands, trace=tt)
    else:
        _, ri_t = mc_kernel.prefetch_reference(
            ts, ri, eng.consts, eng.spec, eng.kern.row(cands), cands,
            trace=tt)
    torch.cuda.synchronize()
    assert ri_k == ri_t == (ri + eng.seg_steps) % eng.cfg.num_contribs
    # (local moves on a bank of one slot make a segment of one step)
    assert eng.seg_steps == 1 or (tt["choice"] >= 0).any()
    assert torch.equal(kt["choice"], tt["choice"])
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f


@pytest.mark.parametrize("shape", sorted(K2_SHAPES))
def test_prefetch_launch_shape(small_tables, shape):
    """K2 runs 8 lanes per candidate, at most one group per candidate and
    1024 threads, in whole warps; rows come staged through shared memory
    unless the shape rule sends them directly (K2_DIRECT), the table's
    corner rows a step ahead unless it reads them from the table."""
    eng = _k2_engine(shape, "global")
    state, _, cands = _k2_segment(eng)
    k = eng.spec.k_cand
    for rows in (eng.kern.row(cands), None):
        got = mc_kernel.prefetch_launch_shape(state, eng.consts, eng.spec,
                                              cands, rows)
        assert got["group"] == 8, got
        assert got["threads"] == -(-min(k, 128) * 8 // 32) * 32, got
        assert 0 < got["registers"] <= 65536 // got["threads"], got
        assert 0 < got["smem_bytes"] <= 227 * 1024, got
        assert 1 <= got["ft_parts"] <= got["threads"] // 32, got
        if rows is None:
            # the corner rows a step ahead where every candidate has a
            # group of its own, the grid fits the row registers and a row
            # is a whole number of 16-byte pieces
            nq = eng.consts.n
            want = ("table_ahead" if k <= 128 and nq <= 104 and nq % 4 == 0
                    else "table")
        else:
            want = "direct" if shape in K2_DIRECT else "staged"
        assert got["source"] == want, got
    # rows that do not start on 16 bytes are read directly too
    rows = eng.kern.row(cands)
    flat = torch.empty(rows.numel() + 1, dtype=rows.dtype, device="cuda")
    odd = flat[1:].view(rows.shape).copy_(rows)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    got = mc_kernel.prefetch_launch_shape(state, eng.consts, eng.spec,
                                          cands, odd)
    assert got["source"] == "direct", got
    a, b = state.clone(), state.clone()
    mc_kernel.run_prefetch_chunk(a, 0, eng.consts, eng.spec, odd, cands)
    mc_kernel.run_prefetch_chunk(b, 0, eng.consts, eng.spec, rows, cands)
    torch.cuda.synchronize()
    assert torch.equal(a.ibank, b.ibank) and torch.equal(a.conval, b.conval)


@pytest.mark.parametrize("entry", ["rows", "table", "intensity"])
def test_prefetch_probe_full_rung_equals_the_kernel(cylinder, entry):
    """K3's full rung of K2 is K2 compiled again: bit for bit the same
    state; a shorter rung changes no state and leaves finite values.
    'intensity': the table entry on a smeared table."""
    eng = cylinder["local"]
    if entry == "intensity":
        eng = _k2_engine("r3-k48-bins100", "local", "1-axis" + _SMEARED)
        entry = "table"
    state, ri, cands = _k2_segment(eng)
    rows = eng.kern.row(cands) if entry == "rows" else None
    sw = mc_kernel.table_factors(eng.spec, cands) if rows is None else None
    a, b = state.clone(), state.clone()
    _run_k2_entry(eng, entry, a, ri, cands)
    before = mc_kernel.run_probe.launches
    _, ri_b, sink = mc_kernel.run_prefetch_probe(
        b, ri, eng.consts, eng.spec, "full", cands, rows, sw)
    assert mc_kernel.run_probe.launches == before + 1 and sink is None
    assert ri_b == (ri + eng.seg_steps) % eng.cfg.num_contribs
    torch.cuda.synchronize()
    assert (a.n_moves > 0).any()
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for level in mc_kernel.PREFETCH_PROBE_LEVELS[:-1]:
        c = state.clone()
        _, _, sink = mc_kernel.run_prefetch_probe(
            c, ri, eng.consts, eng.spec, level, cands, rows, sw)
        torch.cuda.synchronize()
        shape = mc_kernel.prefetch_launch_shape(state, eng.consts, eng.spec,
                                                cands, rows, level)
        assert sink.shape == (eng.cfg.num_reps, shape["threads"])
        assert torch.isfinite(sink).all(), level
        for f in ("rset", "ibank", "conval", "n_iter"):
            assert torch.equal(getattr(c, f), getattr(state, f)), (level, f)


def test_prefetch_kernel_refuses_bad_input(cylinder):
    eng = cylinder["global"]
    state = eng._init_batch()
    cands = eng._draw_chunk_proposals(8)
    rows = eng.kern.row(cands)
    sw = mc_kernel.sqrt_weights(eng.spec, cands)
    for bad_sw in (sw.cpu(), sw.double(), sw[..., :5].contiguous(),
                   sw.transpose(1, 2)):
        with pytest.raises(ValueError, match="sw"):
            mc_kernel.run_prefetch_table_chunk(state, 0, eng.consts,
                                               eng.spec, cands, bad_sw)
    with pytest.raises(ValueError, match="cands"):
        mc_kernel.run_prefetch_table_chunk(state, 0, eng.consts, eng.spec,
                                           cands.cpu(), sw)
    # an amplitude table takes sqrt(w), not w
    with pytest.raises(ValueError, match="take the factor 'sqrt_w'"):
        mc_kernel.run_prefetch_table_chunk(
            state, 0, eng.consts, eng.spec, cands,
            mc_kernel.TableFactors(sw, "w"))
    with pytest.raises(ValueError, match="rows"):
        mc_kernel.run_prefetch_chunk(state, 0, eng.consts, eng.spec,
                                     rows.double(), cands)
    with pytest.raises(ValueError, match="rows"):
        mc_kernel.run_prefetch_chunk(state, 0, eng.consts, eng.spec,
                                     rows[:, :, :5].contiguous(), cands)
    with pytest.raises(ValueError, match="rows"):
        mc_kernel.run_prefetch_chunk(state, 0, eng.consts, eng.spec,
                                     rows.cpu(), cands)
    with pytest.raises(ValueError, match="cands"):
        mc_kernel.run_prefetch_chunk(state, 0, eng.consts, eng.spec, rows,
                                     cands.cpu())
    bad = state.clone()
    bad.conval = bad.conval.double()
    with pytest.raises(ValueError, match="conval"):
        mc_kernel.run_prefetch_chunk(bad, 0, eng.consts, eng.spec, rows,
                                     cands)


def test_intensity_table_refuses_the_amplitude_factor(small_tables):
    """The flag and the factor go together: an intensity table takes w
    (``table_factors``); sqrt(w), tagged or as a plain tensor, is refused
    before any launch."""
    eng = _k2_engine("r3-k48-bins100", "global", "1-axis" + _SMEARED)
    state, ri, cands = _k2_segment(eng)
    factors = mc_kernel.table_factors(eng.spec, cands)
    assert factors.kind == "w"
    root = mc_kernel.sqrt_weights(eng.spec, cands)
    assert not torch.equal(root * root, factors.values)
    before = mc_kernel.run_prefetch_table_chunk.launches
    for bad in (root, mc_kernel.TableFactors(root, "sqrt_w"),
                mc_kernel.TableFactors(factors.values, "sqrt_w")):
        with pytest.raises(ValueError, match="take the factor 'w'"):
            mc_kernel.run_prefetch_table_chunk(state.clone(), ri, eng.consts,
                                               eng.spec, cands, bad)
        with pytest.raises(ValueError, match="take the factor 'w'"):
            mc_kernel.run_prefetch_probe(state.clone(), ri, eng.consts,
                                         eng.spec, "full", cands, None, bad)
    assert mc_kernel.run_prefetch_table_chunk.launches == before


@pytest.mark.parametrize("kind", ["opaque-lookup", "three-axes"])
def test_unblendable_table_runs_the_rows_entry(small_tables, kind):
    """A table the table entry cannot blend (a lookup without
    ``tab_params``, a table of three axes) has a route on the card: the
    engine stages the rows with the table's own lookup and launches K2's
    rows-in entry — no raise, no plain version — and the segment equals
    ``prefetch_table_reference`` bit for bit."""
    cfg = McSASConfig(num_contribs=64, num_reps=3, chunk_steps=60,
                      candidates_per_step=48, seed=5, local_moves=0.5,
                      max_iterations=48 * 150, max_retries=0, table_ff="on")
    eng = McSASEngine(load(DATA), suite.unblendable_cylinder(kind, **CYL_BIND),
                      cfg, device="cuda")
    assert eng.uses_table and eng.runs_cuda_kernel
    assert eng.prefetch_entry == "rows"
    assert mc_kernel.table_blend_refusal(eng.kern)
    with pytest.raises(ValueError, match="table"):
        mc_kernel.run_prefetch_table_chunk(
            eng._init_batch(), 0, eng.consts, eng.spec,
            eng._draw_chunk_proposals(4),
            torch.ones((4, 3, 48), device="cuda"))
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    gen_state = eng.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 9, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    ts, _ = mc_kernel.prefetch_table_reference(state.clone(), 9, eng.consts,
                                               eng.spec, cands)
    rows_in = mc_kernel.run_prefetch_chunk.launches
    table_in = mc_kernel.run_prefetch_table_chunk.launches
    eng.gen.set_state(gen_state)
    ks, ri = eng._segment(state.clone(), 9)
    torch.cuda.synchronize()
    assert mc_kernel.run_prefetch_chunk.launches == rows_in + 1
    assert mc_kernel.run_prefetch_table_chunk.launches == table_in
    assert ri == (9 + eng.seg_steps) % 64 and (ks.n_moves > 0).any()
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f
    res = eng.run()
    assert res.used_table and res.used_prefetch and res.used_pallas
    assert mc_kernel.run_prefetch_chunk.launches > rows_in + 1
    assert mc_kernel.run_prefetch_table_chunk.launches == table_in
    assert np.isfinite(res.conval).all()


def test_smeared_elementwise_fit_raises_on_the_card():
    """A smeared Sphere fit has no kernel: on the card the default
    'auto' raises, naming smearing and use_pallas='off', which runs the
    plain chunk there."""
    _needs_card()
    data = load(DATA, config=DataConfig(smearing=TrapezoidSmearing(
        do_smear=True, n_steps=4, umbra=0.05e9, penumbra=0.2e9)))
    cfg = McSASConfig(num_contribs=16, num_reps=2, chunk_steps=20,
                      candidates_per_step=4, max_iterations=4 * 40,
                      max_retries=0, seed=5)
    with pytest.raises(ValueError, match="smeared") as err:
        McSASEngine(data, get_model("Sphere").bind(), cfg, device="cuda")
    assert "use_pallas='off'" in str(err.value)
    k1 = mc_kernel.run_chunk.launches
    res = McSASEngine(data, get_model("Sphere").bind(),
                      cfg.replace(use_pallas="off"), device="cuda").run()
    assert mc_kernel.run_chunk.launches == k1 and not res.used_pallas
    assert np.isfinite(res.conval).all() and (res.n_moves > 0).all()


def test_table_engine_routes_to_the_prefetch_kernel(cylinder):
    """A table engine on the card launches K2 (and never K1); only
    use_pallas='off' runs the plain version there."""
    eng = cylinder["global"]
    k1 = mc_kernel.run_chunk.launches
    k2 = mc_kernel.run_prefetch_table_chunk.launches
    k2_rows = mc_kernel.run_prefetch_chunk.launches
    small = eng.cfg.replace(max_iterations=48 * 150, max_retries=0)
    res = McSASEngine(eng.data, eng.bound, small, device="cuda").run()
    assert res.used_table and res.used_prefetch and res.used_pallas
    # K2's table entry: the fit path stages no rows
    assert mc_kernel.run_prefetch_table_chunk.launches > k2
    assert mc_kernel.run_prefetch_chunk.launches == k2_rows
    assert mc_kernel.run_chunk.launches == k1
    off = McSASEngine(eng.data, eng.bound, small.replace(use_pallas="off"),
                      device="cuda")
    assert off.uses_table and not off.runs_cuda_kernel
    k2 = mc_kernel.run_prefetch_table_chunk.launches
    res = off.run()
    assert res.used_table and not res.used_prefetch and not res.used_pallas
    assert mc_kernel.run_prefetch_table_chunk.launches == k2
    assert mc_kernel.run_prefetch_chunk.launches == k2_rows


# ------------------------------- K2's table entry with a row factor

KHO = DATA.parent / "sasfit_kho-1-10-1000.dat"
_SLIT4 = dict(do_smear=True, n_steps=4, umbra=0.05e9, penumbra=0.2e9)


def _worm_engine(shape, mode, radius="active", smeared=False):
    """The Kholodenko worm on its table (at most 64 nodes an axis) at one
    of K2_SHAPES on the kho data rebinned to the shape's bins: the lookup
    multiplies the blend by the cross-section 2·j1_over_x(q·radius) of
    each candidate, the radius an active column or ('fixed') a fixed
    value.  *smeared*: a slit of 5 offsets, rows through rows in."""
    key = ("worm", shape, mode, radius, smeared)
    if key not in _ENGINES:
        reps, k, n_bin, n = K2_SHAPES[shape]
        cfg = McSASConfig(num_contribs=n, num_reps=reps, chunk_steps=60,
                          candidates_per_step=k, seed=5,
                          max_iterations=1_000_000, table_ff="on",
                          local_moves=0.5 if mode == "local" else 0.0)
        data = load(KHO, config=DataConfig(
            n_bin=n_bin, smearing=TrapezoidSmearing(**_SLIT4)
            if smeared else None))
        bound = (get_model("Kholodenko").bind() if radius == "active" else
                 get_model("Kholodenko").bind(
                     active=("lenKuhn", "lenContour"),
                     fixed={"radius": 2e-9}))
        _ENGINES[key] = McSASEngine(data, bound, cfg, device="cuda")
    return _ENGINES[key]


_XS_CASES = ([(shape, "active") for shape in sorted(K2_SHAPES)]
             + [("r3-k48-bins100", "fixed"), ("r2-k200-bins200", "fixed")])


@pytest.mark.parametrize("entry", ["rows", "table"])
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("shape,radius", _XS_CASES)
def test_cross_section_entry_equals_plain_version(small_tables, shape,
                                                  radius, mode, entry):
    """K2's table entry with the worm's cross-section of each point (and,
    for the same rows, its rows-in entry) against the plain versions over
    one segment: every decision and every bit of the state equal — the
    in-kernel j1_over_x rounds as PyTorch's float32 operations on the card
    do, at every ragged shape, with the radius active or fixed, on both
    corner sources (a step ahead, or from the table for K > 128 or
    Nq > 104)."""
    eng = _worm_engine(shape, mode, radius)
    assert eng.prefetch_entry == "table" and eng.runs_cuda_kernel
    assert eng.spec.factor_layout == ((1, 0, 0.0) if radius == "active"
                                      else (1, -1, 2e-9))
    state, ri, cands = _k2_segment(eng)
    ks, kt = state.clone(), {}
    _, ri_k = _run_k2_entry(eng, entry, ks, ri, cands, kt)
    ts, tt = state.clone(), {}
    _, ri_t = mc_kernel.prefetch_table_reference(ts, ri, eng.consts,
                                                 eng.spec, cands, trace=tt)
    torch.cuda.synchronize()
    assert ri_k == ri_t
    assert eng.seg_steps == 1 or (tt["choice"] >= 0).any()
    assert torch.equal(kt["choice"], tt["choice"])
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f
    got = mc_kernel.prefetch_launch_shape(state, eng.consts, eng.spec,
                                          cands)
    k, nq = eng.spec.k_cand, eng.consts.n
    assert got["source"] == ("table_ahead" if k <= 128 and nq <= 104
                             and nq % 4 == 0 else "table"), got


def test_cross_section_probe_full_rung_equals_the_kernel(small_tables):
    """K3's full rung with the factor is K2 bit for bit; its shorter
    rungs change no state and leave finite values."""
    eng = _worm_engine("r3-k48-bins100", "local")
    state, ri, cands = _k2_segment(eng)
    sw = mc_kernel.table_factors(eng.spec, cands)
    a, b = state.clone(), state.clone()
    _run_k2_entry(eng, "table", a, ri, cands)
    mc_kernel.run_prefetch_probe(b, ri, eng.consts, eng.spec, "full", cands,
                                 None, sw)
    torch.cuda.synchronize()
    assert (a.n_moves > 0).any()
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for level in mc_kernel.PREFETCH_PROBE_LEVELS[:-1]:
        c = state.clone()
        _, _, sink = mc_kernel.run_prefetch_probe(
            c, ri, eng.consts, eng.spec, level, cands, None, sw)
        torch.cuda.synchronize()
        assert torch.isfinite(sink).all(), level
        assert torch.equal(c.rset, state.rset) and torch.equal(
            c.conval, state.conval), level


@pytest.mark.parametrize("shape", ["r3-k48-bins100", "r2-k200-bins200"])
def test_smeared_worm_runs_the_rows_entry(small_tables, shape):
    """The smeared worm's lookup (the cross-section at each offset, then
    the contraction) declares no factor: its rows, Nq wide, are evaluated
    in blocks of steps of each repetition and go to K2's rows-in entry;
    the engine's segment equals prefetch_table_reference bit for bit."""
    eng = _worm_engine(shape, "local", smeared=True)
    assert eng.prefetch_entry == "rows" and eng.kern.table_is_intensity
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    gen_state = eng.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    ts, _ = mc_kernel.prefetch_table_reference(state.clone(), 0, eng.consts,
                                               eng.spec, cands)
    rows_in = mc_kernel.run_prefetch_chunk.launches
    table_in = mc_kernel.run_prefetch_table_chunk.launches
    eng.gen.set_state(gen_state)
    ks, _ = eng._segment(state.clone(), 0)
    torch.cuda.synchronize()
    assert mc_kernel.run_prefetch_chunk.launches == rows_in + 1
    assert mc_kernel.run_prefetch_table_chunk.launches == table_in
    assert (ks.n_moves > 0).any()
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f


@pytest.mark.parametrize("name", sorted(suite.TABLE_ROWS))
def test_table_rows_route_to_the_table_entry(small_tables, name):
    """Each table row's engine on the card launches K2's table entry only
    (never its rows entry, K1 or the plain chunk) over a short run."""
    row = suite.TABLE_ROWS[name]
    d = row.load()
    cfg = row.config(num_contribs=64, num_reps=3, max_iterations=128 * 150,
                     max_retries=0, table_ff="on")
    eng = McSASEngine(d, row.bound(d), cfg, device="cuda")
    assert eng.prefetch_entry == "table" and eng.runs_cuda_kernel
    counts = (mc_kernel.run_prefetch_table_chunk.launches,
              mc_kernel.run_prefetch_chunk.launches,
              mc_kernel.run_chunk.launches)
    res = eng.run()
    assert res.used_table and res.used_prefetch and res.used_pallas
    assert mc_kernel.run_prefetch_table_chunk.launches > counts[0]
    assert (mc_kernel.run_prefetch_chunk.launches,
            mc_kernel.run_chunk.launches) == counts[1:]
    assert np.isfinite(res.conval).all() and (res.n_moves > 0).all()


def test_three_axis_core_shell_ellipsoid_runs_the_rows_entry(small_tables,
                                                             monkeypatch):
    """EllipsoidalCoreShell with a, b and t active has three table axes:
    its segments go through K2's rows-in entry, bit for bit the plain
    version."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    d = suite.core_shell_ellipsoid_golden()
    cfg = McSASConfig(num_contribs=64, num_reps=3, chunk_steps=60,
                      candidates_per_step=48, seed=5, local_moves=0.5,
                      max_iterations=1_000_000, table_ff="on")
    eng = McSASEngine(d, get_model("EllipsoidalCoreShell").bind(
        active=("a", "b", "t")), cfg, device="cuda")
    assert eng.prefetch_entry == "rows" and len(eng.kern.table.axes) == 3
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    gen_state = eng.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    ts, _ = mc_kernel.prefetch_table_reference(state.clone(), 0, eng.consts,
                                               eng.spec, cands)
    eng.gen.set_state(gen_state)
    rows_in = mc_kernel.run_prefetch_chunk.launches
    ks, _ = eng._segment(state.clone(), 0)
    torch.cuda.synchronize()
    assert mc_kernel.run_prefetch_chunk.launches == rows_in + 1
    for f in ("rset", "ibank", "ft", "conval", "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f


# ------------------------------------- K1 of the other elementwise models

_ROW_OF = {"LMADenseSphere": "lma-dense-sphere",
           "GaussianChain": "gaussian-chain",
           "SphericalCoreShell": "core-shell-sphere"}


def _row_engine(name, shape):
    """An engine on the card for a suite row's model, data and active set
    at one of SHAPES (the row's local moves)."""
    from mcsas_tpu_torch.tools.suite import ROWS
    key = (name, shape)
    if key not in _ENGINES:
        reps, k, n_bin, n = SHAPES[shape]
        row = ROWS[_ROW_OF[name]]
        d = row.load()
        d = d.with_config(d.config.replace(n_bin=n_bin))
        cfg = row.config(num_contribs=n, num_reps=reps, chunk_steps=128,
                         candidates_per_step=k, max_iterations=1_000_000)
        _ENGINES[key] = McSASEngine(d, row.bound(d), cfg, device="cuda")
    return _ENGINES[key]


@pytest.fixture(scope="module")
def elementwise():
    """Engines on the card for each suite row's model, data and active
    set at a small shape: N=64, R=3, K=48, the row's local moves."""
    _needs_card()
    return {name: _row_engine(name, "r3-k48-bins100") for name in _ROW_OF}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["injected", "philox"])
@pytest.mark.parametrize("name", sorted(_ROW_OF))
def test_model_kernel_matches_plain_version(name, mode, shape):
    """K1 of each model against its plain version over 100 steps, on the
    engine's proposals or on the Philox stream (the plain version fed the
    host model of that stream): identical decisions until a near-tie
    (relative χ² gap ≤ 1e-6); where no flip occurs, the same state."""
    _needs_card()
    eng = _row_engine(name, shape)
    assert eng.runs_cuda_kernel and mc_kernel.supports(eng)
    reps = eng.cfg.num_reps
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    if mode == "injected":
        props = eng._draw_chunk_proposals(n_steps=100)
        kw = dict(proposals=props)
    else:
        props = torch.as_tensor(mc_kernel.philox_proposals(
            eng.spec, 31, reps, 100, device="cuda"), device="cuda")
        kw = dict(seed=31, n_steps=100)
    ks, kt = state.clone(), {}
    before = mc_kernel.run_chunk.model_launches.get(name, 0)
    mc_kernel.run_chunk(ks, 0, eng.consts, eng.spec, trace=kt, **kw)
    assert mc_kernel.run_chunk.model_launches[name] == before + 1
    ts, tt = state.clone(), {}
    mc_kernel.chunk_reference(ts, 0, eng.consts, eng.spec, props, trace=tt)
    torch.cuda.synchronize()
    assert (kt["choice"] >= 0).any()
    flips = _first_flips(kt, tt)
    for r in range(reps):
        if r in flips:
            continue
        np.testing.assert_array_equal(ks.rset[r].cpu(), ts.rset[r].cpu())
        np.testing.assert_array_equal(ks.conval[r].cpu(), ts.conval[r].cpu())
        np.testing.assert_array_equal(ks.ibank[r].cpu(), ts.ibank[r].cpu())
        assert int(ks.n_moves[r]) == int(ts.n_moves[r])


@pytest.mark.parametrize("name", ["Sphere"] + sorted(_ROW_OF))
def test_probe_full_rung_equals_the_kernel(elementwise, engine, name):
    """K3's full rung is K1 compiled again: bit for bit the same state
    on the same proposals; a shorter rung changes no state and leaves
    finite values."""
    eng = engine if name == "Sphere" else elementwise[name]
    eng.gen.manual_seed(4)
    state = eng._init_batch()
    props = eng._draw_chunk_proposals(n_steps=64)
    a, b = state.clone(), state.clone()
    mc_kernel.run_chunk(a, 0, eng.consts, eng.spec, proposals=props)
    before = mc_kernel.run_probe.launches
    _, ri, sink = mc_kernel.run_probe(b, 0, eng.consts, eng.spec, "full",
                                      proposals=props)
    assert mc_kernel.run_probe.launches == before + 1 and sink is None
    assert ri == 64 % eng.cfg.num_contribs
    torch.cuda.synchronize()
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    rungs = [(level, 0) for level in mc_kernel.PROBE_LEVELS[:-1]]
    rungs += [(level, g) for level in ("ff", "solve")
              for g in mc_kernel.PROBE_GROUPS]
    for level, group in rungs:
        c = state.clone()
        _, _, sink = mc_kernel.run_probe(c, 0, eng.consts, eng.spec, level,
                                         seed=5, n_steps=32, group=group)
        torch.cuda.synchronize()
        shape = mc_kernel.launch_shape(state, eng.consts, eng.spec, level,
                                       group)
        assert sink.shape == (eng.cfg.num_reps, shape["threads"])
        assert torch.isfinite(sink).all(), (level, group)
        assert torch.equal(c.rset, state.rset) and torch.equal(
            c.conval, state.conval), (level, group)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_launch_shape(shape):
    """K1 runs a group of 8-32 lanes per candidate, at most one group per
    candidate and 1024 threads, in whole warps."""
    _needs_card()
    for name in ["Sphere"] + sorted(_ROW_OF):
        eng = (_sphere_engine(shape) if name == "Sphere"
               else _row_engine(name, shape))
        state = eng._init_batch()
        got = mc_kernel.launch_shape(state, eng.consts, eng.spec)
        g, k = got["group"], eng.spec.k_cand
        assert g in mc_kernel.PROBE_GROUPS, got
        assert got["threads"] % 32 == 0 and got["threads"] <= 1024, got
        assert got["threads"] == -(-min(k, 1024 // g) * g // 32) * 32, got
        assert 0 < got["registers"] <= 65536 // got["threads"], got


def test_engines_route_each_model_to_the_kernel(elementwise):
    """Every K1 model's engine on the card launches K1 under the default
    use_pallas='auto', never K2 or the plain chunk; a float64 config
    raises there."""
    for name, eng in elementwise.items():
        k1 = mc_kernel.run_chunk.model_launches.get(name, 0)
        k2 = mc_kernel.run_prefetch_chunk.launches
        small = eng.cfg.replace(max_iterations=48 * 256, max_retries=0)
        res = McSASEngine(eng.data, eng.bound, small, device="cuda").run()
        assert res.used_pallas and not res.used_table, name
        assert mc_kernel.run_chunk.model_launches[name] > k1, name
        assert mc_kernel.run_prefetch_chunk.launches == k2, name
        with pytest.raises(ValueError, match="eligible"):
            McSASEngine(eng.data, eng.bound, small.replace(dtype="float64"),
                        device="cuda")


# ------------------------------------------------ the ψ-grid cylinders

_PSI_MODELS = ("CylindersIsotropicAspect", "CylindersRadiallyIsotropic")
_PSI_CASES = [("r3-k48-bins100", "1-axis"), ("r1-k8-bins5", "1-axis"),
              ("r3-k48-bins100", "2-axis"), ("r2-k200-bins200", "2-axis")]


@pytest.fixture
def psi_tables(small_tables, monkeypatch):
    """ψ tables of 32 nodes an axis with the interpolation probe bypassed
    (it declines such coarse spacings): K2 is held to its plain version
    on whatever table it reads."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "32")
    monkeypatch.setenv("MCSAS_TPU_TABLE_PROBE", "off")


def _psi_engine(model, shape, mode, axes):
    key = ("psi", model, shape, mode, axes)
    if key not in _ENGINES:
        reps, k, n_bin, n = K2_SHAPES[shape]
        cfg = McSASConfig(num_contribs=n, num_reps=reps, chunk_steps=60,
                          candidates_per_step=k, seed=5,
                          max_iterations=1_000_000, table_ff="on",
                          local_moves=0.5 if mode == "local" else 0.0)
        _ENGINES[key] = McSASEngine(
            load(DATA, config=DataConfig(n_bin=n_bin)),
            get_model(model).bind(**K2_AXES[axes]), cfg, device="cuda")
    return _ENGINES[key]


@pytest.mark.parametrize("entry", ["rows", "table"])
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("shape,axes", _PSI_CASES)
@pytest.mark.parametrize("model", _PSI_MODELS)
def test_psi_table_entries_equal_plain_versions(psi_tables, model, shape,
                                                axes, mode, entry):
    """Both entries of K2 on the ψ-grid cylinders' tables (radius, or
    radius and aspect) against their plain versions over one segment:
    every decision and every bit of the state equal."""
    eng = _psi_engine(model, shape, mode, axes)
    assert eng.prefetch_entry == "table" and eng.runs_cuda_kernel
    assert len(eng.spec.table_layout) == (1 if axes == "1-axis" else 2)
    state, ri, cands = _k2_segment(eng)
    ks, kt = state.clone(), {}
    _run_k2_entry(eng, entry, ks, ri, cands, kt)
    ts, tt = state.clone(), {}
    if entry == "table":
        mc_kernel.prefetch_table_reference(ts, ri, eng.consts, eng.spec,
                                           cands, trace=tt)
    else:
        mc_kernel.prefetch_reference(ts, ri, eng.consts, eng.spec,
                                     eng.kern.row(cands), cands, trace=tt)
    torch.cuda.synchronize()
    assert (tt["choice"] >= 0).any()
    assert torch.equal(kt["choice"], tt["choice"])
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f


@pytest.mark.parametrize("name", ["cylinders-aspect", "cylinders-radial"])
def test_psi_rows_route_to_the_table_entry(psi_tables, name):
    """The ψ rows' engines on the card launch K2's table entry only, at
    two table axes, over a short run."""
    row = suite.PSI_ROWS[name]
    d = row.load()
    cfg = row.config(num_contribs=64, num_reps=3, max_iterations=128 * 150,
                     max_retries=0, table_ff="on")
    eng = McSASEngine(d, row.bound(d), cfg, device="cuda")
    assert eng.prefetch_entry == "table" and eng.runs_cuda_kernel
    assert len(eng.spec.table_layout) == 2
    counts = (mc_kernel.run_prefetch_table_chunk.launches,
              mc_kernel.run_prefetch_chunk.launches,
              mc_kernel.run_chunk.launches)
    res = eng.run()
    assert res.used_table and res.used_prefetch and res.used_pallas
    assert mc_kernel.run_prefetch_table_chunk.launches > counts[0]
    assert (mc_kernel.run_prefetch_chunk.launches,
            mc_kernel.run_chunk.launches) == counts[1:]
    assert np.isfinite(res.conval).all() and (res.n_moves > 0).all()


def test_psi_three_axes_run_the_rows_entry(psi_tables, monkeypatch):
    """The radial model with radius, aspect and psiAngle active has three
    table axes: its segments go through K2's rows-in entry, bit for bit
    the plain version."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    row = suite.PSI_ROWS["cylinders-radial"]
    cfg = McSASConfig(num_contribs=64, num_reps=3, chunk_steps=60,
                      candidates_per_step=48, seed=5, local_moves=0.5,
                      max_iterations=1_000_000, table_ff="on")
    eng = McSASEngine(row.load(), get_model(row.model).bind(
        active=("radius", "aspect", "psiAngle"),
        active_ranges={"radius": (1e-9, 1e-8), "aspect": (1.0, 4.0)}),
        cfg, device="cuda")
    assert eng.prefetch_entry == "rows" and len(eng.kern.table.axes) == 3
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    gen_state = eng.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    ts, _ = mc_kernel.prefetch_table_reference(state.clone(), 0, eng.consts,
                                               eng.spec, cands)
    eng.gen.set_state(gen_state)
    rows_in = mc_kernel.run_prefetch_chunk.launches
    ks, _ = eng._segment(state.clone(), 0)
    torch.cuda.synchronize()
    assert mc_kernel.run_prefetch_chunk.launches == rows_in + 1
    for f in ("rset", "ibank", "ft", "conval", "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f


@pytest.mark.parametrize("name,active,ranges,reason", [
    ("CylindersIsotropicAspect", ("radius", "aspect"),
     {"radius": (0.5e-9, 3e-7), "aspect": (1.0, 20.0)}, "declined"),
    ("CylindersRadiallyIsotropic", ("radius", "psiAngle"),
     {"radius": (0.5e-9, 3e-7)}, "declined"),
    ("CylindersRadiallyIsotropicTilted", ("radius",),
     {"radius": (1.0, 20.0)}, "no device function")])
def test_psi_configs_without_a_kernel(small_tables, monkeypatch, name,
                                      active, ranges, reason):
    """A ψ table the probe declines (the wide default ranges) and the
    tilted model have no kernel: on the card use_pallas='auto' raises
    naming the reason and use_pallas='off', which runs the plain chunk
    and launches nothing."""
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    d = suite.PSI_ROWS["cylinders-radial"].load()
    bound = get_model(name).bind(active=active, active_ranges=ranges)
    cfg = McSASConfig(num_contribs=32, num_reps=2, chunk_steps=8,
                      candidates_per_step=16, max_iterations=16 * 16,
                      max_retries=0, table_ff="on", seed=3)
    with pytest.raises(ValueError, match=reason) as err:
        McSASEngine(d, bound, cfg, device="cuda")
    assert "use_pallas='off'" in str(err.value)
    counts = (mc_kernel.run_chunk.launches,
              mc_kernel.run_prefetch_chunk.launches,
              mc_kernel.run_prefetch_table_chunk.launches)
    res = McSASEngine(d, bound, cfg.replace(use_pallas="off"),
                      device="cuda").run()
    assert not (res.used_pallas or res.used_table)
    assert (mc_kernel.run_chunk.launches,
            mc_kernel.run_prefetch_chunk.launches,
            mc_kernel.run_prefetch_table_chunk.launches) == counts
    assert np.isfinite(res.conval).all()


def test_2d_fit_on_the_card(small_tables):
    """A 2D (q, ψ) fit has no kernel: use_pallas='auto' raises naming 2D;
    under 'off' the plain chunk runs and descends, and the card's float64
    post pass equals the CPU's to 1e-10 relative."""
    from mcsas_tpu_torch.post import histogram
    d = suite.cylinder_2d_golden(24, 16, rel_sigma=0.02)
    bound = get_model("CylindersRadiallyIsotropic").bind(
        active=("radius", "psiAngle"), active_ranges={"radius": (1e-9,
                                                                 2e-8)})
    cfg = McSASConfig(num_contribs=20, num_reps=2, max_iterations=1000,
                      chunk_steps=250, candidates_per_step=4, seed=9,
                      max_retries=0, show_incomplete=True)
    with pytest.raises(ValueError, match="2D") as err:
        McSASEngine(d, bound, cfg, device="cuda")
    assert "use_pallas='off'" in str(err.value)
    eng = McSASEngine(d, bound, cfg.replace(use_pallas="off"),
                      device="cuda")
    eng.gen.manual_seed(cfg.seed)
    chi0 = eng._init_batch().conval.cpu().numpy()
    res = eng.run()
    assert np.all(res.conval < chi0) and res.n_moves.min() > 0
    card = histogram._post_pass_f64(bound, d, cfg, res.contribs,
                                    device="cuda")
    cpu = histogram._post_pass_f64(bound, d, cfg, res.contribs,
                                   device="cpu")
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0.0)


def test_psi_bake_is_the_same_whatever_the_block(small_tables):
    """The ψ bake's rows on the card in blocks of 4, 8 and 12 rows (whole
    multiples of 4, as the factory's) and in one block of all 21, on 100,
    101 and 30 q points: bit for bit."""
    from mcsas_tpu_torch.models import cylinders
    for nq in (100, 101, 30):
        q32 = torch.tensor(np.geomspace(1e7, 1e9, nq), dtype=torch.float32,
                           device="cuda")

        def row_fn(vals):
            return cylinders._cyl_radial_ff(q32, dict(
                radius=vals[:, 0:1], psiAngle=vals[:, 1:2], aspect=10.0,
                psiAngleDivisions=3001.0))

        grids = [tables.log_grid(1e-9, 3e-8, 7),
                 tables.log_grid(0.01, 6.29, 3)]
        outs = [tables.build_param_table(row_fn, grids, block=b,
                                         device="cuda").values
                for b in (21, 4, 8, 12)]
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


# ------------------------------ run_files, plugin models and the post pass

def _counts():
    return (mc_kernel.run_chunk.launches,
            mc_kernel.run_prefetch_table_chunk.launches,
            mc_kernel.run_prefetch_chunk.launches)


def test_run_files_routes_sphere_to_k1_and_the_cylinder_to_k2(
        small_tables, tmp_path):
    """run_files on the card: the Sphere file's fit launches K1 and no
    K2, the cylinder golden's (written to a file, 64-row table) K2's
    table entry and no K1; both write their output sets."""
    from mcsas_tpu_torch.api import run_files
    from mcsas_tpu_torch.data import DataConfig
    from mcsas_tpu_torch.io import write_ascii
    cfg = McSASConfig(num_contribs=64, num_reps=3, chunk_steps=256,
                      candidates_per_step=48, seed=5, max_iterations=2048,
                      max_retries=0, show_incomplete=True)
    before = _counts()
    (res,) = run_files([str(DATA)], "Sphere", cfg, out_dir=tmp_path / "s",
                       device="cuda")
    after = _counts()
    assert after[0] > before[0] and after[1:] == before[1:]
    assert res.engine.used_pallas and os.path.exists(
        res.output_files["fit"])
    golden = suite.cylinder_golden()
    fn = tmp_path / "cylinder.dat"
    write_ascii(fn, golden.raw)
    (cres,) = run_files([str(fn)], suite.cylinder_bound(),
                        suite.cylinder_config(num_contribs=64, num_reps=3,
                                              max_iterations=128 * 200,
                                              max_retries=0, table_ff="on"),
                        out_dir=tmp_path / "c",
                        data_config=DataConfig(n_bin=0), device="cuda")
    final = _counts()
    assert final[1] > after[1] and (final[0], final[2]) == (after[0],
                                                            after[2])
    assert cres.engine.used_prefetch and os.path.exists(
        cres.output_files["fit"])


def _plugin(name="CardPlugin", factory=None):
    """A plugin model in torch: ff = (q·r)⁻², the volume of a sphere."""
    import math
    from mcsas_tpu_torch.models import ParamSpec, SASModel
    from mcsas_tpu_torch.utils.units import NM
    return SASModel(
        name=name, elementwise_q=factory is None, doc="card plugin",
        params=(ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                          active_range=NM.to_si((0.1, 100.0)),
                          generator="logdec1", is_fit=True),),
        default_active=("radius",),
        ff=lambda q, p: (q * p["radius"]) ** -2,
        volume=lambda p: 4.0 / 3.0 * math.pi * p["radius"] ** 3,
        ff_table_factory=factory)


def test_plugin_model_needs_use_pallas_off(small_tables):
    """An elementwise plugin has no device function of K1, even when
    registered under a built-in's name: under 'auto' the card runs it
    through K2's rows-in entry, its rows from the plugin's own ff, and
    launches no K1; under 'off' it fits through the plain chunk and
    launches no kernel."""
    from mcsas_tpu_torch import fit
    from mcsas_tpu_torch.models import REGISTRY, register_model
    plugin = _plugin("Sphere")
    saved = REGISTRY["Sphere"]
    register_model(plugin, overwrite=True)
    try:
        cfg = McSASConfig(num_contribs=32, num_reps=2, chunk_steps=64,
                          candidates_per_step=8, seed=5, max_iterations=256,
                          max_retries=0, show_incomplete=True)
        before = (_counts(), dict(mc_kernel.run_chunk.model_launches))
        res = fit(load(DATA), "Sphere", cfg, device="cuda")
        after = _counts()
        assert after[2] > before[0][2]
        assert (after[0], after[1]) == before[0][:2]
        assert mc_kernel.run_chunk.model_launches == before[1]
        eng = res.engine
        assert res.bound.model is plugin
        assert eng.used_pallas and eng.used_prefetch and not eng.used_table
        assert np.isfinite(eng.conval).all()
        before = (_counts(), dict(mc_kernel.run_chunk.model_launches))
        res = fit(load(DATA), "Sphere", cfg.replace(use_pallas="off"),
                  device="cuda")
        assert (_counts(), mc_kernel.run_chunk.model_launches) == before
        assert res.bound.model is plugin and not res.engine.used_pallas
        assert np.isfinite(res.engine.conval).all()
    finally:
        REGISTRY["Sphere"] = saved


def _plugin_engine(**kw):
    """A card engine of the Sphere's physics as a plugin (not the
    registry's Sphere object, so K1 cannot take it): K2's rows entry."""
    plugin = dataclasses.replace(get_model("Sphere"), name="SpherePlugin")
    cfg = McSASConfig(**dict(dict(num_contribs=64, num_reps=3,
                                  chunk_steps=128, candidates_per_step=48,
                                  local_moves=0.5, seed=5,
                                  max_iterations=1_000_000), **kw))
    eng = McSASEngine(load(DATA), plugin.bind(), cfg, device="cuda")
    assert eng.prefetch_entry == "rows" and eng.runs_prefetch
    assert eng.runs_cuda_kernel and not eng.uses_table
    return eng


@pytest.mark.parametrize("local", (0.0, 0.5))
def test_plugin_rows_entry_equals_plain_version(small_tables, local):
    """K2's rows-in entry on the rows of an elementwise plugin's ff (one
    engine segment) is bitwise equal to prefetch_reference on them."""
    eng = _plugin_engine(local_moves=local)
    eng.gen.manual_seed(3)
    state0 = eng._init_batch()
    cands = mc_kernel.segment_candidates(
        state0, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    rows = mc_kernel.segment_rows(eng.spec, cands)
    torch.testing.assert_close(rows, eng.kern.row(cands), rtol=0, atol=0)
    ks, kt, ts, tt = state0.clone(), {}, state0.clone(), {}
    before = mc_kernel.run_prefetch_chunk.launches
    mc_kernel.run_prefetch_chunk(ks, 0, eng.consts, eng.spec, rows, cands,
                                 trace=kt)
    mc_kernel.prefetch_reference(ts, 0, eng.consts, eng.spec, rows, cands,
                                 trace=tt)
    torch.cuda.synchronize()
    assert mc_kernel.run_prefetch_chunk.launches == before + 1
    assert torch.equal(kt["choice"], tt["choice"])
    for f in ("rset", "ibank", "ft", "scale", "background", "conval",
              "n_iter", "n_moves"):
        assert torch.equal(getattr(ks, f), getattr(ts, f)), f
    assert (ks.n_moves > 0).all()


def test_plugin_rep_mesh_equals_unsharded(small_tables):
    """A 2x1 repetition mesh of an elementwise plugin's fit launches K2's
    rows entry once a segment per shard and is bitwise equal to the
    unsharded fit."""
    from mcsas_tpu_torch import fit
    plugin = dataclasses.replace(get_model("Sphere"), name="SpherePlugin")
    cfg = McSASConfig(num_contribs=64, num_reps=4, chunk_steps=128,
                      candidates_per_step=32, local_moves=0.5, seed=9,
                      max_iterations=4 * 64 * 32, max_retries=0,
                      show_incomplete=True)
    n0 = mc_kernel.run_prefetch_chunk.launches
    base = fit(load(DATA), plugin, cfg, device="cuda")
    n1 = mc_kernel.run_prefetch_chunk.launches
    res = fit(load(DATA), plugin, cfg, mesh=_mesh((2, 1)))
    n2 = mc_kernel.run_prefetch_chunk.launches
    assert n1 > n0 and n2 - n1 == 2 * (n1 - n0)
    assert res.engine.used_prefetch and not res.engine.used_table
    for f in ("contribs", "conval", "n_iter", "n_moves", "scaling",
              "background", "measval"):
        np.testing.assert_array_equal(getattr(res.engine, f),
                                      getattr(base.engine, f), err_msg=f)


def test_compute_fractions_defaults_to_the_card(small_tables):
    """compute_fractions without a device evaluates its float64 bank on
    the card, as histogram_all does: the result of device='cuda'."""
    from mcsas_tpu_torch.post.histogram import compute_fractions
    d = load(DATA)
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(num_contribs=300, num_reps=10)
    contribs = np.random.default_rng(4).uniform(2e-9, 4e-8, (10, 300, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    frac = compute_fractions(contribs, d, bound, cfg)
    torch.cuda.synchronize()
    assert (torch.cuda.max_memory_allocated() - mem0
            >= contribs.size * d.count * 8)
    ref = compute_fractions(contribs, d, bound, cfg, device="cuda")
    np.testing.assert_array_equal(frac.measval, ref.measval)


def test_plugin_model_with_a_lookup_table_launches_k2(small_tables):
    """A plugin that bakes a table for tables.make_lookup runs through
    K2's table entry on the card under 'auto'."""
    from mcsas_tpu_torch import fit
    base = _plugin()

    def factory(bound, q_grid, dtype, device):
        q = torch.as_tensor(np.asarray(q_grid, np.float64), dtype=dtype,
                            device=device)
        grid = tables.log_grid(*bound.ranges[0], 64)
        tab = tables.build_param_table(
            lambda v: base.ff(q, {"radius": v[:, :1]}), [grid], dtype,
            device=device)
        return tables.make_lookup(("radius",)), tab

    model = _plugin(factory=factory)
    cfg = McSASConfig(num_contribs=32, num_reps=2, chunk_steps=64,
                      candidates_per_step=8, seed=5, max_iterations=1024,
                      max_retries=0, show_incomplete=True, table_ff="on")
    before = _counts()
    res = fit(load(DATA), model, cfg, device="cuda")
    after = _counts()
    assert after[1] > before[1] and (after[0], after[2]) == (before[0],
                                                             before[2])
    assert res.engine.used_prefetch and np.isfinite(res.engine.conval).all()


def test_histogram_all_defaults_to_the_card(small_tables):
    """histogram_all without a device evaluates its float64 bank on the
    card: the same result as device='cuda', device memory allocated."""
    from mcsas_tpu_torch.post.histogram import histogram_all
    d = load(DATA)
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(num_contribs=300, num_reps=10)
    contribs = np.random.default_rng(3).uniform(2e-9, 4e-8, (10, 300, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    frac, hists = histogram_all(contribs, d, bound, cfg)
    torch.cuda.synchronize()
    bank_bytes = contribs.size * d.count * 8
    assert torch.cuda.max_memory_allocated() - mem0 >= bank_bytes
    frac_c, hists_c = histogram_all(contribs, d, bound, cfg, device="cuda")
    np.testing.assert_array_equal(frac.measval, frac_c.measval)
    np.testing.assert_array_equal(hists[0].bins.full, hists_c[0].bins.full)


# ----------------------------------------------- the sharded ensemble

def _mesh(shape):
    from mcsas_tpu_torch.parallel import make_mesh
    return make_mesh(shape, [torch.device("cuda", 0)] * (shape[0]
                                                          * shape[1]))


def test_k1_rep_base_draws_the_whole_ensembles_stream():
    """K1 on a slice of the repetitions with rep_base draws what the
    launch on all of them draws for them: the states are bitwise equal."""
    _needs_card()
    eng = McSASEngine(load(DATA), get_model("Sphere").bind(),
                      McSASConfig(num_contribs=64, num_reps=5,
                                  candidates_per_step=48, local_moves=0.5,
                                  seed=3), device="cuda")
    eng.gen.manual_seed(3)
    whole = eng._init_batch()
    parts = [dataclasses.replace(whole, **{
        f.name: getattr(whole, f.name)[a:b].clone()
        for f in dataclasses.fields(whole)}) for a, b in ((0, 2), (2, 5))]
    mc_kernel.run_chunk(whole, 0, eng.consts, eng.spec, seed=99,
                        n_steps=200)
    for part, base in zip(parts, (0, 2)):
        mc_kernel.run_chunk(part, 0, eng.consts, eng.spec, seed=99,
                            n_steps=200, rep_base=base)
    for f in dataclasses.fields(whole):
        joined = torch.cat([getattr(p, f.name) for p in parts])
        assert torch.equal(joined, getattr(whole, f.name)), f.name


@pytest.mark.parametrize("shape", [(2, 1), (3, 1)])
def test_sharded_sphere_fit_is_bitwise_on_one_card(shape):
    """Repetition shards of cuda:0, each on its own stream: K1 once a
    chunk per shard, the contributions of the unsharded engine."""
    _needs_card()
    from mcsas_tpu_torch.parallel import ShardedEnsemble
    d = load(DATA)
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(num_contribs=64, num_reps=5, candidates_per_step=48,
                      local_moves=0.5, chunk_steps=256, seed=4,
                      max_iterations=200_000, max_retries=1)
    mc_kernel.run_chunk.launches = 0
    base = McSASEngine(d, bound, cfg, device="cuda").run()
    n_base = mc_kernel.run_chunk.launches
    se = ShardedEnsemble(d, bound, cfg, mesh=_mesh(shape))
    assert se.runs_cuda_kernel and all(sh.stream is not None
                                       for sh in se.shards)
    mc_kernel.run_chunk.launches = 0
    res = se.run()
    assert mc_kernel.run_chunk.launches == shape[0] * n_base
    for f in ("contribs", "conval", "n_iter", "n_moves", "scaling",
              "background", "measval", "attempts"):
        np.testing.assert_array_equal(getattr(res, f), getattr(base, f),
                                      err_msg=f)
    assert res.total_iters == base.total_iters


def test_sharded_table_fit_is_bitwise_on_one_card(small_tables):
    """The table tier on two shards: K2's table entry once a segment per
    shard on the parent's segment length, bitwise the unsharded fit."""
    _needs_card()
    from mcsas_tpu_torch.parallel import ShardedEnsemble
    d = load(DATA)
    bound = get_model("CylindersIsotropic").bind(**CYL_BIND)
    cfg = McSASConfig(num_contribs=40, num_reps=4, candidates_per_step=32,
                      local_moves=0.5, chunk_steps=64, seed=6,
                      max_iterations=100_000, max_retries=0,
                      table_ff="on", show_incomplete=True)
    mc_kernel.run_prefetch_table_chunk.launches = 0
    base = McSASEngine(d, bound, cfg, device="cuda").run()
    n_base = mc_kernel.run_prefetch_table_chunk.launches
    mc_kernel.run_prefetch_table_chunk.launches = 0
    res = ShardedEnsemble(d, bound, cfg, mesh=_mesh((2, 1))).run()
    # the shards run the serial order's segments; the unsharded engine's
    # lookahead may launch one more, spent on a finished ensemble
    assert mc_kernel.run_prefetch_table_chunk.launches == 2 * base.n_chunks
    assert n_base - base.n_chunks in (0, 1)
    np.testing.assert_array_equal(res.contribs, base.contribs)
    np.testing.assert_array_equal(res.conval, base.conval)


def test_q_axis_on_the_card_needs_the_plain_chunk():
    _needs_card()
    from mcsas_tpu_torch.parallel import ShardedEnsemble
    d = load(DATA)
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(num_contribs=30, num_reps=2, candidates_per_step=8,
                      chunk_steps=50, max_iterations=400, max_retries=0,
                      show_incomplete=True)
    with pytest.raises(ValueError, match="q axis"):
        ShardedEnsemble(d, bound, cfg, mesh=_mesh((1, 2)))
    mc_kernel.run_chunk.launches = 0
    res = ShardedEnsemble(d, bound, cfg.replace(use_pallas="off"),
                          mesh=_mesh((1, 2))).run()
    assert mc_kernel.run_chunk.launches == 0
    assert np.isfinite(res.conval).all() and (res.n_moves > 0).all()


# ------------------------------------------------------------- prewarm

@pytest.mark.parametrize("model,lib", [("Sphere", "mc_chunk"),
                                       ("CylindersIsotropic",
                                        "mc_prefetch")])
def test_prewarm_loads_the_library_and_keeps_the_fit(small_tables, model,
                                                     lib):
    """prewarm() on the card returns a load entry for the library of the
    engine's kernel (K1 for Sphere, K2 for the cylinder; the cylinder's
    post pass launches the bank kernel, so its library beside K2's) with
    every entry a time, and the fit after it is bitwise the fit without
    one."""
    from mcsas_tpu_torch import api, fit
    d = load(DATA)
    bound = (get_model("Sphere").bind() if model == "Sphere"
             else get_model(model).bind(**CYL_BIND))
    cfg = McSASConfig(num_contribs=40, num_reps=4, candidates_per_step=32,
                      local_moves=0.5, chunk_steps=64, seed=6,
                      max_iterations=100_000, max_retries=0,
                      table_ff="on", show_incomplete=True)
    plain = McSASEngine(d, bound, cfg, device="cuda").run()
    eng = McSASEngine(d, bound, cfg, device="cuda")
    out = eng.prewarm()
    libs = [lib] + (["cyl_bank"] if model != "Sphere" else [])
    assert list(out) == ([f"nvcc {n}" for n in libs]
                         + [f"load {n}" for n in libs]
                         + ["init", f"attributes {lib}"])
    assert all(isinstance(v, float) and v >= 0.0 for v in out.values())
    after = eng.run()
    for f in ("contribs", "conval", "n_iter", "n_moves", "scaling",
              "background"):
        np.testing.assert_array_equal(getattr(after, f),
                                      getattr(plain, f), err_msg=f)
    api._ENGINE_CACHE.clear()
    res = fit(d, bound, cfg, device="cuda", prewarm=True)
    np.testing.assert_array_equal(res.engine.contribs, plain.contribs)


def test_rep_scaling_row_at_132_launches_k1():
    """One row of the scaling tool at R = 132 (one K1 block on each SM
    of an H100): K1 launched, every value of the row from one run."""
    _needs_card()
    from mcsas_tpu_torch.tools import rep_scaling
    row = rep_scaling.measure("sphere", 132, 300, "card")
    assert row["kernel"] == "mc_chunk" and row["launches"] > 0
    assert row["reps"] == 132 and row["total_proposals"] > 0
    assert row["proposals_per_sec"] == pytest.approx(
        row["total_proposals"] / row["wall_s"])


def test_k2_launch_calls_lie_inside_the_launch_spans():
    """A cylinder fit through K2's table entry under torch.profiler and
    ``profiling.recording()``: the host-side launch call of every K2
    kernel (the runtime event of its correlation id) lies inside an
    ``ops.mc_kernel.launch`` span, compared on one clock with no offset;
    one launch a segment issued (``n_chunks`` and the spent one) and one
    χ² read a segment of the serial order."""
    _needs_card()
    from torch.profiler import ProfilerActivity, profile
    from mcsas_tpu_torch import api
    from mcsas_tpu_torch.utils import profiling
    golden, bound = suite.cylinder_golden(), suite.cylinder_bound()
    cfg = suite.cylinder_config(table_ff="on", max_retries=0)
    api.fit(golden, bound, cfg, device="cuda")   # the build and the bake
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            res = api.fit(golden, bound, cfg, device="cuda")
        torch.cuda.synchronize()
    assert res.engine.used_prefetch
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [ev for ev in events if ev.device_type() == cuda
               and "mc_prefetch" in ev.name()]
    host = {}
    for ev in events:
        if ev.device_type() != cuda and "Launch" in ev.name():
            host[ev.correlation_id()] = ev
    calls = [host.get(ev.correlation_id())
             or host.get(ev.linked_correlation_id()) for ev in kernels]
    issued = res.engine.n_chunks + rec.counters.get(
        "core.engine.lookahead.spent", 0)
    assert len(kernels) == issued and None not in calls
    spans = [(s, e) for name, s, e, _, _ in rec.spans
             if name == "ops.mc_kernel.launch"]
    assert len(spans) == issued
    for ev in calls:
        assert any(s <= ev.start_ns() and ev.end_ns() <= e
                   for s, e in spans), (ev.name(), ev.start_ns())
    reads = [s for s in rec.spans if s[0] == "core.engine.read"]
    assert len(reads) == res.engine.n_chunks


# ------------------------------------------ the post pass's cylinder bank

def _bank_case(name):
    """(binding, data, contributions) of the bank kernel's card tests:
    the benchmark's cylinder cells (300 × 10 contributions over radius
    0.5-300 nm, aspect 10, intDiv 100, the 100-point grid, unsmeared and
    through the 25-step trapezoid slit), useAspect 0 with the length
    active, intDiv 801 and 3, and contributions that reach qR < 1e-6 (the
    limit branch of j1_over_x and sinc_sin's series)."""
    model = get_model("CylindersIsotropic")
    radii = {"radius": (0.5e-9, 300e-9)}
    d = suite.cylinder_golden()
    if name == "useAspect-0":
        bound = model.bind(active=("radius", "length"),
                           active_ranges=dict(radii, length=(1e-9, 2e-6)),
                           fixed={"useAspect": 0.0})
    elif name == "qR-limit":
        bound = model.bind(active=("radius",),
                           active_ranges={"radius": (1e-10, 1e-8)})
        q = np.geomspace(1e-6, 2.0, 100)
        i = 1.0 / (1.0 + q)
        d = from_raw(np.column_stack([q, i, 0.01 * i]),
                     config=DataConfig(n_bin=0))
    else:
        div = {"intDiv-801": 801.0, "intDiv-3": 3.0}.get(name, 100.0)
        bound = model.bind(active=("radius",), active_ranges=radii,
                           fixed={"aspect": 10.0, "intDiv": div})
        if name == "slit":
            d = suite.cylinder_smeared_golden()
    rs = np.random.default_rng(17)
    lo, hi = np.log(np.asarray(bound.ranges)).T
    c = np.exp(rs.uniform(lo, hi, (10, 300, len(lo))))
    if name == "qR-limit":
        c[0, 0, 0] = 1e-10
    return bound, d, c


@pytest.mark.parametrize("name", ["unsmeared", "slit", "useAspect-0",
                                  "intDiv-801", "intDiv-3", "qR-limit"])
def test_cyl_bank_matches_the_eager_bank(name, monkeypatch):
    """The bank kernel (one launch a post pass) against its plain
    version, the eager bank on the CPU: the bank and every output of the
    float64 post pass to 1e-10 relative (float64 on both sides; the sum's
    order and the math library's last bit differ)."""
    _needs_card()
    from mcsas_tpu_torch.ops import cyl_bank
    from mcsas_tpu_torch.post import histogram
    bound, d, c = _bank_case(name)
    cfg = McSASConfig(num_contribs=c.shape[1], num_reps=c.shape[0])
    comp2 = 2.0 * cfg.compensation_exponent
    inp = cyl_bank.bank_inputs(bound, d, comp2,
                               torch.as_tensor(c, device="cuda"))
    if name == "qR-limit":
        a = inp.grid[None] * inp.radius[:, None, None]
        assert float(a.abs().min()) < 1e-6
    shape = cyl_bank.launch_shape(inp)
    pairs = inp.x.numel() * inp.grid.shape[1]
    assert shape["group"] == (32 if pairs >= 256 else 8)
    assert shape["blocks"] == -(-c.shape[0] * c.shape[1] * d.count
                                // (256 // shape["group"]))
    banks = {}
    real = histogram._bank_f64

    def keep(bound, data, comp2, rset, block=None):
        out = real(bound, data, comp2, rset, block)
        banks[rset.device.type] = out.cpu().numpy()
        return out

    monkeypatch.setattr(histogram, "_bank_f64", keep)
    before = cyl_bank.run_cyl_bank.launches
    card = histogram._post_pass_f64(bound, d, cfg, c, device="cuda")
    assert cyl_bank.run_cyl_bank.launches == before + 1
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        cpu = histogram._post_pass_f64(bound, d, cfg, c, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert cyl_bank.run_cyl_bank.launches == before + 1
    assert np.isfinite(banks["cpu"]).all() and (banks["cpu"] > 0).all()
    np.testing.assert_allclose(banks["cuda"], banks["cpu"], rtol=1e-10,
                               atol=0.0)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0.0)


def test_cyl_bank_launches_once_a_cylinder_post_pass(small_tables):
    """fit() on the card: the bank kernel launches once in each cylinder
    fit's post pass (unsmeared and slit-smeared; once more for a
    prewarm's post pass) and never in a Sphere fit."""
    from mcsas_tpu_torch import api, fit
    from mcsas_tpu_torch.ops import cyl_bank
    api._ENGINE_CACHE.clear()
    cfg = McSASConfig(num_contribs=40, num_reps=3, candidates_per_step=32,
                      chunk_steps=64, seed=6, max_iterations=20_000,
                      max_retries=0, show_incomplete=True)
    n0 = cyl_bank.run_cyl_bank.launches
    fit(load(DATA), get_model("Sphere").bind(), cfg, device="cuda",
        prewarm=True)
    assert cyl_bank.run_cyl_bank.launches == n0
    bound = suite.cylinder_bound()
    for golden in (suite.cylinder_golden(), suite.cylinder_smeared_golden()):
        n0 = cyl_bank.run_cyl_bank.launches
        fit(golden, bound, cfg.replace(table_ff="on"), device="cuda",
            prewarm=True)
        assert cyl_bank.run_cyl_bank.launches == n0 + 2
        fit(golden, bound, cfg.replace(table_ff="on"), device="cuda")
        assert cyl_bank.run_cyl_bank.launches == n0 + 3


def _frame_on_the_grid(d):
    """Another frame of dataset *d* on its grid (and its slit's offsets):
    the intensities times 1 + 0.3 (q / q_max)^1.5."""
    raw = np.array(d.raw, np.float64)
    raw[:, 1] *= 1.0 + 0.3 * (raw[:, 0] / raw[:, 0].max()) ** 1.5
    out = from_raw(raw, title="another frame", config=d.config)
    np.testing.assert_array_equal(out.q, d.q)
    if d.locs is not None:
        np.testing.assert_array_equal(out.locs, d.locs)
    return out


@pytest.mark.parametrize("kind", ["worm", "slit"])
def test_probe_memo_keeps_engines_and_fits_bitwise(small_tables,
                                                   monkeypatch, kind):
    """A worm engine and a slit-smeared cylinder engine built on the card
    on a warm memo of the magnitude probe (another frame on the same grid
    probed first) have the inv_i_ref and w_ref of engines built after the
    memo is cleared, and their fits are the same bits."""
    from mcsas_tpu_torch import api, fit
    from mcsas_tpu_torch.core import engine as engine_mod
    from mcsas_tpu_torch.utils.profiling import recording
    if kind == "worm":
        first = load(DATA.parent / "sasfit_kho-1-10-1000.dat")
        bound = get_model("Kholodenko").bind()
    else:
        first, bound = suite.cylinder_smeared_golden(), suite.cylinder_bound()
    frame = _frame_on_the_grid(first)
    cfg = McSASConfig(num_contribs=40, num_reps=3, candidates_per_step=32,
                      chunk_steps=64, seed=6, max_iterations=20_000,
                      max_retries=0, show_incomplete=True, table_ff="on")
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})

    def fit_on_a_new_engine():
        api._ENGINE_CACHE.clear()
        with recording() as rec:
            res = fit(frame, bound, cfg, device="cuda")
        (eng,) = api._ENGINE_CACHE.values()
        assert eng.runs_prefetch
        memo = {k: v for k, v in rec.counters.items()
                if k.startswith("core.engine.probe_memo.")}
        return res, eng, memo

    monkeypatch.setattr(engine_mod, "_PROBE_MEMO", {})
    McSASEngine(first, bound, cfg, device="cuda")
    warm, warm_eng, memo = fit_on_a_new_engine()
    assert memo == {"core.engine.probe_memo.hit": 1}
    engine_mod._PROBE_MEMO.clear()
    cold, cold_eng, memo = fit_on_a_new_engine()
    assert memo == {"core.engine.probe_memo.miss": 1}
    assert warm_eng is not cold_eng
    assert warm_eng.kern.inv_i_ref == cold_eng.kern.inv_i_ref
    assert warm_eng.kern.w_ref == cold_eng.kern.w_ref == cold.engine.w_ref
    for f in dataclasses.fields(cold.engine):
        if f.name in ("elapsed", "iters_per_sec", "moves_per_sec"):
            continue
        np.testing.assert_array_equal(getattr(warm.engine, f.name),
                                      getattr(cold.engine, f.name), f.name)
    np.testing.assert_array_equal(warm.fractions.measval,
                                  cold.fractions.measval)
    np.testing.assert_array_equal(warm.fractions.fraction["vol"],
                                  cold.fractions.fraction["vol"])
    for a, b in zip(warm.histograms, cold.histograms):
        np.testing.assert_array_equal(a.bins.full, b.bins.full)


# ------------------------------------ the engine's one-segment lookahead

_LOOKAHEAD = tuple(f"core.engine.lookahead.{k}"
                   for k in ("ahead", "held", "spent"))
_RESULT_FIELDS = ("contribs", "conval", "n_iter", "n_moves", "attempts",
                  "scaling", "background", "measval", "n_chunks",
                  "rep_chunks", "retried_iters")


def _lookahead_engine(kind):
    """The suite's cylinder row on K2's one-axis table and its worm row
    on the two-axis table with the cross-section, full-size tables."""
    if kind == "cylinder":
        return McSASEngine(suite.cylinder_golden(), suite.cylinder_bound(),
                           suite.cylinder_config(), device="cuda")
    row = suite.TABLE_ROWS["kholodenko-worm"]
    d = row.load()
    return McSASEngine(d, row.bound(d), row.config(), device="cuda")


def _assert_ahead_but_two(res, counters):
    """Every segment but the first two of a fit without retries went
    ahead of the read before it."""
    ahead, held, _ = (counters.get(k, 0) for k in _LOOKAHEAD)
    assert (res.attempts == 1).all()
    assert ahead > 0 and held == 2     # ahead: all segments issued but two


@pytest.mark.parametrize("kind", ["cylinder", "worm"])
def test_lookahead_fit_equals_serial_order(kind, monkeypatch):
    """A fit through K2's table entry with segment n+1 issued before read
    n equals the same fit in series (the hold-back predicate made to hold
    always) in every field of the result, bit for bit."""
    from mcsas_tpu_torch.utils import profiling
    _needs_card()
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    eng = _lookahead_engine(kind)
    assert eng.runs_cuda_kernel and eng.prefetch_entry == "table"
    with profiling.recording() as rec:
        res = eng.run()
    monkeypatch.setattr(eng, "_may_issue_ahead", lambda *a: False)
    with profiling.recording() as serial:
        ref = eng.run()
    for name in _RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name),
                                      name)
    assert res.converged.all() and res.used_prefetch
    _assert_ahead_but_two(res, rec.counters)
    assert serial.counters[_LOOKAHEAD[1]] == ref.n_chunks
    assert _LOOKAHEAD[0] not in serial.counters


@pytest.mark.parametrize("kind", ["cylinder", "worm"])
def test_lookahead_issues_without_a_sync(kind, monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode('error')`` a whole fit
    raises nothing but where it is let wait: the event of each read, a
    retry's mask and the result's final copy.  So drawing a segment, its
    candidates and factors, the checks, the launch, the copy of its read
    and the ft kept for a spent segment wait for nothing on the card, and
    segment n+1 is issued while segment n runs."""
    from mcsas_tpu_torch.core.engine import _HostReads
    from mcsas_tpu_torch.utils import profiling
    _needs_card()
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    eng = _lookahead_engine(kind)
    eng.run()       # builds and loads K2's library, fills the spec's caches

    def let_wait(fn):
        def inner(*a, **kw):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return inner
    monkeypatch.setattr(_HostReads, "take",
                        staticmethod(let_wait(_HostReads.take)))
    monkeypatch.setattr(eng, "_retry", let_wait(eng._retry))
    monkeypatch.setattr(eng, "_host_state", let_wait(eng._host_state))
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.tensor([1.0], device="cuda")   # the mode does catch one
        with profiling.recording() as rec:
            res = eng.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.converged.all() and res.used_prefetch
    _assert_ahead_but_two(res, rec.counters)
