# -*- coding: utf-8 -*-
"""PyTorch port on the card: the CUDA chunk kernels K1 (mc_chunk, every
model with a device function) and K2 (mc_prefetch) against their plain
PyTorch versions, the latency probe K3 (mc_probe) against K1, and the
engine's routing to them.  Marked ``cuda``; every test skips without a
CUDA device (decided inside the fixture).  On a machine with a card and
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch import load  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.data import DataConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel  # noqa: E402

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
def cylinder():
    """Table engines on the card (64-row tables), without and with local
    moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield {"global": _cylinder_engine(),
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


def test_prefetch_kernel_refuses_bad_input(cylinder):
    eng = cylinder["global"]
    state = eng._init_batch()
    cands = eng._draw_chunk_proposals(8)
    rows = eng.kern.row(cands)
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


def test_table_engine_routes_to_the_prefetch_kernel(cylinder):
    """A table engine on the card launches K2 (and never K1); only
    use_pallas='off' runs the plain version there."""
    eng = cylinder["global"]
    k1 = mc_kernel.run_chunk.launches
    k2 = mc_kernel.run_prefetch_chunk.launches
    small = eng.cfg.replace(max_iterations=48 * 150, max_retries=0)
    res = McSASEngine(eng.data, eng.bound, small, device="cuda").run()
    assert res.used_table and res.used_prefetch and res.used_pallas
    assert mc_kernel.run_prefetch_chunk.launches > k2
    assert mc_kernel.run_chunk.launches == k1
    off = McSASEngine(eng.data, eng.bound, small.replace(use_pallas="off"),
                      device="cuda")
    assert off.uses_table and not off.runs_cuda_kernel
    k2 = mc_kernel.run_prefetch_chunk.launches
    res = off.run()
    assert res.used_table and not res.used_prefetch and not res.used_pallas
    assert mc_kernel.run_prefetch_chunk.launches == k2


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
