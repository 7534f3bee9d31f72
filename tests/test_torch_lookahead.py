# -*- coding: utf-8 -*-
"""PyTorch port: the engine's one-segment lookahead (``McSASEngine._run``
issues segment n+1 before it waits for read n where
``_may_issue_ahead`` allows it) against the serial order, which the same
engine runs when that predicate always holds back.  On the CPU nothing
overlaps, but the loop, the generator's call order, ``stop``,
``progress``, the spent segment's ft and the counters are the card's.
The segments run K2's plain version; nothing is mocked but the
predicate.  Tables are baked at 256 rows for the cylinder (a coarser
table stalls its fit) and at 16 nodes an axis for the worm
(MCSAS_TPU_TABLE_RES_CAP)."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch import load  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.data import DataConfig  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.parallel import ShardedEnsemble, make_mesh  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402
from mcsas_tpu_torch.utils import profiling  # noqa: E402

TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
FIELDS = ("contribs", "conval", "n_iter", "n_moves", "attempts", "scaling",
          "background", "measval", "n_chunks", "rep_chunks", "retried_iters")
AHEAD, HELD, SPENT = (f"core.engine.lookahead.{k}"
                      for k in ("ahead", "held", "spent"))
# a segment's proposals at _engine's table sizes: 12 steps of 16
SEGMENT_PROPOSALS = 12 * 16
_DATA = {}


@pytest.fixture(scope="module", autouse=True)
def no_table_cache():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield


def _engine(kind, monkeypatch, mesh=None, **kw):
    """A small engine on the CPU: 'cylinder' (the table entry's one-axis
    amplitude table on the cylinder golden; χ² ≤ 16, which 24
    contributions reach in about a hundred segments, each repetition at
    its own), 'worm' (the worm's two-axis table with its cross-section,
    three parameters, local moves) or 'sphere' (no table: the plain
    chunk of K1's route)."""
    cfg = dict(num_contribs=24, num_reps=3, candidates_per_step=16,
               chunk_steps=12, seed=3, max_retries=0,
               max_iterations=1_000_000)
    if kind == "cylinder":
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "256")
        cfg.update(table_ff="on", convergence_criterion=16.0)
        if kind not in _DATA:
            _DATA[kind] = suite.cylinder_golden()
        bound = suite.cylinder_bound()
    elif kind == "worm":
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
        cfg.update(table_ff="on", local_moves=0.5)
        if kind not in _DATA:
            _DATA[kind] = load(TESTDATA / "sasfit_kho-1-10-1000.dat",
                               config=DataConfig(n_bin=40))
        bound = get_model("Kholodenko").bind()
    else:
        cfg.update(local_moves=0.5, candidates_per_step=8)
        if kind not in _DATA:
            _DATA[kind] = load(TESTDATA / "sasfit_sphere-10-1.dat")
        bound = get_model("Sphere").bind()
    cfg.update(kw)
    config = McSASConfig(**cfg)
    if mesh is not None:
        return ShardedEnsemble(_DATA[kind], bound, config, mesh=mesh)
    return McSASEngine(_DATA[kind], bound, config, device="cpu")


def _run(eng, serial=False, **kw):
    """(result, counters) of one run; *serial* holds every segment back
    until the read before it."""
    if serial:
        eng._may_issue_ahead = lambda *a: False
    try:
        with profiling.recording() as rec:
            res = eng.run(**kw)
    finally:
        eng.__dict__.pop("_may_issue_ahead", None)
    return res, dict(rec.counters)


def _assert_same(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert np.array_equal(x, y), name


def _issued(counters):
    return counters.get(AHEAD, 0) + counters.get(HELD, 0)


@pytest.mark.parametrize("kind", ["cylinder", "worm"])
def test_lookahead_equals_serial_order(kind, monkeypatch):
    """A fit to convergence: every field of the result bit for bit the
    serial order's; all but the first two segments go ahead (no retry
    here), and the segment issued ahead of the last read is spent."""
    eng = _engine(kind, monkeypatch)
    assert eng.runs_prefetch and eng.prefetch_entry == "table"
    res, cnt = _run(eng)
    ref, ref_cnt = _run(eng, serial=True)
    _assert_same(res, ref)
    assert res.converged.all() and res.n_chunks > 10
    assert cnt[HELD] == 2 and cnt[SPENT] == 1
    assert _issued(cnt) == res.n_chunks + 1
    assert AHEAD not in ref_cnt and ref_cnt[HELD] == ref.n_chunks


@pytest.mark.parametrize("kind", ["cylinder", "worm"])
def test_retries_keep_the_serial_order(kind, monkeypatch):
    """max_iterations of six segments' proposals: repetitions exhaust and
    restart, twice; the segments next to each retry are held back, the
    rest go ahead, and the result is the serial order's bit for bit."""
    eng = _engine(kind, monkeypatch, max_retries=1,
                  max_iterations=6 * SEGMENT_PROPOSALS)
    assert eng.seg_steps * eng.cfg.candidates_per_step == SEGMENT_PROPOSALS
    res, cnt = _run(eng)
    ref, _ = _run(eng, serial=True)
    _assert_same(res, ref)
    assert res.retried_iters > 0 and (res.attempts > 1).any()
    assert cnt["core.engine.retried_reps"] > 0
    assert cnt[AHEAD] > 0 and cnt[HELD] > 2
    assert _issued(cnt) == res.n_chunks + cnt.get(SPENT, 0)


def _stop_on_call(k):
    calls = []

    def stop():
        calls.append(1)
        return len(calls) >= k
    return stop, calls


@pytest.mark.parametrize("k", [1, 3, 40])
def test_stop_ends_after_the_serial_segment(k, monkeypatch):
    """A stop that is true from its k-th call on ends the run after the
    segment the serial order ends it after, with the same result, having
    been called as often; no segment is issued past it."""
    eng = _engine("cylinder", monkeypatch)
    stop, calls = _stop_on_call(k)
    res, cnt = _run(eng, stop=stop)
    ref_stop, ref_calls = _stop_on_call(k)
    ref, _ = _run(eng, serial=True, stop=ref_stop)
    _assert_same(res, ref)
    assert res.n_chunks == k == len(calls) == len(ref_calls)
    assert _issued(cnt) == k and SPENT not in cnt
    if k > 2:
        assert cnt[AHEAD] == k - 2


def test_stop_true_at_once(monkeypatch):
    eng = _engine("worm", monkeypatch)
    res, cnt = _run(eng, stop=lambda: True)
    ref, _ = _run(eng, serial=True, stop=lambda: True)
    _assert_same(res, ref)
    assert res.n_chunks == 1 and cnt[HELD] == 1
    assert AHEAD not in cnt and SPENT not in cnt


@pytest.mark.parametrize("kind", ["cylinder", "worm"])
def test_progress_sees_the_serial_sequence(kind, monkeypatch):
    eng = _engine(kind, monkeypatch)
    seen, ref_seen = [], []
    _run(eng, progress=seen.append)
    _run(eng, serial=True, progress=ref_seen.append)
    assert len(seen) == len(ref_seen) > 10
    for a, b in zip(seen, ref_seen):
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("kind", ["cylinder", "worm"])
def test_spent_segment_leaves_ft_as_serial(kind, monkeypatch):
    """The segment issued ahead on an ensemble that then read finished
    rebuilds ft from the bank; the run restores the ft it kept, so the
    state the result is read from is the serial one, ft bit for bit."""
    eng = _engine(kind, monkeypatch)
    states = []
    host_state = eng._host_state

    def keep(state):
        states.append(state.ft.clone())
        return host_state(state)
    eng._host_state = keep
    _, cnt = _run(eng)
    _, ref_cnt = _run(eng, serial=True)
    assert cnt[SPENT] == 1 and SPENT not in ref_cnt
    assert torch.equal(states[0], states[1])


def test_counters_only_under_recording(monkeypatch):
    """The three counters count under recording() alone: a run outside
    it leaves nothing in a scope closed before it, and one inside counts
    every segment issued."""
    eng = _engine("worm", monkeypatch)
    with profiling.recording() as before:
        pass
    res = eng.run()
    assert before.counters == {}
    again, cnt = _run(eng)
    _assert_same(res, again)
    assert set(cnt) >= {AHEAD, HELD, SPENT}
    assert cnt[AHEAD] + cnt[HELD] == res.n_chunks + cnt[SPENT]


def test_criterion_off_float32_runs_in_series(monkeypatch):
    """A criterion float32 cannot hold (the kernels test χ² against its
    float32 rounding, the host against the float64 value) never lets a
    segment go ahead."""
    eng = _engine("worm", monkeypatch, convergence_criterion=1.1)
    res, cnt = _run(eng)
    assert AHEAD not in cnt and cnt[HELD] == res.n_chunks


def test_k1_route_runs_in_series(monkeypatch):
    """An engine of K1 chunks (here their plain version) holds every
    chunk back."""
    eng = _engine("sphere", monkeypatch, max_iterations=4000)
    assert not eng.runs_prefetch
    res, cnt = _run(eng)
    assert AHEAD not in cnt and cnt[HELD] == res.n_chunks > 2


@pytest.mark.parametrize("shards", [1, 2])
def test_sharded_ensemble_runs_in_series(shards, monkeypatch):
    """A repetition mesh on the CPU issues nothing ahead, and equals the
    unsharded engine (whose segments go ahead) bit for bit."""
    mesh = make_mesh((shards, 1), [torch.device("cpu")] * shards)
    se = _engine("worm", monkeypatch, mesh=mesh)
    res, cnt = _run(se)
    assert AHEAD not in cnt and cnt[HELD] == res.n_chunks
    ref, ref_cnt = _run(_engine("worm", monkeypatch))
    assert ref_cnt[AHEAD] > 0
    _assert_same(res, ref)
