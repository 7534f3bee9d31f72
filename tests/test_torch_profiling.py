# -*- coding: utf-8 -*-
"""PyTorch port: tracing / profiling helpers (mcsas_tpu_torch/utils/
profiling.py), the counterparts of the JAX package's
tests/test_profiling.py, debug_guards raising inside the engine, and the
span and counter recorder: off, it records nothing; on, a fit records
its span tree and counters, gives results bit for bit the fit's without
it, and stamps its spans on the profiler's clock."""
import ast
import dataclasses
import glob
import json
import pathlib
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcsas_tpu_torch import api, data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core import engine  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402
from mcsas_tpu_torch.utils import profiling  # noqa: E402
from mcsas_tpu_torch.utils.profiling import (annotate,  # noqa: E402
                                             debug_guards, recording, span,
                                             trace)


@pytest.fixture(autouse=True)
def fresh_probe_memo(monkeypatch):
    """Each test starts with an empty memo of the magnitude probe: the
    span trees and counts below include the probe's own work."""
    monkeypatch.setattr(engine, "_PROBE_MEMO", {})


def test_trace_writes_capture_with_the_span(tmp_path):
    with trace(tmp_path):
        with annotate("unit-phase"):
            (torch.ones(64) * 2.0).sum()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as fd:
        events = json.load(fd)["traceEvents"]
    assert any(ev.get("name") == "unit-phase" for ev in events)


def test_debug_guards_restores_flags():
    assert profiling.guard_flags() is None
    with debug_guards(nans=True):
        assert profiling.guard_flags() == (True, False)
        with debug_guards(nans=False, infs=True):
            assert profiling.guard_flags() == (False, True)
        assert profiling.guard_flags() == (True, False)
    assert profiling.guard_flags() is None


def _nan_row_engine(refdata):
    """A plain-chunk Sphere engine whose rows are NaN for radii above the
    range's geometric middle: the initial state holds NaN rows."""
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(num_contribs=20, num_reps=2, max_iterations=200,
                      chunk_steps=50, seed=5, max_retries=0,
                      candidates_per_step=2)
    eng = McSASEngine(d, bound, cfg, device="cpu")
    lo, hi = bound.ranges[0]
    mid = float(np.sqrt(lo * hi))
    ff = eng.kern.model_ff

    def nan_ff(q, pd):
        out = ff(q, pd)
        return torch.where(pd["radius"] > mid,
                           torch.full_like(out, float("nan")), out)

    eng.kern = dataclasses.replace(eng.kern, model_ff=nan_ff)
    eng.spec = dataclasses.replace(eng.spec, kern=eng.kern)
    return eng


def test_debug_guards_raise_on_a_nan_row(refdata):
    eng = _nan_row_engine(refdata)
    # without the guards a NaN χ² counts as a stuck repetition
    res = eng.run()
    assert not np.isfinite(res.conval).all()
    with debug_guards(nans=True):
        with pytest.raises(FloatingPointError,
                           match=r"after chunk 1, repetition \d holds a NaN "
                                 r"in chi2, ft"):
            eng.run()
    assert profiling.guard_flags() is None
    # infs only: a NaN passes
    with debug_guards(nans=False, infs=True):
        eng.run()


def test_recorder_report():
    """Totals and self times per name: a span's self time is its duration
    less its direct children's."""
    with recording() as rec:
        with span("a"):
            time.sleep(0.002)
            with span("b"):
                time.sleep(0.004)
        with span("b"):
            pass
    rep = rec.report()
    assert list(rep) == ["a", "b"]
    assert rep["a"]["count"] == 1 and rep["b"]["count"] == 2
    (a, _, a_end, _, _), (b, b_start, b_end, parent, _) = rec.spans[:2]
    assert parent == 0
    assert rep["a"]["self_s"] == pytest.approx(
        rep["a"]["total_s"] - (b_end - b_start) * 1e-9)
    assert rep["a"]["self_s"] >= 0.002
    assert rep["b"]["total_s"] == rep["b"]["self_s"] >= 0.004


def test_span_off_records_nothing():
    """Outside a recording scope span() returns one shared no-op context
    and count() does nothing; a closed scope's recorder takes no more."""
    off = span("x")
    assert span("y", fit=True) is off
    with off:
        profiling.count("x")
    with recording() as rec:
        with span("x"):
            profiling.count("x", 3)
    with span("z"):
        profiling.count("x")
    assert [s[0] for s in rec.spans] == ["x"] and rec.counters == {"x": 3}
    with recording() as outer:
        with recording() as inner:
            with span("in"):
                pass
        with span("out"):
            pass
    assert [s[0] for s in inner.spans] == ["in"]
    assert [s[0] for s in outer.spans] == ["out"]


# the span tree of one fit: each span's parent
_PARENT = {
    "api.engine": "api.fit",
    "core.engine.construct": "api.engine",
    "core.engine.constants": "core.engine.construct",
    "core.engine.probe": "core.engine.construct",
    "ops.tables.lookup": "core.engine.construct",
    "core.engine.mc": "api.fit",
    "core.engine.init": "core.engine.mc",
    "core.engine.chunk": "core.engine.mc",
    "core.engine.retry": "core.engine.mc",
    "core.engine.result": "core.engine.mc",
    "core.engine.draw": "core.engine.chunk",
    "ops.mc_kernel.factors": "core.engine.chunk",
    "ops.mc_kernel.launch": "core.engine.chunk",
    "core.engine.read": "core.engine.chunk",
    "post.histogram_all": "api.fit",
    "post.bank": "post.histogram_all",
    "post.histograms": "post.histogram_all",
}


def _fit_case(kind, refdata, monkeypatch):
    """(data maker, model, config) of a retried CPU fit: the Sphere on the
    plain chunk, or the cylinder on a 64-row table through the prefetch
    segments' plain version.  The maker runs ``data.from_raw``."""
    cfg = dict(num_contribs=10, num_reps=3, max_iterations=300,
               candidates_per_step=4, local_moves=0.5, max_retries=1,
               seed=3)
    if kind == "sphere":
        return (lambda: data.load(refdata / "sasfit_sphere-10-1.dat"),
                "Sphere", McSASConfig(chunk_steps=100, **cfg))
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    return (suite.cylinder_golden, suite.cylinder_bound(),
            suite.cylinder_config(table_ff="on", chunk_steps=4, **cfg))


def _fit(case):
    """A fit of *case* on a new engine, its data made first."""
    make, model, cfg = case
    api._ENGINE_CACHE.clear()
    return api.fit(make(), model, cfg, device="cpu")


@pytest.mark.parametrize("kind", ["sphere", "cylinder"])
def test_a_fit_records_its_span_tree(kind, refdata, monkeypatch):
    """A fit under recording() records the span tree of _PARENT, one
    read in every chunk, the table lookup's counters on the cylinder, and
    the EngineResult's counters agree with the spans and the proposals."""
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    case = _fit_case(kind, refdata, monkeypatch)
    cfg = case[2]
    with recording() as rec:
        res = _fit(case)
    spans = rec.spans
    names = [s[0] for s in spans]
    assert names[0] == "data.from_raw" and spans[0][3:] == (-1, -1)
    assert names[1] == "api.fit" and spans[1][3:] == (-1, 0)
    assert rec.n_fits == 1
    for name, start, end, parent, fit in spans[1:]:
        assert fit == 0 and 0 <= start <= end
        if name != "api.fit":
            assert spans[parent][0] == _PARENT[name], name
            assert spans[parent][1] <= start and end <= spans[parent][2]
    want = set(_PARENT) - {"ops.tables.lookup", "ops.mc_kernel.factors"}
    if kind == "cylinder":
        want |= {"ops.tables.lookup", "ops.mc_kernel.factors"}
    assert set(names[2:]) == want
    # the benchmark's harness labels its own annotations by these names
    src = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
           / "run.py").read_text(encoding="utf-8")
    harness = ast.literal_eval(
        re.search(r"^SPANS = (\(.*?\))$", src, re.M).group(1))
    assert len(harness) == 6 and not set(names) & set(harness)
    eng = res.engine
    chunks = [i for i, n in enumerate(names) if n == "core.engine.chunk"]
    assert len(chunks) == eng.n_chunks == names.count("core.engine.read")
    for i in chunks:
        kids = [s[0] for s in spans if s[3] == i]
        assert kids.count("core.engine.read") == 1
        assert kids[-1] == "core.engine.read"
    assert (eng.attempts > 1).any()        # the case retries
    assert names.count("core.engine.retry") >= 1
    assert eng.retried_iters == eng.total_iters - eng.n_iter.sum() > 0
    assert 0 < eng.rep_chunks <= eng.n_chunks * cfg.num_reps
    assert rec.counters["api.engine_cache.miss"] == 1
    if kind == "cylinder":
        tables = {k: v for k, v in rec.counters.items()
                  if k.startswith("ops.tables.")}
        assert sum(tables.values()) >= 1 and set(tables) <= {
            "ops.tables.memo_hit", "ops.tables.disk_hit", "ops.tables.bake"}
    report = rec.report()
    assert report["core.engine.mc"]["self_s"] < \
        0.05 * report["core.engine.mc"]["total_s"]


def test_bank_kernel_counts_each_launch_under_recording(monkeypatch):
    """``post.bank.kernel`` counts one per launch of the cylinder bank
    kernel under ``recording()`` and nothing with recording off, while the
    wrapper's own ``launches`` counts every launch.  The launch is
    rehearsed on CPU tensors: the wrapper's device check and the C call
    are replaced, the call recorded."""
    from mcsas_tpu_torch.ops import cuda_lib, cyl_bank
    calls = []
    monkeypatch.setattr(cyl_bank, "_check", lambda inp: None)
    monkeypatch.setattr(cuda_lib, "device_index", lambda dev: 0)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda entry, prm, dev: calls.append(entry.name))
    rset = torch.full((2, 3, 1), 1e-8, dtype=torch.float64)
    inp = cyl_bank.bank_inputs(suite.cylinder_bound(),
                               suite.cylinder_golden(), 4.0 / 3.0, rset)
    before = cyl_bank.run_cyl_bank.launches
    with recording() as rec:
        for _ in range(2):
            assert tuple(cyl_bank.run_cyl_bank(inp).shape) == (6, 100)
    cyl_bank.run_cyl_bank(inp)                       # recording off
    with recording() as idle:
        pass
    assert rec.counters == {"post.bank.kernel": 2} and idle.counters == {}
    assert calls == ["cyl_bank"] * 3
    assert cyl_bank.run_cyl_bank.launches == before + 3


def test_the_worm_records_its_rule_and_counters(refdata, monkeypatch):
    """A worm fit (16-node table axes) records a span
    ``models.kholodenko.rule`` under each of the magnitude probe, the
    table's bake and the post pass's bank, counts the (t, x) elements
    each evaluated, one ``ops.mc_kernel.cross_section`` a segment (the
    rows carry the lookup's cross-section; a segment issued ahead of a
    read that found the ensemble finished is one too) and one
    ``post.bank.eager``;
    the Sphere and the cylinder record neither the rule nor the factor."""
    from mcsas_tpu_torch.ops import tables
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    monkeypatch.setattr(tables, "_TABLE_CACHE", {})
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    monkeypatch.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
    d = data.load(refdata / "sasfit_kho-1-10-1000.dat")
    cfg = McSASConfig(num_contribs=10, num_reps=2, max_iterations=3000,
                      chunk_steps=64, candidates_per_step=4,
                      local_moves=0.75, table_ff="on", seed=3,
                      max_retries=0)
    with recording() as rec:
        res = api.fit(d, get_model("Kholodenko").bind(), cfg, device="cpu")
    assert res.engine.used_table
    spans, names = rec.spans, [s[0] for s in rec.spans]
    rule = [s for s in spans if s[0] == "models.kholodenko.rule"]
    assert sorted(spans[s[3]][0] for s in rule) == [
        "core.engine.probe", "ops.tables.lookup", "post.bank"]
    nq = len(d.q)
    c = rec.counters
    assert c["models.kholodenko.rule_values"] == nq * (1 + 16 * 16 + 2 * 10)
    assert c["ops.mc_kernel.cross_section"] == names.count(
        "ops.mc_kernel.launch") == res.engine.n_chunks + c.get(
            "core.engine.lookahead.spent", 0) > 0
    assert c["post.bank.eager"] == 1 and "post.bank.kernel" not in c
    for kind in ("sphere", "cylinder"):
        case = _fit_case(kind, refdata, monkeypatch)
        with recording() as other:
            _fit(case)
        assert "models.kholodenko.rule" not in [s[0] for s in other.spans]
        assert set(other.counters) & {"models.kholodenko.rule_values",
                                      "ops.mc_kernel.cross_section"} == set()
        assert other.counters["post.bank.eager"] == 1


def test_engine_counters_of_a_converging_fit(refdata):
    """rep_chunks counts the repetitions still running at each chunk's
    launch: below n_chunks × R once a repetition converges before the
    last chunk; no attempt retried, no retried proposals."""
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    cfg = McSASConfig(num_contribs=10, num_reps=3, max_iterations=20000,
                      chunk_steps=20, candidates_per_step=4, seed=3,
                      max_retries=0)
    eng = McSASEngine(d, get_model("Sphere").bind(), cfg, device="cpu")
    per_chunk = []
    res = eng.run(progress=lambda p: per_chunk.append(
        int((~p["converged"]).sum())))
    assert res.converged.all() and res.retried_iters == 0
    assert res.n_chunks == len(per_chunk)
    assert res.rep_chunks == cfg.num_reps + sum(per_chunk[:-1])
    assert res.rep_chunks < res.n_chunks * cfg.num_reps


@pytest.mark.parametrize("kind", ["sphere", "cylinder"])
def test_results_are_bitwise_with_recording_on_and_off(kind, refdata,
                                                       monkeypatch):
    """The EngineResult (its timers aside) and the post pass are the same
    bits with recording on and off."""
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    case = _fit_case(kind, refdata, monkeypatch)
    off = _fit(case)
    with recording():
        on = _fit(case)
    for f in dataclasses.fields(off.engine):
        if f.name in ("elapsed", "iters_per_sec", "moves_per_sec"):
            continue
        np.testing.assert_array_equal(getattr(on.engine, f.name),
                                      getattr(off.engine, f.name), f.name)
    np.testing.assert_array_equal(on.fractions.measval,
                                  off.fractions.measval)
    np.testing.assert_array_equal(on.fractions.fraction["vol"],
                                  off.fractions.fraction["vol"])
    for a, b in zip(on.histograms, off.histograms):
        np.testing.assert_array_equal(a.bins.full, b.bins.full)


def test_spans_share_the_profilers_clock():
    """Under torch.profiler each span opens a record_function of its name
    and stamps its own clock inside that event: every span lies within its
    event on one clock, with no offset, and the median distance between
    their starts and between their ends is under 100 µs.  The process's
    first record_function pays about a millisecond of one-time set-up
    inside its event, so a span warms it first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording():
            with span("warm-up"):
                pass
        with recording() as rec:
            for i in range(20):
                with span(f"clock.{i}"):
                    (torch.ones(256) * 2.0).sum()
                    time.sleep(0.001)
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("clock.")}
    assert len(events) == len(rec.spans) == 20
    starts, ends = [], []
    for name, start, end, _, _ in rec.spans:
        ev = events[name]
        assert ev.start_ns() <= start < end <= ev.end_ns(), name
        starts.append(start - ev.start_ns())
        ends.append(ev.end_ns() - end)
    assert np.median(starts) < 100_000 and np.median(ends) < 100_000
