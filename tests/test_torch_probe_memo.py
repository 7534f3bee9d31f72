# -*- coding: utf-8 -*-
"""PyTorch port: the memo of the float64 magnitude probe
(``core/engine.py:memo_probe``).  A hit is the probe's float bit for bit;
any part of the key that changes (the grid by one ulp, a range, a fixed
value, ``locs`` in place of ``q``, ψ) misses; a model piece that cannot
be hashed is probed every time; the oldest entry goes first; the hit and
miss counters count; and two fits of different frames on one grid are
the same bits with the memo cleared and with it warm."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcsas_tpu_torch import api, data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core import engine  # noqa: E402
from mcsas_tpu_torch.core.engine import (magnitude_probe,  # noqa: E402
                                         make_intensity_kernels, memo_probe)
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402
from mcsas_tpu_torch.utils.profiling import recording  # noqa: E402

NM = 1e-9
HIT, MISS = "core.engine.probe_memo.hit", "core.engine.probe_memo.miss"


@pytest.fixture(autouse=True)
def fresh_memo(monkeypatch):
    monkeypatch.setattr(engine, "_PROBE_MEMO", {})


def _memo_counts(rec):
    """The memo's counters of a recording."""
    return {k: v for k, v in rec.counters.items()
            if k.startswith("core.engine.probe_memo.")}


def _case(kind, refdata):
    """(bound, probe grid, ψ or None) of one probe case."""
    if kind == "sphere":
        d = data.load(refdata / "sasfit_sphere-10-1.dat")
        return get_model("Sphere").bind(), d.q, None
    if kind == "cylinder":
        return suite.cylinder_bound(), suite.cylinder_golden().q, None
    if kind == "smeared-cylinder":
        d = suite.cylinder_smeared_golden()
        return suite.cylinder_bound(), d.locs, None
    if kind == "worm":
        d = data.load(refdata / "sasfit_kho-1-10-1000.dat")
        return get_model("Kholodenko").bind(), d.q, None
    d = suite.cylinder_2d_golden(24, 16, rel_sigma=0.02)
    bound = get_model("CylindersRadiallyIsotropic").bind(
        active=("radius", "psiAngle"),
        active_ranges={"radius": (1 * NM, 20 * NM)})
    return bound, d.q, d.psi


@pytest.mark.parametrize("kind", ["sphere", "cylinder", "smeared-cylinder",
                                  "worm", "2d"])
def test_a_hit_is_the_probes_float(kind, refdata):
    """The miss and the hit both return magnitude_probe's float, bit for
    bit; the second call is a hit."""
    bound, grid, psi = _case(kind, refdata)
    want = magnitude_probe(bound, grid, two_d_psi=psi).hex()
    with recording() as rec:
        first = memo_probe(bound, grid, two_d_psi=psi)
        second = memo_probe(bound, grid, two_d_psi=psi)
    assert first.hex() == second.hex() == want
    assert _memo_counts(rec) == {MISS: 1, HIT: 1}
    assert len(engine._PROBE_MEMO) == 1


def _ulp_up(a, k=3):
    a = np.array(a, np.float64)
    a.flat[k] = np.nextafter(a.flat[k], np.inf)
    return a


def test_every_part_of_the_key_misses(refdata):
    """A grid point one ulp up, another range, another fixed value,
    ``locs`` in place of ``q``, ψ one ulp up and ψ left out each miss, and
    each miss returns that key's own probe."""
    model = get_model("CylindersIsotropic")
    bound = suite.cylinder_bound()
    smeared = suite.cylinder_smeared_golden()
    bound_2d, q_2d, psi_2d = _case("2d", refdata)
    keys = [
        (bound, smeared.q, None),
        (bound, _ulp_up(smeared.q), None),
        (model.bind(active=("radius",),
                    active_ranges={"radius": (0.5e-9, 200e-9)}),
         smeared.q, None),
        (model.bind(active=("radius",),
                    active_ranges={"radius": (0.5e-9, 300e-9)},
                    fixed={"aspect": 12.0}), smeared.q, None),
        (bound, smeared.locs, None),
        (bound_2d, q_2d, psi_2d),
        (bound_2d, q_2d, _ulp_up(psi_2d)),
        (bound_2d, q_2d, None),
    ]
    with recording() as rec:
        got = [memo_probe(b, g, two_d_psi=p) for b, g, p in keys]
    assert _memo_counts(rec) == {MISS: len(keys)}
    assert len(engine._PROBE_MEMO) == len(keys)
    for (b, g, p), v in zip(keys, got):
        assert v.hex() == magnitude_probe(b, g, two_d_psi=p).hex()
    # a range and a fixed value move the probe itself
    assert len({got[0], got[2], got[3]}) == 3


class _Unhashable:
    """A form factor that cannot be hashed (equality without a hash)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, q, p):
        return self.fn(q, p)

    def __eq__(self, other):
        return isinstance(other, _Unhashable) and other.fn is self.fn

    __hash__ = None


def test_an_unhashable_model_is_probed_every_time(refdata):
    """A model piece that cannot be hashed probes each call, raises
    nothing and counts a miss each time; the memo stays empty.  An engine's
    intensity row is built on it as before."""
    sphere = get_model("Sphere")
    model = dataclasses.replace(sphere, ff=_Unhashable(sphere.ff))
    bound = model.bind()
    with pytest.raises(TypeError):
        hash(bound)
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    want = magnitude_probe(bound, d.q).hex()
    with recording() as rec:
        got = [memo_probe(bound, d.q).hex() for _ in range(2)]
        kern = make_intensity_kernels(bound, d, McSASConfig())
    assert got == [want, want]
    assert _memo_counts(rec) == {MISS: 3}
    assert engine._PROBE_MEMO == {}
    assert kern.inv_i_ref == 1.0 / float.fromhex(want)


def test_the_cap_evicts_the_oldest_entry(refdata, monkeypatch):
    """At the cap a new key takes the oldest entry's place."""
    monkeypatch.setattr(engine, "_PROBE_MEMO_CAP", 2)
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    model = get_model("Sphere")
    bounds = [model.bind(active_ranges={"radius": (1 * NM, hi * NM)})
              for hi in (50, 60, 70)]
    with recording() as rec:
        for b in bounds:
            memo_probe(b, d.q)
    assert _memo_counts(rec) == {MISS: 3}
    assert [k[0] for k in engine._PROBE_MEMO] == bounds[1:]
    with recording() as rec:
        memo_probe(bounds[2], d.q)          # still there
        memo_probe(bounds[0], d.q)          # evicted: probed again
    assert _memo_counts(rec) == {HIT: 1, MISS: 1}
    assert [k[0] for k in engine._PROBE_MEMO] == [bounds[2], bounds[0]]


def test_engines_count_a_hit_for_each_frame_on_one_grid(refdata):
    """Engines of three frames on one grid (new intensities each) probe
    once: one miss, two hits, the same inv_i_ref and w_ref; the counters
    count nothing outside recording()."""
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    bound = get_model("Sphere").bind()
    frames = [_frame(d, s) for s in (0.0, 0.5, 1.0)]
    assert len({f.content_key() for f in frames}) == 3
    cfg = McSASConfig(num_contribs=10, num_reps=2)
    with recording() as rec:
        kerns = [make_intensity_kernels(bound, f, cfg) for f in frames]
    assert _memo_counts(rec) == {MISS: 1, HIT: 2}
    assert len({(k.inv_i_ref, k.w_ref) for k in kerns}) == 1
    make_intensity_kernels(bound, frames[0], cfg)      # recording off
    assert _memo_counts(rec) == {MISS: 1, HIT: 2}


def _frame(d, tilt):
    """Another frame of dataset *d* on its grid: the intensities times
    1 + 0.3 (q / q_max)^(1 + tilt), the other raw columns as loaded."""
    raw = np.array(d.raw, np.float64)
    raw[:, 1] *= 1.0 + 0.3 * (raw[:, 0] / raw[:, 0].max()) ** (1.0 + tilt)
    out = data.from_raw(raw, title=f"tilt {tilt}", config=d.config)
    np.testing.assert_array_equal(out.q, d.q)
    return out


def test_fits_on_one_grid_are_bitwise_with_the_memo_cold_and_warm(
        refdata, monkeypatch):
    """The worm at 16-node table axes (test_torch_profiling.py's CPU
    case): frame B fitted after frame A on the same grid (the memo warm)
    is the fit of frame B on a cleared memo, bit for bit; the converged
    rule opens under ``core.engine.probe`` on the miss only."""
    from mcsas_tpu_torch.ops import tables
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    monkeypatch.setattr(tables, "_TABLE_CACHE", {})
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    monkeypatch.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
    d = data.load(refdata / "sasfit_kho-1-10-1000.dat")
    frame_a, frame_b = d, _frame(d, 0.5)
    bound = get_model("Kholodenko").bind()
    cfg = McSASConfig(num_contribs=10, num_reps=2, max_iterations=3000,
                      chunk_steps=64, candidates_per_step=4,
                      local_moves=0.75, table_ff="on", seed=3,
                      max_retries=0)

    def fit(frame):
        with recording() as rec:
            res = api.fit(frame, bound, cfg, device="cpu")
        spans = rec.spans
        under_probe = [s for s in spans if s[0] == "models.kholodenko.rule"
                       and spans[s[3]][0] == "core.engine.probe"]
        probe = [s for s in spans if s[0] == "core.engine.probe"]
        return res, len(probe), len(under_probe), _memo_counts(rec)

    _, n_probe, n_rule, counts = fit(frame_a)
    assert (n_probe, n_rule, counts) == (1, 1, {MISS: 1})
    warm, n_probe, n_rule, counts = fit(frame_b)
    assert (n_probe, n_rule, counts) == (1, 0, {HIT: 1})
    engine._PROBE_MEMO.clear()
    api._ENGINE_CACHE.clear()
    cold, n_probe, n_rule, counts = fit(frame_b)
    assert (n_probe, n_rule, counts) == (1, 1, {MISS: 1})
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
