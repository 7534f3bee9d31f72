# -*- coding: utf-8 -*-
"""PyTorch port: tracing / profiling helpers (mcsas_tpu_torch/utils/
profiling.py), the counterparts of the JAX package's
tests/test_profiling.py, and debug_guards raising inside the engine."""
import dataclasses
import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mcsas_tpu_torch import data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.utils import profiling  # noqa: E402
from mcsas_tpu_torch.utils.profiling import (Stopwatch, annotate,  # noqa
                                             debug_guards, trace)


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


def test_stopwatch_report():
    sw = Stopwatch()
    with sw.phase("a"):
        pass
    with sw.phase("b"):
        pass
    rep = sw.report()
    assert "a" in rep and "b" in rep and "total" in rep
