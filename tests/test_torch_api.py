# -*- coding: utf-8 -*-
"""PyTorch port end to end: ``mcsas_tpu_torch.fit`` on the CPU at the
headline configuration, held to the reference McSAS fixture the JAX
package's headline crossval uses; plus the package boundary (no JAX),
the chip smoke script's refusal without a card, and lint."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch import HistogramSpec, fit, load  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    return env


@pytest.fixture(scope="module")
def headline_fit(refdata):
    """The headline config (K=128 best-of-K, local moves 0.5, 300
    contributions, chunk 2048) on the quickstart fixture's dataset.  The
    one reduction: 3 repetitions instead of 10, because the eager CPU
    chunk costs milliseconds per step and the reference tolerances below
    hold per repetition."""
    fix = json.loads((refdata / "reference_quickstart_fixture.json")
                     .read_text())
    d = load(refdata / "quickstartdemo1.csv")
    np.testing.assert_allclose(d.q, np.asarray(fix["fitX0"]), rtol=1e-9)
    cfg = McSASConfig(num_contribs=300, num_reps=3,
                      max_iterations=8_000_000, chunk_steps=2048,
                      candidates_per_step=128, local_moves=0.5, seed=2026,
                      max_retries=1)
    return fix, d, fit(d, "Sphere", cfg, device="cpu")


def test_fit_headline_observables_match_reference(headline_fit):
    """As test_crossval_headline_observables holds the JAX engine: the
    volume-weighted distribution within 0.2 on normalized bars with the
    same modal bin, and the fit curve within 3σ of the data uncertainty
    of the reference's mean curve."""
    fix, d, res = headline_fit
    assert res.converged
    assert res.engine.conval.max() <= 1.0
    assert not res.engine.used_pallas
    h_ref = fix["histograms"]["vol"]
    y_ref = np.asarray(h_ref["yMean"])
    lo, hi = fix["workload"]["activeRange_m"]
    spec = HistogramSpec("radius", lo, hi, bin_count=len(y_ref),
                         xscale="log", yweight="vol", auto_follow=False)
    h = res.histogram([spec]).histograms[0]
    np.testing.assert_allclose(h.x_lower_edge,
                               np.asarray(h_ref["xLowerEdge"]), rtol=1e-9)
    y_eng = h.bins.mean / max(h.bins.mean.sum(), 1e-300)
    y_ref_n = y_ref / max(y_ref.sum(), 1e-300)
    np.testing.assert_allclose(y_eng, y_ref_n, atol=0.2)
    assert int(np.argmax(y_eng)) == int(np.argmax(y_ref_n))
    fu = np.asarray(d.fu, np.float64)
    z = np.abs(res.engine.measval.mean(axis=0)
               - np.asarray(fix["fitMeasValMean"])) \
        / np.where(fu == 0, 1.0, fu)
    assert float(z.max()) < 3.0


def test_fit_result_accessors(headline_fit):
    _, d, res = headline_fit
    n = d.count
    assert res.contribs.shape == (300, 1, 3)
    assert res.fit_measval_mean.shape == (n,)
    assert np.all(np.isfinite(res.fractions.measval))
    # the float64 post-pass curve and the engine's float32 curve agree
    np.testing.assert_allclose(res.fractions.measval, res.engine.measval,
                               rtol=1e-3, atol=1e-3 * np.abs(d.f).max())
    regen = res.regenerate_measval(full_grid=False)
    np.testing.assert_allclose(regen, res.fit_measval_mean, rtol=1e-6)
    assert len(res.histograms) == 1 and res.num_iter > 0
    assert res.engine.total_iters >= int(res.engine.n_iter.sum())


def test_port_never_imports_jax(tmp_path, refdata):
    code = (
        "import sys\n"
        "import mcsas_tpu_torch as mt\n"
        "import mcsas_tpu_torch.ops.tables, mcsas_tpu_torch.models.cylinders\n"
        "import mcsas_tpu_torch.post.histogram\n"
        "import mcsas_tpu_torch.models.chains\n"
        "import mcsas_tpu_torch.models.ellipsoids\n"
        "import mcsas_tpu_torch.tools.kern_probe\n"
        "import mcsas_tpu_torch.tools.suite\n"
        "import mcsas_tpu_torch.api, mcsas_tpu_torch.cli\n"
        "import mcsas_tpu_torch.io.hdf, mcsas_tpu_torch.utils.log\n"
        "import mcsas_tpu_torch.plotting\n"
        "import mcsas_tpu_torch.parallel, mcsas_tpu_torch.utils.profiling\n"
        "import mcsas_tpu_torch.io.native\n"
        "import mcsas_tpu_torch.tools.coldstart\n"
        "import mcsas_tpu_torch.tools.rep_scaling\n"
        "import mcsas_tpu_torch.tools.k1_sweep\n"
        "import mcsas_tpu_torch.tools.bench\n"
        "import mcsas_tpu_torch.tools.roofline\n"
        "import mcsas_tpu_torch.tools.suite_stats\n"
        "cfg = mt.McSASConfig(num_contribs=20, num_reps=1, chunk_steps=20,"
        " max_iterations=400, max_retries=0, candidates_per_step=4)\n"
        f"r = mt.fit({str(refdata / 'sasfit_sphere-10-1.dat')!r}, "
        "'Sphere', cfg, device='cpu')\n"
        "assert r.engine.n_iter[0] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mcsas_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_port_exports_every_name_of_the_jax_package():
    """The port's top level holds every name the JAX package exports
    (mcsas_tpu/__init__.py:54-60), and each resolves there."""
    import mcsas_tpu
    import mcsas_tpu_torch
    missing = set(mcsas_tpu.__all__) - set(mcsas_tpu_torch.__all__)
    assert not missing, sorted(missing)
    for name in mcsas_tpu_torch.__all__:
        assert hasattr(mcsas_tpu_torch, name), name
    assert mcsas_tpu_torch.from_raw.__module__ == "mcsas_tpu_torch.data"
    assert (mcsas_tpu_torch.load_model_file.__module__
            == "mcsas_tpu_torch.models")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_port_lint_clean():
    sys.path.insert(0, str(REPO / "tools"))
    import lint
    findings = lint.lint_paths([str(REPO / "mcsas_tpu_torch"),
                                str(REPO / "chip_smoke.py")])
    msg = "\n".join(f"{p}:{ln}: {code} {m}" for p, ln, code, m in findings)
    assert not findings, f"lint findings:\n{msg}"
