# -*- coding: utf-8 -*-
"""PyTorch port: the command line (``python -m mcsas_tpu_torch``), held
to the JAX package's CLI tests (tests/test_api.py) with ``--device cpu``,
plus the device flag, ``--rehistogram``, ``--series-stats``, ``--plot``
and the module entry's package boundary (no JAX)."""
import configparser
import glob
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch.cli import main  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
_SPHERE = "sasfit_sphere-10-1.dat"
# a fit of about a second: 10 contributions, one repetition, one
# 200-step chunk an attempt, one retry
_TINY = ["--contribs", "10", "--reps", "1", "--max-iter", "200",
         "--candidates", "2", "--seed", "3", "--nolog", "--device", "cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    return env


@pytest.fixture
def no_retries(tmp_path):
    """A -c config with maxRetries 0 (two attempts), for short fits."""
    fn = tmp_path / "cfg.json"
    fn.write_text('{"maxRetries": 0, "chunkSteps": 200}')
    return ["-c", str(fn)]


def _listed(out):
    return [line.split()[0] for line in out.strip().splitlines()]


def test_cli_list_models(capsys):
    """Port of test_api.py::test_cli_list_models: --list-models works
    without a data file and prints the JAX CLI's model names in its
    order; a fit without files is a usage error."""
    from mcsas_tpu.cli import main as jax_main
    assert main(["--list-models"]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["--list-models"]) == 0
    theirs = capsys.readouterr().out
    assert _listed(ours) == _listed(theirs)
    assert "Sphere" in ours and "Kholodenko" in ours
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code == 2


_USER_MODEL_SRC = """
import math
from mcsas_tpu_torch.models import ParamSpec, SASModel
from mcsas_tpu_torch.utils.units import NM

{name} = SASModel(
    name="{name}",
    elementwise_q=True,
    doc="test plugin model",
    params=(ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                      active_range=NM.to_si((0.1, 100.0)),
                      generator="logdec1", is_fit=True),),
    default_active=("radius",),
    ff=lambda q, p: (q * p["radius"]) ** -2,
    volume=lambda p: 4.0 / 3.0 * math.pi * p["radius"] ** 3,
)
"""


@pytest.mark.parametrize("flag", ("--model-dir", "--model-file"))
def test_cli_model_file_and_dir(tmp_path, capsys, flag):
    """Port of test_api.py::test_cli_model_file_and_dir, for both flags."""
    from mcsas_tpu_torch.models import REGISTRY
    src = tmp_path / "cli_plugin.py"
    src.write_text(_USER_MODEL_SRC.format(name="CliPlugin"))
    arg = str(tmp_path if flag == "--model-dir" else src)
    try:
        assert main([flag, arg, "--list-models", "dummy"]) == 0
        assert "CliPlugin" in capsys.readouterr().out
    finally:
        REGISTRY.pop("CliPlugin", None)


def test_cli_plugin_model_fits(refdata, tmp_path, capsys, no_retries):
    """-m of a plugin loaded by --model-file fits on the CPU."""
    from mcsas_tpu_torch.models import REGISTRY
    src = tmp_path / "fit_plugin.py"
    src.write_text(_USER_MODEL_SRC.format(name="FitPlugin"))
    try:
        rc = main([str(refdata / _SPHERE), "--model-file", str(src),
                   "-m", "FitPlugin", "-o", str(tmp_path / "out"),
                   *_TINY, *no_retries])
    finally:
        REGISTRY.pop("FitPlugin", None)
    assert rc in (0, 1)
    assert "sasfit_sphere-10-1: chi2=" in capsys.readouterr().out


def test_cli_full_run(refdata, tmp_path, capsys, no_retries):
    """Port of test_api.py::test_cli_full_run."""
    rc = main([str(refdata / _SPHERE), "-m", "Sphere", "-o",
               str(tmp_path), *_TINY, *no_retries])
    out = capsys.readouterr().out
    assert "sasfit_sphere-10-1: chi2=" in out
    assert "[NOT CONVERGED]" in out and "proposals/s" in out
    assert rc == 1                      # cannot converge in 200 iters
    subdirs = list(tmp_path.iterdir())
    subdirs = [p for p in subdirs if p.is_dir()]
    assert len(subdirs) == 1
    files = {f.name.split("_")[-1] for f in subdirs[0].iterdir()}
    assert {"fit.dat", "settings.cfg", "contributions.pickle",
            "log.txt"} <= files


def test_cli_multi_histograms(refdata, tmp_path, no_retries):
    """Port of test_api.py::test_cli_multi_histograms: repeatable --hist
    adds ranges and weightings beside the default histogram."""
    rc = main([str(refdata / _SPHERE), "-m", "Sphere", "-o",
               str(tmp_path), *_TINY, *no_retries,
               "--hist", "radius=5:20,25,log,num",
               "--hist", "radius,10,surf"])
    assert rc in (0, 1)
    hists = glob.glob(str(tmp_path / "*" / "*_hist-*.dat"))
    assert len(hists) == 3
    assert any("log-num" in h for h in hists)
    assert any("surf" in h for h in hists)


@pytest.mark.parametrize("args,what", [
    (["--range", "radius=banana"], "bad --range"),
    (["--hist", "radius=1:2,nonsense"], "bad --hist"),
    (["--hist", "volFrac"], "bad --hist"),
])
def test_cli_bad_arguments(refdata, capsys, args, what):
    """Port of test_api.py::test_cli_bad_range, with malformed --hist."""
    rc = main([str(refdata / _SPHERE), "--device", "cpu", *args])
    assert rc == 2
    assert what in capsys.readouterr().err


def test_cli_range_override(refdata, tmp_path, no_retries):
    """Port of test_api.py::test_cli_range_override."""
    main([str(refdata / _SPHERE), "-o", str(tmp_path), *_TINY,
          *no_retries, "--range", "radius=5:50"])
    subdir = next(p for p in tmp_path.iterdir() if p.is_dir())
    cfgfile = next(f for f in subdir.iterdir()
                   if f.name.endswith("settings.cfg"))
    cp = configparser.RawConfigParser()
    cp.read(cfgfile)
    assert float(cp.get("Model Settings", "radius_min")) == \
        pytest.approx(5e-9)
    assert float(cp.get("Model Settings", "radius_max")) == \
        pytest.approx(5e-8)
    assert cp.get("MCSAS Settings", "maxRetries") == "0"


def test_cli_series_stats_and_plot(refdata, tmp_path, no_retries):
    """--series-stats over two files writes the series table (and, with
    --plot, its figure and each file's plot)."""
    src = refdata / _SPHERE
    files = [tmp_path / "a.dat", tmp_path / "b.dat"]
    for f in files:
        f.write_bytes(src.read_bytes())
    out = tmp_path / "out"
    rc = main([*map(str, files), "-o", str(out), *_TINY, *no_retries,
               "--series-stats", "--plot"])
    assert rc in (0, 1)
    (table,) = glob.glob(str(out / "series statistics *.dat"))
    assert len(pathlib.Path(table).read_text().strip().splitlines()) == 3
    assert os.path.exists(table.replace(".dat", ".pdf"))
    assert len(glob.glob(str(out / "*" / "*_plot.pdf"))) == 2


def test_cli_rehistogram(refdata, tmp_path, capsys, no_retries):
    """--rehistogram rebuilds histograms from an archive of an earlier
    run, equal to the run's own distribution file at the format's
    precision."""
    pytest.importorskip("h5py")
    run = tmp_path / "run"
    main([str(refdata / _SPHERE), "-o", str(run), *_TINY, *no_retries])
    (archive,) = glob.glob(str(run / "*" / "*_hdf5archive.hdf5"))
    (hist,) = glob.glob(str(run / "*" / "*_hist-*.dat"))
    capsys.readouterr()
    assert main([archive, "--rehistogram", "-o", str(tmp_path),
                 "--device", "cpu", "--nolog"]) == 0
    (rehist,) = glob.glob(str(tmp_path / "*_rehist-radius-50-lin-vol.dat"))
    assert f"wrote {rehist}" in capsys.readouterr().out
    from mcsas_tpu_torch.io import load_raw
    np.testing.assert_allclose(load_raw(rehist)[0], load_raw(hist)[0],
                               rtol=1e-6)


def test_cli_cuda_without_a_card(refdata, capsys):
    """--device cuda (the default) without a card is an error naming the
    missing device: exit code 2, nothing fitted on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in ([], ["--device", "cuda"], ["--rehistogram"]):
        assert main([str(refdata / _SPHERE), "--nolog", *args]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error: --device cuda")
        assert "torch.cuda.is_available() is False" in err


def test_module_entry_imports_no_jax():
    """``python -m mcsas_tpu_torch --list-models`` exits 0 and imports
    neither jax nor the JAX package (read from -X importtime)."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "mcsas_tpu_torch",
         "--list-models"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Sphere" in out.stdout
    imported = {line.rsplit("|", 1)[-1].strip() for line in
                out.stderr.splitlines() if line.startswith("import time:")}
    assert "mcsas_tpu_torch.cli" in imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "mcsas_tpu"))
    assert not bad, bad
