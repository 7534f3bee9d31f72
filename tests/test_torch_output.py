# -*- coding: utf-8 -*-
"""PyTorch port: the result files, the HDF5 archive, the engine cache,
``run_files`` series, plugin models and plotting, held against the JAX
package on the same inputs.

The fits are tiny (10-30 contributions, 1-2 repetitions, at most 3000
iterations, K ≤ 4) and run the plain chunk on the CPU.  The cross-package
file comparison starts from one contribution set: the JAX package's fit,
whose engine arrays become the port's ``McSASResult`` through the port's
own float64 post pass (``histogram_all(device="cpu")``).
"""
import configparser
import dataclasses
import glob
import json
import logging
import os
import pathlib
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mcsas_tpu as jmt  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402

import mcsas_tpu_torch as mt  # noqa: E402
from mcsas_tpu_torch import api, data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (EngineResult,  # noqa: E402
                                         McSASEngine)
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, tables  # noqa: E402
from mcsas_tpu_torch.post.histogram import (HistogramSpec,  # noqa: E402
                                            Moments, histogram_all)

_TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
_SPHERE = "sasfit_sphere-10-1.dat"
# the JAX package's test_api.py fit, on both packages
_CFG = dict(num_contribs=30, num_reps=2, max_iterations=3000,
            chunk_steps=1000, seed=42, max_retries=0,
            candidates_per_step=4, show_incomplete=True)
# a fit of a second or so: one chunk of 200 steps an attempt
_TINY = dict(num_contribs=10, num_reps=1, max_iterations=200,
             chunk_steps=200, seed=3, max_retries=0,
             candidates_per_step=2, show_incomplete=True)
# the output files of one OutputFiles.write_all, by writer
_KINDS = ("fit", "distributions", "statistics", "settings",
          "contributions")


@pytest.fixture(scope="module")
def port_result(refdata):
    return mt.fit(refdata / _SPHERE, model="Sphere",
                  cfg=McSASConfig(**_CFG), device="cpu")


@pytest.fixture(scope="module")
def pair(refdata, tmp_path_factory):
    """One contribution set (the JAX package's fit) through both
    packages' OutputFiles with one basename: {'jax': written,
    'port': written, 'jres', 'pres'}."""
    path = refdata / _SPHERE
    jres = jmt.fit(path, model="Sphere", cfg=JaxConfig(**_CFG))
    # the port's counters the JAX result lacks keep their defaults
    eng = EngineResult(**{f.name: getattr(jres.engine, f.name)
                          for f in dataclasses.fields(EngineResult)
                          if hasattr(jres.engine, f.name)})
    d = data.load(path)
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(**_CFG)
    fractions, hists = histogram_all(eng.contribs, d, bound, cfg,
                                     device="cpu")
    pres = api.McSASResult(data=d, bound=bound, cfg=cfg, engine=eng,
                           fractions=fractions, histograms=hists)
    root = tmp_path_factory.mktemp("pair")
    out = {"jres": jres, "pres": pres}
    for side, res, cls in (("jax", jres, jmt.OutputFiles),
                           ("port", pres, api.OutputFiles)):
        out[side] = cls(res, out_dir=root / side,
                        basename="pair").write_all(plot=False)
    return out


def _files(written, kind):
    got = written[kind]
    return list(got) if isinstance(got, list) else [got]


def _numbers(fn):
    """The numeric table of a written .dat file (header and text cells
    dropped): rows × columns of floats."""
    rows = []
    for line in pathlib.Path(fn).read_text().strip().splitlines():
        cells = []
        for c in line.split():
            try:
                cells.append(float(c))
            except ValueError:
                pass
        if cells:
            rows.append(cells)
    return np.asarray(rows, np.float64)


def _sections(fn):
    cp = configparser.RawConfigParser()
    cp.optionxform = str
    cp.read(fn)
    return {s: dict(cp.items(s)) for s in cp.sections()}


# ------------------------------------------------------------ OutputFiles

def test_write_all_writes_the_whole_set(port_result, tmp_path):
    out = api.OutputFiles(port_result, out_dir=tmp_path)
    written = out.write_all(plot=False)
    assert set(written) == set(_KINDS) | {"archive"}
    for kind in _KINDS + ("archive",):
        for fn in _files(written, kind):
            assert os.path.exists(fn), fn
            assert os.path.dirname(fn) == out.out_dir
    assert len(written["distributions"]) == len(port_result.histograms)
    # the fit file holds the in-memory curve at the format's precision
    raw = _numbers(written["fit"])
    assert raw.shape == (port_result.data.count, 5)
    np.testing.assert_allclose(raw[:, 0], port_result.fit_x0, rtol=1e-6)
    np.testing.assert_allclose(raw[:, 3], port_result.fit_measval_mean,
                               rtol=1e-6)
    with open(written["contributions"], "rb") as fd:
        np.testing.assert_array_equal(pickle.load(fd), port_result.contribs)
    cp = configparser.RawConfigParser()
    cp.read(written["settings"])
    assert cp.get("MCSAS Settings", "numContribs") == "30"
    assert cp.get("MCSAS Settings", "model") == "Sphere"


def test_write_all_without_h5py_skips_the_archive(port_result, tmp_path,
                                                  monkeypatch, caplog):
    """h5py is optional (the JAX package's rule): without it write_all
    logs and writes every other file."""
    from mcsas_tpu_torch.io import hdf

    def missing():
        raise ImportError("h5py is required for HDF5 archives")

    monkeypatch.setattr(hdf, "_h5py", missing)
    with caplog.at_level(logging.WARNING):
        written = api.OutputFiles(port_result,
                                  out_dir=tmp_path).write_all()
    assert "archive" not in written and set(written) == set(_KINDS)
    assert any("h5py" in r.message for r in caplog.records)


@pytest.mark.parametrize("kind", ("fit", "distributions", "statistics"))
def test_tables_equal_the_jax_package(pair, kind):
    """fit.dat, hist-*.dat and stats_*.dat of one contribution set: the
    same file names, rows and columns, and the same numbers at the
    format's precision ("{0: 14.6E}": rtol 1e-6)."""
    jfiles, pfiles = _files(pair["jax"], kind), _files(pair["port"], kind)
    assert ([os.path.basename(f) for f in jfiles]
            == [os.path.basename(f) for f in pfiles])
    for jf, pf in zip(jfiles, pfiles):
        j, p = _numbers(jf), _numbers(pf)
        assert j.shape == p.shape and j.size > 0
        np.testing.assert_allclose(p, j, rtol=1e-6, err_msg=pf)
        jhead = pathlib.Path(jf).read_text().splitlines()[0]
        assert pathlib.Path(pf).read_text().splitlines()[0] == jhead


def test_settings_equal_the_jax_package(pair):
    j = _sections(pair["jax"]["settings"])
    p = _sections(pair["port"]["settings"])
    assert list(p) == list(j) == ["I/O Settings", "MCSAS Settings",
                                  "Model Settings"]
    for section in j:
        assert p[section] == j[section], section


def test_contributions_pickle_equals_the_jax_package(pair):
    jb = pathlib.Path(pair["jax"]["contributions"]).read_bytes()
    assert pathlib.Path(pair["port"]["contributions"]).read_bytes() == jb


# ---------------------------------------------------------------- archive

def test_archive_round_trip_and_rehistogram(port_result, tmp_path):
    """The port's archive reloads to the same state, and re-histogramming
    from it equals result.histogram() at rtol 1e-8."""
    pytest.importorskip("h5py")
    from mcsas_tpu_torch.io.hdf import load_archive
    fn = api.OutputFiles(port_result, out_dir=tmp_path).write_archive()
    state = load_archive(fn)
    np.testing.assert_array_equal(state["contribs"], port_result.contribs)
    assert state["model"] == "Sphere"
    assert state["cfg"] == port_result.cfg
    assert state["data"].content_key() == port_result.data.content_key()
    bound = get_model(state["model"]).bind(
        active=state["active"],
        active_ranges=dict(zip(state["active"], state["ranges"])),
        fixed=state["fixed"])
    assert bound == port_result.bound
    specs = [HistogramSpec("radius", 1e-9, 1e-7, bin_count=25,
                           xscale="log", yweight=w) for w in ("vol", "num")]
    _, hists = histogram_all(np.transpose(state["contribs"], (2, 0, 1)),
                             state["data"], bound, state["cfg"], specs,
                             device="cpu")
    want = port_result.histogram(specs).histograms
    for h, w in zip(hists, want):
        np.testing.assert_allclose(h.bins.full, w.bins.full, rtol=1e-8)
        np.testing.assert_allclose(h.cdf.full, w.cdf.full, rtol=1e-8)


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_archive_loads_in_the_other_package(pair, writer, tmp_path):
    """An archive written by either package loads in the other: the same
    contributions, config, model binding, data and stored arrays."""
    pytest.importorskip("h5py")
    from mcsas_tpu.io import hdf as jhdf
    from mcsas_tpu_torch.io import hdf as phdf
    res = pair["pres"] if writer == "port" else pair["jres"]
    write, load = ((phdf.write_archive, jhdf.load_archive)
                   if writer == "port" else
                   (jhdf.write_archive, phdf.load_archive))
    fn = write(tmp_path / "a.hdf5", res)
    state = load(fn)
    np.testing.assert_array_equal(state["contribs"], res.contribs)
    assert state["cfg"].to_dict() == res.cfg.to_dict()
    assert (state["model"], state["active"]) == ("Sphere", ("radius",))
    assert state["ranges"] == list(res.bound.ranges)
    assert state["fixed"] == dict(res.bound.fixed)
    for name in ("q", "f", "fu", "raw"):
        np.testing.assert_array_equal(getattr(state["data"], name),
                                      getattr(res.data, name))
    for name in ("conval", "scaling", "background", "measval"):
        np.testing.assert_array_equal(state[name],
                                      getattr(res.engine, name))


# ----------------------------------------------------------- engine cache

def _scaled(raw, factor):
    """File columns q, I, σ[, …] with I and σ scaled by *factor*."""
    out = np.array(raw, np.float64)
    out[:, 1:3] *= factor
    return out


@pytest.fixture
def counted(monkeypatch):
    """An empty engine cache and the list of engines built through it."""
    built = []

    class Counting(McSASEngine):
        def __init__(self, *args, **kw):
            built.append(self)
            super().__init__(*args, **kw)

    monkeypatch.setattr(api, "McSASEngine", Counting)
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    return built


def test_cached_engine_repeats_bitwise(refdata, counted):
    """Two fit() calls of one (data, model, config, device) build one
    engine and give the same contributions bit for bit."""
    cfg = McSASConfig(**_TINY)
    a = mt.fit(refdata / _SPHERE, "Sphere", cfg, device="cpu")
    b = mt.fit(refdata / _SPHERE, "Sphere", cfg, device="cpu")
    assert len(counted) == 1
    np.testing.assert_array_equal(a.engine.contribs, b.engine.contribs)
    fresh = McSASEngine(a.data, a.bound, cfg, device="cpu").run()
    np.testing.assert_array_equal(fresh.contribs, a.engine.contribs)


@pytest.mark.parametrize("change", ("cfg", "device", "data", "env"))
def test_cached_engine_rebuilds_on_a_change(refdata, counted, change,
                                            monkeypatch):
    cfg = McSASConfig(**_TINY)
    d = data.load(refdata / _SPHERE)
    mt.fit(d, "Sphere", cfg, device="cpu")
    kw = dict(data=d, model="Sphere", cfg=cfg, device="cpu")
    if change == "cfg":
        kw["cfg"] = cfg.replace(seed=4)
    elif change == "device":
        kw["device"] = "cpu:0"
    elif change == "data":
        kw["data"] = data.from_raw(_scaled(d.raw, 2.0), title=d.title)
    else:
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    mt.fit(**kw)
    assert len(counted) == 2


def test_cached_engine_is_capped(refdata, counted):
    cfg = McSASConfig(**dict(_TINY, max_iterations=2, chunk_steps=2))
    d = data.load(refdata / _SPHERE)
    for seed in range(api._ENGINE_CACHE_CAP + 2):
        mt.fit(d, "Sphere", cfg.replace(seed=seed), device="cpu")
    assert len(api._ENGINE_CACHE) == api._ENGINE_CACHE_CAP
    assert len(counted) == api._ENGINE_CACHE_CAP + 2


def test_cached_engine_refuses_cuda_without_a_card(refdata):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        mt.fit(refdata / _SPHERE, "Sphere", McSASConfig(**_TINY))
    with pytest.raises(RuntimeError, match="is_available"):
        histogram_all(np.full((1, 2, 1), 1e-8),
                      data.load(refdata / _SPHERE),
                      get_model("Sphere").bind(), McSASConfig(**_TINY))


# --------------------------------------------------------------- run_files

def _series_files(refdata, tmp_path):
    """The Sphere file, the same with I and σ scaled × 2, and a byte copy
    of the first under another name."""
    from mcsas_tpu_torch.io import load_raw, write_ascii
    src = refdata / _SPHERE
    raw, _ = load_raw(src)
    files = [tmp_path / "sphere.dat", tmp_path / "sphere-x2.dat",
             tmp_path / "sphere-copy.dat"]
    shutil.copyfile(src, files[0])
    write_ascii(files[1], _scaled(raw, 2.0))
    shutil.copyfile(src, files[2])
    return files


def test_run_files_series(refdata, tmp_path, counted):
    """A series of 3 files: one engine for the two of the same content
    (the copy's contributions equal the first's bit for bit), every
    output set written, and the series table with the JAX package's
    header and one row per file and histogram."""
    files = _series_files(refdata, tmp_path)
    out = tmp_path / "out"
    cfg = McSASConfig(**dict(_TINY, series_stats=True))
    results = api.run_files([str(f) for f in files], model="Sphere",
                            cfg=cfg, out_dir=out, device="cpu")
    assert len(results) == 3 and len(counted) == 2
    np.testing.assert_array_equal(results[2].engine.contribs,
                                  results[0].engine.contribs)
    for res in results:
        assert set(res.output_files) == set(_KINDS) | {"archive"}
        assert os.path.exists(res.output_files["fit"])
        logs = glob.glob(os.path.join(os.path.dirname(
            res.output_files["fit"]), "*_log.txt"))
        assert len(logs) == 1
    series = glob.glob(str(out / "series statistics *.dat"))
    assert len(series) == 1
    lines = pathlib.Path(series[0]).read_text().strip().splitlines()
    from mcsas_tpu.post.histogram import Moments as JaxMoments
    assert lines[0].split() == ["param", "lower", "upper", "weighting",
                                "sample", *JaxMoments.FIELD_NAMES]
    assert len(lines) == 1 + 3 * len(results[0].histograms)
    assert [ln.split()[4] for ln in lines[1:]] == [
        "sphere", "sphere-x2", "sphere-copy"]


def test_run_files_refuses_cuda_without_a_card(refdata, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        api.run_files([str(refdata / _SPHERE)], cfg=McSASConfig(**_TINY),
                      out_dir=tmp_path)


# ------------------------------------------- reference crossvals (ported)

def _io_fixture():
    path = _TESTDATA / "reference_io_fixture.json"
    if not path.exists():
        pytest.skip("reference io fixture not generated "
                    "(tools/run_reference_io.py)")
    return json.loads(path.read_text())


def test_crossval_io_ascii_writer():
    """Port of test_reference_parity.py::test_crossval_io_ascii_writer:
    format_data is byte-identical to the reference's ArrayFile.formatData
    ("{0: 14.6E}" cells, space-separated)."""
    from mcsas_tpu_torch.io.ascii import format_data
    fix = _io_fixture()["ascii_write"]
    assert format_data(np.asarray(fix["data"])) == fix["text"]


def test_crossval_io_pdh_writer(tmp_path):
    """Port of test_reference_parity.py::test_crossval_io_pdh_writer: the
    PDH text the reference's two working pieces compose, byte for byte,
    and its reparse bit for bit."""
    from mcsas_tpu_torch.io.ascii import format_data
    from mcsas_tpu_torch.io.pdh import _header_lines, load_pdh
    fix = _io_fixture()["pdh_write"]
    assert fix["writer_error"].startswith("NameError")
    data_arr = np.asarray(fix["data"], np.float64)
    ours = ("\n".join(_header_lines(data_arr.shape[0],
                                    fix["description"]))
            + "\n" + format_data(data_arr))
    assert ours == fix["text"]
    reparsed = np.asarray(fix["reparsed"], np.float64)
    np.testing.assert_allclose(reparsed, data_arr, rtol=1e-6)
    pdh = tmp_path / "reference_io_roundtrip.pdh"
    pdh.write_text(ours + "\n", encoding="utf-8")
    assert np.array_equal(load_pdh(pdh), reparsed)


def test_crossval_series_statistics(tmp_path):
    """Port of test_reference_parity.py::test_crossval_series_statistics:
    the series accumulation and table (write_series_stats) against the
    reference's own Calculator series machinery on its three fixed
    contribution sets: moments at solver precision, the table's rows at
    the reference's format precision."""
    path = _TESTDATA / "reference_series_fixture.json"
    if not path.exists():
        pytest.skip("reference series fixture not generated "
                    "(tools/run_reference_series.py)")
    fix = json.loads(path.read_text())
    wl = fix["workload"]
    q = np.asarray(fix["q_binned"], np.float64)
    f = np.asarray(fix["f_binned"], np.float64)
    fu = np.asarray(fix["fu_binned"], np.float64)
    d = data.from_raw(np.column_stack([q * 1e-9, f, fu]),
                      title="series-crossval",
                      config=data.DataConfig(n_bin=0, fu_min=0.0))
    bound = get_model("Sphere").bind()
    cfg = McSASConfig()
    assert cfg.compensation_exponent == pytest.approx(
        wl["compensationExponent"], rel=1e-12)
    specs = [HistogramSpec(param="radius", lower=h["lo"], upper=h["hi"],
                           bin_count=h["binCount"], xscale=h["xscale"],
                           yweight=h["yweight"])
             for h in wl["histograms"]]
    assert tuple(wl["fieldNames"]) == Moments.FIELD_NAMES
    series = {}
    for title, fd in fix["files"].items():
        contribs = np.transpose(np.asarray(fd["contribs"], np.float64),
                                (2, 0, 1))
        _, hists = histogram_all(contribs, d, bound, cfg, specs,
                                 device="cpu")
        for h, ref_fields in zip(hists, fd["moments_fields"]):
            got = np.asarray(h.moments.fields, np.float64)
            ref = np.asarray(ref_fields, np.float64)
            np.testing.assert_allclose(
                got, ref, rtol=1e-6,
                atol=1e-6 * max(np.abs(ref).max(), 1e-300),
                err_msg=f"{title}:{h.spec.yweight}")
            key = (h.spec.param, h.spec.lower, h.spec.upper,
                   h.spec.yweight)
            series.setdefault(key, []).append((title, h.moments.fields))
    fn = api.write_series_stats(series, tmp_path)
    lines = pathlib.Path(fn).read_text().strip().split("\n")
    header = lines[0].split()
    ours = {}
    for line in lines[1:]:
        row = dict(zip(header, line.split()))
        ours[(row["sample"], row["weighting"])] = row
    fdat = fix["fileData"]
    n_rows = len(fdat["param"])
    assert len(ours) == n_rows
    for i in range(n_rows):
        key = (fdat["Data_object_title"][i].strip(),
               fdat["weighting"][i].strip())
        assert key in ours, f"row {key} missing from our table"
        row = ours[key]
        assert row["param"] == fdat["param"][i].strip()
        for col in ("lower", "upper") + tuple(wl["fieldNames"]):
            ref_v = float(fdat[col][i])
            got_v = float(row[col])
            assert got_v == pytest.approx(ref_v, rel=2e-6, abs=1e-12), (
                f"{key}:{col}: {got_v} vs reference {ref_v}")


# ----------------------------------------------------------- plugin models

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


@pytest.fixture
def registry():
    """The port's model registry, restored after the test."""
    from mcsas_tpu_torch.models import REGISTRY
    saved = dict(REGISTRY)
    yield REGISTRY
    REGISTRY.clear()
    REGISTRY.update(saved)


def test_load_model_dir(tmp_path, caplog, registry):
    """Port of test_api.py::test_load_model_dir: recursive walk, private
    files skipped, broken files warned about and skipped, the result
    priority-ordered; the plugins' module prefix is the port's."""
    import sys
    from mcsas_tpu_torch.models import load_model_dir
    (tmp_path / "zz_plugin.py").write_text(
        _USER_MODEL_SRC.format(name="ZzPlugin"))
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "aa_plugin.py").write_text(
        _USER_MODEL_SRC.format(name="AaPlugin"))
    (tmp_path / "prio.py").write_text(
        "from mcsas_tpu_torch.models import Sphere\n")
    (tmp_path / "broken.py").write_text("raise RuntimeError('nope')\n")
    (tmp_path / "_private.py").write_text(
        _USER_MODEL_SRC.format(name="NeverLoaded"))
    with caplog.at_level(logging.WARNING):
        found = load_model_dir(tmp_path)
    assert [m.name for m in found] == ["Sphere", "AaPlugin", "ZzPlugin"]
    assert "NeverLoaded" not in registry
    assert "AaPlugin" in registry and "ZzPlugin" in registry
    assert any("broken.py" in r.message for r in caplog.records)
    assert not any(m.startswith("mcsas_tpu.user.") for m in sys.modules)
    assert (registry["ZzPlugin"].ff.__module__
            == "mcsas_tpu_torch.user.zz_plugin")


def test_registry_order_equals_the_jax_package():
    from mcsas_tpu.models import MODELS as JAX_MODELS
    from mcsas_tpu_torch.models import MODELS, _PRIORITY
    from mcsas_tpu.models import _PRIORITY as JAX_PRIORITY
    assert [m.name for m in MODELS] == [m.name for m in JAX_MODELS]
    assert _PRIORITY == JAX_PRIORITY


def _plugin(tmp_path, name):
    from mcsas_tpu_torch.models import load_model_file
    src = tmp_path / f"{name.lower()}_plugin.py"
    src.write_text(_USER_MODEL_SRC.format(name=name))
    (model,) = load_model_file(str(src))
    return model


def test_plugin_fits_the_plain_chunk(refdata, tmp_path, registry):
    """An elementwise plugin in torch fits on the CPU through the plain
    version of K2's rows-in entry, the route it takes on the card: it has
    no device function of K1 — not even one registered under a
    built-in's name — and passes the JAX package's K1 gate."""
    plugin = _plugin(tmp_path, "Sphere")          # overwrites the built-in
    assert registry["Sphere"] is plugin
    res = mt.fit(refdata / _SPHERE, "Sphere", McSASConfig(**_TINY),
                 device="cpu")
    assert res.bound.model is plugin and res.engine.n_iter[0] > 0
    assert np.isfinite(res.fit_measval_mean).all()
    assert not (res.engine.used_pallas or res.engine.used_prefetch
                or res.engine.used_table)
    eng = McSASEngine(res.data, res.bound, McSASConfig(**_TINY),
                      device="cpu")
    assert not mc_kernel.supports(eng) and not eng.uses_table
    assert eng.prefetch_entry == "rows" and eng.runs_prefetch
    assert eng.seg_steps == _TINY["chunk_steps"]
    assert eng._kernel_eligible()
    with pytest.raises(ValueError, match="no device function"):
        mc_kernel.model_id(plugin)


def test_plugin_with_a_lookup_table_takes_k2(refdata, tmp_path, registry):
    """A plugin that declares a parameter table made with
    tables.make_lookup runs through K2's table entry (its plain version
    on the CPU) and fits."""
    base = _plugin(tmp_path, "TablePlugin")

    def factory(bound, q_grid, dtype, device):
        q = torch.as_tensor(np.asarray(q_grid, np.float64), dtype=dtype,
                            device=device)
        grid = tables.log_grid(*bound.ranges[0], 64)
        tab = tables.build_param_table(
            lambda v: base.ff(q, {"radius": v[:, :1]}), [grid], dtype,
            device=device)
        return tables.make_lookup(("radius",)), tab

    model = dataclasses.replace(base, elementwise_q=False,
                                ff_table_factory=factory)
    cfg = McSASConfig(**dict(_TINY, table_ff="on"))
    d = data.load(refdata / _SPHERE)
    eng = McSASEngine(d, model.bind(), cfg, device="cpu")
    assert eng.uses_table and eng.prefetch_entry == "table"
    res = mt.fit(d, model, cfg, device="cpu")
    assert res.engine.used_table and res.engine.n_iter[0] > 0


# ---------------------------------------------------------------- plotting

def _plot_fit(title, f, reps, seed):
    raw = np.column_stack([np.geomspace(0.1, 1, 40), f, 0.05 * np.ones(40)])
    cfg = McSASConfig(num_contribs=8, num_reps=reps, max_iterations=2000,
                      chunk_steps=64, candidates_per_step=2, seed=seed,
                      convergence_criterion=1e9, show_incomplete=True)
    return mt.fit(data.from_raw(raw, title=title), "Sphere", cfg,
                  device="cpu")


def test_plot_negative_intensity_no_warnings(tmp_path):
    """Port of test_api.py::test_plot_negative_intensity_no_warnings: the
    fit panel's y floor is the smallest positive intensity, and the
    layout does not warn."""
    import warnings
    from mcsas_tpu_torch.plotting import plot_results
    res = _plot_fit("neg-tail", np.linspace(1.0, -0.1, 40), 2, 5)
    out = tmp_path / "neg.pdf"
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        plot_results(res, output_filename=str(out))
    assert out.exists()


def test_plot_algo_info_and_partial_curves(tmp_path):
    """Port of test_api.py::test_plot_algo_info_and_partial_curves."""
    from mcsas_tpu_torch.plotting import _format_algo_info, plot_results
    res = _plot_fit("info-panel", np.linspace(1.0, 0.5, 40), 3, 7)
    info = _format_algo_info(res)
    for token in ("info-panel", "Background level", "Scaling factor",
                  "Timing: 3 repetitions", "Reduced χ²", "radius"):
        assert token in info, f"missing {token!r} in algo info:\n{info}"
    fig = plot_results(res, output_filename=str(tmp_path / "reps.pdf"),
                       show_reps=True, auto_close=False)
    try:
        fit_ax = fig.axes[1]          # [0] is the info strip
        assert sum(1 for ln in fit_ax.get_lines()
                   if ln.get_color() == "b") >= 3
    finally:
        import matplotlib.pyplot as plt
        plt.close(fig)


def test_write_all_and_series_plot(port_result, tmp_path):
    """write_all(plot=True) and plot_series_stats write their PDFs."""
    from mcsas_tpu_torch.plotting import plot_series_stats
    written = api.OutputFiles(port_result, out_dir=tmp_path).write_all(
        plot=True)
    assert os.path.getsize(written["plot"]) > 0
    h = port_result.histograms[0]
    series = {(h.spec.param, h.spec.lower, h.spec.upper, h.spec.yweight):
              [("a", h.moments.fields), ("b", h.moments.fields)]}
    fn = tmp_path / "series.pdf"
    plot_series_stats(series, output_filename=str(fn))
    assert fn.exists()
