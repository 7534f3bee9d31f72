"""The plain reference and the frame generator, on the CPU: determinism,
closed forms, upstream's form factors and the repository's cylinder
golden."""
import json
import math

import numpy as np
import pytest
import torch

from conftest import ROOT
from benchmark import run
from benchmark.reference import core, models, prep

SPHERE = json.loads((ROOT / "benchmark/traffic/sphere-series.json")
                    .read_text())
FrameSource = run.generator(SPHERE["generator"])
CONFIG = json.loads((ROOT / "benchmark/configs/sphere-k128.json")
                    .read_text())


def _small(traffic, **kw):
    return {**traffic, "basis_nodes": 128, "strata": 8, **kw}


def test_frames_are_deterministic_in_seed_and_frame():
    a = FrameSource(_small(SPHERE), 2 ** 31 + 77)
    b = FrameSource(_small(SPHERE), 2 ** 31 + 77)
    c = FrameSource(_small(SPHERE), 5)
    for i in (-2, -1, 0, 3, 7, 8, 21):
        assert np.array_equal(a.frame(i), b.frame(i))
        assert a.fit_seed(i) == b.fit_seed(i)
    # another seed: the same set of fits, in another order
    first = sorted((a.stratum(i), a.fit_seed(i)) for i in range(16))
    other = sorted((c.stratum(i), c.fit_seed(i)) for i in range(16))
    assert first == other
    assert [a.stratum(i) for i in range(8)] != [c.stratum(i)
                                               for i in range(8)]
    raw = a.frame(0)
    assert raw.shape == (501, 3) and raw[:, 1].max() == 1.0
    assert np.allclose(raw[:, 2], 0.01 * raw[:, 1], rtol=0, atol=0)


def test_strata_cover_the_ranges():
    src = FrameSource(_small(SPHERE), 1)
    lo, hi = SPHERE["mean_nm"]
    assert lo < src.means.min() < src.means.max() < hi
    assert np.allclose(np.diff(np.log(src.means)), np.log(hi / lo) / 8)
    assert np.allclose(src.widths, 0.1)
    assert sorted(src.order) == list(range(8))


def test_sphere_closed_form_and_upstream():
    q = torch.tensor([math.pi, 4.493409457909064, 1e-5], dtype=torch.float64)
    f = models.Sphere.ff(q, {"radius": torch.tensor(1.0,
                                                    dtype=torch.float64)})
    assert float(f[0]) == pytest.approx(3.0 / math.pi ** 2, rel=1e-14)
    assert abs(float(f[1])) < 1e-14           # tan x = x: the first zero
    assert float(f[2]) == pytest.approx(1.0, abs=1e-10)
    fix = json.loads((ROOT / "testdata/reference_ff_fixture.json")
                     .read_text())
    qq = torch.tensor(fix["q"], dtype=torch.float64)
    for e in fix["models"]["Sphere"]:
        p = {"radius": torch.tensor(e["params"]["radius"],
                                    dtype=torch.float64)}
        assert np.allclose(models.Sphere.ff(qq, p).numpy(), e["ff"],
                           rtol=1e-9, atol=1e-12)
        assert float(models.Sphere.volume(p)) == pytest.approx(
            e["volume"], rel=1e-12)


def test_cylinder_matches_upstream_form_factors():
    fix = json.loads((ROOT / "testdata/reference_ff_fixture.json")
                     .read_text())
    q = torch.tensor(fix["q"], dtype=torch.float64)
    for e in fix["models"]["CylindersIsotropic"]:
        p = {**models.get("CylindersIsotropic").DEFAULTS,
             **{k: float(v) for k, v in e["params"].items()}}
        p["radius"] = torch.tensor(p["radius"], dtype=torch.float64)
        got = models.get("CylindersIsotropic").ff(q, p).numpy()
        # upstream evaluated J1 and the rule its own way: 7e-7 apart
        assert np.allclose(got, e["ff"], rtol=2e-6, atol=1e-12)
        vol = float(models.get("CylindersIsotropic").volume(p))
        assert vol == pytest.approx(e["volume"], rel=1e-12)


def test_cylinder_matches_the_repository_golden_at_10_nm():
    from mcsas_tpu_torch.tools.suite import cylinder_golden
    golden = cylinder_golden()
    p = {**models.get("CylindersIsotropic").DEFAULTS, "intDiv": 801,
         "radius": torch.tensor(10e-9, dtype=torch.float64)}
    f = models.get("CylindersIsotropic").ff(
        torch.as_tensor(golden.q, dtype=torch.float64), p).numpy()
    i = f * f / (f * f).max()
    # the golden's J1 is Abramowitz and Stegun's (1e-8 absolute)
    assert np.max(np.abs(i - golden.f)) < 1e-7
    assert np.allclose(i, golden.f, rtol=1e-4, atol=1e-9)


def test_cylinder_frames_follow_the_basis():
    cyl = json.loads((ROOT / "benchmark/traffic/cylinder-series.json")
                     .read_text())
    src = FrameSource({**cyl, "basis_nodes": 16, "strata": 4,
                              "quad_nodes": 101}, 3)
    raw = src.frame(0)
    assert raw.shape == (100, 3) and raw[0, 1] == pytest.approx(
        raw[:, 1].max())


def test_slit_weights_integrate_the_profile():
    q = np.geomspace(0.01, 2.0, 100) * 1e9
    locs, w = prep.slit(q, {"n_steps": 25, "umbra": 0.05e9,
                            "penumbra": 0.2e9})
    assert locs.shape == (100, 26) and np.allclose(locs[:, 0], q)
    # 2·∫ of the trapezoid profile from 0 to penumbra/2
    c, d = 0.05, 0.2
    exact = 2.0 * (c + ((d * 0.1 - 0.005) - (d * c - c * c / 2)) / (d - c)) \
        / (c + d)
    assert w.sum() == pytest.approx(exact, rel=2e-2)


def test_rebin_and_uncertainty_floor():
    q = np.arange(1.0, 11.0)
    f = np.linspace(2.0, 1.0, 10)
    raw = np.column_stack([q, f, np.full(10, -1.0)])
    fg = prep.derive(raw, {"n_bin": 3, "fu_min": 0.01})
    assert 1 <= fg["q"].size <= 3
    whole = prep.derive(raw, {"n_bin": 0, "fu_min": 0.01})
    assert np.allclose(whole["sigma"], 0.01 * f)
    assert np.allclose(whole["q"], q * 1e9)
    # a bin's σ: the larger of the standard error and the propagated one
    qb, fb, fub = prep.rebin_log(q, f, 0.01 * f, 2)
    m = q >= np.logspace(0, np.log10(10.1), 3)[1]
    assert fb[1] == pytest.approx(f[m].mean())
    assert fub[1] == pytest.approx(max(f[m].std(ddof=1) / math.sqrt(m.sum()),
                                       math.sqrt(((0.01 * f[m]) ** 2)
                                                 .mean())))


def test_solve_recovers_scale_and_background():
    x = torch.linspace(1.0, 3.0, 50, dtype=torch.float64)[None]
    y = (2.5e-3 * x + 0.7)[0].numpy()
    a, b, chi2 = core.solve(x, y, np.full(50, 0.1), CONFIG)
    assert float(a) == pytest.approx(2.5e-3, rel=1e-12)
    assert float(b) == pytest.approx(0.7, rel=1e-12)
    assert float(chi2) < 1e-20
    a, b, _ = core.solve(x, (2.5e-3 * x - 0.7)[0].numpy(), np.full(50, 0.1),
                         {**CONFIG, "positiveBackground": True})
    assert float(b) == 0.0


def test_post_outputs_fractions_and_histogram():
    contribs = np.array([[[2e-9], [3e-9], [5e-9]]])           # (1, 3, 1)
    q = np.geomspace(1e8, 3e9, 20)
    ft = core.rows(CONFIG, q, contribs, False).sum(1)
    scale = 4.0 / float(ft.max())
    y = (scale * ft + 0.01)[0].numpy()
    fg = {"q": q, "y": y, "sigma": 0.01 * y}
    out = core.post_outputs(CONFIG, fg, contribs)
    v = 4.0 / 3.0 * math.pi * contribs[0, :, 0] ** 3
    assert out["scaling"][0, 0] == pytest.approx(scale, rel=1e-9)
    assert out["scaling"][1, 0] == pytest.approx(0.01, rel=1e-6)
    assert np.allclose(out["vol_fraction"][:, 0],
                       v ** (2 * 0.6666666) * scale / (v * 1e28), rtol=1e-9)
    assert out["hist"].sum() == pytest.approx(out["vol_fraction"].sum())
    assert out["hist"].shape == (50, 1)


def test_judge_and_control_rounding():
    contribs = np.array([[[2e-9], [3e-9]], [[4e-9], [6e-9]]])
    q = np.geomspace(1e8, 3e9, 20)
    ft = core.rows(CONFIG, q, contribs[:1], True).sum(1)
    y = (ft / ft.max())[0].numpy()
    fg = {"q": q, "y": y, "sigma": 0.01 * y}
    ref = core.reference(CONFIG, fg, contribs)
    gaps = core.judge(ref, ref, fg, [True, True])
    assert all(v == 0.0 for v in gaps.values())
    low = core.reference(CONFIG, fg, contribs, core.bfloat16)
    assert core.judge(low, ref, fg, [True, True])["chi2_gap"] > 1e-3
    assert core.judge(low, ref, fg, [False, False])["chi2_gap"] is None
    t = torch.tensor([1.0 + 2 ** -10, math.pi], dtype=torch.float64)
    assert torch.all((core.bfloat16(t) - t).abs() <= t * 2 ** -8)
