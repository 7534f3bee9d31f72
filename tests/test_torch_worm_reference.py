# -*- coding: utf-8 -*-
"""PyTorch port, the Kholodenko worm against the benchmark's plain float64
reference (``benchmark/reference/models/Kholodenko.py``, Gauss-Legendre
panels sized to the oscillation, nothing of the port): the converged
Filon/Boole rule's form factor, the post pass's float64 bank, the table
lookup at a small resolution, and the reference against upstream's own
values (``testdata/reference_ff_fixture.json``).  Parameters are seeded
random draws in upstream's active ranges (radius 1-5 nm, lenKuhn 10-50
nm, lenContour 100-1000 nm) on q from 0.01 to 10 nm⁻¹, the worm cell's
grid."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.reference import core, models  # noqa: E402
from mcsas_tpu_torch import data  # noqa: E402
from mcsas_tpu_torch.models import chains, get_model  # noqa: E402
from mcsas_tpu_torch.post import histogram  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = models.get("Kholodenko")
NAMES = ("radius", "lenKuhn", "lenContour")
CONFIG = json.loads((ROOT / "benchmark/configs/worm-k2xs.json").read_text())


def _draw(n, seed):
    """*n* parameter sets (n, 3), log-uniform radius, uniform lengths."""
    rng = np.random.default_rng(seed)
    return np.stack([np.exp(rng.uniform(np.log(1e-9), np.log(5e-9), n)),
                     rng.uniform(1e-8, 5e-8, n),
                     rng.uniform(1e-7, 1e-6, n)], axis=-1)


def _q(n):
    return torch.as_tensor(np.geomspace(0.01, 10.0, n) * 1e9)


def _ref_ff(q, vals):
    v = torch.as_tensor(vals)
    return REF.ff(q, {k: v[..., i:i + 1] for i, k in enumerate(NAMES)})


def test_converged_rule_agrees_with_the_reference():
    """p0² of the port's rule within 5e-6 relative of the reference's
    (the rule is O(h⁴) on its 513-node grid, held to 1e-6 of adaptive
    quadrature at the JAX package's sample points; over these draws it
    reads 1.2e-6 at most, the reference 4e-13 of adaptive quadrature),
    and ff within 1e-7 of each curve's largest |ff| (the cross-section
    multiplies both; near its zeros the relative error of the product
    has no meaning, 1.4e-8 measured)."""
    vals = _draw(24, 22)
    q = _q(64)
    pd = get_model("Kholodenko").bind().pdict(torch.as_tensor(vals[:, None]))
    t = q * pd["lenKuhn"] / 3.0
    x = 3.0 * pd["lenContour"] / pd["lenKuhn"]
    ours = chains._kho_p0_sq_conv(t, x).numpy()
    ref = REF.p0_squared(t, x).numpy()
    assert np.max(np.abs(ours - ref) / ref) < 5e-6
    ff = chains._kho_ff(q, pd).numpy()
    want = _ref_ff(q, vals).numpy()
    assert np.all(np.abs(ff - want).max(-1)
                  <= 1e-7 * np.abs(want).max(-1))


def test_post_pass_bank_agrees_with_the_reference_rows():
    """The port's float64 bank of 2 × 8 contributions on a 32-point grid
    (ff²·v^(2c), the eager bank on the CPU) against ``core.rows`` of the
    plain reference, within 2e-7 of each row's largest value (twice the
    form factor's tolerance: the bank squares it)."""
    vals = _draw(16, 23).reshape(2, 8, 3)
    q_nm = np.geomspace(0.01, 10.0, 32)
    d = data.from_raw(np.column_stack([q_nm, np.ones(32), np.full(32, 0.01)]),
                      config=data.DataConfig(n_bin=0))
    assert np.allclose(d.q, q_nm * 1e9, rtol=1e-15)
    bound = get_model("Kholodenko").bind()
    comp2 = 2.0 * CONFIG["compensationExponent"]
    bank = histogram._bank_f64(bound, d, comp2,
                               torch.as_tensor(vals)).numpy()
    rows = core.rows(CONFIG, np.asarray(d.q), vals, False).numpy()
    assert bank.shape == rows.shape == (2, 8, 32)
    assert np.all(np.abs(bank - rows).max(-1) <= 2e-7 * rows.max(-1))


def test_table_lookup_is_fit_grade_against_the_reference(monkeypatch):
    """The table K2 blends, baked at 16 nodes an axis
    (MCSAS_TPU_TABLE_RES_CAP), times the exact cross-section, against
    the reference on 40 draws: within the table's stated fit-grade
    contract (``ops.tables.FIT_GRADE_MEDIAN``, ``FIT_GRADE_P90`` of
    |Δff²| / (ff² + 1e-6·max)); the 16 × 16 table reads a median 6e-4
    and a 90th percentile 1.5e-3."""
    from mcsas_tpu_torch.ops import tables
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    monkeypatch.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
    bound = get_model("Kholodenko").bind()
    q = _q(64)
    lookup, tab = bound.model.ff_table_factory(bound, q.numpy(),
                                               torch.float32,
                                               torch.device("cpu"))
    assert tuple(tab.values.shape) == (16 * 16, 64)
    assert lookup.row_factor == ("cross_section", "radius")
    vals = _draw(40, 24)
    approx = lookup(tab, bound.pdict(torch.as_tensor(
        vals, dtype=torch.float32))).double().numpy()
    e2 = _ref_ff(q, vals).numpy() ** 2
    errs = (np.abs(approx ** 2 - e2)
            / (e2 + 1e-6 * e2.max(-1, keepdims=True))).ravel()
    assert np.median(errs) < tables.FIT_GRADE_MEDIAN
    assert np.percentile(errs, 90) < tables.FIT_GRADE_P90


def test_reference_matches_upstream_values():
    """Upstream's ff (scipy adaptive quad, epsrel 1e-10) for its 3
    parameter sets on 64 q points: every point within 1e-8 of the
    curve's largest |ff| (2.8e-9 measured: the fixture's own quadrature
    error at the highest q), and the volume π·r²·L."""
    fix = json.loads((ROOT / "testdata/reference_ff_fixture.json")
                     .read_text())
    q = torch.tensor(fix["q"], dtype=torch.float64)
    entries = fix["models"]["Kholodenko"]
    assert len(entries) == 3 and q.numel() == 64
    for e in entries:
        p = {k: float(v) for k, v in e["params"].items()}
        got = REF.ff(q, p).numpy()
        want = np.asarray(e["ff"])
        assert np.max(np.abs(got - want)) <= 1e-8 * np.abs(want).max()
        assert REF.volume(p) == pytest.approx(e["volume"], rel=1e-12)
