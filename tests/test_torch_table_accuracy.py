# -*- coding: utf-8 -*-
"""PyTorch port: the production parameter tables of the ellipsoid and the
Kholodenko worm (no resolution cap) against their exact float64 form
factors — the JAX package's test_ellipsoid_table_accuracy and
test_kholodenko_table_accuracy (tests/test_tables.py) at their limits.
The two full bakes take most of this file's time on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch.models import ellipsoids, get_model  # noqa: E402

NM = 1e-9
Q = np.geomspace(1.05e6, 9.64e9, 100)   # the sasfit_sphere SI q grid


@pytest.fixture(autouse=True)
def full_tables(monkeypatch):
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    monkeypatch.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)


def _errs(e2, a2):
    floor = 1e-6 * e2.max(axis=-1, keepdims=True)
    return (np.abs(a2 - e2) / (np.abs(e2) + floor)).ravel()


def test_ellipsoid_table_accuracy():
    """The JAX package's test_ellipsoid_table_accuracy: the production
    4096-row table (no resolution cap) against the converged n=801 rule in
    float64 on 100 random radii, at its limits (median < 1e-3, p90 <
    1e-2, p99 < 0.1 of |Δff²| / (ff² + 1e-6·max))."""

    bound = get_model("EllipsoidsIsotropic").bind(
        active=("a",), active_ranges={"a": (0.5 * NM, 300 * NM)})
    lookup, table = bound.model.ff_table_factory(bound, Q, torch.float32,
                                                 torch.device("cpu"))
    assert tuple(table.values.shape) == (4096, 100)
    rs = np.random.default_rng(7)
    lo, hi = bound.ranges[0]
    vals = np.exp(rs.uniform(np.log(lo), np.log(hi), (100, 1)))
    pd = bound.pdict(torch.as_tensor(vals[:, None, :]))
    qt = torch.as_tensor(Q)
    exact = ellipsoids._ell_iso_ff_uv(qt * pd["a"],
                                      qt * ellipsoids._ell_iso_rc(pd), 801,
                                      torch.float64).numpy()
    approx = lookup(table, bound.pdict(torch.as_tensor(
        vals, dtype=torch.float32))).double().numpy()
    errs = _errs(exact ** 2, approx ** 2)
    assert np.median(errs) < 1e-3
    assert np.percentile(errs, 90) < 1e-2
    assert np.percentile(errs, 99) < 1e-1


def test_kholodenko_table_accuracy():
    """The JAX package's test_kholodenko_table_accuracy: the production
    256 × 48 table (no resolution cap) against the exact float64 ff on
    100 random parameter sets, at its limits (median < 1e-3, p90 < 1e-2,
    p99 < 0.2 of |Δff²| / (ff² + 1e-6·max))."""
    bound = get_model("Kholodenko").bind()
    lookup, table = bound.model.ff_table_factory(bound, Q, torch.float32,
                                                 torch.device("cpu"))
    assert tuple(table.values.shape) == (256 * 48, 100)
    rs = np.random.default_rng(7)
    vals = np.stack([[np.exp(rs.uniform(np.log(lo), np.log(hi)))
                      for lo, hi in bound.ranges] for _ in range(100)])
    exact = bound.ff(torch.as_tensor(Q), torch.as_tensor(vals[:, None, :]))
    approx = lookup(table, bound.pdict(torch.as_tensor(vals,
                                                       dtype=torch.float32)))
    errs = _errs(exact.numpy() ** 2, approx.double().numpy() ** 2)
    assert np.median(errs) < 1e-3
    assert np.percentile(errs, 90) < 1e-2
    assert np.percentile(errs, 99) < 2e-1
