# -*- coding: utf-8 -*-
"""K1's and K2's summation order, on the CPU.

The CUDA chunk kernel K1 (csrc/mc_chunk.cuh) and, at 8 lanes, the prefetch
kernel K2 (csrc/mc_prefetch.cuh) evaluate each candidate with a group of
G lanes over q: lane l adds the float64 terms of the points l,
l + G, l + 2G, ... one by one, and a butterfly tree over the lanes adds
the lane partials (csrc/mc_common.cuh, mc_group_sum).  The plain version
(ops/mc_kernel.py, chunk_reference) sums the same float32 terms in float64
in torch's order.  A float64 sum of 100 float32 terms is almost always
exact, so both orders should give every candidate the same float32 χ²;
where one does not, the candidate must be far from the step's decision.
These tests recompute every candidate's sums of 64 plain steps on each
suite row's data (the table-tier row 'cylinders-isotropic' through K2's
plain version) in the kernel's order and hold the χ² to the plain
version's.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch import load  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core import fitcore  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402
from mcsas_tpu_torch.tools.suite import ROWS  # noqa: E402

GROUPS = (8, 16, 32)       # the group widths K1 and its probe compile
STEPS = 64
NEAR_TIE = 1e-6
CYLINDER = "cylinders-isotropic"      # K2's row, on a 256-row table
DATASETS = ("sphere-headline", *sorted(ROWS), CYLINDER)
SPHERE = (pathlib.Path(__file__).resolve().parent.parent / "testdata"
          / "sasfit_sphere-10-1.dat")
_RECORDS = {}


def group_sum(terms, g):
    """The float64 sum over the last axis of *terms* in K1's order for a
    group of *g* lanes: lane l adds the points l, l + g, l + 2g, ... one
    by one, starting from 0.0; then a butterfly tree adds the lane
    partials, lane l taking v_l + v_(l xor off) for off = g/2, ..., 2, 1
    (every lane ends with the same bits: IEEE addition is commutative).
    At g = 8 that is ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7))."""
    terms = np.asarray(terms, np.float64)
    lanes = np.zeros(terms.shape[:-1] + (g,))
    for i in range(terms.shape[-1]):
        lanes[..., i % g] += terms[..., i]
    off = g // 2
    while off:
        lanes = lanes + lanes[..., np.arange(g) ^ off]
        off //= 2
    return lanes[..., 0]


def solve_scale_bg(sx, sxx, sxy, c, find_bg, pos_bg):
    """The closed-form solve of fitcore.solve_scale_bg (and the kernel's
    mc_solve_scale_bg) on given float64 sums; (a, b) in float32."""
    s_u, s_uy = c.s_u, c.s_uy
    with np.errstate(divide="ignore", invalid="ignore"):
        xx_zero = sxx <= 0.0
        a_nobg = np.where(xx_zero, 0.0, sxy / np.where(xx_zero, 1.0, sxx))
        a, b = a_nobg, np.zeros_like(a_nobg)
        if find_bg:
            denom = s_u * sxx
            det = denom - sx * sx
            degen = xx_zero | (det <= 1e-6 * denom)
            a_bg = (s_u * sxy - sx * s_uy) / np.where(degen, 1.0, det)
            b_bg = (s_uy - a_bg * sx) / s_u
            a = np.where(degen, a_nobg, a_bg)
            b = np.where(degen, (s_uy - a_nobg * sx) / s_u, b_bg)
            if pos_bg:
                neg = b < 0.0
                a = np.where(neg, a_nobg, a)
                b = np.where(neg, 0.0, b)
    return a.astype(np.float32), b.astype(np.float32)


def kernel_chi2(x, c, find_bg, pos_bg, g):
    """χ² of candidates *x* (..., Nq) float32 as K1 computes them with
    groups of *g* lanes: float32 products, float64 sums in the group
    order, the closed-form solve, the residual pass, NaN as +inf."""
    u, y = c.u.numpy(), c.y.numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        ux = u * x
        sx = group_sum(ux, g)
        sxx = group_sum(ux * x, g)
        sxy = group_sum(ux * y, g)
        a, b = solve_scale_bg(sx, sxx, sxy, c, find_bg, pos_bg)
        res = (y - a[..., None] * x) - b[..., None]
        chi = (group_sum((u * res) * res, g) / c.n).astype(np.float32)
    return np.where(np.isnan(chi), np.float32(np.inf), chi)


def _engine(name):
    """A CPU engine on the dataset's model, data and active set: N=40,
    R=2, its K and local moves."""
    if name == "sphere-headline":
        data = load(SPHERE)
        cfg = McSASConfig(num_contribs=40, num_reps=2, chunk_steps=STEPS,
                          candidates_per_step=128, local_moves=0.5, seed=5)
        return McSASEngine(data, get_model("Sphere").bind(), cfg,
                           device="cpu")
    if name == CYLINDER:
        cfg = suite.cylinder_config(num_contribs=40, num_reps=2,
                                    chunk_steps=STEPS)
        return McSASEngine(suite.cylinder_golden(), suite.cylinder_bound(),
                           cfg, device="cpu")
    row = ROWS[name]
    data = row.load()
    cfg = row.config(num_contribs=40, num_reps=2, chunk_steps=STEPS)
    return McSASEngine(data, row.bound(data), cfg, device="cpu")


def _records(name, monkeypatch):
    """(engine, [x of each step (R, K, Nq)], trace) of 64 plain steps."""
    if name not in _RECORDS:
        with monkeypatch.context() as mp:
            mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "256")
            mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
            eng = _engine(name)
        eng.gen.manual_seed(3)
        state = eng._init_batch()
        props = eng._draw_chunk_proposals(n_steps=STEPS)
        xs = []

        def recording(x, c, find_bg, pos_bg):
            xs.append(x.numpy().copy())
            return fitcore.solve_scale_bg(x, c, find_bg, pos_bg)

        trace = {}
        with monkeypatch.context() as mp:
            mp.setattr(mc_kernel, "solve_scale_bg", recording)
            if eng.uses_table:
                assert eng.seg_steps == STEPS
                mc_kernel.prefetch_table_reference(
                    state, 0, eng.consts, eng.spec,
                    mc_kernel.segment_candidates(state, 0, eng.spec, props),
                    trace=trace)
            else:
                mc_kernel.chunk_reference(state, 0, eng.consts, eng.spec,
                                          props, trace=trace)
        assert len(xs) == STEPS
        assert int((trace["choice"] >= 0).sum()) > 0
        _RECORDS[name] = (eng, xs, trace)
    return _RECORDS[name]


def test_group_sum_order():
    """The order pins which partials meet first: with g = 8 the terms of
    lanes 0 and 4 cancel before the 1.0 of lane 2 joins them; a serial
    sum loses that 1.0."""
    t = np.zeros(8)
    t[0], t[2], t[4] = 1e17, 1.0, -1e17
    assert group_sum(t, 8) == 1.0
    assert sum(t) == 0.0
    rng = np.random.default_rng(0)
    v = rng.standard_normal(37)
    p = [sum(v[l::8]) for l in range(8)]
    want = ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]))
    assert group_sum(v, 8) == want


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("name", DATASETS)
def test_kernel_order_gives_the_plain_chi2(name, g, monkeypatch):
    """Every candidate's χ² of 64 plain steps, recomputed in K1's order
    at g lanes (K2's, at 8), equals the plain version's in float32; a
    candidate where it does not is neither step's best and lies more than
    1e-6 (relative) above the best, so the step decides the same way."""
    eng, xs, trace = _records(name, monkeypatch)
    spec = eng.spec
    plain = trace["chi"].numpy()                             # (S, R, K)
    conval = trace["conval"].numpy()
    kern = np.stack([kernel_chi2(x, eng.consts, spec.find_bg, spec.pos_bg,
                                 g) for x in xs])
    assert kern.shape == plain.shape
    differ = kern != plain
    for s, r, k in zip(*np.nonzero(differ)):
        best = plain[s, r].min()
        assert k != plain[s, r].argmin() and k != kern[s, r].argmin(), (
            s, r, k)
        gap = min(float(plain[s, r, k]), float(kern[s, r, k])) - float(best)
        assert gap > NEAR_TIE * abs(float(best)), (s, r, k, gap)
    # the same decisions: the first minimum and the accept
    np.testing.assert_array_equal(kern.argmin(-1), plain.argmin(-1))
    np.testing.assert_array_equal(kern.min(-1) < conval,
                                  plain.min(-1) < conval)
