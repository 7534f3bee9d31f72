# -*- coding: utf-8 -*-
"""PyTorch port: the post pass's bank kernel of the Kholodenko worm
(ops/kho_bank.py, csrc/kho_bank.cu).  On the CPU: what its wrapper builds,
the struct a launch and a shape query fill, and its operation count (its
route, its wrapper's refusals, its struct against the C source and the CPU
post pass, which keeps the eager bank and needs no library, are tested
with the cylinder's in ``tests/test_torch_bank_route.py``).  On the card
(marked ``cuda``, skipped without one; the CUDA kernel has no CPU mode):
the kernel against the eager bank at the worm cell's size and on each
branch of the rule, the float64 post pass through it, one launch a post
pass and its counters (a worm engine's prewarm, which builds the kernel's
library, is in ``tests/test_torch_prewarm.py``).  On a machine with a card
and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kho_bank.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bank_cases import (WORM_Q_NM, WORM_RANGES, contribs,  # noqa: E402
                        frames, worm)
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.models import chains  # noqa: E402
from mcsas_tpu_torch.ops import (bank_route, cuda_lib, kho_bank,  # noqa: E402
                                 special)
from mcsas_tpu_torch.post import histogram  # noqa: E402
from mcsas_tpu_torch.utils import profiling  # noqa: E402

RTOL = 1e-10       # float64 on both sides; the math library's last bit


def _data(q_nm=WORM_Q_NM, smear=False):
    return frames(q_nm, smear)


# ------------------------------------------------------------- the wrapper

@pytest.mark.parametrize("case", ["unsmeared", "slit", "fixed-radius"])
def test_bank_inputs_shapes_dtypes_and_values(case):
    """bank_inputs: the grid (Nq, n_off) with smear_w where smeared, one
    float64 value a contribution, each computed as the eager bank computes
    it (x = 3·contour/kuhn, w = volume^comp2; a fixed parameter broadcast),
    and the rule's constants as the plain version rounds them."""
    if case == "fixed-radius":
        bound = worm(active=("lenKuhn", "lenContour"),
                     active_ranges={k: WORM_RANGES[k] for k in
                                    ("lenKuhn", "lenContour")},
                     fixed={"radius": 2e-9})
    else:
        bound = worm()
    d = _data(smear=case == "slit")
    c = torch.as_tensor(contribs(bound, 2, 5))
    inp = kho_bank.bank_inputs(bound, d, 4.0 / 3.0, c)
    n_off = 26 if case == "slit" else 1
    assert tuple(inp.grid.shape) == (100, n_off)
    assert (inp.smear_w is None) is (case != "slit")
    if case == "slit":
        assert tuple(inp.smear_w.shape) == (26,)
        np.testing.assert_array_equal(inp.grid.numpy(), d.locs)
    else:
        np.testing.assert_array_equal(inp.grid[:, 0].numpy(), d.q)
    for name in ("radius", "kuhn", "x", "weight"):
        t = getattr(inp, name)
        assert tuple(t.shape) == (10,) and t.is_contiguous(), name
    for t in inp:
        if t is not None:
            assert t.dtype == torch.float64 and t.device == c.device
    pd = bound.pdict(c.reshape(-1, c.shape[-1])[:, None, :])
    np.testing.assert_array_equal(
        inp.x.numpy(), (3.0 * pd["lenContour"] / pd["lenKuhn"])
        .reshape(-1).numpy())
    np.testing.assert_array_equal(
        inp.weight.numpy(),
        (bound.model.volume(pd) ** (4.0 / 3.0)).reshape(-1).numpy())
    if case == "fixed-radius":
        assert (inp.radius == 2e-9).all()
    rule = inp.rule.numpy()
    assert rule.shape == (kho_bank.RULE_VALUES,) == (342,)
    n_t, n_l = kho_bank.N_TAIL, kho_bank.N_LAG
    np.testing.assert_array_equal(rule[:n_t], chains._TAIL_NODES)
    np.testing.assert_array_equal(rule[n_t:2 * n_t], chains._TAIL_WEIGHTS)
    u = special._SI_LAG_X
    np.testing.assert_array_equal(rule[2 * n_t:2 * n_t + n_l], u * u)
    np.testing.assert_array_equal(rule[-kho_bank.N_TAYLOR:],
                                  special._SI_TAYLOR)


def _inputs(smear=False):
    bound = worm()
    rset = torch.as_tensor(contribs(bound, 2, 5))
    return kho_bank.bank_inputs(bound, _data(smear=smear), 4.0 / 3.0, rset)


@pytest.mark.parametrize("smear", [False, True])
def test_launch_and_shape_fill_the_struct(smear, monkeypatch):
    """With the device checks passed, run_kho_bank and launch_shape hand
    the kernel the inputs' pointers, the rule's sizes from the modules
    that define it (513 nodes, Z_CUT 40, Si's switch at 6, 64 tail and 64
    Laguerre nodes, 22 Taylor terms) and the output; each launch counts
    once, and ``post.bank.kernel`` under recording()."""
    calls = []
    monkeypatch.setattr(kho_bank, "_check", lambda inp: None)
    monkeypatch.setattr(cuda_lib, "device_index", lambda dev: 0)
    monkeypatch.setattr(cuda_lib, "launch", lambda entry, prm, dev:
                        calls.append(("launch", entry, prm)))
    monkeypatch.setattr(cuda_lib, "shape", lambda entry, prm:
                        calls.append(("shape", entry, prm)) or {"threads": 1})
    inp = _inputs(smear=smear)
    before = kho_bank.run_kho_bank.launches
    with profiling.recording() as rec:
        out = kho_bank.run_kho_bank(inp)
    assert tuple(out.shape) == (10, 100) and out.dtype == torch.float64
    assert kho_bank.launch_shape(inp) == {"threads": 1}
    assert kho_bank.run_kho_bank.launches == before + 1
    assert rec.counters.get("post.bank.kernel") == 1
    assert "post.bank.eager" not in rec.counters
    (_, e1, launch), (_, e2, shape) = calls
    assert e1 == e2 == kho_bank.ENTRY
    assert launch.out == out.data_ptr() and not shape.out
    for prm in (launch, shape):
        assert prm.grid == inp.grid.data_ptr()
        assert (prm.smear_w or None) == (inp.smear_w.data_ptr() if smear
                                         else None)
        for name in ("radius", "kuhn", "x", "weight", "rule"):
            assert getattr(prm, name) == getattr(inp, name).data_ptr()
        assert (prm.n_contribs, prm.nq, prm.n_off) == (
            10, 100, 26 if smear else 1)
        assert (prm.n_steps, prm.n_tail, prm.n_lag, prm.n_taylor) == (
            512, 64, 64, 22)
        assert (prm.z_cut, prm.si_cut, prm.device) == (40.0, 6.0, 0)


# --------------------------------------------------------- the CPU's bank

# ------------------------------------------------- the kernel's bound

def _one_output(q, radius, kuhn, contour, smear_w=None):
    """BankInputs of one contribution on the grid row *q* (one entry an
    offset)."""
    f64 = torch.float64

    def one(v):
        return torch.as_tensor([v], dtype=f64)
    return kho_bank.BankInputs(
        grid=torch.as_tensor([q], dtype=f64),
        smear_w=(None if smear_w is None
                 else torch.as_tensor(smear_w, dtype=f64)),
        radius=one(radius), kuhn=one(kuhn), x=one(3.0 * contour / kuhn),
        weight=one(1.0), rule=kho_bank.rule_constants("cpu"))


# the node arrays of one contribution: 513 nodes of 7, 512 with z > 0 (2),
# those below z = 0.1 on the series (6) and the rest on the closed form
# (4), the set-up (5) and the output's product with w (1)
def _nodes(below_01):
    return 513 * 7 + 512 * 2 + below_01 * 6 + (513 - below_01) * 4 + 5 + 1


# x = 3 (h = 3/512: 18 nodes below 0.1) and x = 300 (h = 40/512: 2 nodes)
_ELEMENT = 7 + 6                  # t, e or F, e h; the end
_SUB = 2 + 10 * 512               # sinh and cosh; the recurrence
_SUP = 2 + 8 * 512 + 22           # sin and cos; the rotation; the assembly


@pytest.mark.parametrize("case,want", [
    # q 1e7 m⁻¹, kuhn 30 nm: t = 0.1, x = 3; qr 0.02 on J1's polynomial
    ("sub", _nodes(18) + _ELEMENT + _SUB + 1 + 17),
    # q 1e9, kuhn 30 nm: t = 10, F h 0.059 (Filon closed), F X 29.8 (Si
    # Laguerre: 1 + 4 + 6·63 + 7)
    ("sup", _nodes(18) + _ELEMENT + _SUP + 23 + 390 + 1 + 17),
    # q 2e8, kuhn 30 nm: t = 2, F h 0.01 (series), F X 5.2 (Taylor 44)
    ("sup-series", _nodes(18) + _ELEMENT + _SUP + 19 + 44 + 1 + 17),
    # x = 300 > Z_CUT: the tail (2 + 64 nodes of 23 on the sub branch)
    ("tail", _nodes(2) + _ELEMENT + _SUB + 2 + 64 * 23 + 17),
    # radius 1e-17: j1_over_x's limit (3); a slit of two offsets adds the
    # weight's product and sum (2) to each element
    ("slit", _nodes(18) + 2 * (_ELEMENT + 2 + _SUB + 1 + 3)),
])
def test_kho_bank_work_counts_the_kernels_operations(case, want):
    """tools/roofline.py's count of the worm bank kernel's float64
    operations on one output, branch by branch as csrc/kho_bank.cu takes
    them; the bytes: the inputs read once and the output written once."""
    from mcsas_tpu_torch.tools import roofline
    inp = {"sub": lambda: _one_output([1e7], 1e-9, 3e-8, 3e-8),
           "sup": lambda: _one_output([1e9], 1e-9, 3e-8, 3e-8),
           "sup-series": lambda: _one_output([2e8], 1e-9, 3e-8, 3e-8),
           "tail": lambda: _one_output([1e7], 1e-9, 3e-8, 3e-6),
           "slit": lambda: _one_output([1e7, 2e7], 1e-17, 3e-8, 3e-8,
                                       [0.5, 0.5])}[case]()
    n_bytes, n_ops = roofline.kho_bank_work(inp)
    assert n_ops == want
    assert roofline.kho_bank_work(inp, block_values=1) == (n_bytes, n_ops)
    n_in = inp.grid.numel() + 4 + 342 + (0 if inp.smear_w is None else 2)
    assert n_bytes == 8 * (n_in + 1)


def test_kho_bank_bound_is_float64_operations_at_the_cells_shape():
    """kho_bank_bound: float64 operations over 34 TFLOP/s at the worm
    cell's shape (thousands an element, against 8 bytes an output); the
    count does not depend on the block."""
    from mcsas_tpu_torch.tools import roofline
    bound = worm()
    inp = kho_bank.bank_inputs(bound, _data(), 4.0 / 3.0,
                               torch.as_tensor(contribs(bound, 4, 25)))
    n_bytes, n_ops = roofline.kho_bank_work(inp)
    assert roofline.kho_bank_work(inp, block_values=700) == (n_bytes,
                                                             n_ops)
    elements = 100 * 100
    assert 4000 * elements < n_ops < 12000 * elements
    ms, by = roofline.kho_bank_bound(inp)
    assert by == "float64 operations"
    assert ms == pytest.approx(n_ops / roofline.F64_OPS_PER_S * 1e3)


# ================================================================ the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _row_rel(a, b):
    """The largest |a - b| of each row over the row's largest |b|."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max(axis=-1, keepdims=True)
    return float((np.abs(a - b) / scale).max())


def _card_case(name):
    """(binding, data, contributions) of the card tests: the worm cell's
    size (300 × 10 contributions log-uniform over worm-k2xs's active
    ranges, 100 points of 0.01-10 nm⁻¹; unsmeared and through the 25-step
    slit), contributions whose t = q·kuhn/3 lies 1e-7 and 1e-4 either side
    of 1 at points of the grid, and radii and points that reach q·r below
    1e-6 (j1_over_x's limit)."""
    bound = worm()
    d = _data(smear=name == "slit")
    if name == "qr-limit":
        ranges = dict(WORM_RANGES, radius=(1e-10, 5e-9))
        bound = worm(active=tuple(ranges), active_ranges=ranges)
        d = _data((1e-6, 10.0, 100))
    c = contribs(bound, 10, 300, seed=17)
    if name == "t-near-1":
        # 1e-7 from 1 keeps 1 - cos(F X) well above its rounding
        deltas = (-1e-4, -1e-7, 1e-7, 1e-4)
        for k, (j, dt) in enumerate((j, dt) for j in (30, 55, 80)
                                    for dt in deltas):
            c[0, k, 1] = 3.0 / d.q[j] * (1.0 + dt)
    if name == "qr-limit":
        c[0, 0, 0] = 1e-10
    return bound, d, c


def _branches(inp):
    """Which branches of the rule the inputs reach, as the kernel forms
    each argument."""
    g = inp.grid[None]
    t = g * inp.kuhn[:, None, None] / 3.0
    x = inp.x[:, None, None].expand_as(t)
    X = torch.clamp_max(x, chains._Z_CUT)
    F = torch.sqrt(torch.clamp_min(t * t - 1.0, 1e-12))
    above = t >= 1.0
    qr = (g * inp.radius[:, None, None]).abs()
    return {"t<1": bool((t < 1.0).any()), "t>=1": bool(above.any()),
            "x<=40": bool((x <= 40.0).any()), "x>40": bool((x > 40).any()),
            "FX<6": bool((above & (F * X < 6.0)).any()),
            "FX>=6": bool((above & (F * X >= 6.0)).any()),
            "Fh<0.05": bool((above & (F * X / 512 < 0.05)).any()),
            "Fh>=0.05": bool((above & (F * X / 512 >= 0.05)).any()),
            "qr<1e-6": bool((qr < 1e-6).any()),
            "|t-1|<=1e-4": bool(((t - 1.0).abs() <= 1.0001e-4).any())}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unsmeared", "slit", "t-near-1",
                                  "qr-limit"])
def test_kho_bank_matches_the_eager_bank(name):
    """The kernel (one launch) against its plain version, the eager bank on
    the card, at 1e-10 of each row's largest value, on every branch of the
    rule (t either side of 1, x either side of Z_CUT, Si's Taylor and
    Laguerre branches, Filon's series and closed form) and, where the case
    reaches it, j1_over_x's limit; the launch shape of one block a
    contribution."""
    _needs_card()
    bound, d, c = _card_case(name)
    comp2 = 2.0 * McSASConfig().compensation_exponent
    rset = torch.as_tensor(c, device="cuda")
    inp = kho_bank.bank_inputs(bound, d, comp2, rset)
    reached = _branches(inp)
    want = [k for k in reached if not k.startswith(("qr", "|t"))]
    want += {"qr-limit": ["qr<1e-6"], "t-near-1": ["|t-1|<=1e-4"]}.get(
        name, [])
    assert all(reached[k] for k in want), reached
    shape = kho_bank.launch_shape(inp)
    assert (shape["threads"], shape["blocks"]) == (128, 3000), shape
    assert shape["smem_bytes"] == 8 * (3 * 513 + 342)
    before = kho_bank.run_kho_bank.launches
    got = histogram._bank_f64(bound, d, comp2, rset)
    assert kho_bank.run_kho_bank.launches == before + 1
    eager = histogram._bank_eager(bound, d, comp2, rset)
    assert kho_bank.run_kho_bank.launches == before + 1
    e = eager.cpu().numpy().reshape(3000, -1)
    assert np.isfinite(e).all() and (e > 0).all()
    assert _row_rel(got.cpu().numpy().reshape(3000, -1), e) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("smear", [False, True])
def test_kho_bank_post_pass_matches_the_eager_pass(smear, monkeypatch):
    """_post_pass_f64 on the card through the kernel: every output within
    1e-10 relative of the same pass through the eager bank; one launch,
    counted as ``post.bank.kernel`` and not as ``post.bank.eager``."""
    _needs_card()
    bound, d, c = _card_case("slit" if smear else "unsmeared")
    cfg = McSASConfig(num_contribs=c.shape[1], num_reps=c.shape[0])
    before = kho_bank.run_kho_bank.launches
    with profiling.recording() as rec:
        card = histogram._post_pass_f64(bound, d, cfg, c, device="cuda")
    assert kho_bank.run_kho_bank.launches == before + 1
    assert rec.counters.get("post.bank.kernel") == 1
    assert "post.bank.eager" not in rec.counters
    monkeypatch.setattr(bank_route, "kernel_for", lambda *a: None)
    eager = histogram._post_pass_f64(bound, d, cfg, c, device="cuda")
    assert kho_bank.run_kho_bank.launches == before + 1
    for a, b in zip(card, eager):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0.0)
