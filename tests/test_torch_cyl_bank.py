# -*- coding: utf-8 -*-
"""PyTorch port: the post pass's bank kernel of orientation-averaged
cylinders (ops/cyl_bank.py, csrc/cyl_bank.cu) on the CPU.  Which bindings
and data take its route; what its wrapper refuses; the kernel's sum,
written out in PyTorch from the wrapper's inputs, against the eager bank
(its plain version) at the card tests' tolerance; and the CPU post pass,
which keeps the eager bank.  The kernel itself runs in
``tests/test_torch_cuda.py`` on the card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.data import (DataConfig, TrapezoidSmearing,  # noqa: E402
                                  from_raw)
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import cyl_bank, mc_kernel  # noqa: E402
from mcsas_tpu_torch.ops.special import (bessel_j1, j1_over_x,  # noqa: E402
                                         sinc_sin)
from mcsas_tpu_torch.post import histogram  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402

RTOL = 1e-10       # the card tests' tolerance: float64, the order differs
_RADII = {"radius": (0.5e-9, 300e-9)}


def _data(q_nm=(0.01, 2.0, 100), smear=False):
    """Flat frames on geomspace(*q_nm) nm⁻¹, as the benchmark's cylinder
    cells have them: unsmeared, or through their 25-step trapezoid slit."""
    q = np.geomspace(*q_nm)
    ones = np.ones_like(q)
    cfg = DataConfig(n_bin=0, smearing=TrapezoidSmearing(
        do_smear=True, n_steps=25, umbra=0.05e9, penumbra=0.2e9)
        if smear else None)
    return from_raw(np.column_stack([q, ones, 0.01 * ones]), config=cfg)


def _cylinders(**bind):
    return get_model("CylindersIsotropic").bind(
        **(bind or dict(active=("radius",), active_ranges=_RADII)))


def _contribs(bound, n_reps, n, seed=3):
    """Contributions log-uniform over each active range."""
    rs = np.random.default_rng(seed)
    lo, hi = np.log(np.asarray(bound.ranges)).T
    return np.exp(rs.uniform(lo, hi, (n_reps, n, len(lo))))


# ------------------------------------------------------------------ route

def _route_case(case):
    if case == "cylinders":
        return _cylinders(), _data()
    if case == "cylinders-slit":
        return _cylinders(), _data(smear=True)
    if case == "cylinders-length":
        return _cylinders(active=("radius", "length"),
                          active_ranges=dict(_RADII,
                                             length=(1e-9, 1e-6)),
                          fixed={"useAspect": 0.0}), _data()
    if case == "cylinders-own-table":
        return suite.unblendable_cylinder("opaque-lookup"), _data()
    if case == "cylinders-2d":
        d = _data()
        return _cylinders(), dataclasses.replace(
            d, psi=np.linspace(0.0, 1.0, d.count))
    model = {"sphere": "Sphere", "cylinders-aspect":
             "CylindersIsotropicAspect", "ellipsoids":
             "EllipsoidsIsotropic"}[case]
    return get_model(model).bind(), _data(smear=True)


@pytest.mark.parametrize("case,takes", [
    ("cylinders", True), ("cylinders-slit", True),
    ("cylinders-length", True), ("cylinders-own-table", True),
    ("sphere", False), ("cylinders-aspect", False), ("ellipsoids", False),
    ("cylinders-2d", False)])
def test_route_follows_the_binding_and_the_data(case, takes):
    """The kernel's route: a model whose form factor is the cylinders'
    orientation average (the built-in, or a copy with a table of its own)
    on 1D data, smeared or not, either useAspect; not the Sphere, another
    model, or 2D data.  Only a CUDA device launches it."""
    bound, d = _route_case(case)
    assert cyl_bank.applies(bound, d) is takes
    assert cyl_bank.launches_on(bound, d, "cuda") is takes
    assert cyl_bank.launches_on(bound, d, torch.device("cpu")) is False


# ------------------------------------------------------------- the wrapper

def _inputs(smear=False):
    bound = _cylinders()
    rset = torch.as_tensor(_contribs(bound, 2, 5))
    return cyl_bank.bank_inputs(bound, _data(smear=smear), 4.0 / 3.0, rset)


def _fault(kind):
    inp = _inputs(smear=kind in ("no smear_w", "contiguity"))
    if kind == "dtype":
        return inp._replace(radius=inp.radius.float()), "radius"
    if kind == "shape":
        return inp._replace(length=inp.length[:-1].clone()), "length"
    if kind == "contiguity":
        grid = inp.grid.t().contiguous().t()
        return inp._replace(grid=grid), "not contiguous"
    if kind == "device":
        return inp._replace(weight=inp.weight.to("meta")), "weight"
    if kind == "nodes":
        return inp._replace(s=inp.s[:-1].clone()), "s:"
    if kind == "no smear_w":
        return inp._replace(smear_w=None), "smear_w"
    if kind == "grid":
        return inp._replace(grid=inp.grid.reshape(-1)), "grid"
    return inp, "CUDA device"                  # all well, but on the CPU


@pytest.mark.parametrize("kind", ["cpu", "dtype", "shape", "contiguity",
                                  "device", "nodes", "no smear_w", "grid"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(kind, monkeypatch):
    """run_cyl_bank checks device, dtype, shape and contiguity before it
    allocates or launches: each fault raises naming it, nothing launches
    and the count stays."""
    def launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(mc_kernel, "_launch", launch)
    inp, names = _fault(kind)
    before = cyl_bank.run_cyl_bank.launches
    with pytest.raises(ValueError, match=names):
        cyl_bank.run_cyl_bank(inp)
    with pytest.raises(ValueError, match=names):
        cyl_bank.launch_shape(inp)
    assert cyl_bank.run_cyl_bank.launches == before


# ------------------------------------------------- the kernel's sum, in torch

def _kernel_sum(inp):
    """The bank as csrc/cyl_bank.cu sums it, from the wrapper's inputs:
    16·step·w·Σ_off sw·(Σ interior f² + (f0² + f1²)/2), its terms in the
    plain version's operations."""
    g = inp.grid[None]                                  # (1, Nq, n_off)
    a = g * inp.radius[:, None, None]
    c = g * inp.length[:, None, None]
    qr = a[..., None] * inp.s
    ql = c[..., None] * inp.x
    f = bessel_j1(qr) * torch.sin(ql / 2.0) / (qr * ql)
    ends = 0.5 * ((0.5 * j1_over_x(a)) ** 2 + sinc_sin(c / 2.0) ** 2)
    per_off = (f * f).sum(dim=-1) + ends                # (B, Nq, n_off)
    acc = (per_off @ inp.smear_w if inp.smear_w is not None
           else per_off[..., 0])
    return 16.0 * inp.step * acc * inp.weight[:, None]


def _sum_case(case):
    """(binding, data, contributions) of each shape the card tests hold
    the kernel to, cut to a few contributions."""
    if case == "useAspect-0":
        bound = _cylinders(active=("radius", "length"),
                           active_ranges=dict(_RADII, length=(1e-9, 2e-6)),
                           fixed={"useAspect": 0.0})
        return bound, _data(), _contribs(bound, 2, 4)
    if case == "qR-limit":
        # q down to 1e-6 nm⁻¹ and radii from 0.1 nm: qR below 1e-6
        bound = _cylinders(active=("radius",),
                           active_ranges={"radius": (1e-10, 1e-8)})
        c = _contribs(bound, 2, 4)
        c[0, 0, 0] = 1e-10
        return bound, _data((1e-6, 2.0, 100)), c
    div = {"intDiv-801": 801.0, "intDiv-3": 3.0}.get(case, 100.0)
    bound = _cylinders(active=("radius",), active_ranges=_RADII,
                       fixed={"aspect": 10.0, "intDiv": div})
    return bound, _data(smear=case == "slit"), _contribs(bound, 2, 4)


@pytest.mark.parametrize("case", ["unsmeared", "slit", "useAspect-0",
                                  "intDiv-801", "intDiv-3", "qR-limit"])
def test_kernel_sum_matches_the_eager_bank(case):
    """The kernel's rewrite of the bank (ff² as 16·integral, the slit's
    contraction inside the sum, the endpoints as half-weight terms) on the
    wrapper's inputs equals the eager bank to 1e-10 relative."""
    bound, d, c = _sum_case(case)
    comp2 = 2.0 * McSASConfig().compensation_exponent
    rset = torch.as_tensor(c)
    inp = cyl_bank.bank_inputs(bound, d, comp2, rset)
    if case == "qR-limit":
        a = (inp.grid[None] * inp.radius[:, None, None]).abs()
        assert float(a.min()) < 1e-6
    eager = histogram._bank_f64(bound, d, comp2, rset)
    mine = _kernel_sum(inp).reshape(eager.shape)
    assert torch.isfinite(eager).all() and (eager > 0).all()
    np.testing.assert_allclose(mine.numpy(), eager.numpy(), rtol=RTOL,
                               atol=0.0)


@pytest.mark.parametrize("smear", [False, True])
def test_cpu_post_pass_keeps_the_eager_bank(smear, monkeypatch):
    """On the CPU the cylinder's bank is the eager chain, unchanged: no
    kernel call, and the bank is the model's ff²·w (through the slit:
    (ff²(locs) @ smear_w)·w) bit for bit."""
    def refuse(*args):
        raise AssertionError("the kernel route on the CPU")

    monkeypatch.setattr(cyl_bank, "run_cyl_bank", refuse)
    bound, d = _cylinders(), _data(smear=smear)
    comp2 = 4.0 / 3.0
    c = _contribs(bound, 2, 5)
    rset = torch.as_tensor(c)
    got = histogram._bank_f64(bound, d, comp2, rset)
    part = rset.reshape(-1, 1)
    grid = torch.as_tensor(d.locs if smear else d.q)
    pd = bound.pdict(part[:, None, None, :] if smear else part[:, None, :])
    ff = bound.model.ff(grid, pd)
    it = (ff * ff) @ torch.as_tensor(d.smear_w) if smear else ff * ff
    w = bound.model.volume(bound.pdict(part[:, None, :])) ** comp2
    assert torch.equal(got, (it * w).reshape(got.shape))
    out = histogram._post_pass_f64(bound, d, McSASConfig(num_contribs=5,
                                                         num_reps=2), c)
    assert all(np.isfinite(v).all() for v in out)


@pytest.mark.parametrize("launches", [False, True])
def test_bank_follows_launches_on(launches, monkeypatch):
    """_bank_f64 takes the kernel route exactly where
    cyl_bank.launches_on says so, and the eager bank everywhere else: the
    route is decided in one place."""
    calls = []

    def run(inp):
        calls.append(inp)
        return torch.zeros((inp.radius.numel(), inp.grid.shape[0]),
                           dtype=torch.float64)

    monkeypatch.setattr(cyl_bank, "launches_on",
                        lambda bound, data, device: launches)
    monkeypatch.setattr(cyl_bank, "run_cyl_bank", run)
    bound, d = _cylinders(), _data()
    rset = torch.as_tensor(_contribs(bound, 2, 5))
    got = histogram._bank_f64(bound, d, 4.0 / 3.0, rset)
    assert len(calls) == int(launches)
    assert tuple(got.shape) == (2, 5, d.count)
    assert bool((got > 0).all()) is not launches


# ------------------------------------------------- the kernel's bound

def _one_output(q, radius, length, smear_w=None, n=3):
    """BankInputs of one contribution on the grid row *q* (one entry an
    offset) with n - 2 interior nodes."""
    f64 = torch.float64
    x = torch.as_tensor(np.linspace(0.0, 1.0, n)[1:-1], dtype=f64)
    return cyl_bank.BankInputs(
        grid=torch.as_tensor([q], dtype=f64),
        smear_w=(None if smear_w is None
                 else torch.as_tensor(smear_w, dtype=f64)),
        radius=torch.as_tensor([radius], dtype=f64),
        length=torch.as_tensor([length], dtype=f64),
        weight=torch.ones(1, dtype=f64), x=x, s=torch.sqrt(1.0 - x * x),
        step=1.0 / (n - 1))


@pytest.mark.parametrize("case,want", [
    # qR 1, the node's qR·s 0.87: J1's polynomial for node and endpoint,
    # sinc_sin's sin (qL/2 = 5); 3 for the output's weight
    ("polynomial", (56, 3 + (11 + 16) + (9 + 1 + 16 + 2))),
    # qR 4, qR·s 3.46: J1's asymptotic branch twice
    ("asymptotic", (56, 3 + (11 + 32) + (9 + 1 + 32 + 2))),
    # qR 1e-7, qL/2 5e-4: j1_over_x's limit (3) and sinc_sin's series (5)
    ("limits", (56, 3 + (11 + 16) + (9 + 3 + 5))),
    # two offsets (qR 1 and 4) through a slit: one product more a term
    ("slit", (80, 3 + (12 + 16) + (10 + 1 + 16 + 2)
              + (12 + 32) + (10 + 1 + 32 + 2))),
])
def test_cyl_bank_work_counts_the_kernels_operations(case, want):
    """tools/roofline.py's count of the bank kernel's float64 operations
    and bytes, on one output, branch by branch as csrc/cyl_bank.cu takes
    them."""
    from mcsas_tpu_torch.tools import roofline
    inp = {"polynomial": lambda: _one_output([1.0], 1.0, 10.0),
           "asymptotic": lambda: _one_output([1.0], 4.0, 10.0),
           "limits": lambda: _one_output([1.0], 1e-7, 1e-3),
           "slit": lambda: _one_output([1.0, 4.0], 1.0, 10.0,
                                       [0.5, 0.5])}[case]()
    assert roofline.cyl_bank_work(inp) == want
    assert roofline.cyl_bank_work(inp, block_values=1) == want


def test_cyl_bank_bound_is_the_larger_of_bytes_and_operations():
    """cyl_bank_bound: bytes over the HBM rate where they take longer
    (one output), float64 operations over the float64 rate at the bench
    cells' shape; the count does not depend on the block."""
    from mcsas_tpu_torch.tools import roofline
    ms, by = roofline.cyl_bank_bound(_one_output([1.0], 1.0, 10.0))
    assert by == "bytes" and ms == pytest.approx(
        56 / roofline.HBM_BYTES_PER_S * 1e3)
    bound = _cylinders()
    inp = cyl_bank.bank_inputs(bound, _data(smear=True), 4.0 / 3.0,
                               torch.as_tensor(_contribs(bound, 2, 5)))
    n_bytes, n_ops = roofline.cyl_bank_work(inp)
    assert roofline.cyl_bank_work(inp, block_values=3 * 2600 * 98) == (
        n_bytes, n_ops)
    nodes = 10 * 100 * 26 * 98
    assert (11 + 1 + 16) * nodes < n_ops < (11 + 1 + 32 + 10) * nodes * 1.2
    ms, by = roofline.cyl_bank_bound(inp)
    assert by == "float64 operations"
    assert ms == pytest.approx(n_ops / roofline.F64_OPS_PER_S * 1e3)
