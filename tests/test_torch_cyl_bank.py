# -*- coding: utf-8 -*-
"""PyTorch port: the post pass's bank kernel of orientation-averaged
cylinders (ops/cyl_bank.py, csrc/cyl_bank.cu) on the CPU.  The kernel's
sum, written out in PyTorch from the wrapper's inputs, against the eager
bank (its plain version) at the card tests' tolerance, and its operation
count.  Its route, its wrapper's refusals and the CPU post pass, which
keeps the eager bank, are tested with the worm's in
``tests/test_torch_bank_route.py``; the kernel itself runs in
``tests/test_torch_cuda.py`` on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bank_cases import (CYL_Q_NM, RADII, contribs, cylinders,  # noqa: E402
                        frames)
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.ops import cyl_bank  # noqa: E402
from mcsas_tpu_torch.ops.special import (bessel_j1, j1_over_x,  # noqa: E402
                                         sinc_sin)
from mcsas_tpu_torch.post import histogram  # noqa: E402

RTOL = 1e-10       # the card tests' tolerance: float64, the order differs


def _data(q_nm=CYL_Q_NM, smear=False):
    return frames(q_nm, smear)


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
        bound = cylinders(active=("radius", "length"),
                          active_ranges=dict(RADII, length=(1e-9, 2e-6)),
                          fixed={"useAspect": 0.0})
        return bound, _data(), contribs(bound, 2, 4)
    if case == "qR-limit":
        # q down to 1e-6 nm⁻¹ and radii from 0.1 nm: qR below 1e-6
        bound = cylinders(active=("radius",),
                          active_ranges={"radius": (1e-10, 1e-8)})
        c = contribs(bound, 2, 4)
        c[0, 0, 0] = 1e-10
        return bound, _data((1e-6, 2.0, 100)), c
    div = {"intDiv-801": 801.0, "intDiv-3": 3.0}.get(case, 100.0)
    bound = cylinders(active=("radius",), active_ranges=RADII,
                      fixed={"aspect": 10.0, "intDiv": div})
    return bound, _data(smear=case == "slit"), contribs(bound, 2, 4)


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
    bound = cylinders()
    inp = cyl_bank.bank_inputs(bound, _data(smear=True), 4.0 / 3.0,
                               torch.as_tensor(contribs(bound, 2, 5)))
    n_bytes, n_ops = roofline.cyl_bank_work(inp)
    assert roofline.cyl_bank_work(inp, block_values=3 * 2600 * 98) == (
        n_bytes, n_ops)
    nodes = 10 * 100 * 26 * 98
    assert (11 + 1 + 16) * nodes < n_ops < (11 + 1 + 32 + 10) * nodes * 1.2
    ms, by = roofline.cyl_bank_bound(inp)
    assert by == "float64 operations"
    assert ms == pytest.approx(n_ops / roofline.F64_OPS_PER_S * 1e3)
