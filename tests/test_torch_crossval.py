# -*- coding: utf-8 -*-
"""PyTorch port: the running reference McSAS's joint cylinder run
(testdata/reference_cyl_fixture.json: radius AND length active on the
synthetic 2-population testdata/cylmix.dat), reconstructed by the port's
engine on the CPU — the JAX package's
test_crossval_cylinder_joint_reconstruction (tests/test_reference_parity.py)
in its K=1 reference-stepping mode, with the reference's own intDiv=100
quadrature in the loop (table_ff 'off') and its tolerances.  It steps
~170k times eagerly, minutes on the CPU, so it is marked ``slow``; its
stand-in on the card is ``chip_smoke.py`` phase 17 (K=128, local moves
0.5, the two-axis table through K2's table entry)."""
import pytest

torch = pytest.importorskip("torch")

from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402


@pytest.mark.slow
def test_crossval_cylinder_joint_reconstruction():
    """Both histogrammed dimensions and both weightings against the
    reference's bars (within 0.2) and first moments (within the combined
    rep-to-rep spread), the fit curve within 3σ: the reference's own
    tolerances, as the JAX package holds its engine to them."""
    fix, d, bound, cfg = suite.cylinder_crossval_workload(
        candidates_per_step=1, table_ff="off")
    eng = McSASEngine(d, bound, cfg, device="cpu")
    assert not eng.uses_table and not eng.runs_cuda_kernel
    res = eng.run()
    suite.check_smearmc(fix, d, bound, cfg, res,
                        params=("radius", "length"))
