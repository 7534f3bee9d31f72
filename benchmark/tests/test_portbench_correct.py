"""The check that decides ``correct``, on the CPU at a test's size: the
program passes, the control (the reference in bfloat16 in the program's
place) fails, and so does a run with the timed path broken underneath,
once for each fault a one-card series of fits can have: a step that
returns its state unchanged, half of the q points left out of χ² (the
mean taken over the rest), a contribution altered where it is made.
(The exchange between cards has no counterpart on one card.)"""
import pytest

from conftest import tiny
from benchmark import run


def _run(seed, **kw):
    piece = tiny(run.load_cell("sphere-series"))
    rec = run.run_cell(piece, seed, 1.0, device="cpu", **kw)
    return piece, rec


def test_program_passes_and_control_fails():
    piece, rec = _run(2 ** 31 + 21, control=True)
    assert run.passes(rec["checks"], piece["limits"]), rec["checks"]
    assert not run.passes(rec["control"], piece["limits"]), rec["control"]


def _unchanged(monkeypatch):
    from mcsas_tpu_torch.ops import mc_kernel
    monkeypatch.setattr(mc_kernel, "chunk_reference",
                        lambda state, ri, *a, **kw: (state, ri))


def _half_the_points(monkeypatch):
    from mcsas_tpu_torch.core import engine, fitcore
    from mcsas_tpu_torch.post import histogram
    orig = fitcore.make_constants

    def half(f, fu, dtype=None, device="cpu"):
        c = orig(f, fu, dtype, device)
        u = c.u.clone()
        u[1::2] = 0.0
        return fitcore.FitConstants(
            y=c.y, u=u, s_u=float(u.double().sum()),
            s_uy=float((u * c.y).double().sum()), n=(c.n + 1) // 2)
    monkeypatch.setattr(engine, "make_constants", half)
    monkeypatch.setattr(histogram, "make_constants", half)


def _altered(monkeypatch):
    from mcsas_tpu_torch.core.engine import McSASEngine
    orig = McSASEngine.run

    def run_and_alter(self, *a, **kw):
        res = orig(self, *a, **kw)
        hi = self.bound.ranges[0][1]
        res.contribs[0, 0, 0] = min(2.0 * res.contribs[0, 0, 0], hi)
        return res
    monkeypatch.setattr(McSASEngine, "run", run_and_alter)


@pytest.mark.parametrize("fault", [_unchanged, _half_the_points, _altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    piece, rec = _run(2 ** 31 + 22)
    assert not run.passes(rec["checks"], piece["limits"]), rec["checks"]
