# -*- coding: utf-8 -*-
"""Slit-smeared fitting on the PyTorch/CUDA port: configure a
trapezoidal beam-length profile (reference smearing:
src/mcsas/dataobj/sasconfig.py:105-200) and fit the cylinder on the
card.  Its parameter table holds the smeared intensity, so the MC loop
runs in the CUDA kernel K2 (table in, the row blend·w) at table speed,
and the float64 post pass applies the same contraction.  Without a path
it fits the synthetic smeared cylinder of the bench suite's row
'cylinders-smeared' (radius 10 nm, aspect 10, the same slit).

    python examples/torch/smeared_fit.py [path/to/data.dat]
"""
import importlib.util
import sys

import mcsas_tpu_torch as mtt
from mcsas_tpu_torch.data import DataConfig, TrapezoidSmearing


def main(path=None):
    # umbra/penumbra are the flat-top and full base half-widths of the
    # trapezoidal beam-length profile, in SI (m⁻¹): 0.05/0.2 nm⁻¹ here
    smearing = TrapezoidSmearing(do_smear=True, n_steps=25,
                                 umbra=0.05e9, penumbra=0.2e9)
    if path is None:
        from mcsas_tpu_torch.tools import suite
        data = suite.cylinder_smeared_golden()
    else:
        data = mtt.load(path, config=DataConfig(smearing=smearing))
    print(f"loaded {data.title}: {data.count} points, "
          f"smearing={'ON' if data.uses_smearing else 'off'}")

    bound = mtt.get_model("CylindersIsotropic").bind(
        active=("radius",),
        active_ranges={"radius": (0.5e-9, 300e-9)})
    cfg = mtt.McSASConfig(num_contribs=300, num_reps=10,
                          max_iterations=8_000_000, candidates_per_step=128,
                          chunk_steps=1024)
    result = mtt.fit(data, model=bound, cfg=cfg, device="cuda")
    print(f"chi2 per repetition: {result.engine.conval.round(3)}")
    print(f"table tier: {result.engine.used_table}, K2 ran: "
          f"{result.engine.used_prefetch}, "
          f"{result.engine.iters_per_sec:,.0f} proposals/s")
    out = mtt.OutputFiles(result, "out_smeared/")
    out.write_all(plot=importlib.util.find_spec("matplotlib") is not None)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
