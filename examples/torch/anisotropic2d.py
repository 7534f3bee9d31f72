# -*- coding: utf-8 -*-
"""Anisotropic 2D (q, ψ) fitting on the PyTorch/CUDA port — a working
version of the capability the reference left dormant
(mcsas/mcsas.py:617-651).

Generates a synthetic detector image of in-plane cylinders oriented at
ψ₀, fits (radius, psiAngle) populations against it on the card, and
reports the recovered orientation.  No kernel evaluates the anisotropic
ff2d, so the fit runs the plain PyTorch chunk on the card, asked for
with ``use_pallas="off"`` (the JAX package runs its scan path there).

    python examples/torch/anisotropic2d.py
"""
import math

import numpy as np
import torch

import mcsas_tpu_torch as mtt
from mcsas_tpu_torch.data import DataConfig, from_raw
from mcsas_tpu_torch.models.cylinders import _cyl_radial_ff2d

NM = 1e-9
PSI0 = 0.8          # true in-plane orientation [rad]


def synth_image(n_q=32, n_psi=24):
    q_nm = np.geomspace(0.05, 1.5, n_q)
    psi = np.linspace(0.05, 2 * math.pi, n_psi, endpoint=False)
    qg, pg = np.meshgrid(q_nm * 1e9, psi, indexing="ij")
    p = {"radius": 5 * NM, "aspect": 10.0, "psiAngle": PSI0}
    ff = _cyl_radial_ff2d(torch.as_tensor(qg.ravel()),
                          torch.as_tensor(pg.ravel()), p).numpy()
    i = ff ** 2 / (ff ** 2).max() + 1e-4
    # 2% relative + absolute floor: detector images have a noise floor,
    # and without one the deep psi-nodes over-constrain the fit
    sigma = 0.02 * i + 2e-3
    raw = np.column_stack([qg.ravel() / 1e9, i, sigma,
                           np.degrees(pg.ravel())])
    return from_raw(raw, title="synthetic-2d",
                    config=DataConfig(n_bin=0, fit_2d=True))


def main():
    data = synth_image()
    print(f"2D dataset: {data.count} (q, psi) pixels")
    bound = mtt.get_model("CylindersRadiallyIsotropic").bind(
        active=("radius", "psiAngle"),
        active_ranges={"radius": (1 * NM, 20 * NM)})
    # χ² plateaus near ~51 on this synthetic: the target is exactly
    # representable, but greedy single-swap MC cannot cross the
    # radius-exchange barrier (identical accept semantics to the
    # reference).  The demonstrated observable is the ORIENTATION; the
    # criterion is set at the plateau so the demo converges instead of
    # burning retries.
    cfg = mtt.McSASConfig(num_contribs=50, num_reps=3,
                          max_iterations=500_000, chunk_steps=1000,
                          candidates_per_step=32, seed=11, local_moves=0.5,
                          convergence_criterion=52.0, max_retries=0,
                          show_incomplete=True, use_pallas="off")
    res = mtt.fit(data, model=bound, cfg=cfg, device="cuda")
    print("chi2 per repetition:", res.engine.conval.round(2).tolist(),
          "(greedy-MC plateau on an exactly-representable target — "
          "see comment)")
    contribs = res.engine.contribs          # (reps, N, params)
    ang = 2.0 * contribs[:, :, 1]
    w = contribs[:, :, 0] ** 3
    mean_ang = math.atan2((w * np.sin(ang)).sum(),
                          (w * np.cos(ang)).sum()) / 2.0
    print(f"recovered orientation {mean_ang % math.pi:.2f} rad "
          f"(truth {PSI0:.2f}, cylinder is pi-periodic)")


if __name__ == "__main__":
    main()
