# -*- coding: utf-8 -*-
"""Fitting over a device mesh on the PyTorch/CUDA port: the repetitions
shard over the "rep" axis (pure data parallelism), one shard per
visible card, each shard launching the CUDA kernel K1 for its
repetitions on its own stream.  One process draws what the unsharded
engine draws and slices it by repetition, so the result equals a
one-card fit's bit for bit.  On a machine with one card the mesh is
1 x 1.

    python examples/torch/multichip.py [path/to/data.dat]
"""
import pathlib
import sys

import mcsas_tpu_torch as mtt
from mcsas_tpu_torch.parallel import make_mesh

DATA = (pathlib.Path(__file__).resolve().parents[2] / "testdata"
        / "sasfit_sphere-10-1.dat")


def main(path):
    # every visible card on the rep axis (n_dev x 1): the shards share
    # nothing but one read of their chi2 a chunk; make_mesh((n, 2), ...)
    # would also split the q axis, which runs only the plain chunk
    mesh = make_mesh()
    n_dev = len(mesh.devices)
    print(f"{n_dev} device(s): {', '.join(map(str, mesh.devices))}, "
          f"mesh {mesh.shape[0]} x {mesh.shape[1]}")

    data = mtt.load(path)
    cfg = mtt.McSASConfig(num_contribs=300, num_reps=2 * n_dev,
                          max_iterations=2_000_000, candidates_per_step=64,
                          chunk_steps=1024)
    result = mtt.fit(data, model="Sphere", cfg=cfg, mesh=mesh)
    print(f"chi2 per repetition: {result.engine.conval.round(3)}")
    print(f"{result.engine.iters_per_sec:,.0f} proposals/s across "
          f"{n_dev} device(s), K1 ran: {result.engine.used_pallas}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DATA)
