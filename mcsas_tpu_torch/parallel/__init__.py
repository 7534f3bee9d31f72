# -*- coding: utf-8 -*-
"""The MC ensemble over several devices, or several shards of one.

The reference has no parallelism (its numReps ensemble is a sequential
loop, src/mcsas/mcsas/mcsas.py:214).  As in the JAX package
(mcsas_tpu/parallel/):

- **rep axis (data parallel)**: the repetitions split over the mesh's
  ``rep`` shards, which share nothing until the host reads χ² once a
  chunk; K1 and K2 run per shard.
- **q axis**: the fit grid splits over the ``q`` shards, and the solve's
  sums are joined across them every step (the plain chunk only).
"""
from .mesh import Mesh, make_mesh, q_slices, rep_slices
from .spmd import ShardedEnsemble

__all__ = ["Mesh", "make_mesh", "rep_slices", "q_slices",
           "ShardedEnsemble"]
