# -*- coding: utf-8 -*-
"""The device mesh of a sharded ensemble and the slices each shard owns
(the JAX package's mcsas_tpu/parallel/mesh.py without jax.sharding).

A :class:`Mesh` lays devices out on two axes, ``rep`` (repetitions of
the ensemble) and ``q`` (points of the fit grid).  Shards are slices of
an axis as ``torch.tensor_split`` cuts it: uneven where the length does
not divide by the axis size, and empty where the axis has more shards
than the length has entries.  The JAX package pads the repetitions
(``pad_reps_for_mesh``) and the q grid (zero-weight points) because
``shard_map`` needs equal shards; this package splits unevenly and pads
nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class Mesh:
    """``shape`` (n_rep, n_q) and the devices, row-major: the device of
    repetition shard i and q shard j is ``devices[i * n_q + j]``.  A device
    may appear more than once (two shards on one card, or on the CPU).
    Hashable, so that it can key an engine cache."""
    shape: tuple
    devices: tuple

    def __post_init__(self):
        n_rep, n_q = (int(v) for v in self.shape)
        if n_rep < 1 or n_q < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self.shape}")
        object.__setattr__(self, "shape", (n_rep, n_q))
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if len(self.devices) != n_rep * n_q:
            raise ValueError(f"mesh {n_rep}x{n_q} needs {n_rep * n_q} "
                             f"devices, got {len(self.devices)}")

    def device(self, i: int, j: int = 0) -> torch.device:
        """The device of repetition shard *i* and q shard *j*."""
        return self.devices[i * self.shape[1] + j]


def make_mesh(shape: Optional[Sequence] = None, devices=None) -> Mesh:
    """A Mesh of *shape* (n_rep, n_q) over *devices*.

    By default the devices are every visible CUDA card and *shape* puts
    them all on the ``rep`` axis.  A shape larger than the devices raises
    ``ValueError`` (mcsas_tpu/parallel/mesh.py:35-39); so does the default
    without a card.  The JAX package switches to CPU virtual devices when
    the request does not fit (mesh.py:20-32): this package does not, a
    mesh on the CPU is asked for explicitly.  An explicit *devices* list
    may repeat a device, e.g. ``[torch.device("cuda:0")] * 2`` holds a
    2-shard mesh on one card and ``[torch.device("cpu")] * 4`` a 4-shard
    one on the CPU; the first ``n_rep * n_q`` devices are used."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise ValueError("make_mesh: no CUDA device is visible; pass "
                             "devices= (for example [torch.device('cpu')] "
                             "* n) for a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices), 1)
    n_rep, n_q = int(shape[0]), int(shape[1])
    if n_rep * n_q > len(devices):
        raise ValueError(f"mesh {n_rep}x{n_q} needs {n_rep * n_q} devices, "
                         f"have {len(devices)}")
    return Mesh((n_rep, n_q), tuple(devices[:n_rep * n_q]))


def _slices(n: int, parts: int) -> list:
    """The slices ``torch.tensor_split`` cuts a length of *n* into."""
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + n // parts + (1 if i < n % parts else 0))
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


def rep_slices(num_reps: int, mesh: Mesh) -> list:
    """The repetitions each ``rep`` shard owns (an empty slice where the
    axis has more shards than repetitions)."""
    return _slices(int(num_reps), mesh.shape[0])


def q_slices(nq: int, mesh: Mesh) -> list:
    """The fit-grid points each ``q`` shard owns."""
    return _slices(int(nq), mesh.shape[1])
