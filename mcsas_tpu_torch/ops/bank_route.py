# -*- coding: utf-8 -*-
"""Which hand-written kernel, if any, computes the post pass's float64
bank of a binding on its data on a device: read by the post pass
(``post/histogram.py::_bank_f64``) and by the engine's prewarm, which
builds that kernel's library beside the chunk kernel's.  A bank kernel
is its ``csrc/*.cu``, its wrapper and one entry of :data:`KERNELS`.
"""
from __future__ import annotations

import torch

from . import cyl_bank, kho_bank

# the bank kernels' wrappers; no binding's bank is more than one's
KERNELS = (cyl_bank, kho_bank)


def kernel_for(bound, data, device):
    """The wrapper of the bank kernel that computes the post pass's bank
    of *bound* on *data* on *device*: the one whose ``applies`` takes the
    binding and the data, on a CUDA device.  None where the eager bank
    (the kernels' plain version) computes it: every CPU call, every other
    model, 2D data."""
    if torch.device(device).type != "cuda":
        return None
    return next((k for k in KERNELS if k.applies(bound, data)), None)
