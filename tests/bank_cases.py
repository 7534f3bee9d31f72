# -*- coding: utf-8 -*-
"""The data, bindings and contributions the CPU tests of the post pass's
bank kernels share (tests/test_torch_cyl_bank.py,
tests/test_torch_kho_bank.py, tests/test_torch_bank_route.py)."""
import numpy as np

from mcsas_tpu_torch.data import DataConfig, TrapezoidSmearing, from_raw
from mcsas_tpu_torch.models import get_model

CYL_Q_NM = (0.01, 2.0, 100)        # the benchmark's cylinder cells
WORM_Q_NM = (0.01, 10.0, 100)      # the worm cell's range
RADII = {"radius": (0.5e-9, 300e-9)}
# worm-k2xs's active ranges (benchmark/configs/worm-k2xs.json), in m
WORM_RANGES = {"radius": (1e-9, 5e-9), "lenKuhn": (1e-8, 5e-8),
               "lenContour": (1e-7, 1e-6)}


def frames(q_nm, smear=False):
    """Flat frames on geomspace(*q_nm) nm⁻¹, unsmeared or through the
    benchmark's 25-step trapezoid slit."""
    q = np.geomspace(*q_nm)
    ones = np.ones_like(q)
    cfg = DataConfig(n_bin=0, smearing=TrapezoidSmearing(
        do_smear=True, n_steps=25, umbra=0.05e9, penumbra=0.2e9)
        if smear else None)
    return from_raw(np.column_stack([q, ones, 0.01 * ones]), config=cfg)


def cylinders(**bind):
    return get_model("CylindersIsotropic").bind(
        **(bind or dict(active=("radius",), active_ranges=RADII)))


def worm(**bind):
    return get_model("Kholodenko").bind(
        **(bind or dict(active=tuple(WORM_RANGES),
                        active_ranges=WORM_RANGES)))


def contribs(bound, n_reps, n, seed=3):
    """Contributions log-uniform over each active range."""
    rs = np.random.default_rng(seed)
    lo, hi = np.log(np.asarray(bound.ranges)).T
    return np.exp(rs.uniform(lo, hi, (n_reps, n, len(lo))))
