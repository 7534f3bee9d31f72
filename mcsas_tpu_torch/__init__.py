# -*- coding: utf-8 -*-
"""mcsas_tpu_torch — the PyTorch/CUDA port of mcsas_tpu: Monte Carlo
size-distribution retrieval for small-angle scattering on an NVIDIA GPU.

Quick start::

    import mcsas_tpu_torch as mt
    result = mt.fit("mydata.csv", model="Sphere", device="cuda")
    mt.run_files(["a.dat", "b.dat"], model="Sphere", out_dir="out")

or from the shell: ``python -m mcsas_tpu_torch a.dat b.dat -o out``.

The package imports torch and numpy only; the JAX package ``mcsas_tpu``
beside it is the reference it is tested against.
"""

__version__ = "0.1.0"

from .api import McSASResult, OutputFiles, fit, run_files  # noqa: E402
from .config import McSASConfig                      # noqa: E402
from .data import (DataConfig, GaussianSmearing, SASData,  # noqa: E402
                   TrapezoidSmearing, from_raw, load)
from .models import (REGISTRY, get_model,  # noqa: E402
                     load_model_dir, load_model_file)
from .post.histogram import HistogramSpec            # noqa: E402

__all__ = [
    "__version__", "McSASConfig", "DataConfig", "SASData",
    "TrapezoidSmearing", "GaussianSmearing", "from_raw", "load",
    "REGISTRY", "get_model", "load_model_file", "load_model_dir",
    "HistogramSpec", "McSASResult", "OutputFiles", "fit", "run_files",
]
