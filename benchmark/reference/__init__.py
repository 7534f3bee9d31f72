"""The plain reference: float64 PyTorch, independent of the program.

It works the program's outputs out again from the raw frame and the
contributions the program returned: the preprocessing (:mod:`.prep`), the
intensities of each model (``models/<model>.py``, found by the model's
name), the scale and background solve, χ², fractions and histograms
(:mod:`.core`).  It imports nothing of ``mcsas_tpu_torch``, ``mcsas_tpu``
or ``jax``.
"""
