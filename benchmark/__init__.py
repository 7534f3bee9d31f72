"""The benchmark of mcsas_tpu_torch: a series of fits on one card.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Every piece a
cell names is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (read by the ``generators/<generator>.py`` it
names), ``metrics/<metric>.py``, ``limits/<cell>.json`` and
``reference/models/<model>.py``.  The plain
reference (:mod:`benchmark.reference`) imports nothing of the program.
"""
