"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, one traffic mix or one per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``. The yardstick (traffic generation, the weight
rule, the plain reference, the comparison that decides ``correct``, the
table of peaks and the reduction of traces to metrics) lives here, apart
from the program it measures.
"""
