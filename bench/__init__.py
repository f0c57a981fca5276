"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. The plain reference that decides ``correct`` is
``reference/``; it imports nothing of the port.
"""
