"""The benchmark of the PyTorch and CUDA port (``hse_facerec_torch``).

One command runs one cell of ``BENCHMARK.json``::

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a configuration in ``configs/<name>.json``, a
traffic mix in ``traffic/<name>.json``, a cell's comparison limits in
``cells/<name>.json``, a per-layer metric's reader in
``metrics/<name>.py`` and a configuration's plain reference in
``reference/<config>.py``. The yardstick (traffic generation, FLOP and
byte counts, the card's peaks, the trace reduction, the comparison that
decides ``correct``) lives here, where the program cannot move it; from
the port the benchmark takes only the system under test.
"""
