"""CPU tests of the benchmark (``python -m pytest perfbench/tests``); the
tests marked ``cuda`` run a cell on a card and skip without one."""
