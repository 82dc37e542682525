"""CPU tests of the benchmark (run with ``python -m pytest arcbench/tests``);
tests that need a card are marked ``cuda`` and skip without one."""
