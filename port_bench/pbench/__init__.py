"""The benchmark of sedifoam_tpu_torch, the PyTorch and CUDA coupled
CFD-DEM step: one cell run once per call of ``port_bench/run.py``.

The harness is driven by data. ``BENCHMARK.json`` at the checkout's root
names the cells, configurations and metrics; each is found by its name:

- ``configs/<config>.json``: the configuration's sizes, its source, what
  was assumed or reduced and the guarantees it keeps;
  ``configs/<config>.py`` makes its inputs from the seed and loads them
  into a package that has the program's module layout: the program or
  ``pbref``.
- ``workloads/<cell>.json``: the traffic of one cell (its configuration,
  steps per host visit, probe and diagnostics cadence, warm-up visits,
  the window's visit the reference follows).
- ``limits/<cell>.json``: the numbers that decide ``correct`` in that
  cell, each with its limit and the readings it was set from.
- ``metrics/<metric>.py``: one metric; ``read(rec)`` returns a number,
  or None where the run had nothing to read (the metric is then left
  out of the line). Every metric is read in every cell.

``pbref/`` is the plain reference: a frozen plain-PyTorch copy of the
step that imports nothing of the program.
"""
