"""The benchmark of ``xerus_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name the manifest
gives it:

- ``configs/<config>.json``: the sizes as they are run, and ``family``,
  which names ``reference/<family>.py`` (inputs from the seed and the plain
  float64 reference: torch and numpy only) and ``drivers/<family>.py`` (the
  system under test: the port's public entry);
- ``mixes/<traffic>.json``: the traffic's parameters (entry arguments, pool
  of inputs, results checked, calls traced), read by ``harness.py``'s one
  closed-loop generator;
- ``cells/<cell>.json``: the limits that decide ``correct``, the readings
  each limit was set from, and the cell's control;
- ``metrics/<metric>.py``: a ``read(run)`` that takes one per-layer metric
  from the run's counters, syncs or device trace, or returns None where
  there is nothing to read.

No file of this package imports the JAX package; ``reference/`` imports
nothing of the port either.
"""
