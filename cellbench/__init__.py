"""The benchmark of ``tpukernels_torch`` on one or four NVIDIA H100s.

``python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the kernel key, shapes, statics, source and
  deployment of one configuration;
- ``traffic/<traffic>.json``: the parameters of one traffic mix (the
  entry, the statics of a call, the pool, the samples compared, the
  warm-up, the traced part) that the one closed-loop generator
  (``harness.run_cell``) reads, and the limits of the compared numbers;
- ``inputs/<kernel>.py``: the operands of one kernel key, made on the
  device from the seed;
- ``work/<kernel>.py``: the operations and bytes one call needs, from
  its shapes (``peaks.json`` holds the card's published rates);
- ``reference/<kernel>.py``: the plain PyTorch reference and the
  comparison that decides ``correct``;
- ``metrics/<metric>.py``: the reader of one metric;
- ``control.py``: the readings the limits are set from; ``tests/``: the
  CPU tests, and the control at the cells' own size on the card.

Nothing here imports ``jax``, ``jaxlib`` or the JAX package. The
harness imports ``tpukernels_torch`` only inside a run, for the entry
and its spans and counters; ``reference/``, ``work/``, ``inputs/`` and
``metrics/`` import nothing of it.
"""
