"""Observability of the port: ``metrics`` (process-local counters,
gauges and log-bucket histograms), ``trace`` (nested spans into the
journal of ``resilience/journal.py``, off unless ``TPKT_TRACE``),
``scaling`` (the ``device_inventory`` stamp, the distributed layer's
artifacts and verdicts), ``slo`` (latency targets and ``slo.json``),
``reqtrace`` (per-request timelines), ``rollup`` (daily rollups, ``python
-m tpukernels_torch.obs.rollup``), ``trend`` (the verdicts over the
serving journal and the rollups), ``report`` (``python -m
tpukernels_torch.obs.report [--check]``, the gate) and ``trace_report``
(``python -m tpukernels_torch.obs.trace_report``, the waterfalls)."""
