"""Observability of the port: ``metrics`` (process-local counters,
gauges and log-bucket histograms), ``trace`` (nested spans into the
journal of ``resilience/journal.py``, off unless ``TPKT_TRACE``) and
``scaling`` (the ``device_inventory`` stamp)."""
