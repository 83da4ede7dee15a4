"""Observability of the port: ``metrics`` (process-local counters,
gauges and log-bucket histograms) and ``trace`` (nested spans into the
journal of ``resilience/journal.py``, off unless ``TPKT_TRACE``)."""
