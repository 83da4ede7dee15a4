"""``device_idle_pct``: the share of the traced sub-window in which no
device operation ran on any stream (``torch.profiler``, the union of
their intervals). Nothing without a device event."""


def read(rec: dict):
    p = rec.get("profile")
    if not p or not p.get("device_ops_n") or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
