"""``call_ms``: the window's seconds over the calls completed in it, in
milliseconds, by the host's clock over the whole window."""


def read(rec: dict):
    if not rec.get("calls"):
        return None
    return rec["window_s"] / rec["calls"] * 1e3
