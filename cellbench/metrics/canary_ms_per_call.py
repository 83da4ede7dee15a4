"""``canary_ms_per_call``: the integrity guard's canaries
(``integrity/canary/<key>`` spans of ``resilience/integrity.py``) summed
over the part of the traced window with the spans on, over its calls.
Nothing where that part recorded no ``dispatch/`` span."""


def read(rec: dict):
    spans = rec.get("spans") or []
    if not rec.get("span_calls") or not any(
            s.get("name", "").startswith("dispatch/") for s in spans):
        return None
    total = sum(s.get("wall_s", 0.0) for s in spans
                if "integrity/canary/" in s.get("name", ""))
    return total * 1e3 / rec["span_calls"]
