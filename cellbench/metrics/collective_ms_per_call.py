"""``collective_ms_per_call``: the outermost ``collective/<name>`` spans
of ``parallel/collectives.py`` on rank 0 (the ring's steps, forces
included, and the gather of the full result) summed over the part of the
traced window with the spans on, over its calls. Nothing where it
recorded none."""


def read(rec: dict):
    spans = [s for s in rec.get("spans") or []
             if s.get("name", "").count("collective/") == 1]
    if not rec.get("span_calls") or not spans:
        return None
    return sum(s.get("wall_s", 0.0) for s in spans) * 1e3 / rec["span_calls"]
