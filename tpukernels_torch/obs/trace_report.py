"""Per-request timelines from the serving journals: the phase table and
the waterfalls.

    python -m tpukernels_torch.obs.trace_report [journal.jsonl ...]
    python -m tpukernels_torch.obs.trace_report --request lg7-00042
    python -m tpukernels_torch.obs.trace_report --slowest 5

The port's copy of ``tools/trace_report.py``, over ``obs/reqtrace.py``'s
:func:`~tpukernels_torch.obs.reqtrace.assemble`, which joins every
process's evidence (the client's ``serve_client_request`` walls, the
router's ``serve_route``/``serve_spill`` placements, the workers'
``serve_request`` records and request-tagged spans) on the client-minted
``request_id``:

- **the phase table** — phase percentiles a (kernel, bucket, tenant):
  queue wait, lock wait, pad, dispatch, compile, integrity, unaccounted;
- **waterfalls** — the ``--slowest N`` (default 3) requests by client
  wall, or one ``--request``: a lane a process, offsets anchored to each
  process's own ``serve_start``, spill and hedge hops, GAP lines for
  abandoned attempts, replays and expired deadlines, and the critical
  path.

With no journal given it reads ``TPKT_HEALTH_JOURNAL`` (a directory: its
newest ``health_*.jsonl``), never the reference's ``docs/logs/``.
``serve_request`` events without a request id are counted and announced,
never dropped silently.

Exit codes: 0 the report rendered (a journal with no timelines
included: the loud note is the report); 1 no journal; 2 usage. Standard
library only.
"""

from __future__ import annotations

import os
import sys

from tpukernels_torch.obs import reqtrace
from tpukernels_torch.resilience import journal as _journal

_BAR_COLS = 36


def _ms(v, width=9):
    if v is None:
        return " " * (width - 1) + "-"
    return f"{v * 1e3:>{width}.3f}"


def _bar(rel0, rel1, scale_s):
    """A fixed-width lane bar for one segment at its per-process offset;
    a degenerate scale renders without position."""
    if not scale_s or scale_s <= 0:
        return "." * _BAR_COLS
    a = min(_BAR_COLS, int(rel0 / scale_s * _BAR_COLS))
    b = min(_BAR_COLS, max(a + 1, int(rel1 / scale_s * _BAR_COLS)))
    return " " * a + "=" * (b - a) + " " * (_BAR_COLS - b)


def waterfall(t: dict) -> list:
    """One assembled timeline as text lines."""
    cw = t["client_wall_s"]
    out = [
        f"request {t['request_id']}  kernel={t['kernel'] or '?'} "
        f"bucket={t['bucket'] or '-'} tenant={t['tenant'] or '-'}"
        + (f" worker={t['worker_id']}" if t["worker_id"] is not None
           else "")
        + (f"  client wall {cw * 1e3:.3f}ms" if cw else "")
        + (f" (coverage {t['coverage']:.0%})"
           if t["coverage"] is not None else "")
    ]
    client = t["client"]
    if client is not None:
        out.append(
            f"  [client pid {client.get('pid')}] "
            + ("warm " if client.get("warm") else "")
            + ("ok" if client.get("ok")
               else f"DROPPED ({client.get('error')})")
            + (f", {t['rejections']} rejection(s)" if t["rejections"]
               else "")
            + (f", {t['throttles']} tenant throttle(s)" if t["throttles"]
               else "")
        )
    for ev in t["route"]:
        out.append(
            f"  [router pid {ev.get('pid')}] -> worker {ev.get('worker')}"
            + (f" (spilled from {ev.get('spilled_from')})"
               if ev.get("spilled_from") is not None else "")
        )
    for ev in t["spills"]:
        out.append(
            f"  [router pid {ev.get('pid')}] SPILL worker "
            f"{ev.get('from_worker')} -> {ev.get('to_worker')} "
            f"({ev.get('reason')})"
        )
    for ev in t["hedges"]:
        out.append(
            f"  [router pid {ev.get('pid')}] HEDGE worker "
            f"{ev.get('from_worker')} -> {ev.get('to_worker')} "
            f"(elapsed > {ev.get('threshold_s')}s, first response wins)"
        )
    # one lane a process, offsets anchored to that process's own
    # serve_start; the scale is the lane's widest offset
    by_pid: dict = {}
    for s in t["segments"]:
        by_pid.setdefault(s["pid"], []).append(s)
    for pid, segs in by_pid.items():
        scale = max(s["rel1"] for s in segs) or None
        for s in segs:
            out.append(
                f"  [worker pid {pid}] "
                f"{_bar(s['rel0'], s['rel1'], scale)} "
                f"{s['name']:<32} {_ms(s['wall_s'])}ms "
                f"@+{s['rel0'] * 1e3:.3f}ms"
                + ("" if s.get("ok", True) else " FAILED")
            )
    for g in t["gaps"]:
        out.append(f"  GAP ({g['kind']}): {g['detail']}")
    if t.get("critical_path"):
        out.append("  critical path: " + " > ".join(
            f"{ph} {v * 1e3:.3f}ms" for ph, v in t["critical_path"]))
    return out


def aggregate_table(agg: dict) -> list:
    phases = list(reqtrace.PHASES)
    hdr = (f"{'kernel|bucket|tenant':<40} {'n':>4} {'client_p99':>10} "
           + " ".join(f"{p[:9]:>9}" for p in phases))
    out = ["phase attribution (p50 ms in phase) per "
           "(kernel, bucket, tenant); client p99 ms:",
           hdr, "-" * len(hdr)]
    for key, g in agg.items():
        cells = [_ms(g["phases"][p]["p50_s"]) if p in g["phases"]
                 else " " * 8 + "-" for p in phases]
        out.append(
            f"{key:<40} {g['n']:>4} {_ms(g['client_p99_s'], 10)} "
            + " ".join(cells)
            + (f"  {g['gaps']} gap(s)" if g["gaps"] else "")
        )
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    paths: list = []
    want_request = None
    slowest = 3
    it = iter(argv)
    try:
        for a in it:
            if a == "--request":
                want_request = next(it)
            elif a == "--slowest":
                slowest = int(next(it))
            elif a.startswith("--"):
                print(__doc__, file=sys.stderr)
                print(f"trace_report: unknown argument {a!r}",
                      file=sys.stderr)
                return 2
            else:
                paths.append(a)
    except (StopIteration, ValueError):
        print(f"trace_report: {a} needs a value", file=sys.stderr)
        return 2
    if not paths:
        paths = _journal.reader_paths()
        if not paths:
            print("trace_report: no journal given and TPKT_HEALTH_JOURNAL "
                  "names none", file=sys.stderr)
            return 1

    events, bad = _journal.load_events(paths)
    tls = reqtrace.assemble(events)
    untraced = reqtrace.untraced_serve_requests(events)
    print("trace_report: " + ", ".join(os.path.relpath(p) for p in paths))
    traced = [t for t in tls.values() if t["segments"]]
    gaps = sum(len(t["gaps"]) for t in tls.values())
    hedged = sum(1 for t in tls.values() if t["hedged"])
    expired = sum(1 for t in tls.values() if t["expiries"])
    print(f"{len(tls)} request timeline(s) assembled, {len(traced)} "
          f"with span evidence, {gaps} gap(s)"
          + (f", {hedged} hedged" if hedged else "")
          + (f", {expired} expired/refused on deadline" if expired else "")
          + (f", {bad} unparseable line(s)" if bad else ""))
    if untraced:
        print(f"NOTE: {untraced} serve_request event(s) carry no "
              "request_id (old server or pre-tracing client) - served "
              "but not assembled into timelines")
    if not tls:
        print("no request timelines in this journal - run a traced "
              "loadgen --serve burst (TPKT_TRACE=1) to bank some")
        return 0

    print()
    for line in aggregate_table(reqtrace.aggregate(tls)):
        print(line)

    if want_request is not None:
        t = tls.get(want_request)
        if t is None:
            print(f"\ntrace_report: request {want_request!r} not in this "
                  f"journal; known ids e.g. {sorted(tls)[:5]}",
                  file=sys.stderr)
            return 2
        chosen = [t]
    else:
        chosen = sorted((t for t in tls.values()
                         if t["client_wall_s"] is not None),
                        key=lambda t: -(t["client_wall_s"] or 0.0)
                        )[:max(0, slowest)]
    for t in chosen:
        print()
        for line in waterfall(t):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
