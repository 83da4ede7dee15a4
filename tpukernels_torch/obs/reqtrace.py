"""Per-request timelines assembled from the serving journals.

The port's copy of ``tpukernels/obs/reqtrace.py``. It joins what the
serving processes journal — the client's ``serve_client_request`` walls
(``loadgen --serve``), a router's ``serve_route``/``serve_spill``
placements, the daemons' ``serve_request`` records and request-tagged
``span`` events — on the client-minted ``request_id`` into one timeline
a request (:func:`assemble`), decomposes each into phases and a critical
path, aggregates phase percentiles per (kernel, bucket, tenant)
(:func:`aggregate`) and summarises one run (:func:`run_budget`, the
``serve_trace_budget`` event ``loadgen --serve`` stamps).

- **Clocks**: durations (``wall_s``) are monotonic spans; each
  segment's display offset is anchored to its own process's
  ``serve_start`` (or its first segment), never to another pid's clock.
- **Gaps are explicit**: a requeued (abandoned) worker attempt, a
  replay off a dead worker or router (``via: "wal"``), a hedge, a
  cancelled loser, an expired or infeasible deadline, and a client-seen
  request no worker journaled each add a gap entry, never a silently
  shorter phase sum.
- **Never raises on journal content**: unknown kinds are skipped, a
  journal without request ids assembles to nothing, and
  :func:`untraced_serve_requests` counts what could not be joined.

Phases (seconds, exclusive): ``queue_wait``, ``lock_wait``, ``pad``,
``dispatch`` (the ``serve/<kernel>`` span minus its aot/integrity
children), ``compile`` (``aot/`` spans), ``integrity`` and
``unaccounted`` (client wall minus the rest: wire, relay, client work).
``accounted / client_wall`` under :func:`coverage_min`
(``TPKT_TRACE_COVERAGE_MIN``) flags a thin trace; over ``1 +``
:data:`SUM_TOL` on a clean request it is inconsistent.

Standard library only.
"""

from __future__ import annotations

import os

# accounted phases may not exceed the client-observed wall beyond
# this fraction on a clean request: durations nest physically, so an
# overrun means double-counted or mis-joined segments (the documented
# tolerance absorbs sub-ms rounding of the journal's stamps)
SUM_TOL = 0.10

DEFAULT_COVERAGE_MIN = 0.5

# report ordering for the phase tables (unaccounted always last)
PHASES = ("queue_wait", "lock_wait", "pad", "dispatch", "compile",
          "integrity", "unaccounted")


def coverage_min() -> float:
    """``TPKT_TRACE_COVERAGE_MIN`` (default 0.5), fail-loud parse in
    [0, 1]: the documented fraction of the client-observed wall the
    accounted phases must cover before a timeline stops flagging
    ``trace_coverage`` (non-gating)."""
    raw = os.environ.get("TPKT_TRACE_COVERAGE_MIN")
    if raw is None or not raw.strip():
        return DEFAULT_COVERAGE_MIN
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not 0.0 <= val <= 1.0:
        raise ValueError(
            f"TPKT_TRACE_COVERAGE_MIN={raw!r}: expected a float in "
            "[0, 1]"
        )
    return val


def phase_of(name: str) -> str | None:
    """Span path → timeline phase. aot/integrity children classify by their own area
    wherever they nest; anything else under ``serve/`` or
    ``dispatch/`` is dispatch work."""
    if "aot/" in name:
        return "compile"
    if "integrity/" in name:
        return "integrity"
    if name.startswith("serve/wait/queue"):
        return "queue_wait"
    if name.startswith("serve/wait/lock"):
        return "lock_wait"
    if name.startswith("serve/pad"):
        return "pad"
    if name.startswith(("serve/", "dispatch/")):
        return "dispatch"
    return None


def untraced_serve_requests(events) -> int:
    """``serve_request`` events carrying NO request_id — a
    pre-tracing server or client in the mix. Counted so every
    consumer degrades loudly instead of silently assembling a partial
    story."""
    return sum(
        1 for e in events
        if e.get("kind") == "serve_request"
        and e.get("request_id") is None
    )


def _new_timeline(rid) -> dict:
    return {
        "request_id": rid, "kernel": None, "bucket": None,
        "tenant": None, "worker_id": None,
        "client": None, "server": [], "route": [], "spills": [],
        "rejections": 0, "throttles": 0, "requeued": False,
        "replayed": False, "hedged": False,
        "hedges": [], "cancels": [], "expiries": [],
        "segments": [], "gaps": [],
    }


def assemble(events) -> dict:
    """``{request_id: timeline}`` over journal events (any mix of
    processes/files). Tolerant by design: unknown kinds are skipped,
    malformed stamps contribute what they can, and nothing here ever
    raises on journal content — a truncated journal is exactly when a
    postmortem needs whatever assembles."""
    anchors: dict = {}   # pid -> its own serve_start wall-clock t
    tls: dict = {}

    def tl(rid):
        t = tls.get(rid)
        if t is None:
            t = tls[rid] = _new_timeline(rid)
        return t

    for ev in events:
        kind = ev.get("kind")
        if kind == "serve_start":
            pid = ev.get("pid")
            if pid is not None and pid not in anchors:
                anchors[pid] = ev.get("t")
            continue
        rid = ev.get("request_id")
        if rid is None:
            continue
        rid = str(rid)
        if kind == "serve_client_request":
            t = tl(rid)
            t["client"] = ev
            t["kernel"] = t["kernel"] or ev.get("kernel")
            if ev.get("tenant") is not None:
                t["tenant"] = ev.get("tenant")
        elif kind == "serve_request":
            t = tl(rid)
            t["server"].append(ev)
        elif kind == "serve_route":
            t = tl(rid)
            t["route"].append(ev)
            t["kernel"] = t["kernel"] or ev.get("kernel")
            t["bucket"] = t["bucket"] or ev.get("bucket")
        elif kind == "serve_spill":
            tl(rid)["spills"].append(ev)
        elif kind == "serve_hedged":
            t = tl(rid)
            t["hedged"] = True
            t["hedges"].append(ev)
            t["gaps"].append({
                "kind": "hedged", "pid": ev.get("pid"),
                "t": ev.get("t"),
                "detail": (f"worker {ev.get('from_worker')} outlived "
                           "the hedge threshold "
                           f"({ev.get('threshold_s')}s); same "
                           "request_id re-issued to sibling "
                           f"{ev.get('to_worker')} — first response "
                           "wins, loser cancelled"),
            })
        elif kind == "serve_cancelled":
            t = tl(rid)
            t["cancels"].append(ev)
            where = (f"worker {ev.get('to_worker')}"
                     if ev.get("to_worker") is not None
                     else f"phase {ev.get('phase')}")
            t["gaps"].append({
                "kind": "cancelled", "pid": ev.get("pid"),
                "t": ev.get("t"),
                "detail": (f"hedge loser cancelled at "
                           f"{ev.get('site')} ({where}) — its work "
                           "was dropped or its reply suppressed"),
            })
        elif kind == "serve_request_expired":
            t = tl(rid)
            t["expiries"].append(ev)
            t["gaps"].append({
                "kind": "deadline-expired", "pid": ev.get("pid"),
                "t": ev.get("t"),
                "detail": (f"budget ran out at {ev.get('site')}"
                           f"/{ev.get('where')} before dispatch — "
                           "the wait phases above are where the "
                           "budget went"),
            })
        elif kind == "serve_deadline_infeasible":
            t = tl(rid)
            t["expiries"].append(ev)
            t["gaps"].append({
                "kind": "deadline-infeasible", "pid": ev.get("pid"),
                "t": ev.get("t"),
                "detail": ("refused at router admission: the budget "
                           "was already spent before arrival"),
            })
        elif kind == "serve_rejected":
            tl(rid)["rejections"] += 1
        elif kind == "serve_tenant_throttled":
            # a throttled-then-retried request's wall includes the
            # backoff sleeps no span covers: it must not feed the
            # consistency/coverage gate as "clean"
            tl(rid)["throttles"] += 1
        elif kind == "serve_request_replayed":
            t = tl(rid)
            t["replayed"] = True
            if ev.get("via") == "wal":
                # the ROUTER died holding this accepted request; a
                # respawned router replayed it from its WAL
                t["gaps"].append({
                    "kind": "dead-router", "pid": ev.get("pid"),
                    "t": ev.get("t"),
                    "detail": ("the router died holding this "
                               "accepted request; "
                               + (f"replayed from its WAL on worker "
                                  f"{ev.get('to_worker')}"
                                  if ev.get("ok") is not False else
                                  "its WAL replay skipped it "
                                  f"({ev.get('reason')}) and the "
                                  "client retried")
                               + " — the first attempt's evidence "
                               "died with the router"),
                })
            else:
                t["gaps"].append({
                    "kind": "dead-worker", "pid": ev.get("pid"),
                    "t": ev.get("t"),
                    "detail": (f"worker {ev.get('from_worker')} died "
                               "holding this request; replayed on "
                               f"worker {ev.get('to_worker')} — the "
                               "home attempt's evidence died with "
                               "it"),
                })
        elif kind == "serve_request_requeued":
            t = tl(rid)
            t["requeued"] = True
            t["gaps"].append({
                "kind": "abandoned-worker", "pid": ev.get("pid"),
                "t": ev.get("t"),
                "detail": (f"worker abandoned after "
                           f"{ev.get('timeout_s')}s; the attempt's "
                           "spans may never close"),
            })
        elif kind == "span":
            wall = ev.get("wall_s")
            wall = wall if isinstance(wall, (int, float)) else 0.0
            te = ev.get("t")
            te = te if isinstance(te, (int, float)) else 0.0
            name = str(ev.get("name") or "?")
            tl(rid)["segments"].append({
                "name": name, "phase": phase_of(name),
                "pid": ev.get("pid"), "wall_s": wall,
                "t0": te - wall, "t1": te,
                "depth": ev.get("depth") or 1,
                "ok": ev.get("ok", True),
            })

    for t in tls.values():
        _finalize(t, anchors)
    return tls


def _finalize(t: dict, anchors: dict):
    segs = t["segments"]
    segs.sort(key=lambda s: (str(s["pid"]), s["t0"]))
    # per-process anchoring: each segment's display offset is
    # relative to ITS OWN process's serve_start (fallback: the pid's
    # first segment) — cross-process clock skew moves a lane's
    # anchor, never the phase arithmetic (durations only)
    first_by_pid: dict = {}
    for s in segs:
        first_by_pid.setdefault(s["pid"], s["t0"])
    for s in segs:
        anchor = anchors.get(s["pid"])
        if anchor is None:
            anchor = first_by_pid[s["pid"]]
        s["rel0"] = round(max(0.0, s["t0"] - anchor), 6)
        s["rel1"] = round(max(0.0, s["t1"] - anchor), 6)

    # the request of record among (possibly several — a wedged home
    # attempt plus its spill sibling) server records: prefer the ok
    # answer, else the latest
    final = None
    for ev in sorted(t["server"], key=lambda e: e.get("t") or 0.0):
        if final is None:
            final = ev
        elif bool(ev.get("ok")) or not final.get("ok"):
            # an ok answer beats any failure; among equals the
            # latest wins (the spill sibling supersedes the home)
            final = ev
    t["final"] = final
    if final is not None:
        t["kernel"] = t["kernel"] or final.get("kernel")
        t["bucket"] = final.get("bucket") or t["bucket"]
        t["tenant"] = (final.get("tenant")
                       if final.get("tenant") is not None
                       else t["tenant"])
        t["worker_id"] = final.get("worker_id")
    client = t["client"]
    if (final is None and client is not None and client.get("ok")
            and t["rejections"] == 0):
        t["gaps"].append({
            "kind": "missing-server-record", "pid": None, "t": None,
            "detail": ("client saw a completed request but no worker "
                       "journaled it (worker died or journals "
                       "elsewhere)"),
        })

    phases = {ph: 0.0 for ph in PHASES if ph != "unaccounted"}
    top_dispatch = 0.0
    for s in segs:
        ph = s["phase"]
        if ph in ("queue_wait", "lock_wait", "pad",
                  "compile", "integrity"):
            phases[ph] += s["wall_s"]
        elif ph == "dispatch" and s["depth"] == 1:
            # depth-1 serve/<kernel> (or in-process dispatch/<kernel>)
            # spans only: their nested dispatch/aot children are
            # interior and must not double-count
            top_dispatch += s["wall_s"]
    phases["dispatch"] = max(
        0.0, top_dispatch - phases["compile"] - phases["integrity"]
    )
    accounted = (phases["queue_wait"] + phases["lock_wait"]
                 + phases["pad"] + top_dispatch)
    t["accounted_s"] = round(accounted, 6)
    cw = None
    if client is not None and isinstance(client.get("wall_s"),
                                         (int, float)):
        cw = client["wall_s"]
    t["client_wall_s"] = cw
    if cw and segs:
        t["coverage"] = round(accounted / cw, 4)
        phases["unaccounted"] = max(0.0, cw - accounted)
    else:
        t["coverage"] = None
    t["phases"] = {ph: round(v, 6) for ph, v in phases.items() if v}
    t["clean"] = bool(
        final is not None and final.get("ok")
        and not t["requeued"] and not t["spills"]
        and not t["replayed"] and not t["hedged"]
        and not t["expiries"]
        and t["rejections"] == 0 and t["throttles"] == 0
        and len(t["server"]) == 1
    )
    ranked = sorted(t["phases"].items(), key=lambda kv: -kv[1])
    t["critical_path"] = ranked
    t["dominant"] = ranked[0][0] if ranked else None


def _pct(vals, q):
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def aggregate(timelines) -> dict:
    """Phase-attribution percentiles per (kernel, bucket, tenant)
    over assembled timelines (``obs/trace_report.py``'s table).
    Keys are
    ``kernel|bucket|tenant``; per key: request count, client-wall
    p50/p99 and per-phase p50/p99/mean seconds."""
    groups: dict = {}
    for t in timelines.values():
        key = (t["kernel"] or "?", t["bucket"] or "-",
               t["tenant"] or "-")
        g = groups.setdefault(key, {"n": 0, "client": [],
                                    "phases": {}, "gaps": 0})
        g["n"] += 1
        g["gaps"] += len(t["gaps"])
        if t["client_wall_s"] is not None:
            g["client"].append(t["client_wall_s"])
        for ph, v in t.get("phases", {}).items():
            g["phases"].setdefault(ph, []).append(v)
    out = {}
    for (kernel, bucket, tenant), g in sorted(groups.items()):
        out[f"{kernel}|{bucket}|{tenant}"] = {
            "kernel": kernel, "bucket": bucket, "tenant": tenant,
            "n": g["n"], "gaps": g["gaps"],
            "client_p50_s": _pct(g["client"], 0.5),
            "client_p99_s": _pct(g["client"], 0.99),
            "phases": {
                ph: {
                    "n": len(vals),
                    "p50_s": _pct(vals, 0.5),
                    "p99_s": _pct(vals, 0.99),
                    "mean_s": round(sum(vals) / len(vals), 6),
                }
                for ph, vals in sorted(g["phases"].items())
            },
        }
    return out


def run_budget(events, request_ids=None) -> dict | None:
    """One run's trace-budget summary — the payload ``loadgen
    --serve`` stamps as a ``serve_trace_budget`` event (the
    ``serve_copy_budget`` pattern) for ``trend.analyze_trace_budget``
    to judge. ``request_ids`` restricts to the ids the run minted so
    a shared journal's other traffic cannot pollute the verdict.
    Returns None when nothing assembled (journal off, no serve
    traffic)."""
    tls = assemble(events)
    if request_ids is not None:
        wanted = {str(r) for r in request_ids}
        tls = {r: t for r, t in tls.items() if r in wanted}
    if not tls:
        return None
    traced = [t for t in tls.values() if t["segments"]]
    cov = [t["coverage"] for t in traced if t["coverage"] is not None]
    clean = [t["coverage"] for t in traced
             if t["clean"] and t["coverage"] is not None]
    out = {
        "requests": (len(request_ids) if request_ids is not None
                     else len(tls)),
        "assembled": len(tls),
        "traced": len(traced),
        "clean": len(clean),
        "gaps": sum(len(t["gaps"]) for t in tls.values()),
        "hedged": sum(1 for t in tls.values() if t["hedged"]),
        "expired": sum(1 for t in tls.values() if t["expiries"]),
        "untraced_serve_requests": untraced_serve_requests(events),
        "coverage_floor": coverage_min(),
        "sum_tol": SUM_TOL,
    }
    if cov:
        out["coverage_mean"] = round(sum(cov) / len(cov), 4)
        out["coverage_low"] = round(min(cov), 4)
    if clean:
        # the gating surface: only CLEAN requests — an abandoned
        # attempt's late-unwinding span can legitimately overrun the
        # client wall that stopped waiting for it
        out["sum_ratio_max"] = round(max(clean), 4)
    return out
