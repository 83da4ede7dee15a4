"""Verdicts over the serving journal and the daily rollups.

The port's copy of the journal half of ``tpukernels/obs/trend.py``: the
analyzers ``python -m tpukernels_torch.obs.report --check`` reads.

- :func:`analyze_copy_budget` — the latest ``serve_copy_budget`` event a
  (socket, lane): payload bytes copied on a fully negotiated shm run are
  a ``copy_regression`` (gates).
- :func:`analyze_trace_budget` — the latest ``serve_trace_budget`` event
  a socket: phases summed past the client's wall on a clean request are
  ``trace_inconsistent`` (gates); thin coverage is ``trace_coverage``
  (never gates).
- :func:`analyze_pad_waste` — live pad waste after the latest
  ``adapt_promoted`` against the pad the promotion measured:
  ``pad_waste_regression`` (gates).
- :func:`analyze_p99_creep` — a kernel's daily p99 over the rollups
  (``obs/rollup.py``): ``p99_creep`` (never gates).

The bench half of the reference's module (``load_series``, ``analyze``,
the roofline check, ``analyze_repo``, the bench bands ``CEILING_EPS``
and ``REGRESSION_TOL``) reads ``BENCH_r*.json``, ``docs/logs/bench_*.json``
and ``BASELINE.json``, which are TPU figures, and waits for the port's
own bench (ROADMAP Queue A items 1 and 4). Standard library only.
"""

from __future__ import annotations

import os


def _is_measurement(v) -> bool:
    """Numeric and not a bool."""
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def analyze_copy_budget(events) -> dict:
    """Zero-copy verdicts over the ``serve_copy_budget`` events that
    ``loadgen --serve`` stamps. The budget is absolute, so only the
    latest event a (socket, lane) is judged: a run stamped
    ``expected_zero`` (the shm lane negotiated, every operand staged,
    every response under the threshold) that still copied payload bytes
    is a ``copy_regression``. Inline runs are ``ok`` with their bytes a
    request: the inline lane is O(tensor) by construction."""
    latest = {}
    for e in events:
        if e.get("kind") == "serve_copy_budget":
            latest[(str(e.get("socket")), str(e.get("lane")))] = e
    verdicts = {}
    for (sock, lane), e in sorted(latest.items()):
        bpr = e.get("bytes_per_request") or 0
        # gate on the raw count, not the rounded bytes a request: a few
        # bytes over thousands of requests round to 0.0 a request
        raw = e.get("daemon_bytes_copied")
        copied = raw if _is_measurement(raw) else bpr
        name = f"copy/{lane}[{os.path.basename(sock)}]"
        flags = []
        if e.get("expected_zero") and copied > 0:
            verdict = "copy_regression"
            flags.append(
                f"COPY REGRESSION: {copied} payload byte(s) copied "
                f"({bpr}/request) on a fully-negotiated shm run over "
                f"{e.get('requests')} request(s) - the zero-copy "
                "warm path is no longer zero"
            )
        else:
            verdict = "ok"
        verdicts[name] = {
            "verdict": verdict,
            "lane": lane,
            "bytes_per_request": bpr,
            "requests": e.get("requests"),
            "expected_zero": bool(e.get("expected_zero")),
            "flags": flags,
        }
    return verdicts


def analyze_trace_budget(events) -> dict:
    """Request-tracing verdicts over the ``serve_trace_budget`` events
    that ``loadgen --serve`` stamps, the latest a socket:

    - ``trace_inconsistent`` (gates): a clean request's phases summed
      past its client-observed wall beyond the event's ``sum_tol``
      (``reqtrace.SUM_TOL``); durations nest, so the timelines are
      wrong and so is every conclusion drawn from them;
    - ``trace_coverage`` (never gates): the phases explain less than
      the event's ``coverage_floor`` (``TPKT_TRACE_COVERAGE_MIN``) of
      the client's wall;
    - ``ok`` otherwise, a run with nothing traced included."""
    from tpukernels_torch.obs import reqtrace

    latest = {}
    for e in events:
        if e.get("kind") == "serve_trace_budget":
            latest[str(e.get("socket"))] = e
    verdicts = {}
    for sock, e in sorted(latest.items()):
        traced = e.get("traced") or 0
        tol = e.get("sum_tol")
        tol = tol if _is_measurement(tol) else reqtrace.SUM_TOL
        floor = e.get("coverage_floor")
        floor = (floor if _is_measurement(floor)
                 else reqtrace.DEFAULT_COVERAGE_MIN)
        srm = e.get("sum_ratio_max")
        cov = e.get("coverage_mean")
        name = f"trace[{os.path.basename(sock)}]"
        flags = []
        verdict = "ok"
        if traced and _is_measurement(srm) and srm > 1.0 + tol:
            verdict = "trace_inconsistent"
            flags.append(
                f"TRACE INCONSISTENT: accounted phases sum to "
                f"{srm}x of the client-observed wall on a clean "
                f"request (tolerance {tol:.0%}) over {traced} traced "
                "request(s) - the timeline assembly cannot be "
                "trusted"
            )
        elif traced and _is_measurement(cov) and cov < floor:
            verdict = "trace_coverage"
            flags.append(
                f"TRACE COVERAGE: accounted phases explain only "
                f"{cov:.0%} of the client-observed wall (floor "
                f"{floor:.0%}, TPKT_TRACE_COVERAGE_MIN; non-gating) "
                f"over {traced} traced request(s)"
            )
        verdicts[name] = {
            "verdict": verdict,
            "requests": e.get("requests"),
            "traced": traced,
            "gaps": e.get("gaps"),
            "untraced_serve_requests": e.get("untraced_serve_requests"),
            "coverage_mean": cov if _is_measurement(cov) else None,
            "sum_ratio_max": srm if _is_measurement(srm) else None,
            "flags": flags,
        }
    return verdicts


# live pad_frac may exceed a promotion's measured canary pad by this
# absolute slack before the promise counts as broken: traffic drifts,
# and the verdict is for a promotion that never delivered
PAD_WASTE_SLACK = 0.05
PAD_WASTE_MIN_REQUESTS = 20


def analyze_pad_waste(events) -> dict:
    """Whether live traffic kept the pad the latest promotion measured:
    only the latest ``adapt_promoted`` event is judged, against the OK
    ``serve_request`` events after it.

    - ``pad_waste_regression`` (gates): the live mean pad_frac exceeds
      the promoted table's measured pad_frac by more than
      :data:`PAD_WASTE_SLACK`;
    - ``no_data``: fewer than :data:`PAD_WASTE_MIN_REQUESTS` requests
      since the promotion;
    - ``ok`` otherwise. No promotion, no verdict."""
    promoted = None
    for e in events:
        if e.get("kind") == "adapt_promoted":
            promoted = e
    if promoted is None:
        return {}
    promised = promoted.get("pad_frac")
    if not _is_measurement(promised):
        return {}
    t0 = promoted.get("t")
    pads = []
    seen_promo = False
    for e in events:
        if e is promoted:
            seen_promo = True
            continue
        if e.get("kind") != "serve_request" or not e.get("ok"):
            continue
        t = e.get("t")
        if _is_measurement(t) and _is_measurement(t0):
            if t < t0:
                continue
        elif not seen_promo:
            continue  # no time stamps: the journal's order decides
        pads.append(float(e.get("pad_frac") or 0.0))
    table = os.path.basename(str(promoted.get("table") or "buckets.json"))
    name = f"pad_waste[{table}]"
    flags = []
    if len(pads) < PAD_WASTE_MIN_REQUESTS:
        verdict = "no_data"
        live = (sum(pads) / len(pads)) if pads else None
        flags.append(
            f"{len(pads)} request(s) since the promotion < min "
            f"{PAD_WASTE_MIN_REQUESTS} - no drift verdict yet"
        )
    else:
        live = sum(pads) / len(pads)
        if live > promised + PAD_WASTE_SLACK:
            verdict = "pad_waste_regression"
            flags.append(
                f"PAD WASTE REGRESSION: live mean pad_frac {live:.3f} "
                f"over {len(pads)} request(s) exceeds the promoted "
                f"table's measured {promised:.3f} by more than "
                f"{PAD_WASTE_SLACK} - the traffic has drifted off the "
                "promoted buckets; re-propose"
            )
        else:
            verdict = "ok"
    return {name: {
        "verdict": verdict,
        "promised_pad_frac": promised,
        "live_pad_frac": round(live, 6) if live is not None else None,
        "requests": len(pads),
        "slack": PAD_WASTE_SLACK,
        "flags": flags,
    }}


# a kernel's latest daily p99 may sit this far above the median of its
# prior days before the drift counts as creep: daily p99s are noisy, and
# the verdict is for the slow drift over days a per-run band misses
P99_CREEP_FRAC = 0.05
P99_CREEP_MIN_DAYS = 3


def analyze_p99_creep(series) -> dict:
    """Tail drift over a daily rollup series (``rollup.load_series``:
    ``[(date, rollup), ...]`` ascending), a kernel at a time, off the
    rollup's ``requests`` rows:

    - ``p99_creep`` (never gates): the latest day's p99 is more than
      :data:`P99_CREEP_FRAC` above the median of the prior days' and is
      the worst day in the window; a spike that recovered stays ``ok``;
    - ``no_data``: fewer than :data:`P99_CREEP_MIN_DAYS` days carry a
      p99 for the kernel;
    - ``ok`` otherwise. An empty series gives no verdict."""
    by_kernel: dict = {}
    for date, r in series:
        for kernel, row in sorted((r.get("requests") or {}).items()):
            p99 = (row or {}).get("p99")
            if _is_measurement(p99) and (row or {}).get("count"):
                by_kernel.setdefault(kernel, []).append(
                    (date, float(p99), row.get("count")))
    verdicts = {}
    for kernel, pts in sorted(by_kernel.items()):
        name = f"p99_creep[{kernel}]"
        flags = []
        if len(pts) < P99_CREEP_MIN_DAYS:
            verdicts[name] = {
                "verdict": "no_data",
                "days": len(pts),
                "latest": pts[-1][1],
                "baseline": None,
                "flags": [
                    f"{len(pts)} day(s) with p99 data < min "
                    f"{P99_CREEP_MIN_DAYS} - no drift verdict yet"
                ],
            }
            continue
        prior = sorted(p for _, p, _ in pts[:-1])
        mid = len(prior) // 2
        baseline = (prior[mid] if len(prior) % 2
                    else 0.5 * (prior[mid - 1] + prior[mid]))
        date, latest, count = pts[-1]
        creeping = (
            baseline > 0.0
            and latest > baseline * (1.0 + P99_CREEP_FRAC)
            and latest >= max(p for _, p, _ in pts)
        )
        if creeping:
            verdict = "p99_creep"
            flags.append(
                f"P99 CREEP: {kernel} p99 {latest:.6f}s on {date} "
                f"({count} request(s)) is "
                f"{latest / baseline:.3f}x the median of the prior "
                f"{len(prior)} day(s) ({baseline:.6f}s) and the worst "
                f"day in the window (band {P99_CREEP_FRAC:.0%}; "
                "non-gating long-horizon signal)"
            )
        else:
            verdict = "ok"
        verdicts[name] = {
            "verdict": verdict,
            "days": len(pts),
            "latest": round(latest, 6),
            "latest_date": date,
            "baseline": round(baseline, 6),
            "creep_frac": P99_CREEP_FRAC,
            "flags": flags,
        }
    return verdicts
