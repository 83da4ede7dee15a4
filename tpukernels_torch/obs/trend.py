"""Verdicts over the bench's persisted lines, the serving journal and the
daily rollups.

The port's copy of ``tpukernels/obs/trend.py``: the analyzers ``python -m
tpukernels_torch.obs.report --check`` reads.

The bench half (:func:`load_series`, :func:`analyze`,
:func:`analyze_repo`): the H100 bench lines in ``$TPKT_BENCH_DIR``
(``_cachedir.bench_dir``), one a file, ordered by the stamp in the file's
name. Only a line with ``device: "h100"`` and no ``"smoke": true`` counts,
and never a ``<metric>_host`` twin (it moves with the host);
``BENCH_r*.json``, ``docs/logs/`` and ``BASELINE.json`` (the reference's
TPU figures) are never read. An unreachable line's
``details.last_persisted_artifact`` joins the series at its own
artifact's place, once; string details are never evidence;
``invalidated`` raws feed the ceiling check alone. Verdicts a metric:

- ``impossible`` — a raw value over its ceiling (``bench.ceilings()``,
  computed) beyond the 1 % band and never invalidated; it dominates;
- ``regression`` — the newest valid value more than the band under the
  best earlier one or under the H100 median (``baseline_h100.json``);
  tighter than the gate's 15 % on purpose: this is a report;
- ``no_data`` — no valid measurement anywhere: retryable, never a failure;
- ``below_roofline`` — trend-``ok`` but under ``TPKT_ROOFLINE_MIN_FRAC``
  (default 0.5) of the metric's roofline (``tuning/roofline.py``); never
  gates, and only ever replaces ``ok``; the L2-resident SAXPY gets none;
- ``ok`` — otherwise.

:data:`CEILING_EPS` and :data:`REGRESSION_TOL` equal the bench's own
constants (a test holds them so; importing ``bench`` here would import
torch).

The journal half:

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

Standard library only.
"""

from __future__ import annotations

import json
import os

from tpukernels_torch.tuning import roofline


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


# ------------------------------------------------------------------ #
# the bench half: persisted H100 lines, their series and verdicts     #
# ------------------------------------------------------------------ #

CEILING_EPS = 0.01     # == bench._CEILING_EPS (a test holds them equal)
REGRESSION_TOL = 0.15  # == bench._REGRESSION_TOL (the same)
# a metric's host-issued twin in the line's details: not a series
HOST_SUFFIX = "_host"

def is_evidence(rec) -> bool:
    """Whether a bench line may count as evidence: a line of the card
    (``device: "h100"``) that is not a CPU smoke line. A TPU figure, a
    smoke line or anything else never counts (``bench``'s scanners and
    this module's series alike)."""
    return (isinstance(rec, dict) and rec.get("device") == "h100"
            and not rec.get("smoke"))


def load_baseline() -> dict:
    """The port's H100 baseline (``_cachedir.bench_baseline_path``, the
    file ``bench`` judges against), with ``ceilings`` computed
    (``roofline.ceilings``, what ``bench.ceilings`` returns); {} plus the
    ceilings when it is missing or torn."""
    from tpukernels_torch import _cachedir

    try:
        with open(_cachedir.bench_baseline_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    if not isinstance(data, dict):
        data = {}
    return dict(data, ceilings=roofline.ceilings())


def _numeric_table(d) -> dict:
    """The numeric entries of a baseline block (no notes, no dates)."""
    return {k: v for k, v in (d or {}).items() if _is_measurement(v)}


def _bench_line(rec):
    """``rec`` when it is a bench line with a ``details`` dict that counts
    as evidence (:func:`is_evidence`), else None."""
    if is_evidence(rec) and isinstance(rec.get("details"), dict):
        return rec
    return None


def _points_from_line(line, source, order, out):
    """Append the line's evidence to the series ``out``: measured details
    as valid points, invalidated raw values as points for the ceiling
    check alone; never a ``<metric>_host`` twin, which moves with the
    host (``bench`` never gates on one either). Returns the nested
    ``last_persisted_artifact`` (or None) for the caller, which holds the
    dedupe state."""
    details = line.get("details") or {}
    for name, v in details.items():
        if _is_measurement(v) and not name.endswith(HOST_SUFFIX):
            out.setdefault(name, []).append(
                {"value": v, "raw": v, "source": source, "order": order,
                 "invalidated": None})
    for name, iv in (line.get("invalidated") or {}).items():
        raw = iv[0] if isinstance(iv, (list, tuple)) and iv else None
        if _is_measurement(raw):
            out.setdefault(name, []).append(
                {"value": None, "raw": raw, "source": source, "order": order,
                 "invalidated": str(iv[1]) if len(iv) > 1 else "?"})
    nested = details.get("last_persisted_artifact")
    return nested if isinstance(nested, dict) else None


def load_series(bench_dir=None) -> dict:
    """``{metric: [point, ...]}`` over the evidence lines in ``bench_dir``
    (default ``_cachedir.bench_dir()``), each series oldest to newest by
    the stamp in the file's name. A line's nested
    ``last_persisted_artifact`` joins the series at its own artifact's
    place, once however many lines point at it. Unparseable files are
    skipped."""
    import glob

    from tpukernels_torch import _cachedir

    bench_dir = bench_dir or _cachedir.bench_dir()
    out: dict = {}
    seen: set = set()

    def _nested(nest):
        name = nest.get("path")
        line = _bench_line(nest.get("line"))
        if not isinstance(name, str) or line is None:
            return
        key = os.path.basename(os.path.normpath(name))
        if key in seen:
            return
        seen.add(key)
        deeper = _points_from_line(line, key, key, out)
        if deeper is not None:
            _nested(deeper)

    for p in sorted(glob.glob(os.path.join(bench_dir, "bench_*.json")),
                    key=os.path.basename):
        try:
            with open(p) as f:
                line = _bench_line(json.loads(f.read().strip() or "null"))
        except (OSError, ValueError):
            continue
        if line is None:
            continue
        name = os.path.basename(p)
        seen.add(name)
        nest = _points_from_line(line, name, name, out)
        if nest is not None:
            _nested(nest)
    for pts in out.values():
        pts.sort(key=lambda pt: pt["order"])
    return out


def analyze(series, baseline=None, eps=CEILING_EPS) -> dict:
    """Verdicts a metric over :func:`load_series`' output (the module
    docstring has the rules); ``flags`` holds one line a finding. A
    metric the baseline knows and the series lacks is ``no_data``."""
    baseline = baseline or {}
    ceilings = _numeric_table(baseline.get("ceilings"))
    measured = _numeric_table(baseline.get("measured"))
    verdicts = {}
    for metric in sorted(set(series) | set(measured)):
        pts = series.get(metric, [])
        ceiling = ceilings.get(metric)
        flags, valid = [], []
        impossible = False
        for pt in pts:
            raw = pt["raw"]
            if ceiling is not None and raw is not None and \
                    raw > ceiling * (1.0 + eps):
                if pt["invalidated"]:
                    flags.append(f"{raw} from {pt['source']} exceeds ceiling "
                                 f"{ceiling} - already invalidated at source "
                                 f"({pt['invalidated']})")
                else:
                    impossible = True
                    flags.append(f"IMPOSSIBLE: {raw} from {pt['source']} "
                                 f"exceeds the ceiling {ceiling} (+{eps:.0%})"
                                 " and was never invalidated")
                continue
            if pt["value"] is not None:
                valid.append(pt)
        base = measured.get(metric)
        info = {
            "valid_points": len(valid),
            "latest": valid[-1]["value"] if valid else None,
            "latest_source": valid[-1]["source"] if valid else None,
            "best": max((p["value"] for p in valid), default=None),
            "baseline": base,
            "flags": flags,
        }
        if impossible:
            info["verdict"] = "impossible"
        elif not valid:
            info["verdict"] = "no_data"
            flags.append("no valid measurement in any artifact (a null is "
                         "no data, not a regression)")
        else:
            latest = info["latest"]
            regressed = False
            prior_best = max((p["value"] for p in valid[:-1]), default=None)
            if prior_best and latest < prior_best * (1.0 - eps):
                regressed = True
                flags.append(f"REGRESSION: latest {latest} "
                             f"({info['latest_source']}) is "
                             f"{latest / prior_best:.3f}x of prior best "
                             f"{prior_best} (band {eps:.0%})")
            if base and latest < base * (1.0 - eps):
                regressed = True
                flags.append(f"REGRESSION: latest {latest} is "
                             f"{latest / base:.3f}x of the H100 median "
                             f"{base} (band {eps:.0%}; the gate fails below "
                             f"{1.0 - REGRESSION_TOL:.2f}x)")
            info["verdict"] = "regression" if regressed else "ok"
            if info["verdict"] == "ok":
                # only an ok verdict is judged against the roofline:
                # below_roofline never hides a regression, an impossible
                # value or a hole in the data
                roof = _roofline_check(metric, latest)
                if roof is not None:
                    info["roofline"] = roof
                    if roof["below"]:
                        info["verdict"] = "below_roofline"
                        flags.append(
                            f"BELOW ROOFLINE: latest {latest} is "
                            f"{roof['frac']:.1%} of the {roof['bound']}-bound "
                            f"peak {roof['peak']:,.0f} on "
                            f"{roof['device_kind']} (threshold "
                            f"{roof['min_frac']:.0%}, TPKT_ROOFLINE_MIN_FRAC;"
                            " non-gating headroom signal)")
        verdicts[metric] = info
    return verdicts


def _roofline_check(metric, latest):
    """``{peak, frac, bound, device_kind, min_frac, below}`` for a metric
    with a roofline model, else None; ``below`` is False for an
    L2-resident configuration whatever its fraction."""
    if metric not in roofline.MODELS:
        return None
    p = roofline.peak(metric)
    frac = latest / p["peak"]
    mf = roofline.min_frac()
    return {"peak": p["peak"], "frac": frac, "bound": p["bound"],
            "device_kind": p["device_kind"], "min_frac": mf,
            "below": (not p["artifact"]) and frac < mf}


def analyze_repo(bench_dir=None, eps=CEILING_EPS) -> dict:
    """The series, the baseline and the verdicts in one call."""
    return analyze(load_series(bench_dir), load_baseline(), eps=eps)
