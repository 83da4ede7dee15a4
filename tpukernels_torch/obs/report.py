"""Observability report of the port: spans, metrics and the gating verdicts.

    python -m tpukernels_torch.obs.report [--check | --roofline] [--root DIR]
                                          [--journal FILE] [--eps F]

The port's copy of ``tools/obs_report.py``, over the port's own evidence:
the journal, and the state directories of ``_cachedir`` (``--root DIR``
puts every directory that no ``TPKT_*_DIR`` knob redirects under
``DIR/.tpkt_cache``; default the repository). It never opens
``BENCH_r*.json``, ``BASELINE.json`` or anything under ``docs/logs/``:
those are the reference's TPU figures.

Sections:

1. **Bench trend** — ``trend.analyze_repo`` over the H100 bench lines
   in ``_cachedir.bench_dir()``: each metric's points, latest, best and
   H100 median (``baseline_h100.json``) and its verdict. ``--eps`` moves
   the trend band (default ``trend.CEILING_EPS``).
2. **Roofline** — ``tuning/roofline.py``'s table: each metric's latest
   value against its roofline peak on the evidence kind (``h100``) and
   against its bench ceiling. ``--roofline`` prints this section alone.
3. **Span breakdown** — wall time a span name (``TPKT_TRACE=1`` runs).
4. **Supervisor steps** — ``step/<name>`` spans and the ``step_done``
   and ``step_quarantined`` events of the revalidation supervisor
   (``resilience/supervisor.py``, ``python -m
   tpukernels_torch.revalidate``): runs, wall time and outcomes a step.
5. **AOT** — ``aot_hit``/``aot_miss`` with their build, load and plan
   seconds, ``aot_rejected``, ``prewarm_end``.
6. **Output integrity** — guard traffic from the metric snapshots,
   confirmed ``output_integrity_failed`` events, today's quarantine
   ledger (``_cachedir.integrity_quarantine_path``, read without torch).
7. **Latency SLOs** — the validated ``slo.json`` (``_cachedir.slo_path``).
8. **Scaling** — ``obs/scaling.analyze_repo`` over
   ``_cachedir.scaling_dir``; fake and ``shared-card`` series never gate.
9. **Serve copy budget** — ``trend.analyze_copy_budget``.
10. **Adaptive buckets** — the latest ``adapt_*`` events and the live
    ``serve.bucket_pad_frac`` against ``TPKT_ADAPT_PAD_TARGET``.
11. **Request phases** — ``obs/reqtrace.py``'s timelines and
    ``trend.analyze_trace_budget`` (waterfalls:
    ``python -m tpukernels_torch.obs.trace_report``).
12. **Shapes seen** — the requested shapes a (kernel, bucket).
13. **Deadlines** — expiries, refusals, hedges, cancels, goodput.
14. **Metric snapshots** — ``metrics.merge_journal_metrics``.
15. **Daily rollups** — ``obs/rollup.py``'s series and the non-gating
    ``p99_creep`` verdicts.

The journal is ``--journal FILE``, else ``TPKT_HEALTH_JOURNAL`` (a
directory means its newest ``health_*.jsonl``); with neither the
journal sections are empty. It is never the newest file under
``docs/logs/``, which the reference reads by default.

Exit codes (the reference's ``--check`` contract):
    0 — nothing gating: no bench ``regression`` or ``impossible``, no
        confirmed ``output_integrity_failed`` event,
        no validated non-simulated ``slo_breach``, no validated
        (non-fake) scaling ``regression`` or ``impossible``, no
        ``copy_regression``, ``pad_waste_regression`` or
        ``trace_inconsistent``;
    1 — at least one of those (a wrong answer, a breached tail, a copied
        byte on the zero-copy lane, a promoted table that stopped
        delivering, an inconsistent timeline all gate alike);
    2 — usage error (never 1: rc 1 is reserved for real findings).
``below_roofline``, ``below_scaling_efficiency``, ``overlap_low``,
``trace_coverage`` and ``p99_creep`` print as information and never gate;
``no_data`` is retryable, never a failure. ``--roofline`` exits 1 on a
bench ``regression`` or ``impossible``, as the reference's.

``--check`` prints only the non-ok verdict lines and a summary; the
default prints the whole report. Standard library only: no torch.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics as _metrics
from tpukernels_torch.obs import reqtrace as _reqtrace
from tpukernels_torch.obs import rollup as _rollup
from tpukernels_torch.obs import scaling as _scaling
from tpukernels_torch.obs import slo as _slo
from tpukernels_torch.obs import trace, trend
from tpukernels_torch.resilience import journal as _journal
from tpukernels_torch.tuning import roofline as _roofline

# the bench verdicts that gate
BENCH_GATING = ("regression", "impossible")

def _fmt_val(v):
    if v is None:
        return "-"
    return f"{v:,.2f}" if isinstance(v, float) else f"{v:,}"


@contextlib.contextmanager
def state_root(root):
    """Every state directory no ``TPKT_*_DIR`` knob redirects, under
    ``root/.tpkt_cache`` for the block (None: the repository's)."""
    if root is None:
        yield
        return
    moved = _cachedir.state_dirs_under(
        os.path.join(os.path.abspath(root), ".tpkt_cache"))
    added = [k for k in moved if not os.environ.get(k)]
    for k in added:
        os.environ[k] = moved[k]
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def trend_section(verdicts, out):
    out.append(f"== bench trend (H100 lines in {_cachedir.bench_dir()}) ==")
    hdr = (f"{'metric':<22} {'pts':>3} {'latest':>15} {'best':>15} "
           f"{'baseline':>15}  verdict")
    out.append(hdr)
    out.append("-" * len(hdr))
    for name, v in verdicts.items():
        out.append(f"{name:<22} {v['valid_points']:>3} "
                   f"{_fmt_val(v['latest']):>15} {_fmt_val(v['best']):>15} "
                   f"{_fmt_val(v['baseline']):>15}  {v['verdict']}")
        for flag in v["flags"]:
            out.append(f"    {flag}")


def roofline_section(verdicts, out):
    """Each metric's latest value against its roofline peak and against
    its bench ceiling: two yardsticks (``tuning/roofline.py``)."""
    rows = _roofline.report_rows(verdicts)
    out.append("")
    kind = rows[0]["device_kind"] if rows else "?"
    basis = rows[0]["basis"] if rows else "?"
    out.append(f"== roofline ({kind} peaks, {basis}; threshold "
               f"{_roofline.min_frac():.0%}) ==")
    hdr = (f"{'metric':<22} {'achieved':>15} {'roofline peak':>15} "
           f"{'% roofline':>10} {'bound':>9} {'ceiling':>15} "
           f"{'% ceiling':>9}  verdict")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        frac = f"{r['frac']:.1%}" if r["frac"] is not None else "-"
        cfrac = (f"{r['ceiling_frac']:.1%}" if r["ceiling_frac"] is not None
                 else "-")
        out.append(f"{r['metric']:<22} {_fmt_val(r['achieved']):>15} "
                   f"{r['peak']:>15,.1f} {frac:>10} {r['bound']:>9} "
                   f"{_fmt_val(r['ceiling']):>15} {cfrac:>9}  "
                   f"{r['verdict'] or '-'}")
        if r["note"]:
            out.append(f"    {r['note']}")


def span_section(events, out):
    agg = trace.aggregate_spans(events)
    n = sum(a["count"] for a in agg.values())
    out.append("")
    out.append(f"== span breakdown ({n} span events) ==")
    if not agg:
        out.append("(no spans - run with TPKT_TRACE=1 to record them)")
        return
    hdr = (f"{'span':<34} {'count':>5} {'total_s':>10} {'mean_s':>9} "
           f"{'max_s':>9}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for name in sorted(agg, key=lambda k: -agg[k]["total_s"]):
        a = agg[name]
        out.append(
            f"{name:<34} {a['count']:>5} {a['total_s']:>10.3f} "
            f"{a['total_s'] / a['count']:>9.3f} {a['max_s']:>9.3f}"
        )


def step_section(events, out):
    """Supervisor steps: wall time from the ``step/<name>`` spans,
    attempts, outcomes and quarantine from the ``step_*`` events."""
    # spans nest under their parents ("queue/run/step/bench"): key on
    # the segment after the last "step/"
    agg = {name.split("step/")[-1]: a
           for name, a in trace.aggregate_spans(events).items()
           if "step/" in name}
    dones: dict = {}
    quarantined = set()
    for e in events:
        if e.get("kind") == "step_done":
            d = dones.setdefault(e.get("step"), {
                "n": 0, "wall_s": 0.0, "outcomes": {}})
            d["n"] += 1
            d["wall_s"] += e.get("wall_s") or 0.0
            oc = e.get("outcome", "?")
            d["outcomes"][oc] = d["outcomes"].get(oc, 0) + 1
        elif e.get("kind") == "step_quarantined":
            quarantined.add(e.get("step"))
    if not agg and not dones:
        return
    out.append("")
    out.append(f"== supervisor step breakdown ({len(dones)} step(s), "
               f"{len(agg)} traced) ==")
    hdr = (f"{'step':<22} {'runs':>4} {'wall_s':>9} {'span_s':>9} "
           "outcomes")
    out.append(hdr)
    out.append("-" * len(hdr))
    for name in sorted(set(agg) | set(dones),
                       key=lambda n: -dones.get(n, {}).get("wall_s", 0.0)):
        d = dones.get(name, {"n": 0, "wall_s": 0.0, "outcomes": {}})
        span_s = agg.get(name, {}).get("total_s")
        oc = ",".join(f"{k}={v}" for k, v in sorted(d["outcomes"].items()))
        out.append(
            f"{name:<22} {d['n']:>4} {d['wall_s']:>9.3f} "
            + (f"{span_s:>9.3f}" if span_s is not None else f"{'-':>9}")
            + f" {oc}"
            + (" QUARANTINED" if name in quarantined else "")
        )


def aot_section(events, out):
    """The compile discipline: hits and misses with the seconds each
    spent building, loading and planning, rejections, prewarm runs."""
    hits = [e for e in events if e.get("kind") == "aot_hit"]
    misses = [e for e in events if e.get("kind") == "aot_miss"]
    rejected = [e for e in events if e.get("kind") == "aot_rejected"]
    prewarm = [e for e in events if e.get("kind") == "prewarm_end"]
    if not (hits or misses or rejected or prewarm):
        return

    def cost(e):
        return sum(e.get(k) or 0.0 for k in ("build_s", "load_s", "plan_s"))

    out.append("")
    n = len(hits) + len(misses)
    ratio = f"{len(hits) / n:.0%}" if n else "-"
    out.append(f"== aot compile cache ({len(hits)} hit(s), "
               f"{len(misses)} miss(es), hit ratio {ratio}) ==")
    out.append(f"build + load + plan: {sum(map(cost, hits)):.3f}s on hits, "
               f"{sum(map(cost, misses)):.3f}s on misses"
               + (f"; {len(rejected)} stale entr(ies) rejected"
                  if rejected else ""))
    for e in sorted(misses, key=lambda e: -cost(e))[:8]:
        out.append(f"  miss {e.get('key')}: build {e.get('build_s')}s + "
                   f"load {e.get('load_s')}s + plan {e.get('plan_s')}s")
    for e in rejected:
        out.append(f"  rejected {e.get('key')}: {e.get('reason')}")
    for e in prewarm:
        out.append(f"  prewarm: {e.get('warmed')} warmed, "
                   f"{len(e.get('failed') or [])} failed in "
                   f"{e.get('total_wall_s')}s")


def quarantined_entries() -> dict:
    """Today's quarantined (kernel, config) entries of the integrity
    guard's ledger, read as ``resilience/integrity.py`` reads it, without
    importing it (it imports torch)."""
    data = _cachedir.read_json_memoized(
        _cachedir.integrity_quarantine_path(), {})
    today = datetime.date.today().isoformat()
    return {k: v for k, v in (data.get("entries") or {}).items()
            if isinstance(v, dict) and v.get("day") == today
            and v.get("quarantined")}


def integrity_section(events, out):
    """Guard traffic from the metric snapshots, confirmed corruption
    events and today's quarantine ledger."""
    failed = [e for e in events
              if e.get("kind") == "output_integrity_failed"]
    quarantined = [e for e in events
                   if e.get("kind") == "output_integrity_quarantined"]
    checks = deep = errors = 0
    # a pid's final `metrics` event or its deduplicated snapshots, never
    # both (summing raw events would count a pid twice)
    for st in _metrics.merge_journal_metrics(events).values():
        c = st.get("counters") or {}
        checks += c.get("integrity.checks", 0)
        deep += c.get("integrity.deep_checks", 0)
        errors += c.get("integrity.check_errors", 0)
    ledger = quarantined_entries()
    if not (failed or quarantined or checks or ledger):
        return
    out.append("")
    out.append(
        f"== output integrity ({checks} check(s), {deep} canary "
        f"check(s), {len(failed)} confirmed failure(s)) =="
    )
    for e in failed:
        out.append(
            f"  FAILED {e.get('kernel')} at {e.get('site')} "
            f"(tier {e.get('tier')}): {e.get('detail')}"
        )
    if errors:
        out.append(f"  {errors} check error(s) (results not judged - "
                   "see output_integrity_check_error events)")
    for key, ent in sorted(ledger.items()):
        out.append(
            f"  QUARANTINED {key}: {ent.get('failures')} failure(s) "
            f"today - {ent.get('last_detail')}"
        )
    if not failed and not ledger:
        out.append("  all checks passed")


def slo_section(out):
    """Per (kernel, shape class, device kind) p50/p99 against the target
    from the validated ``slo.json``; simulated rows never gate."""
    try:
        entries = _slo.load_entries()
    except Exception:  # noqa: BLE001 — the report must still render
        entries = {}
    if not entries:
        return
    out.append("")
    out.append(f"== latency SLOs ({len(entries)} verdict(s) in "
               f"{os.path.relpath(_slo.path())}) ==")
    hdr = (f"{'kernel':<16} {'class':<7} {'kind':<22} {'n':>5} "
           f"{'p50_ms':>9} {'p99_ms':>9} {'target':>9}  verdict")
    out.append(hdr)
    out.append("-" * len(hdr))
    for key, e in sorted(entries.items()):
        out.append(
            f"{key.split('|', 1)[0]:<16} {e.get('shape_class', '?'):<7} "
            f"{e.get('device_kind', '?'):<22} "
            f"{e.get('count', 0):>5} {_slo.fmt_ms(e.get('p50_s'), 9)} "
            f"{_slo.fmt_ms(e.get('p99_s'), 9)} "
            f"{_slo.fmt_ms(e.get('target_p99_s'), 9)}  {e.get('verdict')}"
            + (" (simulated - never gates)" if e.get("simulated") else "")
        )


def scaling_section(analysis, out):
    """Bus bandwidth, weak scaling, overlap and the dry run's walls, each
    row with its verdict; a fake or shared-card series renders as
    ``no_data`` with its flag, never gating."""
    busbw = analysis.get("busbw") or {}
    weak = analysis.get("weak") or {}
    overlap = analysis.get("overlap") or {}
    dryrun = analysis.get("dryrun") or {}
    if not (busbw or weak or overlap or dryrun):
        return
    out.append("")
    out.append(
        f"== scaling ({analysis.get('artifacts', 0)} artifact(s) in "
        f"{os.path.relpath(_cachedir.scaling_dir())}; fake and shared-card "
        "series never gate) =="
    )
    if busbw:
        hdr = (f"{'bus-bw series':<28} {'pts':>3} {'valid':>5} "
               f"{'latest GB/s':>12} {'best':>10}  verdict")
        out.append(hdr)
        out.append("-" * len(hdr))
        for name, v in busbw.items():
            out.append(
                f"{name:<28} {v['points']:>3} {v['valid_points']:>5} "
                f"{_fmt_val(v['latest']):>12} {_fmt_val(v['best']):>10}"
                f"  {v['verdict']}"
            )
            for flag in v["flags"]:
                out.append(f"    {flag}")
    if weak:
        out.append(f"weak scaling (efficiency floor "
                   f"{_scaling.min_eff():.0%}, TPKT_SCALING_MIN_EFF):")
        for name, v in weak.items():
            walls = " ".join(f"n{n}={w:.4f}s" for n, w in v["walls"].items())
            eff = (f"{v['efficiency']:.1%}"
                   if v.get("efficiency") is not None else "-")
            out.append(f"  {name:<12} eff={eff:>7} {walls}  {v['verdict']}"
                       + (" (fake)" if v.get("fake") else ""))
            for flag in v["flags"]:
                out.append(f"    {flag}")
    if overlap:
        out.append(
            f"comm/compute overlap (floor "
            f"{_scaling.overlap_min_frac():.0%}, TPKT_OVERLAP_MIN_FRAC;"
            " overlap_low is non-gating):"
        )
        for name, v in overlap.items():
            out.append(
                f"  {name:<24} frac={v['overlap_frac']:.3f} "
                f"comm={_fmt_val(v.get('t_comm_s'))}s "
                f"compute={_fmt_val(v.get('t_compute_s'))}s "
                f"full={_fmt_val(v.get('t_full_s'))}s"
                f"  {v['verdict']}"
                + (" (fake)" if v.get("fake") else "")
            )
            for flag in v["flags"]:
                out.append(f"    {flag}")
    if dryrun:
        out.append("multichip dryrun walls (liveness/drift series, never "
                   "gate):")
        for name, v in dryrun.items():
            out.append(
                f"  {name:<18} rounds={v['rounds']} "
                f"latest={v['latest_wall_s']}s best={v['best_wall_s']}s"
            )


def copy_section(events, out):
    """Payload bytes the daemon copied a request, by lane; a nonzero
    ``expected_zero`` row is a ``copy_regression`` and gates."""
    verdicts = trend.analyze_copy_budget(events)
    if not verdicts:
        return
    out.append("")
    out.append(f"== serve copy budget ({len(verdicts)} lane "
               "measurement(s)) ==")
    hdr = (f"{'series':<34} {'lane':<7} {'req':>5} "
           f"{'bytes/request':>14}  verdict")
    out.append(hdr)
    out.append("-" * len(hdr))
    for name, v in verdicts.items():
        out.append(
            f"{name:<34} {v['lane']:<7} {v['requests'] or 0:>5} "
            f"{v['bytes_per_request']:>14,.1f}  {v['verdict']}"
            + (" (zero-copy contract)" if v["expected_zero"] else "")
        )
        for flag in v["flags"]:
            out.append(f"    {flag}")


def adapt_section(events, out):
    """The latest proposal, canary and promotion, and the live
    ``serve.bucket_pad_frac`` against ``TPKT_ADAPT_PAD_TARGET``."""
    from tpukernels_torch.serve import adapt as _adapt

    latest = {}
    for e in events:
        if e.get("kind") in ("adapt_proposed", "adapt_canary",
                             "adapt_promoted", "adapt_rejected"):
            latest[e["kind"]] = e
    live = _adapt.histogram_pad_frac(events)
    if not latest and live is None:
        return

    def _pf(v):
        return f"{v:.3f}" if isinstance(v, (int, float)) else "n/a"

    out.append("")
    out.append("== adaptive buckets ==")
    p = latest.get("adapt_proposed")
    if p:
        out.append(
            f"  proposed: {len(p.get('proposals') or [])} action(s) "
            f"over {p.get('requests_mined')} mined request(s), "
            "projected pad_frac "
            f"{_pf((p.get('before') or {}).get('pad_frac'))} -> "
            f"{_pf((p.get('after') or {}).get('pad_frac'))} "
            f"(target {p.get('pad_target')})"
        )
    c = latest.get("adapt_canary")
    if c:
        out.append(f"  canary: promote={c.get('promote')} - "
                   f"{c.get('reason')}")
    pr = latest.get("adapt_promoted")
    if pr:
        out.append(f"  promoted: {pr.get('table')} (measured "
                   f"pad_frac {_pf(pr.get('pad_frac'))})")
    rj = latest.get("adapt_rejected")
    if rj:
        out.append(f"  rejected: {rj.get('reason')}")
    if live is not None:
        try:
            target = _adapt.pad_target()
        except ValueError:
            target = None
        line = f"  live serve.bucket_pad_frac {_pf(live)}"
        if target is not None:
            line += (" below target " if live < target
                     else " AT-OR-OVER target ") + str(target)
        out.append(line)


def reqtrace_section(events, out):
    """Phase percentiles a (kernel, bucket, tenant) from the assembled
    timelines, and the trace-budget verdicts; served requests without a
    request id are counted, never dropped silently."""
    tls = _reqtrace.assemble(events)
    untraced = _reqtrace.untraced_serve_requests(events)
    verdicts = trend.analyze_trace_budget(events)
    if not (tls or untraced or verdicts):
        return
    traced = sum(1 for t in tls.values() if t["segments"])
    out.append("")
    out.append(f"== request phases ({len(tls)} timeline(s), {traced} "
               "with span evidence; python -m "
               "tpukernels_torch.obs.trace_report renders waterfalls) ==")
    if untraced:
        out.append(f"  NOTE: {untraced} serve_request event(s) carry "
                   "no request_id - served but not assembled")
    agg = _reqtrace.aggregate(tls)
    if agg:
        hdr = (f"{'kernel|bucket|tenant':<40} {'n':>4} "
               f"{'cli_p99_ms':>10}  dominant phases (p50 ms)")
        out.append(hdr)
        out.append("-" * len(hdr))
        for key, g in agg.items():
            tops = sorted(
                ((p, g["phases"][p]["p50_s"])
                 for p in _reqtrace.PHASES if p in g["phases"]),
                key=lambda kv: -(kv[1] or 0.0),
            )[:3]
            cw = g["client_p99_s"]
            out.append(
                f"{key:<40} {g['n']:>4} "
                + (f"{cw * 1e3:>10.3f}" if cw is not None else f"{'-':>10}")
                + "  "
                + " ".join(f"{p}={v * 1e3:.3f}" for p, v in tops)
                + (f"  {g['gaps']} gap(s)" if g["gaps"] else "")
            )
    for name, v in verdicts.items():
        out.append(f"  {name}: {v['verdict']} (traced {v['traced']} "
                   f"of {v['requests']} request(s))")
        for flag in v["flags"]:
            out.append(f"    {flag}")


def shapes_section(events, out):
    """The requested (pre-pad) shapes a (kernel, bucket) with their pad
    waste: what ``serve.optimize propose`` mines."""
    rows: dict = {}
    for ev in events:
        if ev.get("kind") != "serve_request" or not ev.get("shapes"):
            continue
        shapes = "+".join("x".join(str(d) for d in s) or "scalar"
                          for s in ev["shapes"])
        key = (ev.get("kernel", "?"), shapes, ev.get("bucket") or "-")
        r = rows.setdefault(key, {"n": 0, "pad": 0.0, "tenants": set()})
        r["n"] += 1
        r["pad"] += ev.get("pad_frac") or 0.0
        if ev.get("tenant") not in (None, "-"):
            r["tenants"].add(str(ev.get("tenant")))
    if not rows:
        return
    out.append("")
    out.append(f"== shapes seen ({len(rows)} distinct (kernel, "
               "shapes, bucket) mix(es) from serve_request records) ==")
    hdr = (f"{'kernel':<16} {'requested shapes':<26} "
           f"{'bucket':<30} {'n':>5} {'mean_pad':>9}  tenants")
    out.append(hdr)
    out.append("-" * len(hdr))
    for (kernel, shapes, bucket), r in sorted(
            rows.items(), key=lambda kv: (-kv[1]["n"], kv[0])):
        out.append(
            f"{kernel:<16} {shapes:<26} {bucket:<30} {r['n']:>5} "
            f"{r['pad'] / r['n']:>9.1%}  "
            + (",".join(sorted(r["tenants"])) or "-")
        )


def deadlines_section(events, out):
    """Expiries by site, admission refusals, hedge pairs, cancels and the
    goodput a deadline-carrying load run stamps; absent without any
    deadline evidence."""
    kinds: dict = {"serve_request_expired": [],
                   "serve_deadline_infeasible": [],
                   "serve_hedged": [], "serve_cancelled": []}
    for e in events:
        k = e.get("kind")
        if k in kinds:
            kinds[k].append(e)
    probes = [e for e in events
              if e.get("kind") == "slo_probe" and e.get("goodput")]
    if not any(kinds.values()) and not probes:
        return
    out.append("")
    out.append("== deadlines ==")

    def counted(evs, key):
        n: dict = {}
        for e in evs:
            k = key(e)
            n[k] = n.get(k, 0) + 1
        return sorted(n.items())

    exp = kinds["serve_request_expired"]
    if exp:
        out.append(f"  {len(exp)} request(s) expired before dispatch: "
                   + ", ".join(f"{k}={n}" for k, n in counted(
                       exp, lambda e: f"{e.get('site')}/{e.get('where')}")))
    inf = kinds["serve_deadline_infeasible"]
    if inf:
        out.append(f"  {len(inf)} refused at admission (budget "
                   "already infeasible on arrival)")
    hed = kinds["serve_hedged"]
    if hed:
        out.append(f"  {len(hed)} hedged dispatch(es), first-response-wins: "
                   + ", ".join(f"worker {k} x{n}" for k, n in counted(
                       hed, lambda e: f"{e.get('from_worker')}->"
                                      f"{e.get('to_worker')}")))
    can = kinds["serve_cancelled"]
    if can:
        out.append(f"  {len(can)} cancel(s): "
                   + ", ".join(f"{k}={n}" for k, n in counted(
                       can, lambda e: str(e.get("site")))))
    for e in probes:
        gp = e.get("goodput") or {}
        met = sum(int(v[0]) for v in gp.values())
        total = sum(int(v[1]) for v in gp.values())
        frac = f" ({met / total:.1%})" if total else ""
        out.append(f"  goodput {met}/{total}{frac} deadline(s) met "
                   f"(seed {e.get('seed')}, "
                   f"deadline_ms {e.get('deadline_ms')})")


def metrics_section(events, out):
    """A process's metric state: its final ``metrics`` event, else its
    deduplicated ``metrics_snapshot`` stream (a process killed with
    SIGKILL has no final flush); the two are never summed."""
    merged = _metrics.merge_journal_metrics(events)
    n_events = sum(1 for e in events
                   if e.get("kind") in ("metrics", "metrics_snapshot"))
    out.append("")
    out.append(f"== metric snapshots ({n_events} event(s), "
               f"{len(merged)} process(es)) ==")
    if not merged:
        out.append("(no metrics/metrics_snapshot events in the journal)")
        return
    for pid, st in sorted(merged.items(), key=lambda kv: str(kv[0])):
        how = ("final" if st.get("final") else
               f"last snapshot seq={st.get('seq')}, no final flush")
        out.append(f"[pid {pid}] site={st.get('site')} ({how})")
        for k, v in sorted((st.get("counters") or {}).items()):
            out.append(f"  counter   {k} = {v}")
        for k, v in sorted((st.get("gauges") or {}).items()):
            out.append(f"  gauge     {k} = {v}")
        for k, h in sorted((st.get("histograms") or {}).items()):
            out.append(
                f"  histogram {k}: count={h.get('count')} "
                f"sum={h.get('sum')} min={h.get('min')} "
                f"max={h.get('max')} p50={h.get('p50')} "
                f"p95={h.get('p95')} p99={h.get('p99')}"
            )


def rollup_section(out):
    """One line a rollup day (the last seven), then the non-gating
    ``p99_creep`` verdicts."""
    try:
        series = _rollup.load_series()
    except Exception as e:  # noqa: BLE001 — the report must render
        out.append("")
        out.append(f"== daily rollups (unreadable: {e!r}) ==")
        return
    if not series:
        return
    out.append("")
    out.append(f"== daily rollups ({len(series)} day(s) in "
               f"{os.path.relpath(_rollup.rollup_dir())}) ==")
    for date, art in series[-7:]:
        reqs = art.get("requests") or {}
        total = sum((r or {}).get("count") or 0 for r in reqs.values())
        out.append(f"  {date}: {art.get('events')} event(s), "
                   f"{art.get('pids') or 0} pid(s), "
                   f"{total} request(s) over {len(reqs)} kernel(s)")
    for name, v in sorted(trend.analyze_p99_creep(series).items()):
        if v["verdict"] == "p99_creep":
            out.append(f"  {name}: p99_creep (non-gating)")
            for flag in v["flags"]:
                out.append(f"    {flag}")
        elif v["verdict"] == "ok":
            out.append(f"  {name}: ok over {v['days']} day(s) "
                       f"(latest p99 {v['latest']}s, baseline "
                       f"{v['baseline']}s)")


def _bad(verdicts: dict, verdict: str) -> dict:
    return {n: v for n, v in verdicts.items() if v["verdict"] == verdict}


def check(events, eps=trend.CEILING_EPS) -> int:
    """``--check``: the non-ok verdict lines and a summary; rc 0 or 1."""
    verdicts = trend.analyze_repo(eps=eps)
    bad = {n: v for n, v in verdicts.items()
           if v["verdict"] in BENCH_GATING}
    for name, v in bad.items():
        print(f"{name}: {v['verdict']}")
        for flag in v["flags"]:
            print(f"  {flag}")
    below = _bad(verdicts, "below_roofline")
    for name in below:
        # headroom to earn, never a regression to gate on
        print(f"{name}: below_roofline (non-gating)")
    # a confirmed corruption gates: a wrong answer is worse than a slow one
    corrupt = [e for e in events
               if e.get("kind") == "output_integrity_failed"]
    for e in corrupt:
        print(f"output_integrity_failed: {e.get('kernel')} at "
              f"{e.get('site')} (tier {e.get('tier')}): {e.get('detail')}")
    # a confirmed p99 breach gates; an unreadable artifact is reported,
    # never turned into the rc 1 reserved for real findings
    try:
        breaches = _slo.breaches()
    except Exception as e:  # noqa: BLE001 — gate what validates
        print(f"obs.report: slo verdicts unreadable, not judged ({e!r})",
              file=sys.stderr)
        breaches = {}
    for key, e in sorted(breaches.items()):
        print(f"{key.split('|', 1)[0]}: slo_breach (p99 "
              f"{_slo.fmt_ms(e.get('p99_s'))} > target "
              f"{_slo.fmt_ms(e.get('target_p99_s'))} over "
              f"{e.get('count')} request(s), {e.get('shape_class')} "
              f"shapes on {e.get('device_kind')})")
    traces = trend.analyze_trace_budget(events)
    gating = []
    for verdicts, verdict in (
            (trend.analyze_copy_budget(events), "copy_regression"),
            (traces, "trace_inconsistent"),
            (trend.analyze_pad_waste(events), "pad_waste_regression")):
        found = _bad(verdicts, verdict)
        gating.append(found)
        for name, v in found.items():
            print(f"{name}: {verdict}")
            for flag in v["flags"]:
                print(f"  {flag}")
    copy_bad, trace_bad, pad_bad = gating
    trace_low = _bad(traces, "trace_coverage")
    for name in trace_low:
        print(f"{name}: trace_coverage (non-gating)")
    # validated bus-bandwidth series gate; fake and shared-card ones
    # only ever reach no_data
    analysis = _scaling.analyze_repo()
    scaling_bad = _scaling.gating_findings(analysis)
    for name, v in scaling_bad.items():
        print(f"{name}: {v['verdict']}")
        for flag in v["flags"]:
            print(f"  {flag}")
    below_eff = _bad(analysis.get("weak", {}), "below_scaling_efficiency")
    for name in below_eff:
        print(f"weak/{name}: below_scaling_efficiency (non-gating)")
    overlap_low = _bad(analysis.get("overlap", {}), "overlap_low")
    for name, v in overlap_low.items():
        print(f"{name}: overlap_low (non-gating)")
        for flag in v["flags"]:
            print(f"  {flag}")
    try:
        series = _rollup.load_series()
    except Exception as e:  # noqa: BLE001 — gate what validates
        print(f"obs.report: rollup series unreadable, p99 creep not "
              f"judged ({e!r})", file=sys.stderr)
        series = []
    creeping = _bad(trend.analyze_p99_creep(series), "p99_creep")
    for name, v in sorted(creeping.items()):
        print(f"{name}: p99_creep (non-gating)")
        for flag in v["flags"]:
            print(f"  {flag}")
    ok = sum(1 for v in verdicts.values() if v["verdict"] == "ok")
    nodata = len(_bad(verdicts, "no_data"))
    print(
        f"obs.report --check: {len(corrupt)} confirmed output-integrity "
        f"failure(s), {len(breaches)} confirmed SLO breach(es), "
        f"{len(scaling_bad)} scaling regression(s), "
        f"{len(copy_bad)} copy-budget regression(s), "
        f"{len(pad_bad)} pad-waste regression(s), "
        f"{len(trace_bad)} trace inconsistenc(ies), "
        f"{len(trace_low)} trace-coverage (non-gating), "
        f"{len(below_eff)} below-scaling-efficiency (non-gating), "
        f"{len(overlap_low)} overlap-low (non-gating), "
        f"{len(creeping)} p99-creep (non-gating), {len(bad)} bench "
        f"failing, {ok} bench ok, {len(below)} below-roofline (non-gating), "
        f"{nodata} bench no-data (retryable, not a failure)"
    )
    return 1 if (bad or corrupt or breaches or scaling_bad or copy_bad
                 or pad_bad or trace_bad) else 0


def report(events, paths, eps=trend.CEILING_EPS) -> int:
    """The whole report; rc 1 on a gating bench, scaling, copy, pad-waste
    or trace finding, as the reference's full mode."""
    out = []
    verdicts = trend.analyze_repo(eps=eps)
    analysis = _scaling.analyze_repo()
    bad = {**{n: v for n, v in verdicts.items()
              if v["verdict"] in BENCH_GATING},
           **_scaling.gating_findings(analysis),
           **_bad(trend.analyze_copy_budget(events), "copy_regression"),
           **_bad(trend.analyze_pad_waste(events), "pad_waste_regression"),
           **_bad(trend.analyze_trace_budget(events), "trace_inconsistent")}
    trend_section(verdicts, out)
    roofline_section(verdicts, out)
    span_section(events, out)
    step_section(events, out)
    aot_section(events, out)
    integrity_section(events, out)
    slo_section(out)
    scaling_section(analysis, out)
    copy_section(events, out)
    adapt_section(events, out)
    reqtrace_section(events, out)
    shapes_section(events, out)
    deadlines_section(events, out)
    metrics_section(events, out)
    rollup_section(out)
    out.append("")
    if bad:
        out.append("VERDICT: " + "; ".join(f"{n} {v['verdict']}"
                                           for n, v in bad.items()))
    else:
        out.append("VERDICT: clean (no bench, scaling, copy, pad-waste or "
                   "trace finding)")
    if paths:
        out.append("journal: " + ", ".join(os.path.relpath(p)
                                           for p in paths))
    print("\n".join(out))
    return 1 if bad else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    want_check = "--check" in argv
    roofline_only = "--roofline" in argv
    root, paths, eps = None, None, trend.CEILING_EPS
    it = iter(argv)
    try:
        for a in it:
            if a == "--root":
                root = next(it)
            elif a == "--journal":
                paths = [next(it)]
            elif a == "--eps":
                eps = float(next(it))
            elif a not in ("--check", "--roofline"):
                print(__doc__, file=sys.stderr)
                print(f"obs.report: unknown argument {a!r}",
                      file=sys.stderr)
                return 2
    except StopIteration:
        # a flag without its value is a usage error (rc 2), never the
        # rc 1 reserved for a real finding
        print(f"obs.report: {a} requires a value", file=sys.stderr)
        return 2
    except ValueError:
        print(f"obs.report: {a} needs a numeric value", file=sys.stderr)
        return 2
    paths = _journal.reader_paths(paths)
    events, _bad_lines = _journal.load_events(paths)
    with state_root(root):
        if want_check:
            return check(events, eps)
        if roofline_only:
            verdicts = trend.analyze_repo(eps=eps)
            out = []
            roofline_section(verdicts, out)
            print("\n".join(line for line in out if line))
            return 1 if any(v["verdict"] in BENCH_GATING
                            for v in verdicts.values()) else 0
        return report(events, paths, eps)


if __name__ == "__main__":
    sys.exit(main())
