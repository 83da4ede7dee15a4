"""Promote persisted H100 bench evidence into the port's baseline.

    python -m tpukernels_torch.promote_baseline [--dry-run] [--allow-partial]
                                                [--allow-jump] [--run TAG]

The port's copy of ``tools/promote_baseline.py``. It reads the union of
the bench lines under 24 h through the bench's own scanner
(``bench._recent_captured_metrics``: ``$TPKT_BENCH_DIR``, H100 lines only,
the newest artifact winning a metric, stale and invalidated values never
counting), rewrites the ``measured`` block of ``baseline_h100.json``
(``_cachedir.bench_baseline_path()``; ``TPKT_BENCH_BASELINE`` moves it)
and prints old -> new a metric. With every metric from one line, the block
also records where the medians came from: the artifact, the card's name
and power limit and the line's ``git_head``; ``--run TAG`` names the run.

It refuses (rc 1, the file untouched):

- a union that lacks a metric, unless ``--allow-partial`` (medians of
  different sessions would hide a regression between them); a partial
  promotion records the metrics it kept and their date
  (``_not_remeasured``);
- a median lowered by more than the gate's tolerance (15 %): that is a
  regression to look into, not a new bar;
- a median raised by more than 25 % (:data:`_JUMP_TOL`) unless
  ``--allow-jump``: more often a measurement artifact than a speedup;
- a value more than 1 % over its ceiling (``bench.ceilings()``), always.

Promotion is a deliberate act: no queue step runs it.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

# a median may rise this much without --allow-jump
_JUMP_TOL = 0.25


class Refused(Exception):
    """A promotion the guard rails refuse; the message says why."""


def _provenance(bench, union, names):
    """Where a full promotion's medians came from: the one artifact every
    metric was read from, with the card and the code it ran, or None
    when they came from several."""
    paths = {p for _v, p in union.values()}
    if len(paths) != 1 or set(union) != set(names):
        return None
    (path,) = paths
    for p, rec in bench._iter_bench_artifacts():
        if os.path.basename(p) == path:
            return {"artifact": path, "name": rec.get("name"),
                    "power_limit_w": rec.get("power_limit_w"),
                    "git_head": rec.get("git_head")}
    return None


def promote(allow_partial=False, dry_run=False, today=None,
            allow_jump=False, run=None):
    """``(measured, lines)``: the new ``measured`` block and one line a
    metric; raises :class:`Refused`."""
    from tpukernels_torch import _cachedir, bench

    union = bench._recent_captured_metrics()
    names = [n for n, _fn in bench.BENCH_METRICS]
    missing = [n for n in names if n not in union]
    if missing and not allow_partial:
        raise Refused(f"the union is missing {missing} - capture a full set "
                      "first, or pass --allow-partial to promote only the "
                      "captured metrics (medians of several sessions)")
    path = _cachedir.bench_baseline_path()
    baseline = bench._load_baseline()
    measured = dict(baseline.get("measured") or {})
    ceilings = bench.ceilings()
    prev_on = measured.get("measured_on")
    lines = []
    for name in names:
        if name not in union:
            lines.append(f"  {name}: (not captured; keeping "
                         f"{measured.get(name)} from {prev_on})")
            continue
        old = measured.get(name)
        new = round(float(union[name][0]), 2)
        known = bench._is_measurement(old) and old
        if known and new < old * (1.0 - bench._REGRESSION_TOL):
            raise Refused(
                f"{name} captured {new} is more than "
                f"{bench._REGRESSION_TOL:.0%} below the median of record "
                f"{old} - a regression to investigate (the union gate "
                "should have failed), not a new baseline")
        ceiling = ceilings.get(name)
        if ceiling is not None and new > ceiling * (1.0 + bench._CEILING_EPS):
            raise Refused(
                f"{name} captured {new} exceeds its ceiling {ceiling} by "
                f"more than {bench._CEILING_EPS:.0%} - a measurement over "
                "the card's bound is invalidated, never promoted")
        if known and new > old * (1.0 + _JUMP_TOL) and not allow_jump:
            raise Refused(
                f"{name} captured {new} is more than {_JUMP_TOL:.0%} above "
                f"the median of record {old} - re-capture, or pass "
                "--allow-jump if a kernel change explains it")
        measured[name] = new
        lines.append(f"  {name}: {old} -> {new}")
    measured["measured_on"] = today or datetime.date.today().isoformat()
    kept = [n for n in names if n not in union]
    if kept:
        measured["_not_remeasured"] = (
            f"kept from {prev_on}, not re-measured on "
            f"{measured['measured_on']}: " + ", ".join(kept))
    else:
        measured.pop("_not_remeasured", None)
    source = _provenance(bench, union, names)
    if source is not None:
        measured["measured_from"] = dict(source, run=run)
    else:
        measured.pop("measured_from", None)
    baseline["measured"] = measured
    if not dry_run:
        from tpukernels_torch.resilience import atomic

        atomic.dump_json(path, baseline)
    return measured, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="print the promotion without writing")
    ap.add_argument("--allow-partial", action="store_true",
                    help="promote a union that lacks metrics")
    ap.add_argument("--allow-jump", action="store_true",
                    help=f"let a median rise more than {_JUMP_TOL:.0%} "
                         "(ceilings still hold)")
    ap.add_argument("--run", metavar="TAG",
                    help="the name of the run the medians came from")
    args = ap.parse_args(argv)
    try:
        measured, lines = promote(allow_partial=args.allow_partial,
                                  dry_run=args.dry_run,
                                  allow_jump=args.allow_jump, run=args.run)
    except Refused as e:
        print(f"promote_baseline: {e}", file=sys.stderr)
        return 1
    print("promote_baseline:" + (" (dry run)" if args.dry_run else "")
          + f" measured medians (measured_on={measured['measured_on']}):")
    for line in lines:
        print(line)
    if not args.dry_run:
        from tpukernels_torch import _cachedir

        print(f"{_cachedir.bench_baseline_path()} updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
