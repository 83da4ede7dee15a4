"""Traffic-adaptive bucket optimizer: serve telemetry in, a promoted
bucket table out.

The port's copy of ``tpukernels/serve/adapt.py``. The daemon pads each
request up onto an avatar of its table (``serve/bucketing.py``;
``TPKT_SERVE_BUCKETS``, default ``aot.BENCH_CONFIGS``) and journals the
evidence: every ``serve_request`` carries the requested (pre-pad)
shapes and dtypes, the bucket and ``pad_frac``. This module closes the
loop:

- :func:`shape_mix` mines those records into per-kernel (shapes,
  dtypes, count) groups; :func:`window_mix` widens today's mix with the
  prior days' rollups (``obs/rollup.py``) under
  ``TPKT_ADAPT_WINDOW_DAYS`` (:func:`merge_mix` sums the rows);
  :func:`histogram_pad_frac` reads the daemon's
  ``serve.bucket_pad_frac`` aggregate off ``metrics`` events.
- :func:`propose` turns a mix and the incumbent table into ranked
  SPLITs (a new avatar at a hot observed shape, one compile each) and
  MERGEs (drop an avatar no traffic lands on), greedily until the
  projected pad waste falls under ``TPKT_ADAPT_PAD_TARGET``
  (:data:`MAX_SPLITS` at most).
- :func:`record_candidate` / :func:`load` persist and read the winner
  as ``adapt.json`` (``_cachedir.adapt_path``), validated at read
  against the torch and CUDA versions and the sha of :data:`SOURCES`;
  a stale or torn candidate is rejected loudly (stderr,
  ``adapt_rejected``).
- :func:`judge_canary` is the promotion gate: a measured pad_frac win
  over the incumbent beyond :data:`PROMOTE_MARGIN` and a strictly
  better p99 at identical replay seeds. ``python -m
  tpukernels_torch.serve.optimize canary`` measures both sides;
  :func:`promote` writes ``buckets.json``, which a daemon pointed at it
  re-reads on ``undrain``.
- :func:`traffic_order` ranks keys by request count for
  ``python -m tpukernels_torch.prewarm --order traffic``.

Standard library only at import: the proposal math is arithmetic over
shape tuples, and ``optimize propose`` never imports torch.
"""

from __future__ import annotations

import os
import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.resilience import journal

DEFAULT_PAD_TARGET = 0.25
DEFAULT_MIN_REQUESTS = 50
# split proposals applied per candidate table, at most: each one is a
# compile + an executable-memo slot, and a table that shadows every
# observed shape is a memo leak wearing an optimizer's hat
MAX_SPLITS = 4

# the promotion margin: a candidate's measured pad_frac must beat the
# incumbent's by more than this fraction (the reference borrows its
# tuning runner's PROMOTE_MARGIN, >3% over control; the port has no
# runner yet, ROADMAP Queue A item 4)
PROMOTE_MARGIN = 0.03

# sources whose newer commit invalidates a persisted candidate: the
# pad math that projected it, this module's own proposal model, and
# the avatar registry the table overrides
SOURCES = (
    "tpukernels_torch/serve/adapt.py",
    "tpukernels_torch/serve/bucketing.py",
    "tpukernels_torch/aot.py",
)

_DTYPE_KINDS = {"float32": "f32", "int32": "i32"}

_REJECT_NOTED: set = set()


def reset():
    """Drop per-process state (tests)."""
    _REJECT_NOTED.clear()


# ------------------------------------------------------------------ #
# knobs (fail-loud parse)                                            #
# ------------------------------------------------------------------ #

def pad_target() -> float:
    """``TPKT_ADAPT_PAD_TARGET`` (default 0.25): the projected mean
    pad_frac a proposal must drive the observed mix below. Fail-loud
    parse, in (0, 1]."""
    raw = os.environ.get("TPKT_ADAPT_PAD_TARGET")
    if raw is None:
        return DEFAULT_PAD_TARGET
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not 0.0 < val <= 1.0:
        raise ValueError(
            f"TPKT_ADAPT_PAD_TARGET={raw!r}: expected a float in (0, 1]"
        )
    return val


def min_requests() -> int:
    """``TPKT_ADAPT_MIN_REQUESTS`` (default 50): journal requests below
    which no proposal is made — a bucket table re-shaped around an
    anecdote would thrash on every traffic blip. Fail-loud parse,
    >= 1."""
    raw = os.environ.get("TPKT_ADAPT_MIN_REQUESTS")
    if raw is None:
        return DEFAULT_MIN_REQUESTS
    try:
        val = int(raw)
    except ValueError:
        val = 0
    if val < 1:
        raise ValueError(
            f"TPKT_ADAPT_MIN_REQUESTS={raw!r}: expected an int >= 1"
        )
    return val


def window_days() -> int:
    """``TPKT_ADAPT_WINDOW_DAYS`` (default 1): the days of evidence the
    miner sees. 1 is today's journal alone; N > 1 widens the mix with
    the prior N - 1 days' rollups (``obs/rollup.py``), so a quiet
    morning still proposes off a week of traffic. Fail-loud parse,
    >= 1."""
    raw = os.environ.get("TPKT_ADAPT_WINDOW_DAYS")
    if raw is None:
        return 1
    try:
        val = int(raw)
    except ValueError:
        val = 0
    if val < 1:
        raise ValueError(
            f"TPKT_ADAPT_WINDOW_DAYS={raw!r}: expected an int >= 1"
        )
    return val


def path() -> str:
    return _cachedir.adapt_path()


def buckets_path() -> str:
    return _cachedir.adapt_buckets_path()


# ------------------------------------------------------------------ #
# journal mining                                                     #
# ------------------------------------------------------------------ #

def shape_mix(events) -> dict:
    """Aggregate ``serve_request`` events into the optimizer's input:
    ``{kernel: [{"shapes", "dtypes", "count", "pad_frac_sum",
    "bucketed"}, ...]}`` with one row per distinct requested
    (pre-pad) shape tuple, counts over OK requests only — a request
    the daemon failed tells us nothing about what padding it paid."""
    groups: dict = {}
    for e in events:
        if e.get("kind") != "serve_request" or not e.get("ok"):
            continue
        kernel, shapes, dtypes = (
            e.get("kernel"), e.get("shapes"), e.get("dtypes"),
        )
        if not kernel or not isinstance(shapes, list) \
                or not isinstance(dtypes, list):
            continue
        key = (
            kernel,
            tuple(tuple(int(d) for d in s) for s in shapes),
            tuple(dtypes),
        )
        row = groups.get(key)
        if row is None:
            row = groups[key] = {
                "kernel": kernel,
                "shapes": [tuple(int(d) for d in s) for s in shapes],
                "dtypes": list(dtypes),
                "count": 0,
                "pad_frac_sum": 0.0,
                "bucketed": 0,
            }
        row["count"] += 1
        row["pad_frac_sum"] += float(e.get("pad_frac") or 0.0)
        row["bucketed"] += bool(e.get("bucketed"))
    out: dict = {}
    for row in groups.values():
        out.setdefault(row["kernel"], []).append(row)
    for rows in out.values():
        rows.sort(key=lambda r: (-r["count"], r["shapes"]))
    return out


def mix_requests(mix: dict) -> int:
    return sum(r["count"] for rows in mix.values() for r in rows)


def merge_mix(mixes) -> dict:
    """Combine :func:`shape_mix` outputs (today's journal, prior days'
    rollups) into one mix: rows merge by (kernel, shapes, dtypes) with
    count, pad_frac_sum and bucketed summed, which is what mining the
    concatenated events would give, so the proposal cannot tell a
    window from one day."""
    groups: dict = {}
    for mix in mixes:
        for kernel, rows in (mix or {}).items():
            for r in rows:
                try:
                    shapes = [tuple(int(d) for d in s) for s in r["shapes"]]
                    dtypes = list(r["dtypes"])
                except (KeyError, TypeError, ValueError):
                    continue
                key = (kernel, tuple(shapes), tuple(dtypes))
                row = groups.get(key)
                if row is None:
                    row = groups[key] = {
                        "kernel": kernel, "shapes": shapes,
                        "dtypes": dtypes, "count": 0,
                        "pad_frac_sum": 0.0, "bucketed": 0,
                    }
                row["count"] += int(r.get("count") or 0)
                row["pad_frac_sum"] += float(r.get("pad_frac_sum") or 0.0)
                row["bucketed"] += int(r.get("bucketed") or 0)
    out: dict = {}
    for row in groups.values():
        out.setdefault(row["kernel"], []).append(row)
    for rows in out.values():
        rows.sort(key=lambda r: (-r["count"], r["shapes"]))
    return out


def window_mix(events, days: int | None = None,
               end_date: str | None = None):
    """Today's mix from ``events`` (the live journal) widened with the
    prior ``days - 1`` days' validated rollup mixes: ``(mix,
    days_used)``, ``days_used`` the rollup days folded in + 1. A rollup
    dated ``end_date`` (default today) is skipped: today's evidence is
    the journal's, and folding today's rollup in too would count every
    request twice."""
    if days is None:
        days = window_days()
    today_mix = shape_mix(events)
    if days <= 1:
        return today_mix, 1
    from tpukernels_torch.obs import rollup

    if end_date is None:
        end_date = time.strftime("%Y-%m-%d")
    prior = [(date, art) for date, art in rollup.load_series()
             if date < end_date][-(days - 1):]
    mixes = [today_mix] + [art.get("shape_mix") or {} for _, art in prior]
    return merge_mix(mixes), 1 + len(prior)


def histogram_pad_frac(events):
    """Mean live pad_frac (sum/count) of the ``serve.bucket_pad_frac``
    histogram, or None — the daemon-side aggregate twin of the
    per-request evidence. Reconstructed per pid by
    ``metrics.merge_journal_metrics`` (snapshots deduped by (pid,
    seq), a final ``metrics`` event authoritative — never summed with
    its own snapshots), then pooled across pids: sum-of-sums over
    sum-of-counts, each process's traffic weighted by its count."""
    from tpukernels_torch.obs import metrics as obs_metrics

    total = 0.0
    count = 0
    for state in obs_metrics.merge_journal_metrics(events).values():
        row = state["histograms"].get("serve.bucket_pad_frac")
        if isinstance(row, dict) and row.get("count"):
            total += float(row["sum"])
            count += int(row["count"])
    if not count:
        return None
    return total / count


def traffic_order(events, known) -> tuple:
    """(ordered_kernels, counts) — ``known`` re-ranked by journal
    ``serve_request`` frequency (descending, ties by name); kernels
    with no observed traffic keep their registry order at the tail.
    ``counts`` is empty when the journal holds no traffic evidence —
    the caller's cue to say so and fall back."""
    counts: dict = {}
    for e in events:
        if e.get("kind") == "serve_request":
            k = e.get("kernel")
            if k in known:
                counts[k] = counts.get(k, 0) + 1
    if not counts:
        return list(known), {}
    hot = sorted(counts, key=lambda k: (-counts[k], k))
    return hot + [k for k in known if k not in counts], counts


# ------------------------------------------------------------------ #
# pure projection math                                               #
# ------------------------------------------------------------------ #

def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _spec_shapes(spec):
    """[(kind, shape_tuple), ...] for one avatar spec (tolerates JSON
    lists where BENCH_CONFIGS has tuples)."""
    return [
        (kind, tuple(int(d) for d in shape))
        for kind, shape in spec["args"]
    ]


def pad_frac_for(shapes, dtypes, spec):
    """Projected pad_frac of one request group under one avatar spec,
    or None when it cannot bucket there (rank/dtype mismatch, any dim
    over the avatar — the pad-up-never-down rule). Mirrors
    ``bucketing.bucket_for``'s wasted-element arithmetic exactly:
    1 - sum(orig_elems) / sum(avatar_elems)."""
    want = _spec_shapes(spec)
    if len(want) != len(shapes):
        return None
    orig = padded = 0
    for shape, dtype, (kind, avatar) in zip(shapes, dtypes, want):
        if _DTYPE_KINDS.get(dtype, dtype) != kind:
            return None
        shape = tuple(int(d) for d in shape)
        if len(shape) != len(avatar):
            return None
        if any(d > w for d, w in zip(shape, avatar)):
            return None
        orig += _elems(shape) if shape else 1
        padded += _elems(avatar) if avatar else 1
    return 1.0 - (orig / padded if padded else 1.0)


def _kernel_specs(table, kernel):
    """Normalized avatar list for one kernel — a table value may be a
    single spec dict (the historical shape) or a list of them (what a
    split produces)."""
    spec = table.get(kernel)
    if spec is None:
        return []
    return list(spec) if isinstance(spec, list) else [spec]


def project(table: dict, mix: dict, max_pad: float = 0.5) -> dict:
    """Projected fate of an observed mix under a candidate table:
    every request group lands on its cheapest fitting avatar (the
    ``bucket_for`` choice rule) or stays native (no fit, or pad over
    ``max_pad`` — the ``TPKT_SERVE_MAX_PAD_FRAC`` cap). Returns
    ``{"pad_frac", "bucketed", "native", "buckets"}`` where
    ``pad_frac`` is the request-weighted mean over BUCKETED traffic
    and ``buckets`` counts the distinct (kernel, avatar) programs the
    mix would occupy — the executable-memo-slot side of the cost
    model."""
    pad_sum = 0.0
    bucketed = native = 0
    used: set = set()
    for kernel, rows in mix.items():
        specs = _kernel_specs(table, kernel)
        for row in rows:
            best = best_i = None
            for i, spec in enumerate(specs):
                pf = pad_frac_for(row["shapes"], row["dtypes"], spec)
                if pf is None or pf > max_pad:
                    continue
                if best is None or pf < best:
                    best, best_i = pf, i
            if best is None:
                native += row["count"]
            else:
                bucketed += row["count"]
                pad_sum += best * row["count"]
                used.add((kernel, best_i))
    return {
        "pad_frac": (pad_sum / bucketed) if bucketed else 0.0,
        "bucketed": bucketed,
        "native": native,
        "buckets": len(used),
    }


# ------------------------------------------------------------------ #
# proposals: splits and merges under the compile-cost model          #
# ------------------------------------------------------------------ #

def _split_candidates(table, mix, max_pad):
    """One SPLIT candidate per observed shape group that pays padding
    today: a new avatar exactly at the group's requested shapes.
    ``waste_saved`` is the projected drop in total wasted elements per
    replay of the mix (the group lands exact, and any sibling group
    that fits the new avatar cheaper re-homes too); each split costs
    exactly one compile + one executable-memo slot."""
    out = []
    for kernel, rows in mix.items():
        specs = _kernel_specs(table, kernel)
        if not specs:
            continue  # never invent avatars for kernels without one
        statics = dict(specs[0].get("statics") or {})
        for row in rows:
            fits = [
                pf for spec in specs
                if (pf := pad_frac_for(row["shapes"], row["dtypes"],
                                       spec)) is not None
            ]
            current = min((pf for pf in fits if pf <= max_pad),
                          default=None)
            if current is not None and current <= 0.0:
                continue  # already exact somewhere
            new_spec = {
                "args": [
                    [_DTYPE_KINDS.get(dt, dt), list(shape)]
                    for dt, shape in zip(row["dtypes"], row["shapes"])
                ],
                "statics": statics,
            }
            if pad_frac_for(row["shapes"], row["dtypes"],
                            new_spec) != 0.0:
                continue  # malformed group (defensive)
            before = project(table, mix, max_pad)
            trial = dict(table)
            trial[kernel] = specs + [new_spec]
            after = project(trial, mix, max_pad)
            waste_saved = (
                before["pad_frac"] * before["bucketed"]
                - after["pad_frac"] * after["bucketed"]
                # traffic pulled off the native path saved its whole
                # padless dispatch from running cold-shaped; count it
                # as the pad it now pays (0 for an exact split)
            )
            if waste_saved <= 0.0 and after["bucketed"] <= \
                    before["bucketed"]:
                continue
            out.append({
                "action": "split",
                "kernel": kernel,
                "spec": new_spec,
                "count": row["count"],
                "pad_frac_before": current,
                "compiles": 1,
                "waste_saved": round(waste_saved, 6),
                "score": round(waste_saved / 1.0, 6),
            })
    return out


def _merge_candidates(table, mix, max_pad):
    """One MERGE candidate per avatar the observed mix never lands on:
    dropping it frees a compile + an executable-memo slot and, by
    construction, pays no pad_frac (zero traffic re-homes). An avatar
    that IS carrying traffic is never merged away — its traffic would
    pay the sibling's pad_frac, and the split ranking already decided
    that avatar was worth a compile."""
    out = []
    for kernel in sorted(table):
        specs = _kernel_specs(table, kernel)
        if len(specs) < 2:
            continue  # never leave a kernel avatar-less
        for i, spec in enumerate(specs):
            carrying = 0
            for row in mix.get(kernel, ()):
                fits = [
                    (pf, j) for j, s in enumerate(specs)
                    if (pf := pad_frac_for(row["shapes"],
                                           row["dtypes"], s))
                    is not None and pf <= max_pad
                ]
                if fits and min(fits)[1] == i:
                    carrying += row["count"]
            if carrying:
                continue
            out.append({
                "action": "merge",
                "kernel": kernel,
                "spec": spec,
                "count": 0,
                "compiles": -1,
                "waste_saved": 0.0,
                "score": 0.0,
            })
    return out


def propose(mix: dict, table: dict, target: float,
            max_pad: float = 0.5, max_splits: int = MAX_SPLITS) -> dict:
    """The proposal model, pure: rank split candidates by
    waste-saved-per-compile, greedily apply them until the projected
    mean pad_frac of the mix falls below ``target`` (or the split
    budget runs out), then apply every free merge. Returns
    ``{"proposals", "table", "before", "after"}`` — ``table`` is the
    candidate (input table deep-copied; the incumbent is never
    mutated), ``proposals`` the applied actions in rank order."""
    import copy

    candidate = copy.deepcopy(dict(table))
    before = project(candidate, mix, max_pad)
    applied = []
    for _ in range(max_splits):
        now = project(candidate, mix, max_pad)
        if now["pad_frac"] < target and now["native"] == 0:
            break
        splits = _split_candidates(candidate, mix, max_pad)
        if not splits:
            break
        splits.sort(key=lambda p: (-p["score"], p["kernel"],
                                   p["spec"]["args"]))
        best = splits[0]
        specs = _kernel_specs(candidate, best["kernel"])
        candidate[best["kernel"]] = specs + [best["spec"]]
        applied.append(best)
    for merge in _merge_candidates(candidate, mix, max_pad):
        specs = _kernel_specs(candidate, merge["kernel"])
        candidate[merge["kernel"]] = [
            s for s in specs if s != merge["spec"]
        ]
        applied.append(merge)
    after = project(candidate, mix, max_pad)
    return {
        "proposals": applied,
        "table": candidate,
        "before": before,
        "after": after,
    }


# ------------------------------------------------------------------ #
# the promotion gate                                                 #
# ------------------------------------------------------------------ #

def judge_canary(candidate: dict, incumbent: dict,
                 margin: float | None = None) -> dict:
    """The promotion gate over one canary replay at identical seeds.
    ``candidate``/``incumbent`` are measured ``{"pad_frac", "p99_s"}``
    rows. Promote ONLY when the candidate's measured pad_frac beats
    the incumbent's by more than ``margin`` (default: the tuning
    layer's >3% PROMOTE_MARGIN) AND its p99 is strictly better — a
    table that pads less but queues worse did not win. Returns
    ``{"promote": bool, "reason": str, ...}``."""
    if margin is None:
        margin = PROMOTE_MARGIN
    c_pad, i_pad = candidate.get("pad_frac"), incumbent.get("pad_frac")
    c_p99, i_p99 = candidate.get("p99_s"), incumbent.get("p99_s")
    row = {
        "candidate": dict(candidate), "incumbent": dict(incumbent),
        "margin": margin, "promote": False,
    }
    if not all(isinstance(v, (int, float))
               for v in (c_pad, i_pad, c_p99, i_p99)):
        row["reason"] = "no-measurement"
        return row
    if i_pad <= 0.0:
        row["reason"] = "nothing-to-save: incumbent pad_frac is 0"
        return row
    pad_win = (i_pad - c_pad) / i_pad
    row["pad_win"] = round(pad_win, 6)
    if pad_win <= margin:
        row["reason"] = (
            f"pad_frac win {pad_win:.1%} <= margin {margin:.0%}"
        )
        return row
    if c_p99 >= i_p99:
        row["reason"] = (
            f"p99 did not win ({c_p99:.4f}s vs {i_p99:.4f}s)"
        )
        return row
    row["promote"] = True
    row["reason"] = (
        f"pad_frac {i_pad:.3f}->{c_pad:.3f} ({pad_win:.1%} win), "
        f"p99 {i_p99:.4f}s->{c_p99:.4f}s"
    )
    return row


# ------------------------------------------------------------------ #
# the persisted candidate artifact                                   #
# ------------------------------------------------------------------ #

def _versions():
    """(torch, CUDA) versions, read without importing torch."""
    from tpukernels_torch.tuning import cache as tcache

    return tcache.installed_versions()


def record_candidate(result: dict, mix: dict, target: float,
                     versions: tuple | None = None) -> str:
    """Atomically persist a proposal as the ``adapt.json`` candidate
    (status ``proposed``), stamped with the evidence a later reader
    validates it against — torch and CUDA versions, serve-source sha,
    repo HEAD — the tuning/aot/slo artifact discipline. Returns the
    path."""
    from tpukernels_torch.resilience import atomic
    from tpukernels_torch.tuning import cache as tcache

    p = path()
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    torch_v, cuda_v = versions if versions is not None else _versions()
    atomic.dump_json(p, {
        "version": 1,
        "status": "proposed",
        "torch": torch_v,
        "cuda": cuda_v,
        "source_sha": tcache.source_sha(SOURCES),
        "git_head": journal.git_head(),
        "created": round(time.time(), 3),
        "pad_target": target,
        "requests_mined": mix_requests(mix),
        "before": result["before"],
        "after": result["after"],
        "proposals": result["proposals"],
        "table": result["table"],
        # the frozen replay spec: the canary must drive candidate AND
        # incumbent with the mix the proposal was projected from, not
        # whatever the journal says on canary day
        "replay": replay_entries(mix, result["table"]),
        "canary": None,
    })
    return p


def _reject(reason: str, **fields):
    """Loud-rejection contract shared with tuning/aot/slo: stderr note
    + ``adapt_rejected`` journal event, once per process per cause."""
    memo = (path(), reason)
    if memo in _REJECT_NOTED:
        return
    _REJECT_NOTED.add(memo)
    print(f"# adapt candidate rejected: {reason}", file=sys.stderr)
    journal.emit("adapt_rejected", path=path(), reason=reason,
                 **fields)


def load(validate: bool = True):
    """The validated ``adapt.json`` candidate, or None. Validation
    mirrors the tuning cache: a candidate proposed under another torch
    or CUDA version, or whose serve sources have a newer commit than its
    ``source_sha``, is rejected loudly and dropped — a bucket table
    projected by last week's pad math must not be canaried (let alone
    promoted) today. A torn file reads as absent via the shared
    tolerant reader, with its own ``artifact_rejected`` note."""
    data = _cachedir.read_json_memoized(path(), {})
    if not data:
        return None
    if not isinstance(data.get("table"), dict):
        _reject("malformed: no candidate table")
        return None
    if not validate:
        return data
    torch_v, cuda_v = _versions()
    if data.get("torch") != torch_v:
        _reject(f"proposed under torch {data.get('torch')}, "
                f"running {torch_v}")
        return None
    if data.get("cuda") != cuda_v:
        _reject(f"proposed under CUDA {data.get('cuda')}, "
                f"running {cuda_v}")
        return None
    from tpukernels_torch.tuning import cache as tcache

    sha = tcache.source_sha(SOURCES)
    if sha is not None and data.get("source_sha") not in (None, sha):
        _reject(
            "stale: a commit touching " + ",".join(SOURCES)
            + " postdates this candidate",
            entry_sha=data.get("source_sha"), current_sha=sha,
        )
        return None
    return data


def update(mutate) -> dict:
    """flock-serialized read-modify-write of ``adapt.json`` (the
    canary writes its verdict beside the proposal it judged)."""
    return _cachedir.locked_json_update(path(), mutate)


def promote(table: dict) -> str:
    """Atomically write the promoted bucket table to the stable
    ``buckets.json`` path ``TPKT_SERVE_BUCKETS`` points at. The
    promotion changes the FILE behind an unchanged env value, so a
    running router/daemon picks it up on ``undrain`` via
    ``bucketing.reload()`` — no fleet restart."""
    from tpukernels_torch.resilience import atomic

    p = buckets_path()
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    atomic.dump_json(p, table)
    return p


# ------------------------------------------------------------------ #
# replay plumbing (the canary's loadgen input)                       #
# ------------------------------------------------------------------ #

def replay_entries(mix: dict, table: dict, top: int = 8) -> list:
    """The observed mix as a loadgen replay spec (``--shapes FILE``
    entries): the ``top`` heaviest shape groups whose kernel has an
    avatar in ``table``, weights = observed counts, statics borrowed
    from the kernel's avatar (the only traffic that buckets). The
    canary replays THIS against candidate and incumbent at identical
    seeds."""
    rows = [
        (row, kernel)
        for kernel, kernel_rows in sorted(mix.items())
        for row in kernel_rows
        if _kernel_specs(table, kernel)
    ]
    rows.sort(key=lambda rk: (-rk[0]["count"], rk[1],
                              rk[0]["shapes"]))
    out = []
    for row, kernel in rows[:top]:
        statics = dict(
            _kernel_specs(table, kernel)[0].get("statics") or {}
        )
        out.append({
            "kernel": kernel,
            "args": [
                [_DTYPE_KINDS.get(dt, dt), list(shape)]
                for dt, shape in zip(row["dtypes"], row["shapes"])
            ],
            "statics": statics,
            "weight": row["count"],
        })
    return out


def measured_side(events, request_ids_prefix=None) -> dict:
    """One canary side's measurement off its isolated journal:
    ``pad_frac`` is the mean over OK ``serve_request`` events (native
    dispatches count their recorded 0.0 — a table that buckets more
    traffic at low pad must not look worse than one that buckets
    none), ``p99_s`` the request-weighted mean of the loadgen
    ``slo_probe`` verdict p99s."""
    pads, n_bucketed = [], 0
    for e in events:
        if e.get("kind") == "serve_request" and e.get("ok"):
            pads.append(float(e.get("pad_frac") or 0.0))
            n_bucketed += bool(e.get("bucketed"))
    p99 = None
    for e in events:
        if e.get("kind") != "slo_probe":
            continue
        num = den = 0.0
        for v in (e.get("verdicts") or {}).values():
            if isinstance(v.get("p99_s"), (int, float)) \
                    and v.get("count"):
                num += v["p99_s"] * v["count"]
                den += v["count"]
        if den:
            p99 = num / den
    return {
        "pad_frac": (sum(pads) / len(pads)) if pads else None,
        "p99_s": p99,
        "requests": len(pads),
        "bucketed": n_bucketed,
        "hist_pad_frac": histogram_pad_frac(events),
    }
