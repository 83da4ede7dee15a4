"""The adaptive bucket optimizer's control verbs.

    python -m tpukernels_torch.serve.optimize propose [--journal PATH ...]
                                                      [--target F]
    python -m tpukernels_torch.serve.optimize canary [--seed N]
        [--requests N] [--rate R] [--margin F]
        [--autotune off|smoke|quick] [--check]
    python -m tpukernels_torch.serve.optimize show

The port's copy of ``tools/serve_optimize.py``, over ``serve/adapt.py``.

``propose`` (no torch in the process) mines the journal's
``serve_request`` shape mix (under ``TPKT_ADAPT_WINDOW_DAYS`` > 1 widened
with the prior days' rollups, ``adapt.window_mix``), projects it against
the incumbent table (``TPKT_SERVE_BUCKETS``, default
``aot.BENCH_CONFIGS``) and, when the
projected mean pad_frac is at or above ``TPKT_ADAPT_PAD_TARGET`` and at
least ``TPKT_ADAPT_MIN_REQUESTS`` requests back it, writes the ranked
split/merge candidate as ``adapt.json`` (event ``adapt_proposed``). No
traffic, no proposal: it says so and exits 0.

``canary`` judges that candidate end to end: it boots an INCUMBENT and a
CANDIDATE port daemon (``python -m tpukernels_torch.serve``) one after
the other on throwaway sockets, each with its own table file, serve dir
and journal, and replays the candidate's frozen shape mix through
``python -m tpukernels_torch.loadgen --shapes <replay> --verify`` against
each at the same seed (a side that answers a request differently from
its first of the same shapes fails the canary). Each side runs twice,
in the order incumbent, candidate, candidate, incumbent, every run on a
fresh daemon: on a shared host the side that runs second can be faster
or slower by more than the padding moves its p99, so
``adapt.judge_canary`` judges each order and the candidate must win in
both (the reference runs each side once, incumbent first). A
win atomically rewrites the stable ``buckets.json``
(``_cachedir.adapt_buckets_path``; event ``adapt_promoted``), which a
daemon whose ``TPKT_SERVE_BUCKETS`` names it re-reads on ``undrain``; a
loss records ``adapt_rejected`` and touches no table file. Either way
the verdict lands in ``adapt.json`` and an ``adapt_canary`` event. The
daemons run where the caller's environment puts them: on the card, or
on the CPU under ``TPKT_SERVE_DEVICE=cpu``. ``--autotune smoke|quick``
first re-tunes the kernels the candidate table names
(``tuning/runner.py:tune_table``: a ``bench --one`` child a candidate,
promotion into the tuning cache over the 3 % margin; ``smoke`` is the
CPU pipeline proof, ``quick`` the reduced sweep on the card), so the
candidate daemons start on tuned knobs.

With no ``TPKT_HEALTH_JOURNAL`` the journal is a dated file in the adapt
dir; ``propose`` mines ``--journal`` files, else that journal.

Exit codes: 0 the verb did what it was asked (nothing to do included);
1 with ``--check`` a rejected candidate, or the verb's machinery failed
(a daemon that does not start, a replay that fails); 2 a usage error.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import adapt

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _mine_events(paths):
    events, bad = journal.load_events(paths)
    if bad:
        print(f"# optimize: {bad} unparseable journal line(s) skipped",
              file=sys.stderr)
    return events


def _cmd_propose(journals, target):
    from tpukernels_torch.serve import bucketing

    if target is None:
        target = adapt.pad_target()
    need = adapt.min_requests()
    events = _mine_events(journals)
    days = adapt.window_days()
    mix, days_used = adapt.window_mix(events, days=days)
    seen = adapt.mix_requests(mix)
    if days > 1:
        print(f"optimize: mining a {days}-day window "
              f"(TPKT_ADAPT_WINDOW_DAYS): today's journal + "
              f"{days_used - 1} prior rollup day(s), {seen} "
              "request(s) total")
    max_pad = bucketing.max_pad_frac()
    incumbent = bucketing.bucket_configs()
    if seen < need:
        print(f"optimize: {seen} OK serve_request(s) mined < "
              f"TPKT_ADAPT_MIN_REQUESTS={need} - no proposal (a table "
              "re-shaped around an anecdote would thrash)")
        return 0
    before = adapt.project(incumbent, mix, max_pad)
    hist = adapt.histogram_pad_frac(events)
    if before["pad_frac"] < target and before["native"] == 0:
        print(f"optimize: projected pad_frac {before['pad_frac']:.3f} "
              f"already below target {target} over {seen} request(s) - "
              "no proposal")
        return 0
    result = adapt.propose(mix, incumbent, target, max_pad=max_pad)
    if not result["proposals"]:
        print("optimize: no split/merge improves on the incumbent "
              f"(pad_frac {before['pad_frac']:.3f}, {before['native']} "
              "native) - no proposal")
        return 0
    p = adapt.record_candidate(result, mix, target)
    journal.emit(
        "adapt_proposed", path=p, requests_mined=seen, pad_target=target,
        hist_pad_frac=hist, window_days=days_used,
        proposals=[{"action": a["action"], "kernel": a["kernel"],
                    "waste_saved": a["waste_saved"],
                    "compiles": a["compiles"]}
                   for a in result["proposals"]],
        before=result["before"], after=result["after"],
    )
    splits = sum(a["action"] == "split" for a in result["proposals"])
    merges = len(result["proposals"]) - splits
    print(f"optimize: proposed {splits} split(s), {merges} merge(s) over "
          f"{seen} request(s): projected pad_frac "
          f"{result['before']['pad_frac']:.3f} -> "
          f"{result['after']['pad_frac']:.3f} (target {target}), native "
          f"{result['before']['native']} -> {result['after']['native']} "
          f"-> {p}")
    print("optimize: next: python -m tpukernels_torch.serve.optimize canary")
    return 0


def _spawn_daemon(sock, table_path, side_dir, side_journal):
    """One canary side's daemon on a throwaway socket: its own table
    file, serve dir and journal (its stderr in ``side_dir``); everything
    else (the device included) inherited from this process."""
    env = dict(os.environ)
    env["TPKT_SERVE_BUCKETS"] = table_path
    env["TPKT_SERVE_DIR"] = side_dir
    env["TPKT_HEALTH_JOURNAL"] = side_journal
    env.pop("TPKT_SERVE_SOCKET", None)  # --socket decides
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    with open(os.path.join(side_dir, "stderr.txt"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "tpukernels_torch.serve", "--socket",
             sock], cwd=_REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=err)


def _stderr_tail(side_dir):
    try:
        with open(os.path.join(side_dir, "stderr.txt")) as f:
            return f.read().strip()[-500:]
    except OSError:
        return ""


def _wait_ready(proc, sock, side_dir, timeout_s=180.0):
    from tpukernels_torch.serve import client as serve_client

    deadline = time.monotonic() + timeout_s
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"canary daemon died rc={proc.returncode}: "
                               f"{_stderr_tail(side_dir)}")
        try:
            with serve_client.ServeClient(sock, timeout_s=5) as c:
                c.ping()
            return
        except OSError:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"canary daemon at {sock} never answered ping: "
                    f"{_stderr_tail(side_dir)}") from None
            time.sleep(0.1)


def _reap(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)


def _run_side(name, table, replay_path, seed, requests, rate, tmp, echo):
    """Boot one side's daemon, replay the frozen mix through the port's
    loadgen at ``seed``, stop it, and measure the side's own journal."""
    side_dir = os.path.join(tmp, name)
    os.makedirs(side_dir, exist_ok=True)
    table_path = os.path.join(side_dir, "buckets.json")
    with open(table_path, "w") as f:
        json.dump(table, f)
    sock = os.path.join(side_dir, "s.sock")
    side_journal = os.path.join(side_dir, "health.jsonl")
    proc = _spawn_daemon(sock, table_path, side_dir, side_journal)
    try:
        _wait_ready(proc, sock, side_dir)
        env = dict(os.environ)
        env["TPKT_HEALTH_JOURNAL"] = side_journal
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH")) if p)
        r = subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.loadgen",
             "--serve", sock, "--shapes", replay_path, "--seed", str(seed),
             "--requests", str(requests), "--rate", str(rate),
             "--verify"],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{name} replay loadgen rc={r.returncode}: "
                               f"{(r.stdout or '').strip()[-500:]}")
    finally:
        _reap(proc)
    events = _mine_events([side_journal])
    side = adapt.measured_side(events)
    # beside the reference's measurement: the replay's drops and each
    # series' own p50/p99 (the pooled p99 is the gate; these explain it)
    probes = [e for e in events if e.get("kind") == "slo_probe"]
    side["dropped"] = sum(sum((e.get("dropped") or {}).values())
                          for e in probes)
    side["series"] = {
        k: {"count": v.get("count"), "p50_s": v.get("p50_s"),
            "p99_s": v.get("p99_s")}
        for k, v in sorted((probes[-1]["verdicts"] if probes
                            else {}).items())}
    echo(f"# {name}: pad_frac="
         + (f"{side['pad_frac']:.4f}" if side["pad_frac"] is not None
            else "n/a")
         + " p99="
         + (f"{side['p99_s'] * 1e3:.2f}ms" if side["p99_s"] is not None
            else "n/a")
         + f" over {side['requests']} request(s), {side['bucketed']} "
         f"bucketed, {side['dropped']} dropped; "
         + ", ".join(f"{k} p50 {v['p50_s'] * 1e3:.2f}ms p99 "
                     f"{v['p99_s'] * 1e3:.2f}ms"
                     for k, v in side["series"].items()
                     if v["p50_s"] is not None and v["p99_s"] is not None))
    return side


# each side twice, in A/B/B/A order: (side, run)
CANARY_ORDER = (("incumbent", 1), ("candidate", 1), ("candidate", 2),
                ("incumbent", 2))


def _pooled(a, b):
    """One side's two runs as one row: pad_frac weighted by requests,
    the worse of the two p99s, counts summed."""
    n = a["requests"] + b["requests"]
    p99s = (a["p99_s"], b["p99_s"])
    return {
        "pad_frac": (sum((m["pad_frac"] or 0.0) * m["requests"]
                         for m in (a, b)) / n if n else None),
        "p99_s": None if None in p99s else max(p99s),
        "requests": n,
        "bucketed": a["bucketed"] + b["bucketed"],
        "dropped": a["dropped"] + b["dropped"],
    }


def _cmd_canary(seed, requests, rate, margin, check, autotune="off"):
    cand = adapt.load()
    if cand is None:
        print("optimize: no valid adapt.json candidate - run propose first "
              "(a stale or torn one was rejected loudly above)")
        return 1 if check else 0
    if cand.get("status") != "proposed":
        print(f"optimize: candidate already judged (status "
              f"{cand.get('status')!r}) - propose again for a fresh one")
        return 0
    replay = cand.get("replay") or []
    if not replay:
        print("optimize: candidate has no replay entries - nothing "
              "measurable", file=sys.stderr)
        return 1
    from tpukernels_torch.serve import bucketing

    tables = {"incumbent": bucketing.bucket_configs(),
              "candidate": cand["table"]}
    if autotune != "off":
        from tpukernels_torch.tuning import runner

        print(f"# re-autotuning the candidate table's kernels ({autotune})")
        runner.tune_table(cand["table"], smoke=autotune == "smoke",
                          quick=autotune == "quick", echo=print)
    tmp = tempfile.mkdtemp(prefix="tpkt_adapt_canary_")
    runs = {}
    try:
        replay_path = os.path.join(tmp, "replay.json")
        with open(replay_path, "w") as f:
            json.dump({"entries": replay}, f)
        for side, k in CANARY_ORDER:
            runs[side, k] = _run_side(f"{side}-{k}", tables[side],
                                      replay_path, seed, requests, rate,
                                      tmp, print)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    orders = []
    for k in (1, 2):
        v = adapt.judge_canary(runs["candidate", k], runs["incumbent", k],
                               margin=margin)
        first = CANARY_ORDER[2 * k - 2][0]
        orders.append(dict(v, first=first))
        print(f"# {first} first: "
              f"{'promote' if v['promote'] else 'reject'} - {v['reason']}")
    cand_m = _pooled(runs["candidate", 1], runs["candidate", 2])
    inc_m = _pooled(runs["incumbent", 1], runs["incumbent", 2])
    verdict = {"promote": all(v["promote"] for v in orders),
               "margin": orders[0]["margin"], "orders": orders,
               "candidate": cand_m, "incumbent": inc_m}
    if verdict["promote"]:
        verdict["pad_win"] = min(v["pad_win"] for v in orders)
        verdict["reason"] = "won in both orders: " + "; ".join(
            v["reason"] for v in orders)
    else:
        lost = next(v for v in orders if not v["promote"])
        verdict["pad_win"] = lost.get("pad_win")
        verdict["reason"] = f"{lost['first']} first: {lost['reason']}"
    journal.emit(
        "adapt_canary", path=adapt.path(), seed=seed, requests=requests,
        promote=verdict["promote"], reason=verdict["reason"],
        pad_win=verdict.get("pad_win"), candidate=cand_m, incumbent=inc_m,
        orders=orders,
    )
    status = "promoted" if verdict["promote"] else "rejected"

    def _stamp(data):
        data["status"] = status
        data["canary"] = {"seed": seed, "requests": requests,
                          "verdict": dict(verdict)}
        return data

    adapt.update(_stamp)
    if verdict["promote"]:
        bp = adapt.promote(cand["table"])
        journal.emit(
            "adapt_promoted", path=adapt.path(), table=bp,
            pad_frac=cand_m["pad_frac"], p99_s=cand_m["p99_s"],
            pad_win=verdict.get("pad_win"), seed=seed,
        )
        print(f"optimize: PROMOTED - {verdict['reason']}")
        print(f"optimize: table -> {bp}; point TPKT_SERVE_BUCKETS={bp} and "
              "undrain (the daemon's undrain op, or ctl undrain for a "
              "fleet worker) to pick it up live")
        return 0
    journal.emit(
        "adapt_rejected", path=adapt.path(), reason=verdict["reason"],
        pad_win=verdict.get("pad_win"), candidate=cand_m, incumbent=inc_m,
    )
    print(f"optimize: REJECTED - {verdict['reason']} (incumbent stays)")
    return 1 if check else 0


def _cmd_show():
    cand = adapt.load(validate=False)
    if cand is None:
        print("optimize: no adapt.json candidate at " + adapt.path())
        return 0
    print(json.dumps(cand, indent=2, sort_keys=True))
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("propose", "canary", "show"):
        print(__doc__, file=sys.stderr)
        print("optimize: want a verb: propose | canary | show",
              file=sys.stderr)
        return 2
    verb, rest = argv[0], argv[1:]
    journals: list = []
    target = margin = None
    seed, requests, rate = 7, 60, 50.0
    autotune = "off"
    check = False
    it = iter(rest)
    try:
        for a in it:
            if a == "--journal":
                journals.append(next(it))
            elif a == "--target":
                target = float(next(it))
            elif a == "--seed":
                seed = int(next(it))
            elif a == "--requests":
                requests = int(next(it))
            elif a == "--rate":
                rate = float(next(it))
            elif a == "--margin":
                margin = float(next(it))
            elif a == "--autotune":
                autotune = next(it)
            elif a == "--check":
                check = True
            else:
                print(__doc__, file=sys.stderr)
                print(f"optimize: unknown argument {a!r}", file=sys.stderr)
                return 2
    except StopIteration:
        print(f"optimize: {a} requires a value", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"optimize: bad value for {a}: {e}", file=sys.stderr)
        return 2
    if autotune not in ("off", "smoke", "quick"):
        print(f"optimize: --autotune {autotune!r} (known: off, smoke, "
              "quick)", file=sys.stderr)
        return 2
    if target is not None and not 0.0 < target <= 1.0:
        print(f"optimize: --target {target} must be in (0, 1]",
              file=sys.stderr)
        return 2
    if os.environ.get("TPKT_HEALTH_JOURNAL") is None:
        d = os.path.dirname(adapt.path())
        os.makedirs(d, exist_ok=True)
        os.environ["TPKT_HEALTH_JOURNAL"] = d
    if not journals:
        journals = [journal.path()]
    try:
        if verb == "propose":
            return _cmd_propose(journals, target)
        if verb == "canary":
            return _cmd_canary(seed, requests, rate, margin, check,
                               autotune)
        return _cmd_show()
    except (RuntimeError, ValueError) as e:
        print(f"optimize: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
