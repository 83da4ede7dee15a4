"""Autotune sweep runner of the port (CLI: ``python -m
tpukernels_torch.autotune``).

The port's copy of ``tpukernels/tuning/runner.py``. Every candidate runs
through the real metric path, ``python -m tpukernels_torch.bench --one
<metric>`` with the candidate's ``TPKT_*`` knobs, in a child under the
watchdog's hard kill, so a wedged candidate costs its timeout
(``TPKT_TUNE_TIMEOUT_S``) and nothing more. Each candidate journals
``tuning_candidate``; a promotion journals ``tuning_promoted`` and writes
the tuning cache (``tuning/cache.py``, which journals
``tuning_cache_put``); the sweep is bracketed by ``tuning_sweep_start`` /
``tuning_sweep_end``.

Promotion: a candidate is promoted only when it beats the shipped
defaults' control row by more than :data:`PROMOTE_MARGIN` on the bench
medians. ``--smoke`` is the exception: its children run on the CPU
(``TPKT_BENCH_SMOKE=1``, ``--device cpu``), their values are meaningless,
and the sweep promotes its first measured candidate, marked ``smoke``
and keyed ``device_kind=cpu``, so it can never steer a card run; it
proves the sweep -> cache -> dispatch pipeline.

Bench children run with ``TPKT_TUNING_CACHE=0``: a knob the candidate
leaves unset falls back to the shipped default, never to a half-written
cache. The identity an entry is keyed and stamped with (device kind,
torch and CUDA versions) is probed in a child under the children's
environment: this process never touches the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import trace
from tpukernels_torch.resilience import journal, watchdog

_REPO = _cachedir._REPO
PROMOTE_MARGIN = 0.03  # a tuned config must beat control by >3% on medians

# the children of a smoke sweep: the CPU's plain versions, collapsed
# repeats, a process that sees no card
_SMOKE_ENV = {"TPKT_BENCH_SMOKE": "1", "CUDA_VISIBLE_DEVICES": ""}

_IDENTITY_CODE = (
    "import json, sys, torch\n"
    "from tpukernels_torch.tuning import cache\n"
    "dev = 'cpu' if '--device' in sys.argv else None\n"
    "if dev is None and not torch.cuda.is_available():\n"
    "    sys.exit('no CUDA device')\n"
    "print(json.dumps({'device_kind': cache.device_kind(dev),\n"
    "                  'torch': torch.__version__,\n"
    "                  'cuda': torch.version.cuda}))\n"
)


def probe_identity(env, timeout_s=240, device=None):
    """``{device_kind, torch, cuda}`` as the bench children will see them,
    probed in a child under the same env (``device`` ``"cpu"`` for a
    smoke sweep). None when the probe hangs or errors: the caller aborts,
    as no valid cache key can be written."""
    argv = [sys.executable, "-c", _IDENTITY_CODE]
    if device == "cpu":
        argv.append("--device")
    r, status = watchdog.kill_after(argv, timeout_s,
                                    site="autotune identity probe", env=env,
                                    cwd=_REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL, text=True)
    if status != "ok" or r.returncode != 0:
        return None
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return None


def _journal_file(env):
    """The journal file the bench children append to under ``env``, or
    None when journaling is off: the runner reads their evidence past a
    byte offset (``aot_hit``/``aot_miss``, ``output_integrity_failed``)."""
    return journal.resolve(env.get("TPKT_HEALTH_JOURNAL"))


def _journal_size(path) -> int:
    if path is None:
        return 0
    try:
        return os.stat(path).st_size
    except OSError:
        return 0


def _events_since(path, offset):
    if path is None:
        return []
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            lines = f.read().splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if isinstance(ev, dict):
            out.append(ev)
    return out


def _sweep_guard_kernels(kernel, metric):
    """The registry keys whose integrity failures indict this sweep's
    candidates: the tuned kernel and every key measured through the same
    bench metric (a sweep of ``scan`` measures through
    ``scan_hist_melem_s``, whose child guards ``scan_histogram``). The
    journal may be shared: an unrelated key's failure must not discard a
    healthy candidate."""
    from tpukernels_torch import registry

    names = {kernel}
    names.update(k for k in registry.tunable_kernels()
                 if registry.tunables(k).metric == metric)
    return names


def _integrity_failures(path, offset, kernels) -> int:
    """``output_integrity_failed`` events of ``kernels`` past ``offset``:
    the candidate child's guard found its results wrong, so its
    measurement is discarded."""
    return sum(ev.get("kind") == "output_integrity_failed"
               and ev.get("kernel") in kernels
               for ev in _events_since(path, offset))


def _aot_hit_ratio(path, offset):
    """hits / (hits + misses) over the ``aot_*`` events past ``offset``,
    None with journaling off or no ensure."""
    kinds = [ev.get("kind") for ev in _events_since(path, offset)]
    hits, misses = kinds.count("aot_hit"), kinds.count("aot_miss")
    if hits + misses == 0:
        return None
    return round(hits / (hits + misses), 3)


def run_candidate(metric, env, timeout_s, device=None):
    """One candidate through ``bench --one`` under the watchdog's hard
    kill: ``(value, status)`` with status ok, timeout, error or parse,
    the bench's own vocabulary."""
    argv = [sys.executable, "-m", "tpukernels_torch.bench", "--one", metric]
    if device == "cpu":
        argv += ["--device", "cpu"]
    r, status = watchdog.kill_after(argv, timeout_s,
                                    site=f"autotune --one {metric}", env=env,
                                    cwd=_REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL, text=True)
    if status == "timeout":
        return None, "timeout"
    if r.returncode != 0:
        return None, "error"
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])["value"], "ok"
    except (ValueError, KeyError, IndexError):
        return None, "parse"


def _summary(kernel, space, ident, rows, control, best, promoted, key,
             pruned):
    from tpukernels_torch.tuning import cache as tcache

    return {"kernel": kernel, "metric": space.metric, "identity": ident,
            "rows": rows, "control": control, "best": best,
            "promoted": promoted, "cache_key": key,
            "cache_path": tcache.path(), "pruned": pruned}


def tune(kernel: str, smoke: bool = False, quick: bool = False,
         max_candidates: int | None = None, timeout_s: float | None = None,
         base_env: dict | None = None, echo=None):
    """Sweep one kernel's search space; returns a summary dict.

    ``base_env`` is the environment the bench children run under (default
    ``os.environ``); ``echo`` gets one line a candidate."""
    from tpukernels_torch import registry
    from tpukernels_torch.tuning import cache as tcache

    space = registry.tunables(kernel)
    if space.metric is None:
        raise ValueError(f"kernel {kernel!r} declares no bench metric; "
                         "nothing to tune")
    echo = echo or (lambda line: None)
    env0 = dict(os.environ if base_env is None else base_env)
    device = None
    if smoke:
        env0.update(_SMOKE_ENV)
        device = "cpu"
    env0["TPKT_TUNING_CACHE"] = "0"  # children never read mid-sweep
    env0["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env0.get("PYTHONPATH")) if p)
    # the children journal where this sweep does, so that their evidence
    # can be read back (an explicit 0/off stays off)
    if env0.get("TPKT_HEALTH_JOURNAL") is None:
        d = os.path.dirname(_cachedir.aot_manifest_path(env0))
        os.makedirs(d, exist_ok=True)
        env0["TPKT_HEALTH_JOURNAL"] = d
    if timeout_s is None:
        timeout_s = float(os.environ.get("TPKT_TUNE_TIMEOUT_S",
                                         "60" if smoke else "420"))

    ident = probe_identity(env0, device=device)
    if ident is None:
        raise RuntimeError("autotune: the identity probe failed (no card "
                           "answering?) - no valid cache key can be written")

    cands, pruned = space.candidates(shape=space.bench_shape)
    if pruned:
        echo(f"# {pruned} candidate(s) pruned by the shared-memory budget "
             f"({space.smem_budget_bytes} B a block)")
    if quick:
        # the control plus single-axis probes of the first declared knob
        cands = space.quick_candidates(shape=space.bench_shape)
    if smoke and max_candidates is None:
        max_candidates = 3
    if max_candidates is not None and len(cands) > max_candidates:
        echo(f"# sweep capped at {max_candidates} of {len(cands)} "
             "candidates (--max-candidates)")
        cands = cands[:max_candidates]
    if not cands:
        journal.emit("tuning_sweep_end", kernel=kernel, measured=0,
                     failed=0, promoted=None)
        return _summary(kernel, space, ident, [], None, None, None, None,
                        pruned)

    journal.emit("tuning_sweep_start", kernel=kernel, metric=space.metric,
                 candidates=len(cands), pruned=pruned, smoke=smoke,
                 device_kind=ident["device_kind"])
    guarded = _sweep_guard_kernels(kernel, space.metric)
    rows = []
    for params in cands:
        env = dict(env0)
        env.update(space.env_for(params))
        t0 = time.monotonic()
        # re-resolved a candidate: a directory-valued journal rolls over
        # to a new dated file at midnight
        jpath = _journal_file(env0)
        j0 = _journal_size(jpath)
        with trace.span(f"tune/{kernel}", **params):
            value, status = run_candidate(space.metric, env, timeout_s,
                                          device)
        elapsed = round(time.monotonic() - t0, 2)
        aot_ratio = _aot_hit_ratio(jpath, j0)
        integrity_failed = _integrity_failures(jpath, j0, guarded)
        if integrity_failed and value is not None:
            value, status = None, "integrity"
        obs_metrics.inc("tuning.candidates_ok" if value is not None
                        else "tuning.candidates_failed")
        journal.emit("tuning_candidate", kernel=kernel, params=params,
                     value=value, status=status, elapsed_s=elapsed,
                     aot_hit_ratio=aot_ratio,
                     integrity_failed=integrity_failed)
        shown = (f"{value:12.2f}" if value is not None
                 else f"  FAIL ({status})")
        echo("  ".join(f"{k}={v}" for k, v in params.items()) + f"  {shown}"
             + (f"  [aot hit {aot_ratio:.0%}]" if aot_ratio is not None
                else ""))
        rows.append({"params": params, "value": value, "status": status,
                     "elapsed_s": elapsed, "aot_hit_ratio": aot_ratio,
                     "integrity_failed": integrity_failed})

    # candidates() puts the shipped defaults first: without them (pruned)
    # there is no control row and no promotion
    control = rows[0] if rows[0]["params"] == space.defaults() else None
    measured = [r for r in rows if r["value"] is not None]
    best = max(measured, key=lambda r: r["value"], default=None)
    promoted = None
    if smoke:
        # a pipeline proof, not a tuning claim: sweep order decides
        promoted = measured[0] if measured else None
    elif (best is not None and control is not None and best is not control
          and control["value"]
          and best["value"] > control["value"] * (1.0 + PROMOTE_MARGIN)):
        promoted = best
    key = None
    if promoted is not None:
        key = tcache.put(space, promoted["params"], shape=space.bench_shape,
                         dtype=space.bench_dtype, kind=ident["device_kind"],
                         value=promoted["value"],
                         control=control["value"] if control else None,
                         smoke=smoke,
                         versions=(ident["torch"], ident["cuda"]))
        journal.emit("tuning_promoted", kernel=kernel, key=key,
                     params=promoted["params"], value=promoted["value"],
                     control=control["value"] if control else None,
                     smoke=smoke)
    journal.emit("tuning_sweep_end", kernel=kernel, measured=len(measured),
                 failed=len(rows) - len(measured),
                 promoted=promoted["params"] if promoted else None)
    return _summary(kernel, space, ident, rows, control, best, promoted, key,
                    pruned)


def tune_table(table: dict, smoke: bool = False, quick: bool = False,
               max_candidates: int | None = None,
               timeout_s: float | None = None, base_env: dict | None = None,
               echo=None):
    """Sweep every tunable kernel a bucket table names (the adaptive
    canary's re-tune): ``{kernel: summary}``, None for a key that is not
    in the registry or declares no bench metric (skipped loudly, never an
    error)."""
    from tpukernels_torch import registry

    echo = echo or (lambda line: None)
    out = {}
    for kernel in sorted(table):
        try:
            space = registry.tunables(kernel)
        except KeyError:
            echo(f"# tune_table: {kernel!r} has no search space, skipped")
            out[kernel] = None
            continue
        if space.metric is None:
            echo(f"# tune_table: {kernel} declares no bench metric, "
                 "skipped")
            out[kernel] = None
            continue
        out[kernel] = tune(kernel, smoke=smoke, quick=quick,
                           max_candidates=max_candidates,
                           timeout_s=timeout_s, base_env=base_env,
                           echo=echo)
    return out
