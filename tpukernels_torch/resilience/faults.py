"""Deterministic fault injection for the port's guarded paths.

The port's own copy of the parts of ``tpukernels/resilience/faults.py``
that ``registry.dispatch``, the integrity guard, ``atomic.py``, the C
entry, the serving daemon, the fleet router and the revalidation
supervisor reach.
``TPKT_FAULT_PLAN`` holds inline JSON or the path of a JSON file. It is
read once, at import; a process that sets it later calls
:func:`reload_plan`. Unset (the production case), every injection point
is one ``_PLAN is None`` check.

Plan keys (all optional). ``kernel`` omitted matches any kernel, a bare
string is ``{"kernel": ...}``, and an ``"env": {"VAR": "value"}`` clause
narrows a key to processes whose environment holds those values:

- ``"slow_dispatch": {"kernel": "scan", "delay_s": 0.6, "every": 20}``
  — every ``every``-th matching ``registry.dispatch`` (counted per
  process and kernel, default 1) sleeps ``delay_s`` (default 0.1)
  before it runs: a latency-tail fault.
- ``"wedge_dispatch": {"kernel": "scan", "times": 1}`` — the first
  ``times`` matching dispatches (0: all) hang, immune to SIGALRM, as a
  wedged device call would; ``once_file`` makes it one-shot across
  processes.
- ``"kill_worker": {"kernel": "scan", "on_call": 3}`` — the process
  SIGKILLs itself on its ``on_call``-th matching dispatch (default 1);
  ``once_file`` as above.
- ``"corrupt_output": {"kernel": "sgemm", "site": "registry"}`` /
  ``"nan_output": {...}`` — the integrity guard corrupts the result it
  is about to check, and its canary's result too: ``corrupt`` adds a
  finite delta to the first element (only the canary tiers can catch
  it), ``nan`` writes a NaN into the first float leaf (tier 1's prey;
  on an int-only result it degrades to ``corrupt``). ``site`` omitted
  matches any guarded path (``registry``, ``capi`` or ``manual``).
- ``"delay_response": {"kernel": "scan", "delay_s": 0.5, "times": 1}``
  — the serving daemon holds a finished response of a matching kernel
  for ``delay_s`` (default 0.1) before it sends it, every ``every``-th
  time (default 1), at most ``times`` times (0, the default: always): a
  slow worker whose kernel already ran.
- ``"kill_router": {"on_call": 2}`` — the fleet router SIGKILLs itself
  on its ``on_call``-th accepted dispatch (default 1), after the
  request's ``router.wal`` entry is durable and before it is forwarded:
  the guardian must respawn it and the new router replay the entry.
  ``once_file`` makes it one-shot across respawns; an ``env`` clause
  narrows it. Only the router has this injection point.
- ``"fail_capi": "sgemm"`` / ``"wedge_capi": "sgemm"`` — the C entry's
  ``capi.run_from_c`` for that kernel raises, or hangs as
  ``wedge_dispatch`` does, before its adapter runs.
- ``"probe": ["hang", "dead", "ok"]`` — scripted outcomes of the
  supervisor's liveness probe (``resilience/supervisor.py``), one
  consumed a probe attempt in this process, the last repeated once the
  list runs out: ``"ok"`` is alive without a probe child, anything else
  is not alive. ``"hang_probe": N`` is sugar: the first N attempts
  ``"hang"``, later ones run the real probe.
- ``"kill_supervisor": "step"`` (or ``{"step": "step"}``; no step
  matches any) — the supervisor SIGKILLs itself right after it has
  checkpointed that step's ``step_start``, before the step runs: the
  worst instant for resuming.
- ``"torn_write": {"path_substr": "integrity", "on_call": 1}`` — the
  ``on_call``-th matching ``resilience/atomic.py`` write leaves half
  its bytes in the temporary file and aborts before the rename
  (``"mode": "raise"``, the default, raises OSError; ``"kill"``
  SIGKILLs the process). The target keeps its old content.
- ``"wedge_metric": {"metric": "stencil3d_mcells_s", "phase":
  "execute"}`` — the bench child measuring that metric
  (``python -m tpukernels_torch.bench --one``/``--prewarm``) hangs at
  that phase (``operand``, ``compile`` or ``execute``), immune to
  SIGALRM, so only its parent's hard kill reaps it. ``metric`` omitted
  matches any metric, ``phase`` defaults to ``execute``; an ``env``
  clause narrows it to one candidate of a tuning sweep (candidates
  differ only by their ``TPKT_*`` knobs).
- ``"fail_metric": {...}`` — the same matching, but the child raises
  instead of hanging.

Every fault that fires emits a ``fault_injected`` journal event.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

from tpukernels_torch.resilience import journal


def _load_plan():
    raw = os.environ.get("TPKT_FAULT_PLAN")
    if not raw or not raw.strip():
        return None
    if raw.lstrip()[:1] in ("{", "["):
        plan = json.loads(raw)
    else:
        with open(raw) as f:
            plan = json.load(f)
    if not isinstance(plan, dict):
        raise ValueError(
            f"TPKT_FAULT_PLAN must be a JSON object, got "
            f"{type(plan).__name__}")
    return plan


_PLAN = _load_plan()
_DISPATCH_CALLS: dict = {}  # kernel -> dispatches seen (slow_dispatch)
_WEDGE_CALLS: dict = {}     # kernel -> dispatches seen (wedge_dispatch)
_KILL_CALLS: dict = {}      # kernel -> dispatches seen (kill_worker)
_RESPONSE_CALLS: dict = {}  # kernel -> responses seen (delay_response)
_ROUTE_CALLS = 0            # router admissions seen (kill_router)
_TORN_CALLS = 0             # matching atomic writes seen (torn_write)
_PROBE_IDX = 0              # probe attempts scripted (probe, hang_probe)
_CURRENT_METRIC = None      # the bench child's metric (enter_metric)


def active() -> bool:
    """Whether a fault plan is loaded in this process."""
    return _PLAN is not None


def reload_plan():
    """Re-read ``TPKT_FAULT_PLAN`` and reset the per-process fault
    counters; returns the plan (None when unset)."""
    global _PLAN, _ROUTE_CALLS, _TORN_CALLS, _PROBE_IDX, _CURRENT_METRIC
    _PLAN = _load_plan()
    _DISPATCH_CALLS.clear()
    _WEDGE_CALLS.clear()
    _KILL_CALLS.clear()
    _RESPONSE_CALLS.clear()
    _ROUTE_CALLS = _TORN_CALLS = _PROBE_IDX = 0
    _CURRENT_METRIC = None
    return _PLAN


def _spec(key: str, kernel=None):
    """The plan's spec for ``key`` as a dict when it applies to
    ``kernel`` in this process, else None."""
    spec = _PLAN.get(key)
    if not spec:
        return None
    if isinstance(spec, str):
        spec = {"kernel": spec}
    want = spec.get("kernel")
    if want is not None and want != kernel:
        return None
    return spec if _env_match(spec) else None


def _env_match(spec) -> bool:
    """True unless the spec's ``env`` clause names a value this
    process's environment does not hold."""
    want_env = spec.get("env")
    return not (want_env and any(os.environ.get(k) != v
                                 for k, v in want_env.items()))


def _mark_once(spec) -> bool:
    """False when the spec's ``once_file`` exists (the fault already
    fired in some process); else creates it, before the fault fires,
    and returns True."""
    once = spec.get("once_file")
    if once:
        if os.path.exists(once):
            return False
        with open(once, "w") as f:
            f.write(f"{os.getpid()}\n")
    return True


def _wedge(desc: str):
    """Hang as a wedged device call does: immune to SIGALRM, so only a
    process-level kill ends it."""
    print(f"# fault: wedging ({desc})", file=sys.stderr, flush=True)
    try:
        signal.signal(signal.SIGALRM, signal.SIG_IGN)
    except ValueError:
        pass  # not the main thread: the loop below still hangs
    while True:
        time.sleep(60)


def _fail(desc: str):
    raise RuntimeError(f"injected fault: {desc}")


def enter_metric(name: str):
    """Record which bench metric this child process measures, so that
    :func:`phase_fault` can match ``wedge_metric``/``fail_metric``."""
    global _CURRENT_METRIC
    if _PLAN is None:
        return
    _CURRENT_METRIC = name


def phase_fault(phase: str):
    """Injection point of the bench's measure phases (``operand``,
    ``compile``, ``execute``): ``wedge_metric`` and ``fail_metric``."""
    if _PLAN is None:
        return
    for key, action in (("wedge_metric", _wedge), ("fail_metric", _fail)):
        spec = _PLAN.get(key)
        if not spec:
            continue
        want = spec.get("metric")
        if want is not None and want != _CURRENT_METRIC:
            continue
        if spec.get("phase", "execute") != phase or not _env_match(spec):
            continue
        journal.emit("fault_injected", site="metric", fault=key,
                     metric=_CURRENT_METRIC, phase=phase)
        action(f"{key} {_CURRENT_METRIC or '<any>'}:{phase}")


def dispatch_fault(kernel: str):
    """Injection point of ``registry.dispatch``: ``kill_worker``,
    ``wedge_dispatch`` and ``slow_dispatch``."""
    if _PLAN is None:
        return
    spec = _spec("kill_worker", kernel)
    if spec is not None:
        n = _KILL_CALLS[kernel] = _KILL_CALLS.get(kernel, 0) + 1
        if n == int(spec.get("on_call", 1)) and _mark_once(spec):
            journal.emit("fault_injected", site="dispatch", kernel=kernel,
                         fault="kill_worker", call=n)
            print(f"# fault: SIGKILL self mid-{kernel} dispatch (call {n})",
                  file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    spec = _spec("wedge_dispatch", kernel)
    if spec is not None:
        n = _WEDGE_CALLS[kernel] = _WEDGE_CALLS.get(kernel, 0) + 1
        times = int(spec.get("times", 1))
        if (times <= 0 or n <= times) and _mark_once(spec):
            journal.emit("fault_injected", site="dispatch", kernel=kernel,
                         fault="wedge_dispatch", call=n)
            _wedge(f"wedge_dispatch {kernel} (call {n})")
    spec = _spec("slow_dispatch", kernel)
    if spec is None:
        return
    n = _DISPATCH_CALLS[kernel] = _DISPATCH_CALLS.get(kernel, 0) + 1
    every = int(spec.get("every", 1))
    if every > 1 and n % every:
        return
    delay = float(spec.get("delay_s", 0.1))
    journal.emit("fault_injected", site="dispatch", kernel=kernel,
                 fault="slow_dispatch", delay_s=delay, call=n)
    time.sleep(delay)


def response_fault(kernel: str):
    """Injection point of the serving daemon's response path, after the
    dispatch and before the send: ``delay_response``."""
    if _PLAN is None:
        return
    spec = _spec("delay_response", kernel)
    if spec is None:
        return
    n = _RESPONSE_CALLS[kernel] = _RESPONSE_CALLS.get(kernel, 0) + 1
    every = int(spec.get("every", 1))
    if every > 1 and n % every:
        return
    times = int(spec.get("times", 0))
    if times > 0 and n > times * every:
        return
    delay = float(spec.get("delay_s", 0.1))
    journal.emit("fault_injected", site="response", kernel=kernel,
                 fault="delay_response", delay_s=delay, call=n)
    print(f"# fault: delaying {kernel} response {delay}s (call {n})",
          file=sys.stderr, flush=True)
    time.sleep(delay)


def router_fault():
    """Injection point of the fleet router's accept path
    (``router._route``, after the request's ``router.wal`` entry is
    durable, before the forward): ``kill_router``."""
    global _ROUTE_CALLS
    if _PLAN is None:
        return
    spec = _PLAN.get("kill_router")
    if not spec:
        return
    if not isinstance(spec, dict):
        spec = {}
    if not _env_match(spec):
        return
    _ROUTE_CALLS += 1
    n = _ROUTE_CALLS
    if n != int(spec.get("on_call", 1)) or not _mark_once(spec):
        return
    journal.emit("fault_injected", site="route", fault="kill_router",
                 call=n)
    print(f"# fault: SIGKILL self mid-route (call {n})",
          file=sys.stderr, flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


def torn_write_fault(path: str):
    """The ``torn_write`` spec that applies to this atomic write of
    ``path``, or None; ``atomic.write_text`` applies it with
    :func:`apply_torn_write`."""
    global _TORN_CALLS
    if _PLAN is None:
        return None
    spec = _PLAN.get("torn_write")
    if not spec:
        return None
    if isinstance(spec, str):
        spec = {"path_substr": spec}
    sub = spec.get("path_substr")
    if (sub and sub not in path) or not _env_match(spec):
        return None
    _TORN_CALLS += 1
    if _TORN_CALLS != int(spec.get("on_call", 1)):
        return None
    if not _mark_once(spec):
        return None
    return dict(spec, _call=_TORN_CALLS)


def apply_torn_write(spec: dict, path: str, tmp: str, data: bytes):
    """Leave half of ``data`` in ``tmp`` and abort before the rename:
    raise OSError (``"mode": "raise"``) or SIGKILL the process
    (``"kill"``). ``path`` keeps its old content either way."""
    with open(tmp, "wb") as f:
        f.write(data[: max(1, len(data) // 2)])
        f.flush()
    n = spec.get("_call")
    journal.emit("fault_injected", site="atomic_write", fault="torn_write",
                 path=path, call=n)
    print(f"# fault: torn write mid-{os.path.basename(path)} (call {n})",
          file=sys.stderr, flush=True)
    if spec.get("mode") == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    raise OSError(f"injected fault: torn_write on {path}")


def capi_fault(kernel: str):
    """Injection point of ``capi.run_from_c``: ``fail_capi`` raises,
    ``wedge_capi`` hangs."""
    if _PLAN is None:
        return
    if _PLAN.get("fail_capi") == kernel:
        journal.emit("fault_injected", site="capi", kernel=kernel,
                     fault="fail_capi")
        raise RuntimeError(f"injected fault: fail_capi {kernel}")
    if _PLAN.get("wedge_capi") == kernel:
        journal.emit("fault_injected", site="capi", kernel=kernel,
                     fault="wedge_capi")
        _wedge(f"wedge_capi {kernel}")


def output_fault(site: str, kernel):
    """Injection point of the integrity guard: ``"nan"`` or
    ``"corrupt"`` when the plan wants this (site, kernel)'s result
    corrupted, else None. The guard applies the corruption."""
    if _PLAN is None:
        return None
    for key, mode in (("nan_output", "nan"), ("corrupt_output", "corrupt")):
        spec = _spec(key, kernel)
        if spec is None:
            continue
        want_site = spec.get("site")
        if want_site is not None and want_site != site:
            continue
        journal.emit("fault_injected", site=f"output:{site}", kernel=kernel,
                     fault=key)
        return mode
    return None


def probe_outcome():
    """The scripted outcome of the next liveness-probe attempt, or None
    to run the real probe; one ``probe`` entry is consumed an attempt."""
    global _PROBE_IDX
    if _PLAN is None:
        return None
    idx = _PROBE_IDX
    out = None
    script = _PLAN.get("probe")
    if script:
        out = script[min(idx, len(script) - 1)]
    elif idx < int(_PLAN.get("hang_probe", 0)):
        out = "hang"
    if out is None:
        return None
    _PROBE_IDX += 1
    journal.emit("fault_injected", site="probe", outcome=out, attempt=idx)
    return out


def supervisor_fault(step: str):
    """Injection point of the revalidation supervisor, after ``step``'s
    ``step_start`` is durably checkpointed and before the step runs:
    ``kill_supervisor`` SIGKILLs this process."""
    if _PLAN is None:
        return
    spec = _PLAN.get("kill_supervisor")
    if spec is None:
        return
    want = spec.get("step") if isinstance(spec, dict) else spec
    if want and want != step:
        return
    journal.emit("fault_injected", site="supervisor", step=step,
                 fault="kill_supervisor")
    print(f"# fault: SIGKILL supervisor mid-{step}", file=sys.stderr,
          flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
