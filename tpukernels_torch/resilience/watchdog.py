"""The port's timeout mechanisms: the port's own copy of
``tpukernels/resilience/watchdog.py``.

1. :func:`run_with_alarm` — a SIGALRM guard. It interrupts slowness in
   Python only: a handler runs between bytecodes, so a call hung inside
   native code (a device call) is not interrupted. A second layer inside
   a process something else can kill, never the only one.
2. :func:`kill_after` — a subprocess with a hard kill: the one mechanism
   that ends a real wedge, wherever the child hangs.
3. :func:`patient_probe` — retries a liveness probe with a wait between
   tries; a definite "dead" stops the retries early.

:func:`classify_timeout` decides, after a timeout, whether the device
still answers ("slow": one call was stuck) or not ("wedged"); the
serving daemon's watchdog asks it before it abandons a worker. Every
fire and every verdict is journaled and counted.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time

from tpukernels_torch.obs import metrics
from tpukernels_torch.resilience import journal


class Timeout(Exception):
    """Raised by :func:`run_with_alarm` when its alarm fires."""


def run_with_alarm(fn, seconds: int, site: str | None = None):
    """``fn()`` under SIGALRM, raising :class:`Timeout` after ``seconds``.
    The previous handler is restored and the alarm cancelled on every
    exit path. Main thread only, as ``signal`` requires."""

    def handler(signum, frame):
        metrics.inc("watchdog.sigalrm_fires")
        journal.emit("watchdog_fire", mechanism="sigalrm", site=site,
                     timeout_s=seconds)
        raise Timeout(f"exceeded {seconds}s")

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(int(seconds))
    try:
        return fn()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def kill_after(argv, timeout_s: float, site: str | None = None, **run_kw):
    """Run ``argv`` as a subprocess killed after ``timeout_s``: returns
    ``(CompletedProcess, "ok")``, or ``(None, "timeout")`` once the kill
    fired. A nonzero exit is the child failing, not a wedge: the caller
    reads the return code."""
    try:
        proc = subprocess.run(argv, timeout=timeout_s, **run_kw)
    except subprocess.TimeoutExpired:
        metrics.inc("watchdog.kills")
        journal.emit("watchdog_fire", mechanism="subprocess-kill", site=site,
                     timeout_s=timeout_s, argv=[str(a) for a in argv[:4]])
        return None, "timeout"
    return proc, "ok"


def patient_probe(probe_once, attempts: int, retry_wait_s: float,
                  label: str = "probe") -> bool:
    """``probe_once(attempt)`` up to ``attempts`` times, ``retry_wait_s``
    apart. It returns ``"alive"`` (True), ``"dead"`` (False at once: a
    definite answer waiting cannot change) or ``"retry"``. False when the
    attempts run out; each failed attempt is journaled as
    ``probe_failed``."""
    for attempt in range(attempts):
        r = probe_once(attempt)
        if r == "alive":
            return True
        if r == "dead":
            return False
        print(f"# {label} failed (attempt {attempt + 1}/{attempts})",
              file=sys.stderr)
        last = attempt + 1 == attempts
        metrics.inc("probe.retries")
        journal.emit("probe_failed", label=label, attempt=attempt + 1,
                     attempts=attempts,
                     backoff_s=0.0 if last else retry_wait_s)
        if not last:
            time.sleep(retry_wait_s)
    return False


def classify_timeout(probe_alive: bool, **ctx) -> str:
    """``"slow"`` when the device still answers, else ``"wedged"``;
    journaled as ``wedge_classification`` with the caller's context and
    counted in ``watchdog.classified_<verdict>``."""
    verdict = "slow" if probe_alive else "wedged"
    metrics.inc(f"watchdog.classified_{verdict}")
    journal.emit("wedge_classification", verdict=verdict, **ctx)
    return verdict
