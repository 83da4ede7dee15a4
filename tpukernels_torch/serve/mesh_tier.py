"""The serving daemon's mesh tier: a standing group of follower ranks.

The port's counterpart of the reference's over-avatar mesh dispatch
(``tpukernels/serve/server.py`` with ``registry.dispatch_mesh``). The
reference runs a mesh inside one process over its devices; the port's
``registry.dispatch_mesh`` is collective instead: every rank of a
``torch.distributed`` group calls it with the full operands, one rank a
process (``parallel/mesh.py``). The daemon is one process, so with
``TPKT_SERVE_MESH=n`` (n > 1) it keeps a group of n ranks beside it: it
is rank 0, and it spawns and supervises n - 1 follower processes
(``python -m tpukernels_torch.serve.mesh_tier``), each a rank.

- **The group.** Each generation meets at a fresh ``file://``
  rendezvous under ``<serve dir>/mesh/`` and joins through
  ``parallel/mesh.py``'s :func:`~tpukernels_torch.parallel.mesh.init_group`
  on gloo. The followers run on the daemon's device (the card, or the
  CPU under ``TPKT_SERVE_DEVICE=cpu``), one more process and, on the
  card, one more CUDA context each. NCCL takes one rank a card, so
  several ranks on one card speak gloo and their collectives stage the
  card's tensors through host memory (``collectives._on_wire``,
  ``dist.host_staged_bytes``).
- **An order.** Under the tier lock (one order at a time, whatever the
  bucket or worker thread: two interleaved orders would pair one's
  collectives with the other's), rank 0 resolves its generation's mesh,
  writes the order (kernel, statics, each operand's dtype and shape) as
  one JSON line to every follower's stdin, broadcasts the operands as
  host tensors on that mesh's group, and every rank calls
  ``registry.dispatch_mesh(kernel, *operands, mesh_shape=(n,),
  **statics)``, rank 0 with the mesh pinned (``mesh.pinned``); rank 0's
  full result is the reply. The order goes through a pipe and not the
  group because a gloo receive times out (``TPKT_COORDINATOR_TIMEOUT_S``)
  and a tier may stay idle for hours.
- **Refusals** are decided on rank 0 before an order goes out
  (``registry.check_mesh``: the mesh shape, the key and the call's
  route; an expired deadline), so no follower enters a collective that
  rank 0 skips. The guard of the reply (``resilience/integrity.py``)
  and the journal are rank 0's: followers run with both off, and with
  a compile manifest of their own (``<serve dir>/mesh/aot``), so the
  fleet's one ``aot_miss`` a bucket holds.
- **Recovery.** A follower that dies, an order whose collectives raise
  or outrun the group's timeout, or a follower that fails its call (it
  then exits) breaks the group: the request in flight gets an error
  reply and is never run on one device or requeued. An order past the
  daemon's grace is the watchdog's, as any request is: a live device
  and every follower running earn it one more grace; then the watchdog
  breaks the group (:meth:`MeshTier.abandon`), abandons the worker and
  requeues the request once (a second wedge answers ``wedged``). The
  lock of an abandoned order is retired: the keeper and later orders
  take a fresh one, and the abandoned thread's late release lets go of
  its own. On a break the keeper stops the remaining followers, takes
  the tier lock, leaves the group and forms a new generation
  (``serve_mesh_broken``, then ``serve_mesh_up``); a later mesh request
  waits for it within its deadline. An order is tied to its
  generation: its mesh is pinned, and leaving the group marks that mesh
  left, so an abandoned order that unwinds late raises on its own group
  (``serve_mesh_stale_order``) and never reaches the next one. In-avatar
  requests never touch the tier.
- **Lifetime.** A follower dies with its daemon: it asks the kernel for
  SIGKILL when its parent dies (``prctl(PR_SET_PDEATHSIG)``), and an
  end of file on its stdin ends it too. The daemon spawns followers
  only from threads that live as long as it does (the signal follows
  the spawning thread).

Follower usage (the daemon runs it): ``python -m
tpukernels_torch.serve.mesh_tier --rank R --world N --rendezvous URL
--device DEV --timeout-s S --parent PID``.
"""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time

# how long a generation's followers may take to start (import torch,
# make the device's context) before the group counts as not formed
START_TIMEOUT_S = 180.0
# the keeper's look at its followers, and its wait between failed
# attempts to form a group (doubling up to the last)
POLL_S = 0.1
BACKOFF_S = (0.5, 1.0, 2.0, 5.0)
PR_SET_PDEATHSIG = 1


class MeshTierUnavailable(RuntimeError):
    """No group to run an order on within the request's wait."""


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def follower_env(root: str) -> dict:
    """A follower's environment: the daemon's, without its journal, its
    guard and its fault plan (rank 0 keeps those), with a compile
    manifest of its own under ``root``."""
    env = dict(os.environ)
    env.pop("TPKT_FAULT_PLAN", None)
    env.update(TPKT_HEALTH_JOURNAL="off", TPKT_INTEGRITY="0",
               TPKT_AOT_DIR=os.path.join(root, "aot"))
    return env


def group_timeout_s() -> float:
    """The group's rendezvous and collective timeout:
    ``TPKT_COORDINATOR_TIMEOUT_S``, else the daemon's request timeout
    (``TPKT_SERVE_REQUEST_TIMEOUT_S``), so that a collective stuck on a
    live peer raises before the daemon's watchdog fires."""
    from tpukernels_torch.serve.proc import (DEFAULT_REQUEST_TIMEOUT_S,
                                             float_knob)

    return float_knob("TPKT_COORDINATOR_TIMEOUT_S", float_knob(
        "TPKT_SERVE_REQUEST_TIMEOUT_S", DEFAULT_REQUEST_TIMEOUT_S,
        floor=0.1), floor=0.1)


def tier_root() -> str:
    """The tier's state: ``mesh/`` under the daemon's serve directory."""
    from tpukernels_torch import _cachedir

    return os.path.join(_cachedir.serve_dir(), "mesh")


def spawn_early():
    """A :class:`MeshTier` of ``TPKT_SERVE_MESH`` ranks whose first
    followers start now, before this process imports torch (``python -m
    tpukernels_torch.serve`` calls it first and hands the tier to the
    daemon, which joins them), so that their start runs beside the
    daemon's own; None without a tier. A knob that does not parse, or a
    spawn that fails, is left for the daemon's own start to report.
    Standard library only."""
    from tpukernels_torch.serve.proc import int_knob

    try:
        n = int_knob("TPKT_SERVE_MESH", 1)
        timeout_s = group_timeout_s()
    except ValueError:
        return None
    if n <= 1:
        return None
    tier = MeshTier(n, os.environ.get("TPKT_SERVE_DEVICE") or "cuda",
                    tier_root(), timeout_s)
    try:
        tier.spawn()
    except OSError:
        return None
    return tier


class MeshTier:
    """Rank 0's side of the tier: the group, its followers and its lock.

    ``n`` ranks on ``device`` (a ``torch.device`` or its name: the
    followers resolve it as the daemon does), state under ``root``,
    ``timeout_s`` the group's rendezvous and collective timeout. Only
    :meth:`spawn` runs before torch is imported."""

    def __init__(self, n: int, device, root: str, timeout_s: float):
        self.n, self.device, self.root = n, device, root
        self.timeout_s = float(timeout_s)
        self.backend = "gloo"
        self.generation = 0
        self.rebuilds = 0
        self.start_s = None      # the generation's spawn to join
        self.rebuild_s = None    # the last break to the group up again
        self._why = "an order failed"
        self._procs: list = []
        self._op = threading.Lock()          # the tier lock (retired and
        self._holder = None                  # replaced: abandon()); the
        #                                      order thread holding it
        self._ready = threading.Event()      # a group is up
        self._broken = threading.Event()     # wakes the keeper
        self._stopping = threading.Event()
        # _procs, _spawned, _op, _holder, and generation with _broken
        self._state_lock = threading.Lock()
        # (rendezvous, t0, followers) of the next generation, which
        # spawn() started and _form() has not joined yet
        self._spawned = None

    # ---------------------------------------------------------- lifecycle

    def start(self, device=None):
        """Form the first generation (raises when it cannot: the daemon
        then refuses to start) and start the keeper; ``device`` is the
        daemon's, as resolved. Call it, and :meth:`spawn`, from a thread
        that lives as long as the process."""
        import warnings

        # an operand is a read-only view (the socket's bytes, an shm
        # mapping); its broadcast from rank 0 only reads it
        warnings.filterwarnings(
            "ignore", message="The given NumPy array is not writable",
            category=UserWarning)
        if device is not None:
            self.device = device
        self._form(reason="start")
        threading.Thread(target=self._keeper, daemon=True,
                         name="serve-mesh-keeper").start()

    def stop(self):
        """Stop the followers (a ``stop`` order, then SIGKILL for any
        still there) and leave the group."""
        from tpukernels_torch.parallel import mesh

        self._stopping.set()
        self._broken.set()
        lock = self._take(5.0)
        if lock is not None:
            try:
                self._order_all({"op": "stop"})
            except BrokenPipeError:
                pass  # a follower already gone: reaped below
        self._reap(grace_s=10.0 if lock is not None else 0.0)
        if lock is None:
            # an order still in flight unwinds once its peers are gone
            # (an abandoned one's lock was retired: _take has the fresh)
            lock = self._take(self.timeout_s)
        try:
            if lock is not None:
                mesh.leave()
        finally:
            if lock is not None:
                lock.release()
        self._ready.clear()

    def stats(self) -> dict:
        with self._state_lock:
            pids = [p.pid for p in self._procs]
        return {"ranks": self.n, "backend": self.backend,
                "device": str(self.device), "generation": self.generation,
                "up": self.up(),
                "followers": pids, "rebuilds": self.rebuilds,
                "start_s": self.start_s, "rebuild_s": self.rebuild_s}

    # ------------------------------------------------------------ forming

    def _spawn(self, rank: int, url: str):
        return subprocess.Popen(
            [sys.executable, "-m", "tpukernels_torch.serve.mesh_tier",
             "--rank", str(rank), "--world", str(self.n),
             "--rendezvous", url, "--device", str(self.device),
             "--timeout-s", repr(self.timeout_s),
             "--parent", str(os.getpid())],
            cwd=_repo_root(), env=follower_env(self.root),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=None)

    def _await_ready(self, procs, deadline: float):
        """Wait for each follower's ``ready`` line; raise when one exits
        first or the deadline passes."""
        pending = {p.stdout.fileno(): p for p in procs}
        while pending:
            for p in procs:
                if p.poll() is not None:
                    raise RuntimeError(f"follower pid {p.pid} exited rc "
                                       f"{p.returncode} before joining")
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{len(pending)} follower(s) not ready "
                                   f"within {START_TIMEOUT_S:.0f} s")
            ready, _, _ = select.select(list(pending), [], [],
                                        min(left, POLL_S))
            for fd in ready:
                if pending[fd].stdout.readline().strip() == b"ready":
                    pending.pop(fd)

    def spawn(self):
        """Start the next generation's followers at a fresh rendezvous
        (:meth:`_form` joins them)."""
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, f"rendezvous-{os.getpid()}-"
                                       f"{self.generation + 1}")
        if os.path.exists(path):
            os.unlink(path)
        t0 = time.perf_counter()
        procs = [self._spawn(r, "file://" + path) for r in range(1, self.n)]
        with self._state_lock:
            self._spawned = (path, t0, procs)

    def _form(self, reason: str, since=None):
        """Join the followers :meth:`spawn` started (spawning them first
        unless it ran) as rank 0; ``since`` is the ``perf_counter`` of
        the break it repairs."""
        from tpukernels_torch.parallel import mesh
        from tpukernels_torch.resilience import journal

        if self._spawned is None:
            self.spawn()
        gen = self.generation + 1
        with self._state_lock:
            (path, t0, procs), self._spawned = self._spawned, None
            self._procs = list(procs)
        try:
            self._await_ready(procs, time.monotonic() + START_TIMEOUT_S)
            mesh.init_group("file://" + path, self.n, 0, str(self.device),
                            backend=self.backend, timeout_s=self.timeout_s)
        except BaseException:
            self._reap(grace_s=0.0)
            raise
        now = time.perf_counter()
        self.start_s = round(now - t0, 3)
        if since is not None:
            self.rebuild_s = round(now - since, 3)
        with self._state_lock:
            self.generation = gen
            self._broken.clear()
        self._ready.set()
        journal.emit("serve_mesh_up", ranks=self.n, backend=self.backend,
                     device=str(self.device), generation=gen,
                     followers=[p.pid for p in procs],
                     start_s=self.start_s,
                     rebuild_s=self.rebuild_s if since is not None else None,
                     reason=reason)

    def _order_all(self, order: dict):
        """Write one order line to every follower; a follower gone
        raises BrokenPipeError."""
        line = (json.dumps(order) + "\n").encode()
        with self._state_lock:
            procs = list(self._procs)
        err = None
        for p in procs:
            try:
                p.stdin.write(line)
                p.stdin.flush()
            except (BrokenPipeError, OSError, ValueError) as e:
                err = err or e
        if err is not None:
            raise BrokenPipeError(f"a follower took no order: {err!r}")

    def _reap(self, grace_s: float):
        """Wait up to ``grace_s`` for the followers (and any spawned for
        the next generation), SIGKILL the rest and reap them all."""
        with self._state_lock:
            procs, self._procs = self._procs, []
            if self._spawned is not None:
                procs += self._spawned[2]
                self._spawned = None
        end = time.monotonic() + grace_s
        for p in procs:
            try:
                p.wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                try:
                    f.close()
                except (OSError, BrokenPipeError):
                    pass

    # ------------------------------------------------------------- keeper

    def _exited(self) -> list:
        """``[{"pid", "rc"}]`` of the followers that have exited, those
        killed by a signal first (a follower whose peer died exits after
        it, with rc 1)."""
        with self._state_lock:
            out = [{"pid": p.pid, "rc": p.returncode} for p in self._procs
                   if p.poll() is not None]
        return sorted(out, key=lambda e: (e["rc"] >= 0, e["pid"]))

    def _keeper(self):
        """Watch the followers; on a break, rebuild (module docstring)."""
        from tpukernels_torch.parallel import mesh
        from tpukernels_torch.resilience import journal

        while not self._stopping.is_set():
            self._broken.wait(POLL_S)
            if self._stopping.is_set():
                return
            exited = self._exited()
            if not exited and not self._broken.is_set():
                continue
            reason = ("follower " + ", ".join(
                f"pid {e['pid']} exited rc {e['rc']}" for e in exited)
                if exited else self._why)
            self._broken.set()
            self._ready.clear()
            t0 = time.perf_counter()
            journal.emit("serve_mesh_broken", ranks=self.n,
                         generation=self.generation, reason=reason,
                         exited=exited)
            print(f"# serve: mesh tier generation {self.generation} broken "
                  f"({reason}); rebuilding", file=sys.stderr, flush=True)
            # the order in flight, if any, fails once its peers are gone;
            # the next generation starts while it unwinds
            self._reap(grace_s=0.0)
            self.spawn()
            lock = None
            while lock is None:
                if self._stopping.is_set():
                    return
                lock = self._take(1.0)
            try:
                mesh.leave()
                for attempt in range(1 << 30):
                    if self._stopping.is_set():
                        return
                    try:
                        self._form(reason=reason, since=t0)
                        break
                    except Exception as e:  # noqa: BLE001 — try again
                        print(f"# serve: mesh tier rebuild failed: {e!r}",
                              file=sys.stderr, flush=True)
                        journal.emit("serve_mesh_broken", ranks=self.n,
                                     generation=self.generation,
                                     reason=f"rebuild failed: {e!r}",
                                     exited=[])
                        time.sleep(BACKOFF_S[min(attempt,
                                                 len(BACKOFF_S) - 1)])
                self.rebuilds += 1
            finally:
                lock.release()
            print(f"# serve: mesh tier generation {self.generation} up "
                  f"after {self.rebuild_s:.2f} s", file=sys.stderr,
                  flush=True)

    def _break(self, why: str, gen: int) -> list:
        """Mark generation ``gen`` broken for the keeper, unless it
        already is or a later one is up; returns its followers when this
        call broke it, else []."""
        with self._state_lock:
            if self._broken.is_set() or gen != self.generation:
                return []
            self._why = why
            self._broken.set()
            return list(self._procs)

    def abandon(self, ident: int, gen: int, why: str):
        """The daemon's watchdog abandoned the order of thread ``ident``
        on generation ``gen``: break that generation, its followers
        killed at once so that an order stuck in a collective raises (a
        generation already broken or over is left alone), and retire the
        tier lock if that thread holds it (the reference's rule for a
        bucket lock): the keeper and later orders take a fresh lock, and
        the thread's late :meth:`release` lets go of its own. A lock held
        by a live order is never replaced."""
        for p in self._break(why, gen):
            if p.poll() is None:
                p.kill()
        with self._state_lock:
            if self._holder == ident:
                self._op, self._holder = threading.Lock(), None

    def alive(self, gen: int) -> bool:
        """Whether generation ``gen`` is still up with every follower
        running: the tier's part of the watchdog's liveness, beside the
        device probe."""
        with self._state_lock:
            if gen != self.generation or self._broken.is_set():
                return False
        return not self._exited()

    def up(self) -> bool:
        return self._ready.is_set() and not self._broken.is_set()

    # -------------------------------------------------------------- order

    def _take(self, timeout_s: float):
        """The current tier lock, taken within ``timeout_s`` (None when
        not): a lock retired while this waited on it is let go and the
        fresh one taken."""
        end = time.monotonic() + timeout_s
        while True:
            lock = self._op
            left = end - time.monotonic()
            if lock.acquire(timeout=max(0.0, min(POLL_S, left))):
                with self._state_lock:
                    if lock is self._op:
                        return lock
                lock.release()
            elif left <= 0:
                return None

    def acquire(self, wait_s: float, rebuild_s: float):
        """Take the tier lock with the group up: an order in flight is
        waited for at most ``wait_s``, a group that is down (a rebuild in
        flight) up to ``rebuild_s`` in all. Returns the lock taken, for
        :meth:`release`; None when neither was possible."""
        t0 = time.monotonic()
        while True:
            left = (t0 + (wait_s if self.up() else max(wait_s, rebuild_s))
                    - time.monotonic())
            if left <= 0:
                return None
            lock = self._take(min(left, POLL_S))
            if lock is None:
                continue
            with self._state_lock:
                if lock is self._op and self.up():
                    self._holder = threading.get_ident()
                    return lock
            lock.release()
            # the group is down: the keeper takes the lock to rebuild it
            time.sleep(0.01)

    def rebuild_wait_s(self) -> float:
        """The most a rebuild may take: its followers' start and the
        group's rendezvous."""
        return START_TIMEOUT_S + self.timeout_s

    def release(self, lock):
        """Let go of ``lock``, the one :meth:`acquire` returned (a
        retired lock leaves the current one alone)."""
        with self._state_lock:
            if lock is self._op:
                self._holder = None
        lock.release()

    def run(self, kernel: str, arrays, dev_args, statics: dict):
        """One order, the tier lock held (:meth:`acquire`): ``arrays``
        the request's numpy operands (broadcast from here), ``dev_args``
        rank 0's operands on its device. Returns ``(outputs, wire)``,
        ``wire`` the order's broadcast and host-staged bytes. The order
        runs on this generation's mesh, pinned, whenever it gets there.
        An exception after the order went out breaks its generation,
        unless the order was abandoned (:meth:`abandon`): that is
        journaled as ``serve_mesh_stale_order``."""
        import torch
        import torch.distributed as dist

        from tpukernels_torch import registry
        from tpukernels_torch.obs import metrics as obs_metrics
        from tpukernels_torch.obs import trace
        from tpukernels_torch.parallel import mesh
        from tpukernels_torch.resilience import journal

        gen = self.generation
        ring = mesh.make_mesh(self.n, device=self.device)
        order = {"kernel": kernel, "statics": statics,
                 "args": [[a.dtype.name, list(a.shape)] for a in arrays]}
        staged0 = obs_metrics.counters("dist.host_staged_bytes").get(
            "dist.host_staged_bytes", 0)
        nbytes = int(sum(a.nbytes for a in arrays))
        try:
            self._order_all(order)
            with mesh.pinned(ring):
                with trace.span("mesh/broadcast", bytes=nbytes,
                                ranks=self.n):
                    for a in arrays:
                        dist.broadcast(torch.from_numpy(a), src=0,
                                       group=ring.group)
                obs_metrics.inc("serve.mesh.broadcast_bytes", nbytes)
                out = registry.dispatch_mesh(kernel, *dev_args,
                                             mesh_shape=(self.n,),
                                             **statics)
        except BaseException as e:
            with self._state_lock:
                stale = self._holder != threading.get_ident()
            if stale:
                journal.emit("serve_mesh_stale_order", ranks=self.n,
                             generation=gen, current=self.generation,
                             kernel=kernel, error=repr(e)[:300])
            else:
                self._break(f"an order failed: {e!r}"[:300], gen)
            raise
        staged = obs_metrics.counters("dist.host_staged_bytes").get(
            "dist.host_staged_bytes", 0) - staged0
        return out, {"broadcast": nbytes, "host_staged": int(staged)}


# ------------------------------------------------------------------ #
# the follower (python -m tpukernels_torch.serve.mesh_tier)          #
# ------------------------------------------------------------------ #

def _die_with_parent(parent: int):
    """SIGKILL this process when its parent dies; exit now if it already
    has."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    except (OSError, AttributeError):
        pass  # not Linux: the end of file on stdin still ends it
    if os.getppid() != parent:
        sys.exit(0)


def follower_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="A follower rank of the serving daemon's mesh tier")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rendezvous", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--timeout-s", type=float, required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)

    import torch
    import torch.distributed as dist

    from tpukernels_torch.parallel import mesh

    dev = torch.device(args.device)
    torch.zeros(1, device=dev)  # the device's context, before the group
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    mesh.init_group(args.rendezvous, args.world, args.rank, args.device,
                    backend="gloo", timeout_s=args.timeout_s)
    # after the join: the daemon goes on starting meanwhile
    from tpukernels_torch import registry
    stdin = sys.stdin.buffer
    while True:
        line = stdin.readline()
        if not line:
            return 0  # the daemon is gone
        order = json.loads(line)
        if order.get("op") == "stop":
            mesh.leave()
            return 0
        try:
            ops = [torch.empty(shape, dtype=getattr(torch, dtype))
                   for dtype, shape in order["args"]]
            for t in ops:
                dist.broadcast(t, src=0)
            registry.dispatch_mesh(
                order["kernel"], *(t.to(dev) for t in ops),
                mesh_shape=(args.world,), **order["statics"])
        except Exception as e:  # noqa: BLE001 — the group is broken
            # going back to wait on the pipe could pair this rank's next
            # collective with another of rank 0's: leave it broken
            print(f"# serve mesh follower rank {args.rank}: "
                  f"{order['kernel']} failed: {e!r}", file=sys.stderr,
                  flush=True)
            os._exit(1)


if __name__ == "__main__":
    sys.exit(follower_main())
