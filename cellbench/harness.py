"""One run of one cell: set-up, the measured window, the comparison with
the reference, the run's record.

The window drives the program's public entry at its defaults:
``tpukernels_torch.registry.dispatch`` (traffic ``entry: dispatch``) or
``registry.dispatch_mesh`` (``entry: dispatch_mesh``, every rank of the
mesh in its own process). One caller runs a closed loop: each call takes
an operand tuple of the seeded pool in a seeded order, and ends when its
result is synchronised on the device; its latency is read from two CUDA
events, one recorded before the call is issued and one after it returns,
on the device's clock. A reservoir, drawn from the seed, keeps the
outputs of ``samples`` calls spread over the window; once the window has
closed and the peak memory has been read, the plain reference recomputes
each from its own operands and ``reference/<kernel>.py`` compares.

A traced run (``--trace 1``) splits its window in two. Until its last
``trace_seconds`` the program's spans are on (``TPKT_TRACE``, written to
its journal), and the span metrics read them. The last
``trace_seconds`` run with the spans off and ``torch.profiler`` on,
rank 0's calls each inside a ``cellbench.call`` annotation, so the
device's busy share is that of the program as the untraced window runs
it, with only the profiler's own cost added.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import time
from dataclasses import dataclass, field

from cellbench import profiling, roofline, spec

SEED_MASK = (1 << 63) - 1
STOP, SPANS, PROFILED = 0, 1, 2


@dataclass
class Clock:
    """Seconds since the process started, read from ``/proc`` once and
    carried on by ``perf_counter``; ``split`` names the set-up's parts."""

    age0: float
    t0: float
    split: dict = field(default_factory=dict)
    _last: float = 0.0

    @classmethod
    def start(cls) -> "Clock":
        t0 = time.perf_counter()
        try:
            with open("/proc/self/stat") as f:
                start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
            with open("/proc/uptime") as f:
                uptime = float(f.read().split()[0])
            age0 = max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
        except (OSError, ValueError, IndexError):
            age0 = 0.0
        c = cls(age0, t0)
        c._last = age0
        return c

    def age(self) -> float:
        return self.age0 + time.perf_counter() - self.t0

    def lap(self, name: str) -> None:
        """Charge the time since the last lap to ``name``."""
        now = self.age()
        self.split[name] = self.split.get(name, 0.0) + now - self._last
        self._last = now


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn by ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def _within(value, limit) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def leaves(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def make_entry(cell: spec.Cell, statics: dict):
    """The call the window makes: the traffic's entry of
    ``tpukernels_torch.registry`` with the cell's statics."""
    from tpukernels_torch import registry

    entry = cell.traffic.get("entry", "dispatch")
    if entry == "dispatch":
        return lambda ops: leaves(registry.dispatch(cell.kernel, *ops,
                                                    **statics))
    if entry == "dispatch_mesh":
        shape = tuple(cell.traffic["mesh_shape"])
        return lambda ops: leaves(registry.dispatch_mesh(
            cell.kernel, *ops, mesh_shape=shape, **statics))
    raise ValueError(f"traffic entry {entry!r}: expected dispatch or "
                     "dispatch_mesh")


class _Timer:
    """A call's latency: CUDA events on the device's clock where the run
    is on the card, ``perf_counter`` on the CPU (the CPU tests)."""

    def __init__(self, torch, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def begin(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def end(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


class _Phase:
    """The phase of the next call (``STOP``, ``SPANS`` or ``PROFILED``):
    rank 0's clock decides, and on a mesh its decision is broadcast so
    that every rank makes as many calls and switches with it."""

    def __init__(self, torch, device, world: int):
        self.world = world
        if world > 1:
            import torch.distributed as dist

            self.dist = dist
            self.flag = torch.zeros(1, dtype=torch.int32, device=device)

    def next(self, wanted: int) -> int:
        if self.world == 1:
            return wanted
        self.flag.fill_(wanted)
        self.dist.broadcast(self.flag, src=0)
        return int(self.flag.item())


def _spans(on: bool) -> None:
    """The program's spans on or off from the next call on."""
    from tpukernels_torch.obs import trace

    os.environ["TPKT_TRACE"] = "1" if on else "0"
    trace.reload()


def _journal_since(path: str | None, offset: int) -> list:
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        f.seek(offset)
        for line in f:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("kind") == "span":
                out.append(ev)
    return out


def _size(path: str | None) -> int:
    try:
        return os.path.getsize(path) if path else 0
    except OSError:
        return 0


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, clock: Clock, entry=None, rank: int = 0,
             world: int = 1, keep: bool = False) -> dict:
    """Set up, measure, compare. Returns the run's record: the numbers
    the metric readers read, the compared numbers and their limits, the
    device, and (``keep``) the sampled operands, outputs and reference
    results. ``entry`` replaces the program's call (the fault tests)."""
    import torch

    from tpukernels_torch import kernels as port_kernels
    from tpukernels_torch import registry  # noqa: F401  (timed as import)
    from tpukernels_torch.resilience import journal

    clock.lap("import tpukernels_torch")
    kin = spec.load_module("inputs", cell.kernel)
    statics = cell.statics
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    pool = kin.make(cell.config, int(cell.traffic["pool"]), gen, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    clock.lap("inputs")
    call = entry or make_entry(cell, statics)
    timer = _Timer(torch, device)
    phase = _Phase(torch, device, world)
    order = random.Random(int(seed) * 2 + 1)
    sampler = Reservoir(int(cell.traffic["samples"]), random.Random(
        int(seed) * 2 + 2))
    for i in range(int(cell.traffic.get("warmup_calls", 3))):
        timer.begin()
        call(pool[i % len(pool)])
        timer.end()
        clock.lap("first call" if i == 0 else "warm-up")
    profiled = trace and rank == 0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with (profile(activities=acts) if profiled
              else contextlib.nullcontext()):
            timer.begin()  # the profiler's own start-up, on every rank
            call(pool[0])
            timer.end()
        clock.lap("profiler warm-up")
    jpath = journal.path() if trace else None
    jstart = _size(jpath)
    launches0 = dict(port_kernels.LAUNCHES)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trace_s = float(cell.traffic.get("trace_seconds", 3.0)) if trace else 0.0
    lat, calls, span_calls = [], 0, 0
    prof = None
    setup_s = clock.age()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    switch_at = deadline - trace_s
    now = t_start
    while True:
        want = (STOP if now >= deadline
                else PROFILED if trace and now >= switch_at else SPANS)
        ph = phase.next(want)
        if ph == STOP:
            break
        if ph == PROFILED and prof is None:
            _spans(False)
            prof = (profile(activities=acts) if profiled
                    else contextlib.nullcontext())
            prof.__enter__()
        idx = order.randrange(len(pool))
        if ph == PROFILED and profiled:
            with record_function(profiling.ANNOTATION):
                timer.begin()
                out = call(pool[idx])
                ms = timer.end()
        else:
            timer.begin()
            out = call(pool[idx])
            ms = timer.end()
        lat.append(ms)
        sampler.offer((calls, idx, out))
        calls += 1
        span_calls += ph == SPANS
        out = None
        now = time.perf_counter()
    window_s = time.perf_counter() - t_start
    if prof is not None:
        prof.__exit__(None, None, None)
        _spans(True)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if world > 1:
        import torch.distributed as dist

        p = torch.tensor([peak], dtype=torch.int64, device=device)
        dist.all_reduce(p, op=dist.ReduceOp.MAX)
        peak = int(p.item())
    rec = {"setup_s": setup_s, "setup_parts_s": dict(clock.split),
           "window_s": window_s, "calls": calls,
           "latency_ms": lat, "trace": bool(trace), "ranks": world,
           "memory_peak_bytes": int(peak)}
    if trace:
        rec["spans"] = _journal_since(jpath, jstart)
        rec["span_calls"] = span_calls
        rec["launches"] = {k: v - launches0.get(k, 0)
                           for k, v in port_kernels.LAUNCHES.items()
                           if v != launches0.get(k, 0)}
        rec["profile"] = (profiling.reduce(profiling.raw_events(prof))
                          if profiled and prof is not None else None)
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "")
        work = spec.load_module("work", cell.kernel).work(
            cell.config, statics, ranks=world)
        rec["least_s_per_call"], rec["bound_by"] = roofline.least_seconds(
            work, roofline.peaks(name))
    if rank != 0:
        return rec
    rec.update(compare(cell, pool, statics, sampler.items, keep))
    rec["attempted"] = calls
    return rec


def compare(cell: spec.Cell, pool: list, statics: dict, samples: list,
            keep: bool = False) -> dict:
    """The sampled calls against the plain reference, each recomputed
    from its own operands: the largest of each compared number beside
    its limit (``checks``), the calls that broke a limit (``failed``)
    and ``correct``. ``keep`` adds the operands, outputs and reference
    results (the control readings)."""
    ref = spec.load_module("reference", cell.kernel)
    limits = cell.traffic["limits"]
    checks, kept, failed = {}, [], 0
    for i, idx, got in sorted(samples, key=lambda it: it[0]):
        want = ref.reference(pool[idx], statics)
        nums = ref.compare(got, want, pool[idx], statics)
        failed += any(not _within(nums.get(k), lim)
                      for k, lim in limits.items())
        for k, v in nums.items():
            checks[k] = max(checks.get(k, v), v)
        if keep:
            kept.append({"call": i, "pool": idx, "got": got, "want": want})
        del want
    out = {"checks": {k: {"value": checks.get(k), "limit": lim}
                      for k, lim in limits.items()},
           "correct": bool(samples) and failed == 0,
           "failed": failed, "compared": len(samples)}
    if keep:
        out.update(kept=kept, pool=pool, statics=statics)
    return out
