"""Open-loop load generator: drive the serving path, judge the tail.

    python -m tpukernels_torch.loadgen --kernel sgemm --arrivals poisson \\
        --seed 7 --requests 200                   # in process, on the card
    python -m tpukernels_torch.loadgen --mix all --shapes record \\
        --rate 50 --requests 180
    python -m tpukernels_torch.loadgen --requests 200 --simulate 5   # no torch
    python -m tpukernels_torch.loadgen --requests 200 --print-schedule
    python -m tpukernels_torch.loadgen --serve default --kernel scan \\
        --requests 200                            # drive a daemon (no torch)

The port's copy of ``tools/loadgen.py``. It precomputes a deterministic
OPEN-LOOP arrival schedule from the seed alone (``--seed``, else
``TPKT_LOADGEN_SEED``, else 0; the same seed gives a byte-identical
schedule), drives it, records each request's latency as completion
minus its SCHEDULED arrival (arrivals never wait for service, so a stall
shows in every later request's latency: coordinated omission cannot
hide it) into the log-bucketed ``slo.latency_s.<kernel>`` histograms of
``obs/metrics.py``, judges them against ``obs/slo.py``'s targets and
writes the verdicts into ``slo.json``.

Arrivals (all seeded): ``poisson`` at ``--rate`` requests a second;
``bursty``, 1 s at 1.8x then 1 s at 0.2x; ``diurnal``, 0.25x..1.75x
over ``--period`` s (default 60).

Shapes: ``probe`` (default) is the integrity guard's small canary
operands (``resilience/canary.py``); ``record`` is the
``aot.BENCH_CONFIGS`` avatar shapes, filled with ones. ``--mix all``
spreads requests uniformly over the nine registry keys; ``k1=w1,k2=w2``
weights them. Anything else is a replay-spec file (``--serve`` only):
``{"entries": [{"kernel", "args": [[kind, shape], ...], "statics",
"weight"}, ...]}``, an observed shape mix materialised as ones, which
is how ``python -m tpukernels_torch.serve.optimize canary`` replays the
journal's traffic against two bucket tables at one seed; its verdicts
record under shape class ``replay``, which has no target row.

Three ways to run the schedule:

- in process (default): ``registry.dispatch`` on the card, each result
  waited for (``torch.cuda.synchronize``). Each kernel's operands are
  built and dispatched once, untimed, first: the SLO judges the warm
  path. ``--device cpu`` runs the plain versions on the CPU, for tests;
  with no card and no ``--device cpu`` the run refuses (rc 2).
- ``--simulate MS``: a virtual clock, one seeded single-server queue
  around MS; no torch. Its verdicts are persisted flagged ``simulated``
  and never gate.
- ``--serve SOCKET`` (``default``: ``TPKT_SERVE_SOCKET`` or the serve
  dir's socket): the port's daemon, or a fleet's router, over the
  socket; no torch in this process (the device kind and the torch and
  CUDA versions come from the daemon's ping, which a router relays from
  its workers). A rejection is retried
  after the daemon's ``retry_after_s`` with seeded 0.5x-1.5x jitter and
  dropped loudly (``slo.dropped.<kernel>``) after 10. ``--tenant`` and
  ``--priority interactive|batch`` ride every request (a tenant's series
  record as ``<kernel>@<tenant>``); ``--deadline-ms 250`` (or
  ``200:400``, seeded uniform) stamps each scheduled request with a
  deadline and adds a goodput column (an expired request counts under
  ``slo.expired.<kernel>``). Every request carries a seeded id,
  ``lg<seed>-<pid>-NNNNN`` (warms ``lg<seed>-<pid>-warm-<key>``), and a
  ``serve_client_request`` record; the run ends by assembling its own
  timelines from the journal (``obs/reqtrace.py``) and stamping a
  ``serve_trace_budget`` event, and a ``serve_copy_budget`` event from
  the daemon's ``bytes_copied``.

``--verify`` holds every answer bitwise against the first answer of the
same key and shapes (all operands are ones, so every answer of a key is
the same): a difference counts under ``slo.mismatched.<kernel>``, is
printed, and makes the run exit 1. The first answer's CRC-32 is
reported (``answers`` in the run's record), so a caller can hold it
against a dispatch of its own.

Besides latency, every request's lateness (when it was sent minus when
it was scheduled: the generator's own debt) is observed in
``loadgen.lateness_s`` and reported with the run. With no
``TPKT_HEALTH_JOURNAL`` the journal is a dated file beside ``slo.json``.
This process sets ``TPKT_INTEGRITY=tripwire`` unless the caller chose:
the sampled oracle canaries would put multi-ms outliers into exactly the
tail it measures.

Exit codes: 0 the run completed (a breach is the artifact's verdict);
1 with ``--check``, a non-simulated ``slo_breach`` this run, or with
``--verify`` an answer that differs from its key's first; 2 a usage
error, an unreachable daemon, or no card for an in-process run without
``--device cpu``.
"""

from __future__ import annotations

import math
import os
import random
import sys
import time

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import scaling as obs_scaling
from tpukernels_torch.obs import slo, trace
from tpukernels_torch.resilience import journal

ARRIVALS = ("poisson", "bursty", "diurnal")
DEFAULT_RATE = 20.0
LATENESS = "loadgen.lateness_s"


def default_seed() -> int:
    """``TPKT_LOADGEN_SEED`` (fail-loud parse), else 0: a schedule is
    never seeded from the clock."""
    raw = os.environ.get("TPKT_LOADGEN_SEED")
    if raw is None:
        return 0
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"TPKT_LOADGEN_SEED={raw!r}: expected an integer") from None


def _rate_at(arrivals: str, rate: float, t: float, period: float):
    if arrivals == "bursty":
        # 1 s on at 1.8x, 1 s off at 0.2x: mean ~= rate, tail rich
        return rate * (1.8 if (t % 2.0) < 1.0 else 0.2)
    if arrivals == "diurnal":
        return rate * (0.25 + 1.5 * math.sin(math.pi * t / period) ** 2)
    return rate


def build_schedule(seed: int, arrivals: str, rate: float,
                   requests: int, duration: float | None,
                   mix: dict, period: float = 60.0) -> list:
    """[(t_offset_s, kernel), ...]: the whole run, from the seed alone.
    Stops at ``requests`` arrivals or ``duration`` schedule seconds,
    whichever comes first (``requests`` 0 is unbounded, and then
    ``duration`` must bound the run)."""
    if arrivals not in ARRIVALS:
        raise ValueError(
            f"unknown arrival process {arrivals!r}; known: {ARRIVALS}")
    if requests <= 0 and not duration:
        raise ValueError(
            "loadgen: --requests 0 needs --duration to bound the run")
    rng = random.Random(seed)
    kernels = sorted(mix)
    weights = [mix[k] for k in kernels]
    out, t = [], 0.0
    while True:
        if requests > 0 and len(out) >= requests:
            break
        t += rng.expovariate(_rate_at(arrivals, rate, t, period))
        if duration and t > duration:
            break
        out.append((t, rng.choices(kernels, weights)[0]))
    return out


# ------------------------------------------------------------------ #
# operands per shape class                                           #
# ------------------------------------------------------------------ #

def operands_np(kernel: str, shape_class: str):
    """``(args, statics)`` as numpy, host scalars as 0-d float32: the
    avatar of ``aot.BENCH_CONFIGS`` filled with ones (``record``; ones
    keep every output finite for the tripwire), or the canary operands
    (``probe``)."""
    import numpy as np

    if shape_class == "record":
        from tpukernels_torch import aot

        spec = aot.BENCH_CONFIGS[kernel]
        dt = {"f32": np.float32, "i32": np.int32}
        args = tuple(dt[kind](1) if shape == () else np.ones(shape, dt[kind])
                     for kind, shape in spec["args"])
        return args, dict(spec["statics"])
    from tpukernels_torch.resilience import canary

    args = tuple(np.float32(a) if isinstance(a, float)
                 else np.int32(a) if isinstance(a, int) else a
                 for a in canary.build_args(kernel))
    return args, dict(canary.CANARY_CONFIGS[kernel]["statics"])


def _leaves(out):
    return out if isinstance(out, tuple) else (out,)


def answer_crc(leaves) -> str:
    """CRC-32 of an answer's numpy leaves' bytes, in order, as hex."""
    import zlib

    import numpy as np

    crc = 0
    for a in leaves:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return f"{crc:08x}"


class Answers:
    """``--verify``: the first answer of each key and shapes, and every
    later one held bitwise against it (``same`` compares two answers'
    leaves)."""

    def __init__(self, same, to_numpy):
        self.same, self.to_numpy = same, to_numpy
        self.first: dict = {}
        self.crc: dict = {}

    def check(self, key, series, out) -> bool:
        leaves = _leaves(out)
        want = self.first.get(key)
        if want is None:
            self.first[key] = leaves
            self.crc[key] = answer_crc(self.to_numpy(leaves))
            return True
        if len(leaves) == len(want) and all(
                self.same(a, b) for a, b in zip(leaves, want)):
            return True
        obs_metrics.inc(f"slo.mismatched.{series}")
        print(f"# {series} answer differs from the first answer of {key}",
              file=sys.stderr)
        return False


def _observe(series: str, t: float, t0: float, s0: float, s1: float):
    """One completed request: latency from its scheduled arrival,
    service from its send, and the generator's lateness in sending."""
    obs_metrics.inc(f"slo.requests.{series}")
    obs_metrics.observe(f"slo.latency_s.{series}", (s1 - t0) - t)
    obs_metrics.observe(f"slo.service_s.{series}", s1 - s0)


def _sleep_until(t0: float, t: float) -> float:
    """Sleep until the scheduled arrival ``t`` (never past it); returns
    the send time after observing its lateness."""
    now = time.perf_counter() - t0
    if t > now:
        time.sleep(t - now)
    s0 = time.perf_counter()
    obs_metrics.observe(LATENESS, max(0.0, (s0 - t0) - t))
    return s0


# ------------------------------------------------------------------ #
# execution                                                          #
# ------------------------------------------------------------------ #

def run_simulated(schedule, seed: int, service_ms: float) -> None:
    """A virtual clock: one single-server queue, service times from a
    second seeded stream around ``service_ms``; latency = completion -
    scheduled arrival, the real path's arithmetic, so two runs with one
    seed give the same histogram buckets."""
    rng = random.Random(seed ^ 0x510510)
    free_at = 0.0
    for t, kernel in schedule:
        service = service_ms / 1000.0 * (0.5 + rng.random())
        start = max(t, free_at)
        free_at = start + service
        obs_metrics.inc(f"slo.requests.{kernel}")
        obs_metrics.observe(f"slo.latency_s.{kernel}", free_at - t)
        obs_metrics.observe(f"slo.service_s.{kernel}", service)


def run_real(schedule, shape_class: str, echo, device,
             verify: bool = False):
    """``registry.dispatch`` through the schedule, open loop, on
    ``device``: sleep until each request's arrival (never past it: when
    service falls behind, later requests run back to back and their
    latency includes the wait), dispatch, wait for the device. Each
    kernel's operands are built once and dispatched once, untimed.
    Returns the :class:`Answers` of ``verify``, or None."""
    import torch

    from tpukernels_torch import interop, registry

    answers = Answers(torch.equal, lambda leaves: [
        interop.from_port(t) for t in leaves]) if verify else None

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prepared = {}
    for kernel in sorted({k for _t, k in schedule}):
        args, statics = operands_np(kernel, shape_class)
        prepared[kernel] = (interop.to_port(kernel, args, device), statics)
        targs, statics = prepared[kernel]
        w0 = time.perf_counter()
        out = registry.dispatch(kernel, *targs, **statics)
        wait()
        echo(f"# warmed {kernel} in {time.perf_counter() - w0:.3f}s")
        if answers is not None:
            answers.check(kernel, kernel, out)
    t0 = time.perf_counter()
    for t, kernel in schedule:
        s0 = _sleep_until(t0, t)
        targs, statics = prepared[kernel]
        out = registry.dispatch(kernel, *targs, **statics)
        wait()
        _observe(kernel, t, t0, s0, time.perf_counter())
        if answers is not None:
            answers.check(kernel, kernel, out)
    return answers


def _replay_operands(entry):
    """One replay-spec entry's operands: ones at the observed shapes,
    host scalars as 0-d float32."""
    import numpy as np

    dt = {"f32": np.float32, "i32": np.int32}
    args = tuple(
        dt[kind](1) if not shape
        else np.ones([int(d) for d in shape], dt[kind])
        for kind, shape in (tuple(a) for a in entry["args"])
    )
    return args, dict(entry.get("statics") or {})


def load_replay(path):
    """A replay-spec file, checked: ``(entries_by_id, mix)``, the mix
    over synthetic entry ids (``e000``...), since the schedule draws over
    entries while dispatch and metrics use each entry's kernel."""
    import json

    with open(path) as f:
        spec = json.load(f)
    entries = spec.get("entries") if isinstance(spec, dict) else None
    if not isinstance(entries, list) or not entries:
        raise ValueError('want {"entries": [...]} with at least one entry')
    replay, mix = {}, {}
    for i, ent in enumerate(entries):
        if not isinstance(ent, dict) or not isinstance(ent.get("kernel"),
                                                       str):
            raise ValueError(f"entry {i}: needs a kernel name")
        args = ent.get("args")
        if not isinstance(args, list) or not args:
            raise ValueError(f"entry {i}: needs args [[kind, [dims]], ...]")
        for a in args:
            if (not isinstance(a, (list, tuple)) or len(a) != 2
                    or a[0] not in ("f32", "i32")
                    or not isinstance(a[1], (list, tuple))):
                raise ValueError(f"entry {i}: bad arg {a!r} (want "
                                 '["f32"|"i32", [dims]])')
        w = float(ent.get("weight", 1.0))
        if w <= 0:
            raise ValueError(f"entry {i}: weight must be > 0")
        eid = f"e{i:03d}"
        replay[eid] = ent
        mix[eid] = w
    return replay, mix


def _journal_tail(path, offset):
    """The events a journal gained past byte ``offset``."""
    import json

    events = []
    try:
        with open(path) as f:
            f.seek(offset)
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    events.append(rec)
    except OSError:
        return []
    return events


def run_serve(schedule, shape_class: str, socket_path: str, echo,
              seed: int = 0, tenant=None, priority=None, replay=None,
              deadline=None, verify: bool = False):
    """The daemon (or a router) through the schedule, open loop: the
    :func:`run_real` arithmetic with the daemon in place of
    ``registry.dispatch``, so its queueing, batching, padding and
    backpressure all count. One untimed dispatch a (kernel, shapes)
    warms the daemon first. ``replay`` is a :func:`load_replay` map
    (the schedule's keys are then entry ids; two entries of one kernel
    merge into one histogram). ``deadline`` is a ``(lo_ms, hi_ms)``
    range sampled per scheduled request from its own seeded stream; a
    request meets it when it completed ok within it, measured from its
    send. Returns ``(ping stats, {series: [met, total]}, the
    :class:`Answers` of ``verify`` or None)``."""
    import numpy as np

    from tpukernels_torch.serve import client as serve_client
    from tpukernels_torch.serve import protocol as serve_protocol

    answers = Answers(
        lambda a, b: a.dtype == b.dtype and np.array_equal(a, b),
        list) if verify else None

    jitter = random.Random(seed ^ 0x7E57ED)
    dl_rng = random.Random(seed ^ 0xDEAD11)
    goodput: dict = {}

    def _mk(kernel):
        return f"{kernel}@{tenant}" if tenant else kernel

    # seeded client-minted ids; the pid scopes the run, so two runs of
    # one seed appending to one journal never merge timelines
    used_ids: list = []

    def _rid(tag) -> str:
        rid = f"lg{seed}-{os.getpid()}-{tag}"
        used_ids.append(rid)
        return rid

    def dispatch_patiently(cli, kernel, args, statics, rid, warm=False,
                           deadline_ms=None):
        """One request through the shared backpressure policy; its
        answer, or None. Ten rejections, a daemon-reported error or
        transport trouble drop it loudly (stderr and a counter), never
        the rest of the run. Every request journals a
        ``serve_client_request`` record, the client-observed wall its
        timeline is anchored to."""
        cli.next_request_id = rid
        cli.next_deadline_ms = deadline_ms
        c0 = time.perf_counter()
        ok, err, out = True, None, None
        try:
            out = serve_client.dispatch_with_backpressure(
                cli, kernel, args, statics, jitter=jitter)
        except serve_client.ServeExpired as e:
            ok, err = False, "expired"
            obs_metrics.inc(f"slo.expired.{_mk(kernel)}")
            print(f"# {kernel} request missed its deadline: {e}",
                  file=sys.stderr)
        except serve_client.ServeRejected:
            ok, err = False, "rejected"
            obs_metrics.inc(f"slo.dropped.{_mk(kernel)}")
            print(f"# dropped {kernel} request after 10 rejection(s)",
                  file=sys.stderr)
        except serve_client.ServeError as e:
            ok, err = False, f"daemon error: {e}"
            obs_metrics.inc(f"slo.dropped.{_mk(kernel)}")
            print(f"# dropped {kernel} request: daemon error {e}",
                  file=sys.stderr)
        except (OSError, serve_protocol.ProtocolError) as e:
            ok, err = False, f"transport: {e!r}"
            obs_metrics.inc(f"slo.dropped.{_mk(kernel)}")
            print(f"# dropped {kernel} request: transport trouble {e!r}",
                  file=sys.stderr)
        journal.emit(
            "serve_client_request", request_id=rid, kernel=kernel,
            tenant=tenant, warm=warm,
            wall_s=round(time.perf_counter() - c0, 6),
            ok=ok, error=err, deadline_ms=deadline_ms,
        )
        return out if ok else None

    cli = serve_client.ServeClient(socket_path, tenant=tenant,
                                   priority=priority)
    # only the journal bytes this run appends are assembled
    trace_jp = journal.path()
    trace_jp_off = 0
    if trace_jp is not None:
        try:
            trace_jp_off = os.path.getsize(trace_jp)
        except OSError:
            trace_jp_off = 0
    stats = cli.ping()  # a dead socket aborts here
    bytes_before = stats.get("bytes_copied")
    prepared = {}
    for key in sorted({k for _t, k in schedule}):
        if replay is not None:
            kname = replay[key]["kernel"]
            args, statics = _replay_operands(replay[key])
        else:
            kname = key
            args, statics = operands_np(key, shape_class)
        prepared[key] = (kname, args, statics)
        w0 = time.perf_counter()
        warmed = dispatch_patiently(cli, kname, args, statics,
                                    _rid(f"warm-{key}"), warm=True)
        echo(f"# warmed {kname} in {time.perf_counter() - w0:.3f}s"
             " (served)" + ("" if warmed is not None else " DROPPED"))
        if answers is not None and warmed is not None:
            answers.check(key, _mk(kname), warmed)
    t0 = time.perf_counter()
    for i, (t, key) in enumerate(schedule):
        kname, args, statics = prepared[key]
        dl = None
        if deadline is not None:
            dl = dl_rng.uniform(deadline[0], deadline[1])
            goodput.setdefault(_mk(kname), [0, 0])[1] += 1
        s0 = _sleep_until(t0, t)
        out = dispatch_patiently(cli, kname, args, statics,
                                 _rid(f"{i:05d}"), deadline_ms=dl)
        if out is not None:
            s1 = time.perf_counter()
            _observe(_mk(kname), t, t0, s0, s1)
            if dl is not None and (s1 - s0) * 1000.0 <= dl:
                goodput[_mk(kname)][0] += 1
            if answers is not None:
                answers.check(key, _mk(kname), out)
    # ping again: the daemon resolves its device lazily; a daemon that
    # died at the very end keeps the first answer
    try:
        stats = cli.ping()
    except (OSError, serve_protocol.ProtocolError):
        pass
    # copy budget: the daemon's bytes_copied over this run, per request
    bytes_after = stats.get("bytes_copied")
    if (isinstance(bytes_before, (int, float))
            and isinstance(bytes_after, (int, float))):
        n_req = len(schedule) + len(prepared)
        delta = max(0, bytes_after - bytes_before)
        lanes = stats.get("lanes") or ["inline"]
        shm_used = cli.staged_payloads > 0
        journal.emit(
            "serve_copy_budget", socket=socket_path,
            lane="shm" if shm_used else "inline", lanes=lanes,
            requests=n_req, daemon_bytes_copied=delta,
            bytes_per_request=round(delta / max(1, n_req), 3),
            client_bytes_copied=cli.bytes_copied,
            staged_payloads=cli.staged_payloads,
            inline_payloads=cli.inline_payloads,
            expected_zero=bool("shm" in lanes and shm_used
                               and cli.inline_payloads == 0
                               and stats.get("shm_min_bytes") == 0),
        )
    # trace budget over this run's own ids, from the journal tail it
    # appended (a daemon journaling elsewhere assembles client-only
    # timelines: traced 0)
    if trace_jp is not None:
        from tpukernels_torch.obs import reqtrace

        budget = reqtrace.run_budget(_journal_tail(trace_jp, trace_jp_off),
                                     request_ids=used_ids)
        if budget is not None:
            journal.emit("serve_trace_budget", socket=socket_path,
                         server_traced=bool(stats.get("request_trace")),
                         **budget)
    cli.close()
    return stats, goodput, answers


def _parse_deadline_ms(spec: str) -> tuple:
    """``250`` -> (250, 250); ``200:400`` -> (200, 400)."""
    if ":" in spec:
        lo_raw, hi_raw = spec.split(":", 1)
        lo, hi = float(lo_raw), float(hi_raw)
    else:
        lo = hi = float(spec)
    if lo <= 0 or hi < lo:
        raise ValueError(
            f"{spec!r}: want MS > 0 or LO:HI with 0 < LO <= HI")
    return lo, hi


def _parse_mix(raw: str | None, kernel: str | None) -> dict:
    from tpukernels_torch import aot

    known = sorted(aot.BENCH_CONFIGS)
    if kernel is not None:
        if kernel not in known:
            raise ValueError(f"unknown kernel {kernel!r}; known: {known}")
        return {kernel: 1.0}
    if raw in (None, "all"):
        return {k: 1.0 for k in known}
    mix = {}
    for part in raw.split(","):
        name, _, w = part.partition("=")
        name = name.strip()
        if name not in known:
            raise ValueError(
                f"unknown kernel {name!r} in --mix; known: {known}")
        mix[name] = float(w) if w else 1.0
    return mix


def _hist_summary(name: str):
    row = obs_metrics.snapshot()["histograms"].get(name)
    if not row:
        return None
    return {k: row[k] for k in ("count", "p50", "p99", "max")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    kernel = mix_raw = device = None
    arrivals, rate, requests = "poisson", DEFAULT_RATE, 200
    duration = simulate_ms = serve_sock = None
    tenant = priority = deadline = None
    seed = None
    shape_class, period = "probe", 60.0
    print_schedule = check = verify = False
    it = iter(argv)
    try:
        for a in it:
            if a == "--kernel":
                kernel = next(it)
            elif a == "--serve":
                serve_sock = next(it)
            elif a == "--device":
                device = next(it)
            elif a == "--tenant":
                tenant = next(it)
            elif a == "--priority":
                priority = next(it)
            elif a == "--deadline-ms":
                deadline = _parse_deadline_ms(next(it))
            elif a == "--mix":
                mix_raw = next(it)
            elif a == "--arrivals":
                arrivals = next(it)
            elif a == "--rate":
                rate = float(next(it))
            elif a == "--requests":
                requests = int(next(it))
            elif a == "--duration":
                duration = float(next(it))
            elif a == "--period":
                period = float(next(it))
            elif a == "--seed":
                seed = int(next(it))
            elif a == "--shapes":
                shape_class = next(it)
            elif a == "--simulate":
                simulate_ms = float(next(it))
            elif a == "--print-schedule":
                print_schedule = True
            elif a == "--check":
                check = True
            elif a == "--verify":
                verify = True
            else:
                print(__doc__, file=sys.stderr)
                print(f"loadgen: unknown argument {a!r}", file=sys.stderr)
                return 2
    except StopIteration:
        print(f"loadgen: {a} requires a value", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"loadgen: bad value for {a}: {e}", file=sys.stderr)
        return 2
    replay = None
    if shape_class not in ("probe", "record"):
        if serve_sock is None:
            print("loadgen: a --shapes replay spec requires --serve (it "
                  "replays observed traffic against a daemon's bucket "
                  "table)", file=sys.stderr)
            return 2
        if kernel is not None or mix_raw is not None:
            print("loadgen: --kernel/--mix don't combine with a replay "
                  "spec (the file IS the mix)", file=sys.stderr)
            return 2
        try:
            replay, replay_mix = load_replay(shape_class)
        except (OSError, ValueError) as e:
            print(f"loadgen: --shapes {shape_class!r}: {e} (known classes: "
                  "probe, record; anything else must be a readable "
                  "replay-spec file)", file=sys.stderr)
            return 2
        shape_class = "replay"
    if rate <= 0:
        print("loadgen: --rate must be > 0", file=sys.stderr)
        return 2
    if period <= 0:
        print("loadgen: --period must be > 0", file=sys.stderr)
        return 2
    if serve_sock is not None and simulate_ms is not None:
        print("loadgen: --serve and --simulate are exclusive (the virtual "
              "clock has no daemon)", file=sys.stderr)
        return 2
    if device is not None and (serve_sock is not None
                               or simulate_ms is not None):
        print("loadgen: --device applies to in-process runs only (a "
              "daemon has its own device)", file=sys.stderr)
        return 2
    if device not in (None, "cuda", "cpu"):
        print(f"loadgen: --device {device!r} (known: cuda, cpu)",
              file=sys.stderr)
        return 2
    if (tenant or priority) and serve_sock is None:
        print("loadgen: --tenant/--priority only apply to --serve runs "
              "(the router's admission point reads them)", file=sys.stderr)
        return 2
    if deadline is not None and serve_sock is None:
        print("loadgen: --deadline-ms only applies to --serve runs (the "
              "dispatch header carries the budget)", file=sys.stderr)
        return 2
    if tenant is not None and ("@" in tenant or "|" in tenant
                               or not tenant):
        print(f"loadgen: bad --tenant {tenant!r} (non-empty, no '@' or "
              "'|' - it joins metric and slo.json keys)", file=sys.stderr)
        return 2
    if priority is not None and priority not in ("interactive", "batch"):
        print(f"loadgen: --priority {priority!r} (known: interactive, "
              "batch)", file=sys.stderr)
        return 2
    if serve_sock == "default":
        from tpukernels_torch.serve import client as _serve_client

        serve_sock = _serve_client.default_socket_path()
    try:
        if seed is None:
            seed = default_seed()
        mix = (replay_mix if replay is not None
               else _parse_mix(mix_raw, kernel))
        schedule = build_schedule(seed, arrivals, rate, requests, duration,
                                  mix, period)
    except ValueError as e:
        print(f"loadgen: {e}", file=sys.stderr)
        return 2

    if print_schedule:
        # the byte-identical determinism surface: no clock, no dispatch
        for t, k in schedule:
            print(f"{t:.6f} {k}")
        return 0

    in_process = serve_sock is None and simulate_ms is None
    if in_process:
        from tpukernels_torch.utils import pick_device

        try:
            device = pick_device(device)
        except RuntimeError as e:
            print(f"loadgen: {e}", file=sys.stderr)
            return 2

    if os.environ.get("TPKT_HEALTH_JOURNAL") is None:
        d = os.path.dirname(slo.path())
        os.makedirs(d, exist_ok=True)
        os.environ["TPKT_HEALTH_JOURNAL"] = d
    # sampled oracle canaries are multi-ms outliers in exactly the tail
    # this tool measures; the always-on tripwire stays
    os.environ.setdefault("TPKT_INTEGRITY", "tripwire")
    obs_scaling.emit_inventory("loadgen")

    echo = print
    serve_stats = answers = None
    goodput: dict = {}
    t_run0 = time.perf_counter()
    with trace.span("loadgen/run", arrivals=arrivals, seed=seed):
        if simulate_ms is not None:
            run_simulated(schedule, seed, simulate_ms)
            kind, versions = "cpu", None
        elif serve_sock is not None:
            from tpukernels_torch.serve import protocol as serve_protocol

            try:
                serve_stats, goodput, answers = run_serve(
                    schedule, shape_class, serve_sock, echo, seed=seed,
                    tenant=tenant, priority=priority, replay=replay,
                    deadline=deadline, verify=verify)
            except (OSError, serve_protocol.ProtocolError) as e:
                print(f"loadgen: serve daemon at {serve_sock} unreachable: "
                      f"{e}", file=sys.stderr)
                return 2
            # judged against the daemon's device, not this client's
            kind = serve_stats.get("device_kind") or "cpu"
            versions = (serve_stats.get("torch"), serve_stats.get("cuda"))
        else:
            from tpukernels_torch.tuning import cache as tcache

            answers = run_real(schedule, shape_class, echo, device,
                               verify=verify)
            kind = tcache.device_kind(device)
            versions = tcache.installed_versions()
    wall = time.perf_counter() - t_run0

    per_kernel = slo.histograms_by_kernel(
        obs_metrics.snapshot()["histograms"])
    verdicts = slo.judge(per_kernel, kind, shape_class,
                         simulated=simulate_ms is not None,
                         goodput=goodput or None)
    run_info = {
        "arrivals": arrivals, "seed": seed, "rate": rate,
        "requests": len(schedule), "duration": duration,
        "wall_s": round(wall, 3),
        "served": serve_sock is not None,
        "dropped": {k[len("slo.dropped."):]: int(v) for k, v in
                    sorted(obs_metrics.counters("slo.dropped.").items())},
        "lateness_s": _hist_summary(LATENESS),
    }
    if answers is not None:
        run_info["answers"] = dict(sorted(answers.crc.items()))
        run_info["mismatched"] = {
            k[len("slo.mismatched."):]: int(v) for k, v in sorted(
                obs_metrics.counters("slo.mismatched.").items())}
    if tenant:
        run_info["tenant"] = tenant
        run_info["priority"] = priority or "interactive"
    if deadline is not None:
        run_info["deadline_ms"] = list(deadline)
        run_info["goodput"] = {k: list(v) for k, v in goodput.items()}
    artifact = slo.record(verdicts, run_info, versions=versions)
    journal.emit(
        "slo_probe", **run_info, device_kind=kind, shape_class=shape_class,
        simulated=simulate_ms is not None, artifact=artifact,
        verdicts={
            k: {"verdict": v["verdict"], "count": v["count"],
                "p50_s": v["p50_s"], "p99_s": v["p99_s"],
                "target_p99_s": v["target_p99_s"]}
            for k, v in verdicts.items()
        },
    )

    # the goodput column exists only on deadline-carrying runs
    gp_col = deadline is not None
    hdr = (f"{'kernel':<16} {'n':>5} {'p50_ms':>9} {'p95_ms':>9} "
           f"{'p99_ms':>9} {'max_ms':>9} {'target':>9} "
           + (f"{'goodput':>8} " if gp_col else "")
           + " verdict")
    print(hdr)
    print("-" * len(hdr))

    def _ms(v):
        return slo.fmt_ms(v, 9)

    def _gp(v):
        frac = v.get("goodput_frac")
        if frac is None:
            return f"{'-':>8} "
        return f"{frac:>8.1%} "

    breached = []
    for k, v in verdicts.items():
        print(f"{k:<16} {v['count']:>5} {_ms(v['p50_s'])} "
              f"{_ms(v['p95_s'])} {_ms(v['p99_s'])} {_ms(v['max_s'])} "
              f"{_ms(v['target_p99_s'])} "
              + (_gp(v) if gp_col else "")
              + f" {v['verdict']}"
              + (f" ({v['why']})" if v.get("why") else ""))
        if v["verdict"] == "slo_breach" and not v["simulated"]:
            breached.append(k)
    late = run_info["lateness_s"]
    if late:
        print(f"loadgen: generator lateness p50 {slo.fmt_ms(late['p50'])}, "
              f"p99 {slo.fmt_ms(late['p99'])}, max "
              f"{slo.fmt_ms(late['max'])} over {late['count']} request(s)")
    met = sum(v[0] for v in goodput.values())
    total = sum(v[1] for v in goodput.values())
    dropped = sum(run_info["dropped"].values())
    mismatched = sum((run_info.get("mismatched") or {}).values())
    print(
        f"loadgen: {len(schedule)} request(s), {arrivals} arrivals, "
        f"seed {seed}, {shape_class} shapes on {kind}"
        + (" (SIMULATED)" if simulate_ms is not None else "")
        + (" (SERVED)" if serve_sock is not None else "")
        + (f", goodput {met}/{total}"
           + (f" ({met / total:.1%})" if total else "")
           if gp_col else "")
        + f", dropped {dropped}"
        + (f", {mismatched} answer(s) differ" if verify else "")
        + f", wall {wall:.1f}s -> {os.path.relpath(artifact)}"
        + (f"; BREACH: {','.join(breached)}" if breached else "")
    )
    return 1 if (check and breached) or mismatched else 0


if __name__ == "__main__":
    sys.exit(main())
