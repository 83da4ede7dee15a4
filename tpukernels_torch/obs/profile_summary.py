"""Summarize a ``torch.profiler`` Chrome trace into per-plane busy % and
the top ops by time: the profiler evidence behind the port's roofline
claims in PERF.md.

Usage:
    python -m tpukernels_torch.obs.profile_summary TRACE_DIR|TRACE.json \\
        [--top=10]

The port's copy of ``tools/profile_summary.py``. The reference reads
XProf planes; the port reads the Chrome trace ``torch.profiler`` writes
(``export_chrome_trace``, as ``capi._profiled`` and
``python -m tpukernels_torch.profile`` do): the newest ``*.json`` under
the directory, or the file given. Its events become planes of lines:

- a device plane ``/device:CUDA:<n>`` for each card, of the ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events, one line a stream;
- the host plane ``/host:CPU``, of the ``cpu_op`` and ``cuda_runtime``
  events, one line a thread.

"busy %" is the reference's: the union of a line's event intervals over
the plane's observed span, for the busiest line (on a device plane, the
share of the window a stream kept the card busy). The ops of a plane are
ranked by the sum of their events' durations, as the reference ranks
them; a kernel never nests in another on a stream, so on a device plane
that is each kernel's own time.

Exit codes: 0 summarized; 1 the trace was taken with a card (its
``deviceProperties`` name one, or it holds CUDA runtime calls) and holds
no device event, which is a failed capture and never a busy % of 0; 2
usage, or no trace found.
"""

from __future__ import annotations

import decimal
import glob
import json
import os
import re
import sys
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
HOST_PLANE = "/host:CPU"
_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)"
    r"\s*)?(\w+)\s*\(")


@dataclass
class Plane:
    """One plane of a trace: its lines' events as ``(start_ps, end_ps,
    name)``, keyed by line (a stream on a device, a thread on the host)."""
    name: str
    lines: dict = field(default_factory=dict)


def find_trace(path: str) -> str:
    """``path`` itself when it is a file, else the newest ``*.json`` under
    it."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *.json trace under {path}")
    return hits[-1]


def load_trace(path: str) -> dict:
    """The trace as JSON, its numbers exact: Chrome trace timestamps are
    microseconds since an epoch with three decimals, past what a float
    keeps."""
    with open(path) as f:
        return json.load(f, parse_float=decimal.Decimal)


def _ps(us) -> int:
    return int(decimal.Decimal(us) * 1_000_000)


def planes(trace: dict) -> list:
    """The trace's device planes (by card index), then its host plane;
    a plane with no events is left out."""
    device: dict = {}
    host = Plane(HOST_PLANE)
    for ev in trace.get("traceEvents", []):
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat not in DEVICE_CATS + HOST_CATS:
            continue
        s = _ps(ev["ts"])
        item = (s, s + _ps(ev.get("dur", 0)), ev.get("name", "?"))
        if cat in DEVICE_CATS:
            plane = device.setdefault(
                ev.get("pid"), Plane(f"/device:CUDA:{ev.get('pid')}"))
            plane.lines.setdefault(ev.get("tid"), []).append(item)
        else:
            host.lines.setdefault((ev.get("pid"), ev.get("tid")),
                                  []).append(item)
    out = [device[k] for k in sorted(device, key=str)]
    return out + ([host] if host.lines else [])


def card_profiled(trace: dict) -> bool:
    """Whether the trace was taken with a card: its ``deviceProperties``
    list one, or the process made CUDA runtime calls in the window."""
    return bool(trace.get("deviceProperties")) or any(
        ev.get("cat") == "cuda_runtime" for ev in trace.get("traceEvents", []))


def union_busy_ps(intervals) -> int:
    """Total covered picoseconds of [start, end) intervals (events on
    one line can nest, host ops contain ops, so a plain sum
    double-counts)."""
    busy = 0
    last_end = None
    for s, e in sorted(intervals):
        if last_end is None or s >= last_end:
            busy += e - s
            last_end = e
        elif e > last_end:
            busy += e - last_end
            last_end = e
    return busy


def summarize_plane(plane: Plane) -> dict:
    op_ps: dict = {}
    busy = []
    t_min, t_max = None, 0
    for events in plane.lines.values():
        line_iv = []
        for s, e, name in events:
            line_iv.append((s, e))
            op_ps[name] = op_ps.get(name, 0) + (e - s)
            t_min = s if t_min is None else min(t_min, s)
            t_max = max(t_max, e)
        # busy union per line (parallel lines measure different streams
        # or threads; merging them would understate concurrency)
        busy.append(union_busy_ps(line_iv))
    span_ps = (t_max - t_min) if t_min is not None else 0
    return {
        "name": plane.name,
        "span_ms": span_ps / 1e9,
        "busiest_line_ms": max(busy) / 1e9 if busy else 0.0,
        "busy_pct": 100.0 * max(busy) / span_ps if span_ps else 0.0,
        "ops": op_ps,
    }


def top_ops(summary: dict, top: int) -> list:
    """``[(name, ms), ...]``: the plane's ``top`` ops by time, largest
    first."""
    ranked = sorted(summary["ops"].items(), key=lambda kv: (-kv[1], kv[0]))
    return [(name, ps / 1e9) for name, ps in ranked[:top]]


def is_device(summary: dict) -> bool:
    return summary["name"].startswith("/device:")


def summarize(path: str) -> tuple:
    """``(trace path, [plane summaries], card profiled)`` for a trace
    file or directory."""
    path = find_trace(path)
    trace = load_trace(path)
    return path, [summarize_plane(p) for p in planes(trace)], \
        card_profiled(trace)


def function_name(kernel: str) -> str:
    """A demangled kernel name's function, without its namespaces, its
    template arguments and its parameters (``void
    tpkt_gemm::(anonymous namespace)::sgemm_ring_kernel<0, 128>(...)`` ->
    ``sgemm_ring_kernel``)."""
    s = kernel.replace("(anonymous namespace)", "anon")
    if s.startswith("void "):
        s = s[5:]
    out, depth = [], 0
    for c in s:
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(c)
    return "".join(out).strip().split("::")[-1]


def port_kernels(csrc: str = _CSRC) -> dict:
    """``{function: source}``: every ``__global__`` function of the port's
    CUDA sources, read from them, so a new kernel is known without a
    table to keep."""
    found = {}
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))
                       + glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path) as f:
            for name in _GLOBAL_RE.findall(f.read()):
                found[name] = f"tpukernels_torch/csrc/{os.path.basename(path)}"
    return found


def kernel_source(kernel: str, known: dict | None = None):
    """The port's source file of a trace's kernel, or None when the
    kernel is not one of the port's own (a PyTorch or library kernel)."""
    known = port_kernels() if known is None else known
    return known.get(function_name(kernel))


def render(summaries, card: bool, top: int) -> tuple:
    """``(rc, lines)``: the summary's output lines, plane by plane, and its
    exit code."""
    lines = []
    for s in summaries:
        lines.append(f"plane {s['name']!r}: span={s['span_ms']:.3f}ms "
                     f"busiest-line busy={s['busiest_line_ms']:.3f}ms "
                     f"({s['busy_pct']:.1f}%)")
        ranked = top_ops(s, top)
        width = max((len(n) for n, _ in ranked), default=0)
        lines += [f"    {name:<{width}}  {ms:10.3f} ms" for name, ms in ranked]
    if any(is_device(s) for s in summaries):
        return 0, lines
    if card:
        return 1, lines + ["# ERROR: the trace was taken with a card and "
                           "holds no device event (no kernel reached the "
                           "card's timeline)"]
    return 0, lines + ["# WARNING: no device plane found - host-only trace "
                       "(was the kernel actually dispatched to a card?)"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    top = 10
    args = []
    for a in argv:
        if a.startswith("--top="):
            try:
                top = int(a[6:])
            except ValueError:
                print(__doc__, file=sys.stderr)
                return 2
        else:
            args.append(a)
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        path, summaries, card = summarize(args[0])
    except (OSError, ValueError) as e:
        print(f"profile_summary: {e}", file=sys.stderr)
        return 2
    rc, lines = render(summaries, card, top)
    print("\n".join([f"# trace: {path}", *lines]))
    return rc


if __name__ == "__main__":
    sys.exit(main())
