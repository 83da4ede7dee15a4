"""The device's side of a traced run: ``torch.profiler`` over a fixed
sub-window, its events kept in memory and reduced here.

The sub-window is a run of whole calls, each inside a ``cellbench.call``
annotation; its length is from the first annotation's start to the last
one's end. From the raw events (``kineto_results.events()``, never
``key_averages``, so nothing is built per event beyond a tuple):

- ``busy_s``: the union of every device operation's interval (kernels,
  copies, sets, on every stream) within the sub-window;
- ``device_op_s``: the sum of their durations;
- ``by_name``: device time by operation name, and ``device_ops`` the
  ten names with the most;
- ``idle_gaps``: each stretch of the sub-window with no device operation,
  named by the innermost host event open at its midpoint on the calling
  thread (an ATen op, a CUDA runtime call, or the annotation itself when
  the host was in Python between them), summed by that name, ten
  largest.
"""

from __future__ import annotations

ANNOTATION = "cellbench.call"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _is_device(ev) -> bool:
    """A device operation: a kernel, copy or set on the card, not the
    device-side shadow the profiler draws of a host annotation."""
    if "CPU" in str(ev.device_type()) or ev.name() == ANNOTATION:
        return False
    kind = getattr(ev, "activity_type", None)
    return kind is None or "annotation" not in str(kind())


def raw_events(prof) -> list:
    """``(start_ns, end_ns, name, on_device, thread)`` of every event."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        host = "CPU" in str(ev.device_type())
        if not host and not _is_device(ev):
            continue
        out.append((s, s + _ns(ev, "duration"), ev.name(), not host,
                    ev.start_thread_id() if host else None))
    return out


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _top(sums: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def _host_at(host, times) -> list:
    """The innermost host event open at each of ``times`` (ascending):
    the open event that started last."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            h = host[i]
            while stack and stack[-1][1] <= h[0]:
                stack.pop()
            stack.append(h)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host outside any event")
    return out


def reduce(events) -> dict | None:
    """The sub-window's device numbers and breakdown from
    :func:`raw_events`; None where it holds no annotated call."""
    calls = [e for e in events if not e[3] and e[2] == ANNOTATION]
    if not calls:
        return None
    t0 = min(e[0] for e in calls)
    t1 = max(e[1] for e in calls)
    thread = calls[0][4]
    dev = [(max(s, t0), min(e, t1), name) for s, e, name, on_dev, _ in events
           if on_dev and e > t0 and s < t1]
    busy = _union((s, e) for s, e, _ in dev)
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    gaps, edge = [], t0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    host = [(s, e, name) for s, e, name, on_dev, th in events
            if not on_dev and th == thread and e >= t0 and s <= t1]
    names = _host_at(host, [(a + b) / 2 for a, b in gaps])
    idle: dict = {}
    for (a, b), name in zip(gaps, names):
        idle[name[:120]] = idle.get(name[:120], 0.0) + (b - a) / 1e9
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_op_s": sum(e - s for s, e, _ in dev) / 1e9,
        "device_ops_n": len(dev),
        "calls": len(calls),
        "by_name": by_name,
        "device_ops": [[k[:120], v] for k, v in _top(by_name)],
        "idle_gaps": _top(idle),
    }
