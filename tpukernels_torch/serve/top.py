"""Live dashboard of the fleet over the read-only ``stats`` op.

    python -m tpukernels_torch.serve.ctl top [--once] [--interval S]
                                             [--socket PATH]

The port's copy of ``tools/fleet_top.py`` (``serve_ctl top``). Each frame
is one ``stats`` round trip to the fleet's front socket (the router's,
``serve/router.py``) or to a lone daemon's socket (``serve/server.py``),
and one row a worker: requests a second, p50/p99 from the worker's
merged ``serve.wall_s.<kernel>`` histograms (one log-bucket geometry, so
``metrics.percentiles`` reads the merge, clamped to the exact max),
queue depth, in flight, served, bytes copied and
``last_snapshot_age_s`` (a growing age: the worker's metrics flusher
died). The router's line gives its spills, throttles and rejections.

- ``--once`` prints one frame: rc 0 when the stats plane answered, 1
  when nothing did. Its rate is served over uptime.
- Otherwise the terminal redraws every ``--interval`` seconds (default
  2) until Ctrl-C; the rate is the delta of ``served`` between frames,
  so an idle fleet shows 0.0 whatever it served before.

Read-only: it sends ``stats`` and nothing else, takes no lock and
journals nothing. Standard library and numpy; no torch.
"""

from __future__ import annotations

import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.serve import client as serve_client
from tpukernels_torch.serve import fleet as serve_fleet
from tpukernels_torch.serve import protocol as serve_protocol
from tpukernels_torch.serve.proc import pidfile_state


def target_socket(socket_path=None) -> str:
    """The front socket when a router holds its pidfile, else the lone
    daemon's socket: what ``ctl status`` reports on."""
    if socket_path:
        return socket_path
    held, _pid = pidfile_state(serve_fleet.router_pidfile_path())
    if held:
        cfg = serve_fleet.load_config() or {}
        return cfg.get("front") or serve_fleet.front_socket_path()
    return _cachedir.serve_socket_path()


def fetch(sock: str):
    """One ``stats`` reply, or None when nothing answered."""
    try:
        with serve_client.ServeClient(sock, timeout_s=5) as c:
            reply = c.stats()
    except (OSError, serve_protocol.ProtocolError):
        return None
    if not isinstance(reply, dict) or not reply.get("ok"):
        return None
    return reply


def wall_latency_ms(metrics_snap) -> tuple:
    """(count, p50_ms, p99_ms) over every ``serve.wall_s.<kernel>``
    histogram of one worker's metrics snapshot; (0, None, None) without
    one."""
    count = 0
    max_v = 0.0
    buckets: dict = {}
    for name, row in ((metrics_snap or {}).get("histograms") or {}).items():
        if not name.startswith("serve.wall_s."):
            continue
        if not isinstance(row, dict) or not row.get("count"):
            continue
        count += int(row["count"])
        max_v = max(max_v, float(row.get("max") or 0.0))
        for b, c in (row.get("buckets") or {}).items():
            buckets[b] = buckets.get(b, 0) + int(c)
    if not count:
        return 0, None, None
    p50, p99 = obs_metrics.percentiles(count, max_v, buckets, qs=(0.5, 0.99))
    return count, p50 * 1e3, p99 * 1e3


def rows(reply) -> list:
    """One row dict a worker: a router's reply gives its
    ``worker_stats`` (index-aligned with ``workers``), a lone daemon's
    one row for itself."""
    if reply.get("role") == "router":
        out = []
        meta = reply.get("workers") or []
        for i, ws in enumerate(reply.get("worker_stats") or []):
            m = meta[i] if i < len(meta) else {}
            state = ("DOWN" if ws is None
                     else "draining" if m.get("draining")
                     else "quarantined" if m.get("quarantined")
                     else m.get("state") or "up")
            out.append({"name": f"worker{i}", "state": state, "stats": ws,
                        "routed": m.get("routed")})
        return out
    return [{"name": f"daemon:{reply.get('pid')}", "state": "up",
             "stats": reply, "routed": None}]


def _fmt(v, spec="{:.1f}", none="-") -> str:
    return none if v is None else spec.format(v)


def render(reply, prev=None, dt=None, out=None) -> dict:
    """Print one frame; returns ``{worker: served}`` for the next frame's
    deltas. With ``prev`` and ``dt`` the rate is the delta a second,
    else served over uptime."""
    out = sys.stdout if out is None else out
    if reply.get("role") == "router":
        fl = reply.get("fleet") or {}
        head = (f"fleet: routed={reply.get('routed')} "
                f"spilled={reply.get('spilled')} "
                f"throttled={reply.get('throttled')} "
                f"rejected={reply.get('rejected')} "
                f"level={reply.get('level')} "
                f"workers={fl.get('answering')}/{reply.get('n_workers')} "
                f"uptime={reply.get('uptime_s')}s")
    else:
        head = (f"daemon: pid {reply.get('pid')} "
                f"uptime={reply.get('uptime_s')}s "
                f"device={reply.get('device_kind')}")
    print(head, file=out)
    print(f"{'WORKER':<12} {'STATE':<11} {'RPS':>7} {'P50MS':>8} "
          f"{'P99MS':>8} {'DEPTH':>7} {'INFL':>5} {'SERVED':>8} "
          f"{'COPIED':>9} {'SNAP_AGE':>8}", file=out)
    served_now: dict = {}
    for row in rows(reply):
        ws = row["stats"]
        if ws is None:
            print(f"{row['name']:<12} {row['state']:<11} "
                  f"{'-':>7} {'-':>8} {'-':>8} {'-':>7} {'-':>5} "
                  f"{'-':>8} {'-':>9} {'-':>8}", file=out)
            continue
        served = ws.get("served") or 0
        served_now[row["name"]] = served
        if prev is not None and dt:
            rps = max(0.0, served - prev.get(row["name"], served)) / dt
        else:
            up = ws.get("uptime_s") or 0
            rps = (served / up) if up else 0.0
        _n, p50, p99 = wall_latency_ms(ws.get("metrics"))
        depth = f"{ws.get('depth')}/{ws.get('queue_max')}"
        print(f"{row['name']:<12} {row['state']:<11} "
              f"{rps:>7.1f} {_fmt(p50, '{:.2f}'):>8} "
              f"{_fmt(p99, '{:.2f}'):>8} {depth:>7} "
              f"{ws.get('inflight'):>5} {served:>8} "
              f"{ws.get('bytes_copied'):>8}B "
              f"{_fmt(ws.get('last_snapshot_age_s'), '{:.1f}s'):>8}",
              file=out)
    return served_now


def run(once=False, interval_s=2.0, socket_path=None) -> int:
    sock = target_socket(socket_path)
    reply = fetch(sock)
    if reply is None:
        print(f"top: no stats answer on {sock} - is a daemon or fleet "
              "running?", file=sys.stderr)
        return 1
    if once:
        render(reply)
        return 0
    prev = t_prev = None
    try:
        while True:
            if reply is not None:
                sys.stdout.write("\x1b[H\x1b[2J")  # home + clear
                now = time.monotonic()
                dt = (now - t_prev) if t_prev is not None else None
                prev = render(reply, prev=prev, dt=dt)
                t_prev = now
                sys.stdout.flush()
            else:
                print(f"top: no stats answer on {sock} - retrying",
                      file=sys.stderr)
            time.sleep(interval_s)
            reply = fetch(sock)
    except KeyboardInterrupt:
        return 0
