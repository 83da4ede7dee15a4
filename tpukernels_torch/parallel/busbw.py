"""Collective bandwidth sweep of the port.

Port of ``tpukernels/parallel/busbw.py``. It times ``allreduce_sum`` (or,
with ``op="ppermute"``, ``ring_shift``) over message sizes and reports
the bandwidth by the reference's accounting:

    bus_bw = 2 * (n-1)/n * bytes / t          (allreduce, n ranks)
    bw     = bytes / t                        (ppermute, per link)

At n = 1 the allreduce moves nothing between ranks and the figure is a
degenerate copy rate, bytes / t, as in the reference, so the C driver's
check runs on one card. Each size is the best of ``reps`` calls after a
warm-up, each call synchronised: CUDA events on the card, the host clock
on the CPU.

Every point adds one to the ``scaling.busbw_points`` counter and emits a
``busbw_point`` journal event; the CLI stamps a probed
``device_inventory`` first and, on rank 0, writes the sweep's artifact
after it (``obs/scaling.write_busbw_artifact``, into
``$TPKT_SCALING_DIR`` or ``.tpkt_cache/scaling``; its path on stderr).
Stdout is the reference's line format byte for byte (the C driver greps
it); a 2-D sweep appends `` mesh=RxC``.

CLI (on the card unless ``--device=cpu``):

    python -m tpukernels_torch.parallel.busbw [--min=1KB] [--max=64MB]
        [--reps=10] [--op=allreduce|ppermute] [--mesh=RxC] [--device=cpu]

Knobs of :func:`sweep_from_env`: ``TPKT_BUSBW_MIN``/``MAX`` (sizes such
as ``1K``, ``64M``), ``TPKT_BUSBW_REPS``, ``TPKT_BUSBW_OP``.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import scaling
from tpukernels_torch.parallel.collectives import allreduce_sum, ring_shift
from tpukernels_torch.parallel.mesh import make_mesh
from tpukernels_torch.resilience import journal


def bus_bandwidth(seconds: float, nbytes: int, nranks: int) -> float:
    """GB/s by ring-allreduce algorithm-bandwidth accounting."""
    if nranks <= 1:
        return nbytes / seconds / 1e9
    return 2.0 * (nranks - 1) / nranks * nbytes / seconds / 1e9


def _seconds(fn, device) -> float:
    """Wall seconds of one synchronised ``fn()``: CUDA events on the
    card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def sweep(min_bytes: int = 1 << 10, max_bytes: int = 64 << 20,
          reps: int = 10, mesh=None, verbose: bool = True,
          op: str = "allreduce"):
    """Time a collective over message sizes, ×4 a step; returns
    ``[(bytes, seconds, GB/s)]``. ``op``: ``allreduce`` (bus-bandwidth
    accounting) or ``ppermute`` (per-link point-to-point bandwidth).
    Each rank's buffer of a size is that many bytes of float32 ones."""
    if op not in ("allreduce", "ppermute"):
        raise ValueError(f"op={op!r}: expected allreduce or ppermute")
    if mesh is None:
        mesh = make_mesh()  # joins the process group when configured
    axes = mesh.axis_names
    mesh_shape = tuple(mesh.shape[a] for a in axes) if len(axes) == 2 \
        else None
    if mesh_shape is not None and op != "allreduce":
        raise ValueError(
            f"op={op!r} has no 2-D decomposition; only allreduce "
            "sweeps 2-D meshes"
        )
    nranks = mesh.size
    coll = allreduce_sum if op == "allreduce" else ring_shift
    fake = mesh.device.type != "cuda"
    results = []
    size = min_bytes
    while size <= max_bytes:
        x = torch.ones((1, max(size // 4, 1)), dtype=torch.float32,
                       device=mesh.device)
        _seconds(lambda: coll(x, mesh), mesh.device)  # warm-up
        best = min(_seconds(lambda: coll(x, mesh), mesh.device)
                   for _ in range(reps))
        if op == "allreduce":
            bw = bus_bandwidth(best, size, nranks)
        else:
            bw = size / best / 1e9  # per-link point-to-point
        results.append((size, best, bw))
        obs_metrics.inc("scaling.busbw_points")
        extra = {"mesh_shape": list(mesh_shape)} if mesh_shape else {}
        journal.emit(
            "busbw_point", op=op, n_devices=nranks,
            size_bytes=size, seconds=round(best, 6),
            gb_s=round(bw, 4), fake=fake, **extra,
        )
        if verbose:
            line = (
                f"{op} n={nranks} size={size:>10d}B "
                f"time={best * 1e3:9.3f}ms bw={bw:8.3f} GB/s"
            )
            if mesh_shape:
                line += f" mesh={mesh_shape[0]}x{mesh_shape[1]}"
            print(line, flush=True)
        size *= 4
    return results


def sweep_from_env(mesh=None):
    """:func:`sweep` configured by ``TPKT_BUSBW_MIN``/``MAX`` (sizes),
    ``TPKT_BUSBW_REPS`` and ``TPKT_BUSBW_OP``."""
    kw = {}
    if "TPKT_BUSBW_MIN" in os.environ:
        kw["min_bytes"] = _parse_size(os.environ["TPKT_BUSBW_MIN"])
    if "TPKT_BUSBW_MAX" in os.environ:
        kw["max_bytes"] = _parse_size(os.environ["TPKT_BUSBW_MAX"])
    if "TPKT_BUSBW_REPS" in os.environ:
        kw["reps"] = int(os.environ["TPKT_BUSBW_REPS"])
    if "TPKT_BUSBW_OP" in os.environ:
        kw["op"] = os.environ["TPKT_BUSBW_OP"]
    return sweep(mesh=mesh, **kw)


def _parse_size(s: str) -> int:
    s = s.upper().rstrip("B")
    for suffix, mult in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suffix):
            return int(float(s[:-1]) * mult)
    return int(s)


def main(argv=None) -> int:
    kw, mesh_arg, device = {}, None, None
    for a in sys.argv[1:] if argv is None else argv:
        if a.startswith("--min="):
            kw["min_bytes"] = _parse_size(a[6:])
        elif a.startswith("--max="):
            kw["max_bytes"] = _parse_size(a[6:])
        elif a.startswith("--reps="):
            kw["reps"] = int(a[7:])
        elif a.startswith("--op="):
            kw["op"] = a[5:]
        elif a.startswith("--mesh="):
            r, _, c = a[7:].partition("x")
            mesh_arg = (int(r), int(c))
        elif a.startswith("--device="):
            device = a[9:]
        else:
            print(f"busbw: unknown argument {a!r}", file=sys.stderr)
            return 2
    mesh = make_mesh(mesh_arg, device=device)
    # the mesh first: the probe reads the process group it joined
    inv = scaling.emit_inventory("busbw", probe=True, device=mesh.device)
    res = sweep(mesh=mesh, **kw)
    if mesh.rank == 0:
        artifact = scaling.write_busbw_artifact(
            res, kw.get("op", "allreduce"), mesh.size, inv,
            mesh_shape=mesh_arg)
        # stderr: stdout is the line format the C driver reads
        print(f"# busbw artifact: {artifact}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
