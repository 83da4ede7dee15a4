"""How much of the distributed kernels' communication hides under compute.

Port of ``tpukernels/parallel/overlap.py``. ``TPKT_DIST_DEPTH`` >= 2
issues the next hop's exchange before this hop's sweep or force block
(``collectives.py``), so the bytes could move while the kernel runs.
This module measures whether they do. For each op it times three
programs on the group, each the best of ``reps`` after a warm-up:

- ``comm``    — the op's wire alone: for ``stencil2d`` the k-deep halo
                exchanges of ``collectives._halos``, one a round, each
                round's halos written into the block the next round
                sends from; for ``nbody_ring`` the ring rotation of the
                (4, N/P) j-block, ``steps × (P − 1)`` hops, chained;
- ``compute`` — the arithmetic alone, no collective: ``iters / k``
                rounds of k sweeps of the ``jacobi2d`` wrapper on the
                rank's block; ``steps × P`` force blocks of
                ``forces_ij`` (``tpkt_nbody_forces_ij``) on its bodies;
- ``full``    — the real ``jacobi2d_dist`` / ``nbody_dist_ring`` at the
                depth asked for; its output is held bitwise against the
                synchronous call (depth 1), as the layer promises at
                every depth.

If the wire truly hides, ``t_full < t_comm + t_compute``; the figure is

    overlap_frac = clamp01((t_comm + t_compute - t_full)
                           / min(t_comm, t_compute))

the share of the cheaper phase that the full program hid. A time is the
group's: a barrier before each rep, the device synchronised at its end,
the slowest rank's seconds (an all-reduce MAX), then the best rep.

Each op runs in an ``overlap/<op>`` span with ``comm/<op>`` and
``compute/<op>`` children (``obs/trace.py``); rank 0 adds one to the
``scaling.overlap_points`` counter and emits one ``overlap_point``
journal event a point. The CLI writes the probe's artifact on rank 0
(``obs/scaling.write_overlap_artifact``), whose non-gating verdict is
``overlap_low`` under ``TPKT_OVERLAP_MIN_FRAC``; ranks that share a
card write a fake one (``shared-card``), which is never judged.

CLI (on the card unless ``--device cpu``; a group from the
``TPKT_COORDINATOR_*`` env, as ``mesh.py`` says, else one rank):

    python -m tpukernels_torch.parallel.overlap [--ops=nbody_ring,stencil2d]
        [--reps=5] [--quick] [--depth=D] [--device cpu]
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import scaling, trace
from tpukernels_torch.parallel import collectives as C
from tpukernels_torch.parallel.mesh import P, host_to_global, make_mesh
from tpukernels_torch.resilience import journal

DEFAULT_OPS = ("nbody_ring", "stencil2d")

# per-rank work: (default, --quick), the reference's sizes
_WORK = {
    "nbody_bodies": (4096, 256),   # per rank
    "nbody_steps": (2, 1),
    "stencil_rows": (1024, 64),    # per rank
    "stencil_cols": (2048, 256),
    "stencil_iters": (16, 8),
    "stencil_k": (4, 4),
}


def _work(name: str, quick: bool) -> int:
    return _WORK[name][1 if quick else 0]


@contextlib.contextmanager
def _at_depth(depth: int):
    """``TPKT_DIST_DEPTH`` set to ``depth`` inside, restored after."""
    old = os.environ.get("TPKT_DIST_DEPTH")
    os.environ["TPKT_DIST_DEPTH"] = str(int(depth))
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TPKT_DIST_DEPTH", None)
        else:
            os.environ["TPKT_DIST_DEPTH"] = old


# ------------------------------------------------------------ timing

def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def group_max(value: float, mesh) -> float:
    """The largest ``value`` of any rank of the mesh (an all-reduce MAX
    on the group; the value itself without one). Every rank must call
    it: it is also the barrier :func:`group_seconds` puts before a rep."""
    if mesh.group is None:
        return value
    import torch.distributed as dist

    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.item())


def group_seconds(fn, mesh, reps: int):
    """``(seconds, output)``: one untimed warm-up call, then the best of
    ``reps`` group times of ``fn()`` (see the module's docstring); the
    output is the last call's."""
    out = fn()
    _sync(mesh)
    best = float("inf")
    for _ in range(max(1, reps)):
        group_max(0.0, mesh)  # every rank has arrived
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh)
        best = min(best, group_max(time.perf_counter() - t0, mesh))
    return best, out


# ---------------------------------------------------------- programs

def _nbody_programs(mesh, axis, quick):
    """``{"full", "comm", "compute"}`` callables of the ring N-body op."""
    from tpukernels_torch.kernels import nbody

    ax = mesh.axis(axis)
    n = ax.size
    steps = _work("nbody_steps", quick)
    total = _work("nbody_bodies", quick) * n
    rng = np.random.default_rng(0)
    state = tuple(
        host_to_global(rng.standard_normal(total).astype(np.float32)
                       if i < 6 else
                       rng.uniform(0.5, 1.5, total).astype(np.float32),
                       mesh, P(axis))
        for i in range(7))
    px, py, pz, m = state[0], state[1], state[2], state[6]
    eps2 = nbody._eps2(1e-2)

    def full():
        return C.nbody_dist_ring(state, steps, mesh, axis)

    def comm():
        # the ring's hops alone, chained as the pipeline's are
        block = torch.stack([px, py, pz, m])
        for _ in range(steps * max(n - 1, 1)):
            block = C.ring_shift(block, mesh, axis)
        return block

    def compute():
        # the force blocks alone: steps x P of them on the rank's bodies
        acc = [torch.zeros_like(px) for _ in range(3)]
        for _ in range(steps * n):
            for a, d in zip(acc, nbody.forces_ij(px, py, pz, px, py, pz, m,
                                                 eps2)):
                a += d
        return acc

    return {"full": full, "comm": comm, "compute": compute}


def _stencil_programs(mesh, axis, quick):
    """``{"full", "comm", "compute"}`` callables of the 2-D Jacobi op."""
    from tpukernels_torch.kernels import stencil

    ax = mesh.axis(axis)
    rows = _work("stencil_rows", quick)
    cols = _work("stencil_cols", quick)
    iters = _work("stencil_iters", quick)
    k = _work("stencil_k", quick)
    passes = max(iters // k, 1)
    rng = np.random.default_rng(1)
    x = host_to_global(
        rng.standard_normal((rows * ax.size, cols)).astype(np.float32),
        mesh, P(axis))

    def full():
        return C.jacobi2d_dist(x, iters, mesh, axis, k=k)

    def comm():
        # a k-deep exchange a round, the halos received written into
        # the rows the next round sends, so rounds wait on each other
        v = x
        for _ in range(passes):
            top, bot = C._halos(v, k, mesh, ax).result()
            v = torch.cat([v[:k] if top is None else top, v[k:rows - k],
                           v[-k:] if bot is None else bot])
        return v

    def compute():
        # the sweeps alone: k fused sweeps a round, no halo
        v = x
        for _ in range(passes):
            v = stencil.jacobi2d(v, k, k=k)
        return v

    return {"full": full, "comm": comm, "compute": compute}


_BUILDERS = {
    "nbody_ring": _nbody_programs,
    "stencil2d": _stencil_programs,
}


def _same(got, want) -> bool:
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(map(_same, got, want))
    return got.shape == want.shape and torch.equal(got, want)


def overlap_frac(t_comm: float, t_compute: float, t_full: float) -> float:
    """clamp01((t_comm + t_compute - t_full) / min(t_comm, t_compute)):
    the share of the cheaper phase the full program hid."""
    denom = min(t_comm, t_compute)
    if denom <= 0:
        return 0.0
    return max(0.0, min(1.0, (t_comm + t_compute - t_full) / denom))


def measure(ops=None, mesh=None, axis: str = "x", depth=None,
            reps: int = 5, quick: bool = False, verbose: bool = True,
            fake=None):
    """Measure each op's overlap on the group (every rank calls it);
    returns the artifact's ``points``. ``depth`` defaults to
    ``TPKT_DIST_DEPTH`` (the configured path). Raises when ``full``'s
    output is not bitwise the synchronous call's."""
    if mesh is None:
        mesh = make_mesh()
    nranks = mesh.axis(axis).size
    if depth is None:
        depth = C._dist_depth()
    depth = int(depth)
    if fake is None:
        fake = scaling.inventory(probe=True, device=mesh.device).get(
            "fake", True)
    points = []
    for op in ops or DEFAULT_OPS:
        if op not in _BUILDERS:
            raise ValueError(f"op={op!r}: expected one of {sorted(_BUILDERS)}")
        progs = _BUILDERS[op](mesh, axis, quick)
        with trace.span(f"overlap/{op}", n=nranks, depth=depth):
            t_comm, _ = group_seconds(progs["comm"], mesh, reps)
            trace.emit_span(f"comm/{op}", t_comm, n=nranks)
            t_compute, _ = group_seconds(progs["compute"], mesh, reps)
            trace.emit_span(f"compute/{op}", t_compute, n=nranks)
            with _at_depth(depth):
                t_full, got = group_seconds(progs["full"], mesh, reps)
        with _at_depth(1):
            want = progs["full"]()
        if not _same(got, want):
            raise AssertionError(f"overlap {op} at depth {depth}: the full "
                                 "program's output is not bitwise the "
                                 "synchronous call's")
        frac = overlap_frac(t_comm, t_compute, t_full)
        point = {
            "op": op, "n_devices": int(nranks), "mesh_shape": None,
            "depth": depth, "t_comm_s": round(t_comm, 6),
            "t_compute_s": round(t_compute, 6),
            "t_full_s": round(t_full, 6),
            "overlap_frac": round(frac, 4),
        }
        points.append(point)
        if mesh.rank != 0:
            continue  # the group's point is recorded once, by rank 0
        obs_metrics.inc("scaling.overlap_points")
        journal.emit("overlap_point", fake=bool(fake), **point)
        if verbose:
            print(
                f"overlap {op:<12} n={nranks} depth={depth} "
                f"comm={t_comm * 1e3:8.3f}ms "
                f"compute={t_compute * 1e3:8.3f}ms "
                f"full={t_full * 1e3:8.3f}ms frac={frac:5.3f}", flush=True)
    return points


def main(argv=None) -> int:
    kw, device = {}, None
    args = list(sys.argv[1:] if argv is None else argv)
    while args:
        a = args.pop(0)
        if a.startswith("--ops="):
            kw["ops"] = tuple(t for t in a[6:].split(",") if t.strip())
        elif a.startswith("--reps="):
            kw["reps"] = int(a[7:])
        elif a == "--quick":
            kw["quick"] = True
        elif a.startswith("--depth="):
            kw["depth"] = int(a[8:])
        elif a.startswith("--device="):
            device = a[9:]
        elif a == "--device" and args:
            device = args.pop(0)
        else:
            print(f"overlap: unknown argument {a!r}", file=sys.stderr)
            return 2
    mesh = make_mesh(device=device)
    # the mesh first: the probe reads the process group it joined
    inv = scaling.emit_inventory("overlap", probe=True, device=mesh.device)
    points = measure(mesh=mesh, fake=inv.get("fake", True), **kw)
    if mesh.rank == 0:
        artifact = scaling.write_overlap_artifact(points, inv)
        print(f"# overlap artifact: {artifact}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
