"""Weak-scaling sweep of the port's distributed programs, with its artifact.

Port of ``tools/weak_scaling.py``. For each group size N the sweep times
every program of :data:`PROGRAMS` with the work a rank holds fixed
(stencil rows, N-body bodies, scan and histogram elements, the
all-reduce message all grow with N; N-body is O(N^2) in all, linear a
rank when its i-bodies are split), so ideal weak scaling is a flat wall.
A point's wall is the group's (``overlap.group_seconds``: a barrier, the
device synchronised, the slowest rank, the best of ``--reps``). Rank 0
emits one ``weak_scaling_point`` event a point and adds one to the
``scaling.weak_points`` counter; the sweep writes one artifact
(``obs/scaling.write_weak_artifact``, into ``--out``, else
``$TPKT_SCALING_DIR``, else ``.tpkt_cache/scaling``), whose non-gating
verdict is ``below_scaling_efficiency`` under ``TPKT_SCALING_MIN_EFF``.

By default each size N runs as N fresh rank processes on gloo (one
``--inner`` process a rank), meeting through a ``file://`` rendezvous in
a temporary directory, with the caller's group settings scrubbed from
their env. Their kernels run on the card unless ``--device cpu``. Ranks
on the CPU, or more ranks than cards (four on one H100: each rank's
kernels take turns on the card, and gloo stages the wire through host
memory), make a fake artifact, which is reported and never judged.
``--real`` runs this process as one rank of the caller's group (the
``TPKT_COORDINATOR_*`` env, ``mesh.py``) at that group's size.

    python -m tpukernels_torch.parallel.weak_scaling [--sizes "1 2 4"]
        [--reps 2] [--quick] [--real] [--out DIR] [--device cpu]

``--quick`` cuts the work a rank holds by about 100x. Exit codes: 0 the
sweep completed; 1 a program or a rank failed; 2 usage, or no card
without ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import scaling
from tpukernels_torch.resilience import journal

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the work a rank holds: (default, --quick), the reference's sizes
WORK = {
    "stencil_rows": (512, 16), "stencil_cols": (1024, 64),
    "stencil_iters": (50, 2),
    "nbody_bodies": (2048, 64), "nbody_steps": (2, 1),
    "elems": (1 << 20, 4096), "nbins": (256, 256),
    "allreduce_floats": (1 << 22, 2048),
}

# the group settings a rank process of the sweep must not inherit
_GROUP_ENV = ("TPKT_COORDINATOR_ADDRESS", "TPKT_NUM_PROCESSES",
              "TPKT_PROCESS_ID", "TPKT_LOCAL_DEVICE", "TPKT_DIST_BACKEND",
              "TPKT_MESH")


def _work(name: str, quick: bool) -> int:
    return WORK[name][1 if quick else 0]


# ------------------------------------------------------------ programs
# each takes the group's 1-D mesh, --quick and the seeded generator
# (every rank draws the same full arrays and keeps its block) and
# returns (call, work a rank[, extra point fields]), or None where the
# program has no form at this group size

def _block(a, mesh, spec=None):
    from tpukernels_torch.parallel import P, host_to_global

    return host_to_global(a, mesh, P("x") if spec is None else spec)


def _run_stencil2d(mesh, quick, rng):
    from tpukernels_torch.parallel.collectives import jacobi2d_dist

    rows = _work("stencil_rows", quick)
    iters = _work("stencil_iters", quick)
    x = _block(rng.standard_normal(
        (rows * mesh.size, _work("stencil_cols", quick))).astype(np.float32),
        mesh)
    return (lambda: jacobi2d_dist(x, iters, mesh)), rows


def _run_nbody_ring(mesh, quick, rng):
    from tpukernels_torch.parallel.collectives import nbody_dist_ring

    bodies = _work("nbody_bodies", quick)
    steps = _work("nbody_steps", quick)
    nb = bodies * mesh.size
    state = tuple(_block(rng.standard_normal(nb).astype(np.float32), mesh)
                  for _ in range(6)) + (
        _block(rng.uniform(0.5, 1.5, nb).astype(np.float32), mesh),)
    return (lambda: nbody_dist_ring(state, steps, mesh)), bodies


def _run_scan_hist(mesh, quick, rng):
    from tpukernels_torch.parallel.collectives import histogram_dist, scan_dist

    elems = _work("elems", quick)
    nbins = _work("nbins", quick)
    x = _block(rng.integers(0, nbins, elems * mesh.size).astype(np.int32),
               mesh)

    def call():
        return scan_dist(x, mesh), histogram_dist(x, nbins, mesh)

    return call, elems


def _run_allreduce(mesh, quick, rng):
    from tpukernels_torch.parallel.collectives import allreduce_sum

    floats = _work("allreduce_floats", quick)
    x = _block(np.ones((mesh.size, floats), np.float32), mesh)
    return (lambda: allreduce_sum(x, mesh)), floats


def _mesh2d_shape(n: int):
    """The (r, c) of the sweep's 2-D mesh of n ranks, the flattest
    two-row split; None under 4 ranks or for an odd n."""
    if n < 4 or n % 2:
        return None
    return (2, n // 2)


def _run_allreduce2d(mesh, quick, rng):
    from tpukernels_torch.parallel import P, make_mesh
    from tpukernels_torch.parallel.collectives import allreduce_sum

    shape = _mesh2d_shape(mesh.size)
    if shape is None:
        return None
    floats = _work("allreduce_floats", quick)
    m2 = make_mesh(shape, device=mesh.device)
    x = _block(np.ones((mesh.size, floats), np.float32), m2, P(("x", "y")))
    return (lambda: allreduce_sum(x, m2)), floats, {"mesh_shape": list(shape)}


PROGRAMS = {
    "stencil2d": _run_stencil2d,
    "nbody_ring": _run_nbody_ring,
    "scan_hist": _run_scan_hist,
    "allreduce": _run_allreduce,
    "allreduce2d": _run_allreduce2d,
}


# ------------------------------------------------------------ one size

def run_group(reps: int, quick: bool, device=None, echo=True):
    """Every program on the group this process belongs to (every rank
    calls it); returns ``(points, inventory, failed)``. A program that
    raises is a failed point and the sweep goes on; but a rank that
    raises inside a collective leaves the others to their
    ``TPKT_COORDINATOR_TIMEOUT_S``."""
    from tpukernels_torch.parallel import make_mesh
    from tpukernels_torch.parallel.overlap import group_seconds

    mesh = make_mesh(device=device)
    n = mesh.size
    # the mesh first: the probe reads the process group it joined
    inv = scaling.emit_inventory("weak_scaling", probe=True,
                                 device=mesh.device)
    lead = mesh.rank == 0
    rng = np.random.default_rng(0)
    points, failed = [], 0
    for name, build in PROGRAMS.items():
        point = {"program": name, "n_devices": n, "ok": True}
        try:
            built = build(mesh, quick, rng)
            if built is None:
                if lead and echo:
                    print(f"weak_scaling n={n} {name:<12} skipped "
                          "(no mesh shape at this size)", flush=True)
                continue
            call, per_rank = built[0], built[1]
            if len(built) > 2:
                point.update(built[2])
            point["per_chip_work"] = per_rank
            wall, _ = group_seconds(call, mesh, reps)
            point["wall_s"] = round(wall, 6)
        except Exception as e:  # noqa: BLE001 — the sweep goes on
            point["ok"] = False
            point["error"] = repr(e)
            failed += 1
        points.append(point)
        if not lead:
            continue
        obs_metrics.inc("scaling.weak_points")
        journal.emit("weak_scaling_point", fake=inv.get("fake", True),
                     **point)
        if echo:
            wall = point.get("wall_s")
            print(f"weak_scaling n={n} {name:<12} "
                  + (f"wall={wall:9.4f}s" if wall is not None
                     else f"FAILED ({point.get('error')})")
                  + f" work/chip={point.get('per_chip_work', '?')}",
                  flush=True)
    return points, inv, failed


def _inner(reps: int, quick: bool, device) -> int:
    """One rank process of the default mode: rank 0 hands the parent
    its points and inventory as ``WEAK-*`` lines."""
    from tpukernels_torch.parallel import mesh as mesh_mod

    points, inv, failed = run_group(reps, quick, device)
    if mesh_mod.world()[0] == 0:
        print("WEAK-INVENTORY: " + json.dumps(inv), flush=True)
        for p in points:
            print("WEAK-POINT: " + json.dumps(p), flush=True)
    return 1 if failed else 0


def rank_env(n: int, rank: int, rendezvous: str, device=None) -> dict:
    """The env of rank ``rank`` of a fresh gloo group of ``n``: the
    caller's, less its group settings, plus the new group's."""
    env = {k: v for k, v in os.environ.items() if k not in _GROUP_ENV}
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = _REPO + (os.pathsep + prev if prev else "")
    env.update(TPKT_COORDINATOR_ADDRESS=f"file://{rendezvous}",
               TPKT_NUM_PROCESSES=str(n), TPKT_PROCESS_ID=str(rank),
               TPKT_DIST_BACKEND="gloo")
    env.setdefault("TPKT_COORDINATOR_TIMEOUT_S", "300")
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # n ranks share the cores
    return env


def _run_size(n: int, reps: int, quick: bool, device, tmp: str):
    """Size n as n fresh rank processes; ``(points, inventory, rc)``
    from rank 0's lines (rank 0's other lines are echoed)."""
    cmd = [sys.executable, "-m", "tpukernels_torch.parallel.weak_scaling",
           "--inner", "--reps", str(reps)]
    if quick:
        cmd.append("--quick")
    if device:
        cmd += ["--device", device]
    rdv = os.path.join(tmp, f"rendezvous_{n}")
    logs = [open(os.path.join(tmp, f"n{n}_rank{r}.log"), "w")
            for r in range(1, n)]
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                cmd, env=rank_env(n, r, rdv, device), cwd=_REPO,
                stdout=subprocess.PIPE if r == 0 else logs[r - 1],
                stderr=subprocess.STDOUT, text=True))
        points, inv = [], None
        for line in procs[0].stdout:
            if line.startswith("WEAK-POINT: "):
                points.append(json.loads(line[len("WEAK-POINT: "):]))
            elif line.startswith("WEAK-INVENTORY: "):
                inv = json.loads(line[len("WEAK-INVENTORY: "):])
            else:
                sys.stdout.write(line)
                sys.stdout.flush()
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs[1:], 1):
        if rc != 0:
            with open(os.path.join(tmp, f"n{n}_rank{r}.log")) as f:
                tail = f.read()[-2000:]
            print(f"weak_scaling n={n}: rank {r} rc {rc}\n{tail}",
                  file=sys.stderr)
    return points, inv, 0 if not any(rcs) else 1


def _sweep_inventory(invs):
    """One inventory for the sweep's artifact: the largest group's,
    fake when any size's was (with that size's basis)."""
    inv = dict(invs[-1])
    fake = next((i for i in invs if i.get("fake", True)), None)
    if fake is not None:
        inv["fake"] = True
        inv["fake_basis"] = fake.get("fake_basis")
    return inv


def _usage(msg: str) -> int:
    print(__doc__, file=sys.stderr)
    print(f"weak_scaling: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    sizes, reps, quick, real, inner = None, 2, False, False, False
    out_dir = device = None
    it = iter(argv)
    a = None
    try:
        for a in it:
            if a == "--sizes":
                sizes = [int(s) for s in next(it).split()]
            elif a == "--reps":
                reps = int(next(it))
            elif a == "--quick":
                quick = True
            elif a == "--real":
                real = True
            elif a == "--out":
                out_dir = next(it)
            elif a == "--device":
                device = next(it)
            elif a.startswith("--device="):
                device = a[len("--device="):]
            elif a == "--inner":
                inner = True
            else:
                return _usage(f"unknown argument {a!r}")
    except (StopIteration, ValueError):
        return _usage(f"{a} needs a value")
    if inner:
        return _inner(reps, quick, device)
    from tpukernels_torch.utils import pick_device

    try:
        pick_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"weak_scaling: {e}", file=sys.stderr)
        return 2
    if real:
        if sizes is not None:
            return _usage("--real runs at the caller's group size; "
                          "drop --sizes")
        points, inv, failed = run_group(reps, quick, device)
        rc = 1 if failed else 0
        from tpukernels_torch.parallel import mesh as mesh_mod

        if mesh_mod.world()[0] != 0:
            return rc
        sizes = [mesh_mod.world()[1]]
    else:
        sizes = [1, 2, 4, 8] if sizes is None else sizes
        if not sizes or any(n < 1 for n in sizes):
            return _usage(f"bad --sizes {sizes}")
        scaling.emit_inventory("weak_scaling:parent")
        points, invs, rc = [], [], 0
        with tempfile.TemporaryDirectory(prefix="tpkt_weak_") as tmp:
            for n in sizes:
                print(f"== mesh n={n}", flush=True)
                pts, inv, size_rc = _run_size(n, reps, quick, device, tmp)
                points += pts
                if inv is not None:
                    invs.append(inv)
                rc = rc or size_rc
        if invs:
            inv = _sweep_inventory(invs)
        else:
            # no rank printed its probed inventory: the env's, forced fake
            inv = dict(scaling.inventory(), fake=True,
                       fake_basis="unprobed-fallback")
            journal.emit("device_inventory", site="weak_scaling:fallback",
                         **inv)
            print("weak_scaling: WARNING no rank inventory captured - "
                  "artifact stamped from the env (unprobed-fallback) and "
                  "never judged", file=sys.stderr)
    artifact = scaling.write_weak_artifact(points, inv, out_dir)
    ok = sum(1 for p in points if p.get("ok"))
    basis = inv.get("fake_basis")
    note = (" (shared card - contention, not scaling; never judged)"
            if basis == "shared-card" else
            " (no rank inventory - stamped fake, never judged)"
            if basis == "unprobed-fallback" else
            " (FAKE devices - logic proof, never judged)")
    print(f"weak_scaling: {ok}/{len(points)} point(s) ok across meshes "
          f"{sizes}" + (note if inv.get("fake", True) else "")
          + f" -> {artifact}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
