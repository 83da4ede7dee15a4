"""The multi-rank dry run: every distributed program of the port, checked.

The port's counterpart of ``__graft_entry__.dryrun_multichip`` and
``_dryrun_inner``. ``python -m tpukernels_torch.dryrun N [--device cpu]``
starts N rank processes, a fresh gloo group meeting through a
``file://`` rendezvous in a temporary directory, each with the caller's
group settings scrubbed from its env (``weak_scaling.rank_env``). Their
kernels run on the card, the N sharing it, unless ``--device cpu``. Each
rank runs the reference's programs in its order, on the same seeded
inputs, and checks each result:

``allreduce_sum``, ``bcast``, ``ring_shift`` (exact), ``jacobi2d_dist``
with its residual, ``jacobi3d_dist`` (finite), ``scan_dist`` and
``histogram_dist`` (exact against numpy), ``nbody_dist_ring`` and
``nbody_dist_psum`` (finite).

Rank 0's output streams through: a ``[dryrun +T.Ts] <program>`` line at
each program's start, then the ``MULTICHIP-PROGRAMS: {...}`` line of
per-program walls (``obs/scaling.parse_dryrun_tail`` reads both forms),
and, when ``TPKT_MULTICHIP_ARTIFACT`` names a path, the artifact there
(n_devices, ok, programs, the probed device inventory: fake on the CPU
and where the ranks share a card). Each program's start is also a fault
point (``dryrun/<program>`` in ``TPKT_FAULT_PLAN``'s ``wedge_dispatch``).

The run is bounded by ``TPKT_DRYRUN_TIMEOUT`` seconds (default 600): on
a timeout every rank is killed and the error names rank 0's last
progress line. Exit codes: 0 every program passed on every rank; 1 a
rank failed or the run timed out; 2 usage, or no card without
``--device cpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROGRAMS_LINE = "MULTICHIP-PROGRAMS: "


def _inner(device) -> int:
    """One rank: the programs in the reference's order on its group."""
    t0 = time.time()
    programs: list = []
    rank = int(os.environ.get("TPKT_PROCESS_ID", "0"))

    def note(msg: str) -> None:
        if rank == 0:
            print(f"[dryrun +{time.time() - t0:5.1f}s] {msg}", flush=True)

    from tpukernels_torch.resilience import faults

    @contextlib.contextmanager
    def prog(name: str, detail: str = ""):
        note(name + (f" ({detail})" if detail else ""))
        faults.dispatch_fault(f"dryrun/{name}")
        t = time.time()
        entry = {"name": name, "wall_s": None, "ok": False}
        programs.append(entry)
        yield
        entry["wall_s"] = round(time.time() - t, 3)
        entry["ok"] = True

    note("importing torch")
    import numpy as np
    import torch

    from tpukernels_torch.obs import scaling
    from tpukernels_torch.parallel import P, global_to_host, host_to_global
    from tpukernels_torch.parallel import make_mesh
    from tpukernels_torch.parallel.collectives import (
        allreduce_sum,
        bcast,
        histogram_dist,
        jacobi2d_dist,
        jacobi3d_dist,
        nbody_dist_psum,
        nbody_dist_ring,
        ring_shift,
        scan_dist,
    )

    mesh = make_mesh(device=device)
    n = mesh.size
    rng = np.random.default_rng(0)
    X = P("x")

    def blk(a):
        return host_to_global(a, mesh, X)

    def full(t):
        return global_to_host(t, mesh, X).cpu().numpy()

    def finite(*ts):
        for t in ts:
            if not torch.isfinite(t).all():
                raise AssertionError("non-finite values in the result")

    # allreduce (MPI_Allreduce): rank r's row of an (n, 256) array
    x = rng.standard_normal((n, 256)).astype(np.float32)
    with prog("allreduce_sum"):
        out = full(allreduce_sum(blk(x), mesh))
        np.testing.assert_allclose(out[0], x.sum(axis=0), rtol=1e-5,
                                   atol=1e-5)

    with prog("bcast"):
        root = min(1, n - 1)
        np.testing.assert_array_equal(full(bcast(blk(x), mesh, root=root)),
                                      np.tile(x[root], (n, 1)))

    with prog("ring_shift"):
        np.testing.assert_array_equal(full(ring_shift(blk(x), mesh)),
                                      np.roll(x, 1, axis=0))

    with prog("jacobi2d_dist", "halo exchange + residual allreduce"):
        grid = rng.standard_normal((8 * n, 128)).astype(np.float32)
        s, res = jacobi2d_dist(blk(grid), 2, mesh, k=2, residual=True)
        finite(s)
        if not float(res) >= 0.0:
            raise AssertionError(f"residual {float(res)} < 0")

    with prog("jacobi3d_dist"):
        grid3 = rng.standard_normal((2 * n, 8, 128)).astype(np.float32)
        finite(jacobi3d_dist(blk(grid3), 2, mesh, k=2))

    vals = rng.integers(0, 16, 128 * n, endpoint=False).astype(np.int32)
    with prog("scan_dist"):
        np.testing.assert_array_equal(full(scan_dist(blk(vals), mesh)),
                                      np.cumsum(vals).astype(np.int32))
    with prog("histogram_dist"):
        h = histogram_dist(blk(vals), 16, mesh).cpu().numpy()
        np.testing.assert_array_equal(h, np.bincount(vals, minlength=16))

    # N-body: i-blocks round the ring, and j-blocks summed (psum)
    nb = 64 * n
    state = [rng.standard_normal(nb).astype(np.float32) for _ in range(6)]
    state.append(rng.uniform(0.5, 1.5, nb).astype(np.float32))
    with prog("nbody_dist_ring"):
        finite(*nbody_dist_ring(tuple(map(blk, state)), 1, mesh))
    with prog("nbody_dist_psum"):
        rep = tuple(torch.from_numpy(a).to(mesh.device) for a in state[:6])
        finite(*nbody_dist_psum(rep + (blk(state[6]),), 1, mesh))

    # the walls, stamped with the hardware that made them
    inv = scaling.emit_inventory("dryrun", probe=True, device=mesh.device)
    if rank == 0:
        print(_PROGRAMS_LINE + json.dumps({"n_devices": n,
                                           "programs": programs}),
              flush=True)
        path = os.environ.get("TPKT_MULTICHIP_ARTIFACT")
        if path:
            from tpukernels_torch.resilience import atomic

            atomic.dump_json(path, {"n_devices": n, "ok": True,
                                    "programs": programs,
                                    "device_inventory": inv})
    note("all programs OK")
    if rank == 0:
        print(f"dryrun_multichip({n}): OK", flush=True)
    return 0


def dryrun_multichip(n: int, device=None) -> None:
    """Run the dry run as ``n`` fresh rank processes; raises
    RuntimeError when a rank fails or ``TPKT_DRYRUN_TIMEOUT`` passes
    (every rank killed; the error names the last progress line)."""
    from tpukernels_torch.parallel.weak_scaling import rank_env

    timeout = float(os.environ.get("TPKT_DRYRUN_TIMEOUT", "600"))
    cmd = [sys.executable, "-m", "tpukernels_torch.dryrun", "--inner"]
    if device:
        cmd += ["--device", device]
    with tempfile.TemporaryDirectory(prefix="tpkt_dryrun_") as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                for r in range(1, n)]
        procs = []
        try:
            for r in range(n):
                env = rank_env(n, r, os.path.join(tmp, "rendezvous"), device)
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=_REPO,
                    stdout=subprocess.PIPE if r == 0 else logs[r - 1],
                    stderr=subprocess.STDOUT, text=True))
            progress = ["(no progress line printed)"]

            def forward():
                for line in procs[0].stdout:
                    sys.stdout.write(line)
                    sys.stdout.flush()
                    if "[dryrun" in line:
                        progress[0] = line.strip()

            reader = threading.Thread(target=forward, daemon=True)
            reader.start()
            deadline = time.monotonic() + timeout
            try:
                rcs = [p.wait(timeout=max(0.0, deadline - time.monotonic()))
                       for p in procs]
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"dryrun_multichip({n}) timed out after {timeout:.0f}s;"
                    f" last progress: {progress[0]}") from None
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
                reader.join(timeout=10)
        finally:
            for f in logs:
                f.close()
        bad = [(r, rc) for r, rc in enumerate(rcs) if rc != 0]
        for r, rc in bad:
            if r:
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    sys.stderr.write(f"--- rank {r} (rc {rc}):\n"
                                     f"{f.read()[-3000:]}")
        if bad:
            raise RuntimeError(
                f"dryrun_multichip({n}): rank(s) "
                + ", ".join(f"{r} rc={rc}" for r, rc in bad)
                + " - see output above")


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device, n, inner = None, None, False
    while args:
        a = args.pop(0)
        if a == "--inner":
            inner = True
        elif a == "--device" and args:
            device = args.pop(0)
        elif a.startswith("--device="):
            device = a[len("--device="):]
        elif n is None and a.isdigit():
            n = int(a)
        else:
            print(f"dryrun: unknown argument {a!r}\nusage: python -m "
                  "tpukernels_torch.dryrun N [--device cpu]",
                  file=sys.stderr)
            return 2
    if inner:
        return _inner(device)
    if n is None or n < 1:
        print("usage: python -m tpukernels_torch.dryrun N [--device cpu]",
              file=sys.stderr)
        return 2
    from tpukernels_torch.utils import pick_device

    try:
        pick_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    try:
        dryrun_multichip(n, device)
    except RuntimeError as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
