"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. It refuses (exit code 2, no result)
where ``torch.cuda`` sees fewer cards than the cell asks for, or where
the checkout holds no ``tpukernels_torch``; and (exit code 3, no result)
where ``jax``, ``jaxlib``, ``flax`` or the JAX package ``tpukernels`` is
loaded once the window has closed. Otherwise the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's ``end_to_end`` metrics with ``--trace 0``, its
``per_layer`` ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, the set-up's parts, and last ``checks``: each number the
comparison read beside its limit, also the last lines of standard error.

Caches stay inside the checkout at fixed paths: the bytecode of every
module under ``.cellbench_cache/pycache`` (``PYTHONPYCACHEPREFIX``), the
program's nvcc libraries in ``tpukernels_torch/_build``. The program's
state directories (tuning cache, compile manifest, integrity envelopes
and quarantine, the journal) go to a fresh directory under ``TMPDIR``
a run, removed at its end; its ``TPKT_*`` knobs are cleared, so it runs
at its code defaults. A mesh cell (traffic ``entry: dispatch_mesh``)
starts one process a further rank of the mesh, each on its own card,
joined over NCCL at a free ``localhost`` port; this process is rank 0,
times the window, prints the line and waits for every rank to end.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if sys.path[0] == _HERE:
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from cellbench import harness, spec  # noqa: E402  (no torch)

CLOCK = harness.Clock.start()
CACHE = os.path.join(_ROOT, ".cellbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpukernels")


def share_bytecode() -> None:
    """One bytecode cache at a fixed path in the checkout, for this
    process and the ranks it starts."""
    prefix = os.path.join(CACHE, "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules, each
    module's name before its first dot compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_env(state: str, trace: bool) -> None:
    """The program at its code defaults, its state under ``state``."""
    for k in [k for k in os.environ if k.startswith("TPKT_")]:
        del os.environ[k]
    from tpukernels_torch import _cachedir

    os.environ.update(_cachedir.state_dirs_under(state))
    if trace:
        os.environ["TPKT_TRACE"] = "1"
        os.environ["TPKT_HEALTH_JOURNAL"] = os.path.join(state,
                                                         "journal.jsonl")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    import ctypes

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def start_ranks(args, world: int, port: int) -> list:
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                      preexec_fn=_die_with_parent))
    return procs


def reap(procs: list, timeout: float = 60.0) -> list:
    """Wait for every rank; kill those still running after ``timeout``
    seconds. Returns their exit codes."""
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


def read_metrics(entries: list, rec: dict) -> dict:
    out = {}
    for m in entries:
        value = spec.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, rec: dict, trace: bool, device_name: str) -> dict:
    line = {"correct": rec["correct"], "attempted": rec["attempted"],
            "failed": rec["failed"],
            "metrics": read_metrics(cell.per_layer if trace
                                    else cell.end_to_end, rec),
            "device": {"platform": "gpu", "kind": device_name,
                       "count": rec["ranks"],
                       "memory_peak_bytes": rec["memory_peak_bytes"]}}
    prof = rec.get("profile")
    if trace and prof:
        line["device"]["busy_s"] = prof["busy_s"]
        line["device"]["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["setup_parts_s"] = rec["setup_parts_s"]
    line["compared_calls"] = rec["compared"]
    line["checks"] = rec["checks"]
    return line


def parse(argv):
    ap = argparse.ArgumentParser(prog="cellbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    share_bytecode()
    try:
        cell = spec.cell(args.workload)
    except KeyError as e:
        print(f"cellbench: {e}", file=sys.stderr)
        return 2
    found = importlib.util.find_spec("tpukernels_torch")
    if found is None or not os.path.abspath(found.origin).startswith(
            _ROOT + os.sep):
        print("cellbench: no tpukernels_torch in this checkout",
              file=sys.stderr)
        return 2
    import torch

    CLOCK.lap("interpreter and import torch")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"cellbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {cards}", file=sys.stderr)
        return 2
    mesh = cell.traffic.get("entry") == "dispatch_mesh"
    world = math.prod(cell.traffic["mesh_shape"]) if mesh else 1
    rank = args.rank
    state = tempfile.mkdtemp(prefix="cellbench-state-")
    procs = []
    try:
        program_env(state, bool(args.trace))
        if mesh:
            port = args.port or _free_port()
            if rank == 0:
                procs = start_ranks(args, world, port)
            os.environ.update({
                "TPKT_COORDINATOR_ADDRESS": f"localhost:{port}",
                "TPKT_NUM_PROCESSES": str(world),
                "TPKT_PROCESS_ID": str(rank),
                "TPKT_LOCAL_DEVICE": str(rank),
                "TPKT_COORDINATOR_TIMEOUT_S": "300"})
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        CLOCK.lap("CUDA context")
        if mesh:
            from tpukernels_torch.parallel import mesh as port_mesh

            port_mesh.maybe_distributed_init(device)
            CLOCK.lap("rendezvous")
        rec = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device, CLOCK, rank=rank,
                               world=world)
        if mesh:
            port_mesh.leave()
    finally:
        rcs = reap(procs)
        shutil.rmtree(state, ignore_errors=True)
    if rank != 0:
        return 0
    if any(rcs):
        print(f"cellbench: a rank ended with {rcs}", file=sys.stderr)
        return 1
    loaded = forbidden_loaded()
    if loaded:
        print(f"cellbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    line = result_line(cell, rec, bool(args.trace),
                       torch.cuda.get_device_name(device))
    for k, c in rec["checks"].items():
        print(f"cellbench check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
