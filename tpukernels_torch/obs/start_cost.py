"""What it costs to start a Python that reaches the card, with and without
a bytecode cache shared between the starts.

Usage:
    python -m tpukernels_torch.obs.start_cost [--reps N] [--device cpu]

Each case is a fresh child, timed from spawn to exit on the host's clock:
``import torch``, then (on a card) ``import torch`` with the port's bench
module and the first CUDA tensor, which is what a ``bench --one`` child,
a daemon or a C host pays before its first launch. Each case runs
``--reps`` times (default 2) as the environment stands, then as many
times with a new, empty bytecode cache (``PYTHONPYCACHEPREFIX`` set to a
temporary directory, ``PYTHONDONTWRITEBYTECODE`` dropped) after one start
that writes it. Where the environment forbids bytecode files and
site-packages holds none, every start compiles torch's modules from
source again; ``chip_smoke.py`` shares one cache for that reason.

It prints a line a case and, last, one JSON object. ``--device cpu``
times ``import torch`` alone (no card needed). Exit codes: 0 measured; 2
no card and no ``--device cpu``, or a usage error. It reads no knob.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CASES = {
    "import torch": "import torch",
    "import + first CUDA tensor": (
        "import torch, tpukernels_torch.bench; "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"),
}


def start_s(code: str, env: dict) -> float:
    """Seconds from spawning ``python -c code`` to its exit (rc 0)."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                   check=True, stdout=subprocess.DEVNULL)
    return time.perf_counter() - t0


def repo_env(**extra) -> dict:
    """This process's environment with the repository on ``PYTHONPATH``."""
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    return env


def measure(cases: dict, reps: int) -> dict:
    """``{case: {"as_is": [s, ...], "writes": s, "cached": [s, ...]}}``."""
    out = {}
    for name, code in cases.items():
        env = repo_env()
        row = {"as_is": [round(start_s(code, env), 3) for _ in range(reps)]}
        with tempfile.TemporaryDirectory(prefix="tpkt_pyc_") as d:
            env = repo_env(PYTHONPYCACHEPREFIX=d)
            env.pop("PYTHONDONTWRITEBYTECODE", None)
            row["writes"] = round(start_s(code, env), 3)
            row["cached"] = [round(start_s(code, env), 3)
                             for _ in range(reps)]
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", choices=("cpu",))
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    cases = dict(CASES)
    if args.device == "cpu":
        del cases["import + first CUDA tensor"]
    elif subprocess.run([sys.executable, "-c",
                         "import sys, torch; "
                         "sys.exit(0 if torch.cuda.is_available() else 2)"],
                        cwd=_REPO).returncode != 0:
        print("start_cost: no CUDA device (--device cpu times the import "
              "alone)", file=sys.stderr)
        return 2
    no_pyc = subprocess.run(
        [sys.executable, "-c",
         "import sys; print(int(sys.flags.dont_write_bytecode))"],
        capture_output=True, text=True, check=True).stdout.strip() == "1"
    rows = measure(cases, args.reps)
    for name, r in rows.items():
        print(f"{name}: as is {r['as_is']} s; a new cache's first start "
              f"{r['writes']} s, then {r['cached']} s")
    print(json.dumps({"start_cost": rows, "dont_write_bytecode": no_pyc,
                      "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
