"""The readings that a cell's limits are set from, in one process.

    python3 cellbench/control.py --workload <cell> --seconds 2 \\
        --seeds <n> ... --control-seeds <n> ...

For each of ``--seeds``, one run of the cell as ``run.py`` makes it (a
short window at the cell's own load, its sampled calls compared with the
plain reference): the program's numbers, one JSON line each. For each of
``--control-seeds``, also the control: the plain reference computed in
the precision next below the configuration's (bfloat16 for float32), put
in the program's place on the same sampled operands and compared with
the same float32 reference. A limit lies above the largest program
reading and below the smallest control reading. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if sys.path[0] == _HERE:
    sys.path[0] = _ROOT

from cellbench import harness, spec  # noqa: E402
from cellbench import run as cb_run  # noqa: E402

# the precision next below the configuration's, the control's
LOWER = {"float32": "bfloat16"}


def control_reading(cell, rec: dict) -> dict:
    """The control's numbers on the run's sampled operands: the largest
    over the samples, each compared with the run's float32 reference."""
    import torch

    ref = spec.load_module("reference", cell.kernel)
    dtype = getattr(torch, LOWER[cell.config["dtype"]])
    worst: dict = {}
    for k in rec["kept"]:
        ops = rec["pool"][k["pool"]]
        low = ref.reference(ops, rec["statics"], dtype=dtype)
        for name, v in ref.compare(low, k["want"], ops,
                                   rec["statics"]).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cellbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cb_run.share_bytecode()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("cellbench: control readings need the card", file=sys.stderr)
        return 2
    state = tempfile.mkdtemp(prefix="cellbench-state-")
    cb_run.program_env(state, False)
    device = torch.device("cuda", 0)
    clock = harness.Clock.start()
    for seed in list(args.seeds) + [s for s in args.control_seeds
                                    if s not in args.seeds]:
        ctl = seed in args.control_seeds
        rec = harness.run_cell(cell, seed, args.seconds, False, device,
                               clock, keep=ctl)
        row = {"workload": cell.name, "seed": seed, "calls": rec["calls"],
               "compared": rec["compared"], "correct": rec["correct"],
               "program": {k: c["value"] for k, c in rec["checks"].items()}}
        if ctl:
            row["control"] = control_reading(cell, rec)
            row["control_dtype"] = LOWER[cell.config["dtype"]]
        print(json.dumps(row), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
