"""The C acceptance gate on the port: the unchanged ``c/`` drivers, their
``--device=tpu`` rows through the port's shim.

    python -m tpukernels_torch.cgate [--sanitize asan|ubsan]
    python -m tpukernels_torch.cgate DRIVER [ARGS...]

The port's counterpart of ``make -C c`` and ``c/run_all.sh`` with its
TPU rows (the reference queue's ``c_gate`` step). It builds the port's shim
(``_build.build_shim``) and the drivers (``_build.build_c_drivers``, into
``_build/cbin``, never ``c/bin``), then runs ``bin/test_shim_abi`` and
every single-device ``run <driver> <flags>`` row of ``c/run_all.sh`` at
``--device=serial``, ``omp`` and ``tpu`` with ``--check --reps=1``, the
``tpu`` rows through the port (``TPU_KERNELS_SHIM``); each must print
its CHECK PASS. ``allreduce_bench`` and the mesh rows run as rank
processes and are not among them (``chip_smoke.py`` phase 8c runs them).

``DRIVER ARGS`` runs that one driver at ``--device=tpu --check ARGS``
instead (the ``c_scan_timing`` step: ``scan_histogram --n=4194304``).
``--sanitize asan|ubsan`` builds the drivers and the port's shim with
AddressSanitizer or UndefinedBehaviorSanitizer (``c/Makefile``'s
``asan`` and ``ubsan`` flags, into ``_build/cbin-<name>``) and runs the
rows as above; set
``TPKT_CAPI_DEVICE=cpu`` to run the ``tpu`` rows on the CPU, as the
reference's sanitizer steps do.

Exit codes: 0 every row passed (``ACCEPTANCE: PASS``); 1 a row failed or
a build failed; 64 a usage error.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

from tpukernels_torch import _build

DEVICES = ("serial", "omp", "tpu")
# c/Makefile's own CFLAGS (a command-line CFLAGS replaces them) and its
# asan/ubsan targets' additions
MAKE_CFLAGS = "-O3 -march=native -fno-math-errno -Wall -Wextra -std=c11"
SANITIZE = {"asan": "-fsanitize=address -g",
            "ubsan": "-fsanitize=undefined -fno-sanitize-recover=all -g"}
ROW_TIMEOUT_S = 600


def run_all_rows() -> list:
    """The single-device ``run <driver> <flags>`` rows of c/run_all.sh,
    as ``(driver, [flags])``."""
    rows = []
    with open(_build.C_DIR / "run_all.sh") as f:
        for line in f:
            m = re.match(r"run (\w+) (.*?)\s*(#.*)?$", line.rstrip("\n"))
            if m and m.group(1) != "allreduce_bench":
                rows.append((m.group(1), m.group(2).split()))
    return rows


def _row(cbin, env, driver, argv, want) -> bool:
    cmd = [str(cbin / driver), *argv]
    shown = " ".join([f"bin/{driver}", *argv])
    print(f"== {shown}", flush=True)
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=ROW_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"FAILED: {shown} (timed out after {ROW_TIMEOUT_S} s)")
        return False
    sys.stdout.write(p.stdout[-2000:])
    if p.returncode != 0 or want not in p.stdout:
        sys.stdout.write(p.stderr[-4000:])
        print(f"FAILED: {shown} (rc {p.returncode})")
        return False
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    sanitize = None
    if argv[:1] == ["--sanitize"]:
        if len(argv) < 2 or argv[1] not in SANITIZE:
            print(__doc__, file=sys.stderr)
            return 64
        sanitize, argv = argv[1], argv[2:]
    if argv and (argv[0].startswith("-") or argv[0] not in _build.C_DRIVERS):
        print(__doc__, file=sys.stderr)
        print(f"cgate: unknown driver or flag {argv[0]!r}", file=sys.stderr)
        return 64
    env = dict(os.environ)
    try:
        if sanitize is None:
            shim = _build.build_shim()
            cbin = _build.build_c_drivers()
        else:
            cbin = _build.BUILD_DIR / f"cbin-{sanitize}"
            shim = _build.build_shim(cbin, SANITIZE[sanitize].split())
            cbin = _build.build_c_drivers(
                cbin, cflags=f"{MAKE_CFLAGS} {SANITIZE[sanitize]}",
                ldlibs="-lstdc++")
            # CPython and torch keep allocations until exit on purpose
            env.setdefault("ASAN_OPTIONS", "detect_leaks=0")
    except (OSError, RuntimeError) as e:
        print(f"cgate: build failed: {e}", file=sys.stderr)
        return 1
    env["TPU_KERNELS_SHIM"] = str(shim)
    if argv:
        ok = _row(cbin, env, argv[0], ["--device=tpu", "--check", *argv[1:]],
                  f"kernel={argv[0]} CHECK PASS")
        return 0 if ok else 1
    ok = _row(cbin, env, "test_shim_abi", [], "ALL PASS")
    for driver, flags in run_all_rows():
        for dev in DEVICES:
            ok &= _row(cbin, env, driver,
                       [f"--device={dev}", "--check", "--reps=1", *flags],
                       f"kernel={driver} CHECK PASS")
    print(f"ACCEPTANCE: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
