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

``--fuzz [ROUNDS]`` is the port's copy of ``tools/fuzz_c.sh``, the
second half of the reference's ``make -C c test``: ROUNDS (default 10)
rounds, each drawing one extent set for the six drivers from the ranges
``tools/fuzz_c.sh`` gives them (parsed from it at run time, as the rows
above are from ``c/run_all.sh``, so they cannot drift) with a numpy
generator seeded by ``TPKT_FUZZ_SEED`` (default 42), and running each at
``--device=omp`` (the reference's row, no port code) and at
``--device=tpu`` through the port's shim (off-tile SGEMM extents, tiny
grids, odd bin counts through the hand-written kernels), both with
``--check --reps=1``, six rows at once (:data:`FUZZ_JOBS`; a C host's
start is most of a row). Each row prints its extents, rc and wall; a
failed row prints the driver's own output and the exact replay command
after ``FUZZ FAIL:``, and the run ends ``FUZZ: FAIL`` (rc 1) or ``FUZZ:
PASS (<rounds> rounds x 6 drivers x 2 devices, seed <s>)``.

Exit codes: 0 every row passed (``ACCEPTANCE: PASS``, ``FUZZ: PASS``); 1
a row failed or a build failed; 64 a usage error.
"""

from __future__ import annotations

import os
import re
import shlex
import subprocess
import sys
import time

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


FUZZ_SCRIPT = _build.C_DIR.parent / "tools" / "fuzz_c.sh"
FUZZ_DEVICES = ("omp", "tpu")
# rows run at once: a `tpu` row's wall is its C host's start (CPython,
# torch, a CUDA context; 12-17 s each on the H100 host), not its kernels
FUZZ_JOBS = 6
_RND = r"\$\(rnd (\d+)\)"
_FLAG_RE = re.compile(
    rf"--(\w+)=(?:{_RND}|\$\(\({_RND} \+ (\d+)\)\))")


def fuzz_ranges() -> list:
    """The drivers and extent ranges of tools/fuzz_c.sh's round, as
    ``[(driver, [(flag, n, add), ...]), ...]``: each flag drawn uniform in
    1..n, plus ``add``."""
    text = FUZZ_SCRIPT.read_text().replace("\\\n", " ")
    body = re.search(r'for _ in \$\(seq 1 "\$rounds"\); do\n(.*?)\ndone',
                     text, re.DOTALL)
    if body is None:
        raise ValueError(f"{FUZZ_SCRIPT}: no round loop found")
    rows = []
    for line in body.group(1).splitlines():
        m = re.match(r"\s*run_check \./bin/(\w+) (.*)$", line)
        if not m:
            continue
        flags = []
        for f in _FLAG_RE.finditer(m.group(2)):
            n = f.group(2) or f.group(3)
            flags.append((f.group(1), int(n), int(f.group(4) or 0)))
        rows.append((m.group(1), flags))
    if not rows:
        raise ValueError(f"{FUZZ_SCRIPT}: no run_check row found")
    return rows


def fuzz_seed() -> int:
    return int(os.environ.get("TPKT_FUZZ_SEED") or 42)


def fuzz_draws(rounds: int, seed: int, ranges=None) -> list:
    """``[(driver, [--flag=value, ...]), ...]``: ``rounds`` extent sets of
    the fuzz's drivers, in order, from a generator seeded by ``seed``."""
    import numpy as np

    ranges = fuzz_ranges() if ranges is None else ranges
    rng = np.random.default_rng(seed)
    return [(driver, [f"--{flag}={int(rng.integers(1, n + 1)) + add}"
                      for flag, n, add in flags])
            for _ in range(rounds) for driver, flags in ranges]


def _fuzz_row(cmd, env) -> tuple:
    """``(rc, output, wall s)`` of one row."""
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=ROW_TIMEOUT_S)
        rc, out = p.returncode, p.stdout + p.stderr
    except subprocess.TimeoutExpired:
        rc, out = "timeout", f"(timed out after {ROW_TIMEOUT_S} s)\n"
    return rc, out, time.perf_counter() - t0


def fuzz(cbin, env, draws, rounds: int) -> bool:
    """Run every draw at each of :data:`FUZZ_DEVICES` with ``--check
    --reps=1``, :data:`FUZZ_JOBS` rows at once, and report them in order;
    True when every row passed."""
    from concurrent.futures import ThreadPoolExecutor

    per_round = max(1, len(draws) // rounds)
    rows = [(i, driver, argv, dev,
             [str(cbin / driver), *argv, f"--device={dev}", "--check",
              "--reps=1"])
            for i, (driver, argv) in enumerate(draws)
            for dev in FUZZ_DEVICES]
    ok = True
    with ThreadPoolExecutor(FUZZ_JOBS) as pool:
        results = pool.map(lambda row: _fuzz_row(row[-1], env), rows)
        for (i, driver, argv, dev, cmd), (rc, out, wall) in zip(rows,
                                                                 results):
            print(f"fuzz round {i // per_round + 1}/{rounds}: bin/{driver} "
                  f"{' '.join(argv)} --device={dev}: rc {rc}, {wall:.3f} s",
                  flush=True)
            if rc == 0 and f"kernel={driver} CHECK PASS" in out:
                continue
            replay = " ".join(
                [f"{k}={shlex.quote(env[k])}" for k in
                 ("TPU_KERNELS_SHIM", "TPKT_CAPI_DEVICE", "TPKT_FAULT_PLAN")
                 if dev == "tpu" and env.get(k)]
                + [shlex.quote(c) for c in cmd])
            print(f"FUZZ FAIL: {replay}")
            sys.stdout.write(out[-4000:])
            ok = False
    return ok


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
    rounds = None
    if argv[:1] == ["--fuzz"]:
        try:
            rounds = int(argv[1]) if len(argv) > 1 else 10
        except ValueError:
            rounds = 0
        if rounds < 1 or len(argv) > 2:
            print(__doc__, file=sys.stderr)
            print(f"cgate: --fuzz takes one ROUNDS >= 1, got {argv[1:]}",
                  file=sys.stderr)
            return 64
        argv = []
    elif argv[:1] == ["--sanitize"]:
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
    if rounds is not None:
        seed = fuzz_seed()
        ok = fuzz(cbin, env, fuzz_draws(rounds, seed), rounds)
        n = len(fuzz_ranges())
        print(f"FUZZ: PASS ({rounds} rounds x {n} drivers x "
              f"{len(FUZZ_DEVICES)} devices, seed {seed})" if ok
              else "FUZZ: FAIL")
        return 0 if ok else 1
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
