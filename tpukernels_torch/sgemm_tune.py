"""Deprecated alias of the port's SGEMM sweep, kept as the reference keeps
``tools/sgemm_tune.py``:

    python -m tpukernels_torch.sgemm_tune [--quick]
        ==  python -m tpukernels_torch.autotune --kernel sgemm [--quick]

The sweep's axes (tile rows, columns and depth, the ring's stages, the
grid order) are ``kernels/sgemm.py``'s ``TUNABLES``; the killable child a
candidate and the 3 % promotion margin are ``tuning/runner.py``'s.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print("# sgemm_tune is deprecated: forwarding to `python -m "
          "tpukernels_torch.autotune --kernel sgemm`", file=sys.stderr)
    from tpukernels_torch import autotune

    return autotune.main(["--kernel", "sgemm", *argv])


if __name__ == "__main__":
    sys.exit(main())
