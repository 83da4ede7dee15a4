"""The reference's TPU kernels and where each stands in the port.

``TPU_KERNELS`` has one row per function in ``tpukernels/kernels/*.py``
that is handed to ``pl.pallas_call``, at the line of its ``def``.
A row is ``ported`` (naming the CUDA entry and its source under
``csrc/``) or ``pending`` (still to port; ROADMAP.md Queue B lists it).
``tests/test_torch_port_rules.py`` scans the reference's sources and
fails on a Pallas kernel without a row, or a row without a kernel.

``LAUNCHES`` counts, per CUDA kernel, the launches its wrapper made in
this process: each wrapper adds one (:func:`count_launch`, under a lock:
the serving daemon's workers launch from two threads) where it launches
and nowhere else.
``HELPER_KERNELS`` are the hand-written kernels that replace no TPU
kernel (work the reference leaves to XLA): they have a counter and a
source, but no row in ``TPU_KERNELS``.
``chip_smoke.py`` zeroes the counts before it drives the main path and
reads them after, to show the path went through the kernels. At exit a
process adds its nonzero counts to its metrics as
``kernel.launches.<name>`` counters (:func:`publish_launches`; a C host
at its shim's exit flush), so the exit ``metrics`` journal event says
which kernels a child process (a revalidation step, a C driver) launched.
"""

from __future__ import annotations

import atexit
import threading
from dataclasses import dataclass
from typing import Optional

# imported before the exit hook below is registered, so the metrics'
# exit flush (registered at its import) runs after the hook: atexit runs
# the last registered first
from tpukernels_torch.obs import metrics


@dataclass(frozen=True)
class TpuKernel:
    id: str
    file: str
    line: int
    function: str
    status: str  # "ported" | "pending"
    port_entry: Optional[str] = None  # C entry of the CUDA kernel
    port_source: Optional[str] = None
    launches: tuple = ()  # keys of LAUNCHES this row's port counts

    @property
    def where(self) -> str:
        return f"{self.file}:{self.line}"


_K = "tpukernels/kernels/"
_CSRC = "tpukernels_torch/csrc/"

TPU_KERNELS = (
    TpuKernel("B1", _K + "sgemm.py", 164, "_sgemm_kernel", "ported",
              "tpkt_sgemm", _CSRC + "sgemm.cu",
              ("sgemm_split3", "sgemm_float32", "sgemm_bf16")),
    TpuKernel("B2", _K + "sgemm.py", 201, "_sgemm_pipelined_kernel",
              "ported", "tpkt_sgemm_pipelined", _CSRC + "sgemm_pipelined.cu",
              ("sgemm_pipelined_split3", "sgemm_pipelined_float32",
               "sgemm_pipelined_bf16")),
    TpuKernel("B3", _K + "stencil.py", 149, "_jacobi2d_small_kernel",
              "ported", "tpkt_jacobi2d_pass", _CSRC + "jacobi2d.cu",
              ("jacobi2d",)),
    TpuKernel("B4", _K + "stencil.py", 161, "_jacobi2d_blocked_kernel",
              "ported", "tpkt_jacobi2d_pass", _CSRC + "jacobi2d.cu",
              ("jacobi2d",)),
    TpuKernel("B5", _K + "stencil.py", 325, "_jacobi3d_small_kernel",
              "ported", "tpkt_jacobi3d_pass", _CSRC + "jacobi3d.cu",
              ("jacobi3d",)),
    TpuKernel("B6", _K + "stencil.py", 334, "_jacobi3d_blocked_kernel",
              "ported", "tpkt_jacobi3d_pass", _CSRC + "jacobi3d.cu",
              ("jacobi3d",)),
    TpuKernel("B7", _K + "vector_add.py", 62, "_saxpy_kernel", "ported",
              "tpkt_saxpy", _CSRC + "saxpy.cu", ("saxpy",)),
    TpuKernel("B8", _K + "scan.py", 149, "_scan_kernel", "ported",
              "tpkt_scan", _CSRC + "scan.cu", ("scan",)),
    TpuKernel("B9", _K + "histogram.py", 125, "_hist_mxu_kernel", "ported",
              "tpkt_histogram", _CSRC + "histogram.cu", ("histogram",)),
    TpuKernel("B10", _K + "histogram.py", 189, "_hist_kernel", "ported",
              "tpkt_histogram", _CSRC + "histogram.cu", ("histogram",)),
    TpuKernel("B11", _K + "scan_histogram.py", 71, "_fused_kernel",
              "ported", "tpkt_scan_histogram", _CSRC + "scan_histogram.cu",
              ("scan_histogram",)),
    TpuKernel("B12", _K + "nbody.py", 70, "_forces_kernel", "ported",
              "tpkt_nbody_forces", _CSRC + "nbody.cu",
              ("nbody_forces", "nbody_forces_ij")),
)

@dataclass(frozen=True)
class HelperKernel:
    port_entry: str
    source: str
    replaces: str  # what the reference does there, and where


# counter -> kernel. SGEMM's operand preparation: the bf16 split, the
# transposes and the row padding
HELPER_KERNELS = {
    "sgemm_prep": HelperKernel(
        "tpkt_sgemm_prep", _CSRC + "sgemm_prep.cu",
        _K + "sgemm.py:149 (_split_bf16 and the operand layout: XLA ops "
        "outside the TPU kernels)"),
}

# registry keys with a distributed twin in parallel/collectives.py, which
# ``registry.dispatch_mesh`` runs (the reference's tuple). Here, not in
# the registry, so that the serving daemon's admission
# (``serve/bucketing.mesh_tier_for``) reads it without loading torch
MESH_KERNELS = ("histogram", "nbody", "scan", "scan_exclusive",
                "stencil2d", "stencil3d")

LAUNCHES = {
    "saxpy": 0,
    "sgemm_prep": 0,
    "sgemm_split3": 0,
    "sgemm_float32": 0,
    "sgemm_bf16": 0,
    "sgemm_pipelined_split3": 0,
    "sgemm_pipelined_float32": 0,
    "sgemm_pipelined_bf16": 0,
    "jacobi2d": 0,
    "jacobi3d": 0,
    "nbody_forces": 0,
    "nbody_forces_ij": 0,
    "scan": 0,
    "histogram": 0,
    "scan_histogram": 0,
}


_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of ``name`` to ``LAUNCHES``."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        _PUBLISHED.clear()


_PUBLISHED: dict = {}  # name -> the count publish_launches last added


def publish_launches() -> None:
    """Add the launches since the last publish (or reset) to the
    ``kernel.launches.<name>`` counters. Runs at exit, and from
    ``capi.shutdown_from_c`` before a C host's exit flush: a C host never
    finalises its interpreter, so it never runs this exit hook."""
    with _LAUNCH_LOCK:
        counts = {k: n - _PUBLISHED.get(k, 0) for k, n in LAUNCHES.items()
                  if n > _PUBLISHED.get(k, 0)}
        _PUBLISHED.update((k, LAUNCHES[k]) for k in counts)
    for name, n in counts.items():
        metrics.inc(f"kernel.launches.{name}", n)


atexit.register(publish_launches)
