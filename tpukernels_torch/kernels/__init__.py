"""The reference's TPU kernels and where each stands in the port.

``TPU_KERNELS`` has one row per function in ``tpukernels/kernels/*.py``
that is handed to ``pl.pallas_call``, at the line of its ``def``.
A row is ``ported`` (naming the CUDA entry and its source under
``csrc/``) or ``pending`` (still to port; ROADMAP.md Queue B lists it).
``tests/test_torch_port_rules.py`` scans the reference's sources and
fails on a Pallas kernel without a row, or a row without a kernel.

``LAUNCHES`` counts, per CUDA kernel, the launches its wrapper made in
this process: each wrapper adds one where it launches and nowhere else.
``chip_smoke.py`` zeroes the counts before it drives the main path and
reads them after, to show the path went through the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
              "pending"),
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
              "tpkt_nbody_forces", _CSRC + "nbody.cu", ("nbody_forces",)),
)

LAUNCHES = {
    "saxpy": 0,
    "sgemm_split3": 0,
    "sgemm_float32": 0,
    "sgemm_bf16": 0,
    "jacobi2d": 0,
    "jacobi3d": 0,
    "nbody_forces": 0,
    "scan": 0,
    "histogram": 0,
    "scan_histogram": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
