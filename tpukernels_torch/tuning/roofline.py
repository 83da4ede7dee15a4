"""Analytic per-kernel rooflines of the bench's metrics on the H100.

The port's copy of ``tpukernels/tuning/roofline.py``. For each bench
metric it states, as plain arithmetic over the configuration of record,
(a) the operations one metric pass executes, (b) the least device-memory
bytes it must move and (c) which peak binds, so the analytic peak of the
metric is

    peak = work / max(operations / compute_peak, bytes / memory_rate)

and every persisted bench line gets a "% of roofline". ``obs/trend.py``
turns a fraction under :func:`min_frac` (``TPKT_ROOFLINE_MIN_FRAC``,
default 0.5) into the non-gating ``below_roofline`` verdict; ``python -m
tpukernels_torch.obs.report --roofline`` prints the table.

Two yardsticks live here, and they differ on purpose:

- :func:`peak`, the roofline: the reference's byte and work formulas. The
  stencil models divide each sweep's 8 bytes a cell by the temporal depth
  of record (k = 8), so their peak is the passes' memory floor (the 2-D
  Jacobi's 5.0081 ms for 1000 sweeps on the H100);
- :func:`ceilings`, the bench's ceiling (``bench.ceilings``): each
  metric's work over the least time of one iteration of the call of
  record, each input read once and each output written once (the 2-D
  Jacobi's bound is its operations, 1.2508 ms for 1000 sweeps). A capture
  above it is invalidated, so no roofline peak may exceed it.

Peaks are per canonical device kind. The evidence kind is ``h100``, the
card the port's bench lines come from (``TPKT_ROOFLINE_DEVICE`` judges
against another row); the CPU row holds order-of-magnitude figures so the
plumbing runs anywhere, never evidence. An unknown ``h100*`` kind borrows
the H100 row (``basis`` says so), anything else the CPU row. Standard
library only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

from tpukernels_torch.resilience import journal

DEFAULT_MIN_FRAC = 0.5  # below this fraction of the roofline: a verdict

# Published dense peaks of one H100 SXM (NVIDIA H100 Tensor Core GPU
# data sheet, SXM column, without sparsity; at its 700 W limit): bf16
# tensor-core flop/s, fp32 flop/s outside the tensor cores, int32 at half
# of fp32 (Hopper issues int32 on 64 of each SM's 128 lanes), and device
# memory GB/s. ``passes_f32`` is the bf16 products a float32 SGEMM of the
# precision of record (``high``) takes.
PEAKS = {
    "h100": {
        "tensor_flops": 989e12,
        "passes_f32": 3,
        "fp32_ops": 67e12,
        "int32_ops": 33.5e12,
        "hbm_gb_s": 3350.0,
    },
    # plumbing only: a single core's order of magnitude, never evidence
    "cpu": {
        "tensor_flops": 100e9,
        "passes_f32": 1,
        "fp32_ops": 50e9,
        "int32_ops": 50e9,
        "hbm_gb_s": 20.0,
    },
}

EVIDENCE_KIND = "h100"

# bf16 products an SGEMM of each precision makes (kernels/sgemm.py)
PRODUCTS = {"high": 3, "float32": 6, "default": 1}


def resolve_kind(kind=None):
    """(peaks_row, requested_kind, basis) for a device kind string, by
    default ``TPKT_ROOFLINE_DEVICE`` or :data:`EVIDENCE_KIND`. basis:
    ``exact`` (a :data:`PEAKS` row), ``assumed-h100`` (another H100
    spelling) or ``cpu-fallback``."""
    if kind is None:
        kind = os.environ.get("TPKT_ROOFLINE_DEVICE") or EVIDENCE_KIND
    if kind in PEAKS:
        return PEAKS[kind], kind, "exact"
    if kind.startswith(EVIDENCE_KIND):
        return PEAKS[EVIDENCE_KIND], kind, f"assumed-{EVIDENCE_KIND}"
    return PEAKS["cpu"], kind, "cpu-fallback"


def min_frac() -> float:
    """The ``below_roofline`` threshold: ``TPKT_ROOFLINE_MIN_FRAC``,
    default 0.5; anything outside [0, 1] raises."""
    raw = os.environ.get("TPKT_ROOFLINE_MIN_FRAC")
    if raw is None:
        return DEFAULT_MIN_FRAC
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not 0.0 <= val <= 1.0:
        raise ValueError(
            f"TPKT_ROOFLINE_MIN_FRAC={raw!r}: expected a float in [0, 1]")
    return val


def sgemm_hbm_bytes(m: int, n: int, k: int) -> float:
    """Least device-memory traffic of an SGEMM: A and B read once, C read
    and the output written once, float32: 4·(m·k + k·n + 2·m·n)."""
    return 4.0 * (m * k + k * n + 2 * m * n)


@dataclass(frozen=True)
class RooflineModel:
    """The roofline of one bench metric at its configuration of record.

    ``flops``/``hbm_bytes``/``work`` are functions of the configuration
    tuple: the operations of one metric pass, its least memory bytes, and
    the metric's numerator (metric = work / seconds). ``compute`` names
    the peak the operations run against: ``tensor_f32`` (float32 operands
    as ``passes_f32`` bf16 products), ``tensor`` (one bf16 product),
    ``fp32`` or ``int32``. ``artifact`` marks a configuration that beats
    the memory roofline by design (an L2-resident working set): reported,
    never given a verdict."""

    metric: str
    kernel: str
    config: tuple
    flops: Callable
    hbm_bytes: Callable
    work: Callable
    compute: str = "fp32"
    artifact: bool = False
    note: str = ""


MODELS = {
    "sgemm_gflops": RooflineModel(
        metric="sgemm_gflops",
        kernel="sgemm",
        config=(1024, 1024, 1024),
        flops=lambda m, n, k: 2.0 * m * n * k,
        hbm_bytes=sgemm_hbm_bytes,
        work=lambda m, n, k: 2.0 * m * n * k / 1e9,
        compute="tensor_f32",
        note="high: the metric's flops run as 3 bf16 tensor-core products",
    ),
    # 2^20 float32 x and y, 8 MiB, stay in the 50 MB L2 across the chain:
    # a measured rate may pass the memory roofline
    "saxpy_gb_s": RooflineModel(
        metric="saxpy_gb_s",
        kernel="vector_add",
        config=(1 << 20,),
        flops=lambda n: 2.0 * n,
        hbm_bytes=lambda n: 12.0 * n,  # read x, read y, write y
        work=lambda n: 12.0 * n / 1e9,  # the metric is GB moved
        artifact=True,
        note="L2-resident configuration of record; passes the memory "
             "roofline by design (see saxpy_stream_gb_s)",
    ),
    "saxpy_stream_gb_s": RooflineModel(
        metric="saxpy_stream_gb_s",
        kernel="vector_add",
        config=(1 << 26,),
        flops=lambda n: 2.0 * n,
        hbm_bytes=lambda n: 12.0 * n,
        work=lambda n: 12.0 * n / 1e9,
    ),
    # a cell a sweep: 4 neighbour adds, 1 scale, 1 boundary select; 8 B
    # a cell a sweep divided by the temporal depth of record
    "stencil2d_mcells_s": RooflineModel(
        metric="stencil2d_mcells_s",
        kernel="stencil2d",
        config=(4096, 4096),
        flops=lambda h, w: 6.0 * h * w,
        hbm_bytes=lambda h, w: 8.0 * h * w / 8.0,
        work=lambda h, w: h * w / 1e6,
        note="a sweep at temporal depth k = 8",
    ),
    # 5 neighbour adds, 1 scale, 1 select, ~1 mask: 8 operations a cell
    "stencil3d_mcells_s": RooflineModel(
        metric="stencil3d_mcells_s",
        kernel="stencil3d",
        config=(384, 384, 384),
        flops=lambda d, h, w: 8.0 * d * h * w,
        hbm_bytes=lambda d, h, w: 8.0 * d * h * w / 8.0,
        work=lambda d, h, w: d * h * w / 1e6,
        note="a sweep at temporal depth k = 8",
    ),
    # 20 float32 operations a pair; 7 arrays of n floats
    "nbody_ginter_s": RooflineModel(
        metric="nbody_ginter_s",
        kernel="nbody",
        config=(65536,),
        flops=lambda n: 20.0 * n * n,
        hbm_bytes=lambda n: 28.0 * n,
        work=lambda n: n * n / 1e9,
    ),
    # the unfused pass of record: the scan reads and writes its array and
    # the histogram reads it again, 12 B an element
    "scan_hist_melem_s": RooflineModel(
        metric="scan_hist_melem_s",
        kernel="scan",
        config=(1 << 22, 256),
        flops=lambda n, nbins: 3.0 * n,
        hbm_bytes=lambda n, nbins: 12.0 * n,
        work=lambda n, nbins: n / 1e6,
        compute="int32",
        note="bound by bytes; 3 int32 operations an element (the scan's "
             "add, the bin's address and its increment) where the TPU "
             "model counts 1536 flops of MXU scan and nibble-count "
             "matmuls; the fused pass (TPKT_SCANHIST_FUSE=on) moves "
             "8 B an element",
    ),
}

# registry kernel -> the metric whose model covers it
KERNEL_METRIC = {
    "vector_add": "saxpy_gb_s",
    "sgemm": "sgemm_gflops",
    "stencil2d": "stencil2d_mcells_s",
    "stencil3d": "stencil3d_mcells_s",
    "scan": "scan_hist_melem_s",
    "histogram": "scan_hist_melem_s",
    "scan_histogram": "scan_hist_melem_s",
    "nbody": "nbody_ginter_s",
}


def _compute_peak(row: dict, compute: str) -> float:
    if compute == "tensor_f32":
        return row["tensor_flops"] / row["passes_f32"]
    if compute == "tensor":
        return row["tensor_flops"]
    if compute == "int32":
        return row["int32_ops"]
    return row["fp32_ops"]


def peak(metric: str, kind=None) -> dict:
    """The roofline of one metric on one device kind: ``{metric, kernel,
    peak, bound, flops, hbm_bytes, device_kind, basis, artifact, note}``,
    ``peak`` in the metric's own unit, ``bound`` the binding leg
    (``compute`` or ``bandwidth``)."""
    model = MODELS[metric]
    row, rkind, basis = resolve_kind(kind)
    f = model.flops(*model.config)
    b = model.hbm_bytes(*model.config)
    w = model.work(*model.config)
    t_compute = f / _compute_peak(row, model.compute)
    t_bw = b / (row["hbm_gb_s"] * 1e9)
    t = max(t_compute, t_bw)
    return {
        "metric": metric,
        "kernel": model.kernel,
        "peak": w / t,
        "bound": "compute" if t_compute >= t_bw else "bandwidth",
        "flops": f,
        "hbm_bytes": b,
        "device_kind": rkind,
        "basis": basis,
        "artifact": model.artifact,
        "note": model.note,
    }


def ceilings(precision=None) -> dict:
    """Each bench metric's ceiling on the H100: its work over the least
    time of one iteration of the call of record, the larger of the bytes
    it must move over the memory rate and its operations over the peak of
    their type. SGEMM 1024^3 counts the bf16 products of ``precision``
    (``TPKT_SGEMM_PRECISION``, default ``high``: 3); scan + histogram
    2^22 reads x and writes the scan and the next x, 12 B an element, 3
    int32 operations; N-body 20 flops a pair; the stencils take the bound
    of the call of record (2-D 4096^2 x 1000 sweeps, 3-D 384^3 x 8) a
    sweep; SAXPY 2^26 12 B an element. ``saxpy_gb_s`` (2^20,
    L2-resident) has none."""
    if precision is None:
        precision = os.environ.get("TPKT_SGEMM_PRECISION") or "high"
    products = PRODUCTS.get(precision, 1)
    row = PEAKS[EVIDENCE_KIND]
    bw = row["hbm_gb_s"] * 1e9
    bf16, fp32, int32 = row["tensor_flops"], row["fp32_ops"], row["int32_ops"]

    def bound(nbytes, ops, rate):
        return max(nbytes / bw, ops / rate)

    m, n2, n3, nb, ns, nh = 1024, 4096, 384, 65536, 1 << 26, 1 << 22
    t = {
        "sgemm_gflops": (2.0 * m**3 / 1e9,
                         bound(16 * m * m, products * 2 * m**3, bf16)),
        "scan_hist_melem_s": (nh / 1e6, bound(12 * nh, 3 * nh, int32)),
        "nbody_ginter_s": (nb * nb / 1e9,
                           bound(4 * 13 * nb, 20 * nb * nb, fp32)),
        "stencil2d_mcells_s": (n2 * n2 / 1e6, bound(
            8 * n2 * n2, 5 * (n2 - 2) ** 2 * 1000, fp32) / 1000),
        "saxpy_stream_gb_s": (12 * ns / 1e9, bound(12 * ns, 2 * ns, fp32)),
        "stencil3d_mcells_s": (n3**3 / 1e6, bound(
            8 * n3**3, 6 * (n3 - 2) ** 3 * 8, fp32) / 8),
    }
    return {k: round(work / secs, 1) for k, (work, secs) in t.items()}


def report_rows(verdicts=None, kind=None) -> list:
    """One row a modeled metric, the achieved value joined in from a
    ``trend.analyze`` verdict table (``achieved``/``frac`` None for a
    metric with no data), each beside its bench ceiling
    (``ceiling``/``ceiling_frac``, None for the L2-resident SAXPY).
    Emits one ``roofline_computed`` journal event, so a traced session
    records which peaks the table was judged against."""
    lim = ceilings()
    rows = []
    for metric in sorted(MODELS):
        p = peak(metric, kind)
        v = (verdicts or {}).get(metric) or {}
        achieved = v.get("latest")
        ceiling = lim.get(metric)
        rows.append({
            **p,
            "achieved": achieved,
            "frac": achieved / p["peak"] if achieved else None,
            "ceiling": ceiling,
            "ceiling_frac": (achieved / ceiling
                             if achieved and ceiling else None),
            "verdict": v.get("verdict"),
        })
    journal.emit(
        "roofline_computed",
        device_kind=rows[0]["device_kind"] if rows else None,
        basis=rows[0]["basis"] if rows else None,
        min_frac=min_frac(),
        metrics={
            r["metric"]: {
                "peak": round(r["peak"], 1),
                "frac": (round(r["frac"], 3) if r["frac"] is not None
                         else None),
                "bound": r["bound"],
            }
            for r in rows
        },
    )
    return rows
