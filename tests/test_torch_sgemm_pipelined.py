"""The port's pipelined SGEMM path (depth 2/3) and its knobs, on the CPU.

The JAX side runs its pipelined Pallas kernel (``TPK_SGEMM_DEPTH=2|3``,
``TPK_SGEMM_BK=128``, ``TPK_SGEMM_ORDER=ji``) in interpret mode, as its
own tests do; the port runs under the matching ``TPKT_*`` knobs (its
k block, 64, for the reference's 128) and takes its plain version on
CPU tensors, after resolving and checking the knobs. That the CUDA
kernel gives the same bits at every depth and order, and the bits of
the depth-1 kernel, is checked on the card (``chip_smoke.py`` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sgemm import _operands, _tol
from tpukernels.kernels import sgemm as J
from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES, TPU_KERNELS
from tpukernels_torch.kernels import sgemm as S


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tcache"))
    for knob in ("BM", "BN", "BK", "DEPTH", "ORDER", "PRECISION"):
        monkeypatch.delenv(f"TPKT_SGEMM_{knob}", raising=False)


@pytest.mark.parametrize("precision", S.PRECISIONS)
@pytest.mark.parametrize("m,n,k", [(128, 256, 384), (100, 200, 300)])
@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_matches_jax(monkeypatch, depth, m, n, k, precision):
    a, b, c = _operands(m, n, k, seed=5)
    for env, val in (("SGEMM_DEPTH", depth), ("SGEMM_ORDER", "ji")):
        monkeypatch.setenv(f"TPK_{env}", str(val))
        monkeypatch.setenv(f"TPKT_{env}", str(val))
    monkeypatch.setenv("TPK_SGEMM_BK", "128")
    monkeypatch.setenv("TPKT_SGEMM_BK", "64")
    want = np.asarray(J.sgemm(1.5, jnp.asarray(a), jnp.asarray(b), 0.5,
                              jnp.asarray(c), precision=precision))
    ta, tb, tc = (torch.from_numpy(t) for t in (a, b, c))
    assert S.plan(m, n, k, precision, "cpu") == {
        "bm": 128, "bn": 64, "bk": 64, "depth": depth, "order": "ji"}
    got = S.sgemm(1.5, ta, tb, 0.5, tc, precision=precision)
    rtol, atol = _tol(precision, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("precision", S.PRECISIONS)
@pytest.mark.parametrize("m,n,k", [(100, 200, 300), (40, 72, 56),
                                   (33, 130, 300), (64, 96, 129)])
def test_pipelined_operands_hold_the_product(m, n, k, precision):
    """The operands both kernels are handed (bf16, B^T, rows padded
    with zeros to whole 16-byte chunks; ``float32`` its three pieces an
    operand, one after another) give the same product as the unpadded
    ones: the layout and the pad are right."""
    a, b, c = (torch.from_numpy(t) for t in _operands(m, n, k, seed=9))
    ops, kp = S.operands(a, b, precision)
    parts = 3 if precision == "float32" else 1
    assert kp == 8 * -(-k // 8)
    assert (tuple(ops[0].shape), tuple(ops[2].shape)) == ((parts * m, kp),
                                                          (parts * n, kp))
    for t in ops:
        if t is not None:
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
    f = [None if t is None else t.float() for t in ops]
    if precision == "float32":  # six products of the three pieces
        (a1, a2, a3), (b1, b2, b3) = f[0].view(3, m, -1), f[2].view(3, n, -1)
        acc = (a3 @ b1.t() + a1 @ b3.t() + a2 @ b2.t() + a2 @ b1.t()
               + a1 @ b2.t() + a1 @ b1.t())
    elif precision == "high":
        acc = f[0] @ f[2].t() + f[0] @ f[3].t() + f[1] @ f[2].t()
    else:
        acc = f[0] @ f[2].t()
    want = S.sgemm_plain(1.0, a, b, 0.0, torch.zeros_like(c), precision)
    torch.testing.assert_close(acc, want, rtol=1e-6, atol=1e-5)


def test_whole_rows_copies_only_when_needed():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert S._whole_rows(t, 4) is t
    p = S._whole_rows(t[:, :3], 4)
    assert p.shape == (3, 4) and torch.equal(p[:, :3], t[:, :3])
    assert not p[:, 3].any()
    assert S._whole_rows(t.t(), 4).is_contiguous()


@pytest.mark.parametrize("precision", S.PRECISIONS)
@pytest.mark.parametrize("depth,order", [(2, "ij"), (3, "ji")])
def test_pipelined_knobs_keep_the_cpu_result(monkeypatch, precision, depth,
                                             order):
    a, b, c = (torch.from_numpy(t) for t in _operands(40, 72, 56))
    base = S.sgemm(1.5, a, b, 0.5, c, precision=precision)
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", str(depth))
    monkeypatch.setenv("TPKT_SGEMM_ORDER", order)
    assert torch.equal(S.sgemm(1.5, a, b, 0.5, c, precision=precision), base)


@pytest.mark.parametrize("knob,bad", [("DEPTH", "abc"), ("DEPTH", "0"),
                                      ("DEPTH", "4"), ("ORDER", "kij"),
                                      ("BM", "-8"), ("BK", "x")])
def test_bad_pipeline_knobs_raise_with_the_variable(monkeypatch, knob, bad):
    a = torch.zeros(16, 16)
    monkeypatch.setenv(f"TPKT_SGEMM_{knob}", bad)
    with pytest.raises(ValueError, match=f"TPKT_SGEMM_{knob}"):
        S.sgemm(1.0, a, a, 0.0, a)


@pytest.mark.parametrize("precision", ["high", "float32"])
def test_knobs_over_the_smem_budget_raise_before_any_launch(monkeypatch,
                                                            precision):
    a = torch.zeros(16, 16)
    monkeypatch.setenv("TPKT_SGEMM_BM", "256")
    S.sgemm(1.0, a, a, 0.0, a, precision=precision)  # depth 1 fits
    # hi/lo pairs fit two stages of a 256-row preference; float32's three
    # pieces an operand do not
    over = {"high": 3, "float32": 2}[precision]
    for depth in range(2, over):
        monkeypatch.setenv("TPKT_SGEMM_DEPTH", str(depth))
        S.sgemm(1.0, a, a, 0.0, a, precision=precision)
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", str(over))
    with pytest.raises(ValueError,
                       match=f"TPKT_SGEMM_BM=256.*DEPTH={over}"):
        S.sgemm(1.0, a, a, 0.0, a, precision=precision)


def test_plan_picks_built_tiles(monkeypatch):
    # depth 1 (sgemm.cu) builds bm 128/64 x bn 128/64 x bk 64: 128 x 64
    # by default, 128 blocks at 1024^2
    assert S.plan(1024, 1024, 1024, device="cpu") == {
        "bm": 128, "bn": 64, "bk": 64, "depth": 1, "order": "ij"}
    # small or ragged dims: the least padding among the built tiles
    p = S.plan(40, 72, 56, device="cpu")
    assert (p["bm"], p["bn"], p["bk"]) == (64, 64, 64)
    monkeypatch.setenv("TPKT_SGEMM_BM", "64")
    monkeypatch.setenv("TPKT_SGEMM_BK", "64")
    monkeypatch.setenv("TPKT_SGEMM_BN", "256")
    p = S.plan(1024, 1024, 300, device="cpu")
    assert (p["bm"], p["bn"], p["bk"]) == (64, 128, 64)
    # a preference under the smallest tile gets the smallest
    monkeypatch.setenv("TPKT_SGEMM_BM", "8")
    assert S.plan(1024, 1024, 300, device="cpu")["bm"] == 64


def test_b2_row_counters_and_build():
    row = next(r for r in TPU_KERNELS if r.id == "B2")
    assert row.status == "ported" and row.port_entry == "tpkt_sgemm_pipelined"
    assert row.port_source == "tpukernels_torch/csrc/sgemm_pipelined.cu"
    assert set(row.launches) == {f"sgemm_pipelined_{s}"
                                 for s in ("split3", "float32", "bf16")}
    assert set(row.launches) <= set(LAUNCHES)
    assert "sgemm_pipelined" in _build.SOURCES
    src = (_build.CSRC / "sgemm_pipelined.cu").read_text()
    ring = (_build.CSRC / "sgemm_ring.cuh").read_text()
    assert '#include "sgemm_ring.cuh"' in src
    assert not (_build.CSRC / "sgemm.cuh").exists()
    for needle in ("_sgemm_pipelined_kernel", "tpkt_sgemm_pipelined",
                   "run<2>", "run<3>"):
        assert needle in src, needle
    # the shared header: the stage count a template parameter, TMA loads,
    # wgmma, each stage's group waited for (one in flight only as the
    # probe's variant)
    for needle in ("template <int MODE, int BM, int BN, int STAGES,",
                   "kk % STAGES", "(kk / STAGES) & 1", "tma_load_2d",
                   "wgmma_bf16<BN>", "wgmma_wait<IN_FLIGHT>",
                   "tpkt_allow_smem_once"):
        assert needle in ring, needle
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor.2d",
                   "wgmma.wait_group"):
        assert needle in hopper, needle
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in (
        _build.CSRC / "common.cuh").read_text()
    # the timing-only entry is reached by no wrapper
    assert "tpkt_sgemm_pipelined_probe" in src
    assert "_probe" not in (_build.CSRC.parent / "kernels"
                            / "sgemm.py").read_text()
    # the cp.async ring and mma.sync are gone
    for gone in ("cp.async.wait_group", "cp.async.cg", "mma.sync"):
        assert gone not in src + ring + hopper, gone


def test_b1_row_counters_and_build():
    """B1 (depth 1) is csrc/sgemm.cu: the kernel of sgemm_ring.cuh on two
    stages, TMA tile loads on full/empty mbarriers feeding wgmma (bf16
    modes) or fp32 FMAs, the tensor maps encoded through
    cudaGetDriverEntryPoint so that no library links against libcuda
    (no -lcuda)."""
    row = next(r for r in TPU_KERNELS if r.id == "B1")
    assert row.status == "ported" and row.port_entry == "tpkt_sgemm"
    assert row.port_source == "tpukernels_torch/csrc/sgemm.cu"
    assert set(row.launches) == {f"sgemm_{s}"
                                 for s in ("split3", "float32", "bf16")}
    assert set(row.launches) <= set(LAUNCHES)
    src = (_build.CSRC / "sgemm.cu").read_text()
    ring = (_build.CSRC / "sgemm_ring.cuh").read_text()
    both = src + ring + (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "sgemm_ring.cuh"' in src and "sgemm.cuh" not in src
    assert '#include "hopper.cuh"' in ring
    for needle in ("_sgemm_kernel", "STAGES = 2", "__grid_constant__",
                   "cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                   "mbarrier.arrive.expect_tx", "wgmma.mma_async",
                   "wgmma.commit_group", "wgmma.wait_group",
                   "CU_TENSOR_MAP_SWIZZLE_128B", "cudaGetDriverEntryPoint",
                   "cuTensorMapEncodeTiled", "tpkt_sgemm"):
        assert needle in both, needle
    assert not any("cuda" in f and f.startswith("-l")
                   for f in _build.NVCC_FLAGS)
