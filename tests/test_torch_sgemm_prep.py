"""SGEMM's operand preparation on the CPU: ``operands_plain`` (the plain
version of ``csrc/sgemm_prep.cu``) against the JAX package's
``_split_bf16`` and zero padding on the same numpy inputs, bit for bit;
the layouts of all three modes at ragged m, n and k; and SGEMM at depth
1/2/3 against the JAX kernels in interpret mode.

That the CUDA kernel writes the same bits as ``operands_plain`` is
checked on the card (``chip_smoke.py`` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sgemm import _operands, _tol
from tpukernels.kernels import sgemm as J
from tpukernels_torch import _build
from tpukernels_torch.kernels import HELPER_KERNELS, LAUNCHES
from tpukernels_torch.kernels import sgemm as S

# (m, n, k): whole, ragged k (k % 8 != 0), ragged m and n (% 4 != 0)
SHAPES = [(128, 128, 128), (100, 200, 300), (64, 96, 129), (33, 130, 300),
          (5, 3, 7), (1, 1, 1)]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tcache"))
    for knob in ("BM", "BN", "BK", "DEPTH", "ORDER", "PRECISION"):
        monkeypatch.delenv(f"TPKT_SGEMM_{knob}", raising=False)


def _bits(t):
    """A bf16 or float32 tensor as its raw bytes."""
    return t.contiguous().view(torch.uint8).numpy()


def _jax_bits(x):
    return np.asarray(x).view(np.uint8)


def _pad_cols(x, mult):
    width = -(-x.shape[1] // mult) * mult
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, width - x.shape[1])))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_high_operands_are_the_jax_split_bitwise(m, n, k):
    """A hi/lo (m, kp) and B^T hi/lo (n, kp): the JAX package's
    ``_split_bf16`` of the zero-padded matrices, bit for bit."""
    a, b, _ = _operands(m, n, k, seed=21)
    a[0, 0], b[0, 0] = 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8)  # ties
    ops, kp = S.operands_plain(torch.from_numpy(a), torch.from_numpy(b),
                               "high")
    assert kp == -(-k // 8) * 8
    want = (*J._split_bf16(_pad_cols(a, 8)), *J._split_bf16(_pad_cols(b.T, 8)))
    for got, w, rows in zip(ops, want, (m, m, n, n)):
        assert tuple(got.shape) == (rows, kp) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _jax_bits(w))
        assert not got[:, k:].float().any()  # the pad columns are zeros


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_default_operands_are_the_jax_rounding_bitwise(m, n, k):
    a, b, _ = _operands(m, n, k, seed=22)
    ops, kp = S.operands_plain(torch.from_numpy(a), torch.from_numpy(b),
                               "default")
    assert ops[1] is None and ops[3] is None and kp == -(-k // 8) * 8
    for got, src in ((ops[0], a), (ops[2], b.T)):
        want = _pad_cols(src, 8).astype(jnp.bfloat16)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_bits(got), _jax_bits(want))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_float32_operands_are_three_bf16_pieces_an_operand(m, n, k):
    """The pieces of A one after another (3m, kp) and those of B^T (3n,
    kp): each the remainder so far rounded to bf16, as jnp rounds it; the
    first two are the JAX package's ``_split_bf16``; together they hold
    the float32 value exactly (24 bits in 3 x 8)."""
    a, b, _ = _operands(m, n, k, seed=23)
    ops, kp = S.operands_plain(torch.from_numpy(a), torch.from_numpy(b),
                               "float32")
    assert ops[1] is None and ops[3] is None and kp == -(-k // 8) * 8
    for got, src, rows in ((ops[0], a, m), (ops[2], b.T, n)):
        assert tuple(got.shape) == (3 * rows, kp)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        x = _pad_cols(src, 8)
        want, rest = [], x
        for _ in range(3):
            want.append(rest.astype(jnp.bfloat16))
            rest = rest - want[-1].astype(jnp.float32)
        hi, lo = J._split_bf16(x)
        np.testing.assert_array_equal(_jax_bits(want[0]), _jax_bits(hi))
        np.testing.assert_array_equal(_jax_bits(want[1]), _jax_bits(lo))
        for i, w in enumerate(want):
            np.testing.assert_array_equal(
                _bits(got[i * rows:(i + 1) * rows]), _jax_bits(w))
        total = got.float().view(3, rows, kp).sum(0)
        np.testing.assert_array_equal(total.numpy(), np.asarray(x))


@pytest.mark.parametrize("precision", S.PRECISIONS)
def test_operands_of_views_equal_operands_of_copies(precision):
    """A and B given as views that are not contiguous (a transpose, every
    other column) give the operands of their contiguous copies."""
    rng = np.random.default_rng(24)
    big = torch.from_numpy(rng.standard_normal((66, 2 * 45),
                                               dtype=np.float32))
    a = big[:, ::2]                                           # (66, 45)
    b = torch.from_numpy(rng.standard_normal((38, 45),
                                             dtype=np.float32)).t()
    got, kp = S.operands_plain(a, b, precision)
    want, wkp = S.operands_plain(a.contiguous(), b.contiguous(), precision)
    assert kp == wkp
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("precision", S.PRECISIONS)
def test_operands_on_the_cpu_is_the_plain_version(monkeypatch, precision):
    """On CPU tensors ``operands`` is ``operands_plain``: no launch is
    counted and nothing is built."""
    monkeypatch.setattr(_build, "function", lambda *a: pytest.fail(
        "a CPU tensor reached the CUDA library"))
    a, b, _ = (torch.from_numpy(t) for t in _operands(40, 72, 56))
    before = LAUNCHES["sgemm_prep"]
    got, kp = S.operands(a, b, precision)
    want, wkp = S.operands_plain(a, b, precision)
    assert kp == wkp and LAUNCHES["sgemm_prep"] == before
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_prep_kernel_is_registered_and_built():
    """The helper kernel has a counter, a source that ``_build`` compiles
    and no row among the TPU kernels; its source rounds as
    ``_split_bf16`` does and stores 16 bytes at a time."""
    helper = HELPER_KERNELS["sgemm_prep"]
    assert helper.port_entry == "tpkt_sgemm_prep"
    assert helper.source == "tpukernels_torch/csrc/sgemm_prep.cu"
    assert "sgemm_prep" in LAUNCHES and "sgemm_prep" in _build.SOURCES
    src = (_build.CSRC / "sgemm_prep.cu").read_text()
    for needle in ("tpkt_sgemm_prep", "__float2bfloat16_rn",
                   "__bfloat162float", "uint4", "PIECES", "__shared__",
                   "TILE + 1", "_split_bf16", "cudaGetLastError"):
        assert needle in src, needle
    assert "tpukernels_torch/csrc/sgemm_prep.cu" in S.TUNABLES.sources
    assert "tpukernels_torch/csrc/sgemm_ring.cuh" in S.TUNABLES.sources
    assert len(S._PREP_ARGTYPES) == 17


@pytest.mark.parametrize("precision", S.PRECISIONS)
@pytest.mark.parametrize("depth", S.DEPTHS)
def test_sgemm_every_depth_matches_jax(monkeypatch, depth, precision):
    """SGEMM at depth 1/2/3 against the JAX package's kernel at the same
    depth in interpret mode; tolerance ``_tol`` (high rtol 1e-4 / atol
    1e-3, float32 rtol 2e-5 / atol 2e-4, default ``S.contract``)."""
    m, n, k = 100, 136, 200
    a, b, c = _operands(m, n, k, seed=25)
    monkeypatch.setenv("TPK_SGEMM_DEPTH", str(depth))
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", str(depth))
    if depth > 1:
        monkeypatch.setenv("TPK_SGEMM_BK", "128")
    want = np.asarray(J.sgemm(1.5, jnp.asarray(a), jnp.asarray(b), 0.5,
                              jnp.asarray(c), precision=precision))
    assert S.plan(m, n, k, precision, "cpu")["depth"] == depth
    got = S.sgemm(1.5, *(torch.from_numpy(t) for t in (a, b)), 0.5,
                  torch.from_numpy(c), precision=precision)
    rtol, atol = _tol(precision, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_depths_share_one_tile_set_and_two_stages_at_depth_1_and_2():
    """Depth 1 and 2 select the same two-stage instantiation: the same
    tiles and the same shared memory; depth 3 adds a stage."""
    assert S.TILES[1] == S.TILES[2] == ((128, 64), (128, 64), (64,))
    knobs = {"bm": 128, "bn": 64, "bk": 64}
    for precision in S.PRECISIONS:
        two = S._smem_bytes({**knobs, "depth": 1}, precision=precision)
        assert two == S._smem_bytes({**knobs, "depth": 2},
                                    precision=precision)
        three = S._smem_bytes({**knobs, "depth": 3}, precision=precision)
        assert three - two == (two - 1024 - 32) // 2 + 16
