"""Port parity: tpukernels_torch SGEMM against the JAX reference (CPU).

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do on the CPU; the port runs its plain PyTorch version, which takes the
same bf16 split (``high``) or rounding (``default``) as the CUDA kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import sgemm as J
from tpukernels_torch.kernels import sgemm as S

SHAPES = [(128, 128, 128), (100, 200, 300), (40, 72, 56)]  # (m, n, k)


def _operands(m, n, k, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32),
            rng.standard_normal((m, n), dtype=np.float32))


def _tol(precision, k):
    # high: rtol 1e-4 / atol 1e-3 (3.8e-5 measured at 100x200x300);
    # float32: rtol 2e-5 / atol 2e-4, fp32-faithful;
    # default: the port rounds A and B to bf16, the JAX CPU backend
    # multiplies in full fp32, so the two differ by the bf16 band
    # S.contract states (its reason is there)
    if precision == "high":
        return 1e-4, 1e-3
    if precision == "float32":
        return 2e-5, 2e-4
    return S.contract("default", k, 1.5)


@pytest.mark.parametrize("precision", ["high", "float32", "default"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_sgemm_matches_jax(m, n, k, precision):
    a, b, c = _operands(m, n, k)
    want = np.asarray(J.sgemm(1.5, jnp.asarray(a), jnp.asarray(b), 0.5,
                              jnp.asarray(c), precision=precision))
    got = S.sgemm(1.5, torch.from_numpy(a), torch.from_numpy(b), 0.5,
                  torch.from_numpy(c), precision=precision)
    assert got.shape == (m, n) and got.dtype == torch.float32
    rtol, atol = _tol(precision, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_split_bf16_bitwise_equals_jax():
    a, _, _ = _operands(64, 8, 96, seed=3)
    a[0, :4] = [1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8), 3.0e38, 0.0]
    hi, lo = S._split_bf16(torch.from_numpy(a))
    jhi, jlo = J._split_bf16(jnp.asarray(a))
    np.testing.assert_array_equal(hi.float().numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))


def test_sgemm_bad_precision_raises(monkeypatch):
    a, b, c = (torch.from_numpy(t) for t in _operands(8, 8, 8))
    with pytest.raises(ValueError, match="precision="):
        S.sgemm(1.0, a, b, 0.0, c, precision="bf16_3x")
    monkeypatch.setenv("TPKT_SGEMM_PRECISION", "highest")
    with pytest.raises(ValueError, match="TPKT_SGEMM_PRECISION"):
        S.sgemm(1.0, a, b, 0.0, c)


def test_sgemm_precision_knob_selects_mode(monkeypatch):
    a, b, c = (torch.from_numpy(t) for t in _operands(40, 56, 72))
    monkeypatch.setenv("TPKT_SGEMM_PRECISION", "default")
    got = S.sgemm(1.5, a, b, 0.5, c)
    assert torch.equal(got, S.sgemm_plain(1.5, a, b, 0.5, c, "default"))
    assert not torch.equal(got, S.sgemm_plain(1.5, a, b, 0.5, c, "float32"))


@pytest.mark.parametrize("precision", ["high", "float32", "default"])
def test_sgemm_beta_zero_propagates_c_nans(precision):
    a, b, _ = _operands(128, 128, 128)
    c = np.full((128, 128), np.nan, np.float32)
    got = S.sgemm(1.0, torch.from_numpy(a), torch.from_numpy(b), 0.0,
                  torch.from_numpy(c), precision=precision)
    ref = J.sgemm_reference(1.0, jnp.asarray(a), jnp.asarray(b), 0.0,
                            jnp.asarray(c))
    assert torch.isnan(got).all() and np.isnan(np.asarray(ref)).all()


@pytest.mark.parametrize("precision", ["high", "float32", "default"])
def test_sgemm_plain_within_contract_of_oracle(precision):
    # C-golden-style [-1, 1) operands at a ragged shape
    rng = np.random.default_rng(11)
    a, b, c = (torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
               for s in ((33, 300), (300, 130), (33, 130)))
    got = S.sgemm_plain(1.5, a, b, 0.5, c, precision)
    want = S.sgemm_reference(1.5, a, b, 0.5, c)
    rtol, atol = S.contract(precision, 300, 1.5)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_sgemm_rejects_bad_shapes():
    a = torch.zeros(4, 5)
    with pytest.raises(ValueError):
        S.sgemm(1.0, a, torch.zeros(6, 3), 0.0, torch.zeros(4, 3))
    with pytest.raises(TypeError):
        S.sgemm(1.0, a.double(), torch.zeros(5, 3), 0.0, torch.zeros(4, 3))


@pytest.mark.parametrize("precision", ["high", "float32", "default"])
@pytest.mark.parametrize("m,n,k", [(100, 200, 300), (64, 96, 129),
                                   (33, 130, 300)])
def test_kernel_operands_give_the_jax_product(m, n, k, precision):
    """The operands both CUDA kernels take (``S.operands``: the bf16
    split or pieces, B^T, rows padded with zeros to whole 16 bytes), summed
    as the kernels sum them, give the JAX kernel's result within the
    parity band: the padding and the layout lose nothing."""
    a, b, c = _operands(m, n, k, seed=13)
    ops, kp = S.operands(torch.from_numpy(a), torch.from_numpy(b),
                         precision)
    assert kp == -(-k // 8) * 8
    f = [None if t is None else t.double() for t in ops]
    if precision == "float32":  # six products of the three pieces
        (a1, a2, a3), (b1, b2, b3) = f[0].view(3, m, -1), f[2].view(3, n, -1)
        acc = (a3 @ b1.t() + a1 @ b3.t() + a2 @ b2.t() + a2 @ b1.t()
               + a1 @ b2.t() + a1 @ b1.t())
    elif precision == "high":
        acc = f[0] @ f[2].t() + f[0] @ f[3].t() + f[1] @ f[2].t()
    else:
        acc = f[0] @ f[2].t()
    got = (1.5 * acc + 0.5 * torch.from_numpy(c).double()).float()
    want = np.asarray(J.sgemm(1.5, jnp.asarray(a), jnp.asarray(b), 0.5,
                              jnp.asarray(c), precision=precision))
    rtol, atol = _tol(precision, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
