"""Port parity: tpukernels_torch 2-D Jacobi against the JAX reference (CPU).

The port's plain sweep sums ((N + S) + W) + E and then scales by 0.25,
the order of both JAX paths, so the two agree bitwise on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import stencil as JS
from tpukernels_torch.kernels import stencil as S


def _grid(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize(
    "shape,iters", [((64, 128), 3), ((33, 100), 5), ((16, 16), 10)]
)
def test_jacobi2d_small_matches_jax(shape, iters):
    x = _grid(shape)
    want = np.asarray(JS.jacobi2d(jnp.asarray(x), iters))
    got = S.jacobi2d(torch.from_numpy(x), iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,iters", [(1, 3), (8, 13), (8, 16)])
def test_jacobi2d_blocked_bitwise_equals_jax(k, iters):
    x = _grid((1024, 1536))
    want = np.asarray(JS.jacobi2d(jnp.asarray(x), iters, k=k))
    got = S.jacobi2d(torch.from_numpy(x), iters, k=k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_jacobi2d_boundary_held_fixed():
    x = _grid((40, 200))
    got = S.jacobi2d(torch.from_numpy(x), 7).numpy()
    for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got[edge], x[edge])
    assert not np.array_equal(got[1:-1, 1:-1], x[1:-1, 1:-1])


def test_jacobi2d_reference_matches_jax_reference():
    x = _grid((40, 200), seed=9)
    want = np.asarray(JS.jacobi2d_reference(jnp.asarray(x), 4))
    got = S.jacobi2d_reference(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("iters,k,plan", [
    (1000, 8, [8] * 125), (13, 8, [8, 5]), (13, 1, [1] * 13), (3, 8, [3]),
    (0, 8, []),
])
def test_passes_split_iters(iters, k, plan):
    assert S.passes(iters, k) == plan
    assert sum(S.passes(iters, k)) == iters


def test_resolve_k_clamps_and_reads_env(monkeypatch):
    assert S.resolve_k() == 8
    assert S.resolve_k(20) == 8
    assert S.resolve_k(0) == 1
    monkeypatch.setenv("TPKT_STENCIL_K", "3")
    assert S.resolve_k() == 3
    monkeypatch.setenv("TPKT_STENCIL_K", "-2")
    with pytest.raises(ValueError, match="TPKT_STENCIL_K"):
        S.resolve_k()


def test_jacobi2d_zero_iters_returns_copy():
    x = torch.from_numpy(_grid((8, 8)))
    out = S.jacobi2d(x, 0)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
