"""Port parity: tpukernels_torch 3-D Jacobi against the JAX reference (CPU).

The port's plain sweep sums ((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1
and then scales by 1/6, the order of both JAX paths, so the two agree
bitwise on the CPU: on the small path (grids up to 4 MiB) and on the
blocked path (z-slabs with ghost planes), at every k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import stencil as JS
from tpukernels_torch.kernels import stencil as S
from tpukernels_torch.resilience import integrity


def _grid(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("shape,iters,k", [
    ((8, 16, 128), 3, None),   # small path
    ((12, 10, 50), 4, None),   # small path, ragged
    ((64, 64, 384), 3, 2),     # blocked path (> 4 MiB)
    ((64, 64, 384), 9, 4),     # blocked, two full passes and a remainder
])
def test_jacobi3d_bitwise_equals_jax(shape, iters, k):
    x = _grid(shape)
    want = np.asarray(JS.jacobi3d(jnp.asarray(x), iters, k=k))
    got = S.jacobi3d(torch.from_numpy(x), iters, k=k)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_jacobi3d_canary_bitwise_equals_jax():
    (x,) = integrity.build_args("stencil3d")
    iters = integrity.CANARY_CONFIGS["stencil3d"]["statics"]["iters"]
    want = np.asarray(JS.jacobi3d(jnp.asarray(x), iters))
    got = S.jacobi3d(torch.from_numpy(x), iters)
    np.testing.assert_array_equal(got.numpy(), want)


def test_jacobi3d_reference_matches_jax_reference():
    x = _grid((8, 24, 132), seed=9)
    want = np.asarray(JS.jacobi3d_reference(jnp.asarray(x), 3))
    got = S.jacobi3d_reference(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_jacobi3d_plain_matches_port_reference():
    x = torch.from_numpy(_grid((11, 13, 17), seed=3))
    np.testing.assert_array_equal(S.jacobi3d_plain(x, 5).numpy(),
                                  S.jacobi3d_reference(x, 5).numpy())


def test_jacobi3d_boundary_held_fixed():
    x = _grid((10, 12, 30))
    got = S.jacobi3d(torch.from_numpy(x), 6).numpy()
    for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                 np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(got[face], x[face])
    assert not np.array_equal(got[1:-1, 1:-1, 1:-1], x[1:-1, 1:-1, 1:-1])


@pytest.mark.parametrize("iters,k,plan", [
    (8, 4, [4, 4]), (9, 4, [4, 4, 1]), (9, 1, [1] * 9), (3, 4, [3]),
    (0, 4, []),
])
def test_passes_split_iters_3d(iters, k, plan):
    assert S.passes(iters, k) == plan


def test_resolve_k_3d_clamps_to_the_halo_and_reads_env(monkeypatch):
    assert S.HALO3D_MAX == 4
    assert S.resolve_k(None, 3) == 3
    assert S.resolve_k(2, 3) == 2
    assert S.resolve_k(20, 3) == S.HALO3D_MAX
    assert S.resolve_k(0, 3) == 1
    assert S.resolve_k(None, 2) == 8  # 2-D keeps its own halo
    monkeypatch.setenv("TPKT_STENCIL_K", "2")
    assert S.resolve_k(None, 3) == 2
    monkeypatch.setenv("TPKT_STENCIL_K", "x")
    with pytest.raises(ValueError, match="TPKT_STENCIL_K"):
        S.resolve_k(None, 3)


@pytest.mark.parametrize("depth", [None, 1, 2, 3])
def test_jacobi3d_accepts_depth(depth):
    x = torch.from_numpy(_grid((6, 7, 9)))
    np.testing.assert_array_equal(
        S.jacobi3d(x, 3, depth=depth).numpy(), S.jacobi3d_plain(x, 3).numpy()
    )


@pytest.mark.parametrize("depth", [0, -1, 1.5, True])
def test_jacobi3d_rejects_bad_depth(depth):
    with pytest.raises(ValueError, match="depth"):
        S.jacobi3d(torch.zeros(4, 4, 4), 1, depth=depth)


def test_jacobi3d_rejects_bad_operands():
    with pytest.raises(TypeError):
        S.jacobi3d(torch.zeros(4, 4), 1)
    with pytest.raises(TypeError):
        S.jacobi3d(torch.zeros(4, 4, 4, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="negative"):
        S.jacobi3d(torch.zeros(4, 4, 4), -1)


def test_jacobi3d_zero_iters_returns_copy():
    x = torch.from_numpy(_grid((4, 5, 6)))
    out = S.jacobi3d(x, 0)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
