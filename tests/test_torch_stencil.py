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


def _pass_by_plan(x, sweeps):
    """One pass as ``csrc/jacobi2d.cu`` computes it, from ``plan2d``: each
    warp's loaded window swept on its own (cells outside the grid 0, the
    window's edge held, the interior test on the true (h, w)), and only
    its owned cells kept. NaN where no warp owns a cell."""
    h, w = x.shape
    p = S.plan2d(h, w, sweeps)
    out = np.full_like(x, np.nan)
    for iy in range(p.ny):
        r0, r1 = iy * p.seg, min((iy + 1) * p.seg, h)
        rows = np.arange(r0 - sweeps, r1 + sweeps)
        for ix in range(p.nx):
            cols = np.arange(S.LOAD_W) + ix * p.strip - p.halo
            rin = (rows >= 0) & (rows < h)
            cin = (cols >= 0) & (cols < w)
            win = np.zeros((rows.size, cols.size), np.float32)
            win[np.ix_(rin, cin)] = x[np.ix_(rows[rin], cols[cin])]
            upd = (((rows > 0) & (rows < h - 1))[1:-1, None]
                   & ((cols > 0) & (cols < w - 1))[None, 1:-1])
            for _ in range(sweeps):
                mean = (((win[:-2, 1:-1] + win[2:, 1:-1]) + win[1:-1, :-2])
                        + win[1:-1, 2:]) * np.float32(0.25)
                win = win.copy()
                win[1:-1, 1:-1] = np.where(upd, mean, win[1:-1, 1:-1])
            c0, c1 = ix * p.strip, min((ix + 1) * p.strip, w)
            out[r0:r1, c0:c1] = win[sweeps:sweeps + r1 - r0,
                                    p.halo:p.halo + c1 - c0]
    return out


@pytest.mark.parametrize("shape,iters,k", [
    *[((70, 300), s, s) for s in range(1, 9)],  # every sweeps, one pass
    ((50, 260), 13, 8),    # the remainder pass: 8 then 5
    ((100, 500), 7, 3),    # segments and strips in both directions
    ((6, 4096), 8, 8),     # 4096-wide rows at small height
    ((3, 4096), 11, 8),
    ((37, 129), 9, 4),     # widths not a multiple of V
    ((20, 250), 5, 5),
    ((30, 50), 8, 8),      # narrower than one strip
    ((64, 7), 6, 6),
    ((1, 300), 3, 8), ((300, 1), 3, 8), ((2, 2), 4, 8),
    ((40, 200), 4, 8),     # B3's canary
    ((40, 200), 20, 8),
])
def test_jacobi2d_plan_windows_bitwise(shape, iters, k):
    """The kernel's geometry is exact: sweeping each window ``plan2d``
    loads and keeping its owned cells gives bitwise ``jacobi2d_plain``
    and the JAX package's ``jacobi2d``, pass after pass."""
    x = _grid(shape, seed=11)
    got = x
    for sweeps in S.passes(iters, k):
        got = _pass_by_plan(got, sweeps)
    want = S.jacobi2d_plain(torch.from_numpy(x), iters).numpy()
    np.testing.assert_array_equal(got, want)
    jax_out = np.asarray(JS.jacobi2d(jnp.asarray(x), iters, k=k))
    np.testing.assert_array_equal(got, jax_out)


@pytest.mark.parametrize("shape", [(4096, 4096), (1023, 1537), (5, 4099),
                                   (4099, 5), (40, 200), (1, 1), (2, 2)])
@pytest.mark.parametrize("sweeps", range(1, 9))
def test_jacobi2d_plan_owns_each_cell_once(shape, sweeps):
    h, w = shape
    p = S.plan2d(h, w, sweeps)
    assert p.halo >= sweeps and p.halo % S.V == 0
    assert p.strip == S.LOAD_W - 2 * p.halo > 0
    assert p.seg >= S.SEG_MIN
    count = np.zeros(shape, np.int32)
    for iy in range(p.ny):
        for ix in range(p.nx):
            count[iy * p.seg:(iy + 1) * p.seg,
                  ix * p.strip:(ix + 1) * p.strip] += 1
    assert (count == 1).all()
    # no warp owns nothing: the last strip and segment start inside
    assert (p.nx - 1) * p.strip < w and (p.ny - 1) * p.seg < h


def test_jacobi2d_plan_fills_the_card_at_4096():
    """4096^2 at k = 8: one wave of at least 8 warps on each of the
    H100's 132 SMs, and the redundancy the kernel's note states."""
    p = S.plan2d(4096, 4096, 8)
    assert (p.halo, p.strip, p.seg, p.nx, p.ny) == (8, 112, 147, 37, 28)
    assert 132 * 7 < p.nx * p.ny <= S.FILL_WARPS
    redundancy = S.LOAD_W / p.strip * (p.seg + 3 * 8) / p.seg
    assert round(redundancy, 2) == 1.33


@pytest.mark.parametrize("skew", [0, 1])
def test_jacobi2d_plan_check_compares_kernel_plan(monkeypatch, skew):
    """The wrapper's check reads the kernel's own plan through its C
    entry and raises when it differs from ``plan2d``."""
    import ctypes

    def fake(name, symbol, argtypes):
        assert (name, symbol) == ("jacobi2d", "tpkt_jacobi2d_plan")

        def entry(h, w, sweeps, addr):
            out = ctypes.cast(addr, ctypes.POINTER(ctypes.c_int))
            for i, v in enumerate(S.plan2d(h, w, sweeps)):
                out[i] = v + (skew if i == 2 else 0)
            return 0
        return entry

    monkeypatch.setattr(S._build, "function", fake)
    S._plan_agrees.cache_clear()
    try:
        if skew:
            with pytest.raises(RuntimeError, match="plan2d"):
                S._plan_agrees(4096, 4096, 8)
        else:
            S._plan_agrees(4096, 4096, 8)
    finally:
        S._plan_agrees.cache_clear()
