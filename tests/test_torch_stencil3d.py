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
    monkeypatch.delenv("TPKT_STENCIL_K", raising=False)
    assert S.HALO3D_MAX == 8  # the reference's 1..8
    assert S.resolve_k(None, 3) == 4
    assert S.resolve_k(2, 3) == 2
    assert S.resolve_k(8, 3) == 8
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
    """The reference clamps ``depth`` to ``max(1, int(depth))``
    (``tpukernels/kernels/stencil.py:471``), so these values run as
    depth 1 there; the port clamps the same way and agrees bitwise, on
    a grid that takes the reference's blocked (depth-ringed) path."""
    assert S.resolve_depth(depth) == 1
    x = _grid((64, 64, 384))
    want = np.asarray(JS.jacobi3d(jnp.asarray(x), 3, k=2, depth=depth))
    got = S.jacobi3d(torch.from_numpy(x), 3, k=2, depth=depth).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, S.jacobi3d(torch.from_numpy(x), 3, k=2, depth=1).numpy())


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


# ------------------------------------------------------------------ #
# csrc/jacobi3d.cu's geometry (plan3d) and march, proved on the CPU    #
# ------------------------------------------------------------------ #

_SIXTH = np.float32(1.0 / 6.0)
H100_SMS = 132  # SMs of the H100 SXM, the card the plan is tuned on
H100_PCIE_SMS = 114


def _blocks(shape, sweeps, sms=H100_SMS):
    """Each block of ``plan3d``: its owned (planes, rows, columns) as
    ranges, and the loaded window's planes, rows and columns."""
    d, h, w = shape
    p = S.plan3d(d, h, w, sweeps, sms)
    wx, wy = S.window3d(sweeps)
    for bz in range(p.nz):
        z0, z1 = bz * p.seg, min((bz + 1) * p.seg, d)
        for by in range(p.ny):
            r0, r1 = by * p.rows, min((by + 1) * p.rows, h)
            for bx in range(p.nx):
                c0, c1 = bx * p.strip, min((bx + 1) * p.strip, w)
                yield ((z0, z1), (r0, r1), (c0, c1),
                       np.arange(z0 - sweeps, z1 + sweeps),
                       np.arange(wy) + r0 - sweeps,
                       np.arange(wx) + c0 - p.halo)


def _load(x, planes, rows, cols):
    d, h, w = x.shape
    zin, rin = (planes >= 0) & (planes < d), (rows >= 0) & (rows < h)
    cin = (cols >= 0) & (cols < w)
    win = np.zeros((planes.size, rows.size, cols.size), np.float32)
    win[np.ix_(zin, rin, cin)] = x[np.ix_(planes[zin], rows[rin], cols[cin])]
    return win


def _interior(n, idx):
    return (idx > 0) & (idx < n - 1)


def _pass_by_plan3d(x, sweeps):
    """One pass as ``csrc/jacobi3d.cu`` computes it, from ``plan3d``:
    each block's loaded window swept on its own (cells outside the grid
    0, the window's edge held, the interior test on the true (d, h, w)),
    and only its owned cells kept. NaN where no block owns a cell."""
    d, h, w = x.shape
    out = np.full_like(x, np.nan)
    for (z0, z1), (r0, r1), (c0, c1), planes, rows, cols in _blocks(
            x.shape, sweeps):
        win = _load(x, planes, rows, cols)
        upd = (_interior(d, planes)[1:-1, None, None]
               & _interior(h, rows)[None, 1:-1, None]
               & _interior(w, cols)[None, None, 1:-1])
        for _ in range(sweeps):
            mean = (((((win[:-2, 1:-1, 1:-1] + win[2:, 1:-1, 1:-1])
                       + win[1:-1, :-2, 1:-1]) + win[1:-1, 2:, 1:-1])
                     + win[1:-1, 1:-1, :-2]) + win[1:-1, 1:-1, 2:]) * _SIXTH
            win = win.copy()
            win[1:-1, 1:-1, 1:-1] = np.where(upd, mean, win[1:-1, 1:-1, 1:-1])
        s, hx = sweeps, c0 - cols[0]
        out[z0:z1, r0:r1, c0:c1] = win[s:s + z1 - z0, s:s + r1 - r0,
                                       hx:hx + c1 - c0]
    return out


def _pass_by_march(x, sweeps):
    """One pass as the kernel's threads march it, a block's window at a
    time: plane lo + t arrives at step t (0 past the window), level s
    moves to plane lo + t - s from level s-1's planes of the two steps
    before (slot t % 2 holds step t's plane) and the one made earlier in
    this step; planes 0 and d - 1 are tested only in the step pairs the
    kernel tests them in; level ``sweeps`` is kept at owned cells from
    step 2·sweeps on. Every value the kernel leaves unspecified (levels
    before their first plane, neighbours beyond the window) is NaN here,
    so an owned cell that read one comes out NaN."""
    d, h, w = x.shape
    s_ = sweeps
    out = np.full_like(x, np.nan)
    for (z0, z1), (r0, r1), (c0, c1), _, rows, cols in _blocks(x.shape,
                                                               sweeps):
        lo, hi, n = z0 - s_, z1 + s_, z1 - z0
        keep = _interior(h, rows)[:, None] & _interior(w, cols)[None, :]
        lv = np.full((s_, 2, rows.size, cols.size), np.nan, np.float32)
        a0 = b0 = a1 = b1 = 0
        if lo <= 0:
            a0, b0 = 1 - lo, s_ - lo + 1
        if hi >= d:
            a1, b1 = d - lo, d - lo + s_
        steps = n + 2 * s_
        for t in range(steps + steps % 2):
            par, pair = t % 2, t - t % 2
            zb = (pair + 2 > a0 and pair < b0) or (pair + 2 > a1 and pair < b1)
            pl = lo + t
            nw = _load(x, np.array([pl if max(lo, 0) <= pl < min(hi, d)
                                    else -1]), rows, cols)[0]
            for s in range(1, s_ + 1):
                q = lo + t - s
                a, m = lv[s - 1, par], lv[s - 1, 1 - par]
                nan_row = np.full((1, cols.size), np.nan, np.float32)
                nan_col = np.full((rows.size, 1), np.nan, np.float32)
                north = np.vstack([nan_row, m[:-1]])
                south = np.vstack([m[1:], nan_row])
                west = np.hstack([nan_col, m[:, :-1]])
                east = np.hstack([m[:, 1:], nan_col])
                v = (((((a + nw) + north) + south) + west) + east) * _SIXTH
                k = keep & (0 < q < d - 1) if zb else keep
                lv[s - 1, par] = nw
                nw = np.where(k, v, m)
            if 0 <= t - 2 * s_ < n:
                pr, pc = r0 - rows[0], c0 - cols[0]
                out[lo + t - s_, r0:r1, c0:c1] = nw[pr:pr + r1 - r0,
                                                    pc:pc + c1 - c0]
    return out


# shapes that stress the geometry: ragged in every dimension, d < 2k,
# 1- and 2-cell extents, widths not a multiple of V, several segments,
# strips and row tiles
_GEOMETRY_CASES = [
    *[((20, 70, 130), k, k) for k in range(1, 9)],  # every sweeps, one pass
    ((3, 40, 70), 8, 8), ((5, 33, 67), 6, 6),       # d < 2k
    ((1, 30, 70), 3, 8), ((2, 30, 70), 5, 5),       # 1 and 2 planes
    ((20, 1, 70), 3, 8), ((20, 2, 70), 4, 4),       # 1 and 2 rows
    ((20, 30, 1), 3, 8), ((20, 30, 2), 4, 4),       # 1 and 2 columns
    ((2, 2, 2), 4, 8), ((1, 1, 1), 2, 8),
    ((40, 66, 131), 8, 3),                         # 3 + 3 + 2, odd width
    ((70, 9, 20), 9, 4),                           # several segments
    ((33, 70, 130), 9, 5),                         # 5 then 4
]


@pytest.mark.parametrize("shape,iters,k", _GEOMETRY_CASES)
def test_jacobi3d_plan_windows_bitwise(shape, iters, k):
    """The kernel's geometry is exact: sweeping each window ``plan3d``
    loads and keeping its owned cells gives bitwise ``jacobi3d_plain``,
    pass after pass."""
    x = _grid(shape, seed=11)
    got = x
    for sweeps in S.passes(iters, k):
        got = _pass_by_plan3d(got, sweeps)
    want = S.jacobi3d_plain(torch.from_numpy(x), iters).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,iters,k", _GEOMETRY_CASES)
def test_jacobi3d_march_bitwise(shape, iters, k):
    """The kernel's march (levels lagging one plane each, two register
    slots a level, the plane tests only in the steps that reach plane 0
    or d - 1) stores only exact values: bitwise ``jacobi3d_plain``, with
    every unspecified value NaN."""
    x = _grid(shape, seed=13)
    got = x
    for sweeps in S.passes(iters, k):
        got = _pass_by_march(got, sweeps)
    want = S.jacobi3d_plain(torch.from_numpy(x), iters).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,iters", [(5, 9), (8, 16)])
def test_jacobi3d_plan_bitwise_equals_jax_blocked(k, iters):
    """The kernel's windows and the JAX package's blocked path (z-slabs
    with ghost planes, > 4 MiB) agree bitwise at deep fusion."""
    x = _grid((64, 64, 384), seed=17)
    got = x
    for sweeps in S.passes(iters, k):
        got = _pass_by_plan3d(got, sweeps)
    want = np.asarray(JS.jacobi3d(jnp.asarray(x), iters, k=k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        S.jacobi3d(torch.from_numpy(x), iters, k=k).numpy(), want)


@pytest.mark.parametrize("shape", [(384, 384, 384), (33, 70, 130),
                                   (5, 389, 1031), (1, 1, 1), (2, 2, 2),
                                   (70, 9, 20)])
@pytest.mark.parametrize("sweeps", range(1, 9))
@pytest.mark.parametrize("sms", [H100_SMS, H100_PCIE_SMS])
def test_jacobi3d_plan_owns_each_cell_once(shape, sweeps, sms):
    d, h, w = shape
    p = S.plan3d(d, h, w, sweeps, sms)
    wx, wy = S.window3d(sweeps)
    assert p.halo >= sweeps and p.halo % S.V == 0
    assert p.strip == wx - 2 * p.halo > 0 and p.rows == wy - 2 * sweeps > 0
    assert p.seg >= min(d, S.SEG3D_MIN)
    count = np.zeros(shape, np.int32)
    for (z0, z1), (r0, r1), (c0, c1), *_ in _blocks(shape, sweeps, sms):
        count[z0:z1, r0:r1, c0:c1] += 1
    assert (count == 1).all()
    # no block owns nothing
    assert ((p.nx - 1) * p.strip < w and (p.ny - 1) * p.rows < h
            and (p.nz - 1) * p.seg < d)


def test_jacobi3d_plan_fills_the_card_at_384():
    """384^3 at the default k: whole waves of blocks, one a SM of the
    H100's 132 (the last wave at least 95 % full), and the halo's
    redundancy that PERF.md states."""
    k = S.resolve_k(4, 3)
    p = S.plan3d(384, 384, 384, k, H100_SMS)
    assert p == (4, 56, 56, 48, 7, 7, 8)
    blocks = p.nx * p.ny * p.nz
    assert (blocks >= H100_SMS
            and blocks / (-(-blocks // H100_SMS) * H100_SMS) >= 0.95)
    wx, wy = S.window3d(k)
    assert round(wx * wy / (p.strip * p.rows), 3) == 1.306
    loaded = p.nx * wx * p.ny * wy * p.nz * (p.seg + 2 * k)
    assert round(loaded / 384 ** 3, 3) == 1.588


@pytest.mark.parametrize("skew", [0, 1])
def test_jacobi3d_plan_check_compares_kernel_plan(monkeypatch, skew):
    """The wrapper's check reads the kernel's own plan through its C
    entry and raises when it differs from ``plan3d``."""
    import ctypes

    def fake(name, symbol, argtypes):
        assert (name, symbol) == ("jacobi3d", "tpkt_jacobi3d_plan")

        def entry(d, h, w, sweeps, sms, addr):
            out = ctypes.cast(addr, ctypes.POINTER(ctypes.c_int))
            for i, v in enumerate(S.plan3d(d, h, w, sweeps, sms)):
                out[i] = v + (skew if i == 3 else 0)
            return 0
        return entry

    monkeypatch.setattr(S._build, "function", fake)
    S._plan3d_agrees.cache_clear()
    try:
        if skew:
            with pytest.raises(RuntimeError, match="plan3d"):
                S._plan3d_agrees(384, 384, 384, 4, H100_SMS)
        else:
            S._plan3d_agrees(384, 384, 384, 4, H100_SMS)
    finally:
        S._plan3d_agrees.cache_clear()


def test_stencil3d_knobs_are_the_references(monkeypatch, tmp_path):
    """``resolve_params`` has the reference's knob names, ``k`` and
    ``depth``, and reads ``TPKT_STENCIL_DEPTH``."""
    from tpukernels_torch import registry

    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("TPKT_STENCIL_K", raising=False)
    monkeypatch.delenv("TPKT_STENCIL_DEPTH", raising=False)
    want = JS.TUNABLES[1].defaults().keys()
    got = registry.resolve_params("stencil3d", (384, 384, 384), "float32",
                                  "cpu")
    assert set(got) == set(want) == {"k", "depth"}
    assert got == {"k": 4, "depth": 3}
    monkeypatch.setenv("TPKT_STENCIL_DEPTH", "2")
    assert registry.resolve_params("stencil3d")["depth"] == 2
    assert S.resolve_depth() == 2
    monkeypatch.setenv("TPKT_STENCIL_DEPTH", "0")
    with pytest.raises(ValueError, match="TPKT_STENCIL_DEPTH"):
        S.resolve_depth()


@pytest.mark.parametrize("depth,want", [(1, 1), (2, 2), (3, 3), (4, 3),
                                        (9, 3), (10 ** 6, 3)])
def test_resolve_depth_clamps_to_the_ring(depth, want):
    assert S.resolve_depth(depth) == want
