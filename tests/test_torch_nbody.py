"""Port parity: tpukernels_torch N-body against the JAX reference (CPU).

Band: rtol 1e-3, atol 2e-4 — the C golden checker's bar (rtol 2e-3,
atol 2e-4, c/nbody.c) tightened on rtol: on the CPU the port and JAX
compute the same pair terms and differ only in the order of the sums
over j (a gap below 1e-6 at these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import nbody as JN
from tpukernels_torch.kernels import nbody as N

RTOL, ATOL = 1e-3, 2e-4


def _bodies(n, seed=7):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(n).astype(np.float32) for _ in range(6)]
    return arrs + [rng.uniform(0.5, 1.5, n).astype(np.float32)]


def _jax(fn, arrs, **statics):
    return [np.asarray(a) for a in fn(*map(jnp.asarray, arrs), **statics)]


def _port(fn, arrs, **statics):
    return [t.numpy() for t in fn(*map(torch.from_numpy, arrs), **statics)]


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,steps", [(192, 1), (1000, 2)])
def test_nbody_step_matches_jax(n, steps):
    arrs = _bodies(n)
    _assert_close(_port(N.nbody_step, arrs, steps=steps),
                  _jax(JN.nbody_step, arrs, steps=steps))


@pytest.mark.parametrize("n,steps", [(192, 1), (1000, 2)])
def test_nbody_plain_matches_jax(n, steps):
    arrs = _bodies(n, seed=11)
    _assert_close(_port(N.nbody_plain, arrs, steps=steps, chunk=256),
                  _jax(JN.nbody_step, arrs, steps=steps))


def test_nbody_reference_matches_jax_reference():
    arrs = _bodies(300, seed=3)
    _assert_close(_port(N.nbody_reference, arrs, dt=2e-3, steps=2),
                  _jax(JN.nbody_reference, arrs, dt=2e-3, steps=2),
                  rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [1, 64, 333])
def test_chunked_plain_equals_unchunked(chunk):
    arrs = _bodies(1000, seed=5)
    whole = _port(N.nbody_plain, arrs, chunk=1000)
    for a, b in zip(_port(N.nbody_plain, arrs, chunk=chunk), whole):
        np.testing.assert_array_equal(a, b)
    # and the unchunked pairwise oracle, which rounds m·inv³ in another
    # order, within a few ulps
    _assert_close(whole, _port(N.nbody_reference, arrs), rtol=1e-5,
                  atol=1e-6)


def test_eps_zero_gives_nan_in_both():
    arrs = _bodies(192)
    port = _port(N.nbody_step, arrs, eps=0.0)
    jax_ = _jax(JN.nbody_step, arrs, eps=0.0)
    for p, j in zip(port, jax_):
        assert np.isnan(p).all() and np.isnan(j).all()


def test_nbody_leaves_inputs_unchanged_and_zero_steps_copies():
    ts = [torch.from_numpy(a) for a in _bodies(64)]
    before = [t.clone() for t in ts]
    out = N.nbody_step(*ts, steps=0)
    for o, t, b in zip(out, ts, before):
        assert torch.equal(o, t) and o.data_ptr() != t.data_ptr()
    N.nbody_step(*ts, steps=2)
    for t, b in zip(ts, before):
        assert torch.equal(t, b)


def test_nbody_rejects_bad_operands():
    ts = [torch.zeros(8) for _ in range(7)]
    with pytest.raises(ValueError, match="differ"):
        N.nbody_step(*ts[:6], torch.zeros(9))
    with pytest.raises(TypeError):
        N.nbody_step(*ts[:6], torch.zeros(8, dtype=torch.float64))
    with pytest.raises(TypeError):
        N.nbody_step(*ts[:6], torch.zeros(2, 4))


def test_nbody_tiles_read_env(monkeypatch):
    assert N._tiles() == (256, 2048)
    monkeypatch.setenv("TPKT_NBODY_BI", "128")
    monkeypatch.setenv("TPKT_NBODY_BJ", "512")
    assert N._tiles() == (128, 512)
    monkeypatch.setenv("TPKT_NBODY_BI", "100")
    with pytest.raises(ValueError, match="TPKT_NBODY_BI"):
        N._tiles()
    monkeypatch.setenv("TPKT_NBODY_BI", "256")
    monkeypatch.setenv("TPKT_NBODY_BJ", "4096")
    with pytest.raises(ValueError, match="TPKT_NBODY_BJ"):
        N._tiles()


# n of every shape class the plan meets: one body, fewer than a warp,
# a warp and either side of it, either side of a tile and of a block,
# ragged, the configuration of record and one past it
PLAN_NS = (1, 2, 31, 32, 33, 127, 128, 129, 1000, 4097, 65536, 65537)


def _owned(plan, n):
    """Every (i stored, by whom) of ``plan``: for each group, the
    i-bodies its threads hold and store, as plan_forces documents."""
    t = np.arange(plan.group_threads)
    k = np.arange(plan.r)
    local = (t[:, None] + k[None, :] * plan.group_threads).ravel()
    local = local[local < plan.bi]
    i = (np.arange(plan.grid)[:, None] * plan.bi + local[None, :]).ravel()
    return i[i < n]


@pytest.mark.parametrize("rs", N.RS_BUILT, ids=lambda rs: f"r{rs[0]}s{rs[1]}")
@pytest.mark.parametrize("n", PLAN_NS)
def test_plan_forces_covers_every_pair_once(n, rs):
    bi, bj = N._tiles()
    p = N.plan_forces(n, bi, bj, *rs)
    assert p.r == rs[0] and p.s <= rs[1] and (p.r, p.s) in N.RS_BUILT
    assert p.group_threads % 32 == 0 and p.group_threads * p.r >= p.bi
    assert p.threads == p.s * p.group_threads <= N.MAX_THREADS
    assert p.s * p.tile <= max(bj, p.s) and p.per % p.tile == 0
    # every i stored once: each group holds every i exactly once, and
    # the blocks' i-ranges are disjoint
    counts = np.bincount(_owned(p, n), minlength=n)
    assert counts.shape == (n,) and (counts == 1).all()
    assert (p.grid - 1) * p.bi < n <= p.grid * p.bi
    # every j walked once: the groups' ranges tile [0, n_pad), n_pad >= n
    ranges = p.j_ranges()
    assert len(ranges) == p.s and ranges[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert ranges[-1][1] == p.n_pad >= n
    assert p.n_pad - n < p.s * p.tile  # padding under one tile a group


def _pair_terms(xj, yj, zj, mj, px, py, pz, eps2):
    """(w·dx, w·dy, w·dz) of every (i, j): i along dim 0."""
    dx = xj[None, :] - px[:, None]
    dy = yj[None, :] - py[:, None]
    dz = zj[None, :] - pz[:, None]
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + eps2)
    wgt = mj[None, :] * inv * inv * inv
    return wgt * dx, wgt * dy, wgt * dz


def _forces_in_plan_order(px, py, pz, m, eps2, plan, pad=True,
                          sequential=False):
    """The kernel's sums in torch: the j-set padded to ``plan.n_pad``
    with mass-0 bodies at the origin, one partial sum over each group's
    j-range, the partials added in group order. ``pad=False`` cuts the
    ranges at n instead; ``sequential`` adds each group's terms one j
    after another, as a thread of the kernel does."""
    n = px.numel()
    xj, yj, zj, mj = (torch.cat([a, a.new_zeros(plan.n_pad - n)])
                      for a in (px, py, pz, m))
    assert not mj[n:].any()
    out = [torch.zeros(n) for _ in range(3)]
    for lo, hi in plan.j_ranges():
        hi = hi if pad else min(hi, n)
        part = [torch.zeros(n) for _ in range(3)]
        for i0 in range(0, n, 1024):  # i-rows a chunk: no (n, n) temporary
            rows = slice(i0, i0 + 1024)
            terms = _pair_terms(xj[lo:hi], yj[lo:hi], zj[lo:hi], mj[lo:hi],
                                px[rows], py[rows], pz[rows], eps2)
            for p, term in zip(part, terms):
                if sequential:
                    for j in range(hi - lo):
                        p[rows] += term[:, j]
                else:
                    p[rows] = term.sum(dim=1)
        for a, p in zip(out, part):
            a += p
    return tuple(out)


def _planned_step(arrs, plan, eps=1e-2):
    forces = lambda *a: _forces_in_plan_order(*a, plan=plan)  # noqa: E731
    return [t.numpy() for t in N._advance(
        forces, tuple(map(torch.from_numpy, arrs)), 1e-3, eps, 1)]


_JAX_STEPS = {}


def _jax_step(n):
    if n not in _JAX_STEPS:
        _JAX_STEPS[n] = _jax(JN.nbody_step, _bodies(n, seed=13))
    return _JAX_STEPS[n]


@pytest.mark.parametrize("rs", N.RS_BUILT, ids=lambda rs: f"r{rs[0]}s{rs[1]}")
@pytest.mark.parametrize("n", [1000, 4097])
def test_plan_order_matches_jax(n, rs):
    plan = N.plan_forces(n, *N._tiles(), *rs)
    _assert_close(_planned_step(_bodies(n, seed=13), plan), _jax_step(n))


@pytest.mark.parametrize("n", [33, 1001, 4097])
def test_plan_padding_contributes_nothing(n):
    """The padding's zero-mass bodies add exactly 0: the plan's sums
    equal, bit for bit, the same sums over the real bodies only."""
    arrs = [torch.from_numpy(a) for a in _bodies(n, seed=17)]
    plan = N.plan_forces(n, *N._tiles())
    assert plan.n_pad > n
    args = (arrs[0], arrs[1], arrs[2], arrs[6], N._eps2(1e-2), plan)
    for g, w in zip(_forces_in_plan_order(*args, sequential=True),
                    _forces_in_plan_order(*args, pad=False,
                                          sequential=True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rs", [(1, 4), (3, 2), (2, 3), (8, 8), (2, 16)])
def test_plan_forces_rejects_unbuilt_instantiations(rs):
    with pytest.raises(ValueError, match="no kernel"):
        N.plan_forces(4096, 256, 1024, *rs)
