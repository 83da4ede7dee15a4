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
    assert N._tiles() == (256, 1024)
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
