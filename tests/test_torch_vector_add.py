"""Port parity: tpukernels_torch SAXPY against the JAX reference (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels.vector_add import saxpy as jax_saxpy
from tpukernels_torch.kernels import vector_add as V
from tpukernels_torch.tuning import resolve


# rtol 1e-6 / atol 1e-7: both sides compute alpha*x + y in float32; at
# most one rounding (a fused multiply-add on one side) separates them
@pytest.mark.parametrize("n", [1, 1000, 4097, 1 << 16])
def test_saxpy_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n, dtype=np.float32)
    y = rng.standard_normal(n, dtype=np.float32)
    want = np.asarray(jax_saxpy(0.7, jnp.asarray(x), jnp.asarray(y)))
    got = V.saxpy(0.7, torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_saxpy_returns_new_tensor_and_leaves_y():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(300, dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal(300, dtype=np.float32))
    y0 = y.clone()
    out = V.saxpy(2.0, x, y)
    assert out.data_ptr() != y.data_ptr()
    assert torch.equal(y, y0)


def test_saxpy_of_no_elements_is_empty():
    # a divergence by design: the port returns an empty result, where
    # the reference's tile arithmetic divides by zero
    out = V.saxpy(0.7, torch.zeros(0), torch.zeros(0))
    assert out.shape == (0,) and out.dtype == torch.float32
    with pytest.raises(ZeroDivisionError):
        jax_saxpy(0.7, jnp.zeros(0, jnp.float32), jnp.zeros(0, jnp.float32))


def test_saxpy_rejects_bad_operands():
    x = torch.zeros(8)
    with pytest.raises(TypeError):
        V.saxpy(1.0, x.double(), x.double())
    with pytest.raises(ValueError):
        V.saxpy(1.0, x, torch.zeros(9))
    # neither CPU nor CUDA: raise, never a silent plain path
    with pytest.raises(ValueError):
        V.saxpy(1.0, x.to("meta"), torch.zeros(8, device="meta"))


def test_saxpy_knobs(monkeypatch):
    assert resolve(V.TUNABLES) == {"threads": 256}
    monkeypatch.setenv("TPKT_SAXPY_THREADS", "512")
    assert resolve(V.TUNABLES)["threads"] == 512
    monkeypatch.setenv("TPKT_SAXPY_THREADS", "abc")
    with pytest.raises(ValueError, match="TPKT_SAXPY_THREADS"):
        resolve(V.TUNABLES)


@pytest.fixture
def plan_env(tmp_path, monkeypatch):
    """An empty tuning cache of the test's own, no SAXPY knob set, a
    fixed source sha, and a clock that stands still (the cache's memo
    does not expire between calls)."""
    from tpukernels_torch.tuning import cache

    monkeypatch.setattr(cache.time, "monotonic", lambda: 100.0)
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tcache"))
    monkeypatch.delenv("TPKT_TUNING_CACHE", raising=False)
    monkeypatch.delenv("TPKT_SAXPY_THREADS", raising=False)
    monkeypatch.setattr(cache, "source_sha", lambda sources, root=None: "a")
    cache.forget()
    return cache


@pytest.mark.parametrize("n", [1, 1000, 1 << 20, 1 << 26])
def test_saxpy_launch_plan_memo_follows_env_and_cache(plan_env, monkeypatch,
                                                      n):
    """The memoised plan is the plan an unmemoised resolve would give,
    call after call: it follows TPKT_SAXPY_THREADS and a new cache entry
    at once, and a memo hit costs no new plan."""
    cache, cpu = plan_env, torch.device("cpu")
    made = []
    build = V._launch_plan
    monkeypatch.setattr(V, "_launch_plan",
                        lambda *a: made.append(a) or build(*a))
    want = lambda t: (t, -(-n // (16 * t)))  # noqa: E731
    assert V.launch_plan(n, cpu) == want(256)
    assert V.launch_plan(n, cpu) == want(256) and len(made) == 1
    monkeypatch.setenv("TPKT_SAXPY_THREADS", "512")
    assert V.launch_plan(n, cpu) == want(512)
    monkeypatch.delenv("TPKT_SAXPY_THREADS")
    cache.put(V.TUNABLES, {"threads": 128}, shape=(n,), dtype="float32",
              kind="cpu")
    assert V.launch_plan(n, cpu) == want(128)
    assert V.launch_plan(n, cpu) == want(128) and len(made) == 3
    monkeypatch.setenv("TPKT_TUNING_CACHE", "off")
    assert V.launch_plan(n, cpu) == want(256)
    monkeypatch.setenv("TPKT_SAXPY_THREADS", "48")
    with pytest.raises(ValueError, match="TPKT_SAXPY_THREADS=48"):
        V.launch_plan(n, cpu)


@pytest.mark.parametrize("shape,view", [((4, 250), "2-D"), ((1001,), "offset"),
                                        ((1000,), "strided")])
def test_saxpy_flattens_only_what_needs_it(shape, view):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    if view == "offset":
        x, y = x[1:], y[1:]
    elif view == "strided":
        x, y = x[::2], y[::2]
    got = V.saxpy(0.7, x, y)
    assert got.shape == (x.numel(),)
    want = np.asarray(jax_saxpy(0.7, jnp.asarray(x.reshape(-1).numpy()),
                                jnp.asarray(y.reshape(-1).numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
