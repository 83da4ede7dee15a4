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
