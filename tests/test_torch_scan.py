"""Port parity: tpukernels_torch scan against the JAX reference (CPU).

The same numpy inputs go through the JAX kernel functions (interpret
mode on the CPU) and through the port's registry and ``interop``. int32
is exact, wrapping mod 2^32 on both sides; float32 is held to the
reference's own band, rtol 1e-4 / atol 1e-2
(tests/test_scan_histogram.py: prefix sums accumulate error ~ sqrt(n)
* eps * scale, in another order on each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import scan as JS
from tpukernels_torch import interop, registry
from tpukernels_torch.kernels import scan as S
from tpukernels_torch.tuning import resolve

RTOL, ATOL = 1e-4, 1e-2


def _port(name, x):
    return interop.from_port(
        registry.dispatch(name, *interop.to_port(name, (x,), "cpu")))


def _jax(fn, x):
    return np.asarray(fn(jnp.asarray(x)))


def _ints(n, lo=-100, hi=100, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


@pytest.mark.parametrize("n", [0, 1, 7, 128, 333, 4093, 1 << 17])
def test_scan_int32_matches_jax_exactly(n):
    x = _ints(n, seed=n)
    got = _port("scan", x)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, _jax(JS.inclusive_scan, x))


def test_scan_int32_wraps_like_jax():
    # values near 2^30: the running sum wraps mod 2^32 every few elements
    x = _ints(4093, (1 << 30) - 1000, 1 << 30, seed=1)
    got = _port("scan", x)
    np.testing.assert_array_equal(got, _jax(JS.inclusive_scan, x))
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.int32))
    assert (got < 0).any()


@pytest.mark.parametrize("tile,n", [(1024, 4093), (2048, 4093),
                                    (1024, 1 << 17), (8192, 1 << 17),
                                    (16384, 1 << 17)])
def test_scan_plain_tiles_carry_exactly(tile, n):
    # tiles smaller than n, with a ragged last tile: the carried prefix
    x = _ints(n, seed=tile)
    got = S.scan_plain(torch.from_numpy(x), tile=tile).numpy()
    np.testing.assert_array_equal(got, _jax(JS.inclusive_scan, x))


@pytest.mark.parametrize("n", [7, 128, 1000, 1 << 17])
def test_scan_float32_matches_jax_in_band(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = _port("scan", x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(JS.inclusive_scan, x), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [0, 1, 333])
def test_exclusive_scan_matches_jax(n):
    x = _ints(n, seed=n + 5)
    got = _port("scan_exclusive", x)
    assert got.shape == (n,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax(JS.exclusive_scan, x))
    if n:
        assert got[0] == 0
    xf = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(_port("scan_exclusive", xf),
                               _jax(JS.exclusive_scan, xf), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fn", [S.inclusive_scan, S.exclusive_scan])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.int16,
                                   torch.bool, torch.bfloat16])
def test_scan_rejects_other_dtypes(fn, dtype):
    with pytest.raises(TypeError, match="float32 or int32"):
        fn(torch.zeros(8, dtype=dtype))


def test_scan_oracles_keep_int32_and_match_jax():
    x = _ints(333, seed=3)
    t = torch.from_numpy(x)
    incl = S.inclusive_scan_reference(t)
    assert incl.dtype == torch.int32
    np.testing.assert_array_equal(incl.numpy(),
                                  _jax(JS.inclusive_scan_reference, x))
    np.testing.assert_array_equal(S.exclusive_scan_reference(t).numpy(),
                                  _jax(JS.exclusive_scan_reference, x))
    assert S.exclusive_scan_reference(t[:0]).numpy().shape == (0,)


def test_scan_rejects_unsupported_device():
    with pytest.raises(ValueError, match="unsupported device"):
        S.inclusive_scan(torch.zeros(8, device="meta"))


def test_scan_tile_knob(monkeypatch):
    assert resolve(S.TUNABLES) == {"tile": 16384}
    x = _ints(5000, seed=9)
    want = _jax(JS.inclusive_scan, x)
    monkeypatch.setenv("TPKT_SCAN_TILE", "1024")
    assert S.resolve_tile() == 1024
    np.testing.assert_array_equal(_port("scan", x), want)
    monkeypatch.setenv("TPKT_SCAN_TILE", "1000")
    with pytest.raises(ValueError, match="TPKT_SCAN_TILE"):
        S.resolve_tile()
