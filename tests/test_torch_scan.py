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
from tpukernels_torch import _build, interop, registry
from tpukernels_torch.kernels import scan as S
from tpukernels_torch.tuning import cache, resolve, space

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


@pytest.fixture
def counted_resolves(tmp_path, monkeypatch):
    """A tuning cache of the test's own, no scan knob set, and a list
    that grows by one with every knob resolution of any kernel."""
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tcache"))
    monkeypatch.delenv("TPKT_TUNING_CACHE", raising=False)
    monkeypatch.delenv("TPKT_SCAN_TILE", raising=False)
    monkeypatch.setattr(cache, "source_sha", lambda sources, root=None: None)
    monkeypatch.setattr(cache.time, "monotonic", lambda: 100.0)
    cache.forget()
    calls = []
    real = space.resolve_with_sources
    monkeypatch.setattr(space, "resolve_with_sources",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    return calls


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_second_scan_call_resolves_no_knob(counted_resolves, monkeypatch,
                                           dtype):
    """The tile comes from the memoised plan: a second call with the
    same (n, dtype) resolves nothing; another length or dtype, a changed
    env knob or a new cache entry is seen on the next call."""
    x = torch.from_numpy(_ints(5000, seed=2).astype(dtype))
    want = _jax(JS.inclusive_scan, x.numpy())
    for _ in range(3):
        np.testing.assert_allclose(S.inclusive_scan(x).numpy(), want,
                                   rtol=RTOL, atol=ATOL)
    assert len(counted_resolves) == 1
    S.inclusive_scan(x[:4000])
    assert len(counted_resolves) == 2
    other = torch.float32 if dtype == np.int32 else torch.int32
    S.inclusive_scan(x.to(other))
    assert len(counted_resolves) == 3
    monkeypatch.setenv("TPKT_SCAN_TILE", "2048")
    assert S.tile_plan(x) == 2048 and len(counted_resolves) == 4
    monkeypatch.setenv("TPKT_SCAN_TILE", "1000")
    with pytest.raises(ValueError, match="TPKT_SCAN_TILE=1000"):
        S.inclusive_scan(x)
    monkeypatch.delenv("TPKT_SCAN_TILE")
    assert S.tile_plan(x) == 16384
    cache.put(S.TUNABLES, {"tile": 4096}, shape=(5000,), dtype=x.dtype,
              kind="cpu")
    assert S.tile_plan(x) == 4096 and S.tile_plan(x) == 4096
    np.testing.assert_allclose(S.inclusive_scan(x).numpy(), want, rtol=RTOL,
                               atol=ATOL)


class _Stream:
    """Stand-ins for the CUDA calls :func:`scan.scratch` makes, so that
    its bookkeeping runs on CPU tensors."""

    def __init__(self, monkeypatch):
        self.stream, self.capturing = 7, False
        monkeypatch.setattr(_build, "device_stream",
                            lambda t: (t.get_device(), self.stream))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: self.capturing)
        monkeypatch.setattr(S, "_SCRATCH", {})


def test_scratch_is_one_zeroed_buffer_a_stream_grown_on_demand(monkeypatch):
    cur = _Stream(monkeypatch)
    x = torch.zeros(8, dtype=torch.int32)
    key, buf = S.scratch("scan", 10, x)
    assert key == ("scan", -1, 7) and buf.dtype == torch.int64
    assert buf.numel() >= 10 and not buf.any()
    assert S.scratch("scan", 10, x)[1] is buf  # kept: no fill a call
    assert S.scan_state(16384 * 9, 16384, x)[1] is buf  # 10 words
    big = S.scratch("scan", buf.numel() + 1, x)[1]  # grows, zeroed
    assert big is not buf and big.numel() > buf.numel() and not big.any()
    assert S.scratch("scan", 10, x)[1] is big
    # the fused pass keeps its bins behind the status words
    assert S.scan_state(16384, 16384, x, nbins=2 * big.numel())[1] \
        .numel() >= 2 + big.numel()
    # another kind or another stream: another buffer
    assert S.scratch("histogram", 10, x)[1] is not big
    cur.stream = 8
    other = S.scratch("scan", 10, x)[1]
    assert other is not big and len(S._SCRATCH) == 3
    # given where the caller looked up, no second lookup
    monkeypatch.setattr(_build, "device_stream",
                        lambda t: pytest.fail("looked up again"))
    assert S.scratch("scan", 10, x, (-1, 8))[1] is other


def test_scratch_dropped_after_a_failed_launch_and_not_kept_in_capture(
        monkeypatch):
    cur = _Stream(monkeypatch)
    x = torch.zeros(8, dtype=torch.int32)
    key, buf = S.scratch("scan", 10, x)
    S.drop_scratch(key)
    S.drop_scratch(key)  # and again: nothing to forget
    assert S.scratch("scan", 10, x)[1] is not buf
    # a buffer made during a capture belongs to the graph: not kept
    cur.stream, cur.capturing = 9, True
    _, first = S.scratch("scan", 10, x)
    assert S.scratch("scan", 10, x)[1] is not first
    assert ("scan", -1, 9) not in S._SCRATCH
    # one made before the capture is used during it
    cur.capturing = False
    _, made = S.scratch("scan", 10, x)
    cur.capturing = True
    assert S.scratch("scan", 10, x)[1] is made


def test_scan_kernel_resets_its_own_state():
    """The kernel's source leaves the state zeroed (the last block
    clears it), asks the runtime for its grid once, and the timing-only
    probe entry is reached by no wrapper."""
    cuh = (_build.CSRC / "scan.cuh").read_text()
    for needle in ("atomicAdd(counter + 1, 1u) == gridDim.x - 1",
                   "__threadfence()", "status[i] = 0",
                   "tpkt_resident_grid", "static TpktGridMemo memo"):
        assert needle in cuh, needle
    assert "tpkt_scan_probe" in (_build.CSRC / "scan.cu").read_text()
    for mod in ("scan", "histogram", "scan_histogram"):
        src = (_build.CSRC.parent / "kernels" / f"{mod}.py").read_text()
        assert "tpkt_scan_probe" not in src
