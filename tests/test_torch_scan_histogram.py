"""Port parity: tpukernels_torch scan_histogram against the JAX reference.

Both fuse settings on the CPU: ``TPK_SCANHIST_FUSE`` picks the JAX
path (the two standalone kernels, or the fused kernel in interpret
mode) and ``TPKT_SCANHIST_FUSE`` the port's (its two wrappers, or the
fused kernel's plain version). Both halves are exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import scan_histogram as JSH
from tpukernels_torch import interop, registry
from tpukernels_torch.kernels import histogram as H
from tpukernels_torch.kernels import scan as S
from tpukernels_torch.kernels import scan_histogram as SH
from tpukernels_torch.tuning import cache, space

CASES = list(itertools.product([0, 7, 999, 4093, 100000],
                               [4, 16, 200, 256, 1024]))


def _both(monkeypatch, fuse, x, nbins):
    """(port, jax) results of scan_histogram(x, nbins), as numpy pairs."""
    monkeypatch.setenv("TPK_SCANHIST_FUSE", fuse)
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", fuse)
    args = interop.to_port("scan_histogram", (x,), "cpu")
    port = interop.from_port(registry.dispatch("scan_histogram", *args,
                                               nbins=nbins))
    jax_ = tuple(np.asarray(a) for a in JSH.scan_histogram(jnp.asarray(x),
                                                          nbins))
    return port, jax_


@pytest.mark.parametrize("fuse", ["off", "on"])
@pytest.mark.parametrize("n,nbins", CASES)
def test_scan_histogram_matches_jax_exactly(monkeypatch, fuse, n, nbins):
    x = np.random.default_rng(n + nbins).integers(0, nbins, n).astype(
        np.int32)
    (s, h), (js, jh) = _both(monkeypatch, fuse, x, nbins)
    assert s.dtype == h.dtype == np.int32
    assert s.shape == (n,) and h.shape == (nbins,)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(h, jh)
    assert h.sum() == n


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_scan_histogram_pad_correction_case(monkeypatch, fuse):
    # all zeros: the reference's fused path pads with zeros and takes the
    # pad count back out of bin 0; the port masks instead
    x = np.zeros(1000, np.int32)
    (s, h), (js, jh) = _both(monkeypatch, fuse, x, 8)
    assert h[0] == 1000 and h.sum() == 1000
    np.testing.assert_array_equal(s, np.zeros(1000, np.int32))
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(s, js)
    # negative and out-of-range values: counted nowhere, scanned as they are
    x = np.array([-5, 3, 99, 3, 0], np.int32)
    (s, h), (js, jh) = _both(monkeypatch, fuse, x, 4)
    np.testing.assert_array_equal(h, [1, 0, 0, 2])
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(s, np.cumsum(x, dtype=np.int32))
    np.testing.assert_array_equal(s, js)


def test_fuse_off_is_the_standalone_wrappers(monkeypatch):
    monkeypatch.delenv("TPKT_SCANHIST_FUSE", raising=False)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -50, 300, 5000).astype(np.int32))
    s, h = SH.scan_histogram(x, 256)
    assert torch.equal(s, S.inclusive_scan(x))
    assert torch.equal(h, H.histogram(x, 256))


def test_fused_plain_and_oracle_agree(monkeypatch):
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", "on")
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 200, 30000).astype(np.int32))
    s, h = SH.scan_histogram(x, 200)
    rs, rh = SH.scan_histogram_reference(x, 200)
    assert torch.equal(s, rs) and torch.equal(h, rh)


def test_bad_fuse_knob_fails_loud(monkeypatch):
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", "maybe")
    with pytest.raises(ValueError, match="TPKT_SCANHIST_FUSE"):
        SH.scan_histogram(torch.zeros(16, dtype=torch.int32), 8)


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_second_call_resolves_no_knob_and_env_is_still_seen(tmp_path,
                                                            monkeypatch,
                                                            fuse):
    """One memoised plan holds ``fuse``, the scan's tile and the
    histogram's grid: a second call with the same (n, nbins) resolves no
    knob of any of the three kernels, and a change to any of their env
    knobs is seen on the next call."""
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tcache"))
    monkeypatch.delenv("TPKT_TUNING_CACHE", raising=False)
    for env in ("TPKT_SCAN_TILE", "TPKT_HIST_BLOCKS_PER_SM"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", fuse)
    monkeypatch.setattr(cache, "source_sha", lambda sources, root=None: None)
    monkeypatch.setattr(cache.time, "monotonic", lambda: 100.0)
    cache.forget()
    calls = []
    real = space.resolve_with_sources
    monkeypatch.setattr(space, "resolve_with_sources",
                        lambda *a, **k: calls.append(a[0].kernel)
                        or real(*a, **k))
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 64, 5000).astype(np.int32))
    want = SH.scan_histogram_reference(x, 64)
    for _ in range(3):
        s, h = SH.scan_histogram(x, 64)
        assert torch.equal(s, want[0]) and torch.equal(h, want[1])
    first = ["scan_histogram", "histogram", "scan"] if fuse == "off" else [
        "scan_histogram", "scan"]
    assert calls == first
    assert SH.launch_plan(x, 64) == (fuse, 16384,
                                     2 if fuse == "off" else None)
    monkeypatch.setenv("TPKT_SCAN_TILE", "2048")
    assert SH.launch_plan(x, 64)[1] == 2048
    monkeypatch.setenv("TPKT_HIST_BLOCKS_PER_SM", "4")
    assert SH.launch_plan(x, 64)[2] == (4 if fuse == "off" else None)
    flipped = "on" if fuse == "off" else "off"
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", flipped)
    assert SH.launch_plan(x, 64)[0] == flipped
    cache.put(S.TUNABLES, {"tile": 4096}, shape=(5000,), dtype="int32",
              kind="cpu")
    monkeypatch.delenv("TPKT_SCAN_TILE")
    assert SH.launch_plan(x, 64)[1] == 4096
    s, h = SH.scan_histogram(x, 64)
    assert torch.equal(s, want[0]) and torch.equal(h, want[1])


def test_input_is_converted_once(monkeypatch):
    """``scan_histogram`` casts and flattens its input once; the two
    halves take it as it is."""
    monkeypatch.setenv("TPKT_SCANHIST_FUSE", "off")
    seen = []
    real = H.as_int32
    monkeypatch.setattr(H, "as_int32", lambda t: seen.append(1) or real(t))
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 16, (10, 50)).astype(np.int64))
    s, h = SH.scan_histogram(x, 16)
    rs, rh = SH.scan_histogram_reference(x, 16)
    assert torch.equal(s, rs) and torch.equal(h, rh)
    assert len(seen) == 2  # the wrapper's, and histogram_plain's own
