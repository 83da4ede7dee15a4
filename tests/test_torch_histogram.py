"""Port parity: tpukernels_torch histogram against the JAX reference (CPU).

The same numpy inputs go through the JAX ``histogram`` (interpret mode
on the CPU, the MXU path for nbins <= 256 and the VPU path above, as
the reference picks them) and through the port's registry and
``interop``. Counts are exact on both sides.

The port follows the kernels, which count nothing for negative values
and values >= nbins. The reference's oracle clips negative values into
bin 0 instead; the port's copy of the oracle mirrors it, and both
divergences are pinned below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels.kernels import histogram as JH
from tpukernels_torch import interop, registry
from tpukernels_torch.kernels import histogram as H
from tpukernels_torch.tuning import cache, resolve, space

MIXED = np.array([-5, 3, 99, 3, 0], np.int32)


def _port(x, nbins):
    args = interop.to_port("histogram", (x,), "cpu")
    return interop.from_port(registry.dispatch("histogram", *args,
                                               nbins=nbins))


def _jax(fn, x, nbins):
    return np.asarray(fn(jnp.asarray(x), nbins))


@pytest.mark.parametrize("n,nbins", [(999, 16), (4096, 1024), (1 << 17, 64),
                                     (30000, 200)])
def test_histogram_matches_jax_exactly(n, nbins):
    x = np.random.default_rng(n).integers(0, nbins, n).astype(np.int32)
    got = _port(x, nbins)
    assert got.dtype == np.int32 and got.shape == (nbins,)
    np.testing.assert_array_equal(got, _jax(JH.histogram, x, nbins))
    np.testing.assert_array_equal(got, _jax(JH.histogram_reference, x, nbins))
    assert got.sum() == n


def test_histogram_out_of_range_counts_nothing_like_the_kernel():
    got = _port(MIXED, 4)
    np.testing.assert_array_equal(got, [1, 0, 0, 2])
    np.testing.assert_array_equal(got, _jax(JH.histogram, MIXED, 4))


def test_oracle_clips_negatives_like_the_reference_oracle():
    # the pinned divergence: both oracles put -5 into bin 0
    got = H.histogram_reference(torch.from_numpy(MIXED), 4).numpy()
    np.testing.assert_array_equal(got, [2, 0, 0, 2])
    np.testing.assert_array_equal(got,
                                  _jax(JH.histogram_reference, MIXED, 4))


def test_histogram_skewed_input_matches_jax():
    # one value everywhere: every count lands in one bin
    x = np.full(30000, 7, np.int32)
    x[:100] = -3
    x[100:200] = 256
    got = _port(x, 256)
    assert got[7] == 30000 - 200 and got.sum() == 30000 - 200
    np.testing.assert_array_equal(got, _jax(JH.histogram, x, 256))


def test_histogram_empty_input():
    x = np.zeros(0, np.int32)
    np.testing.assert_array_equal(_port(x, 64), np.zeros(64, np.int32))
    np.testing.assert_array_equal(_port(x, 64), _jax(JH.histogram, x, 64))


def test_histogram_casts_to_int32_like_jax():
    x = np.array([1.7, -0.5, 2.2, 3.9, 0.0], np.float32)
    got = H.histogram(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, _jax(JH.histogram, x, 4))


@pytest.mark.parametrize("block", [1, 1000, 1 << 20])
def test_histogram_plain_merges_blocks_exactly(block):
    rng = np.random.default_rng(block)
    x = torch.from_numpy(rng.integers(-40, 300, 5000).astype(np.int32))
    got = H.histogram_plain(x, 256, block=block)
    valid = x[(x >= 0) & (x < 256)].numpy()
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(valid, minlength=256))


def test_histogram_rejects_bad_nbins_and_device():
    for nbins in (0, -3):
        with pytest.raises(ValueError, match="nbins"):
            H.histogram(torch.zeros(8, dtype=torch.int32), nbins)
    with pytest.raises(ValueError, match="unsupported device"):
        H.histogram(torch.zeros(8, dtype=torch.int32, device="meta"), 4)


def test_histogram_knob(monkeypatch):
    assert resolve(H.TUNABLES) == {"blocks_per_sm": 2}
    monkeypatch.setenv("TPKT_HIST_BLOCKS_PER_SM", "0")
    with pytest.raises(ValueError, match="TPKT_HIST_BLOCKS_PER_SM"):
        resolve(H.TUNABLES)


def test_histogram_plan_is_memoised_and_follows_env_and_cache(tmp_path,
                                                              monkeypatch):
    """``blocks_per_sm`` comes from the memoised plan: a second call with
    the same (n, nbins) resolves nothing; a changed env knob or a new
    cache entry is seen on the next call."""
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tcache"))
    monkeypatch.delenv("TPKT_TUNING_CACHE", raising=False)
    monkeypatch.delenv("TPKT_HIST_BLOCKS_PER_SM", raising=False)
    monkeypatch.setattr(cache, "source_sha", lambda sources, root=None: None)
    monkeypatch.setattr(cache.time, "monotonic", lambda: 100.0)
    cache.forget()
    calls = []
    real = space.resolve_with_sources
    monkeypatch.setattr(space, "resolve_with_sources",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    cpu = torch.device("cpu")
    assert H.launch_plan(5000, 64, cpu) == 2
    assert H.launch_plan(5000, 64, cpu) == 2 and len(calls) == 1
    assert H.launch_plan(5000, 65, cpu) == 2 and len(calls) == 2
    monkeypatch.setenv("TPKT_HIST_BLOCKS_PER_SM", "4")
    assert H.launch_plan(5000, 64, cpu) == 4 and len(calls) == 3
    monkeypatch.setenv("TPKT_HIST_BLOCKS_PER_SM", "0")
    with pytest.raises(ValueError, match="TPKT_HIST_BLOCKS_PER_SM"):
        H.launch_plan(5000, 64, cpu)
    monkeypatch.delenv("TPKT_HIST_BLOCKS_PER_SM")
    cache.put(H.TUNABLES, {"blocks_per_sm": 3}, shape=(5000, 64),
              dtype="int32", kind="cpu")
    assert H.launch_plan(5000, 64, cpu) == 3


@pytest.mark.parametrize("nbins,n,zeroed", [(256, 100, False),
                                            (H.SMEM_BINS, 100, False),
                                            (H.SMEM_BINS + 1, 100, True),
                                            (256, 0, True)])
def test_bins_out_is_zeroed_only_where_the_kernel_counts_into_it(
        monkeypatch, nbins, n, zeroed):
    """Up to SMEM_BINS bins the kernel's last block writes the whole
    output, which then needs no fill; above, and for an empty input, the
    output starts zeroed."""
    made = []
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append("empty")
                        or torch.ones(*a, **k))
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: made.append("zeros")
                        or torch.full(a, 0, **k))
    out = H.bins_out(nbins, n, torch.ones(1))
    assert made == ["zeros" if zeroed else "empty"]
    assert out.shape == (nbins,) and out.dtype == torch.int32
    src = (H._build.CSRC / "bins.cuh").read_text()
    assert f"TPKT_SMEM_BINS = {H.SMEM_BINS};" in src


def test_as_int32_passes_flat_int32_through():
    x = torch.arange(12, dtype=torch.int32)
    assert H.as_int32(x) is x
    assert H.as_int32(x.view(3, 4)).shape == (12,)
    assert H.as_int32(x[::2]).is_contiguous()
    assert H.as_int32(x.float()).dtype == torch.int32
