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
from tpukernels_torch.tuning import resolve

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
