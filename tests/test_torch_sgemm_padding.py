"""The CPU SGEMM's bits under the serving daemon's zero padding.

The daemon pads an SGEMM request up to its bucket
(``serve/bucketing.py``: ``bucket_for``, ``pad_args``), dispatches at the
bucket's shape and cuts the answer back (``unpad_outputs``); the C entry's
in-process route calls the wrapper at the request's own shape. On the CPU
the wrapper runs ``sgemm_plain``, so the two agree bit for bit only if
zero rows, columns and k leave every element's bits alone, in every
precision: a BLAS ``@`` does not promise that (its k order follows the
shape and the thread count), so ``sgemm_plain`` sums its products in one
fixed order. Each case pads through the daemon's own functions, for every
SGEMM bucket a table yields: the default table's (``aot.BENCH_CONFIGS``,
1024³), the serving tests' small one and a table split three ways. The
plain version stays within ``sgemm.contract`` of the oracle.
"""

import json

import numpy as np
import pytest
import torch

from tpukernels_torch import aot
from tpukernels_torch.kernels import sgemm as S
from tpukernels_torch.serve import bucketing


def _spec(m, k, n):
    return {"args": [["f32", []], ["f32", [m, k]], ["f32", [k, n]],
                     ["f32", []], ["f32", [m, n]]], "statics": {}}


# table -> ((m, k, n) of a request, the bucket it must land on)
TABLES = {
    "default": (None, ((1000, 1000, 1000), (1024, 1024, 1024)),
                ((700, 900, 1000), (1024, 1024, 1024))),
    "small": ({"sgemm": _spec(64, 96, 80)},
              ((60, 90, 70), (64, 96, 80)), ((64, 96, 41), (64, 96, 80))),
    "split": ({"sgemm": [_spec(64, 96, 72), _spec(128, 128, 128),
                         _spec(256, 256, 256)]},
              ((60, 90, 70), (64, 96, 72)), ((100, 120, 90),
                                             (128, 128, 128)),
              ((250, 200, 255), (256, 256, 256))),
}
CASES = [(t, req, want) for t, (_table, *pairs) in TABLES.items()
         for req, want in pairs]


@pytest.fixture
def table(request, monkeypatch):
    raw = TABLES[request.param][0]
    if raw is None:
        monkeypatch.delenv("TPKT_SERVE_BUCKETS", raising=False)
        assert bucketing.bucket_configs() is aot.BENCH_CONFIGS
    else:
        monkeypatch.setenv("TPKT_SERVE_BUCKETS", json.dumps(raw))
    monkeypatch.delenv("TPKT_SERVE_MAX_PAD_FRAC", raising=False)
    monkeypatch.delenv("TPKT_SGEMM_PRECISION", raising=False)
    return request.param


def _request(m, k, n, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [np.float32(1.5), f(m, k), f(k, n), np.float32(0.5), f(m, n)]


def _served(arrays, precision):
    """The daemon's path on the CPU: bucket, pad, dispatch at the
    bucket's shape, cut back."""
    spec, pad = bucketing.bucket_for("sgemm", arrays, {})
    assert spec is not None and pad > 0, pad
    padded, meta = bucketing.pad_args("sgemm", spec, arrays)
    alpha, a, b, beta, c = padded
    out = S.sgemm(float(alpha), *(torch.from_numpy(np.ascontiguousarray(t))
                                  for t in (a, b)), float(beta),
                  torch.from_numpy(np.ascontiguousarray(c)),
                  precision=precision)
    (cut,) = bucketing.unpad_outputs("sgemm", meta, (out.numpy(),))
    return spec, cut


@pytest.mark.parametrize("precision", S.PRECISIONS)
@pytest.mark.parametrize("table,req,bucket", CASES,
                         ids=[f"{t}-{'x'.join(map(str, r))}"
                              for t, r, _b in CASES],
                         indirect=["table"])
def test_padding_to_the_bucket_leaves_the_bits(table, req, bucket,
                                               precision):
    arrays = _request(*req)
    spec, served = _served(arrays, precision)
    got = tuple(tuple(shape) for _k, shape in spec["args"])
    m, k, n = bucket
    assert got[1:3] == ((m, k), (k, n))
    alpha, a, b, beta, c = arrays
    local = S.sgemm(float(alpha), torch.from_numpy(a), torch.from_numpy(b),
                    float(beta), torch.from_numpy(c), precision=precision)
    np.testing.assert_array_equal(served, local.numpy())
    # and still within the mode's contract of the oracle
    want = S.sgemm_reference(float(alpha), torch.from_numpy(a),
                             torch.from_numpy(b), float(beta),
                             torch.from_numpy(c))
    rtol, atol = S.contract(precision, req[1], float(alpha))
    torch.testing.assert_close(local, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("precision", S.PRECISIONS)
def test_plain_version_ignores_the_thread_count(precision):
    """The bits do not follow the thread count either (the daemon's
    workers and the in-process caller may run with different ones)."""
    alpha, a, b, beta, c = (torch.from_numpy(np.asarray(t))
                            for t in _request(61, 97, 83, seed=5))
    threads = torch.get_num_threads()
    try:
        outs = []
        for t in (1, max(2, threads)):
            torch.set_num_threads(t)
            outs.append(S.sgemm_plain(float(alpha), a, b, float(beta), c,
                                      precision))
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(outs[0], outs[1])


def test_high_holds_the_c_checkers_bar_at_1024():
    """``high`` within 1e-3 of the float64 oracle at the configuration of
    record, the C golden checker's bar."""
    alpha, a, b, beta, c = (torch.from_numpy(np.asarray(t))
                            for t in _request(1024, 1024, 1024, seed=0))
    got = S.sgemm_plain(float(alpha), a, b, float(beta), c, "high")
    want = S.sgemm_reference(float(alpha), a, b, float(beta), c)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
