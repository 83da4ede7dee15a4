"""The port's slices end to end on the CPU: the port's registry against
the JAX kernel functions, on the reference's canary operands.

The JAX functions are called directly (no registry, journal or tuning
cache state is touched); the port goes through its own registry and
``interop``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpukernels.kernels import histogram as J_histogram
from tpukernels.kernels import nbody as J_nbody
from tpukernels.kernels import scan as J_scan
from tpukernels.kernels import scan_histogram as J_scan_histogram
from tpukernels.kernels import sgemm as J_sgemm
from tpukernels.kernels import stencil as J_stencil
from tpukernels.kernels import vector_add as J_vector_add
from tpukernels.resilience import integrity as J_integrity
from tpukernels_torch import interop, registry
from tpukernels_torch.resilience import integrity

PORTED = ("vector_add", "sgemm", "stencil2d", "stencil3d", "nbody", "scan",
          "scan_exclusive", "histogram", "scan_histogram")
JAX_FN = {
    "vector_add": J_vector_add.saxpy,
    "sgemm": J_sgemm.sgemm,
    "stencil2d": J_stencil.jacobi2d,
    "stencil3d": J_stencil.jacobi3d,
    "nbody": J_nbody.nbody_step,
    "scan": J_scan.inclusive_scan,
    "scan_exclusive": J_scan.exclusive_scan,
    "histogram": J_histogram.histogram,
    "scan_histogram": J_scan_histogram.scan_histogram,
}


def _jax_call(name, np_args, statics):
    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in np_args]
    out = JAX_FN[name](*args, **statics)
    if isinstance(out, tuple):
        return tuple(np.asarray(a) for a in out)
    return np.asarray(out)


def _assert_close(got, want, rtol, atol):
    """Element by element for a tuple-valued result (``nbody``,
    ``scan_histogram``); exactly where the tolerance is ``exact`` (rtol
    None), as for the int32 keys."""
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if rtol is None:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", PORTED)
def test_dispatch_canary_matches_jax(name):
    np_args = integrity.build_args(name)
    statics = integrity.CANARY_CONFIGS[name]["statics"]
    out = registry.dispatch(name, *interop.to_port(name, np_args, "cpu"),
                            **statics)
    got = interop.from_port(out)
    want = _jax_call(name, np_args, statics)
    _, rtol, atol = integrity.tolerance(name)
    _assert_close(got, want, rtol, atol)


@pytest.mark.parametrize("name", PORTED)
def test_dispatch_canary_matches_port_oracle(name):
    args = interop.to_port(name, integrity.build_args(name), "cpu")
    statics = integrity.CANARY_CONFIGS[name]["statics"]
    got = interop.from_port(registry.dispatch(name, *args, **statics))
    want = interop.from_port(integrity.oracle(name)(*args, **statics))
    _, rtol, atol = integrity.tolerance(name)
    _assert_close(got, want, rtol, atol)


@pytest.mark.parametrize("name", PORTED)
def test_build_args_equal_reference(name):
    mine, theirs = integrity.build_args(name), J_integrity._build_args(name)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name", PORTED)
def test_canary_configs_equal_reference(name):
    assert integrity.CANARY_CONFIGS[name] == J_integrity.CANARY_CONFIGS[name]
    assert integrity.tolerance(name) == J_integrity.tolerance(name)


def test_dispatch_counts_calls():
    registry.reset_calls()
    args = interop.to_port("vector_add", integrity.build_args("vector_add"),
                           "cpu")
    registry.dispatch("vector_add", *args)
    registry.dispatch("vector_add", *args)
    assert registry.calls() == {"vector_add": 2}
    registry.reset_calls()
    assert registry.calls() == {}


def test_registry_names_and_tunables():
    assert registry.names() == sorted(PORTED)
    assert registry.PENDING == {}
    for name in PORTED:
        base = registry.DERIVED_KERNELS.get(name, name)
        assert registry.tunables(name).kernel == base
    assert registry.tunables("scan_exclusive").kernel == "scan"


def test_interop_round_trip():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    i = rng.integers(-9, 9, 7).astype(np.int32)
    alpha, tf, ti = interop.to_port("any", (np.float32(0.5), f, i), "cpu")
    assert isinstance(alpha, float) and alpha == 0.5
    assert tf.is_contiguous() and str(tf.dtype) == "torch.float32"
    assert str(ti.dtype) == "torch.int32"
    np.testing.assert_array_equal(interop.from_port(tf), f)
    np.testing.assert_array_equal(interop.from_port(ti), i)
    with pytest.raises(TypeError):
        interop.to_port("any", (f.astype(np.float64),), "cpu")
    with pytest.raises(ValueError):
        interop.to_port("sgemm", (1.0, f, f, 0.0), "cpu")
    with pytest.raises(ValueError):
        interop.to_port("nbody", (f[0],) * 6, "cpu")
    pair = interop.from_port((tf, ti))
    assert isinstance(pair, tuple) and len(pair) == 2
    np.testing.assert_array_equal(pair[0], f)
