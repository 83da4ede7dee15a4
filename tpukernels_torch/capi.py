"""The C entry of the port: the module the port's shim imports.

The port's counterpart of ``tpukernels/capi.py``. The shim
(``csrc/tpkt_shim.c``, built by ``_build.build_shim``) hands over the C
driver's raw host pointers and a JSON description of their shapes,
dtypes and scalar parameters. Each adapter wraps the pointers as numpy
views (zero copy) and those as tensors (``torch.from_numpy``), uploads
them to the device, runs the kernel through ``registry.dispatch`` (the
guarded path), and copies the result back into the driver's buffers
before it returns. The C timing loop around ``tpu_run`` therefore
measures H2D + compute + D2H, as the reference's does.

``run_from_c`` checks the buffer specs against the pointers and the
kernel name, then runs, in order: the ``fail_capi``/``wedge_capi`` fault
point, the adapter inside a ``capi/<kernel>`` span that carries the
device it ran on (an error in either is counted in
``capi.errors.<kernel>``, journaled as ``capi_error`` and raised again,
so the shim returns 1), the wall clock, the output-integrity guard at
site ``capi`` over the buffers the adapter wrote (its canary on the
adapter's device; a leaf the guard corrupted is copied into the
driver's buffer, so the C checker sees it), then ``capi.calls.<kernel>``
and the ``capi.wall_s.<kernel>`` histogram.

Knobs:

- ``TPKT_CAPI_DEVICE``: unset means the card, and ``run_from_c`` raises
  when there is none; ``cpu`` runs the plain PyTorch versions on the CPU
  (the C host's counterpart of the tests' ``device="cpu"``). Nothing
  falls back from the card to the CPU.
- ``TPKT_SERVE_SOCKET``: when set, the adapters are clients of the
  serving daemon on that socket (``serve/``; one ``ServeClient`` a
  thread): the driver's buffers go to the daemon as numpy views (the shm
  lane for large ones, when the daemon offers it), the daemon runs
  ``registry.dispatch`` on its card, and the results come back into the
  buffers. A rejection is retried on the daemon's hint up to 10 times; a
  dispatch error the daemon reports is raised. When the daemon is
  unusable (transport trouble, or still rejecting), one stderr note is
  printed and the call takes the in-process path, which runs the same
  kernel on the same card.
- ``TPKT_MESH``: the ranks the stencil, scan, histogram, scan_histogram
  and nbody adapters run over (default 1, the single-device path). Above
  1 they take the reference's mesh branches on the port's distributed
  layer (``parallel/``): the C driver runs as that many processes, one
  rank each (``mpirun -np N``), every one with identical buffers and the
  coordinator env of ``parallel/mesh.py`` (``TPKT_COORDINATOR_ADDRESS``,
  ``TPKT_NUM_PROCESSES``, ``TPKT_PROCESS_ID``); each rank computes its
  block and gathers the full result into its driver's buffers. A
  ``TPKT_MESH`` above the process group's size raises. The stencils read
  ``TPKT_STENCIL_K`` (the halo depth) and ``TPKT_STENCIL_RESIDUAL=1``
  (the residual on stderr); nbody reads ``TPKT_NBODY_DIST`` (``psum``, the
  default, or ``ring``). The ``allreduce`` adapter (``allreduce_bench``)
  always runs on a mesh: ``TPKT_MESH`` ranks if set, else the whole
  group (one rank without one); with ``TPKT_BUSBW_SWEEP=1`` its first
  call also prints the bus-bandwidth sweep (``parallel/busbw.py``, tuned
  by ``TPKT_BUSBW_MIN``/``MAX``/``REPS``/``OP``).
- ``TPKT_PROFILE=<dir>``: each call runs under ``torch.profiler``, and
  its Chrome trace is written into ``<dir>`` as
  ``capi_<pid>_<seq>_<kernel>.json`` when the call returns.

:func:`shutdown_from_c`, which the shim calls when its C host exits,
writes the metrics snapshot to the journal and leaves the process group.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import json
import math
import os
import sys
import threading
import time
import warnings

import numpy as np
import torch

from tpukernels_torch import kernels, registry
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import trace
from tpukernels_torch.resilience import faults, integrity, journal
from tpukernels_torch.parallel import mesh as mesh_mod
from tpukernels_torch.parallel.mesh import local_device

# exactly the dtypes the C drivers send in their buffer specs
_DTYPES = {
    "f32": np.float32,
    "i32": np.int32,
}

_DEVICES: dict = {}  # TPKT_CAPI_DEVICE's raw value -> the device it names
_PROFILE_SEQ = itertools.count()  # profiled calls of this process
_SERVE_TLS = threading.local()  # .client: this thread's ServeClient
_SERVE_WARNED: list = []  # [True] once the unusable-daemon note printed
_BUSBW_SWEPT: list = []  # [True] once TPKT_BUSBW_SWEEP's sweep ran


def _device() -> torch.device:
    """The device the adapters run on: the card, unless
    ``TPKT_CAPI_DEVICE`` names another (``cpu``). Resolved through
    ``local_device`` (``pick_device``, which raises when the card is
    asked for and there is none); a CUDA device carries its index
    (``TPKT_LOCAL_DEVICE``, else the current card), so spans name it."""
    raw = os.environ.get("TPKT_CAPI_DEVICE")
    dev = _DEVICES.get(raw)
    if dev is None:
        dev = _DEVICES[raw] = local_device(raw or None)
    return dev


def _mesh_size() -> int:
    """``TPKT_MESH``: the ranks the mesh branches run over (1: the
    single-device path)."""
    n = int(os.environ.get("TPKT_MESH", "1"))
    if n < 1:
        raise ValueError(f"TPKT_MESH={n}: must be >= 1")
    return n


def _mesh(dev, n: int):
    """The mesh of ``n`` ranks, one this process; raises when the
    process group (``parallel/mesh.py``'s coordinator env) has fewer."""
    from tpukernels_torch.parallel import make_mesh, maybe_distributed_init
    from tpukernels_torch.parallel.mesh import world

    maybe_distributed_init(dev)
    have = world()[1]
    if have < n:
        raise RuntimeError(
            f"TPKT_MESH={n} but the process group has {have} rank(s): run "
            f"the driver as {n} processes with TPKT_COORDINATOR_ADDRESS, "
            "TPKT_NUM_PROCESSES and TPKT_PROCESS_ID set")
    return make_mesh(n, device=dev)


@contextlib.contextmanager
def _profiled(kernel: str):
    """One ``torch.profiler`` session around one call when
    ``TPKT_PROFILE`` names a directory: its Chrome trace is written
    there when the call returns. A session never outlives its call: a C
    host's exit destroys the main thread's thread-local state (glibc runs
    those destructors before any exit handler), where the profiler keeps
    its own, so a session stopped at exit would crash the host."""
    directory = os.environ.get("TPKT_PROFILE")
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        directory, f"capi_{os.getpid()}_{next(_PROFILE_SEQ)}_{kernel}.json"))


def shutdown_from_c() -> int:
    """Called by the shim when its C host exits (and by an explicit
    ``tpu_shutdown``): write the metrics snapshot to the journal, then
    leave the process group a mesh call joined (``mesh.leave``), since a
    C host never finalises the interpreter and so never runs the exit
    hook a Python host leaves it by. A group left to the process's own
    teardown exits with its NCCL threads still running against a card
    whose runtime is being torn down: a C host that had passed its check
    once died of SIGSEGV at exit that way."""
    kernels.publish_launches()
    obs_metrics.emit_snapshot(site="capi.shutdown")
    mesh_mod.leave()
    return 0


def _wrap(addr: int, spec: dict) -> torch.Tensor:
    """The driver's buffer at ``addr`` as a tensor over its memory (a
    numpy view, then ``torch.from_numpy``: no copy)."""
    dtype_name = spec.get("dtype")
    if dtype_name not in _DTYPES:
        raise ValueError(
            f"unsupported buffer dtype {dtype_name!r}; the C ABI "
            f"carries {sorted(_DTYPES)}"
        )
    dt = np.dtype(_DTYPES[dtype_name])
    shape = tuple(int(d) for d in spec["shape"])
    nbytes = dt.itemsize * math.prod(shape)
    raw = (ctypes.c_char * nbytes).from_address(addr)
    return torch.from_numpy(np.frombuffer(raw, dtype=dt).reshape(shape))


def _serve(sock: str, kernel: str, args, statics):
    """``kernel`` on the serving daemon at ``sock``: the host tensors
    go as numpy views, the scalars as float32. Returns the result as
    tensors over the response's bytes (read only by the adapters'
    copies into the driver's buffers), or None when the call must take
    the in-process path (see the module's docstring)."""
    from tpukernels_torch.serve import client as serve_client
    from tpukernels_torch.serve import protocol as serve_protocol

    np_args = tuple(a.numpy() if isinstance(a, torch.Tensor)
                    else np.float32(a) for a in args)
    try:
        cli = getattr(_SERVE_TLS, "client", None)
        if cli is None or cli.socket_path != sock:
            cli = _SERVE_TLS.client = serve_client.ServeClient(sock)
        out = serve_client.dispatch_with_backpressure(cli, kernel, np_args,
                                                      statics)
    except serve_client.ServeRejected:
        print(f"# capi: serve daemon at {sock} rejected {kernel} 10x - "
              "falling back in-process", file=sys.stderr)
        return None
    except serve_client.ServeError:
        raise  # the daemon ran it and it failed: that is the answer
    except (OSError, serve_protocol.ProtocolError) as e:
        _SERVE_TLS.client = None
        if not _SERVE_WARNED:
            _SERVE_WARNED.append(True)
            print(f"# capi: serve daemon at {sock} unusable ({e!r}) - "
                  "falling back in-process", file=sys.stderr)
        return None
    # the response's arrays are read-only views of its bytes
    warnings.filterwarnings("ignore",
                            message="The given NumPy array is not writable",
                            category=UserWarning)
    if isinstance(out, tuple):
        return tuple(torch.from_numpy(o) for o in out)
    return torch.from_numpy(out)


def _dispatch(dev, kernel: str, *args, **statics):
    """``registry.dispatch`` of ``kernel`` on ``dev`` (host tensors are
    uploaded; one already on ``dev`` is used as it is), or on the
    serving daemon when ``TPKT_SERVE_SOCKET`` names one."""
    sock = os.environ.get("TPKT_SERVE_SOCKET")
    if sock:
        out = _serve(sock, kernel, args, statics)
        if out is not None:
            return out
    return registry.dispatch(
        kernel, *(a.to(dev) if isinstance(a, torch.Tensor) else a
                  for a in args), **statics)


def _adapt_vector_add(p, arrs, dev):
    x, y = arrs
    out = _dispatch(dev, "vector_add", float(np.float32(p.get("alpha", 1.0))),
                    x, y)
    y.copy_(out.view(y.shape))


def _adapt_sgemm(p, arrs, dev):
    a, b, c = arrs
    out = _dispatch(dev, "sgemm", float(np.float32(p.get("alpha", 1.0))),
                    a, b, float(np.float32(p.get("beta", 0.0))), c)
    c.copy_(out)


def _adapt_stencil(name, p, arrs, dev):
    (x,) = arrs
    n = _mesh_size()
    if n == 1:
        x.copy_(_dispatch(dev, name, x, iters=int(p["iters"])))
        return
    from tpukernels_torch.parallel import P, collectives
    from tpukernels_torch.parallel import global_to_host, host_to_global

    dist = {"stencil2d": collectives.jacobi2d_dist,
            "stencil3d": collectives.jacobi3d_dist}[name]
    mesh = _mesh(dev, n)
    xl = host_to_global(x, mesh, P("x"))
    # the halo depth of the mesh path, the multi-rank mirror of the
    # single-device fusion depth
    kw = {}
    if "TPKT_STENCIL_K" in os.environ:
        kw["k"] = int(os.environ["TPKT_STENCIL_K"])
    # TPKT_STENCIL_RESIDUAL=1: also the loop's residual allreduce,
    # reported on stderr; one more sweep and all-reduce a call, so timed
    # runs leave it unset
    if os.environ.get("TPKT_STENCIL_RESIDUAL") == "1":
        out, res = dist(xl, int(p["iters"]), mesh, residual=True, **kw)
        print(f"tpukernels: {name} residual "
              f"||x_k+1 - x_k||^2 = {float(res):.6e}", file=sys.stderr)
    else:
        out = dist(xl, int(p["iters"]), mesh, **kw)
    x.copy_(global_to_host(out, mesh, P("x")))


def _mesh_1d(dev, x):
    """``(mesh, x's block on it)`` for the element-split adapters, or
    ``(None, x)`` on the single-device path."""
    n = _mesh_size()
    if n == 1:
        return None, x
    from tpukernels_torch.parallel import P, host_to_global

    mesh = _mesh(dev, n)
    return mesh, host_to_global(x, mesh, P("x"))


def _scan(dev, x, exclusive, mesh=None):
    if mesh is not None:
        from tpukernels_torch.parallel import P, collectives, global_to_host

        return global_to_host(
            collectives.scan_dist(x, mesh, exclusive=exclusive), mesh, P("x"))
    return _dispatch(dev, "scan_exclusive" if exclusive else "scan", x)


def _histogram(dev, x, nbins, mesh=None):
    if mesh is not None:
        from tpukernels_torch.parallel import collectives

        return collectives.histogram_dist(x, nbins, mesh)
    return _dispatch(dev, "histogram", x, nbins=nbins)


def _adapt_scan(p, arrs, dev):
    x, out = arrs
    mesh, x = _mesh_1d(dev, x)
    out.copy_(_scan(dev, x, bool(p.get("exclusive")), mesh).view(out.shape))


def _adapt_histogram(p, arrs, dev):
    x, counts = arrs
    mesh, x = _mesh_1d(dev, x)
    counts.copy_(_histogram(dev, x, int(p["nbins"]), mesh))


def _adapt_scan_histogram(p, arrs, dev):
    """One upload of x feeds both halves in process (the daemon takes
    the host buffer itself). The inclusive single-device pass dispatches
    the registry's combined key, so ``TPKT_SCANHIST_FUSE`` applies on the
    C path too; the exclusive one takes the two keys, and the mesh path
    ``scan_dist`` and ``histogram_dist``, as the reference's does."""
    x, scan_out, counts = arrs
    mesh, x = _mesh_1d(dev, x)
    if mesh is None and not os.environ.get("TPKT_SERVE_SOCKET"):
        x = x.to(dev)
    nbins = int(p["nbins"])
    if mesh is None and not p.get("exclusive"):
        s, h = _dispatch(dev, "scan_histogram", x, nbins=nbins)
    else:
        s = _scan(dev, x, bool(p.get("exclusive")), mesh)
        h = _histogram(dev, x, nbins, mesh)
    scan_out.copy_(s.view(scan_out.shape))
    counts.copy_(h)


def _adapt_nbody(p, arrs, dev):
    statics = {"dt": float(p.get("dt", 1e-3)),
               "eps": float(p.get("eps", 1e-2))}
    steps = int(p.get("steps", 1))
    n = _mesh_size()
    if n == 1:
        out = _dispatch(dev, "nbody", *arrs, steps=steps, **statics)
        for host, res in zip(arrs, out):
            host.copy_(res)
        return
    from tpukernels_torch.parallel import P, collectives
    from tpukernels_torch.parallel import global_to_host, host_to_global

    # TPKT_NBODY_DIST: 'psum' (the j-split partial forces, every rank
    # holding all positions) or 'ring' (i-blocks, j-blocks rotating)
    variant = os.environ.get("TPKT_NBODY_DIST", "psum")
    variants = {"psum": collectives.nbody_dist_psum,
                "ring": collectives.nbody_dist_ring}
    if variant not in variants:
        raise ValueError(f"TPKT_NBODY_DIST={variant!r}: expected one of "
                         f"{sorted(variants)}")
    mesh = _mesh(dev, n)
    specs = ((P(),) * 6 + (P("x"),) if variant == "psum"
             else (P("x"),) * 7)
    state = tuple(host_to_global(a, mesh, sp) for a, sp in zip(arrs, specs))
    out = variants[variant](state, steps, mesh, **statics)
    for host, res, sp in zip(arrs, out, specs):
        host.copy_(global_to_host(res, mesh, sp))


def _maybe_busbw_sweep(mesh):
    """``TPKT_BUSBW_SWEEP=1``: the bus-bandwidth table of
    ``parallel/busbw.py`` (``TPKT_BUSBW_MIN``/``MAX``/``REPS``/``OP``),
    once a process, on the driver's first allreduce call (its untimed
    check), so the timed reps after it are undisturbed."""
    if _BUSBW_SWEPT or os.environ.get("TPKT_BUSBW_SWEEP") != "1":
        return
    _BUSBW_SWEPT.append(True)
    from tpukernels_torch.parallel.busbw import sweep_from_env

    sweep_from_env(mesh=mesh)


def _adapt_allreduce(p, arrs, dev):
    """Every rank contributes the driver's x; every rank's out is the
    sum, so the driver reads its rank count back from out / x."""
    from tpukernels_torch.parallel import P, host_to_global
    from tpukernels_torch.parallel import maybe_distributed_init
    from tpukernels_torch.parallel.collectives import allreduce_sum
    from tpukernels_torch.parallel.mesh import world

    x, out = arrs
    maybe_distributed_init(dev)
    n = _mesh_size() if "TPKT_MESH" in os.environ else world()[1]
    mesh = _mesh(dev, n)
    _maybe_busbw_sweep(mesh)
    contrib = host_to_global(x.view(1, -1).expand(n, -1), mesh, P("x"))
    out.copy_(allreduce_sum(contrib, mesh)[0])


# buffer indices each adapter writes: the guard checks these only, since
# a C caller may pass non-finite input data that a correct kernel must
# not be failed for
_OUTPUT_BUFFERS = {
    "vector_add": (1,),          # y (in/out)
    "sgemm": (2,),               # c (in/out)
    "stencil2d": (0,),           # x (in/out)
    "stencil3d": (0,),
    "scan": (1,),                # out
    "histogram": (1,),           # counts
    "scan_histogram": (1, 2),    # scan_out, counts
    "nbody": (0, 1, 2, 3, 4, 5),  # px..vz (m is input-only)
    "allreduce": (1,),           # out
}

_ADAPTERS = {
    "vector_add": _adapt_vector_add,
    "sgemm": _adapt_sgemm,
    "stencil2d": functools.partial(_adapt_stencil, "stencil2d"),
    "stencil3d": functools.partial(_adapt_stencil, "stencil3d"),
    "scan": _adapt_scan,
    "histogram": _adapt_histogram,
    "scan_histogram": _adapt_scan_histogram,
    "nbody": _adapt_nbody,
    "allreduce": _adapt_allreduce,
}


def run_from_c(kernel: str, params_json: str, addrs) -> int:
    """Run C kernel ``kernel`` on the driver's buffers at ``addrs``,
    described by ``params_json``; returns 0 or raises (see the module's
    docstring)."""
    p = json.loads(params_json)
    specs = p.get("buffers", [])
    if len(specs) != len(addrs):
        raise ValueError(
            f"{kernel}: {len(addrs)} pointers but {len(specs)} buffer specs"
        )
    arrs = [_wrap(int(a), s) for a, s in zip(addrs, specs)]
    fn = _ADAPTERS.get(kernel)
    if fn is None:
        raise KeyError(
            f"no C adapter for kernel {kernel!r}; known: {sorted(_ADAPTERS)}"
        )
    with _profiled(kernel):
        t0 = time.perf_counter()
        try:
            faults.capi_fault(kernel)  # one is-None check without a plan
            dev = _device()
            with trace.span(f"capi/{kernel}", kernel=kernel,
                            device=str(dev)):
                fn(p, arrs, dev)
        except Exception as e:  # noqa: BLE001 — journaled, then re-raised
            obs_metrics.inc(f"capi.errors.{kernel}")
            journal.emit("capi_error", kernel=kernel, error=repr(e))
            raise
        # H2D + compute + D2H, clocked before the guard, so a canary
        # never lands in the latency histogram
        wall_s = time.perf_counter() - t0
        outs = [arrs[i] for i in _OUTPUT_BUFFERS[kernel]]
        checked = integrity.guard("capi", kernel, outs, device=dev)
        for mine, seen in zip(outs, checked):
            if seen is not mine:  # a fault plan corrupted it: C sees it
                mine.copy_(seen)
    obs_metrics.inc(f"capi.calls.{kernel}")
    obs_metrics.observe(f"capi.wall_s.{kernel}", wall_s)
    return 0
