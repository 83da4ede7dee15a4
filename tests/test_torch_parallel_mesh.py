"""The port's mesh (``tpukernels_torch/parallel/mesh.py``) on the CPU.

In this process no group is ever joined (the coordinator env is cleared):
the world-1 path, where a mesh is this one rank and every collective the
identity, the env parsing, the fail-loud ``TPKT_DIST_DEPTH``, the mesh
shapes and their errors, and the blocks ``host_to_global`` cuts. The
group itself is joined in child processes only (two gloo ranks through
a ``file://`` rendezvous in ``tmp_path``): a 1-D ring, a 1 × 2 mesh and
its sub-groups, the meshes each process keeps, the errors of a mesh
that does not span the group, and the ``collective/<name>`` spans; two
generations of a group, where a mesh of the left one, pinned, raises
for every mesh key and leaves the next generation paired.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpukernels_torch.kernels import histogram, nbody, scan, stencil
from tpukernels_torch.parallel import P, collectives as C
from tpukernels_torch.parallel import global_to_host, host_to_global, mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("TPKT_COORDINATOR_ADDRESS", "TPKT_NUM_PROCESSES", "TPKT_PROCESS_ID",
       "TPKT_LOCAL_DEVICE", "TPKT_COORDINATOR_TIMEOUT_S", "TPKT_DIST_BACKEND",
       "TPKT_DIST_DEPTH", "TPKT_NBODY_RING_SKIP_LAST",
       "TPKT_NBODY_RING_BIDIR")


@pytest.fixture
def alone(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()
    return M.make_mesh(device="cpu")


def test_no_coordinator_is_one_rank(alone, monkeypatch):
    assert M.maybe_distributed_init("cpu") is False
    assert not torch.distributed.is_initialized()
    assert M.world() == (0, 1)
    assert alone.axis_names == ("x",) and alone.shape == {"x": 1}
    assert alone.size == 1 and alone.rank == 0 and alone.group is None
    assert alone.backend is None and not alone.host_staged
    assert C.wire(alone) == "local"
    assert M.make_mesh(1, device="cpu") is alone  # kept per process


def test_collectives_are_the_identity_at_one_rank(alone):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 96)).astype(np.float32))
    for got in (C.allreduce_sum(x, alone), C.ring_shift(x, alone, shift=3),
                C.bcast(x, alone)):
        assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="root=1 out of range for 1 ranks"):
        C.bcast(x, alone, root=1)


def test_dist_kernels_at_one_rank_are_the_single_device_ones(alone):
    """Without a group, each distributed entry is bitwise the port's
    single-device call (the same wrappers on the same data; the N-body
    forms add the one j-block's forces to zeros)."""
    rng = np.random.default_rng(2)
    g2 = torch.from_numpy(rng.standard_normal((40, 72)).astype(np.float32))
    g3 = torch.from_numpy(rng.standard_normal((12, 10, 20)).astype(np.float32))
    for k in (1, 3, 8, 40):
        assert torch.equal(C.jacobi2d_dist(g2, 9, alone, k=k),
                           stencil.jacobi2d(g2, 9))
    assert torch.equal(C.jacobi3d_dist(g3, 5, alone),
                       stencil.jacobi3d(g3, 5))
    grid, res = C.jacobi2d_dist(g2, 4, alone, residual=True)
    d = stencil.jacobi2d(g2, 5).double() - stencil.jacobi2d(g2, 4).double()
    assert torch.equal(grid, stencil.jacobi2d(g2, 4))
    np.testing.assert_allclose(float(res), float((d * d).sum()), rtol=1e-4)
    v = torch.from_numpy(rng.integers(-2**30, 2**30, 5000).astype(np.int32))
    assert torch.equal(C.scan_dist(v, alone), scan.inclusive_scan(v))
    assert torch.equal(C.scan_dist(v, alone, exclusive=True),
                       scan.exclusive_scan(v))
    assert torch.equal(C.histogram_dist(v % 300, 256, alone),
                       histogram.histogram(v % 300, 256))
    st = [torch.from_numpy(rng.standard_normal(300).astype(np.float32))
          for _ in range(6)]
    st.append(torch.from_numpy(rng.uniform(0.5, 1.5, 300).astype(np.float32)))
    want = nbody.nbody_step(*st, steps=2)
    for fn in (C.nbody_dist_psum, C.nbody_dist_ring):
        for g, w in zip(fn(tuple(st), 2, alone), want):
            assert torch.equal(g, w)


def test_make_mesh_shapes_and_errors(alone):
    m2 = M.make_mesh((1, 1), device="cpu")
    assert m2.axis_names == ("x", "y") and m2.shape == {"x": 1, "y": 1}
    assert m2.axis("y").size == 1 and m2.size == 1
    with pytest.raises(ValueError, match=r"^requested 2 devices, have 1$"):
        M.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"^requested 2x2=4 devices, have 1$"):
        M.make_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        M.make_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="axis 'z' not in mesh axes"):
        alone.axis("z")


@pytest.mark.parametrize("raw,want", [(None, 1), ("1", 1), ("2", 2),
                                      ("7", 7)])
def test_dist_depth_reads_the_knob(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("TPKT_DIST_DEPTH", raising=False)
    else:
        monkeypatch.setenv("TPKT_DIST_DEPTH", raw)
    assert C._dist_depth() == want


@pytest.mark.parametrize("raw", ["0", "-1", "abc", "1.5", ""])
def test_dist_depth_fails_loud(monkeypatch, raw):
    monkeypatch.setenv("TPKT_DIST_DEPTH", raw)
    with pytest.raises(ValueError, match="TPKT_DIST_DEPTH"):
        C._dist_depth()


def test_ring_perm_is_the_references():
    from tpukernels.parallel.collectives import _ring_perm

    for n, shift in ((1, 1), (4, 1), (8, -1), (8, 3)):
        assert C._ring_perm(n, shift) == _ring_perm(n, shift)


def test_init_method_and_backend():
    assert M.init_method("localhost:29500") == "tcp://localhost:29500"
    assert M.init_method("file:///tmp/rdv") == "file:///tmp/rdv"
    assert M.backend_for(torch.device("cpu")) == "gloo"
    assert M.backend_for(torch.device("cuda", 0)) == "nccl"


@pytest.mark.parametrize("backend,device,ok", [
    ("gloo", "cuda", True), ("nccl", "cpu", False), ("mpi", "cpu", False)])
def test_backend_knob(monkeypatch, backend, device, ok):
    monkeypatch.setenv("TPKT_DIST_BACKEND", backend)
    if ok:
        assert M.backend_for(torch.device(device, 0 if device == "cuda"
                                          else None)) == backend
    else:
        with pytest.raises(ValueError, match="TPKT_DIST_BACKEND"):
            M.backend_for(torch.device(device))


@pytest.mark.parametrize("env,match", [
    ({}, "TPKT_NUM_PROCESSES is required"),
    ({"TPKT_NUM_PROCESSES": "2"}, "TPKT_PROCESS_ID is required"),
    ({"TPKT_NUM_PROCESSES": "two", "TPKT_PROCESS_ID": "0"}, "expected an int"),
    ({"TPKT_NUM_PROCESSES": "2", "TPKT_PROCESS_ID": "2"}, "out of range"),
])
def test_coordinator_env_is_checked_before_joining(alone, monkeypatch, env,
                                                   match):
    monkeypatch.setenv("TPKT_COORDINATOR_ADDRESS", "localhost:1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        M.maybe_distributed_init("cpu")
    assert not torch.distributed.is_initialized()


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.local_device()
    assert M.local_device("cpu") == torch.device("cpu")


def test_blocks_of_a_two_rank_axis():
    """host_to_global cuts rank i's block out of the full copy; the
    spec's errors."""
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    for index in (0, 1):
        mesh = M.Mesh(("x",), {"x": 2}, index, torch.device("cpu"), None,
                      None, {"x": M.Axis(2, index, (0, 1))})
        got = host_to_global(a, mesh, P("x"))
        assert torch.equal(got, torch.from_numpy(a[3 * index:3 * index + 3]))
        assert torch.equal(host_to_global(a, mesh, P()),
                           torch.from_numpy(a))
        with pytest.raises(ValueError, match="dim0=5 must divide across 2"):
            host_to_global(a[:5], mesh, P("x"))
        with pytest.raises(ValueError, match="only dim 0"):
            host_to_global(a, mesh, P(None, "x"))


def test_global_to_host_at_one_rank(alone):
    t = torch.arange(10.0)
    assert global_to_host(t, alone, P("x")) is t
    assert torch.equal(host_to_global(t.numpy(), alone, P("x")), t)


GROUP = """
import json, os, sys
import torch
from tpukernels_torch.obs import trace
from tpukernels_torch.parallel import P, make_mesh, collectives as C
from tpukernels_torch.parallel import mesh as M

out = {"joined": M.maybe_distributed_init("cpu")}
ring = make_mesh(device="cpu")
assert make_mesh(2, device="cpu") is ring
one = make_mesh(1, device="cpu")
m2 = make_mesh((1, 2), device="cpu")
out["ring"] = [ring.size, ring.rank, ring.backend, C.wire(ring),
               ring.group is not None]
out["one"] = [one.size, one.group is None, C.wire(one)]
out["m2"] = [m2.shape, m2.axis("x").size, m2.axis("x").group is None,
             m2.axis("y").size, m2.axis("y").index, list(m2.axis("y").ranks)]
for bad in (3, (2, 2)):
    try:
        make_mesh(bad, device="cpu")
        out[str(bad)] = "no error"
    except ValueError as e:
        out[str(bad)] = str(e)
x = torch.full((1, 4), float(ring.rank + 1))
out["allreduce"] = C.allreduce_sum(x, ring).tolist()
out["allreduce_2d"] = C.allreduce_sum(x, m2).tolist()
out["ring_shift"] = C.ring_shift(x, m2, axis="y").tolist()
out["gathered"] = M.global_to_host(x, ring, P("x")).tolist()
print(json.dumps(out))
"""


def test_a_two_rank_group(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPK_", "TPKT_"))}
    env.update(PYTHONPATH=ROOT, TPKT_NUM_PROCESSES="2", TPKT_TRACE="1",
               OMP_NUM_THREADS="1",
               TPKT_COORDINATOR_ADDRESS=f"file://{tmp_path / 'rdv'}",
               TPKT_COORDINATOR_TIMEOUT_S="60")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(GROUP)],
        env={**env, "TPKT_PROCESS_ID": str(r),
             "TPKT_HEALTH_JOURNAL": str(tmp_path / f"j{r}.jsonl")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    for r, (o, _) in enumerate(outs):
        got = json.loads(o.strip().splitlines()[-1])
        assert got["joined"] is True
        assert got["ring"] == [2, r, "gloo", "gloo", True]
        assert got["one"] == [1, True, "local"]
        assert got["m2"] == [{"x": 1, "y": 2}, 1, True, 2, r, [0, 1]]
        assert got["3"] == "requested 3 devices, have 2"
        assert got["(2, 2)"] == "requested 2x2=4 devices, have 2"
        assert got["allreduce"] == got["allreduce_2d"] == [[3.0] * 4]
        assert got["ring_shift"] == [[float(2 - r)] * 4]
        assert got["gathered"] == [[1.0] * 4, [2.0] * 4]
        spans = [json.loads(line) for line in
                 open(tmp_path / f"j{r}.jsonl") if '"span"' in line]
        names = {(s["name"], s["wire"]) for s in spans}
        assert ("collective/allreduce", "gloo") in names
        assert ("collective/ring_shift", "gloo") in names
        assert ("collective/all_gather", "gloo") in names
        assert all(s["ok"] for s in spans)


def test_a_pinned_mesh_is_the_one_make_mesh_gives(alone):
    with M.pinned(alone) as m:
        assert m is alone
        assert M.make_mesh(device="cpu") is alone
        assert M.make_mesh(1, device="cpu") is alone
        with pytest.raises(ValueError, match="is pinned"):
            M.make_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        M.make_mesh(2, device="cpu")
    # a mesh whose group was left: make_mesh under its pin and any use of
    # the group raise, and the group is never None (a collective given
    # None runs on the group current then)
    left = M.Mesh(("x",), {"x": 2}, 0, torch.device("cpu"), "gloo", M.LEFT,
                  {"x": M.Axis(2, 0, (0, 1), M.LEFT)})
    with M.pinned(left), pytest.raises(M.GroupLeft):
        M.make_mesh(2, device="cpu")
    with pytest.raises(M.GroupLeft):
        M.LEFT.allreduce
    assert M.LEFT is not None and bool(M.LEFT)


# two generations of a two-rank group, as the serving daemon's mesh tier
# makes them: rank 0 keeps generation 1's mesh past leave() and runs every
# mesh key on it, pinned, after generation 2 is up; then both ranks run
# generation 2
LEFT_GROUP = """
import json, sys
import torch
from tpukernels_torch import registry
from tpukernels_torch.parallel import collectives as C
from tpukernels_torch.parallel import mesh as M

rank, base = int(sys.argv[1]), sys.argv[2]
M.init_group(f"file://{base}/g1", 2, rank, "cpu", backend="gloo",
             timeout_s=60)
m1 = M.make_mesh(2, device="cpu")
M.leave()
M.init_group(f"file://{base}/g2", 2, rank, "cpu", backend="gloo",
             timeout_s=60)
x = torch.arange(64, dtype=torch.int32)
out = {"left": repr(m1.group)}
if rank == 0:
    g = torch.ones(16, 8)
    cases = {"scan": (x,), "scan_exclusive": (x,), "histogram": (x,),
             "stencil2d": (g,), "stencil3d": (torch.ones(8, 4, 4),),
             "nbody": tuple(torch.rand(16) for _ in range(7))}
    for key, args in cases.items():
        with M.pinned(m1):
            try:
                registry.dispatch_mesh(key, *args, mesh_shape=(2,))
                out[key] = "ran"
            except M.GroupLeft:
                out[key] = "GroupLeft"
    for name, fn in (("all_gather", lambda: C.all_gather_rows(
            torch.ones(4), m1, ("x",))), ("allreduce", lambda: C.allreduce_sum(
            torch.ones(1, 4), m1))):
        try:
            fn()
            out[name] = "ran"
        except M.GroupLeft:
            out[name] = "raised"
        except ValueError as e:  # torch's refusal of a group it lacks
            out[name] = "raised" if "left process group" in str(e) else repr(e)
out["gen2"] = registry.dispatch_mesh("scan", x, mesh_shape=(2,)).tolist()
M.leave()
print(json.dumps(out))
"""


def test_a_mesh_of_a_left_group_reaches_no_later_group(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPK_", "TPKT_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", TPKT_AOT_CACHE="0",
               TPKT_INTEGRITY="0", TPKT_HEALTH_JOURNAL="off")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(LEFT_GROUP), str(r),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    want = np.cumsum(np.arange(64)).tolist()
    for r, (o, _) in enumerate(outs):
        got = json.loads(o.strip().splitlines()[-1])
        assert got.pop("left") == "<left process group>"
        # generation 2 stayed paired: rank 0's stale calls sent nothing
        assert got.pop("gen2") == want
        if r == 0:
            assert got == {"scan": "GroupLeft", "scan_exclusive": "GroupLeft",
                           "histogram": "GroupLeft", "stencil2d": "GroupLeft",
                           "stencil3d": "GroupLeft", "nbody": "GroupLeft",
                           "all_gather": "raised", "allreduce": "raised"}, got
