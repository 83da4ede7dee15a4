"""The port's mesh: a ``torch.distributed`` process group, one rank a process.

Port of ``tpukernels/parallel/mesh.py``. The reference joins a
multi-host JAX job when a coordinator is configured and builds a named
1-D ring or (r, c) mesh over the devices it sees; its arrays are global
arrays sharded over the mesh inside one program. The port follows
PyTorch's SPMD idiom instead: one process per rank, each holding its own
block on its own device, and a process group between them.

:func:`maybe_distributed_init` joins the group described by the
environment (the counterpart of the reference's JAX coordinator env),
once per process:

- ``TPKT_COORDINATOR_ADDRESS`` — ``host:port`` (a TCP rendezvous) or a
  URL ``torch.distributed`` takes (``file:///path``, ``tcp://...``);
  unset means no group: every mesh is this one rank and every
  collective the identity (the reference's n = 1 case);
- ``TPKT_NUM_PROCESSES``, ``TPKT_PROCESS_ID`` — world size and rank;
- ``TPKT_LOCAL_DEVICE`` — the index of the card this rank runs on
  (default: the current card);
- ``TPKT_COORDINATOR_TIMEOUT_S`` — the rendezvous and collective
  timeout;
- ``TPKT_DIST_BACKEND`` — ``nccl`` (the default on the card) or
  ``gloo`` (the default on the CPU, and the way to put several ranks on
  one card: NCCL takes one rank a card; the collectives then stage card
  tensors through host memory, ``collectives.py``).

:func:`make_mesh` returns a :class:`Mesh` over the whole group, 1-D
(``n``) or 2-D (``(r, c)``, with its row and column sub-groups).
:func:`host_to_global` cuts this rank's block out of a full host copy
(every rank holds identical buffers, the reference's C contract) and
:func:`global_to_host` gathers the blocks back into the full result.
A spec is a tuple of mesh axis names a dimension, as the reference's
``PartitionSpec``: ``("x",)`` splits dim 0 over axis x, ``(("x", "y"),)``
over both axes of a 2-D mesh, ``()`` is replicated. Only dim 0 is split.

A mesh belongs to the group it was made on. :func:`leave` marks every
mesh of the group it destroys as left (:data:`LEFT` for its groups), so a
collective on a mesh of a left group raises :class:`GroupLeft` instead of
reaching the group joined after it; :func:`pinned` binds a thread's
:func:`make_mesh` to one mesh, so that a caller that resolved its group's
mesh first (the serving daemon's mesh tier) never runs on a later group.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import threading
from dataclasses import dataclass, field

import torch

from tpukernels_torch.utils import pick_device

_MESHES: dict = {}  # (axes, shape, device, group) -> Mesh
_LEAVE_AT_EXIT: list = []  # [True] once leave() is registered at exit
_PINNED = threading.local()  # .mesh: this thread's pinned mesh (pinned())


class GroupLeft(RuntimeError):
    """A mesh's process group was left (:func:`leave`) before its use."""


class _Left:
    """A left mesh's group: never None (a collective given None runs on
    the group that is current, the one joined since), and any use of it
    raises :class:`GroupLeft`."""

    def __getattr__(self, name):
        raise GroupLeft("this mesh's process group was left; a mesh of the "
                        "current group is needed")

    def __repr__(self):
        return "<left process group>"


LEFT = _Left()


def P(*axes) -> tuple:
    """A partition spec: the mesh axes each dimension is split over."""
    return tuple(axes)


def _dist():
    import torch.distributed as dist

    return dist


def _env_int(name: str) -> int:
    raw = os.environ.get(name)
    if raw is None:
        raise ValueError(f"{name} is required with TPKT_COORDINATOR_ADDRESS")
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an int") from None


def init_method(addr: str) -> str:
    """The rendezvous URL of ``TPKT_COORDINATOR_ADDRESS``: a URL as it
    is, ``host:port`` as ``tcp://host:port``."""
    return addr if "://" in addr else f"tcp://{addr}"


def local_device(requested=None) -> torch.device:
    """This rank's device: the card (``TPKT_LOCAL_DEVICE``, else the
    current one) unless ``requested`` names the CPU; raises when the
    card is asked for and there is none (``pick_device``)."""
    dev = pick_device(requested)
    if dev.type == "cuda" and dev.index is None:
        idx = os.environ.get("TPKT_LOCAL_DEVICE")
        dev = torch.device("cuda", int(idx) if idx is not None
                           else torch.cuda.current_device())
    return dev


def backend_for(device: torch.device) -> str:
    """``TPKT_DIST_BACKEND``, else ``nccl`` on the card and ``gloo`` on
    the CPU. NCCL cannot carry CPU tensors, so it raises for the CPU."""
    raw = os.environ.get("TPKT_DIST_BACKEND")
    backend = raw or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"TPKT_DIST_BACKEND={raw!r}: expected nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("TPKT_DIST_BACKEND=nccl carries card tensors only; "
                         f"this rank runs on {device}")
    return backend


def maybe_distributed_init(device=None) -> bool:
    """Join the process group the environment describes (see the
    module's docstring), with the backend for ``device`` (default: the
    card); returns whether a group is up. Idempotent: a process joins
    once, and every later call returns True. Without
    ``TPKT_COORDINATOR_ADDRESS`` it does nothing and returns False."""
    dist = _dist()
    if dist.is_initialized():
        return True
    addr = os.environ.get("TPKT_COORDINATOR_ADDRESS")
    if not addr:
        return False
    world = _env_int("TPKT_NUM_PROCESSES")
    rank = _env_int("TPKT_PROCESS_ID")
    if not 0 <= rank < world:
        raise ValueError(f"TPKT_PROCESS_ID={rank} out of range for "
                         f"TPKT_NUM_PROCESSES={world}")
    timeout = os.environ.get("TPKT_COORDINATOR_TIMEOUT_S")
    init_group(addr, world, rank, device,
               timeout_s=float(timeout) if timeout is not None else None)
    return True


def init_group(addr: str, world: int, rank: int, device=None,
               backend=None, timeout_s=None) -> str:
    """Join the group of ``world`` ranks at the rendezvous ``addr`` (see
    :func:`init_method`) as ``rank``, on ``device`` (:func:`local_device`)
    with ``backend`` (default :func:`backend_for`); ``timeout_s`` bounds
    the rendezvous and every collective (torch's default when None). The
    process leaves it at exit (:func:`leave`), or earlier by calling
    :func:`leave`, after which it may join another. Returns the
    backend."""
    dev = local_device(device)
    backend = backend or backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    _dist().init_process_group(backend, init_method=init_method(addr),
                               world_size=world, rank=rank, **kw)
    if not _LEAVE_AT_EXIT:
        _LEAVE_AT_EXIT.append(True)
        atexit.register(leave)
    return backend


def leave() -> None:
    """Destroy the process group, if one is up. A Python process that
    joined one leaves it at exit (registered by
    :func:`maybe_distributed_init`): a group left to the interpreter's
    teardown can abort the process (gloo's threads outlive the objects
    they use). Every mesh this process made lets go of its groups first
    (they are unusable after this), so the group objects die here, while
    the interpreter is whole, even where the caller still holds its
    meshes: destroyed during the interpreter's teardown instead, a gloo
    group aborted a two-rank process at exit ("terminate called without
    an active exception") about once in 600 runs. A C host never
    finalises the interpreter, so it never tears the group down
    either. Each of those groups becomes :data:`LEFT`, so a caller
    still holding such a mesh raises :class:`GroupLeft` at its next
    collective, whatever group is up by then."""
    dist = _dist()
    if not dist.is_initialized():
        return
    for mesh in _MESHES.values():
        if mesh.group is not None:
            object.__setattr__(mesh, "group", LEFT)
        for ax in mesh.axes.values():
            if ax.group is not None:
                object.__setattr__(ax, "group", LEFT)
    _MESHES.clear()
    dist.destroy_process_group()


@contextlib.contextmanager
def pinned(mesh: "Mesh"):
    """Within the block, this thread's :func:`make_mesh` returns ``mesh``
    (and raises ValueError for a mesh of another shape or device), never
    a mesh of the group current at the call; once this process has left
    ``mesh``'s group it raises :class:`GroupLeft` instead. Resolved
    before a call that may run late, it ties the call to its group."""
    prev = getattr(_PINNED, "mesh", None)
    _PINNED.mesh = mesh
    try:
        yield mesh
    finally:
        _PINNED.mesh = prev


def world() -> tuple:
    """``(rank, world size)`` of this process: ``(0, 1)`` without a
    group."""
    dist = _dist()
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    ``index`` along it, the global ``ranks`` along it (``ranks[index]``
    is this rank) and their process ``group`` (None at size 1)."""

    size: int
    index: int
    ranks: tuple
    group: object = None


@dataclass(frozen=True)
class Mesh:
    """A 1-D ring (``axis_names == ("x",)``) or an (r, c) mesh
    (``("x", "y")``; rank ``i·c + j`` at (i, j)) over the process group,
    on this rank's ``device``. ``shape`` maps each axis name to its size,
    as the reference's ``mesh.shape``; ``rank`` is this process's place
    in the mesh and ``group`` the group over all of it (None for one
    rank: every collective is then the identity). ``backend`` is the
    group's (None without one)."""

    axis_names: tuple
    shape: dict
    rank: int
    device: torch.device
    backend: str | None
    group: object = None
    axes: dict = field(default_factory=dict)  # name -> Axis

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    @property
    def host_staged(self) -> bool:
        """Whether the wire stages card tensors through host memory
        (gloo carries no card tensor)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def axis(self, name: str) -> Axis:
        try:
            return self.axes[name]
        except KeyError:
            raise ValueError(f"axis {name!r} not in mesh axes "
                             f"{self.axis_names}") from None


def _axis(dist, ranks, me) -> Axis:
    ranks = tuple(ranks)
    group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
    return Axis(len(ranks), ranks.index(me) if me in ranks else -1, ranks,
                group)


def make_mesh(n_devices=None, axis: str = "x", axes=("x", "y"),
              device=None) -> Mesh:
    """A mesh over this process group (default: every rank, 1-D).

    ``n_devices`` an int (or None) builds the 1-D ring named ``axis``;
    an ``(r, c)`` tuple builds the 2-D mesh named ``axes``, with a
    sub-group along each axis (every rank creates every sub-group, in
    the same order). It joins the group first (:func:`maybe_distributed_init`)
    and raises, as the reference does, when more ranks are asked for
    than the group has. A mesh covers the whole group, since each rank
    is one process: a mesh of fewer ranks than the group raises, except
    one rank, which is then this process alone (no group: every
    collective the identity, as without a group at all). ``device``: this
    rank's device (default: the card, ``TPKT_LOCAL_DEVICE``). Meshes
    are kept per process, so a caller asking again (the C entry, once a
    call) gets the same groups."""
    dev = local_device(device)
    pin = getattr(_PINNED, "mesh", None)
    if pin is None:
        maybe_distributed_init(dev)
        rank, have = world()
    else:
        rank, have = pin.rank, pin.size
    if isinstance(n_devices, (tuple, list)):
        r, c = (int(d) for d in n_devices)
        names, shape = tuple(axes), (r, c)
    else:
        n = have if n_devices is None else int(n_devices)
        names, shape = (axis,), (n,)
    if pin is not None:
        if pin.group is LEFT:
            raise GroupLeft(f"the pinned mesh's process group was left; "
                            f"no mesh {shape} of a later group is taken")
        if (names != pin.axis_names or dev != pin.device
                or shape != tuple(pin.shape[a] for a in names)):
            raise ValueError(f"a mesh {names}={shape} on {dev} asked for "
                             f"where the mesh {pin.axis_names}="
                             f"{tuple(pin.shape.values())} on {pin.device} "
                             "is pinned")
        return pin
    want = 1
    for d in shape:
        want *= d
    if want < 1:
        raise ValueError(f"requested a mesh of shape {shape}")
    if want > have:
        label = "x".join(map(str, shape))
        raise ValueError(f"requested {label}={want} devices, have {have}"
                         if len(shape) == 2 else
                         f"requested {want} devices, have {have}")
    if 1 < want < have:
        raise ValueError(f"requested {want} of {have} ranks: a mesh spans "
                         "the whole process group (one rank a process)")
    dist = _dist()
    # a group joined after one was destroyed makes new meshes
    key = (names, shape, str(dev),
           dist.group.WORLD if dist.is_initialized() else None)
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    if want < have or not dist.is_initialized():
        # this process alone: no group, every collective the identity
        mesh = Mesh(names, dict(zip(names, shape)), 0, dev, None, None,
                    {a: Axis(1, 0, (rank,)) for a in names})
    else:
        # the whole group, a group of one included (NCCL at world 1)
        group = dist.group.WORLD
        if len(shape) == 1:
            axes_ = {names[0]: Axis(want, rank, tuple(range(want)), group)}
        else:
            r, c = shape
            # along x: the ranks of one column j (i varies); along y: the
            # ranks of one row i
            xs = [_axis(dist, [i * c + j for i in range(r)], rank)
                  for j in range(c)]
            ys = [_axis(dist, [i * c + j for j in range(c)], rank)
                  for i in range(r)]
            axes_ = {names[0]: xs[rank % c], names[1]: ys[rank // c]}
        mesh = Mesh(names, dict(zip(names, shape)), rank, dev,
                    dist.get_backend(), group, axes_)
    _MESHES[key] = mesh
    return mesh


def _parts(mesh: Mesh, spec) -> tuple:
    """``(parts, index)``: how many blocks dim 0 is cut into under
    ``spec`` and which is this rank's."""
    spec = tuple(spec or ())
    if any(s is not None for s in spec[1:]):
        raise ValueError(f"spec {spec}: only dim 0 is split")
    if not spec or spec[0] is None:
        return 1, 0
    names = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    parts, index = 1, 0
    for name in names:
        ax = mesh.axis(name)
        parts, index = parts * ax.size, index * ax.size + ax.index
    return parts, index


def host_to_global(a, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of ``a``, a full copy every rank holds (numpy
    or a tensor), on the mesh's device: dim 0 cut into equal blocks
    over the axes ``spec`` names (``()``: the whole of ``a``)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    parts, index = _parts(mesh, spec)
    if parts > 1:
        if t.shape[0] % parts:
            raise ValueError(f"dim0={t.shape[0]} must divide across "
                             f"{parts} ranks")
        rows = t.shape[0] // parts
        t = t[index * rows:(index + 1) * rows]
    return t.to(mesh.device).contiguous()


def global_to_host(t: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The full value of blocks laid out as ``spec`` says, on every
    rank: the blocks gathered along dim 0 in mesh order (replicated
    values are returned as they are)."""
    parts, _ = _parts(mesh, spec)
    if parts == 1:
        return t
    from tpukernels_torch.parallel import collectives

    names = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    return collectives.all_gather_rows(t, mesh, names)
