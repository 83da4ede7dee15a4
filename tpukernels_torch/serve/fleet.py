"""Fleet layout and process lifecycle of the port's serving fleet.

The port's copy of ``tpukernels/serve/fleet.py``. One fleet is one
front-end router (``serve/router.py``) and N worker daemons, each a
plain ``python -m tpukernels_torch.serve`` on its own socket, pidfile
and log. This module owns where all of that lives on disk and how the
processes are spawned; the fleet verbs of ``python -m
tpukernels_torch.serve.ctl`` are thin over it.

Layout (under :func:`fleet_dir`, default ``<serve_dir>/fleet``;
``TPKT_SERVE_FLEET_DIR`` redirects it):

    fleet.json          # config of record: front socket + workers
    front.sock          # the router's socket: point clients here
    router.pid          # the router's flocked pidfile
    router.log          # the router's stderr
    guardian.pid        # the guardian's flocked pidfile (and .log)
    router.wal          # the router's write-ahead log (serve/wal.py)
    worker0/            # worker 0's TPKT_SERVE_DIR: socket, pidfile,
    worker1/            # daemon log, one directory a worker
    ...

Each worker is spawned with ``TPKT_SERVE_WORKER_ID=<i>``, the hook a
``TPKT_FAULT_PLAN`` ``env`` clause uses to fault ONE worker of a
fleet. ``TPKT_SERVE_SOCKET`` is scrubbed from every child: it is the
client's routing switch, and a fleet member resolving its own socket
through it would dispatch into itself. ``TPKT_SERVE_DEVICE`` passes
through unchanged, so the workers serve on the card unless the caller
asks for the CPU, and so does ``TPKT_SERVE_MESH``: each worker then
keeps its own mesh tier of follower ranks (``serve/mesh_tier.py``). A child whose caller chose no journal
(``TPKT_HEALTH_JOURNAL`` unset) journals into the caller's serve
directory, so the router and every worker write one dated file
(the reference's members all default to its one dated repo file).

Only the workers touch the card: this module, the router, the health
manager and the guardian import no torch. Standard library at import.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from tpukernels_torch import _cachedir


def fleet_dir(env=None) -> str:
    """``TPKT_SERVE_FLEET_DIR`` when set, else ``fleet/`` under the
    serve directory (read from the env on every call)."""
    target = os.environ if env is None else env
    d = target.get("TPKT_SERVE_FLEET_DIR")
    if d:
        return d
    return os.path.join(_cachedir.serve_dir(env), "fleet")


def config_path(env=None) -> str:
    return os.path.join(fleet_dir(env), "fleet.json")


def front_socket_path(env=None) -> str:
    return os.path.join(fleet_dir(env), "front.sock")


def router_pidfile_path(env=None) -> str:
    return os.path.join(fleet_dir(env), "router.pid")


def guardian_pidfile_path(env=None) -> str:
    return os.path.join(fleet_dir(env), "guardian.pid")


def wal_path(env=None) -> str:
    """The router's durable-admission log (``serve/wal.py``), beside
    fleet.json so a respawned router finds its predecessor's replay
    debt."""
    return os.path.join(fleet_dir(env), "router.wal")


def worker_dir(i: int, env=None) -> str:
    return os.path.join(fleet_dir(env), f"worker{i}")


def worker_socket_path(i: int, env=None) -> str:
    return os.path.join(worker_dir(i, env), "serve.sock")


def load_config():
    """The fleet.json config of record, or None when no fleet was
    started here. A file that does not parse reads as no fleet, loudly
    (``_cachedir.note_torn_artifact``): start-fleet rewrites it, ``ctl
    fsck`` reaps it."""
    try:
        with open(config_path()) as f:
            cfg = json.load(f)
    except OSError:
        return None
    except ValueError as e:
        _cachedir.note_torn_artifact(config_path(), str(e))
        return None
    if not isinstance(cfg, dict) or not cfg.get("workers"):
        return None
    return cfg


def write_config(front: str, workers) -> dict:
    from tpukernels_torch.resilience import atomic

    cfg = {
        "front": front,
        "workers": list(workers),
        "written": round(time.time(), 3),
        "pid": os.getpid(),
    }
    d = fleet_dir()
    os.makedirs(d, exist_ok=True)
    # fsync'd tmp + rename: a respawned router or guardian rebuilds the
    # fleet from this file, so it must read as old-or-new across a crash
    atomic.dump_json(config_path(), cfg)
    return cfg


def _child_env(extra=None) -> dict:
    """A fleet child's environment: the caller's env minus the client
    routing switch, the journal pinned (module docstring), plus
    overrides."""
    env = dict(os.environ)
    env.pop("TPKT_SERVE_SOCKET", None)
    env.setdefault("TPKT_HEALTH_JOURNAL", _cachedir.serve_dir())
    env.update(extra or {})
    return env


def _spawn(argv, repo: str, log_path: str, env: dict):
    """Start ``argv`` detached (its own session), stdout discarded,
    stderr appended to ``log_path``."""
    log = open(log_path, "a")
    try:
        return subprocess.Popen(
            argv, cwd=repo, start_new_session=True,
            stdout=subprocess.DEVNULL, stderr=log, env=env,
        )
    finally:
        log.close()


def spawn_worker(i: int, repo: str, d=None):
    """Spawn worker ``i`` on its own socket and dir; returns (proc,
    socket_path). ``d`` overrides the worker dir: the health manager
    respawns a dead worker at the exact dir and socket the router
    already points at, not wherever the current env resolves
    ``worker_dir(i)``."""
    if d is None:
        d = worker_dir(i)
    os.makedirs(d, exist_ok=True)
    sock = os.path.join(d, "serve.sock")
    proc = _spawn(
        [sys.executable, "-m", "tpukernels_torch.serve", "--socket", sock],
        repo, os.path.join(d, "serve_daemon.log"),
        _child_env({"TPKT_SERVE_DIR": d, "TPKT_SERVE_WORKER_ID": str(i)}),
    )
    return proc, sock


def spawn_guardian(repo: str):
    """Spawn the router's guardian (``serve/guardian.py``); returns the
    Popen."""
    d = fleet_dir()
    os.makedirs(d, exist_ok=True)
    return _spawn([sys.executable, "-m", "tpukernels_torch.serve.guardian"],
                  repo, os.path.join(d, "guardian.log"), _child_env())


def spawn_router(front: str, worker_sockets, repo: str):
    """Spawn the router on the front socket over the given worker
    sockets; returns the Popen."""
    d = fleet_dir()
    os.makedirs(d, exist_ok=True)
    argv = [sys.executable, "-m", "tpukernels_torch.serve.router",
            "--socket", front]
    for w in worker_sockets:
        argv += ["--worker", w]
    return _spawn(argv, repo, os.path.join(d, "router.log"), _child_env())
