"""tpukernels_torch.serve — the serving daemon and fleet of the port.

The port's counterpart of ``tpukernels/serve/``:

- ``server.py`` (``python -m tpukernels_torch.serve``): a Unix-domain-socket
  daemon that runs every request through the port's ``registry.dispatch``
  on the card, with the reference's wire unchanged (``protocol.py``),
  shape bucketing onto the avatars of record (``bucketing.py``,
  ``aot.BENCH_CONFIGS``) and the client (``client.py``) that ``capi`` and
  ``chip_smoke.py`` use;
- the fleet: ``router.py`` (``python -m tpukernels_torch.serve.router``,
  one front socket over N daemons: md5 ring routing, spill, failover,
  drain, tenant quotas, deadlines, hedging), ``wal.py`` (its write-ahead
  log), ``health.py`` (crash detection, respawn, quarantine),
  ``guardian.py`` (``python -m tpukernels_torch.serve.guardian``, the
  router's supervisor), ``fleet.py`` (the layout on disk and the
  spawners) and ``ctl.py`` (``python -m tpukernels_torch.serve.ctl``,
  the operator's verbs); ``proc.py`` holds the knob parsers and the
  flocked pidfile they share with the daemon.

The adaptive bucket loop is ``adapt.py`` with ``optimize.py``
(``python -m tpukernels_torch.serve.optimize``; ``adapt.window_mix``
widens its evidence with the daily rollups of ``obs/rollup.py``). The
fleet's operations: ``top.py`` (``ctl top``, the live dashboard over the
``stats`` op) and ``chaos.py`` (``python -m
tpukernels_torch.serve.chaos``, the seeded chaos campaign, which ends
with ``python -m tpukernels_torch.obs.report --check`` over its own
journal). The mesh tier is ``mesh_tier.py``: with ``TPKT_SERVE_MESH=n``
a daemon keeps n - 1 follower ranks beside it, and an over-avatar
request that ``bucketing.mesh_tier_for`` admits runs on
``registry.dispatch_mesh`` over them.

Standard library and numpy at import; torch loads with ``server.py``, in
the daemons only: the router, health manager, guardian, ctl, top and the
campaign never import it.
"""

from tpukernels_torch.serve.client import (  # noqa: F401
    ServeClient,
    ServeError,
    ServeExpired,
    ServeRejected,
    default_socket_path,
)
