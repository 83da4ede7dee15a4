"""tpukernels_torch.serve — the serving daemon of the port.

The port's counterpart of ``tpukernels/serve/``: a Unix-domain-socket
daemon (``server.py``, ``python -m tpukernels_torch.serve``) that runs
every request through the port's ``registry.dispatch`` on the card, the
reference's wire protocol unchanged (``protocol.py``), shape bucketing
onto the avatars of record (``bucketing.py``, ``aot.BENCH_CONFIGS``)
and the client (``client.py``) that ``capi`` and ``chip_smoke.py`` use.
The reference's fleet (router, health manager, guardian, WAL) and its
adaptive buckets wait (ROADMAP.md).

Standard library and numpy at import; torch loads with ``server.py``.
"""

from tpukernels_torch.serve.client import (  # noqa: F401
    ServeClient,
    ServeError,
    ServeExpired,
    ServeRejected,
    default_socket_path,
)
