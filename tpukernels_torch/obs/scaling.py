"""The device inventory of the port: what hardware a process ran on.

The port's copy of the inventory part of ``tpukernels/obs/scaling.py``
(``inventory``, ``emit_inventory``): :func:`emit_inventory` stamps one
``device_inventory`` journal event at the start of a process whose
evidence needs it: the serving daemon (``serve``), the fleet's router
(``serve_router``) and the bandwidth sweep (``busbw``). The dict has the
reference's keys; ``fake`` is True unless the platform is the card
(``cuda``), so a CPU rehearsal never reads as evidence from the card.

The reference's artifact writers and analyzers wait with ROADMAP.md
Queue A items 3 and 8. Standard library only at import: with
``probe=False`` nothing is imported, so the router, which never touches
the card, can stamp it.
"""

from __future__ import annotations

import os

from tpukernels_torch.resilience import journal

_REAL = ("cuda",)


def inventory(probe: bool = False) -> dict:
    """The hardware this process runs on, as a plain dict.

    ``probe=True`` reads ``torch.cuda`` (``source="torch"``): platform
    ``cuda`` or ``cpu``, the device kind of the tuning cache
    (``nvidia_h100_80gb_hbm3``), the devices, and ``process_index`` /
    ``process_count`` from ``torch.distributed`` when a group is up. It
    initialises CUDA, so only a process about to run on the card asks for
    it. ``probe=False`` imports nothing and derives the dict from
    ``CUDA_VISIBLE_DEVICES`` (``source="env"``). ``fake_basis`` says why
    ``fake`` is what it is, in the reference's words: ``probe`` (the
    runtime answered), ``declared-platform`` (the env named the devices,
    or none), ``unknown-platform`` (nothing declared them, the usual case:
    unknown, so fake, but not known fake) or ``unprobed-fallback`` (a
    probe was asked for and failed: fake whatever the env says)."""
    if probe:
        try:
            import torch

            from tpukernels_torch.tuning import cache as tcache

            on_card = torch.cuda.is_available()
            n = torch.cuda.device_count() if on_card else 1
            index, count = 0, 1
            if torch.distributed.is_available() and \
                    torch.distributed.is_initialized():
                index = torch.distributed.get_rank()
                count = torch.distributed.get_world_size()
            platform = "cuda" if on_card else "cpu"
            return {
                "source": "torch",
                "platform": platform,
                "device_kind": tcache.device_kind(platform),
                "n_devices": n,
                "local_devices": n,
                "process_index": index,
                "process_count": count,
                "fake": platform not in _REAL,
                "fake_basis": "probe",
            }
        except Exception:  # noqa: BLE001 — fall through to the env
            pass
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        platform, n = None, None
    else:
        ids = [d.strip() for d in visible.split(",") if d.strip()]
        # CUDA stops at the first invalid id: "-1" hides every card
        ids = ids[:next((i for i, d in enumerate(ids) if d == "-1"),
                        len(ids))]
        platform, n = ("cuda", len(ids)) if ids else ("cpu", 0)
    inv = {
        "source": "env",
        "platform": platform,
        "device_kind": None,
        "n_devices": n,
        "local_devices": None,
        "process_index": None,
        "process_count": None,
        "fake": platform not in _REAL,
        "fake_basis": ("declared-platform" if platform is not None
                       else "unknown-platform"),
    }
    if probe:
        inv["fake"] = True
        inv["fake_basis"] = "unprobed-fallback"
    return inv


def emit_inventory(site: str, probe: bool = False) -> dict:
    """Stamp one ``device_inventory`` event for this process (nothing
    when journaling is off) and return the inventory; ``probe`` as in
    :func:`inventory`."""
    inv = inventory(probe)
    journal.emit("device_inventory", site=site, **inv)
    return inv
