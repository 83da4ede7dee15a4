"""The least time the card could take for one call's work: the larger of
its bytes over the memory rate and its operations over the peak rate of
their type (``peaks.json``)."""

from __future__ import annotations

import os

from cellbench import spec

RATES = ("fp32_flops", "bf16_flops")  # keys of a work dict and of a card


def peaks(card_name: str) -> dict:
    """The row of ``peaks.json`` whose ``match`` the card's name holds;
    the last row (the H100 SXM) where none does."""
    cards = spec.load_json(os.path.join(spec.HERE, "peaks.json"))["cards"]
    for row in cards:
        if row["match"] in card_name:
            return row
    return cards[-1]


def least_seconds(work: dict, card: dict) -> tuple:
    """``(seconds, bound_by)``: ``bytes`` or the operation type whose
    time is the larger."""
    best = (work.get("bytes", 0) / card["hbm_bytes_s"], "bytes")
    for key in RATES:
        if work.get(key):
            t = work[key] / card[key]
            if t > best[0]:
                best = (t, key)
    return best


def kernel_roofline(rec: dict, symbol: str):
    """A kernel's share of its roofline, in %: the calls of the traced
    sub-window times the least time of one call's work
    (``work/<kernel>.py`` over ``peaks.json``), over the device time of
    the operations whose name holds ``symbol``. Nothing where the
    sub-window ran no such operation: a kernel off the path is silent,
    never 0."""
    p = rec.get("profile")
    least = rec.get("least_s_per_call")
    if not p or not least:
        return None
    t = sum(v for k, v in p["by_name"].items() if symbol in k)
    if t <= 0:
        return None
    return 100.0 * p["calls"] * least / t
