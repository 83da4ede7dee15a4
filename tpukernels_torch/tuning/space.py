"""Declarative tunable knobs of the port's kernels.

A kernel's tunable surface is data: a :class:`SearchSpace` names each
knob (:class:`Tunable`), its ``TPKT_*`` environment spelling and its
shipped default. :func:`resolve` is the one resolution path every
wrapper calls, with the precedence

    env-override  >  shipped-default

Env parsing is fail-loud: ``TPKT_SAXPY_THREADS=abc`` raises a
ValueError naming the variable. A persistent tuned cache between the
two layers comes with the port's tuning slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Sequence


@dataclass(frozen=True)
class Tunable:
    """One knob: a positive int (block sizes, fusion depth) or a
    categorical choice (``choice=True``, one of ``values``)."""

    name: str
    env: str
    default: Any
    values: tuple = ()
    choice: bool = False

    def parse_env(self, raw: str):
        if self.choice:
            if raw not in self.values:
                raise ValueError(
                    f"{self.env}={raw!r}: expected one of "
                    + ", ".join(repr(v) for v in self.values)
                )
            return raw
        try:
            val = int(raw)
        except ValueError:
            val = 0
        if val <= 0:
            raise ValueError(
                f"{self.env}={raw!r}: expected a positive integer"
            )
        return val


@dataclass(frozen=True)
class SearchSpace:
    """The knobs of one registry kernel."""

    kernel: str
    tunables: tuple


def resolve(space: SearchSpace) -> dict:
    """Resolved knob values for one kernel call: a set env var wins
    (fail-loud parse), else the shipped default."""
    params = {}
    for t in space.tunables:
        raw = os.environ.get(t.env)
        params[t.name] = t.default if raw is None else t.parse_env(raw)
    return params


def spaces_of(module) -> Sequence[SearchSpace]:
    """A module's exported TUNABLES as a flat sequence."""
    tun = getattr(module, "TUNABLES", None)
    if tun is None:
        return ()
    if isinstance(tun, SearchSpace):
        return (tun,)
    return tuple(tun)
