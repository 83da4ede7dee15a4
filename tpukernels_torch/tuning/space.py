"""Declarative tunable knobs of the port's kernels.

A kernel's tunable surface is data: a :class:`SearchSpace` names each
knob (:class:`Tunable`), its ``TPKT_*`` environment spelling, its
shipped default and its sweep values, plus an optional model of the
shared memory a block needs, so that candidates over the card's budget
are pruned before they are measured. :func:`resolve` is the one
resolution path every wrapper calls, per knob with the precedence

    env-override  >  tuned-cache  >  shipped-default

Env parsing is fail-loud: ``TPKT_SAXPY_THREADS=abc`` raises a
ValueError naming the variable. A value from the tuning cache
(:mod:`tpukernels_torch.tuning.cache`) is checked by the same rules but
rejected instead (counted, one stderr line, a ``tuning_rejected``
journal event, the default used): a bad cache file must never take down
a kernel call. A resolution that took a value from the cache journals
one ``tuning_resolved`` event per (kernel, shape, dtype) a process,
with each knob's source: the evidence that a run read a promoted entry.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Callable, Optional, Sequence

from tpukernels_torch.resilience import journal
from tpukernels_torch.tuning import cache

# shared memory one block of an H100 can use (NVIDIA's data sheet)
SMEM_BUDGET_BYTES = 232_448


@dataclass(frozen=True)
class Tunable:
    """One knob: a positive int (tile sizes, pipeline depth), at most
    ``most`` where that is set, or a categorical choice
    (``choice=True``, one of ``values``)."""

    name: str
    env: str
    default: Any
    values: tuple = ()
    choice: bool = False
    most: Optional[int] = None

    def _int_ok(self, v) -> bool:
        return 0 < v and (self.most is None or v <= self.most)

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
        if not self._int_ok(val):
            raise ValueError(
                f"{self.env}={raw!r}: expected a positive integer"
                + ("" if self.most is None else f" up to {self.most}")
            )
        return val

    def coerce_cached(self, v):
        """(ok, value) for a value from the cache: the rules of
        :meth:`parse_env`, but it never raises."""
        if self.choice:
            return (v in self.values), v
        ok = isinstance(v, int) and not isinstance(v, bool) and self._int_ok(v)
        return ok, v


@dataclass(frozen=True)
class SearchSpace:
    """The knobs of one registry kernel.

    ``sources`` are the repo-relative files whose newest commit dates a
    tuning-cache entry (an entry tuned before it is stale).
    ``bench_shape``/``bench_dtype`` are the configuration of record, the
    cache key a sweep writes for. ``metric`` is the bench metric
    (``python -m tpukernels_torch.bench``) a sweep of this space
    measures through, None when it has none. ``smem_bytes(params,
    shape)`` is the shared memory a block needs; candidates over
    ``smem_budget_bytes`` are pruned (both optional)."""

    kernel: str
    tunables: tuple
    sources: tuple = ()
    metric: Optional[str] = None
    bench_shape: Optional[tuple] = None
    bench_dtype: Optional[str] = None
    smem_budget_bytes: Optional[int] = None
    smem_bytes: Optional[Callable] = field(default=None, repr=False)

    def defaults(self) -> dict:
        return {t.name: t.default for t in self.tunables}

    @cached_property
    def envs(self) -> tuple:
        """The env variable of each knob, in declaration order."""
        return tuple(t.env for t in self.tunables)

    def env_for(self, params: dict) -> dict:
        """Env assignments selecting ``params`` in a subprocess (None
        values are left unset)."""
        by_name = {t.name: t for t in self.tunables}
        return {by_name[k].env: str(v) for k, v in params.items()
                if k in by_name and v is not None}

    def feasible(self, params: dict, shape=None) -> bool:
        if self.smem_bytes is None or self.smem_budget_bytes is None:
            return True
        return self.smem_bytes(params, shape) <= self.smem_budget_bytes

    def candidates(self, shape=None):
        """Sweep candidates, shipped defaults first (the control row),
        then the product of the sweep values in declaration order, each
        once, those over the budget pruned. Returns (candidates,
        n_pruned)."""
        axes = [t.values or (t.default,) for t in self.tunables]
        names = [t.name for t in self.tunables]
        out, pruned, seen = [], 0, set()
        for params in itertools.chain(
                [self.defaults()],
                (dict(zip(names, combo)) for combo in itertools.product(*axes))):
            key = tuple(sorted(params.items()))
            if key in seen:
                continue
            seen.add(key)
            if self.feasible(params, shape):
                out.append(params)
            else:
                pruned += 1
        return out, pruned

    def quick_candidates(self, shape=None):
        """The control plus single-axis probes of the first declared
        knob, at most 3 rows."""
        cands, _ = self.candidates(shape=shape)
        if not cands:
            return []
        first, rest = self.tunables[0], self.tunables[1:]
        probes = [c for c in cands[1:] if c[first.name] != first.default
                  and all(c[t.name] == t.default for t in rest)]
        return (cands[:1] + probes)[:3]


# (kernel, shape, dtype) whose cache-sourced resolution this process has
# journaled: a wrapper called in a loop journals it once
_JOURNALED: set = set()


def resolve_with_sources(space: SearchSpace, shape=None, dtype=None,
                         device=None):
    """``(params, sources)`` for one kernel call: per knob a set env var
    (fail-loud), else a valid tuning-cache entry for (kernel, shape,
    dtype, the kind of ``device``), else the default; ``sources`` says
    which (``env``/``cache``/``default``) for each knob."""
    cached = cache.get(space, shape, dtype, device=device)
    params, sources = {}, {}
    for t in space.tunables:
        raw = os.environ.get(t.env)
        if raw is not None:
            params[t.name], sources[t.name] = t.parse_env(raw), "env"
            continue
        if cached is not None and t.name in cached:
            ok, v = t.coerce_cached(cached[t.name])
            if ok:
                params[t.name], sources[t.name] = v, "cache"
                continue
            cache.reject(cache.key_str(space.kernel, shape, dtype,
                                       cache.device_kind(device)),
                         f"bad cached value for {t.name}: "
                         f"{cached[t.name]!r}", kernel=space.kernel)
        params[t.name], sources[t.name] = t.default, "default"
    if "cache" in sources.values():
        memo = (space.kernel, repr(shape), repr(dtype))
        if memo not in _JOURNALED:
            _JOURNALED.add(memo)
            journal.emit("tuning_resolved", kernel=space.kernel,
                         shape=list(shape) if shape else None,
                         dtype=cache.canon_dtype(dtype), params=params,
                         sources=sources)
    return params, sources


def resolve(space: SearchSpace, shape=None, dtype=None, device=None) -> dict:
    """Resolved knob values for one kernel call (see
    :func:`resolve_with_sources`)."""
    return resolve_with_sources(space, shape, dtype, device)[0]


_PLANS: dict = {}  # memo of plan_memo(): key -> (cache state, plan)
_PLANS_MAX = 256


def plan_memo(space, key, make: Callable, *args):
    """``make(*args)``, memoised per process: a wrapper's launch plan,
    built from :func:`resolve` and the device, costs a lookup once it is
    made. ``space`` is the :class:`SearchSpace` whose knobs the plan
    reads, or a tuple of them for a plan that reads several. The memo is
    keyed on ``key`` (the call's shape and device), the raw env value of
    every knob of ``space`` and the tuning cache's state
    (:func:`cache.state`), so a changed env knob or cache entry takes
    effect on the next call, as an unmemoised resolve would."""
    state = cache.state()
    if isinstance(space, SearchSpace):
        names, envs = space.kernel, space.envs
    else:
        names = tuple(sp.kernel for sp in space)
        envs = tuple(e for sp in space for e in sp.envs)
    memo_key = (names, key, id(state), *map(cache.env_raw, envs))
    hit = _PLANS.get(memo_key)
    if hit is not None and hit[0] is state:
        return hit[1]
    made = make(*args)
    if len(_PLANS) >= _PLANS_MAX:  # states come and go; keep it small
        _PLANS.clear()
    _PLANS[memo_key] = (state, made)
    return made


def forget(kernel: str) -> int:
    """Drop the memoised launch plans of ``kernel``, those of plans that
    read its knobs among others' included; returns how many were
    dropped. The integrity guard calls it when a result of ``kernel``
    fails a check, so that the next call builds its plan afresh."""
    # list() copies the keys in one step: another thread may add a plan
    drop = [k for k in list(_PLANS)
            if k[0] == kernel or (isinstance(k[0], tuple) and kernel in k[0])]
    for k in drop:
        _PLANS.pop(k, None)
    return len(drop)


def spaces_of(module) -> Sequence[SearchSpace]:
    """A module's exported TUNABLES as a flat sequence."""
    tun = getattr(module, "TUNABLES", None)
    if tun is None:
        return ()
    if isinstance(tun, SearchSpace):
        return (tun,)
    return tuple(tun)
