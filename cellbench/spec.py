"""What a run reads from ``BENCHMARK.json`` and the files it names.

Plain JSON and file lookups; no torch. A cell (one entry of
``workloads``) names its configuration and its traffic mix, each a data
file of its own under ``configs/`` and ``traffic/``; a metric is a
reader under ``metrics/``; a kernel key's inputs, work and reference are
modules under ``inputs/``, ``work/`` and ``reference/``. Adding any of
them is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    """One cell with its configuration and traffic read in."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def kernel(self) -> str:
        return self.config["kernel"]

    @property
    def statics(self) -> dict:
        """A call's keyword statics: the configuration's (``dt``,
        ``eps``), then the traffic's (``iters``, ``steps``)."""
        return {**self.config.get("statics", {}),
                **self.traffic.get("statics", {})}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "configs", f"{name}.json")


def traffic_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", f"{name}.json")


def metrics_for(bench: dict, kind: str, workload: dict) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it under ``workloads``, and those without the key that
    apply to every cell (a per-layer metric without it: every cell that
    reports the end-to-end metric it moves)."""
    name = workload["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def cell(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError if there is
    none."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(config_file(w["config"], here)),
                traffic=load_json(traffic_file(w["traffic"], here)),
                end_to_end=metrics_for(bench, "end_to_end", w),
                per_layer=metrics_for(bench, "per_layer", w))


def load_module(kind: str, name: str, here: str = HERE):
    """``<kind>/<name>.py`` as a module (names may hold ``.`` and
    ``-``, so it is loaded from its path); FileNotFoundError if absent."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cellbench: no {kind} module {path}")
    mod_name = f"cellbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod
