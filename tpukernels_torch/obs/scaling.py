"""Scaling observability of the port's distributed layer.

The port's copy of ``tpukernels/obs/scaling.py``:

- **Device inventory** (:func:`inventory`, :func:`emit_inventory`): one
  ``device_inventory`` journal event at the start of a process whose
  evidence needs it: the serving daemon (``serve``), the fleet's router
  (``serve_router``), the bandwidth sweep (``busbw``), the overlap probe
  (``overlap``), the weak-scaling ranks (``weak_scaling``) and the dry
  run's ranks (``dryrun``). The dict has the reference's keys; ``fake``
  is True unless the platform is the card (``cuda``), so a CPU rehearsal
  never reads as evidence from the card, and True as well where the
  group's ranks outnumber the cards (``fake_basis`` ``shared-card``:
  four gloo ranks on one H100 measure contention on that card, not
  scaling across cards).
- **Artifacts** (:func:`write_busbw_artifact`,
  :func:`write_overlap_artifact`, :func:`write_weak_artifact`): one JSON
  file a sweep in :func:`scaling_dir` (``$TPKT_SCALING_DIR``, else
  ``.tpkt_cache/scaling``), in the reference's ``tpk_scaling_v1`` schema
  field for field, written atomically (``resilience/atomic.py``).
- **Series and verdicts** (:func:`analyze_repo`): bus bandwidth per (op,
  size, ranks) gets ``regression`` / ``impossible`` (above the card's
  link bound, :data:`LINK_CEILINGS`) / ``no_data`` / ``ok``; weak
  scaling gets the non-gating ``below_scaling_efficiency`` under
  ``TPKT_SCALING_MIN_EFF``; overlap the non-gating ``overlap_low`` under
  ``TPKT_OVERLAP_MIN_FRAC``. Fake artifacts (the CPU, a shared card) are
  loaded and reported and never judged: only :func:`gating_findings`
  gates, and it holds validated bandwidth verdicts alone.
- **The dry run** (:func:`parse_dryrun_tail`, :func:`analyze_dryrun`):
  the port's ``python -m tpukernels_torch.dryrun`` prints the
  reference's ``[dryrun +T.Ts] <program>`` lines and
  ``MULTICHIP-PROGRAMS:`` line and writes its artifact where
  ``TPKT_MULTICHIP_ARTIFACT`` says; :func:`analyze_dryrun` reads the
  ``multichip_*.json`` artifacts in the scaling directory. The
  reference's ``load_multichip`` over the repository's
  ``MULTICHIP_r*.json`` is not ported: those rounds are dry runs of the
  JAX package on fake CPU devices, made for the TPU, and no run of the
  port is among them.

The bound between cards is the H100's, not a TPU's interconnect: see
:data:`LINK_CEILINGS`. Standard library only at import: with
``probe=False`` nothing is imported, so the router, which never touches
the card, can stamp its inventory.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re
import time

from tpukernels_torch._cachedir import scaling_dir
from tpukernels_torch.resilience import journal

SCHEMA = "tpk_scaling_v1"
DEFAULT_MIN_EFF = 0.5
DEFAULT_OVERLAP_MIN_FRAC = 0.3

_REAL = ("cuda",)
_DRYRUN_LINE_RE = re.compile(r"\[dryrun \+\s*([0-9.]+)s\] (.+)")
_PROGRAMS_LINE = "MULTICHIP-PROGRAMS: "

# The most a link can carry, GB/s, by device kind: the bound a bus
# bandwidth point is judged against (above it: ``impossible``). From the
# H100 SXM data sheet (https://www.nvidia.com/en-us/data-center/h100/,
# "Interconnect"): NVLink 900 GB/s a card, 450 GB/s each way, bounds a
# ring all-reduce's bus bandwidth and a ring shift's per-link rate
# (``link_gb_s``); PCIe Gen5 128 GB/s, 64 GB/s each way, bounds ranks on
# other hosts, whose bytes leave the card through it (``net_gb_s``). At
# one rank no link is crossed: the sweep's figure is the degenerate copy
# rate, bytes / t, bounded by the card's memory, 3.35 TB/s on the same
# sheet (``local_gb_s``). The ``cpu`` row is loose plumbing: CPU
# evidence is fake and never judged.
LINK_CEILINGS = {
    "nvidia_h100_80gb_hbm3": {"link_gb_s": 450.0, "net_gb_s": 64.0,
                              "local_gb_s": 3350.0},
    "cpu": {"link_gb_s": 100.0, "net_gb_s": 100.0, "local_gb_s": 100.0},
}
EVIDENCE_KIND = "nvidia_h100_80gb_hbm3"

# The weak-scaling programs (``parallel/weak_scaling.PROGRAMS`` is held
# to these keys): each one's artifact series and what per-rank work is.
WEAK_SERIES = {
    "stencil2d": {
        "series": "weak/stencil2d",
        "work_unit": "rows/rank x cols (iters fixed)",
    },
    "nbody_ring": {
        "series": "weak/nbody_ring",
        "work_unit": "bodies/rank (O(N^2) total = linear/rank when "
                     "i-bodies split)",
    },
    "scan_hist": {
        "series": "weak/scan_hist",
        "work_unit": "elements/rank (scan + 256-bin histogram)",
    },
    "allreduce": {
        "series": "weak/allreduce",
        "work_unit": "f32 elements/rank in the all-reduce message",
    },
    "allreduce2d": {
        "series": "weak/allreduce2d",
        "work_unit": "f32 elements/rank, two-phase over an (r, c) mesh "
                     "(reduce-scatter along x, all-reduce along y, "
                     "all-gather along x)",
    },
}

# Whether each weak-scaling program's communication can hide under its
# compute (``depth``: ``TPKT_DIST_DEPTH`` pipelines it) or why not.
OVERLAP_CAPS = {
    "stencil2d": {
        "mode": "depth",
        "why": "at depth 2 the next round's k-deep halos leave before "
               "the bulk sweep (collectives._jacobi_dist)",
    },
    "nbody_ring": {
        "mode": "depth",
        "why": "the j-block ring keeps depth hops in flight ahead of "
               "the force block (collectives.nbody_dist_ring)",
    },
    "scan_hist": {
        "mode": "exempt",
        "why": "one all-gather / all-reduce after all local compute: "
               "there is no second hop to overlap with",
    },
    "allreduce": {
        "mode": "exempt",
        "why": "a single all-reduce; nothing else runs beside it",
    },
    "allreduce2d": {
        "mode": "exempt",
        "why": "phases in a chain (each consumes the last one's "
               "partials); nothing independent to overlap",
    },
}


def _fraction_knob(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not 0.0 <= val <= 1.0:
        raise ValueError(f"{name}={raw!r}: expected a float in [0, 1]")
    return val


def min_eff() -> float:
    """``TPKT_SCALING_MIN_EFF`` (default 0.5): the weak-scaling
    efficiency under which the largest group's point earns the
    non-gating ``below_scaling_efficiency``; a value outside [0, 1]
    raises."""
    return _fraction_knob("TPKT_SCALING_MIN_EFF", DEFAULT_MIN_EFF)


def overlap_min_frac() -> float:
    """``TPKT_OVERLAP_MIN_FRAC`` (default 0.3): the overlap fraction
    under which a validated point earns the non-gating ``overlap_low``;
    a value outside [0, 1] raises."""
    return _fraction_knob("TPKT_OVERLAP_MIN_FRAC", DEFAULT_OVERLAP_MIN_FRAC)


def ceiling_gb_s(op: str, kind=None, net: bool = False, local: bool = False):
    """``(GB/s, kind, basis)``: the bound of a bandwidth point of ``op``
    on ``kind`` (default the card's) between cards of one host, across
    hosts (``net``) or at one rank (``local``). Another H100 variant
    borrows the H100 row (basis ``assumed-<kind>``); any other kind the
    ``cpu`` row (``cpu-fallback``)."""
    if kind is None:
        kind = EVIDENCE_KIND
    basis = "exact"
    if kind in LINK_CEILINGS:
        row = LINK_CEILINGS[kind]
    elif str(kind).startswith("nvidia_h100"):
        row, basis = LINK_CEILINGS[EVIDENCE_KIND], f"assumed-{EVIDENCE_KIND}"
    else:
        row, basis = LINK_CEILINGS["cpu"], "cpu-fallback"
    col = "local_gb_s" if local else "net_gb_s" if net else "link_gb_s"
    return row[col], kind, basis


# ------------------------------------------------------------------ #
# device inventory                                                   #
# ------------------------------------------------------------------ #

def inventory(probe: bool = False, device=None) -> dict:
    """The hardware this process runs on, as a plain dict.

    ``probe=True`` reads ``torch.cuda`` (``source="torch"``): platform
    ``cuda`` or ``cpu`` (the type of ``device`` when the caller names the
    device it runs on, so a run asked onto the CPU of a host with a card
    is stamped ``cpu``; else whether a card answers), the device kind of
    the tuning cache (``nvidia_h100_80gb_hbm3``), the devices, and
    ``process_index`` / ``process_count`` from ``torch.distributed`` when
    a group is up. It initialises CUDA, so only a process about to run
    on the card asks for it. ``probe=False`` imports nothing and derives
    the dict from ``CUDA_VISIBLE_DEVICES`` (``source="env"``). ``fake_basis`` says why
    ``fake`` is what it is, in the reference's words: ``probe`` (the
    runtime answered), ``declared-platform`` (the env named the devices,
    or none), ``unknown-platform`` (nothing declared them, the usual case:
    unknown, so fake, but not known fake) or ``unprobed-fallback`` (a
    probe was asked for and failed: fake whatever the env says); and the
    port's own ``shared-card``: the card answered, but the group has more
    ranks than this host has cards, so they took turns on one."""
    if probe:
        try:
            import torch

            from tpukernels_torch.tuning import cache as tcache

            on_card = torch.cuda.is_available() and (
                device is None or torch.device(device).type == "cuda")
            n = torch.cuda.device_count() if on_card else 1
            index, count = 0, 1
            if torch.distributed.is_available() and \
                    torch.distributed.is_initialized():
                index = torch.distributed.get_rank()
                count = torch.distributed.get_world_size()
            platform = "cuda" if on_card else "cpu"
            shared = on_card and count > n
            return {
                "source": "torch",
                "platform": platform,
                "device_kind": tcache.device_kind(platform),
                "n_devices": n,
                "local_devices": n,
                "process_index": index,
                "process_count": count,
                "fake": platform not in _REAL or shared,
                "fake_basis": "shared-card" if shared else "probe",
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


def emit_inventory(site: str, probe: bool = False, device=None) -> dict:
    """Stamp one ``device_inventory`` event for this process (nothing
    when journaling is off) and return the inventory; ``probe`` and
    ``device`` as in :func:`inventory`."""
    inv = inventory(probe, device)
    journal.emit("device_inventory", site=site, **inv)
    return inv


# ------------------------------------------------------------------ #
# artifact writers                                                   #
# ------------------------------------------------------------------ #

def _write(prefix: str, payload: dict, out_dir=None) -> str:
    from tpukernels_torch.resilience import atomic

    d = out_dir or scaling_dir()
    os.makedirs(d, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    path = os.path.join(d, f"{prefix}_{stamp}_{os.getpid()}.json")
    payload = dict(payload)
    payload.setdefault("schema", SCHEMA)
    payload.setdefault("git_head", journal.git_head())
    payload.setdefault("recorded", round(time.time(), 3))
    atomic.dump_json(path, payload)
    return path


def write_busbw_artifact(points, op: str, n_devices: int, inv: dict,
                         out_dir=None, mesh_shape=None) -> str:
    """Persist one bandwidth sweep: ``points`` is ``busbw.sweep``'s
    ``[(size_bytes, seconds, gb_s), ...]``. ``mesh_shape`` is the
    ``(rows, cols)`` of a 2-D sweep (None, the 1-D ring, leaves the key
    out, as the reference does)."""
    payload = {
        "family": "busbw",
        "op": op,
        "n_devices": int(n_devices),
        "fake": bool(inv.get("fake", True)),
        "device_inventory": inv,
        "points": [
            {"size_bytes": int(s), "seconds": sec, "gb_s": bw}
            for s, sec, bw in points
        ],
    }
    if mesh_shape is not None:
        payload["mesh_shape"] = [int(d) for d in mesh_shape]
    return _write(f"scaling_busbw_{op}", payload, out_dir)


def write_overlap_artifact(points, inv: dict, out_dir=None) -> str:
    """Persist one overlap probe (``parallel/overlap.py``): ``points``
    is a list of ``{op, n_devices, mesh_shape, depth, t_comm_s,
    t_compute_s, t_full_s, overlap_frac}``."""
    return _write("scaling_overlap", {
        "family": "overlap",
        "fake": bool(inv.get("fake", True)),
        "device_inventory": inv,
        "points": list(points),
    }, out_dir)


def write_weak_artifact(points, inv: dict, out_dir=None) -> str:
    """Persist one weak-scaling sweep (``parallel/weak_scaling.py``):
    ``points`` is a list of ``{program, n_devices, wall_s,
    per_chip_work, ok}``."""
    return _write("scaling_weak", {
        "family": "weak_scaling",
        "fake": bool(inv.get("fake", True)),
        "device_inventory": inv,
        "points": list(points),
    }, out_dir)


# ------------------------------------------------------------------ #
# loaders                                                            #
# ------------------------------------------------------------------ #

def _read_json(p):
    try:
        with open(p) as f:
            return json.loads(f.read().strip() or "null")
    except (OSError, ValueError):
        return None


def load_artifacts(d=None) -> list:
    """Every ``scaling_*.json`` artifact in ``d`` (default
    :func:`scaling_dir`), ordered by file name (their time stamps).
    A file that does not parse, or holds no ``points`` list, is skipped:
    a truncated artifact must not take down the report that would
    explain it."""
    d = d or scaling_dir()
    out = []
    for p in sorted(glob.glob(os.path.join(d, "scaling_*.json")),
                    key=os.path.basename):
        rec = _read_json(p)
        if isinstance(rec, dict) and isinstance(rec.get("points"), list):
            rec["_source"] = os.path.basename(p)
            out.append(rec)
    return out


def parse_dryrun_tail(tail: str) -> list:
    """Per-program walls from a dry run's output, as the reference reads
    it: the ``MULTICHIP-PROGRAMS: {...}`` line when there is one; else
    the ``[dryrun +T.Ts] <name>`` lines, stamps printed at each program's
    start, so a program's wall is the next stamp minus its own (the
    closing ``all programs OK`` stamp ends the last)."""
    if not isinstance(tail, str):
        return []
    for line in reversed(tail.strip().splitlines()):
        line = line.strip()
        if line.startswith(_PROGRAMS_LINE):
            try:
                rec = json.loads(line[len(_PROGRAMS_LINE):])
            except ValueError:
                break
            progs = rec.get("programs")
            if isinstance(progs, list):
                return [p for p in progs if isinstance(p, dict)]
            break
    stamps = []
    for line in tail.splitlines():
        m = _DRYRUN_LINE_RE.search(line)
        if m:
            stamps.append((float(m.group(1)), m.group(2).strip()))
    out = []
    for (t, name), (t_next, _n2) in zip(stamps, stamps[1:]):
        if name.startswith("importing") or name.startswith("all programs"):
            continue
        name = name.split(" (")[0].strip()
        out.append({"name": name, "wall_s": round(t_next - t, 3),
                    "ok": True})
    return out


def load_dryruns(d=None) -> list:
    """``[{n_devices, ok, fake, programs, _source}]`` over the dry run's
    artifacts (``multichip_*.json``) in ``d`` (default
    :func:`scaling_dir`), by file name."""
    d = d or scaling_dir()
    out = []
    for p in sorted(glob.glob(os.path.join(d, "multichip_*.json")),
                    key=os.path.basename):
        rec = _read_json(p)
        if not isinstance(rec, dict):
            continue
        progs = rec.get("programs")
        if not isinstance(progs, list):
            progs = parse_dryrun_tail(rec.get("tail"))
        inv = rec.get("device_inventory") or {}
        out.append({
            "n_devices": rec.get("n_devices"),
            "ok": bool(rec.get("ok")),
            "fake": bool(inv.get("fake", True)),
            "programs": [p for p in progs if isinstance(p, dict)],
            "_source": os.path.basename(p),
        })
    return out


# ------------------------------------------------------------------ #
# series + verdicts                                                  #
# ------------------------------------------------------------------ #

def busbw_series(artifacts) -> dict:
    """``{(op, size_bytes, n_devices, mesh_shape): [point, ...]}`` in
    artifact order; each point carries its value, ``fake`` and source.
    A 1-D sweep's ``mesh_shape`` is None."""
    out: dict = {}
    for art in artifacts:
        if art.get("family") != "busbw":
            continue
        fake = bool(art.get("fake", True))
        op = art.get("op") or "?"
        nd = art.get("n_devices")
        ms = art.get("mesh_shape")
        mesh_shape = tuple(int(d) for d in ms) \
            if isinstance(ms, (list, tuple)) and len(ms) == 2 else None
        inv = art.get("device_inventory") or {}
        kind = inv.get("device_kind")
        inv_source = inv.get("source")
        # ranks of more than one host: the bytes leave the card over PCIe
        pc, local = inv.get("process_count"), inv.get("local_devices")
        net = (isinstance(pc, int) and isinstance(local, int)
               and pc > local)
        for pt in art["points"]:
            if not isinstance(pt, dict):
                continue
            gbs = pt.get("gb_s")
            if not isinstance(gbs, (int, float)) or isinstance(gbs, bool):
                continue
            key = (op, pt.get("size_bytes"), nd, mesh_shape)
            out.setdefault(key, []).append({
                "value": gbs,
                "fake": fake,
                "device_kind": kind,
                "inv_source": inv_source,
                "net": net,
                "local": nd == 1,
                "source": art.get("_source", "?"),
                # marked invalid where it was taken: reported, never
                # evidence
                "invalidated": pt.get("invalidated"),
            })
    return out


def analyze_busbw(artifacts, eps: float) -> dict:
    """Verdicts per (op, size, ranks): only points that are not fake and
    carry a probed inventory (``source`` ``torch``) are evidence; a
    series without one is ``no_data``, never a regression and never
    impossible."""
    verdicts = {}
    for (op, size, nd, mesh_shape), pts in sorted(
        busbw_series(artifacts).items(),
        key=lambda kv: (kv[0][0], kv[0][2] or 0, kv[0][1] or 0,
                        kv[0][3] or ()),
    ):
        name = f"busbw/{op}/n{nd}/{size}B"
        if mesh_shape is not None:
            name += f"/mesh{mesh_shape[0]}x{mesh_shape[1]}"
        flags = []
        impossible = False
        valid = []
        for p in pts:
            if p["fake"]:
                continue
            if p.get("inv_source") != "torch":
                flags.append(
                    f"{p['value']} GB/s from {p['source']} carries an "
                    f"unprobed device inventory "
                    f"(source={p.get('inv_source')!r}) - excluded "
                    "from gating"
                )
                continue
            ceil, kind, basis = ceiling_gb_s(
                op, p["device_kind"], net=p.get("net", False),
                local=p.get("local", False))
            over = p["value"] > ceil * (1.0 + eps)
            if p.get("invalidated"):
                flags.append(
                    f"{p['value']} GB/s from {p['source']} "
                    "invalidated at source "
                    f"({p['invalidated']})"
                    + (f" - exceeds the {kind} link ceiling {ceil}"
                       if over else "")
                )
                continue
            if over:
                impossible = True
                flags.append(
                    f"IMPOSSIBLE: {p['value']} GB/s from {p['source']} "
                    f"exceeds the {kind} link ceiling "
                    f"{ceil} GB/s (+{eps:.0%}, basis {basis})"
                )
                continue
            valid.append(p)
        info = {
            "op": op, "size_bytes": size, "n_devices": nd,
            "mesh_shape": list(mesh_shape) if mesh_shape else None,
            "points": len(pts), "valid_points": len(valid),
            "latest": valid[-1]["value"] if valid else None,
            "latest_source": valid[-1]["source"] if valid else None,
            "best": max((p["value"] for p in valid), default=None),
            "flags": flags,
        }
        if impossible:
            info["verdict"] = "impossible"
        elif not valid:
            info["verdict"] = "no_data"
            flags.append(
                "no validated evidence (fake or unprobed points only; "
                "excluded from gating)" if pts else "no points"
            )
        else:
            latest = info["latest"]
            prior_best = max(
                (p["value"] for p in valid[:-1]), default=None
            )
            if prior_best and latest < prior_best * (1.0 - eps):
                info["verdict"] = "regression"
                flags.append(
                    f"REGRESSION: latest {latest} GB/s "
                    f"({info['latest_source']}) is "
                    f"{latest / prior_best:.3f}x of prior best "
                    f"{prior_best} GB/s (band {eps:.0%})"
                )
            else:
                info["verdict"] = "ok"
        verdicts[name] = info
    return verdicts


def _fake_note(basis) -> str:
    if basis == "shared-card":
        return ("shared-card evidence only (the ranks took turns on one "
                "card: contention, not scaling; never verdict-ed)")
    return ("fake-device evidence only (all mesh 'chips' timeshare one "
            "host; efficiency is meaningless and never verdict-ed)")


def analyze_weak(artifacts) -> dict:
    """Per-program verdicts over the newest artifact that holds the
    program (an older sweep is superseded, not a series: the wall at n
    ranks compares with the same sweep's smallest group).
    ``below_scaling_efficiency`` is non-gating and fires only on evidence
    that is not fake."""
    floor = min_eff()
    latest: dict = {}
    for art in artifacts:
        if art.get("family") != "weak_scaling":
            continue
        fake = bool(art.get("fake", True))
        basis = (art.get("device_inventory") or {}).get("fake_basis")
        per_prog: dict = {}
        for pt in art["points"]:
            if not isinstance(pt, dict) or not pt.get("ok", True):
                continue
            wall = pt.get("wall_s")
            nd = pt.get("n_devices")
            if not isinstance(wall, (int, float)) or not nd:
                continue
            per_prog.setdefault(pt.get("program"), {})[int(nd)] = wall
        for prog, walls in per_prog.items():
            latest[prog] = {
                "walls": walls, "fake": fake, "basis": basis,
                "source": art.get("_source", "?"),
            }
    verdicts = {}
    for prog in sorted(latest):
        ent = latest[prog]
        walls = ent["walls"]
        ns = sorted(walls)
        info = {
            "program": prog,
            "series": WEAK_SERIES.get(prog, {}).get(
                "series", f"weak/{prog}"
            ),
            "n_devices": ns,
            "walls": {str(n): walls[n] for n in ns},
            "fake": ent["fake"],
            "source": ent["source"],
            "flags": [],
        }
        if len(ns) < 2:
            info["verdict"] = "no_data"
            info["efficiency"] = None
            info["flags"].append("fewer than two mesh sizes measured")
        else:
            n0, n1 = ns[0], ns[-1]
            eff = walls[n0] / walls[n1] if walls[n1] > 0 else 0.0
            info["efficiency"] = round(eff, 4)
            if ent["fake"]:
                info["verdict"] = "no_data"
                info["flags"].append(_fake_note(ent["basis"]))
            elif eff < floor:
                info["verdict"] = "below_scaling_efficiency"
                info["flags"].append(
                    f"BELOW SCALING EFFICIENCY: wall {walls[n1]}s at "
                    f"n={n1} vs {walls[n0]}s at n={n0} -> efficiency "
                    f"{eff:.1%} under the TPKT_SCALING_MIN_EFF floor "
                    f"{floor:.0%} (non-gating headroom signal)"
                )
            else:
                info["verdict"] = "ok"
        verdicts[prog] = info
    return verdicts


def analyze_overlap(artifacts) -> dict:
    """Per-(op, ranks, depth) verdicts over the newest artifact holding
    each key. ``overlap_low`` is non-gating: a validated point under the
    ``TPKT_OVERLAP_MIN_FRAC`` floor is headroom, not a broken build.
    Fake evidence (the CPU's gloo ranks, a shared card) proves the
    plumbing and is reported as ``no_data``."""
    floor = overlap_min_frac()
    latest: dict = {}
    for art in artifacts:
        if art.get("family") != "overlap":
            continue
        fake = bool(art.get("fake", True))
        basis = (art.get("device_inventory") or {}).get("fake_basis")
        for pt in art["points"]:
            if not isinstance(pt, dict):
                continue
            frac = pt.get("overlap_frac")
            if not isinstance(frac, (int, float)) or isinstance(frac, bool):
                continue
            key = (pt.get("op") or "?", pt.get("n_devices"),
                   pt.get("depth"))
            latest[key] = {
                "point": pt, "fake": fake, "basis": basis,
                "source": art.get("_source", "?"),
            }
    verdicts = {}
    for (op, nd, depth) in sorted(
        latest, key=lambda k: (k[0], k[1] or 0, k[2] or 0)
    ):
        ent = latest[(op, nd, depth)]
        pt = ent["point"]
        frac = pt["overlap_frac"]
        ms = pt.get("mesh_shape")
        name = f"overlap/{op}/n{nd}/d{depth}"
        info = {
            "op": op, "n_devices": nd, "depth": depth,
            "mesh_shape": list(ms) if ms else None,
            "overlap_frac": round(float(frac), 4),
            "t_comm_s": pt.get("t_comm_s"),
            "t_compute_s": pt.get("t_compute_s"),
            "t_full_s": pt.get("t_full_s"),
            "fake": ent["fake"],
            "source": ent["source"],
            "flags": [],
        }
        if ent["fake"]:
            info["verdict"] = "no_data"
            info["flags"].append(
                _fake_note(ent["basis"]) if ent["basis"] == "shared-card"
                else "fake-device evidence only (overlap plumbing proven; "
                     "the fraction itself never verdict-ed)"
            )
        elif frac < floor:
            info["verdict"] = "overlap_low"
            info["flags"].append(
                f"OVERLAP LOW: measured comm/compute overlap "
                f"{frac:.1%} under the TPKT_OVERLAP_MIN_FRAC floor "
                f"{floor:.0%} at depth {depth} (non-gating headroom "
                "signal)"
            )
        else:
            info["verdict"] = "ok"
        verdicts[name] = info
    return verdicts


def analyze_dryrun(d=None) -> dict:
    """Per-program wall series over the dry run's artifacts in ``d``:
    informational only. The walls prove the programs ran and show
    drift; they are no bandwidth and never gate."""
    series: dict = {}
    for i, rnd in enumerate(load_dryruns(d)):
        for prog in rnd["programs"]:
            name = prog.get("name")
            wall = prog.get("wall_s")
            if not name or not isinstance(wall, (int, float)):
                continue
            series.setdefault(name, []).append({
                "round": i + 1,
                "n_devices": rnd["n_devices"],
                "wall_s": wall,
                "fake": rnd["fake"],
                "ok": bool(prog.get("ok", True)),
            })
    return {
        name: {
            "rounds": len(pts),
            "latest_wall_s": pts[-1]["wall_s"],
            "best_wall_s": min(p["wall_s"] for p in pts),
            "points": pts,
        }
        for name, pts in sorted(series.items())
    }


def analyze_repo(d=None, eps: float = 0.01) -> dict:
    """Every family's verdicts over the artifacts in ``d`` (default
    :func:`scaling_dir`); emits one ``scaling_computed`` event naming
    them."""
    artifacts = load_artifacts(d)
    out = {
        "busbw": analyze_busbw(artifacts, eps),
        "weak": analyze_weak(artifacts),
        "overlap": analyze_overlap(artifacts),
        "dryrun": analyze_dryrun(d),
        "artifacts": len(artifacts),
    }
    journal.emit(
        "scaling_computed",
        artifacts=len(artifacts),
        min_eff=min_eff(),
        busbw={k: v["verdict"] for k, v in out["busbw"].items()},
        weak={k: v["verdict"] for k, v in out["weak"].items()},
        overlap={k: v["verdict"] for k, v in out["overlap"].items()},
        dryrun_programs=sorted(out["dryrun"]),
    )
    return out


def gating_findings(analysis) -> dict:
    """The verdicts of an :func:`analyze_repo` result that gate: the
    validated bandwidth ``regression`` and ``impossible`` ones. Weak
    scaling, overlap and the dry run never appear here."""
    return {
        name: v for name, v in analysis.get("busbw", {}).items()
        if v["verdict"] in ("regression", "impossible")
    }
