"""Shape bucketing: pad requests up to the avatars of record.

The port's copy of ``tpukernels/serve/bucketing.py``, with the same
rules. A request whose operands fit under a kernel's avatar (every dim
<=, same rank, same dtype, same statics) is zero-padded up to it,
dispatched at the avatar's shape (its launch plans, tuning entries and
the daemon's pad staging buffers stay warm), and its outputs are sliced
or corrected back to the native shapes. Pad up, never down.

The rule is per kernel and explicit (``PAD_RULES``):

- ``"zero"``  — zero padding changes nothing: SAXPY and SGEMM (zero rows
  and columns add zero), the scans (trailing zeros leave every prefix
  alone), N-body (a zero-mass body at the origin exerts no force and
  its own row is cut away).
- ``"hist0"`` — each pad element lands in bin 0, so the pad count is
  taken off ``counts[0]`` after the dispatch (scan_histogram's scan half
  follows the scan rule).
- ``None``    — padding changes the answer (the stencils: a padded
  boundary is another boundary condition). An exact avatar match still
  buckets; anything else dispatches at its own shape.

Padding is wasted work, so it is capped (``TPKT_SERVE_MAX_PAD_FRAC``,
default 0.5) and observed (``serve.bucket_pad_frac``). A request over
the cap, over the avatar or at other statics dispatches at its own
shape.

``TPKT_SERVE_BUCKETS`` (inline JSON or a file path) replaces the avatar
table, as the CPU tests do to prove the pad rules at small shapes; a
value may be one avatar spec or a list of them (the request then lands
on the fitting one with the least padding). :func:`reload` re-reads a
changed file behind an unchanged path (the daemon's ``undrain`` op).

The default table is ``tpukernels_torch.aot.BENCH_CONFIGS``. Standard
library and numpy only.
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpukernels_torch import aot

DEFAULT_MAX_PAD_FRAC = 0.5

# kernel -> padding rule (module docstring). Explicit None rows are
# deliberate: every registry key states its rule
# (tests/test_torch_serve_protocol.py holds them to the reference's).
PAD_RULES = {
    "vector_add": "zero",
    "sgemm": "zero",
    "stencil2d": None,
    "stencil3d": None,
    "scan": "zero",
    "scan_exclusive": "zero",
    "histogram": "hist0",
    "scan_histogram": "hist0",
    "nbody": "zero",
}

_DTYPE_NAMES = {"f32": "float32", "i32": "int32"}


def max_pad_frac() -> float:
    """``TPKT_SERVE_MAX_PAD_FRAC`` (default 0.5), fail-loud parse in
    [0, 1]."""
    raw = os.environ.get("TPKT_SERVE_MAX_PAD_FRAC")
    if raw is None:
        return DEFAULT_MAX_PAD_FRAC
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not 0.0 <= val <= 1.0:
        raise ValueError(
            f"TPKT_SERVE_MAX_PAD_FRAC={raw!r}: expected a float in [0, 1]"
        )
    return val


# parse-once cache keyed on the raw knob value: admission runs
# bucket_for per incoming request in the reader thread, and a
# file-path knob must not cost a disk open + JSON parse per request.
# (A changed FILE behind an unchanged path is not re-read — tests and
# operators flip the env value, which busts the cache.)
_CONFIG_CACHE: dict = {"raw": None, "table": None}


def bucket_configs() -> dict:
    """The avatar table bucketing folds onto: ``TPKT_SERVE_BUCKETS``
    (inline JSON object or a JSON file path — the fault-plan loading
    convention) when set, else the registered ``aot.BENCH_CONFIGS``.
    Spec shape mirrors BENCH_CONFIGS: ``{kernel: {"args": [(kind,
    shape), ...], "statics": {...}}}``."""
    raw = os.environ.get("TPKT_SERVE_BUCKETS")
    if not raw or not raw.strip():
        return aot.BENCH_CONFIGS
    if _CONFIG_CACHE["raw"] == raw:
        return _CONFIG_CACHE["table"]
    if raw.lstrip()[:1] == "{":
        table = json.loads(raw)
    else:
        with open(raw) as f:
            table = json.load(f)
    if not isinstance(table, dict):
        raise ValueError(
            "TPKT_SERVE_BUCKETS must be a JSON object "
            f"({type(table).__name__} given)"
        )
    _CONFIG_CACHE["table"] = table
    _CONFIG_CACHE["raw"] = raw
    return table


def reload():
    """Bust the parse-once config cache and re-read the table — the
    promoted-table pickup hook (docs/SERVING.md §adaptive buckets).
    The cache is keyed on the RAW env value, so a promotion that
    atomically rewrites the file behind a stable ``TPKT_SERVE_BUCKETS``
    path is invisible until this runs; the router and daemon call it
    on ``undrain``, the operator's "config changed" signal. Raises
    like :func:`bucket_configs` on a malformed table — an undrain
    must not silently serve yesterday's avatars — but a reload that
    FAILS leaves the previously parsed table in effect, so one torn
    promotion cannot take the request path down with it."""
    old = dict(_CONFIG_CACHE)
    _CONFIG_CACHE["raw"] = _CONFIG_CACHE["table"] = None
    try:
        return bucket_configs()
    except (OSError, ValueError):
        _CONFIG_CACHE.update(old)
        raise


def kernel_specs(kernel: str) -> list:
    """The kernel's avatar specs as a list — one entry for the
    historical single-spec table shape, N after an adaptive split."""
    spec = bucket_configs().get(kernel)
    if spec is None:
        return []
    return list(spec) if isinstance(spec, list) else [spec]


def _spec_args(spec):
    """[(dtype_name, shape_tuple), ...] for one avatar spec (tolerates
    JSON lists where BENCH_CONFIGS has tuples)."""
    out = []
    for kind, shape in spec["args"]:
        out.append((_DTYPE_NAMES.get(kind, kind),
                    tuple(int(d) for d in shape)))
    return out


def bucket_for(kernel: str, arrays, statics: dict):
    """Match one request against the kernel's avatar(s).

    ``arrays`` are the request's numpy operands (0-d = host scalar).
    Returns ``(spec, pad_frac)`` when the request buckets — ``spec``
    is the avatar entry, ``pad_frac`` the wasted-element fraction
    (0.0 for an exact fit) — or ``(None, reason)`` when it must
    dispatch natively. Pad-up only: any dim over the avatar's is a
    non-match, never a truncation. A kernel with SEVERAL avatars (an
    adaptively split table) lands the request on the fitting avatar
    with the LEAST padding."""
    try:
        raw = bucket_configs().get(kernel)
    except (OSError, ValueError) as e:
        raise ValueError(f"TPKT_SERVE_BUCKETS: {e}") from None
    if raw is None:
        return None, "no-avatar"
    specs = list(raw) if isinstance(raw, list) else [raw]
    if not specs:
        return None, "no-avatar"
    best = reason = None
    for spec in specs:
        got, how = _match_one(kernel, arrays, statics, spec)
        if got is None:
            if reason is None:
                reason = how  # first avatar's reason, deterministic
            continue
        if how == 0.0:
            return got, 0.0  # exact fit: nothing beats zero pad
        if best is None or how < best[1]:
            best = (got, how)
    if best is not None:
        return best
    return None, reason


def _match_one(kernel: str, arrays, statics: dict, spec):
    """One request against ONE avatar spec — the single-avatar match
    body :func:`bucket_for` ranks over."""
    want = _spec_args(spec)
    if len(want) != len(arrays):
        return None, "arg-count-mismatch"
    if dict(spec.get("statics") or {}) != dict(statics or {}):
        return None, "statics-mismatch"
    orig = padded = 0
    exact = True
    for a, (dtype, shape) in zip(arrays, want):
        a = np.asarray(a)
        if a.dtype.name != dtype or a.ndim != len(shape):
            return None, "layout-mismatch"
        if any(d > w for d, w in zip(a.shape, shape)):
            return None, "over-avatar"
        if tuple(a.shape) != shape:
            exact = False
        orig += int(a.size)
        padded += int(np.prod(shape, dtype=np.int64)) if shape else 1
    if exact:
        return spec, 0.0
    if PAD_RULES.get(kernel) is None:
        return None, "no-pad-rule"
    if not _consistent(kernel, arrays):
        # cross-operand shape disagreements (sgemm inner dims,
        # mismatched vector lengths) that registry.dispatch would
        # REJECT must never be padded into a plausible-but-wrong
        # answer — dispatch natively and let the kernel error honestly
        return None, "inconsistent-args"
    pad_frac = 1.0 - (orig / padded if padded else 1.0)
    if pad_frac > max_pad_frac():
        return None, "pad-over-cap"
    return spec, pad_frac


def spec_stubs(specs):
    """Allocation-free operand stand-ins built from wire arg specs
    (``[{"shape", "dtype"}, ...]``) — zero-stride broadcasts with the
    right shape/dtype/size, enough for :func:`bucket_for` /
    :func:`bucket_id` which only read layout. How the fleet router
    hashes a request without touching (or even receiving) its payload
    bytes: with the shm lane the tensors never pass through the
    front-end at all. Malformed specs raise ``ValueError``/
    ``TypeError`` — the router's bad-request surface."""
    from tpukernels_torch.serve import protocol

    out = []
    for spec in specs or ():
        name = spec.get("dtype")
        if name not in protocol.DTYPES:
            raise ValueError(f"unsupported dtype {name!r} in spec")
        shape = tuple(int(d) for d in spec.get("shape", ()))
        out.append(
            np.broadcast_to(np.zeros((), protocol.DTYPES[name]), shape)
        )
    return out


def _consistent(kernel: str, arrays) -> bool:
    """Cross-operand shape agreement for multi-operand kernels — the
    constraints ``registry.dispatch`` itself would enforce. Only
    consulted for non-exact (padding) matches: an exact avatar fit is
    consistent by construction."""
    shapes = [tuple(np.asarray(a).shape) for a in arrays]
    if kernel == "vector_add":
        return shapes[1] == shapes[2]
    if kernel == "sgemm":
        (m, k), (k2, n), (m2, n2) = shapes[1], shapes[2], shapes[4]
        return k == k2 and m == m2 and n == n2
    if kernel == "nbody":
        return len(set(shapes)) == 1
    return True  # single-data-operand kernels


def pad_args(kernel: str, spec, arrays, pool=None):
    """Zero-pad the request's operands up to the avatar shapes.
    Returns ``(padded_arrays, meta)`` — ``meta`` carries what
    :func:`unpad_outputs` needs (native shapes + the data-arg pad
    count for the hist0 correction) plus ``copied_bytes``, the
    staging bytes this call copied (the serve daemon's
    ``serve.bytes_copied`` evidence).

    ``pool`` (a per-bucket ``{arg_index: buffer}`` dict) reuses the
    avatar-shaped staging buffers across requests so the warm padded
    path allocates nothing — the CALLER must serialize access (the
    daemon holds the bucket lock)."""
    want = _spec_args(spec)
    padded, orig_shapes = [], []
    copied = 0
    for i, (a, (dtype, shape)) in enumerate(zip(arrays, want)):
        a = np.asarray(a)
        orig_shapes.append(tuple(a.shape))
        if tuple(a.shape) == shape:
            padded.append(a)
            continue
        buf = pool.get(i) if pool is not None else None
        if (buf is None or buf.shape != shape
                or buf.dtype != a.dtype):
            buf = np.zeros(shape, dtype=a.dtype)
            if pool is not None:
                pool[i] = buf
        else:
            # reused staging buffer: re-zero before the copy so the
            # previous request's longer operand cannot bleed through
            buf[...] = 0
        buf[tuple(slice(0, d) for d in a.shape)] = a
        copied += int(a.nbytes)
        padded.append(buf)
    data_pad = 0
    for a, (dtype, shape) in zip(arrays, want):
        if shape:  # first non-scalar arg is the data array by contract
            data_pad = int(np.prod(shape, dtype=np.int64)) - int(
                np.asarray(a).size
            )
            break
    return padded, {"orig_shapes": orig_shapes, "data_pad": data_pad,
                    "rule": PAD_RULES.get(kernel),
                    "copied_bytes": copied}


def unpad_outputs(kernel: str, meta, outputs):
    """Slice/correct the avatar-shaped outputs back to the request's
    native shapes. ``outputs`` is the flat tuple of numpy result
    leaves; returns the corrected tuple. The inverse map is
    per-kernel because output shapes are functions of INPUT shapes:

    - vector_add / scan / scan_exclusive — one output shaped like the
      data arg: slice to it.
    - sgemm — output shaped like C (arg 4): slice to it.
    - nbody — six outputs shaped like the body arrays: slice each.
    - histogram — counts are avatar-shaped already (nbins is a
      static); subtract the pad count from bin 0 (every pad element
      is a zero).
    - scan_histogram — scan half sliced, counts half bin-0-corrected.
    """
    shapes = meta["orig_shapes"]
    pad = meta["data_pad"]

    def _cut(a, shape):
        a = np.asarray(a)
        if tuple(a.shape) == tuple(shape):
            return a
        return np.ascontiguousarray(
            a[tuple(slice(0, d) for d in shape)]
        )

    def _fix_counts(c):
        c = np.array(c, copy=True)
        c[0] -= np.asarray(pad, dtype=c.dtype)
        return c

    if kernel == "vector_add":
        return (_cut(outputs[0], shapes[1]),)
    if kernel == "sgemm":
        return (_cut(outputs[0], shapes[4]),)
    if kernel in ("scan", "scan_exclusive"):
        return (_cut(outputs[0], shapes[0]),)
    if kernel == "histogram":
        return (_fix_counts(outputs[0]),)
    if kernel == "scan_histogram":
        return (_cut(outputs[0], shapes[0]), _fix_counts(outputs[1]))
    if kernel == "nbody":
        return tuple(_cut(o, s) for o, s in zip(outputs, shapes))
    # exact-fit buckets of rule-less kernels never pad, so outputs
    # are already native-shaped
    return tuple(np.asarray(o) for o in outputs)


def bucket_id(kernel: str, spec, statics: dict, arrays=None) -> str:
    """Stable batching/locking key for one (kernel, compiled-program)
    bucket. Bucketed requests share the avatar's key; native
    dispatches key on their own shapes (same-shape natives still
    coalesce and still compile once)."""
    if spec is not None:
        shapes = "+".join(
            "x".join(str(d) for d in shape) or "-"
            for _dt, shape in _spec_args(spec)
        )
    else:
        shapes = "+".join(
            "x".join(str(d) for d in np.asarray(a).shape) or "-"
            for a in (arrays or ())
        )
    stat = ",".join(f"{k}={v}" for k, v in sorted((statics or {}).items()))
    return f"{kernel}|{shapes}|{stat or '-'}"


def mesh_tier_for(kernel: str, arrays, statics: dict):
    """The mesh shape an over-avatar request could run on, or None. The
    port has no distributed layer yet (ROADMAP.md Queue A item 3), so it
    is always None: the reference's answer on a host with one device,
    and an over-avatar request dispatches at its own shape."""
    return None
