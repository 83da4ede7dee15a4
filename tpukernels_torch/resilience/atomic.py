"""Crash-consistent writes of the port's persisted JSON files.

The port's own copy of ``write_text``/``dump_json`` in
``tpukernels/resilience/atomic.py``: the new content goes to a temporary
file beside the target, is fsynced, and replaces the target in one
rename, so a crash leaves the old file or the new one, never half of
either. The ``torn_write`` fault key (``resilience/faults.py``) injects
that crash: a matching write strands half its bytes in the temporary
file and aborts before the rename.
"""

from __future__ import annotations

import json
import os

from tpukernels_torch.resilience import faults


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_text(path: str, text: str) -> None:
    """After this returns ``path`` holds ``text``; if the process dies
    inside, ``path`` holds what it held before."""
    tmp = f"{path}.tmp.{os.getpid()}"
    data = text.encode("utf-8")
    spec = faults.torn_write_fault(path)
    if spec is not None:
        faults.apply_torn_write(spec, path, tmp, data)
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    _fsync_dir(path)


def dump_json(path: str, obj, indent=1, sort_keys=True) -> None:
    write_text(path, json.dumps(obj, indent=indent, sort_keys=sort_keys))
