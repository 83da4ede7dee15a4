"""Carry operands between the reference's numpy form and the port.

The suite has no weights: a kernel's state is its operands (arrays)
and statics (host scalars). :func:`to_port` turns the numpy operands a
JAX kernel function takes into the port's tensors; :func:`from_port`
turns a port result back into numpy. Tests and ``chip_smoke.py`` both
go through these two functions.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukernels_torch.utils import pick_device

# array operands each registry key takes, in order
_N_ARRAYS = {"vector_add": 2, "sgemm": 3, "stencil2d": 1, "stencil3d": 1,
             "nbody": 7, "scan": 1, "scan_exclusive": 1, "histogram": 1,
             "scan_histogram": 1}
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32}


def to_port(name: str, np_args, device=None) -> tuple:
    """numpy arrays -> contiguous float32/int32 tensors on ``device``
    (the card unless ``device="cpu"``); host scalars -> Python floats."""
    dev = pick_device(device)
    out = []
    for a in np_args:
        if isinstance(a, np.ndarray) and a.ndim > 0:
            dt = _DTYPES.get(a.dtype)
            if dt is None:
                raise TypeError(
                    f"{name}: operand dtype {a.dtype} is not float32/int32"
                )
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
        else:
            out.append(float(a))
    want = _N_ARRAYS.get(name)
    got = sum(isinstance(t, torch.Tensor) for t in out)
    if want is not None and got != want:
        raise ValueError(f"{name}: expected {want} array operands, got {got}")
    return tuple(out)


def from_port(out):
    """A port result -> numpy on the host; a tuple of tensors (``nbody``,
    ``scan_histogram``) -> a tuple of arrays."""
    if isinstance(out, tuple):
        return tuple(from_port(t) for t in out)
    return out.detach().cpu().numpy()
