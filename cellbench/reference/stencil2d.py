"""Plain PyTorch reference of ``stencil2d`` and the comparison that
decides ``correct``.

A 5-point Jacobi sweep with a Dirichlet boundary: each interior cell
becomes ((N + S) + W) + E, times 0.25, of the grid before the sweep;
boundary cells keep their values. Imports nothing of the program.
"""

import torch


def reference(operands, statics: dict, dtype=torch.float32):
    """The grid after ``statics["iters"]`` sweeps, computed in
    ``dtype`` (the configuration's float32; a lower one for the
    control), returned as a one-leaf tuple."""
    (x,) = operands
    a = x.to(dtype).clone()
    b = a.clone()
    for _ in range(int(statics["iters"])):
        b[1:-1, 1:-1] = (((a[:-2, 1:-1] + a[2:, 1:-1]) + a[1:-1, :-2])
                         + a[1:-1, 2:]) * 0.25
        a, b = b, a
    return (a,)


def compare(got, want, operands, statics: dict) -> dict:
    """``max_abs_err``: the largest |got - want| over the grid, in
    float64."""
    (g,), (w,) = got, want
    if g.shape != w.shape:
        return {"max_abs_err": float("inf")}
    d = (g.double() - w.double()).abs().max()
    return {"max_abs_err": float(d)}
