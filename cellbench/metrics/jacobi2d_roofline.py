"""``jacobi2d_roofline``: the ``jacobi2d_kernel`` launches'
(``csrc/jacobi2d.cu``) share of the least time of the calls' sweeps."""

from cellbench.roofline import kernel_roofline


def read(rec: dict):
    return kernel_roofline(rec, "jacobi2d_kernel")
