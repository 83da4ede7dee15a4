"""``nbody_forces_roofline``: the ``nbody_forces_kernel`` launches'
(``csrc/nbody.cu``) share of the least time of the calls' pairwise
forces (rank 0's i-bodies on a mesh)."""

from cellbench.roofline import kernel_roofline


def read(rec: dict):
    return kernel_roofline(rec, "nbody_forces_kernel")
