"""Grids for ``stencil2d``: a pool of ``pool`` distinct float32 grids of
the configuration's shape, made on ``device`` from the seed in one call,
every cell uniform in [-1, 1) (``c/stencil.c``'s fill)."""

import torch


def make(config: dict, pool: int, gen, device) -> list:
    """One operand tuple a pool slot: ``(grid,)``, each a contiguous
    slice of one tensor."""
    h, w = config["shape"]
    grids = torch.rand((pool, h, w), generator=gen, device=device,
                       dtype=torch.float32).mul_(2).sub_(1)
    return [(grids[i],) for i in range(pool)]

