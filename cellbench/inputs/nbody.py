"""Bodies for ``nbody``: a pool of ``pool`` distinct float32 SoA states
of the configuration's ``n`` bodies, made on ``device`` from the seed in
one call, as ``c/nbody.c`` fills them: positions uniform in [-1, 1),
velocities 0.1 times that, masses 1 + 0.5 times that."""

import torch


def make(config: dict, pool: int, gen, device) -> list:
    """One operand tuple a pool slot: ``(px, py, pz, vx, vy, vz, m)``,
    each a contiguous row of one tensor."""
    n = int(config["n"])
    s = torch.rand((pool, 7, n), generator=gen, device=device,
                   dtype=torch.float32).mul_(2).sub_(1)
    s[:, 3:6].mul_(0.1)
    s[:, 6].mul_(0.5).add_(1.0)
    return [tuple(s[i, k] for k in range(7)) for i in range(pool)]

