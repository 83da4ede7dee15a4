"""The least work of one ``nbody`` call: 20 float32 operations a pair a
step (the reference's cost estimate), and the seven arrays read once and
the six written once (13 × 4 bytes a body). On a mesh of ``ranks`` ranks
one rank's share: the forces on its n / ranks i-bodies from all n, and
its share of the arrays."""


def work(config: dict, statics: dict, ranks: int = 1) -> dict:
    n = int(config["n"])
    steps = int(statics["steps"])
    return {"bytes": 4 * 13 * n // ranks,
            "fp32_flops": 20 * (n // ranks) * n * steps}
