"""The least work of one ``stencil2d`` call: the grid read once and
written once (8 bytes a cell), and 5 float32 operations a sweep of each
interior cell, the reference's cost estimate."""


def work(config: dict, statics: dict, ranks: int = 1) -> dict:
    h, w = config["shape"]
    iters = int(statics["iters"])
    return {"bytes": 8 * h * w,
            "fp32_flops": 5 * (h - 2) * (w - 2) * iters}
