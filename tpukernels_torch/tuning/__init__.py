from tpukernels_torch.tuning.space import (
    SearchSpace,
    Tunable,
    resolve,
    spaces_of,
)

__all__ = ["SearchSpace", "Tunable", "resolve", "spaces_of"]
