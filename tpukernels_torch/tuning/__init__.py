from tpukernels_torch.tuning.space import (
    SMEM_BUDGET_BYTES,
    SearchSpace,
    Tunable,
    plan_memo,
    resolve,
    resolve_with_sources,
    spaces_of,
)

__all__ = ["SMEM_BUDGET_BYTES", "SearchSpace", "Tunable", "plan_memo",
           "resolve", "resolve_with_sources", "spaces_of"]
