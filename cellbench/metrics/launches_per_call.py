"""``launches_per_call``: the launches ``tpukernels_torch.kernels.
LAUNCHES`` counted over the window (rank 0's on a mesh), over the calls.
Nothing where no launch was counted (the CPU's plain versions)."""


def read(rec: dict):
    launches = rec.get("launches") or {}
    if not rec.get("calls") or not launches:
        return None
    return sum(launches.values()) / rec["calls"]
