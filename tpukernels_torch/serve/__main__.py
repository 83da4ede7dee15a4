"""``python -m tpukernels_torch.serve`` — run the serving daemon
(``serve/server.py``)."""

import sys

if __name__ == "__main__":
    from tpukernels_torch.serve import mesh_tier

    # the mesh tier's followers (TPKT_SERVE_MESH) start while this
    # process imports torch, not after it
    tier = mesh_tier.spawn_early()

    from tpukernels_torch.serve.server import main

    sys.exit(main(tier=tier))
