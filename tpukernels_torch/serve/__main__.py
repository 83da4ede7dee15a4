"""``python -m tpukernels_torch.serve`` — run the serving daemon
(``serve/server.py``)."""

import sys

from tpukernels_torch.serve.server import main

if __name__ == "__main__":
    sys.exit(main())
