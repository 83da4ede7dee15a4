"""``setup_s``: seconds from the process's start to the window's start
(interpreter, ``import torch``, CUDA context, the program's import and
library load or build, the inputs, the warm-up), by the host's clock."""


def read(rec: dict):
    return rec.get("setup_s")
