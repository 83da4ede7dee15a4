"""The control at each one-card cell's own size, on the card: on three
seeds the program's sampled calls stay inside every limit and the
reference computed in bfloat16, put in the program's place, breaks one.

    python -m pytest cellbench/tests/test_cellbench_chip.py

Skips (with its reason) where there is no card; ``control.py`` gives the
same readings for a dozen seeds as JSON lines."""

import os

import pytest
import torch

from cellbench import control, harness, spec
from cellbench import run as cb_run

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_fails_where_the_program_passes(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = dict(os.environ)
    cb_run.program_env(str(tmp_path), False)
    try:
        cell = spec.cell(name)
        for seed in (2**32 + 1, 2**32 + 2, 2**32 + 3):
            rec = harness.run_cell(cell, seed, 1.0, False,
                                   torch.device("cuda", 0),
                                   harness.Clock.start(), keep=True)
            assert rec["correct"], (seed, rec["checks"])
            got = control.control_reading(cell, rec)
            assert any(got[k] > lim for k, lim in
                       cell.traffic["limits"].items()), (seed, got)
            del rec
            torch.cuda.empty_cache()
    finally:
        os.environ.clear()
        os.environ.update(saved)
