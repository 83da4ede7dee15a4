"""``python -m tpukernels_torch.obs.trace_report`` against the reference's
``tools/trace_report.py``, on the CPU.

Both read the same fixture journal (the events of
``tests/test_torch_reqtrace.py``: clean, wedged, spilled, replayed,
hedged, expired and untraced requests on skewed clocks, and junk) and
must print the same report: the same phase table, rows and percentiles,
and the same waterfalls for ``--slowest`` and ``--request``. With no
journal given and none routed the port exits 1.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_reqtrace import EVENTS

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def journal_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("trace") / "health_2026-08-01.jsonl"
    p.write_text("".join(json.dumps(e) + "\n" for e in EVENTS)
                 + "not json\n")
    return p


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), **extra)
    return env


def _port(*argv, **extra):
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.obs.trace_report", *argv],
        capture_output=True, text=True, cwd=ROOT, env=_env(**extra),
        timeout=120)


def _reference(*argv):
    return subprocess.run(
        [sys.executable, os.path.join("tools", "trace_report.py"), *argv],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=120)


@pytest.mark.parametrize("argv", [[], ["--slowest", "5"], ["--slowest", "0"],
                                  ["--request", "r-spill"],
                                  ["--request", "r-wedge"]],
                         ids=lambda a: " ".join(a) or "default")
def test_report_equals_reference(journal_file, argv):
    got = _port(str(journal_file), *argv)
    want = _reference(str(journal_file), *argv)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert "phase attribution (p50 ms in phase)" in got.stdout
    assert "1 unparseable line(s)" in got.stdout


def test_slowest_and_request_pick_the_references(journal_file):
    heads = []
    for run in (_port, _reference):
        out = run(str(journal_file), "--slowest", "3").stdout
        heads.append([line.split()[1] for line in out.splitlines()
                      if line.startswith("request ")])
    assert heads[0] == heads[1] and len(heads[0]) == 3
    got = _port(str(journal_file), "--request", "r-nope")
    assert got.returncode == 2 and "not in this journal" in got.stderr


def test_the_journal_knob_and_no_journal(journal_file, tmp_path):
    # a directory: its newest dated file
    got = _port(TPKT_HEALTH_JOURNAL=str(journal_file.parent))
    assert got.returncode == 0, got.stderr
    assert journal_file.name in got.stdout.splitlines()[0]
    # no journal given and none routed: rc 1, never docs/logs/
    got = _port()
    assert got.returncode == 1 and "no journal" in got.stderr
    got = _port(TPKT_HEALTH_JOURNAL="off")
    assert got.returncode == 1
    # an empty journal renders the loud note
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    got = _port(str(empty))
    assert got.returncode == 0 and "no request timelines" in got.stdout
    for argv in (["--bogus"], ["--slowest"], ["--slowest", "x"]):
        assert _port(*argv).returncode == 2
