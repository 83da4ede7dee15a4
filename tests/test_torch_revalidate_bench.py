"""The revalidation queue's bench steps on the CPU: the ``bench`` step's
body as the queue runs it on a host without a card (the unreachable line
persisted, the gate's rc 2 the step's), ``roofline_report``'s, the
watch's skip-captured mode and its post-green harvest (the reference's
``tools/revalidate.py``: ``_harvest`` and ``main``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpukernels_torch import revalidate

ROOT = Path(__file__).resolve().parent.parent


def _step(name):
    return {s.name: s for s in revalidate.PRODUCTION_QUEUE}[name]


def _env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               TPKT_BENCH_DIR=str(tmp_path / "bench"),
               TPKT_BENCH_BASELINE=str(tmp_path / "base.json"),
               TPKT_BENCH_PROBE_ATTEMPTS="1",
               TPKT_HEALTH_JOURNAL=str(tmp_path / "health.jsonl"),
               TPKT_AOT_DIR=str(tmp_path / "aot"),
               TPKT_SUPERVISOR_DIR=str(tmp_path / "sup"))
    env.update({k: str(v) for k, v in extra.items()})
    return env


@pytest.mark.parametrize("skip", ("", "1"), ids=("single", "union"))
def test_bench_step_persists_its_line_and_gates_it(tmp_path, skip):
    """No card: the suite prints its unreachable line, the step writes it
    to ``$TPKT_BENCH_DIR/bench_<stamp>.json`` and pipes it to the gate,
    whose rc 2 (no evidence yet, retryable) is the step's; under
    ``TPKT_BENCH_SKIP_CAPTURED=1`` the gate judges the union."""
    env = _env(tmp_path, TPKT_BENCH_SKIP_CAPTURED=skip)
    p = subprocess.run(["bash", "-c", _step("bench").shell], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2, p.stdout + p.stderr
    (art,) = (tmp_path / "bench").glob("bench_*.json")
    line = json.loads(art.read_text())
    assert line["device"] == "h100" and line["value"] is None
    assert "card unreachable" in line["error"]
    assert ("persisted union" in p.stdout) == bool(skip)
    assert "REGRESSION" in p.stdout


def test_roofline_report_step_is_green_without_evidence(tmp_path):
    p = subprocess.run(["bash", "-c", _step("roofline_report").shell],
                       cwd=ROOT, env=_env(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "roofline report: OK" in p.stdout and "h100 peaks" in p.stdout


_WATCH_PROBE = """
import json, os, sys
from tpukernels_torch import revalidate
from tpukernels_torch.resilience import supervisor
seen = {}
def watch(make, max_hours, harvest=None):
    seen["harvest"] = getattr(harvest, "__name__", None)
    seen["env"] = {k: os.environ.get(k) for k in (
        "TPKT_BENCH_SKIP_CAPTURED", "TPKT_BENCH_PROBE_ATTEMPTS")}
    return 0
supervisor.watch = watch
rc = revalidate.main(sys.argv[1:])
print(json.dumps(dict(seen, rc=rc)))
"""


@pytest.mark.parametrize("queue", (False, True), ids=("production", "file"))
def test_watch_skips_captured_and_harvests_after_green(tmp_path, queue):
    """``--wait``: skip-captured and one probe attempt for the queue's
    bench; the production queue's watch harvests after its first green
    queue, a queue file's does not (in a child: the lock takes fd 9)."""
    argv = ["--wait"]
    if queue:
        qf = tmp_path / "q.json"
        qf.write_text(json.dumps([{"name": "a", "shell": "true"}]))
        argv += ["--queue", str(qf)]
    env = _env(tmp_path, TPKT_REVALIDATE_LOCK=tmp_path / "lock")
    p = subprocess.run([sys.executable, "-c", _WATCH_PROBE, *argv],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    seen = json.loads(p.stdout.strip().splitlines()[-1])
    assert seen["rc"] == 0
    assert seen["env"] == {"TPKT_BENCH_SKIP_CAPTURED": "1",
                           "TPKT_BENCH_PROBE_ATTEMPTS": "1"}
    assert seen["harvest"] == (None if queue else "_harvest")


def test_harvest_runs_the_quick_sgemm_sweep_and_never_gates(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    monkeypatch.setenv("TPKT_SUPERVISOR_DIR", str(tmp_path / "sup"))
    ran = []

    class Done:
        returncode = 3

    def run(cmd, stdout=None, **kw):
        ran.append((cmd, kw["cwd"]))
        stdout.write("sweep output\n")
        return Done()

    monkeypatch.setattr(subprocess, "run", run)
    revalidate._harvest()
    assert ran == [([sys.executable, "-m", "tpukernels_torch.sgemm_tune",
                     "--quick"], revalidate._REPO)]
    (log,) = (tmp_path / "sup" / "logs").glob("sgemm_tune_*.log")
    assert log.read_text() == "sweep output\n"
    out = capsys.readouterr().out
    assert "harvest sgemm_tune --quick rc=3 (non-gating)" in out

    def hang(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(subprocess, "run", hang)
    revalidate._harvest()
    assert "rc=timeout (non-gating)" in capsys.readouterr().out
