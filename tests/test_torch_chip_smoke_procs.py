"""``chip_smoke.py``'s own process hygiene, on the CPU: the end's sweep
stops what a child left behind (an orphan, a process in a session of its
own), and the Pythons the script starts share one bytecode cache. Each
case runs in a child interpreter, since the sweep makes its process the
reaper of its descendants' orphans."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return p


@pytest.mark.parametrize("spawn", ["(sleep 60 &)", "setsid sleep 60 &"],
                         ids=["orphan", "own-session"])
def test_the_end_sweep_stops_what_a_child_left(spawn):
    p = run(f"""
import json, os, subprocess, time
import chip_smoke
chip_smoke.become_subreaper()
subprocess.run(["bash", "-c", {spawn!r} + "\\nexit 0"], check=True)
deadline = time.monotonic() + 10
while not chip_smoke.descendants() and time.monotonic() < deadline:
    time.sleep(0.05)
left = chip_smoke.report_leftovers("the test")
chip_smoke.stop_leftovers()
alive = [p for p in left if os.path.exists(f"/proc/{{p}}")]
print(json.dumps({{"left": left, "alive": alive,
                  "after": sorted(chip_smoke.descendants())}}))
""")
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert len(got["left"]) == 1, p.stderr
    assert got["alive"] == [] and got["after"] == []
    assert "LEFTOVER after the test: 1 process(es)" in p.stderr
    assert "sleep 60" in p.stderr


def test_started_pythons_share_one_bytecode_cache(tmp_path):
    prefix = tmp_path / "pycache"
    (tmp_path / "tpkt_probe_mod.py").write_text("X = 1\n")
    p = run(f"""
import os, subprocess, sys
import chip_smoke
os.environ["PYTHONDONTWRITEBYTECODE"] = "1"
chip_smoke.share_bytecode({str(prefix)!r})
child = ("import json, sys; sys.path.insert(0, {str(tmp_path)!r}); "
         "import tpkt_probe_mod; print(json.dumps([sys.pycache_prefix, "
         "sys.flags.dont_write_bytecode]))")
print(subprocess.run([sys.executable, "-c", child], capture_output=True,
                     text=True, check=True).stdout)
""")
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == [str(prefix), 0]
    assert list(prefix.rglob("tpkt_probe_mod*.pyc"))
    assert not (tmp_path / "__pycache__").exists()


@pytest.mark.parametrize("argv, rc", [(["--device", "cpu", "--reps", "1"], 0),
                                      (["--reps", "0"], 2)],
                         ids=["cpu", "bad-reps"])
def test_start_cost_probe(argv, rc):
    p = subprocess.run([sys.executable, "-m", "tpukernels_torch.obs.start_cost",
                        *argv], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == rc, p.stderr
    if rc == 0:
        got = json.loads(p.stdout.strip().splitlines()[-1])
        row = got["start_cost"]["import torch"]
        assert list(got["start_cost"]) == ["import torch"]
        assert len(row["as_is"]) == len(row["cached"]) == 1
        assert all(s > 0 for s in row["as_is"] + row["cached"]
                   + [row["writes"]])
