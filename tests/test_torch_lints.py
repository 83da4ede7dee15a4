"""The port's knob and journal-kind lints on the CPU.

- ``python -m tpukernels_torch.obs.env_knobs`` and ``python -m
  tpukernels_torch.obs.journal_kinds`` exit 0 on this tree: every
  ``TPKT_*`` knob has a row in ``tpukernels_torch/docs/KNOBS.md``, every
  emitted kind a row in ``tpukernels_torch/docs/OBSERVABILITY.md``, every
  traced emit a ``request_id=``, every fault key a row.
- In a ``--root`` tree of their own, each catches an undocumented knob
  (a constant, a shell body, the C shim's ``getenv``), an undocumented
  kind, a non-literal kind, an untagged traced emit and an undocumented
  fault key (literal ``_PLAN.get``, literal ``_spec``, ``_spec`` or
  ``_PLAN.get`` through a loop over a literal tuple) with rc 1, and warns with rc 0 on a row
  nothing references.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpukernels_torch.obs import env_knobs, journal_kinds

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("lint", ["env_knobs", "journal_kinds"])
def test_the_lint_passes_on_this_tree(lint):
    p = subprocess.run([sys.executable, "-m", f"tpukernels_torch.obs.{lint}"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"{lint}: OK - " in p.stdout


def test_the_trees_fault_keys_are_the_fault_modules():
    """The keys the lint finds are the plan keys ``faults.py`` documents,
    the generic lookup's included."""
    assert journal_kinds.fault_plan_keys(str(ROOT)) == sorted([
        "slow_dispatch", "wedge_dispatch", "kill_worker", "delay_response",
        "kill_router", "torn_write", "nan_output", "corrupt_output",
        "fail_capi", "wedge_capi", "probe", "hang_probe", "kill_supervisor",
        "wedge_metric", "fail_metric"])


def test_the_trees_traced_kinds_are_the_serve_paths():
    doc = ROOT / journal_kinds.DOC_REL
    assert journal_kinds.traced_kinds(str(doc)) == {
        "serve_request", "serve_rejected", "serve_request_requeued",
        "serve_route", "serve_spill", "serve_tenant_throttled",
        "serve_client_request", "serve_request_replayed",
        "serve_request_expired", "serve_deadline_infeasible", "serve_hedged",
        "serve_cancelled"}


# ------------------------------------------------- a tree of its own

KNOBS_DOC = """\
# knobs

| Knob | Default | Read by | What |
| --- | --- | --- | --- |
| `TPKT_READ` | 1 | `a.py` | read |
"""

OBS_DOC = """\
# journal

Traced kinds (request-id lint): `traced_kind` — every emit passes one.

## Event kinds

| Kind | Emitted by | What |
| --- | --- | --- |
| `known_kind` | `a.py` | known |
| `traced_kind` | `a.py` | traced |

## Fault keys

| Key | Example | Effect |
| --- | --- | --- |
| `plan_key` / `spec_key` | `"x"` | documented |
| `loop_key` | `{}` | documented |
"""

MODULE = '''\
"""Docstring naming TPKT_IN_A_DOCSTRING, which is prose."""
import os

from tpukernels_torch.resilience import journal


def f(rid):
    os.environ.get("TPKT_READ")
    journal.emit("known_kind", x=1)
    journal.emit(
        "traced_kind",  # a comment with a ( paren
        request_id=rid)
'''

FAULTS = '''\
_PLAN = {}


def _spec(key, kernel=None):
    return _PLAN.get(key)


def points():
    _PLAN.get("plan_key")
    _spec("spec_key", "k")
    for key, mode in (("loop_key", "a"),):
        _spec(key, "k")
'''


def _tree(tmp_path, over=None):
    """A mini repository under ``tmp_path``: the package's module, its
    fault module, its C source, ``chip_smoke.py`` and both catalogs;
    ``over`` maps a relative path to the text that replaces (or adds)
    it."""
    files = {"tpukernels_torch/a.py": MODULE,
             "tpukernels_torch/resilience/faults.py": FAULTS,
             "tpukernels_torch/csrc/shim.c":
                 'const char *v = getenv("TPKT_READ");\n'
                 "#define TPKT_MACRO 1\n",
             "chip_smoke.py": "X = 1\n",
             env_knobs.DOC_REL: KNOBS_DOC,
             journal_kinds.DOC_REL: OBS_DOC}
    files.update(over or {})
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


def _lint(mod, root, capsys):
    rc = mod.main(["--root", root])
    return rc, capsys.readouterr().out


def test_a_clean_tree_passes_both(tmp_path, capsys):
    root = _tree(tmp_path)
    rc, out = _lint(env_knobs, root, capsys)
    assert rc == 0 and "OK - 1 knobs across 2 reference(s)" in out, out
    rc, out = _lint(journal_kinds, root, capsys)
    assert rc == 0, out
    assert ("OK - 2 kinds across 2 callsites, all documented; 1 traced "
            "kind(s) all carry request_id; 3 fault key(s)") in out


@pytest.mark.parametrize("where, text", [
    ("tpukernels_torch/b.py", 'import os\nos.environ["TPKT_NEW"] = "1"\n'),
    ("tpukernels_torch/steps.py",
     'BODY = """\nset -e\nenv TPKT_NEW=1 python3 -m x\n"""\n'),
    ("chip_smoke.py", 'KNOBS = ("TPKT_NEW",)\n'),
    ("tpukernels_torch/csrc/more.c", 'getenv( "TPKT_NEW")\n'),
])
def test_an_undocumented_knob_fails(tmp_path, capsys, where, text):
    rc, out = _lint(env_knobs, _tree(tmp_path, {where: text}), capsys)
    assert rc == 1
    assert "knob 'TPKT_NEW' is referenced but not in the" in out
    assert where in out


def test_prose_macros_and_prefixes_are_not_knobs(tmp_path, capsys):
    text = ('"""A docstring: TPKT_PROSE."""\n'
            'x = f"TPKT_SGEMM_{1}"\n'
            "# TPKT_COMMENT\n")
    rc, out = _lint(env_knobs,
                    _tree(tmp_path, {"tpukernels_torch/c.py": text}), capsys)
    assert rc == 0, out


def test_an_unused_knob_row_warns(tmp_path, capsys):
    doc = KNOBS_DOC + "| `TPKT_GONE` | 0 | `x.py` | removed |\n"
    rc, out = _lint(env_knobs, _tree(tmp_path, {env_knobs.DOC_REL: doc}),
                    capsys)
    assert rc == 0
    assert "WARN documented knob 'TPKT_GONE' has no production" in out


def test_an_undocumented_kind_fails(tmp_path, capsys):
    text = MODULE + '\n\ndef g():\n    journal.emit("new_kind")\n'
    rc, out = _lint(journal_kinds,
                    _tree(tmp_path, {"tpukernels_torch/a.py": text}), capsys)
    assert rc == 1
    assert "kind 'new_kind' is emitted but not in the" in out
    assert "tpukernels_torch/a.py:16" in out


def test_a_non_literal_kind_fails(tmp_path, capsys):
    text = MODULE + '\n\ndef g(k):\n    journal.emit(f"aot_{k}")\n'
    rc, out = _lint(journal_kinds,
                    _tree(tmp_path, {"tpukernels_torch/a.py": text}), capsys)
    assert rc == 1 and "non-literal kind at tpukernels_torch/a.py:16" in out


def test_an_untagged_traced_emit_fails(tmp_path, capsys):
    text = MODULE + ('\n\ndef g():\n    journal.emit("traced_kind", '
                     'note="request_id is in a string, not passed")\n')
    rc, out = _lint(journal_kinds,
                    _tree(tmp_path, {"tpukernels_torch/a.py": text}), capsys)
    assert rc == 1
    assert "traced kind 'traced_kind' emitted WITHOUT request_id at " \
        "tpukernels_torch/a.py:16" in out
    assert "a.py:10" not in out  # the tagged callsite passes


@pytest.mark.parametrize("line", [
    '    _PLAN.get("new_key")',
    '    _spec("new_key", "k")',
    '    for key in ("new_key",):\n        _spec(key)',
    '    for key, act in (("new_key", 1),):\n        _PLAN.get(key)',
])
def test_an_undocumented_fault_key_fails(tmp_path, capsys, line):
    faults = FAULTS + "\n\ndef more():\n" + line + "\n"
    rc, out = _lint(journal_kinds, _tree(
        tmp_path, {"tpukernels_torch/resilience/faults.py": faults}), capsys)
    assert rc == 1
    assert "fault plan key 'new_key' is consumed by" in out


def test_an_unused_kind_row_warns(tmp_path, capsys):
    doc = OBS_DOC.replace("| `traced_kind` |",
                          "| `gone_kind` | `x.py` | removed |\n"
                          "| `traced_kind` |")
    rc, out = _lint(journal_kinds,
                    _tree(tmp_path, {journal_kinds.DOC_REL: doc}), capsys)
    assert rc == 0
    assert "WARN documented kind 'gone_kind' has no production callsite" \
        in out


def test_fault_rows_are_not_kinds(tmp_path, capsys):
    """The fault-key table's rows document keys, not kinds: a kind named
    only there is undocumented."""
    text = MODULE + '\n\ndef g():\n    journal.emit("loop_key")\n'
    rc, out = _lint(journal_kinds,
                    _tree(tmp_path, {"tpukernels_torch/a.py": text}), capsys)
    assert rc == 1 and "kind 'loop_key' is emitted but not in" in out


@pytest.mark.parametrize("mod", [env_knobs, journal_kinds])
def test_a_tree_without_its_catalog_fails(tmp_path, capsys, mod):
    root = _tree(tmp_path)
    os.remove(os.path.join(root, mod.DOC_REL))
    rc, out = _lint(mod, root, capsys)
    assert rc == 1 and "nothing to lint against" in out


@pytest.mark.parametrize("mod", [env_knobs, journal_kinds])
def test_usage(mod, capsys):
    assert mod.main(["--root"]) == 2
    assert mod.main(["--bogus"]) == 2
    assert "unknown argument" in capsys.readouterr().err


def test_an_unparseable_module_fails_the_knob_lint(tmp_path, capsys):
    rc, out = _lint(env_knobs, _tree(
        tmp_path, {"tpukernels_torch/bad.py": "def (:\n"}),
        capsys)
    assert rc == 1 and "cannot scan tpukernels_torch/bad.py" in out
