"""Lint: every ``TPKT_*`` env knob of the port must be documented.

Usage:
    python -m tpukernels_torch.obs.env_knobs [--root DIR]
    # rc 0 clean, 1 findings, 2 usage

The port's copy of ``tools/env_knobs.py``. A knob that exists only in the
code that reads it is an operator running with a default they cannot
discover. This lint scans every ``TPKT_*`` knob the port's production
code references and asserts each has a row in the catalog table of
``tpukernels_torch/docs/KNOBS.md`` (``| `TPKT_...` | default | module |
...``):

- ``tpukernels_torch/**/*.py`` and ``chip_smoke.py`` through the AST: a
  string constant that IS a knob name (an env read, write or
  declaration; a docstring that mentions knobs never matches whole, and
  a constant ending in ``_`` is the prefix of a name composed at run
  time), and every knob named inside a multi-line string that is not a
  docstring (the revalidation steps' shell bodies);
- ``tpukernels_torch/csrc/*`` by regex: the ``getenv("TPKT_...")`` reads
  of the C shim (the sources' other ``TPKT_`` names are macros).

It also warns, without failing, on catalog rows no production code
references: usually a knob removed without its row.
"""

from __future__ import annotations

import ast
import glob
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOC_REL = os.path.join("tpukernels_torch", "docs", "KNOBS.md")

_KNOB_RE = re.compile(r"TPKT_[A-Z0-9_]*[A-Z0-9]")
_GETENV_RE = re.compile(r"getenv\(\s*\"(TPKT_[A-Z0-9_]+)\"")
_DOC_KNOB_RE = re.compile(r"^\|\s*`(TPKT_\w+)`", re.MULTILINE)


def production_files(repo=_REPO):
    """``(python_files, c_files)`` the lint scans; the lint's own file is
    left out."""
    pkg = os.path.join(repo, "tpukernels_torch")
    py = sorted(glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True))
    py.append(os.path.join(repo, "chip_smoke.py"))
    c = sorted(glob.glob(os.path.join(pkg, "csrc", "*")))
    return ([f for f in py if os.path.isfile(f)
             and os.path.basename(f) != "env_knobs.py"],
            [f for f in c if os.path.isfile(f)])


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                out.add(id(first.value))
    return out


def python_knobs(tree) -> list:
    """``[(knob, line), ...]`` referenced by one parsed module."""
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value,
                                                              str)):
            continue
        if _KNOB_RE.fullmatch(node.value):
            found.append((node.value, node.lineno))
        elif "\n" in node.value and id(node) not in docs:
            for i, line in enumerate(node.value.splitlines()):
                found.extend((m.group(0), node.lineno + i)
                             for m in _KNOB_RE.finditer(line))
    return found


def referenced_knobs(repo=_REPO):
    """``{knob: [file:line, ...]}`` over production references, and the
    files that could not be scanned (reported, never skipped)."""
    knobs: dict = {}
    unparseable = []
    py, c = production_files(repo)
    for path in py:
        rel = os.path.relpath(path, repo)
        try:
            with open(path) as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError, ValueError) as e:
            unparseable.append(f"{rel}: {e}")
            continue
        for knob, line in python_knobs(tree):
            knobs.setdefault(knob, []).append(f"{rel}:{line}")
    for path in c:
        rel = os.path.relpath(path, repo)
        try:
            with open(path) as f:
                text = f.read()
        except (OSError, UnicodeDecodeError) as e:
            unparseable.append(f"{rel}: {e}")
            continue
        for m in _GETENV_RE.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            knobs.setdefault(m.group(1), []).append(f"{rel}:{line}")
    return knobs, unparseable


def documented_knobs(doc):
    try:
        with open(doc) as f:
            return set(_DOC_KNOB_RE.findall(f.read()))
    except OSError:
        return set()


def main(argv=None) -> int:
    repo = _REPO
    argv = sys.argv[1:] if argv is None else list(argv)
    it = iter(argv)
    for a in it:
        if a == "--root":
            try:
                repo = next(it)
            except StopIteration:
                print("env_knobs: --root requires a value", file=sys.stderr)
                return 2
        else:
            print(f"env_knobs: unknown argument {a!r}", file=sys.stderr)
            return 2
    knobs, unparseable = referenced_knobs(repo)
    documented = documented_knobs(os.path.join(repo, DOC_REL))
    rc = 0
    if not documented:
        print(f"env_knobs: {DOC_REL} has no knob catalog "
              "(| `TPKT_...` | rows) - nothing to lint against")
        rc = 1
    undocumented = {k: v for k, v in knobs.items() if k not in documented}
    for knob in sorted(undocumented):
        print(f"env_knobs: knob {knob!r} is referenced but not in the "
              f"{DOC_REL} catalog:")
        for where in undocumented[knob][:6]:
            print(f"  {where}")
        rc = 1
    for msg in unparseable:
        print(f"env_knobs: cannot scan {msg}")
        rc = 1
    for knob in sorted(documented - set(knobs)):
        print(f"env_knobs: WARN documented knob {knob!r} has no "
              "production reference (stale doc row?)")
    if rc == 0:
        print(f"env_knobs: OK - {len(knobs)} knobs across "
              f"{sum(len(v) for v in knobs.values())} reference(s), all "
              "documented")
    return rc


if __name__ == "__main__":
    sys.exit(main())
