"""Lint: every journal event kind, traced emit and fault key of the port
must be documented.

Usage:
    python -m tpukernels_torch.obs.journal_kinds [--root DIR]
    # rc 0 clean, 1 findings, 2 usage

The port's copy of ``tools/journal_kinds.py``, against the port's own
catalog ``tpukernels_torch/docs/OBSERVABILITY.md``. It scans the
production ``journal.emit("kind", ...)`` callsites of
``tpukernels_torch/**`` (tests may emit throwaway kinds) and checks:

- every kind literal has a row in the catalog's event-kind table (the
  section headed "Event kinds"): the contract the readers key on
  (``obs/report.py``, ``obs/health_report.py``, ``obs/trend.py``, a
  postmortem's grep), so an undocumented kind is a reader silently
  skipping events. A callsite whose kind is not a string literal cannot
  be checked and fails;
- every production emit of a kind on the catalog's "Traced kinds
  (request-id lint):" line passes ``request_id=``: one untagged callsite
  is a hole in every request's timeline;
- every plan key ``resilience/faults.py`` consumes has a row in the
  catalog's fault-key table (the section headed "Fault keys"): its
  literal ``_PLAN.get("...")`` lookups, and the keys that reach the
  generic lookup ``_spec`` through the fault points, as a literal or
  through a loop over a literal tuple.

It also warns, without failing, on catalog rows no callsite emits:
usually a callsite removed without its row.
"""

from __future__ import annotations

import ast
import glob
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOC_REL = os.path.join("tpukernels_torch", "docs", "OBSERVABILITY.md")
FAULTS_REL = os.path.join("tpukernels_torch", "resilience", "faults.py")

# \s* spans the newline of a wrapped call; the kind must be the first
# argument, a literal, or the callsite is unlintable
_EMIT_RE = re.compile(r"journal\.emit\(\s*([\"']\w+[\"']|[^\s\"'])")
_ROW_RE = re.compile(r"^\|\s*`(\w+)`", re.MULTILINE)
# the paragraph naming the traced kinds runs to the em dash that ends
# the list, or to the blank line after it
_TRACED_RE = re.compile(
    r"Traced kinds \(request-id lint\):(.*?)(?:—|\n\n)", re.DOTALL)


def _call_text(text: str, start: int) -> str:
    """The balanced-paren call text from the ``(`` at ``start``; string
    literals and ``#`` comments are skipped, so a paren inside a message
    or an apostrophe in a comment cannot desync the scan."""
    depth, i, n, in_str = 0, start, len(text), None
    while i < n:
        c = text[i]
        if in_str is not None:
            if c == "\\":
                i += 2
                continue
            if c == in_str:
                in_str = None
        elif c == "#":
            nl = text.find("\n", i)
            i = n if nl < 0 else nl
        elif c in "\"'":
            in_str = c
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return text[start:i + 1]
        i += 1
    return text[start:]


def _section(doc_text: str, heading: str) -> str:
    """The text of the ``## ...`` section whose heading holds
    ``heading``, up to the next ``## `` heading ('' when absent)."""
    m = re.search(rf"^##[^\n]*{re.escape(heading)}[^\n]*\n(.*?)(?=^## |\Z)",
                  doc_text, re.MULTILINE | re.DOTALL)
    return m.group(1) if m else ""


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def documented_kinds(doc: str) -> set:
    return set(_ROW_RE.findall(_section(_read(doc), "Event kinds")))


def documented_fault_keys(doc: str) -> set:
    """Keys in the first cell of the fault-key table's rows (one row may
    name several keys that share a contract: ``| `fail_capi` /
    `wedge_capi` |``)."""
    keys = set()
    for line in _section(_read(doc), "Fault keys").splitlines():
        m = re.match(r"\|([^|]*)\|", line)
        if m:
            keys.update(re.findall(r"`(\w+)`", m.group(1)))
    return keys


def traced_kinds(doc: str) -> set:
    m = _TRACED_RE.search(_read(doc))
    return set(re.findall(r"`(\w+)`", m.group(1))) if m else set()


def production_files(repo=_REPO):
    files = sorted(glob.glob(os.path.join(repo, "tpukernels_torch", "**",
                                          "*.py"), recursive=True))
    # this lint's own docstring shows journal.emit(...) as prose
    return [f for f in files if os.path.isfile(f)
            and os.path.basename(f) != "journal_kinds.py"]


def _emits(repo):
    """``(kind or None, file:line, file text, match)`` for every
    production callsite."""
    for path in production_files(repo):
        text = _read(path)
        rel = os.path.relpath(path, repo)
        for m in _EMIT_RE.finditer(text):
            where = f"{rel}:{text.count(chr(10), 0, m.start()) + 1}"
            tok = m.group(1)
            kind = tok.strip("\"'") if tok[0] in "\"'" else None
            yield kind, where, text, m


def emitted_kinds(repo=_REPO):
    """``{kind: [file:line, ...]}`` and the unlintable callsites."""
    kinds, unlintable = {}, []
    for kind, where, _text, _m in _emits(repo):
        if kind is None:
            unlintable.append(where)
        else:
            kinds.setdefault(kind, []).append(where)
    return kinds, unlintable


def untagged_traced_callsites(repo=_REPO, traced=None):
    """``[(kind, file:line), ...]``: emits of a traced kind whose call
    passes no ``request_id=``."""
    if traced is None:
        traced = traced_kinds(os.path.join(repo, DOC_REL))
    missing = []
    for kind, where, text, m in _emits(repo):
        if kind in traced:
            call = _call_text(text, text.index("(", m.start()))
            if not re.search(r"\brequest_id\s*=", call):
                missing.append((kind, where))
    return missing


def _spec_loop_keys(tree) -> set:
    """Keys that reach ``_spec(name, ...)`` or ``_PLAN.get(name)`` through
    ``for ... in <literal tuple>`` loops whose target binds ``name``."""
    keys = set()
    for loop in ast.walk(tree):
        if not (isinstance(loop, ast.For)
                and isinstance(loop.iter, (ast.Tuple, ast.List))):
            continue
        names = ([loop.target] if isinstance(loop.target, ast.Name)
                 else list(getattr(loop.target, "elts", [])))
        for call in ast.walk(loop):
            f = getattr(call, "func", None)
            if not (isinstance(call, ast.Call) and call.args
                    and isinstance(call.args[0], ast.Name)
                    and ((isinstance(f, ast.Name) and f.id == "_spec")
                         or (isinstance(f, ast.Attribute) and f.attr == "get"
                             and isinstance(f.value, ast.Name)
                             and f.value.id == "_PLAN"))):
                continue
            pos = [i for i, n in enumerate(names)
                   if isinstance(n, ast.Name) and n.id == call.args[0].id]
            for item in loop.iter.elts:
                if pos and isinstance(item, (ast.Tuple, ast.List)):
                    item = item.elts[pos[0]]
                if isinstance(item, ast.Constant) and isinstance(
                        item.value, str):
                    keys.add(item.value)
    return keys


def fault_plan_keys(repo=_REPO) -> list:
    """The plan keys ``resilience/faults.py`` consumes (empty when the
    module is absent)."""
    text = _read(os.path.join(repo, FAULTS_REL))
    if not text:
        return []
    tree = ast.parse(text)
    keys = _spec_loop_keys(tree)
    for call in ast.walk(tree):
        if not (isinstance(call, ast.Call) and call.args
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            continue
        f = call.func
        if (isinstance(f, ast.Name) and f.id == "_spec") or (
                isinstance(f, ast.Attribute) and f.attr == "get"
                and isinstance(f.value, ast.Name) and f.value.id == "_PLAN"):
            keys.add(call.args[0].value)
    return sorted(keys)


def main(argv=None) -> int:
    repo = _REPO
    argv = sys.argv[1:] if argv is None else list(argv)
    it = iter(argv)
    for a in it:
        if a == "--root":
            try:
                repo = next(it)
            except StopIteration:
                print("journal_kinds: --root requires a value",
                      file=sys.stderr)
                return 2
        else:
            # an ignored argument must not lint the wrong tree and say OK
            print(f"journal_kinds: unknown argument {a!r}", file=sys.stderr)
            return 2
    doc = os.path.join(repo, DOC_REL)
    kinds, unlintable = emitted_kinds(repo)
    documented = documented_kinds(doc)
    rc = 0
    if not documented:
        print(f"journal_kinds: {DOC_REL} has no event-kind catalog "
              "(| `kind` | rows under 'Event kinds') - nothing to lint "
              "against")
        rc = 1
    for kind in sorted(k for k in kinds if k not in documented):
        print(f"journal_kinds: kind {kind!r} is emitted but not in the "
              f"{DOC_REL} catalog:")
        for where in kinds[kind]:
            print(f"  {where}")
        rc = 1
    for where in unlintable:
        print(f"journal_kinds: non-literal kind at {where} - unlintable; "
              "pass the kind as a string literal")
        rc = 1
    traced = traced_kinds(doc)
    for kind, where in untagged_traced_callsites(repo, traced):
        print(f"journal_kinds: traced kind {kind!r} emitted WITHOUT "
              f"request_id at {where} (every emit of a traced kind must "
              "carry the request's id)")
        rc = 1
    fault_keys = fault_plan_keys(repo)
    documented_faults = documented_fault_keys(doc)
    for key in fault_keys:
        if key not in documented_faults:
            print(f"journal_kinds: fault plan key {key!r} is consumed by "
                  f"{FAULTS_REL} but has no row in the {DOC_REL} "
                  "fault-key table")
            rc = 1
    for kind in sorted(documented - set(kinds)):
        print(f"journal_kinds: WARN documented kind {kind!r} has no "
              "production callsite (stale doc row?)")
    if rc == 0:
        print(f"journal_kinds: OK - {len(kinds)} kinds across "
              f"{sum(len(v) for v in kinds.values())} callsites, all "
              f"documented; {len(traced)} traced kind(s) all carry "
              f"request_id; {len(fault_keys)} fault key(s) all documented")
    return rc


if __name__ == "__main__":
    sys.exit(main())
