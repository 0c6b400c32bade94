"""Linter engine: AST analysis shared by the rules, suppression comments,
file walking and output formatting (the JAX package's
``analysis/lint/core.py``, its framework-free machinery kept line for
line).

The rules themselves live in ``rules.py``; this module gives them a
parsed, pre-analyzed view of one source file (``LintModule``) with the
groundwork done once:

* a parent map over the AST,
* per-scope name -> FunctionDef/Lambda/assignment resolution,
* the *captured* regions: the body of a ``with torch.cuda.graph(...)``
  block, and every function the module passes as the step body to
  ``train.capture.TrainScan`` (the port's one capture entry point), plus
  everything lexically nested inside one. A captured region runs once
  at capture and then only as replays of what it recorded on the card:
  a host read there fails the capture or reads a value frozen at
  capture time. This takes the place of the JAX package's traced
  functions (``jax.jit`` and the ``lax`` loop and cond bodies).

Suppression syntax (checked by tests/test_torch_lint.py)::

    x = float(y)  # jg: disable=JG001 -- y is a python scalar here

A ``# jg: disable=...`` comment suppresses the listed rules (or ``all``)
on its own line; a comment-only line suppresses them on the next code
line. The ``--`` reason is mandatory — an unexplained suppression is
itself reported as unsuppressable ``JG000``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*jg:\s*disable=(?P<rules>[A-Za-z0-9,* ]+?)"
    r"\s*(?:--\s*(?P<reason>.*\S))?\s*$"
)

#: the port's capture entry points: name-of-last-dotted-segment -> the
#: indices (and keywords) of the arguments that run captured.
CAPTURING_CALLS: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "TrainScan": ((0,), ("chunk",)),
}

#: dotted names of the context managers whose body is captured.
CAPTURING_BLOCKS = ("torch.cuda.graph", "cuda.graph")


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        if self.reason is None:
            d.pop("reason")
        return d


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_segment(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def parse_suppressions(lines: Sequence[str]) -> Dict[int, Tuple[Set[str], Optional[str]]]:
    """1-based line -> (rule ids or {'all'}, reason). A comment-only
    suppression line covers the next line as well."""
    out: Dict[int, Tuple[Set[str], Optional[str]]] = {}
    for i, raw in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {
            r.strip().upper() if r.strip() != "all" else "all"
            for r in m.group("rules").replace("*", "all").split(",")
            if r.strip()
        }
        entry = (rules, m.group("reason"))
        out[i] = entry
        if raw.lstrip().startswith("#"):  # standalone: covers next line
            out[i + 1] = entry
    return out


class LintModule:
    """One parsed source file plus the shared analyses rules consume."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressions = parse_suppressions(self.lines)
        self.parents: Dict[ast.AST, ast.AST] = {}
        # each node's nearest enclosing function scope (or the module),
        # filled in the same walk: a parent is walked before its children
        self._scope_of: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            scope = node if isinstance(node, _SCOPES) else (
                self._scope_of.get(node, self.tree))
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                self._scope_of[child] = scope
        self._index_scopes()
        self._find_captured()

    # -- scopes and name resolution -----------------------------------------

    def _index_scopes(self) -> None:
        """Map each function/module scope to its locally-bound callables
        and simple assignments (last lexical binding wins)."""
        self.scope_defs: Dict[ast.AST, Dict[str, ast.AST]] = {}
        self.scope_assigns: Dict[ast.AST, Dict[str, ast.AST]] = {}
        for node in ast.walk(self.tree):
            scope = self.enclosing_scope(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.scope_defs.setdefault(scope, {})[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    if isinstance(node.value, ast.Lambda):
                        self.scope_defs.setdefault(scope, {})[
                            tgt.id
                        ] = node.value
                    self.scope_assigns.setdefault(scope, {})[
                        tgt.id
                    ] = node.value

    def enclosing_scope(self, node: ast.AST) -> ast.AST:
        """Nearest enclosing function scope (or the module)."""
        return self._scope_of.get(node, self.tree)

    def enclosing_scopes(self, node: ast.AST) -> Iterable[ast.AST]:
        scope = self.enclosing_scope(node)
        while True:
            yield scope
            if isinstance(scope, ast.Module):
                return
            scope = self.enclosing_scope(scope)

    def resolve_callable(self, node: ast.AST) -> Optional[ast.AST]:
        """Resolve an expression used as a function value to its
        FunctionDef/Lambda: direct lambdas and names bound in an
        enclosing scope (a def, or ``name = lambda ...``)."""
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return node
        if not isinstance(node, ast.Name):
            return None
        for scope in self.enclosing_scopes(node):
            if node.id in self.scope_defs.get(scope, {}):
                return self.scope_defs[scope][node.id]
            if node.id in self.scope_assigns.get(scope, {}):
                return None
        return None

    # -- captured-region analysis -------------------------------------------

    def _find_captured(self) -> None:
        """Mark the FunctionDefs/Lambdas passed as a step body to a
        capture entry point, and the ``with torch.cuda.graph(...)``
        statements whose body is captured."""
        captured: Set[ast.AST] = set()
        blocks: Set[ast.AST] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                spec = CAPTURING_CALLS.get(last_segment(node.func) or "")
                if spec is None:
                    continue
                positions, keywords = spec
                args = [node.args[i] for i in positions if i < len(node.args)]
                args += [k.value for k in node.keywords if k.arg in keywords]
                for arg in args:
                    fn = self.resolve_callable(arg)
                    if fn is not None:
                        captured.add(fn)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and (
                        dotted_name(expr.func) in CAPTURING_BLOCKS
                    ):
                        blocks.add(node)
        self.captured = captured
        self.capture_blocks = blocks

    def is_captured(self, node: ast.AST) -> bool:
        """True when ``node`` runs captured: inside (or being) a captured
        def, or in the body of a capturing ``with`` block, including
        lexical nesting."""
        cur: Optional[ast.AST] = node
        prev: Optional[ast.AST] = None
        while cur is not None:
            if cur in self.captured:
                return True
            if cur in self.capture_blocks and prev is not None and any(
                prev is stmt for stmt in cur.body
            ):
                return True
            prev, cur = cur, self.parents.get(cur)
        return False

    def nearest_def(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            cur = self.parents.get(cur)
        return cur

    def is_test_file(self) -> bool:
        base = os.path.basename(self.path)
        return base.startswith(("test_", "conftest")) or (
            os.sep + "tests" + os.sep
        ) in self.path


def apply_suppressions(module: LintModule, findings: List[Finding]) -> List[Finding]:
    """Mark suppressed findings. A disable with no ``-- reason``, or a
    placeholder ``TODO`` reason (what ``--fix-suppressions`` writes),
    does NOT suppress — the finding stays active and a companion
    ``JG000`` records the bad suppression itself, so the gate cannot be
    neutralized without writing a real justification."""
    extra: List[Finding] = []
    for f in findings:
        entry = module.suppressions.get(f.line)
        if entry is None:
            continue
        rules, reason = entry
        if "all" in rules or f.rule in rules:
            if not reason or reason.strip().upper().startswith("TODO"):
                what = "without a '-- reason'" if not reason else (
                    "with a placeholder TODO reason"
                )
                extra.append(
                    Finding(
                        rule="JG000", path=f.path, line=f.line, col=f.col,
                        message=(
                            f"suppression of {f.rule} {what} does not "
                            "suppress — write the actual justification"
                        ),
                    )
                )
                continue
            f.suppressed = True
            f.reason = reason
    return findings + extra


def run_source(
    source: str,
    path: str = "<string>",
    rule_ids: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint one source string. Returns findings with suppressions applied
    (suppressed ones included, flagged)."""
    from .rules import RULES, check_rule_ids

    if rule_ids:
        check_rule_ids(rule_ids)
    module = LintModule(path, source)
    selected = (
        {r.upper() for r in rule_ids} if rule_ids else set(RULES.keys())
    )
    findings: List[Finding] = []
    for rule_id, rule in RULES.items():
        if rule_id not in selected or rule.check is None:
            continue
        findings.extend(rule.check(module))
    # A rule may visit the same node through two captured roots: dedup.
    seen = set()
    unique = []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        key = (f.rule, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return apply_suppressions(module, unique)


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".venv")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def run_paths(
    paths: Sequence[str],
    rule_ids: Optional[Sequence[str]] = None,
) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            findings.extend(run_source(source, path, rule_ids))
        except SyntaxError as e:
            findings.append(
                Finding(
                    rule="JG000", path=path, line=e.lineno or 0, col=0,
                    message=f"could not parse: {e.msg}",
                )
            )
    return findings


def format_human(findings: Sequence[Finding], *, show_suppressed: bool = False) -> str:
    out: List[str] = []
    shown = 0
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        shown += 1
        tag = f" (suppressed: {f.reason})" if f.suppressed else ""
        out.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}{tag}")
    n_sup = sum(1 for f in findings if f.suppressed)
    n_active = len(findings) - n_sup
    out.append(
        f"{n_active} finding(s), {n_sup} suppressed"
        + ("" if show_suppressed or not n_sup else " (hidden)")
    )
    return "\n".join(out)


def format_json(findings: Sequence[Finding]) -> str:
    n_sup = sum(1 for f in findings if f.suppressed)
    return json.dumps(
        {
            "findings": [f.to_dict() for f in findings],
            "unsuppressed": len(findings) - n_sup,
            "suppressed": n_sup,
        },
        indent=2,
    )


def _sarif_source_root() -> str:
    """The base result URIs are relativized against: the git toplevel
    when available (what GitHub code scanning resolves URIs from),
    else the working directory."""
    import subprocess

    try:
        proc = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=10,
        )
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip()
    except OSError:
        pass
    return os.getcwd()


def format_sarif(findings: Sequence[Finding]) -> str:
    """SARIF 2.1.0 — the schema CI annotation uploaders (GitHub code
    scanning, `sarif-tools`) consume. Result URIs are repo-relative
    (code scanning matches them against checkout paths; an absolute
    runner path would silently anchor nothing). Suppressed findings
    are carried with ``suppressions`` entries (SARIF's own mechanism)
    so the reasons survive into the annotation UI; unsuppressed ones
    become ``error``-level results, matching the exit-code gate."""
    from .rules import RULES

    rules_meta = [
        {
            "id": rule.id,
            "name": rule.name,
            "shortDescription": {"text": rule.description},
        }
        for rule in RULES.values()
        if rule.check is not None
    ]
    known = {r["id"] for r in rules_meta}
    root = _sarif_source_root()
    results = []
    for f in findings:
        rel = os.path.relpath(os.path.abspath(f.path), root)
        uri = f.path if rel.startswith("..") else rel  # outside root: keep
        result = {
            "ruleId": f.rule,
            "level": "note" if f.suppressed else "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": uri.replace(os.sep, "/"),
                        },
                        "region": {
                            "startLine": max(f.line, 1),
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if f.suppressed:
            result["suppressions"] = [
                {
                    "kind": "inSource",
                    "justification": f.reason or "",
                }
            ]
        results.append(result)
        if f.rule not in known:  # JG000 meta-findings
            known.add(f.rule)
            rules_meta.append({
                "id": f.rule,
                "name": "meta",
                "shortDescription": {
                    "text": "linter meta-finding (bad suppression or "
                            "unparsable file)",
                },
            })
    return json.dumps(
        {
            "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
            "version": "2.1.0",
            "runs": [
                {
                    "tool": {
                        "driver": {
                            "name": "jg-lint-torch",
                            "rules": rules_meta,
                        }
                    },
                    "results": results,
                }
            ],
        },
        indent=2,
    )


def changed_py_files(
    base: str = "HEAD", repo_root: Optional[str] = None
) -> List[str]:
    """Python files changed vs ``base`` per git (staged, unstaged and
    untracked), for ``cli lint --changed-only``. Paths come back
    absolute and existing-only (a deleted file has nothing to lint).
    Raises ``RuntimeError`` when git is unavailable or the diff fails —
    the caller decides whether that falls back to a full lint (CI
    wants loud, a laptop wants convenient)."""
    import subprocess

    def run(cwd: str, *argv: str) -> List[str]:
        proc = subprocess.run(
            argv, cwd=cwd, capture_output=True, text=True, timeout=60,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(argv)} failed: {proc.stderr.strip()}"
            )
        return [ln for ln in proc.stdout.splitlines() if ln.strip()]

    try:
        top = run(
            repo_root or os.getcwd(), "git", "rev-parse", "--show-toplevel",
        )[0]
        # Diff against the merge base (three-dot semantics), not the
        # ref's tip: `--base origin/main` must scope to what THIS
        # branch changed, not every file other PRs landed on main.
        merge_base = run(top, "git", "merge-base", base, "HEAD")[0]
        # Both listings run from the toplevel: `diff --name-only` is
        # toplevel-relative regardless, but `ls-files --others` is
        # cwd-relative AND cwd-scoped — from a subdirectory it would
        # miss untracked files elsewhere and mis-join the rest.
        listed = run(
            top, "git", "diff", "--name-only", "--diff-filter=d",
            merge_base, "--",
        )
        listed += run(
            top, "git", "ls-files", "--others", "--exclude-standard",
        )
    except (OSError, RuntimeError, IndexError) as e:
        raise RuntimeError(f"cannot compute changed files: {e}") from e
    out = []
    for rel in dict.fromkeys(listed):  # dedup, keep order
        if not rel.endswith(".py"):
            continue
        path = os.path.join(top, rel)
        if os.path.isfile(path):
            out.append(path)
    return out


def fix_suppressions(findings: Sequence[Finding]) -> int:
    """Append a TODO suppression comment to every unsuppressed finding's
    line (skipping lines that already carry a jg: comment). Returns the
    number of edited lines. An annotator for burning down a large
    backlog: TODO reasons deliberately do NOT suppress (the finding
    stays active plus a JG000 for the placeholder), so the gate only
    goes green once every reason is actually written."""
    by_file: Dict[str, List[Finding]] = {}
    for f in findings:
        if not f.suppressed and f.rule != "JG000":
            by_file.setdefault(f.path, []).append(f)
    edited = 0
    for path, file_findings in by_file.items():
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines(keepends=True)
        rules_by_line: Dict[int, Set[str]] = {}
        for f in file_findings:
            rules_by_line.setdefault(f.line, set()).add(f.rule)
        for lineno, rules in rules_by_line.items():
            idx = lineno - 1
            if idx >= len(lines) or "jg:" in lines[idx]:
                continue
            body = lines[idx].rstrip("\n")
            lines[idx] = (
                f"{body}  # jg: disable={','.join(sorted(rules))} "
                "-- TODO: justify or fix\n"
            )
            edited += 1
        with open(path, "w", encoding="utf-8") as fh:
            fh.writelines(lines)
    return edited
