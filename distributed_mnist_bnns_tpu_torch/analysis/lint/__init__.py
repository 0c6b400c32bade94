"""AST linter of the port: the JAX package's rule registry (JG001-JG018)
with each ID carried over, given a torch counterpart, or registered as
not applicable with its reason (``rules.py``), and the concurrency pack
(JG007-JG011, ``analysis/concurrency/``). ``cli lint`` runs it."""

from .core import (
    Finding,
    LintModule,
    changed_py_files,
    fix_suppressions,
    format_human,
    format_json,
    format_sarif,
    run_paths,
    run_source,
)
from .rules import RULES, RuleNotApplicable, check_rule_ids

__all__ = [
    "Finding",
    "LintModule",
    "RULES",
    "RuleNotApplicable",
    "changed_py_files",
    "check_rule_ids",
    "fix_suppressions",
    "format_human",
    "format_json",
    "format_sarif",
    "run_paths",
    "run_source",
]
