"""graftlint for the port — AST-based invariant checks for
cup2d_tpu_torch.

Torch-import-free by contract (nothing in this subpackage imports
torch, jax, numpy, or the simulation modules it inspects); runs
anywhere Python runs in well under 5 s. See core.py for the framework,
rules.py for the five checkers, policy.py for the sanctioned-site
tables.

Usage::

    python -m cup2d_tpu_torch.analysis [--json] [--only env-latch] [paths]

or in-process::

    from cup2d_tpu_torch.analysis import lint_package
    report = lint_package(only=["env-latch"])
    assert report.clean, "\\n".join(map(str, report.findings))
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .core import (Finding, LintConfigError, Module, Report, Rule,
                   collect_package_modules, package_root, run_rules)
from .rules import ALL_RULES, RULE_NAMES, make_rules

__all__ = [
    "ALL_RULES", "RULE_NAMES", "Finding", "LintConfigError", "Module",
    "Report", "Rule", "lint_package", "lint_sources", "make_rules",
]


def lint_package(only: Optional[Sequence[str]] = None,
                 skip: Optional[Sequence[str]] = None,
                 root: Optional[str] = None) -> Report:
    """Lint the cup2d_tpu_torch package (or ``root``) and return the
    Report — the in-process entry the tests wrap."""
    rules = make_rules(only=only, skip=skip)
    modules = collect_package_modules(root or package_root(),
                                      set(RULE_NAMES))
    return run_rules(modules, rules)


def lint_sources(sources: dict,
                 only: Optional[Sequence[str]] = None) -> Report:
    """Lint ``{relpath: source}`` strings — the fixture-test entry
    (snippets compiled from strings, never repo files)."""
    rules = make_rules(only=only)
    modules: List[Module] = [
        Module.parse(src, rel, set(RULE_NAMES))
        for rel, src in sorted(sources.items())]
    return run_rules(modules, rules)
