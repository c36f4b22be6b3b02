"""graftlint CLI — ``python -m cup2d_tpu_torch.analysis``.

rc semantics (pinned by tests/test_torch_analysis.py):

* 0 — clean: no unsuppressed findings
* 1 — findings: the tree violates an invariant
* 2 — config error: malformed suppression, unknown rule, unparseable
  target (distinct so CI can tell 'dirty tree' from 'broken setup')

``--json`` emits ONE line (machine-readable, greppable from CI logs);
the default human format is one finding per line plus a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .core import (LintConfigError, Module, collect_package_modules,
                   package_root, run_rules)
from .rules import ALL_RULES, RULE_NAMES, make_rules


def _split_rules(value: str) -> List[str]:
    return [v.strip() for v in value.split(",") if v.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cup2d_tpu_torch.analysis",
        description=("graftlint — AST invariant checks for "
                     "cup2d_tpu_torch (torch-import-free; rc 0 clean / "
                     "1 findings / 2 config error)"))
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: the "
                        "cup2d_tpu_torch package)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit one JSON line instead of human output")
    p.add_argument("--only", type=_split_rules, default=None,
                   metavar="RULES",
                   help="comma-separated rule names to run exclusively")
    p.add_argument("--skip", type=_split_rules, default=None,
                   metavar="RULES",
                   help="comma-separated rule names to skip")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit 0")
    return p


def _collect(paths: List[str], known) -> List[Module]:
    if not paths:
        return collect_package_modules(package_root(), known)
    modules: List[Module] = []
    for path in paths:
        if os.path.isdir(path):
            modules.extend(collect_package_modules(path, known))
        elif os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                src = f.read()
            rel = os.path.basename(path)
            modules.append(Module.parse(src, rel, known))
        else:
            raise LintConfigError(f"no such lint target: {path}")
    return modules


def run(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.name:14s} {cls.description} (the JAX "
                  f"package's {cls.stands_for})")
        return 0
    try:
        rules = make_rules(only=args.only, skip=args.skip)
        known = set(RULE_NAMES)
        modules = _collect(args.paths, known)
        report = run_rules(modules, rules)
    except LintConfigError as e:
        if args.as_json:
            print(json.dumps({"graftlint": 1, "error": str(e)}))
        else:
            print(f"graftlint: config error: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(report.as_json(), sort_keys=True))
    else:
        for f in report.findings:
            print(f)
        counts = report.counts()
        summary = ", ".join(f"{r}={counts[r]}" for r in report.rules_run)
        nsup = sum(report.suppressed.values())
        print(f"graftlint: {report.files_scanned} files, "
              f"{len(report.findings)} findings ({summary}), "
              f"{nsup} suppressed")
    return 0 if report.clean else 1


def main() -> None:
    sys.exit(run())
