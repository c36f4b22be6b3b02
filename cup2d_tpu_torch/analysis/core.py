"""graftlint core — the shared AST-walk framework under the invariant
checkers (``cup2d_tpu_torch.analysis.rules``).

The port's correctness/performance contracts are DISCIPLINES, not
types: env gates latched once, one batched device read per step, no
numpy-backed tensors installed as a sim's state, cache keys that do not
vary per call, leading-dim-agnostic stencils. Each rule here encodes
one of those as a static check that fails at review time instead of a
runtime counter that fires after the violation ships.

Deliberately torch-import-free and package-import-free: linting must
run anywhere Python runs (pre-commit, CI collect phase, a box with no
accelerator stack) in well under 5 s. Nothing in this subpackage may
import torch, jax, numpy, or the simulation modules it inspects — the
AST is the only interface.

Framework pieces:

* :class:`Module` — one parsed source file: AST, per-line suppression
  table, and the import-alias map used for qualified-name resolution
  (``F.pad`` -> ``torch.nn.functional.pad`` under
  ``import torch.nn.functional as F``).
* :func:`iter_scoped` — AST iteration with ``Class.method.inner``
  scope strings (the convention of the env-latch sanctioned-site
  table).
* :class:`Rule` — checker base: ``check(module)`` yields
  :class:`Finding`; an optional ``finalize(modules)`` pass runs once
  after every module for cross-file policy-reality checks.
* suppressions — ``# lint: allow[rule] -- reason`` on the flagged line
  (or the line directly above). The reason is REQUIRED: a bare allow is
  a :class:`LintConfigError` (rc 2 from the CLI), because an
  unexplained suppression is indistinguishable from a stale one.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple


class LintConfigError(Exception):
    """Malformed lint configuration: a suppression without a reason, an
    unknown rule name (in a suppression or ``--only/--skip``), or an
    unparseable target. Maps to CLI rc 2 — distinct from findings
    (rc 1) so CI can tell 'the tree is dirty' from 'the lint setup is
    broken'."""


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    file: str      # path relative to the lint root, posix separators
    line: int
    scope: str     # enclosing Class.method chain, "<module>" at top level
    message: str

    def __str__(self) -> str:
        return (f"{self.file}:{self.line}: [{self.rule}] "
                f"{self.scope}: {self.message}")

    def as_json(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "scope": self.scope, "message": self.message}


# -- suppression comments ---------------------------------------------------

# allow-comment shape:  lint: allow[rule1,rule2] -- reason
_ALLOW_RE = re.compile(
    r"lint:\s*allow\s*\[([^\]]*)\]\s*(?:--\s*(.*))?$")
_LINT_MARK_RE = re.compile(r"#\s*lint\s*:")


def _parse_suppressions(source: str, relpath: str,
                        known_rules: Optional[Set[str]] = None,
                        ) -> Dict[int, Set[str]]:
    """Per-line suppression table from ``# lint: allow[...] -- reason``
    comments, via the tokenizer (a '# lint:' inside a string literal is
    NOT a suppression). Raises LintConfigError on a missing/empty
    reason or an unknown rule name."""
    table: Dict[int, Set[str]] = {}
    if not _LINT_MARK_RE.search(source):
        return table        # no lint mark anywhere: nothing to tokenize
    toks = tokenize.generate_tokens(io.StringIO(source).readline)
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        if not _LINT_MARK_RE.search(tok.string):
            continue
        m = _ALLOW_RE.search(tok.string)
        line = tok.start[0]
        if not m:
            raise LintConfigError(
                f"{relpath}:{line}: malformed lint comment {tok.string!r}"
                " — expected '# lint: allow[rule] -- reason'")
        rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
        reason = (m.group(2) or "").strip()
        if not rules:
            raise LintConfigError(
                f"{relpath}:{line}: suppression names no rule")
        if not reason:
            raise LintConfigError(
                f"{relpath}:{line}: suppression without a reason — every "
                "allow must say WHY: '# lint: allow[rule] -- reason'")
        if known_rules is not None:
            for r in rules:
                if r not in known_rules:
                    raise LintConfigError(
                        f"{relpath}:{line}: suppression names unknown "
                        f"rule {r!r} (known: {sorted(known_rules)})")
        table.setdefault(line, set()).update(rules)
    return table


# -- import-alias map / qualified names -------------------------------------

def _collect_imports(tree: ast.AST) -> Dict[str, str]:
    """alias -> dotted qualified name, over the WHOLE file (function-
    local imports count too — several modules import lazily inside
    cold paths)."""
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    # `import torch.cuda` binds `torch`; the usable dotted
                    # prefix is the top-level name
                    table[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            prefix = "." * node.level + mod
            for a in node.names:
                table[a.asname or a.name] = (
                    f"{prefix}.{a.name}" if prefix else a.name)
    return table


def qualified_name(node: ast.AST,
                   imports: Dict[str, str]) -> Optional[str]:
    """Resolve an Attribute/Name chain to a dotted name through the
    module's import aliases: ``F.pad`` -> ``torch.nn.functional.pad``,
    ``torch.zeros`` -> ``torch.zeros``. None for anything rooted
    in a call/subscript (dynamic receivers are out of scope for a
    static check)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(imports.get(node.id, node.id))
    return ".".join(reversed(parts))


# -- scope-aware iteration --------------------------------------------------

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def iter_scoped(tree: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
    """Yield ``(node, scope)`` for every node, where scope is the
    dotted enclosing def/class chain (a def/class node reports under
    its OWN name — the env-latch table convention) and
    ``"<module>"`` at top level."""

    def rec(node: ast.AST, scope: List[str]):
        for child in ast.iter_child_nodes(node):
            cs = scope + [child.name] if isinstance(child, _SCOPE_NODES) \
                else scope
            yield child, ".".join(cs) or "<module>"
            yield from rec(child, cs)

    yield from rec(tree, [])


def scope_matches(scope: str, sanctioned: Iterable[str]) -> bool:
    """True when ``scope`` is one of the sanctioned scopes or nested
    inside one (closures/comprehension helpers defined inside a
    sanctioned method inherit its sanction)."""
    for s in sanctioned:
        if scope == s or scope.startswith(s + "."):
            return True
    return False


# -- parsed module ----------------------------------------------------------

@dataclass
class Module:
    """One parsed source file plus everything rules need from it."""

    relpath: str                       # posix, relative to lint root
    source: str
    tree: ast.Module
    imports: Dict[str, str]
    suppressions: Dict[int, Set[str]]
    _scoped: Optional[List[Tuple[ast.AST, str]]] = field(
        default=None, repr=False, compare=False)
    _functions: Optional[List[Tuple[ast.AST, str]]] = field(
        default=None, repr=False, compare=False)

    def scoped(self) -> List[Tuple[ast.AST, str]]:
        """``list(iter_scoped(self.tree))``, walked once: every rule
        iterates the same parsed module."""
        if self._scoped is None:
            self._scoped = list(iter_scoped(self.tree))
        return self._scoped

    def functions(self) -> List[Tuple[ast.AST, str]]:
        """Every function/method def with its scope string (including
        its own name) — the unit of the function-local dataflow rules —
        from the cached walk."""
        if self._functions is None:
            self._functions = [
                (n, s) for n, s in self.scoped()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return self._functions

    @classmethod
    def parse(cls, source: str, relpath: str,
              known_rules: Optional[Set[str]] = None) -> "Module":
        try:
            tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            raise LintConfigError(
                f"{relpath}: cannot parse: {e}") from e
        return cls(
            relpath=relpath,
            source=source,
            tree=tree,
            imports=_collect_imports(tree),
            suppressions=_parse_suppressions(source, relpath, known_rules),
        )

    def suppressed(self, rule: str, line: int) -> bool:
        """A finding is suppressed by an allow comment on its own line
        or on the line directly above (multi-line calls anchor at the
        expression's first line, where the comment naturally sits)."""
        for ln in (line, line - 1):
            if rule in self.suppressions.get(ln, set()):
                return True
        return False


# -- rule base + engine -----------------------------------------------------

class Rule:
    """One invariant checker. Subclasses set ``name``/``description``
    and implement ``check``; ``finalize`` (optional) runs once after
    all modules for cross-file policy-reality checks (e.g. a
    sanctioned-site table row whose latch no longer exists)."""

    name: str = ""
    description: str = ""

    def check(self, module: Module) -> Iterable[Finding]:
        raise NotImplementedError

    def finalize(self, modules: List[Module]) -> Iterable[Finding]:
        return ()


@dataclass
class Report:
    """One lint run: what was scanned, what fired, what was allowed."""

    findings: List[Finding] = field(default_factory=list)
    suppressed: Dict[str, int] = field(default_factory=dict)
    files_scanned: int = 0
    rules_run: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    def counts(self) -> Dict[str, int]:
        out = {r: 0 for r in self.rules_run}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def as_json(self) -> dict:
        return {
            "graftlint": 1,
            "files_scanned": self.files_scanned,
            "rules": self.rules_run,
            "counts": self.counts(),
            "suppressed": dict(self.suppressed),
            "clean": self.clean,
            "findings": [f.as_json() for f in self.findings],
        }


def run_rules(modules: List[Module], rules: List[Rule]) -> Report:
    """Run every rule over every module, apply suppressions, run the
    finalize passes. Pure function of the sources — no filesystem."""
    rep = Report(files_scanned=len(modules),
                 rules_run=[r.name for r in rules])
    by_relpath = {m.relpath: m for m in modules}
    for mod in modules:
        for rule in rules:
            for f in rule.check(mod):
                if mod.suppressed(rule.name, f.line):
                    rep.suppressed[rule.name] = (
                        rep.suppressed.get(rule.name, 0) + 1)
                else:
                    rep.findings.append(f)
    for rule in rules:
        for f in rule.finalize(modules):
            mod = by_relpath.get(f.file)
            if mod is not None and mod.suppressed(rule.name, f.line):
                rep.suppressed[rule.name] = (
                    rep.suppressed.get(rule.name, 0) + 1)
            else:
                rep.findings.append(f)
    rep.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return rep


def collect_package_modules(root: str,
                            known_rules: Optional[Set[str]] = None,
                            ) -> List[Module]:
    """Parse every ``.py`` under ``root`` (skipping ``__pycache__``),
    relpaths posix-normalized — the same walk the env-latch test has
    always done."""
    modules: List[Module] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            with open(full, encoding="utf-8") as f:
                src = f.read()
            modules.append(Module.parse(src, rel, known_rules))
    return modules


def package_root() -> str:
    """The cup2d_tpu_torch package directory (the default lint
    target)."""
    return os.path.normpath(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
