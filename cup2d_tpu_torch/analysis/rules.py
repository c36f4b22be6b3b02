"""graftlint rules for the port — the five load-bearing invariants as
AST checkers, each the torch counterpart of one of the JAX package's
(``stands_for`` names it).

Each rule is a heuristic over the AST, tuned to the port's idiom: it
catches the real hazard patterns (each demonstrated live by a
seeded-violation fixture in tests/test_torch_analysis.py) while staying
quiet on the sanctioned sites policy.py tables. False-negative by
design where static analysis cannot see types (``bool(x)`` on a tensor
that arrived as a parameter, a tensor returned by an untyped helper) —
the runtime counters (``shapes_host.pulls`` as ``device_gets``, the
kernel launch counts) remain the backstop; this layer moves the KNOWN
hazard classes to review time.
"""

from __future__ import annotations

import ast
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from . import policy
from .core import Finding, Module, Rule, qualified_name, scope_matches


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _is_torch_qual(q: Optional[str]) -> bool:
    return q is not None and (q == "torch" or q.startswith("torch."))


def _is_np_qual(q: Optional[str]) -> bool:
    return q is not None and (q == "numpy" or q.startswith("numpy."))


# torch-rooted calls that return HOST values or are pure metadata — not
# tensor producers for the host-sync dataflow (torch.cuda.synchronize is
# flagged on its own; torch.cuda's other calls are queries and handles)
_TORCH_HOST_PREFIXES = (
    "torch.device", "torch.finfo", "torch.iinfo", "torch.is_tensor",
    "torch.is_floating_point", "torch.is_complex", "torch.numel",
    "torch.Size", "torch.get_default_dtype", "torch.set_default_dtype",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.dtype", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.set_grad_enabled", "torch.manual_seed",
    "torch.Generator", "torch.get_num_threads", "torch.set_num_threads",
    "torch.cuda", "torch.backends", "torch.distributed", "torch.profiler",
    "torch.autograd", "torch.version", "torch.utils", "torch.library",
    "torch.compiler", "torch.testing",
)

# tensor attributes and methods that read host metadata, not data
_TENSOR_META = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "layout",
    "requires_grad", "nbytes", "itemsize", "is_leaf", "names",
    "size", "dim", "numel", "element_size", "stride", "storage_offset",
    "data_ptr", "is_contiguous", "is_floating_point", "is_complex",
    "get_device", "untyped_storage", "nelement", "ndimension",
})

# methods only a tensor has (a numpy array has none of them): their
# result is a tensor whatever the receiver's provenance
# (``getattr(state, k).detach()``, ``a.view(torch.int32).long()``)
_TENSOR_ONLY_METHODS = frozenset({
    "detach", "contiguous", "clone", "cuda", "long", "float", "double",
    "half", "bfloat16", "abs", "amax", "amin", "isfinite", "isnan",
    "logical_and", "logical_or", "logical_not", "masked_fill",
    "new_zeros", "new_empty", "new_full", "new_tensor", "unsqueeze",
    "permute", "expand", "index_select", "view_as", "reshape_as",
})

# methods whose result is already on the host (the sync, if any, is the
# call itself — flagged there, not again downstream)
_HOST_RESULT_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


def _read_before(e: ast.AST) -> bool:
    """True when the receiver chain ``e`` passes a host-result method
    (``x.cpu()`` in ``x.cpu().double()``)."""
    while isinstance(e, (ast.Call, ast.Attribute, ast.Subscript)):
        if isinstance(e, ast.Call):
            if isinstance(e.func, ast.Attribute) \
                    and e.func.attr in _HOST_RESULT_METHODS:
                return True
            e = e.func
        else:
            e = e.value
    return False


def _is_torch_producing(q: Optional[str]) -> bool:
    """A call into torch that returns a tensor (device data)."""
    if not _is_torch_qual(q):
        return False
    return not any(q == p or q.startswith(p + ".")
                   for p in _TORCH_HOST_PREFIXES)


def _ordered_walk(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk in source order (iter_child_nodes preserves it)."""
    for child in ast.iter_child_nodes(node):
        yield child
        yield from _ordered_walk(child)


def _assign_targets(stmt: ast.AST) -> List[ast.expr]:
    if isinstance(stmt, ast.Assign):
        return stmt.targets
    if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) \
            and stmt.value is not None:
        return [stmt.target]
    return []


def _target_names(targets: Sequence[ast.expr]) -> List[str]:
    """Bare names bound by an assignment (tuple targets flattened;
    attribute/subscript targets skipped — per-function dataflow only
    tracks locals)."""
    out: List[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_target_names(list(t.elts)))
        elif isinstance(t, ast.Starred):
            out.extend(_target_names([t.value]))
    return out


def _const_ints(node: ast.AST) -> Tuple[int, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.append(e.value)
        return tuple(out)
    return ()


def _func_name(call: ast.Call) -> Optional[str]:
    """The terminal name of a call's callee (``x.y.f(...)`` -> ``f``)."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _defined_scopes(mod: Module) -> Set[str]:
    return {s for _, s in mod.scoped()}


# ---------------------------------------------------------------------------
# 1. env-latch
# ---------------------------------------------------------------------------

class EnvLatchRule(Rule):
    """CUP2D_* env vars are read ONCE at a sanctioned latch point
    (policy.ENV_LATCH_SITES), never mid-run: a read in a per-step or
    per-refresh helper lets a mid-run env mutation silently flip a
    solver or storage form between steps."""

    name = "env-latch"
    stands_for = "env-latch"
    description = ("CUP2D_* env gates latched once at sanctioned "
                   "construction points, never read mid-run")

    @staticmethod
    def _env_var_of(node: ast.AST) -> Optional[str]:
        """The env var name a node reads, or None. Catches
        os.environ[...] / os.environ.get|pop|setdefault(...) /
        os.getenv(...) (and the bare `environ`/`getenv` import-form
        spellings) — the JAX package's walk, unchanged."""
        def is_environ(n):
            return (isinstance(n, ast.Attribute) and n.attr == "environ") \
                or (isinstance(n, ast.Name) and n.id == "environ")

        def const(n):
            return n.value if (isinstance(n, ast.Constant)
                               and isinstance(n.value, str)) \
                else "<dynamic>"

        if isinstance(node, ast.Subscript) and is_environ(node.value):
            return const(node.slice)
        if isinstance(node, ast.Call):
            f = node.func
            envget = (isinstance(f, ast.Attribute)
                      and f.attr in ("get", "pop", "setdefault")
                      and is_environ(f.value))
            getenv = ((isinstance(f, ast.Attribute)
                       and f.attr == "getenv")
                      or (isinstance(f, ast.Name) and f.id == "getenv"))
            if envget or getenv:
                return const(node.args[0]) if node.args else "<dynamic>"
        return None

    @classmethod
    def env_reads(cls, mod: Module) -> List[Tuple[str, str, int]]:
        """(scope, var, lineno) for every constant CUP2D_* env read."""
        out = []
        if "environ" not in mod.source and "getenv" not in mod.source:
            return out          # no node can read the environment
        for node, scope in mod.scoped():
            var = cls._env_var_of(node)
            if var is not None and var.startswith("CUP2D_"):
                out.append((scope, var, node.lineno))
        return out

    def check(self, mod: Module) -> Iterable[Finding]:
        if mod.relpath in policy.ENV_LATCH_FILES:
            return
        allowed = {scope: vars_
                   for (f, scope), vars_ in policy.ENV_LATCH_SITES.items()
                   if f == mod.relpath}
        for scope, var, line in self.env_reads(mod):
            if var in allowed.get(scope, ()):
                continue
            yield Finding(
                self.name, mod.relpath, line, scope,
                f"reads {var} outside the sanctioned latch sites — "
                "latch once at construction (policy.ENV_LATCH_SITES) "
                "and store the value")

    def finalize(self, modules: List[Module]) -> Iterable[Finding]:
        # policy-reality: every sanctioned (file, scope, var) row must
        # still name a real latch — a refactor that moves a latch must
        # move its policy row too
        by_rel = {m.relpath: m for m in modules}
        for (rel, scope), vars_ in policy.ENV_LATCH_SITES.items():
            mod = by_rel.get(rel)
            if mod is None:
                continue    # partial lint target: row not in scope
            found = {v for s, v, _ in self.env_reads(mod) if s == scope}
            missing = set(vars_) - found
            if missing:
                yield Finding(
                    self.name, rel, 1, scope,
                    f"stale policy row: expected latched reads of "
                    f"{sorted(missing)} in scope {scope} — "
                    "policy.ENV_LATCH_SITES no longer matches reality")


# ---------------------------------------------------------------------------
# 2. host-sync
# ---------------------------------------------------------------------------

class HostSyncRule(Rule):
    """Device->host reads and card-wide waits only at the sanctioned
    sites (policy.HOST_SYNC_SITES / HOST_SYNC_FILES): a step's reads go
    through ``shapes_host.pull`` (counted as ``device_gets``), and every
    other torch read — ``.item()``, ``.tolist()``/``.cpu()``/``.numpy()``
    of a tensor, ``int()``/``float()``/``bool()``/``np.asarray()`` of a
    tensor expression, a tensor as an ``if``/``while`` condition,
    ``torch.cuda.synchronize`` and an event's or stream's
    ``.synchronize()`` — stalls the launch queue with no counter to see
    it. Taint is function-local: names assigned from torch calls, or
    from methods/arithmetic/subscripts of tainted names, hold tensors;
    host metadata (``.shape``, ``.numel()``, ``torch.device``, dtypes,
    ``torch.finfo``, ``torch.cuda.*`` queries) and numpy values do
    not."""

    name = "host-sync"
    stands_for = "host-sync"
    description = ("device->host reads and card waits only at sanctioned "
                   "sites — a step's reads go through shapes_host.pull")

    _COERCIONS = {"int", "float", "bool"}
    _NP_COERCIONS = {"numpy.asarray", "numpy.array"}
    _TAINTED_ONLY = {"tolist", "cpu", "numpy"}
    _PULLS = ("pull", "pull_diag")
    _CHECKED = (ast.Call, ast.If, ast.While, ast.IfExp)

    def __init__(self) -> None:
        self._reads: Dict[Tuple[str, int], list] = {}

    @staticmethod
    def expr_tainted(e: ast.AST, tainted: Set[str],
                     imports: Dict[str, str]) -> bool:
        """True when ``e`` evaluates to a tensor by the rule's taint."""
        rec = HostSyncRule.expr_tainted
        if isinstance(e, ast.Name):
            return e.id in tainted
        if isinstance(e, ast.Call):
            q = qualified_name(e.func, imports)
            if _is_torch_qual(q):
                return _is_torch_producing(q)
            f = e.func
            if isinstance(f, ast.Attribute) and not (
                    isinstance(f.value, ast.Name) and f.value.id in imports):
                if f.attr in _TENSOR_META or f.attr in _HOST_RESULT_METHODS:
                    return False
                if f.attr in _TENSOR_ONLY_METHODS:
                    # only a tensor has it — unless the receiver was
                    # already read (``x.cpu().double()``)
                    return not _read_before(f.value)
                return rec(f.value, tainted, imports)
            return False        # a helper, builtin or module function
        if isinstance(e, ast.Attribute):
            if e.attr in _TENSOR_META:
                return False
            return rec(e.value, tainted, imports)
        if isinstance(e, ast.Subscript):
            return rec(e.value, tainted, imports)
        if isinstance(e, ast.BinOp):
            return rec(e.left, tainted, imports) \
                or rec(e.right, tainted, imports)
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.Not):
                return False        # `not t` is a host bool (a read)
            return rec(e.operand, tainted, imports)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return any(rec(x, tainted, imports)
                       for x in [e.left, *e.comparators])
        if isinstance(e, ast.IfExp):
            return rec(e.body, tainted, imports) \
                or rec(e.orelse, tainted, imports)
        return False

    @classmethod
    def taint_at(cls, func: ast.AST, imports: Dict[str, str]
                 ) -> Dict[int, FrozenSet[str]]:
        """id(node) -> the names holding tensors where ``node`` is
        evaluated, for every node of ``func`` (closures inline). Flow-
        sensitive in source order: an assignment from a tainted
        expression taints its names from the next statement on, one from
        a host expression clears them (``if not torch.is_tensor(dt): dt
        = torch.tensor(float(dt))`` reads nothing). A loop body is walked
        twice so taint assigned late in it reaches its head."""
        at: Dict[int, FrozenSet[str]] = {}
        cur: Set[str] = set()
        snap = [frozenset()]        # frozenset(cur), rebuilt on change

        def visit(node: ast.AST) -> None:
            if isinstance(node, cls._CHECKED):
                at[id(node)] = snap[0]
            if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                for _ in range(2):
                    for child in ast.iter_child_nodes(node):
                        visit(child)
                return
            for child in ast.iter_child_nodes(node):
                visit(child)
            targets = _assign_targets(node)
            if targets:
                names = _target_names(targets)
                before = len(cur)
                if cls.expr_tainted(node.value, cur, imports):
                    cur.update(names)
                elif not isinstance(node, ast.AugAssign):
                    cur.difference_update(names)
                if len(cur) != before:
                    snap[0] = frozenset(cur)

        for child in ast.iter_child_nodes(func):
            visit(child)
        return at

    def _is_pull(self, node: ast.Call, mod: Module) -> Optional[str]:
        q = qualified_name(node.func, mod.imports) or ""
        for p in self._PULLS:
            if q.endswith("shapes_host." + p) or (
                    mod.relpath == "shapes_host.py" and q == p):
                return f"shapes_host.{p}"
        return None

    def _flags(self, node: ast.AST, mod: Module,
               tainted: FrozenSet[str]) -> Optional[str]:
        """Reason string when ``node`` reads the device or waits on it,
        else None."""
        imports = mod.imports
        taint = self.expr_tainted
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if taint(node.test, tainted, imports):
                kind = {ast.If: "an if", ast.While: "a while",
                        ast.IfExp: "a conditional expression's"
                        }[type(node)]
                return f"tensor used as {kind} condition (a bool() read)"
            return None
        if not isinstance(node, ast.Call):
            return None
        pull = self._is_pull(node, mod)
        if pull:
            return f"{pull} (a counted device read)"
        q = qualified_name(node.func, imports)
        if q == "torch.cuda.synchronize":
            return "torch.cuda.synchronize (a card-wide wait)"
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "synchronize" and not node.args:
                return ".synchronize() (an event/stream wait)"
            if f.attr == "item" and not node.args:
                return ".item() scalar read"
            if f.attr in self._TAINTED_ONLY \
                    and taint(f.value, tainted, imports):
                return f".{f.attr}() of a tensor (a device read)"
        coerce = None
        if isinstance(f, ast.Name) and f.id in self._COERCIONS:
            coerce = f.id
        elif q in self._NP_COERCIONS:
            coerce = q.replace("numpy.", "np.")
        if coerce is None or not node.args:
            return None
        if taint(node.args[0], tainted, imports):
            return f"{coerce}() of a tensor expression (a device read)"
        return None

    def reads(self, mod: Module) -> List[Tuple[ast.AST, str, str]]:
        """(node, scope, reason) for every read or wait in ``mod``,
        sanctioned or not (computed once per module and run)."""
        key = (mod.relpath, id(mod.tree))
        if key in self._reads:
            return self._reads[key]
        taint: Dict[int, FrozenSet[str]] = {}
        defs = {scope for _, scope in mod.functions()}
        for node, scope in mod.functions():
            parts = scope.split(".")
            if any(".".join(parts[:i]) in defs for i in range(1, len(parts))):
                continue
            # outermost defs only: a closure is walked inline, so it sees
            # the taint of its enclosing def where it is defined
            taint.update(self.taint_at(node, mod.imports))
        out = []
        for node, scope in mod.scoped():
            if not isinstance(node, self._CHECKED):
                continue
            reason = self._flags(node, mod, taint.get(id(node),
                                                      frozenset()))
            if reason:
                out.append((node, scope, reason))
        self._reads[key] = out
        return out

    def check(self, mod: Module) -> Iterable[Finding]:
        if mod.relpath in policy.HOST_SYNC_FILES:
            return
        sanctioned = policy.HOST_SYNC_SITES.get(mod.relpath, ())
        for node, scope, reason in self.reads(mod):
            if scope_matches(scope, sanctioned):
                continue
            yield Finding(
                self.name, mod.relpath, node.lineno, scope,
                f"{reason} outside the sanctioned sites — ride the "
                "step's batched shapes_host.pull "
                "(policy.HOST_SYNC_SITES) or move to a cold path")

    def finalize(self, modules: List[Module]) -> Iterable[Finding]:
        # policy-reality: a sanctioned scope must still exist and still
        # read; a sanctioned whole file must still read somewhere
        by_rel = {m.relpath: m for m in modules}
        for rel, scopes in policy.HOST_SYNC_SITES.items():
            mod = by_rel.get(rel)
            if mod is None:
                continue
            present = _defined_scopes(mod)
            reading = [s for _, s, _ in self.reads(mod)]
            for s in scopes:
                if s not in present:
                    why = f"sanctioned read scope {s!r} no longer exists"
                elif not any(scope_matches(r, (s,)) for r in reading):
                    why = f"sanctioned read scope {s!r} reads nothing"
                else:
                    continue
                yield Finding(
                    self.name, rel, 1, s,
                    f"stale policy row: {why} in {rel} — "
                    "policy.HOST_SYNC_SITES must move with it")
        for rel in sorted(policy.HOST_SYNC_FILES):
            mod = by_rel.get(rel)
            if mod is not None and not self.reads(mod):
                yield Finding(
                    self.name, rel, 1, "<module>",
                    f"stale policy row: sanctioned measurement file "
                    f"{rel!r} reads nothing — policy.HOST_SYNC_FILES "
                    "must move with it")


# ---------------------------------------------------------------------------
# 3. alias-safety
# ---------------------------------------------------------------------------

class AliasSafetyRule(Rule):
    """No tensor that shares memory with a numpy buffer or with a
    snapshot-ring entry is installed into a sim's state without a copy.
    The step may write into the tensors it was given (``.copy_`` and
    in-place updates), so an aliased install corrupts the numpy buffer
    or the snapshot a later restore needs — torch's counterpart of the
    JAX package's donated-numpy-buffer class. Aliases come from
    ``torch.from_numpy``, ``torch.as_tensor``/``torch.asarray`` of a
    numpy value, and a snapshot's ``.payload``; views and dict walks
    carry them; ``torch.tensor(...)``, ``.clone()``, arithmetic and
    ``.to(<device or dtype>)`` clear them. The sinks are
    policy.ALIAS_SINKS."""

    name = "alias-safety"
    stands_for = "donation-safety"
    description = ("numpy-backed and snapshot-ring tensors never "
                   "installed as a sim's state without a copy")

    # methods that may hand back (a view of) their receiver's memory
    _ALIAS_METHODS = frozenset({
        "view", "view_as", "reshape", "reshape_as", "squeeze",
        "unsqueeze", "flatten", "unflatten", "permute", "transpose", "t",
        "expand", "expand_as", "narrow", "as_strided", "detach",
        "contiguous", "float", "double", "half", "bfloat16", "type_as",
        "unbind", "split", "chunk", "movedim", "real", "imag",
        "items", "values", "get", "pop", "copy", "_asdict",
    })
    _TORCH_VIEWS = frozenset({
        "torch.reshape", "torch.squeeze", "torch.unsqueeze",
        "torch.flatten", "torch.permute", "torch.transpose",
        "torch.narrow", "torch.movedim", "torch.as_strided",
        "torch.unbind", "torch.split", "torch.chunk", "torch.view_as_real",
        "torch.view_as_complex", "torch.detach",
    })
    _NP_WRAP = frozenset({"torch.as_tensor", "torch.asarray"})

    @staticmethod
    def _np_names(func: ast.AST, imports: Dict[str, str]) -> Set[str]:
        """Names holding numpy values: assigned from numpy calls, or
        subscripts/attributes of such names (``npz["vel"]``)."""
        out: Set[str] = set()

        def np_expr(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in out
            if isinstance(e, (ast.Subscript, ast.Attribute)):
                return np_expr(e.value)
            if isinstance(e, ast.Call):
                return _is_np_qual(qualified_name(e.func, imports))
            return False

        for _ in range(2):
            for stmt in _ordered_walk(func):
                targets = _assign_targets(stmt)
                if targets and np_expr(stmt.value):
                    out.update(_target_names(targets))
            for node in _ordered_walk(func):
                if isinstance(node, ast.withitem) and node.optional_vars \
                        is not None and np_expr(node.context_expr):
                    out.update(_target_names([node.optional_vars]))
        return out

    @classmethod
    def _np_value(cls, e: ast.AST, np_names: Set[str],
                  imports: Dict[str, str]) -> bool:
        if isinstance(e, ast.Name):
            return e.id in np_names
        if isinstance(e, (ast.Subscript, ast.Attribute)):
            return cls._np_value(e.value, np_names, imports)
        if isinstance(e, ast.Call):
            return _is_np_qual(qualified_name(e.func, imports))
        return False

    def alias_of(self, e: ast.AST, aliased: Set[str], np_names: Set[str],
                 imports: Dict[str, str]) -> Optional[str]:
        """Why ``e`` may share memory with a numpy buffer or a snapshot
        entry, or None."""
        rec = self.alias_of
        if isinstance(e, ast.Name):
            return f"{e.id!r} aliases memory" if e.id in aliased else None
        if isinstance(e, ast.Attribute):
            if e.attr in policy.ALIAS_SNAPSHOT_ATTRS:
                return f"snapshot-ring entry (.{e.attr})"
            return rec(e.value, aliased, np_names, imports)
        if isinstance(e, ast.Subscript):
            return rec(e.value, aliased, np_names, imports)
        if isinstance(e, ast.Starred):
            return rec(e.value, aliased, np_names, imports)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            for x in e.elts:
                why = rec(x, aliased, np_names, imports)
                if why:
                    return why
            return None
        if isinstance(e, ast.Dict):
            for x in e.values:
                why = rec(x, aliased, np_names, imports)
                if why:
                    return why
            return None
        if isinstance(e, ast.IfExp):
            return rec(e.body, aliased, np_names, imports) \
                or rec(e.orelse, aliased, np_names, imports)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            inner = set(aliased)
            for gen in e.generators:
                names = _target_names([gen.target])
                if rec(gen.iter, inner, np_names, imports):
                    inner.update(names)
                else:
                    inner.difference_update(names)
            # a dict's keys install no memory: only its values can
            elts = [e.value] if isinstance(e, ast.DictComp) else [e.elt]
            for x in elts:
                why = rec(x, inner, np_names, imports)
                if why:
                    return why
            return None
        if isinstance(e, ast.Call):
            q = qualified_name(e.func, imports)
            if q == "torch.from_numpy":
                return "torch.from_numpy(...) shares the numpy buffer"
            if q in self._NP_WRAP:
                if e.args and self._np_value(e.args[0], np_names, imports):
                    return f"{q}(<numpy>) shares the numpy buffer"
                return rec(e.args[0], aliased, np_names, imports) \
                    if e.args else None
            if q in self._TORCH_VIEWS:
                return rec(e.args[0], aliased, np_names, imports) \
                    if e.args else None
            if _is_torch_qual(q):
                return None         # a new tensor (torch.tensor, ops)
            f = e.func
            if isinstance(f, ast.Attribute) and not (
                    isinstance(f.value, ast.Name)
                    and f.value.id in imports):
                if f.attr == "to":
                    copy = any(k.arg == "copy" for k in e.keywords)
                    moves = bool(e.args) or any(
                        k.arg in ("device", "dtype") for k in e.keywords)
                    if copy or moves:
                        return None
                    return rec(f.value, aliased, np_names, imports)
                if f.attr in self._ALIAS_METHODS:
                    return rec(f.value, aliased, np_names, imports)
                if f.attr == "_replace":    # a state with new fields
                    for a in [f.value] + [k.value for k in e.keywords]:
                        why = rec(a, aliased, np_names, imports)
                        if why:
                            return why
                return None         # clone(), arithmetic methods: new
            # a constructor or helper: aliased iff an argument is (the
            # FlowState(*buffers) shape)
            for a in list(e.args) + [k.value for k in e.keywords]:
                why = rec(a, aliased, np_names, imports)
                if why:
                    return why
            return None
        return None

    def _aliased_names(self, func: ast.AST, imports: Dict[str, str],
                       np_names: Set[str]) -> Set[str]:
        aliased: Set[str] = set()
        for _ in range(2):
            for stmt in _ordered_walk(func):
                targets = _assign_targets(stmt)
                if not targets:
                    # a for loop's names (a comprehension's are its own,
                    # handled where it is evaluated)
                    if isinstance(stmt, ast.For):
                        names = _target_names([stmt.target])
                        if self.alias_of(stmt.iter, aliased, np_names,
                                         imports):
                            aliased.update(names)
                        else:
                            aliased.difference_update(names)
                    continue
                names = _target_names(targets)
                if self.alias_of(stmt.value, aliased, np_names, imports):
                    aliased.update(names)
                else:
                    aliased.difference_update(names)
        return aliased

    @staticmethod
    def _installs(node: ast.AST, sinks: Dict[str, Set[str]]
                  ) -> List[Tuple[str, ast.AST]]:
        """(label, value) for each value ``node`` installs into a sink:
        a call's arguments, an ``x.<attr> = v`` store, an
        ``x.<attr>[k] = v`` store."""
        if isinstance(node, ast.Call) and _func_name(node) in sinks["call"]:
            label = f"{_func_name(node)}(...)"
            return [(label, a) for a in
                    list(node.args) + [k.value for k in node.keywords]]
        if not isinstance(node, ast.Assign):
            return []
        out = []
        for t in node.targets:
            if isinstance(t, ast.Attribute) and t.attr in sinks["attr"]:
                out.append((f".{t.attr} =", node.value))
            elif isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Attribute) \
                    and t.value.attr in sinks["item"]:
                out.append((f".{t.value.attr}[...] =", node.value))
        return out

    def check(self, mod: Module) -> Iterable[Finding]:
        sinks: Dict[str, Set[str]] = {"call": set(), "attr": set(),
                                      "item": set()}
        for _, scope, kind in policy.ALIAS_SINKS:
            sinks[kind].add(scope.split(".")[-1])
        funcs = {scope: func for func, scope in mod.functions()}
        state: Dict[str, Tuple[Set[str], Set[str]]] = {}
        for node, scope in mod.scoped():
            installs = self._installs(node, sinks)
            if not installs:
                continue
            # the innermost def holding the install, and the names every
            # enclosing def binds (a closure sees its parents' locals)
            parts = scope.split(".")
            defs = [".".join(parts[:i]) for i in range(1, len(parts) + 1)
                    if ".".join(parts[:i]) in funcs]
            if not defs:
                continue            # module or class level: no dataflow
            for d in defs:
                if d not in state:
                    np_names = self._np_names(funcs[d], mod.imports)
                    state[d] = (np_names, self._aliased_names(
                        funcs[d], mod.imports, np_names))
            np_names = set().union(*(state[d][0] for d in defs))
            aliased = set().union(*(state[d][1] for d in defs))
            for label, value in installs:
                why = self.alias_of(value, aliased, np_names, mod.imports)
                if why:
                    yield Finding(
                        self.name, mod.relpath, node.lineno, defs[-1],
                        f"{label} installs a tensor that may share "
                        f"memory: {why} — the step writes into its "
                        "state; copy with torch.tensor(...) or .clone() "
                        "first")
                    break           # one finding per install

    def finalize(self, modules: List[Module]) -> Iterable[Finding]:
        by_rel = {m.relpath: m for m in modules}
        for rel, scope, kind in policy.ALIAS_SINKS:
            mod = by_rel.get(rel)
            if mod is None:
                continue
            if kind == "call":
                ok = scope in _defined_scopes(mod)
            else:
                owner, _, attr = scope.rpartition(".")

                def stores(n: ast.AST) -> bool:
                    if kind == "item":
                        return isinstance(n, ast.Subscript) \
                            and isinstance(n.ctx, ast.Store) \
                            and isinstance(n.value, ast.Attribute) \
                            and n.value.attr == attr
                    return isinstance(n, ast.Attribute) \
                        and n.attr == attr and isinstance(n.ctx, ast.Store)

                ok = any(stores(n) and scope_matches(s, (owner,))
                         for n, s in mod.scoped())
            if not ok:
                yield Finding(
                    self.name, rel, 1, scope,
                    f"stale policy row: state sink {scope!r} ({kind}) no "
                    f"longer exists in {rel} — policy.ALIAS_SINKS must "
                    "move with it")


# ---------------------------------------------------------------------------
# 4. cache-key
# ---------------------------------------------------------------------------

class CacheKeyRule(Rule):
    """Arguments of a module-local ``functools.lru_cache``/``cache``
    function are hashable and stable from call to call — a key that
    varies per call makes a new entry (and, for the port's tables, a new
    host-to-device copy) every time and evicts the plans the launches
    need. Flags non-hashable literals (list/dict/set/comprehension),
    f-strings, ``.format()``/%-formatting, per-call-varying calls
    (time.time, id, random.*, uuid.*) and ``float()`` of a non-constant
    expression (a step's dt, a product of floats)."""

    name = "cache-key"
    stands_for = "retrace-hazard"
    description = ("lru_cache keys hashable and per-call-stable — no "
                   "f-strings, literals or floats that miss every call")

    _UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                   ast.DictComp, ast.SetComp, ast.GeneratorExp)
    _VARYING_CALLS = ("time.time", "time.monotonic", "time.perf_counter",
                      "id", "uuid.uuid4", "os.getpid", "random.random",
                      "random.randint")
    _CACHES = ("functools.lru_cache", "functools.cache")

    @classmethod
    def cached_functions(cls, mod: Module) -> Dict[str, int]:
        """name -> line of every def decorated with lru_cache/cache."""
        out: Dict[str, int] = {}
        for node, _ in mod.functions():
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if qualified_name(d, mod.imports) in cls._CACHES:
                    out[node.name] = node.lineno
        return out

    @staticmethod
    def _formatted_names(func: ast.AST) -> Set[str]:
        """Names assigned from f-strings / .format() / str %-formatting
        within this function."""
        out: Set[str] = set()
        for stmt in ast.walk(func):
            targets = _assign_targets(stmt)
            if not targets:
                continue
            v = stmt.value
            fmt = isinstance(v, ast.JoinedStr) or (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and v.func.attr == "format") or (
                isinstance(v, ast.BinOp)
                and isinstance(v.op, ast.Mod)
                and isinstance(v.left, (ast.Constant, ast.JoinedStr)))
            if fmt:
                out.update(_target_names(targets))
        return out

    def _hazard(self, val: ast.AST, formatted: Set[str],
                imports: Dict[str, str]) -> Optional[str]:
        if isinstance(val, self._UNHASHABLE):
            return "non-hashable literal (a TypeError every call)"
        if isinstance(val, ast.JoinedStr):
            return "f-string (a new entry per distinct value)"
        if isinstance(val, ast.BinOp) and isinstance(val.op, ast.Mod) \
                and isinstance(val.left, (ast.Constant, ast.JoinedStr)) \
                and isinstance(getattr(val.left, "value", ""), str):
            return "%-formatted string (a new entry per value)"
        if isinstance(val, ast.Call):
            q = qualified_name(val.func, imports)
            if isinstance(val.func, ast.Attribute) \
                    and val.func.attr == "format":
                return ".format() string (a new entry per value)"
            if q in self._VARYING_CALLS:
                return f"per-call-varying {q}() value"
            if q == "float" and val.args and not isinstance(
                    val.args[0], ast.Constant):
                return ("float() of a non-constant expression (a new "
                        "entry whenever the value moves)")
        if isinstance(val, ast.Name) and val.id in formatted:
            return (f"{val.id!r} holds a formatted string "
                    "(a new entry per distinct value)")
        return None

    def check(self, mod: Module) -> Iterable[Finding]:
        cached = self.cached_functions(mod)
        if not cached:
            return
        for func, scope in mod.functions():
            formatted = self._formatted_names(func)
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                name = _func_name(node)
                if name not in cached:
                    continue
                args = [(str(i), a) for i, a in enumerate(node.args)] + \
                    [(repr(k.arg), k.value) for k in node.keywords]
                for label, a in args:
                    why = self._hazard(a, formatted, mod.imports)
                    if why:
                        yield Finding(
                            self.name, mod.relpath, node.lineno, scope,
                            f"argument {label} of cached {name!r} "
                            f"(lru_cache at line {cached[name]}): {why}"
                            " — steady state must hit the cache")


# ---------------------------------------------------------------------------
# 5. leading-dim
# ---------------------------------------------------------------------------

class LeadingDimRule(Rule):
    """In the contract scopes (policy.LEADING_DIM_SCOPES) field ops
    address the trailing y/x axes ONLY via ``...`` slicing and negative
    axis numbers, so one kernel serves uniform [ny,nx], fleet [B,ny,nx]
    and forest-lab [N,2,H,W] operands. Flags positive ``axis=``/``dim=``
    constants, ``.shape[k]`` with k >= 0, and hard positional ``[i, j]``
    tuple indexing with neither ``...`` nor ``None`` (newaxis shaping
    and ``...``-anchored slices stay legal)."""

    name = "leading-dim"
    stands_for = "leading-dim"
    description = ("contract scopes index fields with '...' and "
                   "negative axes only — one kernel, any leading dims")

    @staticmethod
    def _annotation_nodes(tree: ast.AST) -> Set[int]:
        """ids of every node inside a type annotation —
        ``Callable[[Tensor], Tensor]`` is a tuple-subscript to the AST
        but not an array indexing."""
        out: Set[int] = set()

        def mark(node: Optional[ast.AST]) -> None:
            if node is None:
                return
            for sub in ast.walk(node):
                out.add(id(sub))

        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mark(node.returns)
                a = node.args
                for arg in (a.posonlyargs + a.args + a.kwonlyargs
                            + ([a.vararg] if a.vararg else [])
                            + ([a.kwarg] if a.kwarg else [])):
                    mark(arg.annotation)
            elif isinstance(node, ast.AnnAssign):
                mark(node.annotation)
        return out

    @staticmethod
    def _pos_axis(node: ast.Call) -> Optional[int]:
        for kw in node.keywords:
            if kw.arg not in ("axis", "axes", "dimension", "dim", "dims"):
                continue
            vals = _const_ints(kw.value)
            for v in vals:
                if v >= 0:
                    return v
        return None

    def check(self, mod: Module) -> Iterable[Finding]:
        scopes = policy.LEADING_DIM_SCOPES.get(mod.relpath)
        if not scopes:
            return
        whole_file = "*" in scopes
        in_annotation = self._annotation_nodes(mod.tree)
        for node, scope in mod.scoped():
            if not (whole_file or scope_matches(scope, scopes)):
                continue
            if id(node) in in_annotation:
                continue
            if isinstance(node, ast.Call):
                v = self._pos_axis(node)
                if v is not None:
                    yield Finding(
                        self.name, mod.relpath, node.lineno, scope,
                        f"positional axis={v} counts from the front — "
                        "the leading-dim contract requires negative "
                        "axes (-2/-1 for y/x)")
            elif isinstance(node, ast.Subscript):
                # .shape[k], k >= 0
                if isinstance(node.value, ast.Attribute) \
                        and node.value.attr == "shape":
                    idx = node.slice
                    if isinstance(idx, ast.Constant) \
                            and isinstance(idx.value, int) \
                            and idx.value >= 0:
                        yield Finding(
                            self.name, mod.relpath, node.lineno, scope,
                            f".shape[{idx.value}] counts from the "
                            "front — use negative indices "
                            "(shape[-2]/shape[-1]) so leading dims "
                            "pass through")
                    continue
                # hard [i, j] indexing without '...' anchor
                if isinstance(node.slice, ast.Tuple) \
                        and len(node.slice.elts) >= 2:
                    elts = node.slice.elts
                    has_ellipsis = any(
                        isinstance(e, ast.Constant) and e.value is ...
                        for e in elts)
                    has_newaxis = any(
                        isinstance(e, ast.Constant) and e.value is None
                        for e in elts)
                    if not has_ellipsis and not has_newaxis:
                        yield Finding(
                            self.name, mod.relpath, node.lineno, scope,
                            "hard positional [i, j] indexing — anchor "
                            "with '...' so the op stays leading-dim "
                            "agnostic")

    def finalize(self, modules: List[Module]) -> Iterable[Finding]:
        by_rel = {m.relpath: m for m in modules}
        for rel, scopes in policy.LEADING_DIM_SCOPES.items():
            mod = by_rel.get(rel)
            if mod is None:
                continue
            present = _defined_scopes(mod)
            for s in scopes:
                if s != "*" and s not in present:
                    yield Finding(
                        self.name, rel, 1, s,
                        f"stale policy row: contract scope {s!r} no "
                        f"longer exists in {rel} — "
                        "policy.LEADING_DIM_SCOPES must move with it")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ALL_RULES = (EnvLatchRule, HostSyncRule, AliasSafetyRule, CacheKeyRule,
             LeadingDimRule)

RULE_NAMES = tuple(r.name for r in ALL_RULES)


def make_rules(only: Optional[Sequence[str]] = None,
               skip: Optional[Sequence[str]] = None) -> List[Rule]:
    """Instantiate the selected rules; unknown names are a
    LintConfigError (CLI rc 2)."""
    from .core import LintConfigError

    known = set(RULE_NAMES)
    for group in (only or ()), (skip or ()):
        for n in group:
            if n not in known:
                raise LintConfigError(
                    f"unknown rule {n!r} (known: {sorted(known)})")
    sel = []
    for cls in ALL_RULES:
        if only and cls.name not in only:
            continue
        if skip and cls.name in skip:
            continue
        sel.append(cls())
    if not sel:
        raise LintConfigError("rule selection is empty")
    return sel
