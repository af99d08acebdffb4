"""AST linter engine: captured-scope discovery, taint tracking, suppression.

Counterpart of the JAX package's ``analysis/linter.py``. The rules
(``analysis/rules/``) are small because this module answers the two
questions every capture-hygiene check needs:

1. **Which functions are captured?** The port's counterpart of a JAX trace
   is a CUDA graph capture: every captured body is the ``fn`` of a
   ``PhaseGraph`` (``train/capture.py``). A function is captured when it is
   the ``fn`` (the second positional argument, or ``fn=``) of a
   ``PhaseGraph(...)`` call, or a bound method or closure that a
   ``phase_fns()`` returns in its list, or a function nested in either.
   Host code in such a function runs on the eager warm-up call and during
   the capture, and never again on replay; on the CPU (``capture=False``)
   it runs on every call, so no CPU test can see the difference. Functions
   reached from a captured scope across modules count as captured too:
   the call-graph engine (``analysis/callgraph.py``) extends the seeds
   over the package when a file on disk is linted.
2. **Which names hold tensors?** Parameters of captured scopes (except
   config-named ones and literal-default flags), the tensors a closure
   closes over (names its enclosing function binds from a ``torch.*``
   call), the tensor attributes of ``self`` (attributes a method of the
   class binds from a ``torch.*`` call), plus anything assigned from an
   expression that mentions a tainted name, EXCEPT static extractors
   (``x.shape``, ``x.ndim``, ``x.dtype``, ``x.device``, ``x.numel()``,
   ``len(x)``, ``isinstance(...)``, ``x is None``), which are host values
   and must not poison downstream checks. A parameter annotated with a
   type that names no tensor (``model: nn.Module``) is a host value.

Suppression: ``# graftlint: disable=<rule>[,<rule>...]`` as a trailing
comment on the flagged line or as a comment-only line directly above it;
``# graftlint: disable-file=<rule>`` anywhere disables a rule for the
whole file.

Pure AST: imports nothing but the standard library.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import (
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from marl_distributedformation_tpu_torch.analysis.config import (
    GraftlintConfig,
)

# Attribute / builtin accesses that yield host values even when applied
# to a tensor.
STATIC_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "size", "aval", "weak_type", "device",
     "numel", "dim", "is_floating_point", "is_cuda", "requires_grad"}
)
# Parameter names that conventionally carry config objects, not tensors.
STATIC_PARAM_NAMES = frozenset(
    {"self", "cls", "params", "config", "cfg", "ppo", "env_params",
     "hparams", "mesh", "train_config"}
)
# A parameter annotated with a type that names none of these is a host
# value.
TENSOR_ANNOTATIONS = ("Tensor", "Any")
STATIC_CALLS = frozenset(
    {"len", "isinstance", "issubclass", "getattr", "hasattr", "type", "id",
     "callable", "repr", "str"}
)

# The capture entry point and the list of phases a trainer captures.
PHASE_GRAPH = "PhaseGraph"
PHASE_FNS = "phase_fns"
PARTIAL_NAMES = frozenset({"functools.partial", "partial"})

# ``torch.*`` calls that return no tensor (so a name bound from one is not
# a tensor a closure captures).
_NON_TENSOR_TORCH = frozenset(
    {"device", "Generator", "no_grad", "enable_grad", "inference_mode",
     "set_grad_enabled", "is_grad_enabled", "get_default_dtype",
     "is_tensor", "manual_seed", "finfo", "iinfo", "Size", "dtype"}
)
_NON_TENSOR_TORCH_MODULES = ("torch.cuda.", "torch.backends.", "torch.nn.",
                             "torch.distributed.", "torch.utils.",
                             "torch.autograd.", "torch.library.")
# Tensor methods whose result is a tensor again.
_TENSOR_METHODS = frozenset(
    {"to", "clone", "detach", "contiguous", "float", "half", "bfloat16",
     "view", "reshape", "expand", "new_zeros", "new_ones", "new_empty",
     "new_full", "zero_", "fill_", "copy_", "unsqueeze", "squeeze"}
)

_DISABLE_RE = re.compile(r"#\s*graftlint:\s*disable\s*=\s*([\w\-,\s]+)")
_DISABLE_FILE_RE = re.compile(
    r"#\s*graftlint:\s*disable-file\s*=\s*([\w\-,\s]+)")


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_phase_graph_call(node: ast.AST) -> bool:
    """A ``PhaseGraph(...)`` call (any import spelling)."""
    if not isinstance(node, ast.Call):
        return False
    fname = dotted_name(node.func) or ""
    return fname.rsplit(".", 1)[-1] == PHASE_GRAPH


def phase_graph_arg(call: ast.Call, position: int,
                    keyword: str) -> Optional[ast.expr]:
    """A ``PhaseGraph`` argument by position or keyword."""
    if position < len(call.args):
        return call.args[position]
    for kw in call.keywords:
        if kw.arg == keyword:
            return kw.value
    return None


def tensor_expr(node: Optional[ast.AST]) -> bool:
    """Does ``node`` evaluate to a tensor made on the spot: a ``torch.*``
    call that makes one, or a tensor method (``.to``, ``.clone``, ...) on
    such an expression?"""
    if not isinstance(node, ast.Call):
        return False
    fname = dotted_name(node.func) or ""
    if fname.startswith("torch.") and not fname.startswith(
            _NON_TENSOR_TORCH_MODULES):
        return fname.rsplit(".", 1)[-1] not in _NON_TENSOR_TORCH
    if isinstance(node.func, ast.Attribute) and (
            node.func.attr in _TENSOR_METHODS):
        return tensor_expr(node.func.value)
    return False


def _split_rule_list(raw: str) -> Set[str]:
    """Leading REGISTERED rule names from a suppression payload. The
    payload ends at the first token that is not a known rule, so the
    reason that follows can mention other rules without suppressing
    them."""
    from marl_distributedformation_tpu_torch.analysis.rules import (
        rule_names,
    )

    known = set(rule_names())
    names: Set[str] = set()
    for token in re.split(r"[\s,]+", raw.strip()):
        if token in known:
            names.add(token)
        else:
            break
    return names


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str  # "error" | "warn"

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity.upper()} [{self.rule}] {self.message}"
        )


class Rule:
    """Base class for graftlint rules. Subclasses set ``name``,
    ``default_severity``, ``description`` and implement :meth:`check`."""

    name: str = "abstract"
    default_severity: str = "error"
    description: str = ""

    def check(self, ctx: "ModuleContext") -> Iterator[Tuple[int, int, str]]:
        raise NotImplementedError


FunctionLike = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def function_key(node: ast.AST) -> Tuple[int, int, str]:
    """A function's identity across two parses of one file."""
    return (node.lineno, node.col_offset, type(node).__name__)


class ModuleContext:
    """One parsed module plus the captured-scope / taint analyses rules
    share. Built once per file; rules only read from it.

    ``phase_methods`` lists ``(class, method)`` for each ``self.method``
    a ``phase_fns()`` returns, and ``phase_attr_methods`` the method names
    of ``self.<attr>.<method>`` entries whose owner is not known here; the
    call-graph engine seeds their overrides and namesakes across the
    package."""

    def __init__(self, tree: ast.Module, source: str, path: str) -> None:
        self.tree = tree
        self.path = path
        self.lines = source.splitlines()
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self._defs_by_name: Dict[str, List[ast.AST]] = {}
        self._classes: Dict[str, ast.ClassDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs_by_name.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.ClassDef):
                self._classes.setdefault(node.name, node)
        self.phase_methods: List[Tuple[str, str]] = []
        self.phase_attr_methods: Set[str] = set()
        # scope -> how it came to be captured (for messages)
        self.captured_via: Dict[ast.AST, str] = {}
        self.traced_scopes: Set[ast.AST] = self._with_closures(
            self._find_captured_scopes())
        # The scopes this module captures itself, before the call graph's
        # cross-module extension.
        self.local_scopes: Set[ast.AST] = set(self.traced_scopes)
        self._set_roots()
        self._taint_cache: Dict[ast.AST, Set[str]] = {}
        self._tensor_attrs: Dict[Optional[str], Set[str]] = {}
        self.file_disabled: Set[str] = set()
        for line in self.lines:
            m = _DISABLE_FILE_RE.search(line)
            if m:
                self.file_disabled |= _split_rule_list(m.group(1))

    # -- captured-scope discovery ----------------------------------------

    def _set_roots(self) -> None:
        self.traced_roots: List[ast.AST] = sorted(
            (scope for scope in self.traced_scopes
             if not self._has_traced_ancestor(scope)),
            key=lambda n: (n.lineno, n.col_offset),
        )

    def _with_closures(self, scopes: Set[ast.AST]) -> Set[ast.AST]:
        """``scopes`` and every function nested in one (a closure runs
        in the body that defines it)."""
        out = set(scopes)
        for node in ast.walk(self.tree):
            if isinstance(node, FunctionLike) and any(
                anc in scopes for anc in self._ancestors(node)
            ):
                out.add(node)
        return out

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for anc in self._ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def _methods_named(self, cls: Optional[ast.ClassDef],
                       name: str) -> List[ast.AST]:
        """Method ``name`` of ``cls`` and of its subclasses in this module
        (an override is what a subclass's phase list holds)."""
        if cls is None:
            return []
        out = []
        family = {cls.name}
        grew = True
        while grew:
            grew = False
            for other in self._classes.values():
                if other.name in family:
                    continue
                bases = {(dotted_name(b) or "").rsplit(".", 1)[-1]
                         for b in other.bases}
                if bases & family:
                    family.add(other.name)
                    grew = True
        for cname in sorted(family):
            for stmt in self._classes[cname].body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                              ) and stmt.name == name:
                    out.append(stmt)
        return out

    @staticmethod
    def _scope_defs(scope: ast.AST) -> Iterator[ast.AST]:
        """The defs bound in ``scope``'s own body (not in a nested
        function's or class's)."""
        todo = list(ast.iter_child_nodes(scope))
        while todo:
            node = todo.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node
            elif not isinstance(node, (ast.ClassDef, ast.Lambda)):
                todo.extend(ast.iter_child_nodes(node))

    def _lexical_defs(self, name: str, at: ast.AST) -> List[ast.AST]:
        """The defs a bare ``name`` at ``at`` refers to: the innermost
        enclosing function that binds it, else the module's (a method is
        never a bare name)."""
        scopes = [a for a in self._ancestors(at)
                  if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in (*scopes, self.tree):
            defs = [d for d in self._scope_defs(scope) if d.name == name]
            if defs:
                return defs
        return []

    def _loop_bindings(self, name: ast.Name) -> List[ast.AST]:
        """The values a ``for``/comprehension target binds to ``name`` when
        it iterates over a literal sequence of tuples
        (``for n, fn in (("a", f), ("b", g))``)."""
        out: List[ast.AST] = []
        for anc in self._ancestors(name):
            gens: List[Tuple[ast.AST, ast.AST]] = []
            if isinstance(anc, (ast.For, ast.AsyncFor)):
                gens = [(anc.target, anc.iter)]
            elif isinstance(anc, (ast.ListComp, ast.SetComp,
                                  ast.GeneratorExp, ast.DictComp)):
                gens = [(g.target, g.iter) for g in anc.generators]
            for target, it in gens:
                if not isinstance(it, (ast.Tuple, ast.List)):
                    continue
                if isinstance(target, ast.Name) and target.id == name.id:
                    out.extend(it.elts)
                elif isinstance(target, ast.Tuple):
                    for pos, elt in enumerate(target.elts):
                        if isinstance(elt, ast.Name) and elt.id == name.id:
                            out.extend(
                                row.elts[pos] for row in it.elts
                                if isinstance(row, (ast.Tuple, ast.List))
                                and pos < len(row.elts))
        return out

    def _resolve_callable(self, node: ast.AST,
                          at: Optional[ast.AST] = None) -> List[ast.AST]:
        """The functions of this module a callable expression names:
        a lambda, a def by name, ``self.method`` (and its overrides in
        subclasses here), a loop variable over a literal list of
        callables, or ``functools.partial(f, ...)``. ``self.<attr>.m``
        is noted for the call-graph engine."""
        at = node if at is None else at
        if isinstance(node, ast.Lambda):
            return [node]
        if isinstance(node, ast.Name):
            defs = self._lexical_defs(node.id, at)
            if defs:
                return defs
            return [f for value in self._loop_bindings(node)
                    for f in self._resolve_callable(value, at)]
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                cls = self.enclosing_class(at)
                if cls is not None:
                    self.phase_methods.append((cls.name, node.attr))
                return self._methods_named(cls, node.attr)
            if (isinstance(node.value, ast.Attribute)
                    and dotted_name(node.value.value) == "self"):
                self.phase_attr_methods.add(node.attr)
            return []
        if isinstance(node, ast.Call):
            if dotted_name(node.func) in PARTIAL_NAMES and node.args:
                return self._resolve_callable(node.args[0], at)
        return []

    def _find_captured_scopes(self) -> Set[ast.AST]:
        captured: Set[ast.AST] = set()

        def add(scopes: Iterable[ast.AST], via: str) -> None:
            for scope in scopes:
                captured.add(scope)
                self.captured_via.setdefault(scope, via)

        for node in ast.walk(self.tree):
            if is_phase_graph_call(node):
                fn = phase_graph_arg(node, 1, "fn")
                if fn is not None:
                    add(self._resolve_callable(fn, node),
                        f"the fn of PhaseGraph(...) on line {node.lineno}")
            elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and node.name == PHASE_FNS):
                for ret in ast.walk(node):
                    if not isinstance(ret, ast.Return) or not isinstance(
                            ret.value, (ast.List, ast.Tuple)):
                        continue
                    for elt in ret.value.elts:
                        if isinstance(elt, ast.Tuple) and elt.elts:
                            elt = elt.elts[-1]
                        add(self._resolve_callable(elt, node),
                            f"a phase of {PHASE_FNS}() on line "
                            f"{node.lineno}")
        return captured

    def extend_captured(self, scopes: Dict[Tuple[int, int, str], str]
                        ) -> None:
        """Add the functions keyed in ``scopes`` (``function_key``), with
        how each was reached, to the captured scopes: the call-graph
        engine's cross-module seeds."""
        if not scopes:
            return
        added = set()
        for node in ast.walk(self.tree):
            if isinstance(node, FunctionLike):
                via = scopes.get(function_key(node))
                if via is not None and node not in self.traced_scopes:
                    added.add(node)
                    self.captured_via.setdefault(node, via)
        if added:
            self.traced_scopes = self._with_closures(
                self.traced_scopes | added)
            self._set_roots()
            self._taint_cache.clear()

    def _ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def _has_traced_ancestor(self, node: ast.AST) -> bool:
        return any(a in self.traced_scopes for a in self._ancestors(node))

    def enclosing_traced_scope(self, node: ast.AST) -> Optional[ast.AST]:
        if node in self.traced_scopes:
            return node
        for anc in self._ancestors(node):
            if anc in self.traced_scopes:
                return anc
        return None

    # -- taint ----------------------------------------------------------

    @staticmethod
    def _param_names(scope: ast.AST) -> Set[str]:
        """Parameters presumed to carry tensors: everything except
        config-named params (STATIC_PARAM_NAMES), flag-like params whose
        default is a literal constant (``with_obs=True``), and params
        annotated with a type that names no tensor (``model: nn.Module``,
        ``shape: Tuple[int, ...]``)."""
        args = scope.args
        positional = [*args.posonlyargs, *args.args]
        static: Set[str] = set(STATIC_PARAM_NAMES)
        for arg in (*positional, *args.kwonlyargs):
            if arg.annotation is not None and not any(
                    word in ast.unparse(arg.annotation)
                    for word in TENSOR_ANNOTATIONS):
                static.add(arg.arg)
        for arg, default in zip(
            reversed(positional), reversed(args.defaults)
        ):
            if isinstance(default, ast.Constant):
                static.add(arg.arg)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None and isinstance(default, ast.Constant):
                static.add(arg.arg)
        names = {
            a.arg
            for a in (
                *positional, *args.kwonlyargs,
                *filter(None, (args.vararg, args.kwarg)),
            )
        }
        return names - static

    def tensor_attrs(self, cls: Optional[ast.ClassDef]) -> Set[str]:
        """``self.<attr>`` of ``cls`` that a method binds from a
        ``torch.*`` call: the instance's own tensors."""
        key = cls.name if cls is not None else None
        cached = self._tensor_attrs.get(key)
        if cached is not None:
            return cached
        attrs: Set[str] = set()
        if cls is not None:
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign):
                    targets, value = [node.target], node.value
                else:
                    continue
                if not tensor_expr(value):
                    continue
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and dotted_name(t.value) == "self"):
                        attrs.add(f"self.{t.attr}")
        self._tensor_attrs[key] = attrs
        return attrs

    def _closed_over(self, root: ast.AST) -> Set[str]:
        """Names the functions enclosing ``root`` bind from a ``torch.*``
        call: the tensors a closure captures."""
        out: Set[str] = set()
        for anc in self._ancestors(root):
            if not isinstance(anc, FunctionLike) or isinstance(
                    anc, ast.Lambda):
                continue
            for node in ast.walk(anc):
                if isinstance(node, ast.Assign) and tensor_expr(node.value):
                    out.update(self._target_names(node.targets))
        return out

    def taint_for(self, root: ast.AST) -> Set[str]:
        """Names (and ``self.<attr>`` paths) holding (potentially) tensors
        anywhere inside the captured root: its parameters, parameters of
        nested functions, what it closes over, the instance's tensor
        attributes, and fixpoint propagation through assignments."""
        cached = self._taint_cache.get(root)
        if cached is not None:
            return cached
        taint: Set[str] = set()
        for node in ast.walk(root):
            if isinstance(node, FunctionLike):
                taint |= self._param_names(node)
        if isinstance(root, FunctionLike):
            taint |= self._param_names(root)
        taint |= self._closed_over(root)
        taint |= self.tensor_attrs(self.enclosing_class(root))
        for _ in range(4):  # fixpoint; chains deeper than 4 hops are rare
            grew = False
            for node in ast.walk(root):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.NamedExpr):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    targets, value = [node.target], node.iter
                if value is None or not (
                        self.expr_tainted(value, taint)
                        or tensor_expr(value)):
                    continue
                for name in self._target_names(targets):
                    if name not in taint:
                        taint.add(name)
                        grew = True
            if not grew:
                break
        self._taint_cache[root] = taint
        return taint

    @staticmethod
    def _target_names(targets: Iterable[ast.AST]) -> Iterator[str]:
        """The names an assignment binds (``self.x`` for an attribute of
        ``self``, which leaves ``self`` itself untainted)."""
        todo = list(targets)
        while todo:
            node = todo.pop()
            if isinstance(node, ast.Name):
                yield node.id
            elif (isinstance(node, ast.Attribute)
                  and dotted_name(node.value) == "self"):
                yield f"self.{node.attr}"
            else:
                todo.extend(ast.iter_child_nodes(node))

    def expr_tainted(self, node: ast.AST, taint: Set[str]) -> bool:
        """Does evaluating ``node`` touch a tensor? Static extractors
        (shape/dtype/device/len/isinstance/is-None) break the chain."""
        if isinstance(node, ast.Name):
            return node.id in taint
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            if dotted_name(node) in taint:
                return True
            return self.expr_tainted(node.value, taint)
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in STATIC_CALLS:
                return False
            return any(
                self.expr_tainted(c, taint)
                for c in ast.iter_child_nodes(node)
            )
        if isinstance(node, ast.Compare):
            if all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
            ):
                return False  # `x is None`: structural, never a tensor
            if any(
                isinstance(c, ast.Constant) and isinstance(c.value, str)
                for c in (node.left, *node.comparators)
            ):
                return False  # comparing to a string: host metadata
        return any(
            self.expr_tainted(c, taint) for c in ast.iter_child_nodes(node)
        )

    # -- suppression -----------------------------------------------------

    def suppressed(self, line: int, rule_name: str) -> bool:
        if rule_name in self.file_disabled:
            return True
        candidates = []
        if 1 <= line <= len(self.lines):
            candidates.append(self.lines[line - 1])
        if 2 <= line <= len(self.lines) + 1:
            above = self.lines[line - 2]
            if above.lstrip().startswith("#"):
                candidates.append(above)
        for text in candidates:
            m = _DISABLE_RE.search(text)
            if m and rule_name in _split_rule_list(m.group(1)):
                return True
        return False


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------


def lint_source(
    source: str,
    path: str = "<string>",
    config: Optional[GraftlintConfig] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Violation]:
    """Lint one module's source; returns violations sorted by location.
    Rules configured ``off`` are skipped; per-line / per-file suppression
    comments are honored. A module on disk gets the captured scopes its
    package reaches into it (``callgraph.CallGraphEngine.captured_in``)."""
    from marl_distributedformation_tpu_torch.analysis import callgraph
    from marl_distributedformation_tpu_torch.analysis.rules import all_rules

    config = config or GraftlintConfig()
    active = list(rules) if rules is not None else all_rules()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Violation(
                "syntax-error", path, e.lineno or 0, e.offset or 0,
                f"file does not parse: {e.msg}", "error",
            )
        ]
    ctx = ModuleContext(tree, source, path)
    ctx.extend_captured(callgraph.ENGINE.captured_in(ctx))
    violations: List[Violation] = []
    for rule in active:
        severity = config.rule_severity(rule.name, rule.default_severity)
        if severity == "off":
            continue
        for line, col, message in rule.check(ctx):
            if ctx.suppressed(line, rule.name):
                continue
            violations.append(
                Violation(rule.name, path, line, col, message, severity)
            )
    return sorted(violations, key=lambda v: (v.path, v.line, v.col, v.rule))


def iter_python_files(
    paths: Sequence, config: GraftlintConfig, root: Optional[Path] = None
) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not config.excludes_path(f, root):
                    yield f
        elif p.suffix == ".py" and not config.excludes_path(p, root):
            yield p


def lint_paths(
    paths: Sequence,
    config: Optional[GraftlintConfig] = None,
    rules: Optional[Sequence[Rule]] = None,
    root: Optional[Path] = None,
) -> List[Violation]:
    """Lint every ``.py`` file under ``paths`` (files or directories),
    honoring the config's exclude list."""
    config = config or GraftlintConfig()
    violations: List[Violation] = []
    for f in iter_python_files(paths, config, root):
        violations.extend(
            lint_source(
                f.read_text(encoding="utf-8"), str(f), config, rules
            )
        )
    return violations
