"""Whole-package call-graph + lock-context engine (the graftlock substrate).

Counterpart of the JAX package's ``analysis/callgraph.py``, which is
framework-neutral: this copy resolves imports inside the port's package
and adds one analysis, the captured closure (4 below).

1. **Call graph.** Every ``def`` / ``async def`` / ``lambda`` in a
   package becomes a :class:`FuncInfo`; call sites resolve through
   plain names, ``self.method``, attribute receivers typed via
   ``__init__`` annotations or direct construction, module aliases, and
   ``from m import f`` imports. Traversals are depth-bounded
   (:data:`MAX_DEPTH`).

2. **Lock context.** ``with lock:`` blocks (including the
   ``getattr(obj, "batch_lock", None)`` + ``lock if lock is not None
   else nullcontext()`` gate idiom), explicit ``.acquire()`` calls
   (timed vs untimed), attribute writes, and callback registrations
   (``threading.Thread(target=...)``, ``Timer``, ``submit``,
   ``add_done_callback``, handler tables) are recorded per function
   with the with-stack held at each event, then propagated through
   resolved calls so "reachable while holding X" is a graph question.

3. **Annotations.** A small grammar declares intent the AST cannot:

   - ``# graftlock: guarded-by=<lock_attr>`` on an attribute
     assignment / dataclass field line declares the attr's guard;
   - ``# graftlock: holds=<lock_attr>`` on (or directly above) a
     ``def`` line asserts the caller-holds contract of a helper;
   - ``# graftlock: gate`` on a lock attr's declaration marks it a
     dispatch/batch gate (``batch_lock`` is a gate by naming
     convention);
   - ``# graftlock: lock=<name>`` names a ``with``-item's lock when
     inference fails.

4. **The captured closure.** Every function a captured scope (the ``fn``
   of a ``PhaseGraph``, a phase of a ``phase_fns()`` list, a closure in
   either; ``linter.ModuleContext``) reaches through resolved calls, to
   :data:`MAX_DEPTH` hops, in any module of the package, counts as
   captured too: its host code runs at the warm-up and the capture only.
   A phase ``self.m`` seeds ``m``'s overrides in every subclass in the
   package, a phase ``self.<attr>.m`` whose owner is unknown seeds every
   method ``m`` of the package, and a call ``self.m()`` reaches the
   subclasses' overrides of ``m`` as well.

On top of these the engine computes the four graftlock analyses —
lock-ordering cycles over the may-acquire-while-holding graph,
unguarded writes to declared-guarded attributes from thread-reachable
code, blocking calls reachable under a dispatch gate, and callbacks
registered under a lock they re-acquire — once per package snapshot;
the rules in ``rules/graftlock.py`` just look their module's findings
up.

Caching: parses and per-module analyses are keyed on
``(path, mtime_ns, size)``; the package graph is keyed on the sorted
snapshot of every member file, so editing any module invalidates exactly
one module analysis plus the package pass. A lint of an in-memory module
(path not on disk) analyzes that module alone — fixture lints can never
leak findings from the repo.

Lock identity: ``Class.attr`` when the owner class resolves, bare attr
name otherwise; a module-level lock (``_CAPTURE_LOCK =
threading.Lock()``) by its name, and lock-like names match in any case. Guard/held matching uses bare names (conservative
across instances); cycle edges connect qualified keys, skip same-name
pairs (N instances of one lock class, e.g. a coordinator sweeping every
replica's ``batch_lock``, are ordered by iteration, not nesting), and
only untimed acquisitions create edges — a timed acquire with an abort
path cannot deadlock.

Pure AST: imports nothing but the standard library.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import (
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from marl_distributedformation_tpu_torch.analysis.linter import (
    FunctionLike,
    ModuleContext,
    dotted_name,
    function_key,
)

# Rule names the package pass computes findings for (defined here, not
# in rules/graftlock.py, so the engine never imports the rule layer).
LOCK_ORDERING_CYCLE = "lock-ordering-cycle"
UNGUARDED_SHARED_MUTATION = "unguarded-shared-mutation"
BLOCKING_UNDER_GATE = "blocking-call-under-dispatch-lock"
CALLBACK_LOCK_SEAM = "lock-released-across-await-seam"

# Transitive traversal bound: every analysis below follows resolved
# calls at most this many hops. Chains deeper than 8 frames are beyond
# what a static pass can report actionably; the runtime guards own them.
MAX_DEPTH = 8

# How many ancestor directories of a linted file are searched as roots
# for absolute imports.
MAX_ROOT_WALK = 6

_ANNOT_RE = re.compile(r"#\s*graftlock:\s*([^#]+)")
_ANNOT_KEYS = frozenset({"guarded-by", "holds", "gate", "lock"})

# Attribute names that denote a lock-like synchronization object when no
# stronger signal (constructor, annotation) exists.
# Case-insensitive, so module constants (``_CAPTURE_LOCK``) count too.
_LOCKISH_RE = re.compile(
    r"(?:^|_)(?:lock|locks|barrier|mutex|cond|rlock)(?:$|_)", re.IGNORECASE)

_LOCK_CTORS = frozenset(
    {
        "threading.Lock", "threading.RLock", "threading.Condition",
        "threading.Semaphore", "threading.BoundedSemaphore",
        "Lock", "RLock", "Condition",
    }
)
_THREAD_CTORS = frozenset({"threading.Thread", "Thread"})
_TIMER_CTORS = frozenset({"threading.Timer", "Timer"})

# Container-mutation methods: calling one on a guarded attribute is a
# write to the shared structure.
_MUTATORS = frozenset(
    {
        "append", "appendleft", "extend", "add", "update", "pop", "popleft",
        "remove", "discard", "clear", "setdefault", "insert",
    }
)

# Gate-lock naming convention (rule 25): the fleet batch barrier.
_GATE_NAMES = frozenset({"batch_lock"})

# Blocking calls by dotted name (rule 25).
_BLOCKING_DOTTED = frozenset(
    {
        "torch.cuda.synchronize", "time.sleep",
        "urllib.request.urlopen", "requests.get", "requests.post",
        "socket.create_connection",
    }
)
_FILE_IO_ATTRS = frozenset(
    {"read_text", "write_text", "read_bytes", "write_bytes"}
)


def parse_annotations(line: str) -> Dict[str, List[str]]:
    """``# graftlock: key=value ...`` tokens on one source line. Parsing
    stops at the first token that is not a known key, so trailing prose
    ('gate — serving pause boundary') does not corrupt the payload."""
    m = _ANNOT_RE.search(line)
    out: Dict[str, List[str]] = {}
    if not m:
        return out
    for token in re.split(r"[\s,]+", m.group(1).strip()):
        if not token:
            continue
        key, eq, val = token.partition("=")
        if key not in _ANNOT_KEYS:
            break
        bucket = out.setdefault(key, [])
        if eq and val:
            bucket.append(val)
    return out


@dataclasses.dataclass(frozen=True)
class LockRef:
    """One lock object, as precisely as static analysis can name it."""

    name: str                     # attribute / variable name
    owner: Optional[str] = None   # owning class when resolvable

    @property
    def key(self) -> str:
        return f"{self.owner}.{self.name}" if self.owner else self.name


@dataclasses.dataclass(frozen=True)
class Acquire:
    lock: LockRef
    timed: bool
    line: int
    col: int
    via: str                      # "with" | "acquire"
    held: Tuple[LockRef, ...]     # with-stack at the acquisition point


@dataclasses.dataclass(frozen=True)
class AttrWrite:
    recv: str                     # "self", dotted receiver, or ""
    attr: str
    line: int
    col: int
    held: Tuple[LockRef, ...]
    in_init: bool


class CallSite:
    __slots__ = ("node", "line", "col", "held")

    def __init__(self, node: ast.Call, held: Tuple[LockRef, ...]) -> None:
        self.node = node
        self.line = node.lineno
        self.col = node.col_offset
        self.held = held


class Registration:
    """A callable handed to another execution context: thread target,
    timer, executor submit, done-callback, or a handler-table entry."""

    __slots__ = ("target", "kind", "line", "col", "held")

    def __init__(
        self, target: ast.AST, kind: str, line: int, col: int,
        held: Tuple[LockRef, ...],
    ) -> None:
        self.target = target
        self.kind = kind
        self.line = line
        self.col = col
        self.held = held


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST
    name: str
    qualname: str
    class_name: Optional[str]
    module: "ModuleInfo"
    holds: Tuple[str, ...]                 # bare lock names asserted held
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    acquires: List[Acquire] = dataclasses.field(default_factory=list)
    writes: List[AttrWrite] = dataclasses.field(default_factory=list)
    registrations: List[Registration] = dataclasses.field(default_factory=list)

    def holds_refs(self) -> Tuple[LockRef, ...]:
        return tuple(LockRef(n, self.class_name) for n in self.holds)


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    methods: Dict[str, ast.AST]
    bases: List[str]
    attr_types: Dict[str, str]    # attr -> constructor/annotation dotted name
    guards: Dict[str, str]        # attr -> guard lock bare name
    gates: Set[str]               # lock attrs marked "# graftlock: gate"
    lock_attrs: Set[str]


def _is_lock_ctor(ctor: Optional[str]) -> bool:
    if not ctor:
        return False
    if ctor in _LOCK_CTORS:
        return True
    tail = ctor.rsplit(".", 1)[-1]
    return bool(re.search(r"(?:Lock|Barrier|Condition|Semaphore)$", tail))


def _timeout_bounded(node: ast.Call, *, first_arg_is_timeout: bool) -> bool:
    """Does this ``.acquire()`` / ``.wait()`` / ``.get()`` call carry a
    bound? Explicit ``timeout=None`` (and bare ``acquire(True)``) are
    unbounded; any other timeout expression counts as bounded."""
    for kw in node.keywords:
        if kw.arg == "timeout":
            return not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            )
    if node.args:
        first = node.args[0]
        if isinstance(first, ast.Constant):
            if first.value is False:
                return True   # non-blocking acquire: returns immediately
            if first.value in (True, None):
                return len(node.args) > 1
        return first_arg_is_timeout or len(node.args) > 1
    return False


def blocking_desc(node: ast.Call) -> Optional[str]:
    """Human-readable description when this call can block the calling
    thread indefinitely (or for a device round trip) — the shapes that
    wedge a fleet-wide serving pause when a dispatch gate is held."""
    fname = dotted_name(node.func)
    if fname in _BLOCKING_DOTTED:
        return f"{fname}(...)"
    if fname == "open":
        return "open(...) file IO"
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    recv = dotted_name(node.func.value) or ""
    if attr in _FILE_IO_ATTRS:
        return f"{recv or '<expr>'}.{attr}(...) file IO"
    if attr == "incident" and ("tracer" in recv or "flightrec" in recv):
        return f"{recv}.incident(...) flight-record file IO"
    if attr == "get" and "queue" in recv.rsplit(".", 1)[-1].lower():
        if not _timeout_bounded(node, first_arg_is_timeout=False):
            return f"{recv}.get() with no timeout"
    if attr == "acquire" and _LOCKISH_RE.search(recv.rsplit(".", 1)[-1]):
        if not _timeout_bounded(node, first_arg_is_timeout=False):
            return f"{recv}.acquire() with no timeout"
    if attr == "wait" and not _timeout_bounded(node, first_arg_is_timeout=True):
        if isinstance(node.func.value, (ast.Name, ast.Attribute)):
            return f"{recv}.wait() with no timeout"
    return None


# ----------------------------------------------------------------------
# Per-module analysis
# ----------------------------------------------------------------------


def _imports(
    tree: ast.Module,
) -> Tuple[Dict[str, Tuple[str, str, int]], Dict[str, Tuple[str, int]]]:
    """``from_imports[local] = (module, attr, level)`` and
    ``module_aliases[alias] = (module, 0)`` — rule 14's import surface,
    now shared by every interprocedural analysis."""
    from_imports: Dict[str, Tuple[str, str, int]] = {}
    module_aliases: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                from_imports[alias.asname or alias.name] = (
                    module, alias.name, node.level,
                )
        elif isinstance(node, ast.Import):
            for alias in node.names:
                module_aliases[alias.asname or alias.name] = (alias.name, 0)
    return from_imports, module_aliases


class ModuleInfo:
    """One module's call-graph facts: defs, classes, imports, and the
    per-function lock-context event streams."""

    def __init__(self, path: str, tree: ast.Module, source: str) -> None:
        self.path = path
        self.tree = tree
        self.lines = source.splitlines()
        self.from_imports, self.module_aliases = _imports(tree)
        self.classes: Dict[str, ClassInfo] = {}
        self.top_defs: Dict[str, ast.AST] = {}
        self.defs_by_name: Dict[str, List[ast.AST]] = {}
        self.functions: Dict[int, FuncInfo] = {}   # id(def node) -> info
        self.funcs: List[FuncInfo] = []

        parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent
        self._parents = parents

        # Module-level locks (``_CAPTURE_LOCK = threading.Lock()``).
        self.module_locks: Set[str] = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top_defs[node.name] = node
            elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)
                  and isinstance(node.value, ast.Call)
                  and _is_lock_ctor(dotted_name(node.value.func))):
                self.module_locks.add(node.targets[0].id)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs_by_name.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.ClassDef):
                self._build_class(node)

        for node in ast.walk(tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                info = self._analyze_function(node)
                self.functions[id(node)] = info
                self.funcs.append(info)

    # -- structure -----------------------------------------------------

    def _enclosing_class(self, node: ast.AST) -> Optional[str]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a def nested inside a method still belongs to the class
                cur = self._parents.get(cur)
                continue
            cur = self._parents.get(cur)
        return None

    def _build_class(self, node: ast.ClassDef) -> None:
        methods = {
            stmt.name: stmt
            for stmt in node.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        info = ClassInfo(
            name=node.name,
            node=node,
            methods=methods,
            bases=[dotted_name(b) or "" for b in node.bases],
            attr_types={},
            guards={},
            gates=set(),
            lock_attrs=set(),
        )
        # Class-body fields (dataclass style): `x: T = ...`.
        for stmt in node.body:
            target: Optional[str] = None
            ctor: Optional[str] = None
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                target = stmt.target.id
                ann = dotted_name(stmt.annotation)
                if ann:
                    info.attr_types[target] = ann
                if isinstance(stmt.value, ast.Call):
                    ctor = dotted_name(stmt.value.func)
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
                isinstance(stmt.targets[0], ast.Name)
            ):
                target = stmt.targets[0].id
                if isinstance(stmt.value, ast.Call):
                    ctor = dotted_name(stmt.value.func)
                    if ctor:
                        info.attr_types[target] = ctor
            if target is not None:
                self._note_attr(info, target, ctor, stmt.lineno)
        # `self.x = ...` anywhere in the class's methods.
        annotations = {}
        init = methods.get("__init__")
        if init is not None and not isinstance(init, ast.Lambda):
            annotations = {
                a.arg: dotted_name(a.annotation)
                for a in (*init.args.posonlyargs, *init.args.args,
                          *init.args.kwonlyargs)
                if a.annotation is not None
            }
        for method in methods.values():
            for stmt in ast.walk(method):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(stmt, ast.Assign):
                    targets, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AnnAssign):
                    targets, value = [stmt.target], stmt.value
                for t in targets:
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    ctor = None
                    if isinstance(value, ast.Call):
                        ctor = dotted_name(value.func)
                        if ctor and t.attr not in info.attr_types:
                            info.attr_types[t.attr] = ctor
                    elif isinstance(value, ast.Name):
                        ann = annotations.get(value.id)
                        if ann and t.attr not in info.attr_types:
                            info.attr_types[t.attr] = ann
                    self._note_attr(info, t.attr, ctor, stmt.lineno)
        self.classes[node.name] = info

    def _note_attr(
        self, info: ClassInfo, attr: str, ctor: Optional[str], lineno: int
    ) -> None:
        """Record lock-ness and graftlock annotations for one attribute
        declaration line."""
        if _is_lock_ctor(ctor) or _LOCKISH_RE.search(attr):
            info.lock_attrs.add(attr)
        ann = self._line_annotations(lineno)
        for guard in ann.get("guarded-by", ()):
            info.guards[attr] = guard
        if "gate" in ann:
            info.gates.add(attr)
            info.lock_attrs.add(attr)

    def _line_annotations(self, lineno: int) -> Dict[str, List[str]]:
        if 1 <= lineno <= len(self.lines):
            return parse_annotations(self.lines[lineno - 1])
        return {}

    def _def_annotations(self, node: ast.AST) -> Dict[str, List[str]]:
        """Annotations on the def line or a comment-only line directly
        above it (mirroring suppression-comment placement)."""
        out = self._line_annotations(node.lineno)
        if not out and node.lineno >= 2:
            above = self.lines[node.lineno - 2]
            if above.lstrip().startswith("#"):
                out = parse_annotations(above)
        return out

    # -- per-function event streams ------------------------------------

    def _analyze_function(self, node: ast.AST) -> FuncInfo:
        class_name = self._enclosing_class(node)
        name = getattr(node, "name", "<lambda>")
        qualname = f"{class_name}.{name}" if class_name else name
        holds: Tuple[str, ...] = ()
        if not isinstance(node, ast.Lambda):
            holds = tuple(self._def_annotations(node).get("holds", ()))
        info = FuncInfo(
            node=node, name=name, qualname=qualname,
            class_name=class_name, module=self, holds=holds,
        )
        scanner = _FuncScanner(self, info)
        body = node.body if isinstance(node.body, list) else [node.body]
        scanner.scan_block(body)
        return info

    def class_of(self, name: Optional[str]) -> Optional[ClassInfo]:
        return self.classes.get(name) if name else None


class _FuncScanner:
    """Orders one function body, tracking the ``with``-stack of held
    locks and simple lock-valued locals, and emits the event streams.
    Nested defs/lambdas are skipped — a closure runs later, on some
    other stack, and inherits nothing."""

    def __init__(self, module: ModuleInfo, info: FuncInfo) -> None:
        self.module = module
        self.info = info
        self.held: List[LockRef] = []
        self.lock_locals: Dict[str, LockRef] = {}
        self.in_init = info.name in ("__init__", "__post_init__")

    def scan_block(self, stmts: Sequence[ast.AST]) -> None:
        for stmt in stmts:
            self._scan(stmt)

    def _scan(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            self._scan_with(node)
            return
        if isinstance(node, ast.Assign):
            self._scan_assign(node)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            self._record_writes([node.target])
        if isinstance(node, ast.Call):
            self._scan_call(node)
        for child in ast.iter_child_nodes(node):
            self._scan(child)

    # -- with blocks ---------------------------------------------------

    def _scan_with(self, node) -> None:
        pushed = 0
        forced = self.module._line_annotations(node.lineno).get("lock", [])
        for item in node.items:
            self._scan(item.context_expr)     # calls inside the item expr
            ref = self._lock_of(item.context_expr, require_lockish=True)
            if ref is None and forced:
                ref = LockRef(forced.pop(0))
            if ref is not None:
                self.info.acquires.append(
                    Acquire(
                        lock=ref, timed=False, line=node.lineno,
                        col=node.col_offset, via="with",
                        held=tuple(self.held),
                    )
                )
                self.held.append(ref)
                pushed += 1
        self.scan_block(node.body)
        for _ in range(pushed):
            self.held.pop()

    # -- assignments / writes ------------------------------------------

    def _scan_assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            ref = self._lock_of(node.value, require_lockish=False)
            if ref is not None:
                self.lock_locals[node.targets[0].id] = ref
        self._record_writes(node.targets)

    def _record_writes(self, targets: Sequence[ast.AST]) -> None:
        for t in targets:
            attr_node: Optional[ast.Attribute] = None
            if isinstance(t, ast.Attribute):
                attr_node = t
            elif isinstance(t, ast.Subscript) and isinstance(
                t.value, ast.Attribute
            ):
                attr_node = t.value
            elif isinstance(t, ast.Tuple):
                self._record_writes(t.elts)
                continue
            if attr_node is None:
                continue
            recv = dotted_name(attr_node.value) or ""
            self.info.writes.append(
                AttrWrite(
                    recv=recv, attr=attr_node.attr, line=t.lineno,
                    col=t.col_offset, held=tuple(self.held),
                    in_init=self.in_init,
                )
            )

    # -- calls ----------------------------------------------------------

    def _scan_call(self, node: ast.Call) -> None:
        held = tuple(self.held)
        self.info.calls.append(CallSite(node, held))
        fname = dotted_name(node.func)
        # explicit acquire: an acquisition event, not a held context
        if isinstance(node.func, ast.Attribute) and node.func.attr == "acquire":
            ref = self._lock_of(node.func.value, require_lockish=False)
            if ref is not None:
                self.info.acquires.append(
                    Acquire(
                        lock=ref,
                        timed=_timeout_bounded(
                            node, first_arg_is_timeout=False
                        ),
                        line=node.lineno, col=node.col_offset,
                        via="acquire", held=held,
                    )
                )
        # container mutation on an attribute = a write to it
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
            and isinstance(node.func.value, ast.Attribute)
        ):
            recv_attr = node.func.value
            recv = dotted_name(recv_attr.value) or ""
            self.info.writes.append(
                AttrWrite(
                    recv=recv, attr=recv_attr.attr, line=node.lineno,
                    col=node.col_offset, held=held, in_init=self.in_init,
                )
            )
        # callback registrations
        self._scan_registrations(node, fname, held)

    def _scan_registrations(
        self, node: ast.Call, fname: Optional[str],
        held: Tuple[LockRef, ...],
    ) -> None:
        def reg(target: ast.AST, kind: str) -> None:
            self.info.registrations.append(
                Registration(target, kind, node.lineno, node.col_offset, held)
            )

        if fname in _THREAD_CTORS:
            for kw in node.keywords:
                if kw.arg == "target":
                    reg(kw.value, "thread")
        elif fname in _TIMER_CTORS:
            if len(node.args) >= 2:
                reg(node.args[1], "timer")
            for kw in node.keywords:
                if kw.arg == "function":
                    reg(kw.value, "timer")
        elif isinstance(node.func, ast.Attribute):
            if node.func.attr == "submit" and node.args:
                reg(node.args[0], "submit")
            elif node.func.attr == "add_done_callback" and node.args:
                reg(node.args[0], "done-callback")
        # handler tables: `Server({"register": self._rpc_register, ...})`
        for arg in (*node.args, *(kw.value for kw in node.keywords)):
            if isinstance(arg, ast.Dict):
                for value in arg.values:
                    if isinstance(value, (ast.Attribute, ast.Name)):
                        reg(value, "handler-table")

    # -- lock expression resolution -------------------------------------

    def _lock_of(
        self, expr: ast.AST, *, require_lockish: bool
    ) -> Optional[LockRef]:
        if isinstance(expr, ast.IfExp):
            return (
                self._lock_of(expr.body, require_lockish=require_lockish)
                or self._lock_of(expr.orelse, require_lockish=require_lockish)
            )
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                ref = self._lock_of(v, require_lockish=require_lockish)
                if ref is not None:
                    return ref
            return None
        if isinstance(expr, ast.Name):
            ref = self.lock_locals.get(expr.id)
            if ref is not None:
                return ref
            if expr.id in self.module.module_locks or _LOCKISH_RE.search(
                    expr.id):
                return LockRef(expr.id)
            return None
        if isinstance(expr, ast.Attribute):
            owner = self._receiver_class(expr.value)
            cls = self.module.class_of(owner)
            is_lock = bool(
                (cls and expr.attr in cls.lock_attrs)
                or _LOCKISH_RE.search(expr.attr)
            )
            if is_lock or not require_lockish:
                return LockRef(expr.attr, owner) if is_lock or owner else (
                    LockRef(expr.attr)
                )
            return None
        if isinstance(expr, ast.Call):
            fname = dotted_name(expr.func)
            if fname and fname.rsplit(".", 1)[-1] == "getattr":
                if len(expr.args) >= 2 and isinstance(
                    expr.args[1], ast.Constant
                ) and isinstance(expr.args[1].value, str):
                    owner = self._receiver_class(expr.args[0])
                    return LockRef(expr.args[1].value, owner)
            if _is_lock_ctor(fname):
                return LockRef(fname.rsplit(".", 1)[-1].lower())
        return None

    def _receiver_class(self, expr: ast.AST) -> Optional[str]:
        """Class name owning the attributes of ``expr``: ``self`` is the
        enclosing class; ``self.x`` follows the inferred attr type."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return self.info.class_name
            return None
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ) and expr.value.id == "self":
            cls = self.module.class_of(self.info.class_name)
            if cls:
                t = cls.attr_types.get(expr.attr)
                if t:
                    return t.rsplit(".", 1)[-1]
        return None


# ----------------------------------------------------------------------
# Package graph + analyses
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeSite:
    """Example site of a may-acquire-while-holding edge."""

    module_path: str
    qualname: str
    line: int
    col: int
    chain: Tuple[str, ...]        # held lock keys, in acquisition order
    acquired: str


class PackageGraph:
    """All modules of one package plus the graftlock analyses computed
    over them. ``findings[path][rule]`` holds ``(line, col, message)``
    triples the rules replay per linted module."""

    def __init__(
        self, modules: Dict[str, ModuleInfo], engine: "CallGraphEngine"
    ) -> None:
        self.modules = modules
        self._engine = engine
        self._member_paths = set(modules)
        self.lock_edges: Dict[Tuple[str, str], EdgeSite] = {}
        self.findings: Dict[str, Dict[str, List[Tuple[int, int, str]]]] = {}
        self.gate_names: Set[str] = set(_GATE_NAMES)
        self._captured: Optional[
            Dict[str, Dict[Tuple[int, int, str], str]]] = None
        self.guard_index: Dict[str, List[Tuple[str, str]]] = {}
        for mod in modules.values():
            for cls in mod.classes.values():
                self.gate_names |= cls.gates
                for attr, guard in cls.guards.items():
                    self.guard_index.setdefault(attr, []).append(
                        (cls.name, guard)
                    )
        self._analyze()

    # -- resolution ------------------------------------------------------

    def resolve_class(
        self, module: ModuleInfo, name: Optional[str]
    ) -> Optional[Tuple[ClassInfo, ModuleInfo]]:
        if not name:
            return None
        name = name.rsplit(".", 1)[-1]
        cls = module.classes.get(name)
        if cls is not None:
            return cls, module
        imported = module.from_imports.get(name)
        if imported is not None:
            target = self._engine.module_by_import(
                module.path, imported[0], imported[2]
            )
            if target is not None:
                cls = target.classes.get(imported[1])
                if cls is not None:
                    return cls, target
        return None

    def _method_of(
        self, module: ModuleInfo, class_name: Optional[str], method: str,
        _seen: Optional[Set[str]] = None,
    ) -> Optional[FuncInfo]:
        resolved = self.resolve_class(module, class_name)
        if resolved is None:
            return None
        cls, owner_mod = resolved
        node = cls.methods.get(method)
        if node is not None:
            return owner_mod.functions.get(id(node))
        seen = _seen or set()
        for base in cls.bases:
            if base and base not in seen:
                seen.add(base)
                hit = self._method_of(owner_mod, base, method, seen)
                if hit is not None:
                    return hit
        return None

    def resolve_call(
        self, module: ModuleInfo, node: ast.Call,
        class_name: Optional[str],
    ) -> List[Tuple[FuncInfo, str]]:
        """Possible callees of one call site as ``(func, kind)`` with
        kind in {"local", "import", "method"}."""
        out: List[Tuple[FuncInfo, str]] = []
        func = node.func
        if isinstance(func, ast.Name):
            name = func.id
            local = module.defs_by_name.get(name)
            if local:
                return [
                    (module.functions[id(d)], "local")
                    for d in local
                    if id(d) in module.functions
                ]
            if name in module.classes:
                init = self._method_of(module, name, "__init__")
                return [(init, "local")] if init else []
            imported = module.from_imports.get(name)
            if imported is not None:
                target = self._engine.module_by_import(
                    module.path, imported[0], imported[2]
                )
                if target is not None:
                    d = target.top_defs.get(imported[1])
                    if d is not None:
                        return [(target.functions[id(d)], "import")]
                    if imported[1] in target.classes:
                        init = self._method_of(
                            target, imported[1], "__init__"
                        )
                        return [(init, "import")] if init else []
            return out
        if not isinstance(func, ast.Attribute):
            return out
        attr = func.attr
        recv = func.value
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                hit = self._method_of(module, class_name, attr)
                return [(hit, "method")] if hit else []
            # module alias (`import telemetry; telemetry.emit(...)`) or
            # from-imported module (`from pkg import mod; mod.f(...)`)
            modref = module.module_aliases.get(recv.id)
            level = 0
            if modref is None:
                imported = module.from_imports.get(recv.id)
                if imported is not None:
                    base, sub, level = imported
                    modref = (f"{base}.{sub}" if base else sub, level)
            if modref is not None:
                target = self._engine.module_by_import(
                    module.path, modref[0], level or modref[1]
                )
                if target is not None:
                    d = target.top_defs.get(attr)
                    if d is not None:
                        return [(target.functions[id(d)], "import")]
            return out
        if isinstance(recv, ast.Attribute) and isinstance(
            recv.value, ast.Name
        ) and recv.value.id == "self":
            # self.obj.m(): follow the inferred type of self.obj
            cls = module.class_of(class_name)
            if cls:
                t = cls.attr_types.get(recv.attr)
                if t:
                    hit = self._method_of(module, t, attr)
                    if hit:
                        return [(hit, "method")]
        return out

    def resolve_target(
        self, module: ModuleInfo, expr: ast.AST, class_name: Optional[str]
    ) -> List[FuncInfo]:
        """Resolve a callback-registration target expression."""
        if isinstance(expr, ast.Lambda):
            info = module.functions.get(id(expr))
            return [info] if info else []
        if isinstance(expr, ast.Name):
            defs = module.defs_by_name.get(expr.id, ())
            return [
                module.functions[id(d)]
                for d in defs
                if id(d) in module.functions
            ]
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ) and expr.value.id == "self":
            hit = self._method_of(module, class_name, expr.attr)
            return [hit] if hit else []
        return []

    # -- the captured closure ------------------------------------------

    def captured(self) -> Dict[str, Dict[Tuple[int, int, str], str]]:
        """``{module path: {function_key: how it was reached}}`` for every
        function of the package a captured scope reaches (see the module
        docstring, 4)."""
        if self._captured is not None:
            return self._captured
        classes: Dict[str, List[Tuple[ModuleInfo, ClassInfo]]] = {}
        subclasses: Dict[str, Set[str]] = {}
        for mod in self.modules.values():
            for cls in mod.classes.values():
                classes.setdefault(cls.name, []).append((mod, cls))
                for base in cls.bases:
                    subclasses.setdefault(
                        base.rsplit(".", 1)[-1], set()).add(cls.name)

        def family(name: str) -> Set[str]:
            out, todo = {name}, [name]
            while todo:
                for sub in subclasses.get(todo.pop(), ()):
                    if sub not in out:
                        out.add(sub)
                        todo.append(sub)
            return out

        def methods(names: Iterable[str], method: str) -> List[FuncInfo]:
            return [
                mod.functions[id(cls.methods[method])]
                for name in sorted(names)
                for mod, cls in classes.get(name, ())
                if method in cls.methods
                and id(cls.methods[method]) in mod.functions
            ]

        seen: Dict[int, Tuple[FuncInfo, str]] = {}
        frontier: List[Tuple[FuncInfo, int]] = []

        def add(func: FuncInfo, depth: int, via: str) -> None:
            if id(func.node) not in seen:
                seen[id(func.node)] = (func, via)
                frontier.append((func, depth))

        for path, mod in sorted(self.modules.items()):
            ctx = self._engine.context_for(mod)
            for node in sorted(ctx.traced_scopes,
                               key=lambda n: (n.lineno, n.col_offset)):
                info = mod.functions.get(id(node))
                if info is not None:
                    add(info, 0, ctx.captured_via.get(node, "captured"))
            for cname, method in ctx.phase_methods:
                for info in methods(family(cname), method):
                    add(info, 0, f"the phase {cname}.{method} "
                                 f"({Path(path).name})")
            for method in sorted(ctx.phase_attr_methods):
                for info in methods(classes, method):
                    add(info, 0, f"a phase named {method} "
                                 f"({Path(path).name})")
        while frontier:
            func, depth = frontier.pop()
            for node in ast.walk(func.node):
                if node is not func.node and isinstance(node, FunctionLike):
                    inner = func.module.functions.get(id(node))
                    if inner is not None:
                        add(inner, depth, f"nested in {func.qualname}")
            if depth >= MAX_DEPTH:
                continue
            for site in func.calls:
                via = (f"reached from {func.qualname} "
                       f"({Path(func.module.path).name}:{site.line})")
                callees = self.resolve_call(
                    func.module, site.node, func.class_name)
                for callee, kind in callees:
                    add(callee, depth + 1, via)
                    if kind == "method" and callee.class_name:
                        # self.m() on a subclass runs its override
                        for override in methods(
                                family(callee.class_name), callee.name):
                            add(override, depth + 1, via)
        out: Dict[str, Dict[Tuple[int, int, str], str]] = {}
        for func, via in seen.values():
            out.setdefault(func.module.path, {})[function_key(func.node)] = via
        self._captured = out
        return out

    # -- analyses --------------------------------------------------------

    def _add(
        self, path: str, rule: str, line: int, col: int, msg: str
    ) -> None:
        if path in self._member_paths:
            self.findings.setdefault(path, {}).setdefault(rule, []).append(
                (line, col, msg)
            )

    def _analyze(self) -> None:
        self._collect_contexts()
        self._detect_cycles()
        self._check_guarded_writes()

    # . lock edges + gate blocking + callback seams (one shared DFS) .....

    def _collect_contexts(self) -> None:
        seen_states: Set[Tuple[int, FrozenSet[str]]] = set()
        blocking_seen: Set[Tuple[str, int, int]] = set()
        seam_seen: Set[Tuple[str, int, int]] = set()

        def merge(
            base: Tuple[LockRef, ...], extra: Tuple[LockRef, ...]
        ) -> Tuple[LockRef, ...]:
            names = {r.name for r in base}
            return base + tuple(r for r in extra if r.name not in names)

        def visit(func: FuncInfo, held: Tuple[LockRef, ...], depth: int) -> None:
            entry = merge(held, func.holds_refs())
            state = (id(func), frozenset(r.name for r in entry))
            if state in seen_states:
                return
            seen_states.add(state)
            mod = func.module
            for acq in func.acquires:
                eff = merge(entry, acq.held)
                if not acq.timed:
                    for h in eff:
                        if h.name == acq.lock.name:
                            continue
                        edge = (h.key, acq.lock.key)
                        if edge not in self.lock_edges:
                            self.lock_edges[edge] = EdgeSite(
                                module_path=mod.path,
                                qualname=func.qualname,
                                line=acq.line, col=acq.col,
                                chain=tuple(r.key for r in eff),
                                acquired=acq.lock.key,
                            )
            for call in func.calls:
                eff = merge(entry, call.held)
                gates = [r for r in eff if r.name in self.gate_names]
                if gates:
                    desc = blocking_desc(call.node)
                    site = (mod.path, call.line, call.col)
                    if desc and site not in blocking_seen:
                        blocking_seen.add(site)
                        self._add(
                            mod.path, BLOCKING_UNDER_GATE, call.line,
                            call.col,
                            f"{desc} runs while dispatch gate "
                            f"{gates[0].key!r} is held (in "
                            f"{func.qualname}) — every replica's batch "
                            "barrier stays closed for the duration; move "
                            "it off the gated region or bound it with a "
                            "timeout",
                        )
                if depth > 0:
                    for callee, _ in self.resolve_call(
                        mod, call.node, func.class_name
                    ):
                        visit(callee, eff, depth - 1)
            for r in func.registrations:
                eff = merge(entry, r.held)
                if not eff:
                    continue
                for target in self.resolve_target(
                    mod, r.target, func.class_name
                ):
                    reacquired = self._reacquires(
                        target, {ref.name for ref in eff}
                    )
                    site = (mod.path, r.line, r.col)
                    if reacquired and site not in seam_seen:
                        seam_seen.add(site)
                        self._add(
                            mod.path, CALLBACK_LOCK_SEAM, r.line, r.col,
                            f"{r.kind} callback {target.qualname} is "
                            f"registered while {reacquired!r} is held and "
                            f"re-acquires {reacquired!r} when it runs — "
                            "if the registering thread waits on the "
                            "callback (or the callback can run "
                            "synchronously) this deadlocks; register "
                            "after releasing the lock",
                        )

        for mod in self.modules.values():
            for func in mod.funcs:
                visit(func, (), MAX_DEPTH)

    def _reacquires(
        self, func: FuncInfo, held_names: Set[str], depth: int = MAX_DEPTH,
        _seen: Optional[Set[int]] = None,
    ) -> Optional[str]:
        """Bare name of the first lock in ``held_names`` that ``func``
        transitively acquires, else None."""
        seen = _seen or set()
        if id(func) in seen:
            return None
        seen.add(id(func))
        for acq in func.acquires:
            if acq.lock.name in held_names:
                return acq.lock.name
        if depth > 0:
            for call in func.calls:
                for callee, _ in self.resolve_call(
                    func.module, call.node, func.class_name
                ):
                    hit = self._reacquires(
                        callee, held_names, depth - 1, seen
                    )
                    if hit:
                        return hit
        return None

    # . cycle detection ..................................................

    def _detect_cycles(self) -> None:
        graph: Dict[str, Set[str]] = {}
        for a, b in self.lock_edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        reported: Set[FrozenSet[str]] = set()
        for start in sorted(graph):
            cycle = self._find_cycle(graph, start)
            if cycle is None:
                continue
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            edges = [
                (cycle[i], cycle[(i + 1) % len(cycle)])
                for i in range(len(cycle))
            ]
            sites = [self.lock_edges[e] for e in edges]
            chain = "; ".join(
                f"holding {a!r} acquires {b!r} in {s.qualname} "
                f"({Path(s.module_path).name}:{s.line})"
                for (a, b), s in zip(edges, sites)
            )
            msg = (
                f"lock-ordering cycle "
                f"{' -> '.join([*cycle, cycle[0]])}: {chain} — two "
                "threads entering this cycle from different edges "
                "deadlock; acquire these locks in one global order (or "
                "make one acquisition timed with an abort path)"
            )
            for mod_path in {s.module_path for s in sites}:
                first = next(
                    s for s in sites if s.module_path == mod_path
                )
                self._add(
                    mod_path, LOCK_ORDERING_CYCLE, first.line, first.col,
                    msg,
                )

    @staticmethod
    def _find_cycle(
        graph: Dict[str, Set[str]], start: str
    ) -> Optional[List[str]]:
        """A simple cycle through ``start``, as a node list, else None."""
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        best: Optional[List[str]] = None
        seen_paths: Set[Tuple[str, ...]] = set()
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) > 1:
                    if best is None or len(path) < len(best):
                        best = list(path)
                    continue
                if nxt in path or len(path) >= 8:
                    continue
                key = tuple([*path, nxt])
                if key not in seen_paths:
                    seen_paths.add(key)
                    stack.append((nxt, [*path, nxt]))
        return best

    # . guarded writes ...................................................

    def _thread_entries(self) -> List[FuncInfo]:
        entries: List[FuncInfo] = []
        seen: Set[int] = set()
        for mod in self.modules.values():
            for func in mod.funcs:
                for r in func.registrations:
                    for target in self.resolve_target(
                        mod, r.target, func.class_name
                    ):
                        if id(target) not in seen:
                            seen.add(id(target))
                            entries.append(target)
        return entries

    def _guard_for(
        self, func: FuncInfo, write: AttrWrite
    ) -> Optional[Tuple[str, str]]:
        """``(guard, owner_class)`` when this write targets a declared-
        guarded attribute."""
        if write.recv == "self":
            resolved = self.resolve_class(func.module, func.class_name)
            seen: Set[str] = set()
            while resolved is not None:
                cls, owner_mod = resolved
                guard = cls.guards.get(write.attr)
                if guard is not None:
                    return guard, cls.name
                resolved = None
                for base in cls.bases:
                    if base and base not in seen:
                        seen.add(base)
                        resolved = self.resolve_class(owner_mod, base)
                        if resolved:
                            break
            return None
        declared = self.guard_index.get(write.attr, ())
        if len(declared) == 1:
            cls_name, guard = declared[0]
            return guard, cls_name
        return None

    def _check_guarded_writes(self) -> None:
        flagged: Set[Tuple[str, int, int]] = set()
        seen_states: Set[Tuple[int, FrozenSet[str]]] = set()

        def visit(func: FuncInfo, held: FrozenSet[str], depth: int) -> None:
            entry = held | set(func.holds)
            state = (id(func), frozenset(entry))
            if state in seen_states:
                return
            seen_states.add(state)
            mod = func.module
            for w in func.writes:
                if w.in_init and w.recv == "self":
                    continue   # pre-publication construction
                guarded = self._guard_for(func, w)
                if guarded is None:
                    continue
                guard, owner = guarded
                eff = entry | {r.name for r in w.held}
                site = (mod.path, w.line, w.col)
                if guard not in eff and site not in flagged:
                    flagged.add(site)
                    recv = w.recv or "<expr>"
                    self._add(
                        mod.path, UNGUARDED_SHARED_MUTATION, w.line, w.col,
                        f"{recv}.{w.attr} is declared guarded-by="
                        f"{guard!r} (on {owner}.{w.attr}) but is written "
                        f"from thread-reachable {func.qualname} without "
                        f"holding {guard!r} — wrap the write in `with "
                        f"...{guard}:` or move it onto the guarded path",
                    )
            if depth > 0:
                for call in func.calls:
                    eff = entry | {r.name for r in call.held}
                    for callee, _ in self.resolve_call(
                        mod, call.node, func.class_name
                    ):
                        visit(callee, frozenset(eff), depth - 1)

        for entry in self._thread_entries():
            visit(entry, frozenset(), MAX_DEPTH)

    # -- rule replay ------------------------------------------------------

    def findings_for(
        self, path: str, rule: str
    ) -> List[Tuple[int, int, str]]:
        return self.findings.get(path, {}).get(rule, [])


# ----------------------------------------------------------------------
# Engine: caches + package discovery
# ----------------------------------------------------------------------


def _file_key(path: Path) -> Optional[Tuple[str, int, int]]:
    try:
        st = path.stat()
    except OSError:
        return None
    return (str(path), st.st_mtime_ns, st.st_size)


class CallGraphEngine:
    """Process-global engine instance (:data:`ENGINE`). All caches are
    keyed on ``(path, mtime_ns, size)`` so an edited module re-resolves
    on the next lint without restarting the process."""

    def __init__(self) -> None:
        self._module_cache: Dict[Tuple[str, int, int], Optional[ModuleInfo]] = {}
        self._package_cache: Dict[str, Tuple[Tuple, PackageGraph]] = {}
        self._ctx_slot: Optional[Tuple[ModuleContext, PackageGraph]] = None
        self._ctx_cache: Dict[Tuple[str, int, int], ModuleContext] = {}

    # -- module loading ---------------------------------------------------

    def module(self, path: Path) -> Optional[ModuleInfo]:
        key = _file_key(path)
        if key is None:
            return None
        if key not in self._module_cache:
            try:
                source = path.read_text(encoding="utf-8")
                tree = ast.parse(source)
            except (OSError, SyntaxError, UnicodeDecodeError, ValueError):
                self._module_cache[key] = None
            else:
                self._module_cache[key] = ModuleInfo(str(path), tree, source)
        return self._module_cache[key]

    def context_for(self, module: ModuleInfo) -> ModuleContext:
        """A ModuleContext (its own captured scopes, taint) for a module
        the engine loaded; an in-memory module's is never cached (two
        fixtures may share a path)."""
        key = _file_key(Path(module.path))
        if key is None:
            return ModuleContext(
                module.tree, "\n".join(module.lines), module.path
            )
        ctx = self._ctx_cache.get(key)
        if ctx is None:
            ctx = ModuleContext(
                module.tree, "\n".join(module.lines), module.path
            )
            self._ctx_cache[key] = ctx
        return ctx

    # -- import resolution (rule 14's, generalized) -----------------------

    @staticmethod
    def module_file(
        path: str, module: str, level: int
    ) -> Optional[Path]:
        """Locate ``module`` (dotted) relative to the importing file at
        ``path``: relative imports resolve against the file's package;
        absolute imports search the file's ancestor directories."""
        base = Path(path).resolve().parent
        parts = module.split(".") if module else []
        if level > 0:
            root = base
            for _ in range(level - 1):
                root = root.parent
            roots = [root]
        else:
            roots = [base, *list(base.parents)[:MAX_ROOT_WALK]]
        for root in roots:
            if parts:
                as_module = root.joinpath(*parts).with_suffix(".py")
                if as_module.is_file():
                    return as_module
                as_package = root.joinpath(*parts, "__init__.py")
                if as_package.is_file():
                    return as_package
            elif level > 0:
                init = root / "__init__.py"
                if init.is_file():
                    return init
        return None

    def module_by_import(
        self, importer_path: str, module: str, level: int
    ) -> Optional[ModuleInfo]:
        file = self.module_file(importer_path, module, level)
        if file is None:
            return None
        return self.module(file)

    # -- package discovery -------------------------------------------------

    @staticmethod
    def package_files(path: Path) -> Tuple[Path, List[Path]]:
        """``(root, member_files)`` for the package containing ``path``:
        walk up while ``__init__.py`` exists (recursive scan of the
        package root); a bare directory (fixture tempdirs, scripts)
        scans non-recursively."""
        directory = path.parent
        root = directory
        while (root.parent / "__init__.py").is_file() and (
            root / "__init__.py"
        ).is_file():
            root = root.parent
        if (root / "__init__.py").is_file():
            files = sorted(root.rglob("*.py"))
        else:
            root = directory
            files = sorted(root.glob("*.py"))
        return root, files

    def package_for(self, ctx: ModuleContext) -> PackageGraph:
        """The PackageGraph covering ``ctx``'s module. In-memory modules
        (path not on disk) analyze alone; on-disk modules pull in their
        whole package, cached on the member-file snapshot."""
        # The slot holds a strong reference to the context it memoizes:
        # comparing a bare id() against a freed context's recycled
        # address would serve a stale graph for an edited file.
        slot = self._ctx_slot
        if slot is not None and slot[0] is ctx:
            return slot[1]
        path = Path(ctx.path)
        if not path.exists():
            source = "\n".join(ctx.lines)
            mod = ModuleInfo(ctx.path, ctx.tree, source)
            pg = PackageGraph({ctx.path: mod}, self)
        else:
            root, files = self.package_files(path.resolve())
            snapshot = tuple(
                k for k in (_file_key(f) for f in files) if k is not None
            )
            cached = self._package_cache.get(str(root))
            if cached is not None and cached[0] == snapshot:
                pg = cached[1]
            else:
                modules: Dict[str, ModuleInfo] = {}
                for f in files:
                    mod = self.module(f)
                    if mod is not None:
                        modules[str(f)] = mod
                pg = PackageGraph(modules, self)
                self._package_cache[str(root)] = (snapshot, pg)
        self._ctx_slot = (ctx, pg)
        return pg

    def module_key_for(self, ctx: ModuleContext) -> str:
        path = Path(ctx.path)
        return str(path.resolve()) if path.exists() else ctx.path

    def captured_in(
        self, ctx: ModuleContext
    ) -> Dict[Tuple[int, int, str], str]:
        """The functions of ``ctx``'s module that its package's captured
        scopes reach, by ``linter.function_key``, with how each was
        reached."""
        pg = self.package_for(ctx)
        return pg.captured().get(self.module_key_for(ctx), {})


ENGINE = CallGraphEngine()


# ----------------------------------------------------------------------
# Reachability helpers for the migrated per-module rules (12/14/16/17/22)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReachHit:
    """A transitive hit: what matched, where the chain entered."""

    matched: str                  # description from the predicate
    first_qualname: str
    first_kind: str               # "local" | "import" | "method"
    first_module: str             # path of the first callee's module
    hops: int


def _ctx_module(ctx: ModuleContext, pg: PackageGraph) -> Optional[ModuleInfo]:
    return pg.modules.get(ENGINE.module_key_for(ctx))


def _enclosing_class_name(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = ctx.parents.get(cur)
    return None


def traced_in_own_module(func: FuncInfo, home_ctx: ModuleContext) -> bool:
    """Is ``func`` a traced scope of its own module? (Prune predicate:
    a traced callee compiles with the loop — its probes/branches are
    in-program, not host-side.)"""
    if func.module.path == home_ctx.path:
        owner = home_ctx
    else:
        owner = ENGINE.context_for(func.module)
    return func.node in owner.traced_scopes


def reachable_call(
    ctx: ModuleContext,
    call: ast.Call,
    pred: Callable[[ast.Call, Optional[str]], Optional[str]],
    *,
    first_hops: FrozenSet[str] = frozenset({"local", "method", "import"}),
    depth: int = MAX_DEPTH,
    prune: Optional[Callable[[FuncInfo], bool]] = None,
) -> Optional[ReachHit]:
    """Does ``call``'s callee transitively reach a call satisfying
    ``pred(call_node, dotted_name)``? The first hop's kind must be in
    ``first_hops`` (rules 12 and 14 split local-vs-imported chains so
    their reports stay disjoint); deeper hops follow every resolvable
    edge. A callee for which ``prune`` answers True is neither scanned
    nor descended into. The direct call itself is NOT tested — direct
    hits stay the per-module rules' own business."""
    pg = ENGINE.package_for(ctx)
    module = _ctx_module(ctx, pg)
    if module is None:
        return None
    class_name = _enclosing_class_name(ctx, call)
    callees = pg.resolve_call(module, call, class_name)
    for first, kind in callees:
        if kind not in first_hops:
            continue
        if prune is not None and prune(first):
            continue
        hit = _search_calls(pg, first, pred, depth, {id(first)}, 1, prune)
        if hit is not None:
            matched, hops = hit
            return ReachHit(
                matched=matched,
                first_qualname=first.qualname,
                first_kind=kind,
                first_module=first.module.path,
                hops=hops,
            )
    return None


def _search_calls(
    pg: PackageGraph,
    func: FuncInfo,
    pred: Callable[[ast.Call, Optional[str]], Optional[str]],
    depth: int,
    seen: Set[int],
    hops: int,
    prune: Optional[Callable[[FuncInfo], bool]] = None,
) -> Optional[Tuple[str, int]]:
    for site in func.calls:
        matched = pred(site.node, dotted_name(site.node.func))
        if matched is not None:
            return matched, hops
    if depth <= 1:
        return None
    for site in func.calls:
        for callee, _ in pg.resolve_call(
            func.module, site.node, func.class_name
        ):
            if id(callee) in seen:
                continue
            seen.add(id(callee))
            if prune is not None and prune(callee):
                continue
            hit = _search_calls(
                pg, callee, pred, depth - 1, seen, hops + 1, prune
            )
            if hit is not None:
                return hit
    return None


def reachable_function(
    ctx: ModuleContext,
    call: ast.Call,
    func_pred: Callable[[FuncInfo, ModuleContext], Optional[str]],
    *,
    depth: int = MAX_DEPTH,
) -> Optional[ReachHit]:
    """Like :func:`reachable_call`, but the predicate inspects each
    reachable FUNCTION (with its own module's ModuleContext) instead of
    each call site — rule 17's shape."""
    pg = ENGINE.package_for(ctx)
    module = _ctx_module(ctx, pg)
    if module is None:
        return None
    class_name = _enclosing_class_name(ctx, call)

    def visit(
        func: FuncInfo, kind: str, first: FuncInfo, d: int,
        seen: Set[int], hops: int,
    ) -> Optional[ReachHit]:
        owner_ctx = (
            ctx if func.module is module
            else ENGINE.context_for(func.module)
        )
        matched = func_pred(func, owner_ctx)
        if matched is not None:
            return ReachHit(
                matched=matched,
                first_qualname=first.qualname,
                first_kind=kind,
                first_module=first.module.path,
                hops=hops,
            )
        if d <= 1:
            return None
        for site in func.calls:
            for callee, _ in pg.resolve_call(
                func.module, site.node, func.class_name
            ):
                if id(callee) in seen:
                    continue
                seen.add(id(callee))
                hit = visit(callee, kind, first, d - 1, seen, hops + 1)
                if hit is not None:
                    return hit
        return None

    for first, kind in pg.resolve_call(module, call, class_name):
        hit = visit(first, kind, first, depth, {id(first)}, 1)
        if hit is not None:
            return hit
    return None
