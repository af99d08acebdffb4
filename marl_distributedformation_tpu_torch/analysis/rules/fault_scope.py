"""fault-point-in-traced-scope: chaos injection in a captured scope.

The chaos plane (``chaos/plane.py``) is host-only by the same contract as
the tracer and the registry: injection points live at dispatch seams (the
checkpoint write, the scheduler's worker loop, the gate's eval body),
never inside a body a ``PhaseGraph`` captures. A ``fault_point(...)`` /
``plane.hit(...)`` there counts one hit at the warm-up and one at the
capture: the armed fault fires at most twice while the campaign believes
it exercises every step, and a fault raised during the capture aborts the
capture itself.

Detection surfaces (the tracer's and the registry's, over the chaos API):

- bare calls to names imported from a ``chaos``/``plane`` module
  (``fault_point(...)``);
- method calls whose receiver chain names the plane
  (``get_fault_plane().hit(...)``, ``plane.hit(...)``,
  ``self._fault_plane.arm(...)``) with the method in ``hit``/``arm``;
- one same-module call hop.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

# Injection entry points on a FaultPlane handle (chaos/plane.py).
_RECORD_METHODS = frozenset({"hit", "arm"})
# Module-level helpers callable bare after a chaos import.
_BARE_CALLS = frozenset({"fault_point"})
# Module-path fragments that mark an import as the chaos plane.
_CHAOS_MODULE_PARTS = frozenset({"chaos"})


def _is_chaos_module(module: str) -> bool:
    return any(part in _CHAOS_MODULE_PARTS for part in module.split("."))


class FaultPointInTracedScope(Rule):
    name = "fault-point-in-traced-scope"
    default_severity = "error"
    description = (
        "chaos.fault_point / FaultPlane.hit reachable inside a captured "
        "scope (a PhaseGraph's fn) — injection counts hits at the warm-up "
        "and the capture, never per replay, and a fault raised there "
        "aborts the capture; inject at the dispatch seam instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        chaos_names = self._chaos_imports(ctx.tree)
        reported: Set[Tuple[int, int]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_traced_scope(node) is None:
                continue
            hit = self._record_call(ctx, node, chaos_names)
            if hit and (node.lineno, node.col_offset) not in reported:
                reported.add((node.lineno, node.col_offset))
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{hit} inside a captured scope injects at the warm-up and "
                    "the capture only (never per replay) — the chaos "
                    "plane is host-side only; put the injection point at "
                    "the dispatch seam around the PhaseGraph call",
                )

    # -- import surface ---------------------------------------------------

    @staticmethod
    def _chaos_imports(tree: ast.Module) -> Set[str]:
        """Local names bound from chaos modules: both
        ``from ...chaos import fault_point`` targets and
        ``import ...chaos as c`` aliases."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if _is_chaos_module(node.module or ""):
                    for alias in node.names:
                        if alias.name != "*":
                            names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_chaos_module(alias.name):
                        names.add(alias.asname or alias.name.split(".")[0])
        return names

    # -- call classification ----------------------------------------------

    def _record_call(
        self, ctx: ModuleContext, node: ast.Call, chaos_names: Set[str]
    ) -> Optional[str]:
        """A human-readable description when this call reaches the
        chaos plane (directly or one same-module hop away); else
        None."""
        direct = self._direct_record(node, chaos_names)
        if direct:
            return direct
        # One call hop: a captured scope calling a same-module helper that
        # injects.
        if isinstance(node.func, ast.Name):
            for definition in ctx._defs_by_name.get(node.func.id, ()):
                for inner in ast.walk(definition):
                    if isinstance(inner, ast.Call):
                        hit = self._direct_record(inner, chaos_names)
                        if hit:
                            return f"{node.func.id}() reaches {hit}"
        return None

    def _direct_record(
        self, node: ast.Call, chaos_names: Set[str]
    ) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name):
            # fault_point(...) bare, or any chaos-imported name called
            # through directly.
            if func.id in _BARE_CALLS or func.id in chaos_names:
                return f"{func.id}(...)"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr not in _RECORD_METHODS:
            # chaos.fault_point(...) via a module alias.
            if func.attr in _BARE_CALLS:
                rname = dotted_name(func.value)
                if rname and rname.split(".")[0] in chaos_names:
                    return f"{rname}.{func.attr}(...)"
            return None
        if self._plane_like(func.value, chaos_names):
            rname = dotted_name(func.value)
            if rname is None and isinstance(func.value, ast.Call):
                inner = dotted_name(func.value.func)
                rname = f"{inner}()" if inner else "<plane>()"
            return f"{rname or '<plane>'}.{func.attr}(...)"
        return None

    @staticmethod
    def _plane_like(expr: ast.AST, chaos_names: Set[str]) -> bool:
        """Does this receiver expression denote the fault plane?
        Receiver chains must look plane-like (``plane``/``fault`` in a
        part, ``get_fault_plane()`` as the root, or a root bound from a
        chaos import) before the method-name check applies —
        ``schedule.hit`` on an unrelated object stays clean."""
        if isinstance(expr, ast.Call):
            fname = dotted_name(expr.func) or ""
            if fname:
                parts = fname.split(".")
                if (
                    parts[-1] == "get_fault_plane"
                    or parts[0] in chaos_names
                ):
                    return True
            return False
        rname = dotted_name(expr)
        if rname is None:
            return False
        parts = rname.split(".")
        return (
            any(
                "plane" in p.lower() or "fault" in p.lower() for p in parts
            )
            or parts[0] in chaos_names
        )
