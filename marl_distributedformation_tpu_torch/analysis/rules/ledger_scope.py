"""ledger-record-in-traced-scope: program-ledger recording in a
captured scope.

The ProgramLedger (``obs/ledger.py``) is host-only by the same contract
as the tracer and the registry: a program registers at its build, around
the capture, and its dispatches are recorded at the host seam around each
replay (``train/capture.py::PhaseGraph``), never inside the body being
measured. A ``get_ledger().dispatch(...)`` there records once at the
warm-up and once at the capture: a census that counts nothing.

Detection surfaces (the tracer's and the registry's, over the ledger's
API):

- record calls whose receiver chain names the ledger
  (``ledger.dispatch(...)``, ``self._ledger.register(...)``,
  ``get_ledger().record_watermark(...)``) with the method in the
  recording set (``dispatch``/``register``/``record_watermark``/
  ``write_census``);
- names imported from an ``obs``/``ledger`` module and called through,
  and the ``sample_device_watermark`` helper by name;
- one same-module call hop.

Receiver chains must look ledger-like before the method-name check
applies, so ``atexit.register(...)`` stays clean.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

# Recording entry points on a ProgramLedger handle (obs/ledger.py).
_RECORD_METHODS = frozenset(
    {"dispatch", "register", "record_watermark", "write_census"}
)
# Bare helpers that record into the ledger when called (guards.py).
_RECORD_FUNCTIONS = frozenset({"sample_device_watermark"})
# Module-path fragments that mark an import as the ledger plane.
_LEDGER_MODULE_PARTS = frozenset({"obs", "ledger"})


def _is_ledger_module(module: str) -> bool:
    return any(part in _LEDGER_MODULE_PARTS for part in module.split("."))


class LedgerRecordInTracedScope(Rule):
    name = "ledger-record-in-traced-scope"
    default_severity = "error"
    description = (
        "obs.ProgramLedger registration/dispatch recording reachable "
        "inside a captured scope (a PhaseGraph's fn) — it records at the "
        "warm-up and the capture, never per replay; record at the "
        "dispatch seam instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        ledger_names = self._ledger_imports(ctx.tree)
        reported: Set[Tuple[int, int]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_traced_scope(node) is None:
                continue
            hit = self._record_call(ctx, node, ledger_names)
            if hit and (node.lineno, node.col_offset) not in reported:
                reported.add((node.lineno, node.col_offset))
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{hit} inside a captured scope records at the warm-up and "
                    "the capture only (never per replay) — the program "
                    "ledger is host-side only; record at the dispatch "
                    "seam around the PhaseGraph call",
                )

    # -- import surface ---------------------------------------------------

    @staticmethod
    def _ledger_imports(tree: ast.Module) -> Set[str]:
        """Local names bound from obs/ledger modules: both
        ``from ...obs.ledger import get_ledger`` targets and
        ``import ...obs.ledger as l`` aliases."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if _is_ledger_module(node.module or ""):
                    for alias in node.names:
                        if alias.name != "*":
                            names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_ledger_module(alias.name):
                        names.add(alias.asname or alias.name.split(".")[0])
        return names

    # -- call classification ----------------------------------------------

    def _record_call(
        self, ctx: ModuleContext, node: ast.Call, ledger_names: Set[str]
    ) -> Optional[str]:
        """A human-readable description when this call records to the
        ledger (directly or one same-module hop away); else None."""
        direct = self._direct_record(node, ledger_names)
        if direct:
            return direct
        # One call hop: a captured scope calling a same-module helper that
        # records.
        if isinstance(node.func, ast.Name):
            for definition in ctx._defs_by_name.get(node.func.id, ()):
                for inner in ast.walk(definition):
                    if isinstance(inner, ast.Call):
                        hit = self._direct_record(inner, ledger_names)
                        if hit:
                            return f"{node.func.id}() reaches {hit}"
        return None

    def _direct_record(
        self, node: ast.Call, ledger_names: Set[str]
    ) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name):
            if (
                func.id in _RECORD_FUNCTIONS
                or (
                    func.id in ledger_names
                    and func.id != "get_ledger"
                    and func.id in _RECORD_FUNCTIONS | _RECORD_METHODS
                )
            ):
                return f"{func.id}(...)"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr not in _RECORD_METHODS and func.attr not in (
            _RECORD_FUNCTIONS
        ):
            return None
        if self._ledger_like(func.value, ledger_names):
            rname = dotted_name(func.value)
            if rname is None and isinstance(func.value, ast.Call):
                inner = dotted_name(func.value.func)
                rname = f"{inner}()" if inner else "<ledger>()"
            return f"{rname or '<ledger>'}.{func.attr}(...)"
        return None

    def _ledger_like(self, expr: ast.AST, ledger_names: Set[str]) -> bool:
        """Does this receiver expression denote the program ledger?"""
        if isinstance(expr, ast.Call):
            fname = dotted_name(expr.func) or ""
            if fname:
                parts = fname.split(".")
                # get_ledger() / obs.get_ledger() / l.get_ledger()
                if parts[-1] == "get_ledger" or parts[0] in ledger_names:
                    return True
            return False
        rname = dotted_name(expr)
        if rname is None:
            return False
        parts = rname.split(".")
        return (
            any("ledger" in p.lower() for p in parts)
            or parts[0] in ledger_names
        )
