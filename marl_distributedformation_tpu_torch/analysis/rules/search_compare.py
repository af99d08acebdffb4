"""traced-python-comparison-in-search: a search loop in a captured scope
whose helper Python-branches on a comparison of its tensor arguments.

A Python ``for``/``while`` loop inside a body a ``PhaseGraph`` captures is
unrolled into the graph at the capture. A selection helper it calls,
``if cand > best: return cand``, lives at module level, so it is not a
captured scope of its own and the control-flow rule never walks it: the
comparison syncs the device (which the capture does not allow) and the
branch the capture took is replayed forever. This rule follows the
plain-name call through the call graph (``analysis/callgraph.py``) and
reports at the CALL site; the fix is ``torch.where`` /
``torch.maximum``, which keep the selection on the device. Helpers
branching on host values (config flags, literal-default params,
``is None``, ``.shape``) stay clean through the taint engine's static
rules; comparisons written in the captured body itself are the
control-flow rule's report (which also reports the helper's branch, at
its own line, when the call graph's captured closure reaches it); host
search loops that drain fitness to numpy first
(``scenarios/adversary.py``) are untouched.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis import callgraph
from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
)


def _branching_pred(
    func: "callgraph.FuncInfo", owner_ctx: ModuleContext
) -> Optional[str]:
    """Does this function Python-branch on a comparison of its own
    (presumed tensor) parameters? A body a PhaseGraph captures itself
    answers no: its branches are the control-flow rule's report."""
    node = func.node
    if isinstance(node, ast.Lambda) or node in owner_ctx.local_scopes:
        return None
    taint = ModuleContext._param_names(node)
    for inner in ast.walk(node):
        if not isinstance(inner, (ast.If, ast.IfExp, ast.While)):
            continue
        for cmp_node in ast.walk(inner.test):
            if isinstance(cmp_node, ast.Compare) and owner_ctx.expr_tainted(
                cmp_node, taint
            ):
                return f"{func.qualname} (line {inner.lineno})"
    return None


class TracedComparisonInSearch(Rule):
    name = "traced-python-comparison-in-search"
    default_severity = "error"
    description = (
        "a search loop in a captured scope calls a helper that "
        "Python-branches on a comparison of its tensor arguments — a sync "
        "the capture does not allow, its branch replayed forever; select "
        "with torch.where instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        reported: Set[Tuple[int, int]] = set()
        for site in self._search_sites(ctx):
            for node in ast.walk(site):
                if not isinstance(node, ast.Call) or not isinstance(
                    node.func, ast.Name
                ):
                    continue
                hit = callgraph.reachable_function(
                    ctx, node, _branching_pred
                )
                if hit is None:
                    continue
                if (node.lineno, node.col_offset) in reported:
                    continue
                reported.add((node.lineno, node.col_offset))
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{node.func.id}() is called from a search loop in a "
                    f"captured scope and reaches a Python branch on a "
                    f"comparison of tensor arguments in {hit.matched} — "
                    "the capture's branch is replayed forever; return "
                    "torch.where(cmp, a, b) so the selection stays on the "
                    "device",
                )

    @staticmethod
    def _search_sites(ctx: ModuleContext) -> List[ast.AST]:
        """Host ``for``/``while`` loops inside a captured scope."""
        return [
            node for node in ast.walk(ctx.tree)
            if isinstance(node, (ast.For, ast.While))
            and ctx._has_traced_ancestor(node)
        ]
