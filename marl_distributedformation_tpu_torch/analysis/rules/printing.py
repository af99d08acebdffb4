"""print-in-jit: host printing and tensor formatting in a captured scope.

``print`` inside a body a ``PhaseGraph`` captures runs at the warm-up and
the capture only: it shows two lines for a phase that ran a thousand
times, and its absence on later calls reads as "the code stopped
running". Formatting a tensor into an f-string is the same bug in string
clothing, and worse on the card: ``format`` copies the tensor to the host
(a sync the capture does not allow). F-strings over host values (shapes in
error messages) stay allowed, as do ``assert``/``raise`` messages, which
only evaluate on the failure path.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
)


class PrintInJit(Rule):
    name = "print-in-jit"
    default_severity = "error"
    description = (
        "print / f-string of a tensor inside a captured scope (a "
        "PhaseGraph's fn) — runs at the warm-up and the capture only, and "
        "formatting a tensor syncs the device"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for root in ctx.traced_roots:
            taint = ctx.taint_for(root)
            for node in ast.walk(root):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                ):
                    yield (
                        node.lineno,
                        node.col_offset,
                        "print() inside a captured scope runs at the "
                        "warm-up and the capture only, never on a replay "
                        "— print drained values at the dispatch seam (or "
                        "drop it)",
                    )
                elif (
                    isinstance(node, ast.JoinedStr)
                    and not self._in_failure_path(ctx, node)
                    and any(
                        isinstance(v, ast.FormattedValue)
                        and ctx.expr_tainted(v.value, taint)
                        for v in node.values
                    )
                ):
                    yield (
                        node.lineno,
                        node.col_offset,
                        "f-string formats a tensor inside a captured scope "
                        "— a device->host copy the capture does not allow, "
                        "and the text is the warm-up's; format drained "
                        "values at the dispatch seam",
                    )

    @staticmethod
    def _in_failure_path(ctx: ModuleContext, node: ast.AST) -> bool:
        """F-strings in ``assert`` / ``raise`` messages only evaluate on
        the failure path."""
        cur = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = ctx.parents.get(cur)
        return isinstance(cur, (ast.Assert, ast.Raise))
