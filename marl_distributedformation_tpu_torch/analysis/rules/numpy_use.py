"""numpy-in-jit: host numpy applied to a tensor in a captured scope.

``np.*`` on host values inside a captured body is fine: it runs at the
warm-up and the capture and its result is a constant of the graph (the
idiomatic way to precompute a table). ``np.*`` on a *tensor* copies it to
the host (a sync the capture does not allow), and what it computes from
the warm-up's values is frozen into every replay. Flag numpy calls whose
arguments touch a tensor; the plain copies (``np.asarray`` /
``np.array``) are the host-sync-in-jit rule's.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)
from marl_distributedformation_tpu_torch.analysis.rules.host_sync import (
    NUMPY_SYNC_SPELLINGS,
)


class NumpyInJit(Rule):
    name = "numpy-in-jit"
    default_severity = "error"
    description = (
        "host numpy called on a tensor inside a captured scope (a "
        "PhaseGraph's fn) — a host copy the capture does not allow, its "
        "result frozen into every replay; use the torch equivalent"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for root in ctx.traced_roots:
            taint = ctx.taint_for(root)
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                fname = dotted_name(node.func)
                if not fname or fname.split(".", 1)[0] not in ("np",
                                                              "numpy"):
                    continue
                if fname in ("np", "numpy") or fname in NUMPY_SYNC_SPELLINGS:
                    continue
                args = [*node.args, *(k.value for k in node.keywords)]
                if any(ctx.expr_tainted(a, taint) for a in args):
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"{fname}(...) applied to a tensor inside a "
                        "captured scope — use the torch equivalent so it "
                        "runs on every replay",
                    )
