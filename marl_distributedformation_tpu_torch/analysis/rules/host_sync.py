"""host-sync-in-jit: a device->host synchronization in a captured scope.

``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` on a tensor,
``float()`` / ``int()`` / ``bool()`` of one, ``np.asarray()`` of one,
``.to("cpu")`` and ``torch.cuda.synchronize()`` (or a stream's or an
event's ``.synchronize()``) wait for the device. Inside a body that a
``PhaseGraph`` captures, a copy to the host is not allowed during the
capture (it raises, or the value read is the warm-up's), and the host
value it returns is frozen into the graph: every replay reuses it. On the
CPU (``capture=False``) the same body runs eagerly and nothing shows, so
no CPU test can see it. The tensor-only methods are flagged on any
receiver; the builtins and numpy only on a tensor (``linter`` taint). The
runtime complement is ``analysis.guards.no_host_transfers``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

_SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})
# Tensor methods that copy to the host, whatever the receiver.
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "__array__",
                           "synchronize"})
# The numpy spellings this rule owns; numpy-in-jit imports this set to
# stay out of the way (one defect must yield one report).
NUMPY_SYNC_SPELLINGS = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
)
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    for arg in (*node.args, *(k.value for k in node.keywords
                              if k.arg == "device")):
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return True
        if (isinstance(arg, ast.Call)
                and dotted_name(arg.func) == "torch.device" and arg.args
                and isinstance(arg.args[0], ast.Constant)
                and arg.args[0].value == "cpu"):
            return True
    return False


class HostSyncInJit(Rule):
    name = "host-sync-in-jit"
    default_severity = "error"
    description = (
        "device->host sync (.item()/.cpu()/float()/np.asarray()/"
        "torch.cuda.synchronize) inside a captured scope (a PhaseGraph's "
        "fn) — not allowed in a capture, and its value is frozen into the "
        "graph"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for root in ctx.traced_roots:
            taint = ctx.taint_for(root)
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                hit = self._spelling(ctx, node, taint)
                if hit:
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"{hit} forces a device->host sync inside a "
                        "captured scope (a PhaseGraph's fn): it fails the "
                        "capture or freezes the warm-up's value into "
                        "every replay, and the CPU never shows it — keep "
                        "the value on the device and read it at the drain",
                    )

    @staticmethod
    def _spelling(ctx: ModuleContext, node: ast.Call, taint) -> str:
        fname = dotted_name(node.func)
        if fname in _SYNC_CALLS:
            return f"{fname}()"
        if fname in NUMPY_SYNC_SPELLINGS and any(
            ctx.expr_tainted(a, taint) for a in node.args
        ):
            return f"{fname}(...)"
        if (
            isinstance(node.func, ast.Name)
            and node.func.id in _SYNC_BUILTINS
            and node.args
            and any(ctx.expr_tainted(a, taint) for a in node.args)
        ):
            return f"{node.func.id}(...)"
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and not node.args
        ):
            return f".{node.func.attr}()"
        if _to_host(node):
            return '.to("cpu")'
        return ""
