"""device-put-in-dispatch-loop: a host->device placement per request in a
serving dispatch loop.

A serving engine captures each rung's act graph over static tensors and
swaps parameters by ``copy_`` into them at the batch barrier, once per
SWAP (``serving/engine.py``). Inside a host ``while``-loop body (the shape
of every serve/poll worker) a ``.to(device)`` re-uploads a tensor every
iteration, and a parameter ``copy_`` rewrites the weights every dispatch:
the per-request spelling of what must happen once per swap, which caps
throughput at the link rate. Flagged, directly or one plain-name call
hop (same module or imported) into a helper that does it:

- ``.to(...)`` with a device argument (a name or attribute chain ending
  in ``device``, a ``"cuda..."`` string, ``torch.device(...)``, or
  ``device=``), and ``.cuda()``;
- ``.copy_(...)`` on a receiver that names a parameter (``param`` in a
  part of its chain).

A copy to the host is the runtime guard's business (``no_host_transfers``),
and captured loops are the capture rules'.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis import callgraph
from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

_NAME_HOPS = frozenset({"local", "import"})


def _device_like(arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.startswith("cuda")
    if isinstance(arg, ast.Call):
        return dotted_name(arg.func) == "torch.device"
    name = dotted_name(arg)
    return bool(name) and name.rsplit(".", 1)[-1].endswith("device")


def _transfer_pred(node: ast.Call, fname) -> Optional[str]:
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    recv = dotted_name(node.func.value) or ""
    if attr == "cuda":
        return ".cuda"
    if attr == "to" and (
        any(_device_like(a) for a in node.args)
        or any(k.arg == "device" for k in node.keywords)
    ):
        return ".to(device)"
    if attr == "copy_" and any("param" in p.lower()
                               for p in recv.split(".")):
        return f"{recv}.copy_"
    return None


class DevicePutInDispatchLoop(Rule):
    name = "device-put-in-dispatch-loop"
    default_severity = "error"
    description = (
        ".to(device) or a parameter copy_ inside a while-loop dispatch "
        "body — a host->device upload per request; place the weights once "
        "at the swap/commit seam instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        reported: Set[Tuple[int, int]] = set()
        for loop in self._host_while_loops(ctx):
            for hit in self._scan_body(ctx, loop):
                if hit[:2] not in reported:
                    reported.add(hit[:2])
                    yield hit

    @staticmethod
    def _host_while_loops(ctx: ModuleContext) -> List[ast.While]:
        return [
            node
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.While)
            and not ctx._has_traced_ancestor(node)
        ]

    def _scan_body(
        self, ctx: ModuleContext, loop: ast.While
    ) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            direct = _transfer_pred(node, dotted_name(node.func))
            if direct:
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{direct}(...) inside a dispatch loop uploads to the "
                    "device every iteration — place the weights once at "
                    "the swap/commit seam and reuse the static tensors "
                    "per dispatch",
                )
            elif isinstance(node.func, ast.Name):
                hit = callgraph.reachable_call(
                    ctx, node, _transfer_pred, first_hops=_NAME_HOPS
                )
                if hit is not None:
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"{node.func.id}() is called from a dispatch "
                        f"loop and reaches {hit.matched}(...) — a "
                        "host->device upload every iteration; hoist the "
                        "placement out of the loop to the swap/commit "
                        "seam",
                    )
