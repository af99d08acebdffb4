"""rpc-in-traced-scope: mesh and network round trips in a captured
scope.

The mesh control plane (``serving/mesh/``) is host-only by the same
contract as the tracer, the registry, the chaos plane and the ledger:
RPC calls (a coordinator round trip, a heartbeat, a raw socket or HTTP
request) live at host seams, never inside a body a ``PhaseGraph``
captures. There the call fires at the warm-up and the capture, never per
replay, and a dead peer holds the process-wide capture lock
(``train/capture.py``) for a network timeout.

Detection surfaces (the mesh RPC API and the stdlib network modules):

- bare calls to names imported from a mesh/rpc module or a network
  module (``socket``, ``http.client``, ``urllib.*``);
- any attribute call through a network-module alias
  (``socket.create_connection(...)``);
- method calls whose receiver chain names the mesh control plane
  (``coordinator.global_reload(...)``, ``self._mesh.heartbeat(...)``)
  with the method in the RPC set and the receiver looking mesh-like, so
  an unrelated ``registry.register(...)`` stays clean;
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

# Control-plane entry points on mesh handles (coordinator/agent/rpc).
_RPC_METHODS = frozenset({
    "rpc_call",
    "global_reload",
    "reload_pinned",
    "heartbeat",
    "register",
    "deregister",
    "prepare_global",
    "commit_prepared",
    "abort_prepared",
})
# Module-level callables that are an RPC/socket round trip by name.
_BARE_CALLS = frozenset({"rpc_call"})
# Module-path fragments that mark an import as the mesh RPC surface.
_MESH_MODULE_PARTS = frozenset({"mesh", "rpc"})
# Stdlib network modules: EVERY call through them is host IO.
_NET_MODULE_PARTS = frozenset({"socket", "urllib", "requests"})
_NET_MODULES = frozenset({"http.client", "http"})
# Receiver-chain fragments that make a method call look mesh-like.
_RECEIVER_PARTS = ("mesh", "coordinator", "rpc")


def _is_mesh_module(module: str) -> bool:
    return any(p in _MESH_MODULE_PARTS for p in module.split("."))


def _is_net_module(module: str) -> bool:
    return module in _NET_MODULES or any(
        p in _NET_MODULE_PARTS for p in module.split(".")
    )


class RpcInTracedScope(Rule):
    name = "rpc-in-traced-scope"
    default_severity = "error"
    description = (
        "mesh RPC / socket call reachable inside a captured scope (a "
        "PhaseGraph's fn) — the round trip fires at the warm-up and the "
        "capture, never per replay, and a dead peer holds the capture "
        "lock; keep coordinator/socket calls at the host dispatch seam"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        mesh_names, net_aliases = self._rpc_imports(ctx.tree)
        reported: Set[Tuple[int, int]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_traced_scope(node) is None:
                continue
            hit = self._rpc_call(ctx, node, mesh_names, net_aliases)
            if hit and (node.lineno, node.col_offset) not in reported:
                reported.add((node.lineno, node.col_offset))
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{hit} inside a captured scope does a network round trip "
                    "at the warm-up and the capture only (never per "
                    "replay) and can hold the capture lock on a dead peer "
                    "— the mesh control plane is host-side only; make the "
                    "call at the dispatch seam around the PhaseGraph call",
                )

    # -- import surface ---------------------------------------------------

    @staticmethod
    def _rpc_imports(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
        """``(mesh_names, net_aliases)``: local names bound from mesh
        RPC modules (callables AND module aliases), and module aliases
        of the stdlib network modules (any attribute call through one
        is host IO)."""
        mesh_names: Set[str] = set()
        net_aliases: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                module = node.module or ""
                if _is_mesh_module(module):
                    for alias in node.names:
                        if alias.name != "*":
                            mesh_names.add(alias.asname or alias.name)
                elif _is_net_module(module):
                    for alias in node.names:
                        if alias.name != "*":
                            # from urllib.request import urlopen —
                            # the bound name IS a network entry point.
                            mesh_names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_mesh_module(alias.name):
                        mesh_names.add(
                            alias.asname or alias.name.split(".")[0]
                        )
                    elif _is_net_module(alias.name):
                        net_aliases.add(
                            alias.asname or alias.name.split(".")[0]
                        )
        return mesh_names, net_aliases

    # -- call classification ----------------------------------------------

    def _rpc_call(
        self,
        ctx: ModuleContext,
        node: ast.Call,
        mesh_names: Set[str],
        net_aliases: Set[str],
    ) -> Optional[str]:
        direct = self._direct_rpc(node, mesh_names, net_aliases)
        if direct:
            return direct
        # One call hop: a captured scope calling a same-module helper
        # whose body does RPC.
        if isinstance(node.func, ast.Name):
            for definition in ctx._defs_by_name.get(node.func.id, ()):
                for inner in ast.walk(definition):
                    if isinstance(inner, ast.Call):
                        hit = self._direct_rpc(
                            inner, mesh_names, net_aliases
                        )
                        if hit:
                            return f"{node.func.id}() reaches {hit}"
        return None

    def _direct_rpc(
        self,
        node: ast.Call,
        mesh_names: Set[str],
        net_aliases: Set[str],
    ) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in _BARE_CALLS or func.id in mesh_names:
                return f"{func.id}(...)"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        rname = dotted_name(func.value)
        root = rname.split(".")[0] if rname else None
        # Any call through a network-module alias: socket.X(...),
        # urllib.request.urlopen(...).
        if root is not None and root in net_aliases:
            return f"{rname}.{func.attr}(...)"
        # mesh_module.rpc_call(...) via a module alias.
        if func.attr in _BARE_CALLS:
            if root is not None and root in mesh_names:
                return f"{rname}.{func.attr}(...)"
        if func.attr not in _RPC_METHODS:
            return None
        if self._mesh_like(func.value, mesh_names):
            if rname is None and isinstance(func.value, ast.Call):
                inner = dotted_name(func.value.func)
                rname = f"{inner}()" if inner else "<mesh>()"
            return f"{rname or '<mesh>'}.{func.attr}(...)"
        return None

    @staticmethod
    def _mesh_like(expr: ast.AST, mesh_names: Set[str]) -> bool:
        """Does this receiver denote the mesh control plane? Chains
        must look mesh-like (``mesh``/``coordinator``/``rpc`` in a
        part, or a root bound from a mesh import) before the
        method-name check applies — ``registry.register(...)`` on an
        unrelated object stays clean."""
        if isinstance(expr, ast.Call):
            fname = dotted_name(expr.func) or ""
            if fname:
                parts = [p.lower() for p in fname.split(".")]
                if parts[0] in mesh_names or any(
                    frag in p for p in parts for frag in _RECEIVER_PARTS
                ):
                    return True
            return False
        rname = dotted_name(expr)
        if rname is None:
            return False
        parts = [p.lower() for p in rname.split(".")]
        return parts[0] in mesh_names or any(
            frag in p for p in parts for frag in _RECEIVER_PARTS
        )
