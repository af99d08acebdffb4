"""Parameters and Adam state between the JAX package's trees and the port.

The port names its layers as the flax modules do, so the mapping is by path:
``embed/kernel`` <-> ``embed.weight``, ``actor/pi_0/bias`` <->
``actor.pi_0.bias``, ``log_std`` <-> ``log_std``. A flax ``Dense`` kernel is
``(in, out)`` and a ``torch.nn.Linear`` weight ``(out, in)``, so kernels are
transposed. The optimizer state is optax's
``chain(clip_by_global_norm, adam)`` tree, ``{0: {}, 1: {0: {count, mu,
nu}, 1: {}}}`` with ``mu`` and ``nu`` shaped like ``{"params": ...}``; the
port's side of it is a plain ``{"count", "mu", "nu"}`` dict, with ``mu`` and
``nu`` keyed by parameter name (the fields of ``algo.optim.AdamState``).
With the learning rate in the optimizer state (the recovery ladder's
backoff), the tree is optax's ``inject_hyperparams(adam)`` layout,
``{0: {}, 1: {count, hyperparams, hyperparams_states, inner_state: {0: {count,
mu, nu}, 1: {}}}}``, as the JAX trainer builds it with
``recovery_lr_backoff != 1``.

A population's trees (the JAX package's ``train/sweep.py``, ``jax.vmap``
over the member axis) carry a leading member axis on every leaf: kernels
swap their last two axes, and the Adam ``count`` and the injected
hyperparameters are ``(K,)``. ``member_slice`` cuts one member's tree out
of such a tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

# The flax layer names of each architecture, as the checkpoint records it.
LAYERS = {
    "MLPActorCritic": ("pi_", "vf_", "pi_head", "vf_head", "log_std"),
    "CTDEActorCritic": ("actor", "vf_embed", "critic", "log_std"),
    "GNNActorCritic": ("embed", "msg_", "upd_", "actor", "critic", "log_std"),
}


def _check_layers(names, policy: str) -> None:
    if policy not in LAYERS:
        raise ValueError(f"unknown policy {policy!r}; known: {sorted(LAYERS)}")
    for top in names:
        if not top.startswith(LAYERS[policy]):
            raise ValueError(f"{policy} has no layer {top!r}")


def params_from_jax(
    tree: Mapping[str, Any], policy: str
) -> Dict[str, torch.Tensor]:
    """``state_dict`` for the port's ``policy`` model from the JAX package's
    parameters, given as nested dicts of numpy arrays (``{"params": ...}``
    or its inner dict)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    _check_layers(tree, policy)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if name == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(
                    np.swapaxes(arr, -1, -2).copy()
                )
            else:
                out[f"{prefix}{name}"] = torch.from_numpy(arr)

    walk(tree, "")
    return out


def _numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def params_to_jax(
    params: Mapping[str, Any], policy: str
) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: ``{"params": nested dicts of
    float32 numpy arrays}`` in the JAX package's layout, from tensors or
    numpy arrays."""
    _check_layers({name.split(".")[0] for name in params}, policy)
    inner: Dict[str, Any] = {}
    for name, value in params.items():
        *path, leaf = name.split(".")
        node = inner
        for part in path:
            node = node.setdefault(part, {})
        arr = _numpy(value).astype(np.float32)
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(np.swapaxes(arr, -1, -2))
        else:
            node[leaf] = arr
    return {"params": inner}


def inject_hyperparams(learning_rate: Any, eps: float) -> Dict[str, Any]:
    """The ``hyperparams`` of ``optax.inject_hyperparams(optax.adam)(
    learning_rate, eps=eps)``, float32 as optax keeps them; with one rate a
    member (``(K,)``), every entry ``(K,)``, as ``jax.vmap`` stacks them."""
    lr = np.asarray(learning_rate, np.float32)

    def full(value: float) -> np.ndarray:
        return np.full(lr.shape, value, np.float32)

    return {
        "b1": full(0.9), "b2": full(0.999), "eps": full(eps),
        "eps_root": full(0.0), "learning_rate": lr,
    }


def opt_state_to_jax(
    state: Mapping[str, Any],
    policy: str,
    hyperparams: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """optax's ``chain(clip_by_global_norm, adam)`` state tree from the
    port's ``{"count", "mu", "nu"}`` (tensors or numpy arrays); with
    ``hyperparams`` (``inject_hyperparams``), the ``inject_hyperparams``
    layout."""
    count = np.asarray(_numpy(state["count"]), np.int32)
    adam = {
        "count": count,
        "mu": params_to_jax(state["mu"], policy),
        "nu": params_to_jax(state["nu"], policy),
    }
    if hyperparams is None:
        return {"0": {}, "1": {"0": adam, "1": {}}}
    return {"0": {}, "1": {
        "count": count.copy(),
        "hyperparams": dict(hyperparams),
        "hyperparams_states": {},
        "inner_state": {"0": adam, "1": {}},
    }}


def opt_state_from_jax(
    tree: Mapping[str, Any], policy: str
) -> Dict[str, Any]:
    """The port's ``{"count", "mu", "nu"}`` on the CPU from optax's state
    tree as a checkpoint (or flax's ``to_state_dict``) holds it, either
    layout; from the ``inject_hyperparams`` layout also ``"learning_rate"``
    (a float; a ``(K,)`` tensor from a population's). Keys follow the
    parameters'."""
    outer = tree["1"]
    injected = "inner_state" in outer
    adam = outer["inner_state"]["0"] if injected else outer["0"]
    out = {
        "count": torch.from_numpy(np.array(adam["count"], dtype=np.int32)),
        "mu": params_from_jax(adam["mu"], policy),
        "nu": params_from_jax(adam["nu"], policy),
    }
    if injected:
        lr = np.array(outer["hyperparams"]["learning_rate"], np.float32)
        out["learning_rate"] = (
            float(lr) if lr.ndim == 0 else torch.from_numpy(lr)
        )
    return out


def member_slice(tree: Any, i: int) -> Any:
    """Member ``i``'s tree from a population's host tree: every array leaf
    indexed at ``i`` on its leading axis (owning copies), other leaves as
    they are."""
    if isinstance(tree, Mapping):
        return {k: member_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim > 0:
        return np.array(tree[i])
    return tree
