"""Parameters of the JAX package's models as the port's ``state_dict``.

The port names its layers as the flax modules do, so the mapping is by path:
``embed/kernel`` -> ``embed.weight``, ``actor/pi_0/bias`` -> ``actor.pi_0.bias``,
``log_std`` -> ``log_std``. A flax ``Dense`` kernel is ``(in, out)`` and a
``torch.nn.Linear`` weight ``(out, in)``, so kernels are transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# The flax layer names of each architecture, as the checkpoint records it.
LAYERS = {
    "MLPActorCritic": ("pi_", "vf_", "pi_head", "vf_head", "log_std"),
    "GNNActorCritic": ("embed", "msg_", "upd_", "actor", "critic", "log_std"),
}


def params_from_jax(
    tree: Mapping[str, Any], policy: str
) -> Dict[str, torch.Tensor]:
    """``state_dict`` for the port's ``policy`` model from the JAX package's
    parameters, given as nested dicts of numpy arrays (``{"params": ...}``
    or its inner dict)."""
    if policy not in LAYERS:
        raise ValueError(f"unknown policy {policy!r}; known: {sorted(LAYERS)}")
    if set(tree) == {"params"}:
        tree = tree["params"]
    for top in tree:
        if not top.startswith(LAYERS[policy]):
            raise ValueError(f"{policy} has no layer {top!r}")
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if name == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(arr.T.copy())
            else:
                out[f"{prefix}{name}"] = torch.from_numpy(arr)

    walk(tree, "")
    return out
