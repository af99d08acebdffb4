"""The two actor-critics as plain functions of a dict of parameters.

Parameters are named as the program's modules name theirs, so that one
dict of seeded weights loads into both. ``precision="tf32"`` rounds both
operands of every matrix product (forward and backward) to TF32's ten
mantissa bits and accumulates in float32, as TF32 tensor cores do: the
control of the correctness check. ``"float32"`` is the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]
LOG_2PI = math.log(2.0 * math.pi)
HIDDEN_GAIN = math.sqrt(2.0)


def to_tf32(x: Tensor) -> Tensor:
    """``x`` rounded to the nearest TF32 value (ties to even), as float32."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = to_tf32(x), to_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.T + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = to_tf32(g)
        gx = gr @ wr
        gw = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        return gx, gw, g.reshape(-1, g.shape[-1]).sum(0)


def linear(p: Params, name: str, x: Tensor, precision: str) -> Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if precision == "tf32":
        return _TF32Linear.apply(x, w, b)
    return x @ w.T + b


def _tower(p: Params, prefix: str, depth: int, head: str, x: Tensor,
           precision: str) -> Tensor:
    for i in range(depth):
        x = torch.tanh(linear(p, f"{prefix}{i}", x, precision))
    return linear(p, head, x, precision)


def mlp_forward(p: Params, model: Dict, obs: Tensor, precision: str
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """``obs (..., obs_dim)`` -> ``(mean (..., act_dim), log_std, value
    (...))``: separate tanh towers for the policy and the value."""
    depth = len(model["hidden"])
    mean = _tower(p, "pi_", depth, "pi_head", obs, precision)
    value = _tower(p, "vf_", depth, "vf_head", obs, precision).squeeze(-1)
    return mean, p["log_std"], value


def gnn_forward(p: Params, model: Dict, obs: Tensor, precision: str
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """``obs (..., N, obs_dim)`` of k-NN observations -> ``(mean, log_std,
    value)``: a tanh node embedding, ``rounds`` residual rounds of messages
    from the k neighbors (self, neighbor and edge features through a tanh
    layer, averaged, then a tanh update of self, the mean and the node
    features), a tanh actor tower on each agent and a critic on each agent
    beside its formation's mean embedding."""
    k = model["knn_k"]
    own = obs[..., :2]
    offsets = obs[..., 2:2 + 2 * k]
    dists = obs[..., 2 + 2 * k:2 + 3 * k]
    parts = [own]
    if model["goal_in_obs"]:
        parts.append(obs[..., 2 + 3 * k:4 + 3 * k])
    node = torch.cat(parts, dim=-1)
    idx = obs[..., -k:].to(torch.int64)
    edge = torch.cat([offsets.reshape(*offsets.shape[:-1], k, 2),
                      dists[..., None]], dim=-1)
    h = torch.tanh(linear(p, "embed", node, precision))
    lead, n, e = h.shape[:-2], h.shape[-2], h.shape[-1]
    flat_idx = idx.reshape(*lead, n * k, 1).expand(*lead, n * k, e)
    for r in range(model["rounds"]):
        h_nb = torch.gather(h, -2, flat_idx).reshape(*lead, n, k, e)
        h_self = h[..., :, None, :].expand_as(h_nb)
        msg = torch.tanh(linear(p, f"msg_{r}",
                                torch.cat([h_self, h_nb, edge], dim=-1),
                                precision))
        agg = msg.mean(dim=-2)
        h = h + torch.tanh(linear(p, f"upd_{r}",
                                  torch.cat([h, agg, node], dim=-1),
                                  precision))
    depth = len(model["hidden"])
    mean = _tower(p, "actor.pi_", depth, "actor.pi_head", h, precision)
    pooled = h.mean(dim=-2, keepdim=True).expand_as(h)
    value = _tower(p, "critic.vf_", depth, "critic.vf_head",
                   torch.cat([h, pooled], dim=-1), precision).squeeze(-1)
    return mean, p["log_std"], value


def forward(p: Params, model: Dict, obs: Tensor, precision: str = "float32"
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(mean, log_std, value)`` of ``obs (M, N, obs_dim)`` (or flat
    agent rows for the MLP)."""
    kinds = {"gnn": gnn_forward, "mlp": mlp_forward}
    return kinds[model["kind"]](p, model, obs, precision)


def log_prob(actions: Tensor, mean: Tensor, log_std: Tensor) -> Tensor:
    """Diagonal Gaussian log density, summed over the action axis."""
    z = (actions - mean) * torch.exp(-log_std)
    return (-0.5 * (z * z + LOG_2PI) - log_std).sum(-1)


def entropy(log_std: Tensor) -> Tensor:
    return (log_std + 0.5 * (1.0 + LOG_2PI)).sum()


def layer_shapes(model: Dict, obs_dim: int) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """``{name: (weight shape (out, in), gain)}`` of every dense layer, in
    the program's parameter order; orthogonal gains sqrt(2) for hidden
    layers, 0.01 for the action head and 1 for the value head."""
    hidden, act = list(model["hidden"]), model["act_dim"]
    layers: Dict[str, Tuple[Tuple[int, ...], float]] = {}

    def tower(prefix: str, head: str, width: int, out: int, gain: float):
        for i, w in enumerate(hidden):
            layers[f"{prefix}{i}"] = ((w, width), HIDDEN_GAIN)
            width = w
        layers[head] = ((out, width), gain)

    if model["kind"] == "mlp":
        tower("pi_", "pi_head", obs_dim, act, 0.01)
        tower("vf_", "vf_head", obs_dim, 1, 1.0)
        return layers
    e, msg = model["embed_dim"], model["msg_dim"]
    node = 4 if model["goal_in_obs"] else 2
    layers["embed"] = ((e, node), HIDDEN_GAIN)
    for r in range(model["rounds"]):
        layers[f"msg_{r}"] = ((msg, 2 * e + 3), HIDDEN_GAIN)
        layers[f"upd_{r}"] = ((e, e + msg + node), HIDDEN_GAIN)
    tower("actor.pi_", "actor.pi_head", e, act, 0.01)
    tower("critic.vf_", "critic.vf_head", 2 * e, 1, 1.0)
    return layers
