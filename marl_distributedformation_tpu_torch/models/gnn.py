"""Graph-network actor-critic over the k-NN observation graph.

Counterpart of the JAX package's ``models/gnn.py`` (BASELINE config 4): node
embeddings, ``rounds`` of message passing over each agent's k nearest
neighbors (the neighbor indices ride in the observation as float32), a
per-agent actor head and a pooled (CTDE) critic. Inputs are per formation,
``obs (M, N, obs_dim)``.

Building ``msg_in`` materialises ``(M, N, k, 2E+3)`` float32 per round, about
0.86 GB at M=4096, N=100, k=4 — the plain form, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from marl_distributedformation_tpu_torch.models.common import (
    HIDDEN_GAIN,
    PolicyHead,
    PooledValueHead,
    dense,
)


def parse_knn_obs(
    obs: torch.Tensor, k: int, goal_in_obs: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split a ``compute_obs_knn`` observation ``(..., N, 2+3k[+2]+k)`` into
    node features ``(..., N, 2[+2])``, edge features ``(..., N, k, 3)``
    (offset, dist) and int64 neighbor indices ``(..., N, k)`` in ``[0,
    N-1]``.

    The index columns are read as the JAX package reads them (sensor noise
    can push them out of range): truncated toward zero as ``astype(int32)``
    converts them, NaN to 0, and an index in ``[-N, -1]`` counts from the
    end, as ``jnp.take_along_axis`` reads it. For an index outside ``[-N,
    N-1]`` JAX gathers a NaN row (``take_along_axis``'s fill), so that
    neighbor's message is NaN; here its distance is NaN instead, which
    makes the same message NaN (a NaN anywhere in a dense layer's input
    row makes every output NaN), and its index is clamped into range, so
    that ``torch.gather`` neither raises on the CPU nor asserts on the
    card, without copying the node embeddings every round."""
    own = obs[..., :2]
    offsets = obs[..., 2 : 2 + 2 * k]
    dists = obs[..., 2 + 2 * k : 2 + 3 * k]
    node_parts = [own]
    if goal_in_obs:
        node_parts.append(obs[..., 2 + 3 * k : 4 + 3 * k])
    n = obs.shape[-2]
    # Clamped one past either end: out of range stays out of range.
    idx = torch.nan_to_num(obs[..., -k:], nan=0.0).clamp(-(n + 1), n)
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    dists = torch.where(valid, dists, float("nan"))
    edge = torch.cat(
        [offsets.reshape(*offsets.shape[:-1], k, 2), dists[..., None]], dim=-1
    )
    return torch.cat(node_parts, dim=-1), edge, idx


def gather_nodes(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h (..., N, E)``, int64 ``idx (..., N, k)`` -> neighbor embeddings
    ``(..., N, k, E)`` by one ``torch.gather`` on the node axis."""
    n, k = idx.shape[-2], idx.shape[-1]
    e = h.shape[-1]
    flat = idx.reshape(*idx.shape[:-2], n * k, 1).expand(
        *idx.shape[:-2], n * k, e
    )
    return torch.gather(h, -2, flat).reshape(*idx.shape[:-2], n, k, e)


class GNNActorCritic(nn.Module):
    """``forward(obs (..., N, obs_dim), mask=None) -> (mean, log_std,
    value)``. ``mask (..., N)`` marks valid agents of padded formations:
    messages from padded neighbors are zeroed, padded agents leave the
    critic pool, and their values are 0."""

    per_formation = True

    def __init__(
        self,
        k: int,
        act_dim: int = 2,
        embed_dim: int = 64,
        msg_dim: int = 64,
        rounds: int = 2,
        hidden: Sequence[int] = (64,),
        goal_in_obs: bool = True,
        log_std_init: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.k = k
        self.goal_in_obs = goal_in_obs
        self.rounds = rounds
        node_dim = 4 if goal_in_obs else 2
        self.embed = dense(node_dim, embed_dim, HIDDEN_GAIN, generator)
        for r in range(rounds):
            self.add_module(
                f"msg_{r}",
                dense(2 * embed_dim + 3, msg_dim, HIDDEN_GAIN, generator),
            )
            self.add_module(
                f"upd_{r}",
                dense(embed_dim + msg_dim + node_dim, embed_dim, HIDDEN_GAIN,
                      generator),
            )
        self.actor = PolicyHead(embed_dim, act_dim, hidden, generator)
        self.critic = PooledValueHead(embed_dim, hidden, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(log_std_init)))

    def forward(
        self, obs: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        node, edge, idx = parse_knn_obs(obs, self.k, self.goal_in_obs)
        h = torch.tanh(self.embed(node))
        if mask is not None:
            nb_valid = gather_nodes(mask.to(h.dtype)[..., None], idx)
        for r in range(self.rounds):
            h_nb = gather_nodes(h, idx)  # (..., N, k, E)
            h_self = h[..., :, None, :].expand_as(h_nb)
            msg_in = torch.cat([h_self, h_nb, edge], dim=-1)
            msg = torch.tanh(getattr(self, f"msg_{r}")(msg_in))
            if mask is not None:
                msg = msg * nb_valid
                agg = msg.sum(dim=-2) / torch.clamp_min(nb_valid.sum(dim=-2), 1.0)
            else:
                agg = msg.mean(dim=-2)
            upd = torch.tanh(
                getattr(self, f"upd_{r}")(torch.cat([h, agg, node], dim=-1))
            )
            h = h + upd  # residual: round r refines round r-1
        mean = self.actor(h)
        value = self.critic(h, mask)
        return mean, self.log_std, value
