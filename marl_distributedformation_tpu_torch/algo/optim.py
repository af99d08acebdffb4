"""SB3's clipped Adam, written as plain functions on tensors.

Counterpart of the JAX package's optimizer, ``optax.chain(
clip_by_global_norm(max_grad_norm), adam(lr, eps=adam_eps))``
(``algo/ppo.py::PPOConfig.make_optimizer``), with optax's rules and rounding:

- the global norm is ``sqrt(sum of sum(g*g))`` over every gradient;
- gradients pass as they are when ``norm < max_norm``, else become
  ``(g / norm) * max_norm``, chosen on the device;
- ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g*g + b2*nu``, ``count += 1``;
- ``u = mu_hat / (sqrt(nu_hat) + eps)`` with ``mu_hat = mu / (1 - b1**count)``
  and ``nu_hat = nu / (1 - b2**count)``;
- ``p = p + (-lr * u)``, with ``lr`` a float or a 0-d tensor (the trainer
  keeps it on the device, so that a captured step reads its current value).

``torch.optim.Adam`` rounds ``sqrt(nu)/sqrt(bc2)`` where optax rounds
``sqrt(nu/bc2)``, and ``torch.nn.utils.clip_grad_norm_`` scales by
``max/(norm+1e-6)`` even below the limit, so neither is used. Nothing here
reads a value back to the host. The state is ``{count, mu, nu}`` with ``mu``
and ``nu`` keyed by parameter name, which ``compat.convert`` maps 1:1 onto
a checkpoint's ``opt_state/1/0/{count,mu,nu}``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor

B1 = 0.9
B2 = 0.999


@dataclasses.dataclass
class AdamState:
    """``count`` is a 0-d int32 tensor; ``mu`` and ``nu`` map each parameter
    name to a tensor of its shape, in the model's parameter order."""

    count: Tensor
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


def adam_init(params: Mapping[str, Tensor]) -> AdamState:
    """Zero moments and a zero count on the parameters' device."""
    device = next(iter(params.values())).device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
    )


def global_norm(
    grads: Sequence[Tensor], members: Optional[int] = None
) -> Tensor:
    """``sqrt(sum_i |g_i|^2)`` as a 0-d tensor, from one norm a tensor.
    With ``members`` K (tensors stacked ``(K, ...)``, a population's),
    ``(K,)``: each member's own, from the norms of its slices."""
    if members is None:
        norms = torch.stack(torch._foreach_norm(list(grads)))
        return torch.sqrt((norms * norms).sum())
    slices = [g[i] for i in range(members) for g in grads]
    norms = torch.stack(torch._foreach_norm(slices)).reshape(members, -1)
    return torch.sqrt((norms * norms).sum(1))


def clip_by_global_norm(
    grads: Sequence[Tensor], max_norm: float
) -> Tuple[List[Tensor], Tensor]:
    """optax's ``clip_by_global_norm``: ``(clipped grads, raw norm)``.

    The choice between ``g`` and ``(g / norm) * max_norm`` is made on the
    device as ``keep * g + (1 - keep) * scaled`` with ``keep`` exactly 0 or
    1, which equals ``torch.where`` bit for bit on finite gradients, in
    five launches for all the tensors."""
    grads = list(grads)
    norm = global_norm(grads)
    keep = (norm < max_norm).to(norm.dtype)
    scaled = torch._foreach_div(grads, norm)
    torch._foreach_mul_(scaled, max_norm)
    torch._foreach_mul_(scaled, 1.0 - keep)
    torch._foreach_add_(scaled, torch._foreach_mul(grads, keep))
    return scaled, norm


@torch.no_grad()
def adam_step(
    params: Sequence[Tensor],
    grads: Sequence[Tensor],
    state: AdamState,
    lr: Union[float, Tensor],
    eps: float,
) -> None:
    """One Adam step in place on ``params`` and ``state`` (optax ``adam``
    followed by ``apply_updates``)."""
    mu = list(state.mu.values())
    nu = list(state.nu.values())
    grads = list(grads)
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - B1))
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1.0 - B2)
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, g2)
    state.count.add_(1)
    count = state.count.to(torch.float32)
    # On the parameters' device: CUDA divides by a host scalar as a
    # multiplication by its reciprocal, which rounds differently.
    bc1 = 1.0 - torch.pow(B1, count)
    bc2 = 1.0 - torch.pow(B2, count)
    mu_hat = torch._foreach_div(mu, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, eps)
    updates = torch._foreach_div(mu_hat, den)
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(list(params), updates)


def population_adam_init(params: Mapping[str, Tensor]) -> AdamState:
    """``adam_init`` of a population's stacked ``(K, ...)`` parameters:
    zero moments of their shapes and one count a member ``(K,)``."""
    state = adam_init(params)
    k = next(iter(params.values())).shape[0]
    state.count = torch.zeros((k,), dtype=torch.int32,
                              device=state.count.device)
    return state


def member_views(
    params: Sequence[Tensor], state: AdamState
) -> Tuple[List[List[Tensor]], List[AdamState]]:
    """Member i's parameters and Adam state as views of a population's
    stacked tensors, for each i: what ``clipped_adam_step`` updates in
    place for one member. Made once; the views follow the storage."""
    k = state.count.shape[0]
    with torch.no_grad():
        views = [[p[i] for p in params] for i in range(k)]
        states = [
            AdamState(
                count=state.count[i],
                mu={n: t[i] for n, t in state.mu.items()},
                nu={n: t[i] for n, t in state.nu.items()},
            )
            for i in range(k)
        ]
    return views, states


def clipped_adam_step(
    params: Sequence[Tensor],
    grads: Sequence[Tensor],
    state: AdamState,
    lr: Union[float, Tensor],
    max_grad_norm: float,
    eps: float,
) -> Tensor:
    """``clip_by_global_norm`` then ``adam_step``; returns the raw
    (pre-clip) global gradient norm."""
    clipped, norm = clip_by_global_norm(grads, max_grad_norm)
    adam_step(params, clipped, state, lr, eps)
    return norm
