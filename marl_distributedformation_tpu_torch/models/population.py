"""K actor-critics of one architecture as one model with stacked
parameters: the port's counterpart of ``jax.vmap`` over ``model.apply`` in
the JAX package's ``train/sweep.py``.

Each parameter is one leaf tensor of shape ``(K, ...)``, member i's at
index i (``torch.func.stack_module_state``), and a forward is
``torch.func.vmap`` of ``torch.func.functional_call`` over the member axis
on the architecture's own module, so a member's math is its single run's
and there is one model definition. Gradients come from ordinary autograd
on the stacked leaves: members are independent, so the gradient of the
sum of their losses is each member's own.

One layer is batched by hand: under ``vmap`` a dense layer becomes a
batched matmul, and autograd's weight gradient of a batched matmul is one
batched GEMM of K small ``(out, in)`` products over the whole minibatch
(65,200 rows for the GNN's message layer at ``gnn100``'s shape), which
cuBLAS runs on a few dozen CTAs without splitting the reduction.
``MemberLinear`` keeps the batched matmul for the forward and the input
gradient, and computes each member's weight gradient as its own GEMM, as
the single run does, so that cuBLAS splits its reduction.
The forward runs each layer once for all K members; for K > 1 that rounds
differently from a member's single run in the last bit. A population of
one runs no ``vmap``: ``PopulationModel.map`` calls the member's function
on member 0's slices of the stacked tensors, through the architecture's
own layers, so every op is the single run's call at the single run's
shapes and the run is the single run bitwise on any CPU (a batched call
at K = 1 reaches other MKL and ATen kernels on some CPUs: ROADMAP C9).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, stack_module_state, vmap
from torch.utils._pytree import tree_map

Tensor = torch.Tensor


class StackedLinear(torch.autograd.Function):
    """``x (K, X, in) @ weight (K, out, in)^T + bias (K, out)`` on the
    stacked tensors, with each member's weight gradient its own GEMM (see
    the module docstring)."""

    @staticmethod
    def forward(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
        y = torch.matmul(x, weight.transpose(1, 2))
        return y if bias is None else y + bias[:, None, :]

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, weight, bias = inputs
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None

    @staticmethod
    def backward(ctx, gy: Tensor):
        x, weight = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(gy, weight)
        if ctx.needs_input_grad[1]:
            gw = torch.stack([x[i].t().mm(gy[i]).t()
                              for i in range(x.shape[0])])
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum(1)
        return gx, gw, gb


class MemberLinear(torch.autograd.Function):
    """``F.linear`` of one member, whose batching over the members (its
    ``vmap`` rule) is ``StackedLinear``. Used only under ``vmap``."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
        return F.linear(x, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        raise RuntimeError("MemberLinear runs under torch.func.vmap only")

    @staticmethod
    def backward(ctx, gy: Tensor):
        raise RuntimeError("MemberLinear runs under torch.func.vmap only")

    @staticmethod
    def vmap(info, in_dims, x, weight, bias):
        k = info.batch_size

        def front(t: Tensor, dim: Optional[int]) -> Tensor:
            return t.movedim(dim, 0) if dim is not None else t.expand(
                k, *t.shape
            )

        x = front(x, in_dims[0])
        weight = front(weight, in_dims[1])
        if bias is not None:
            bias = front(bias, in_dims[2])
        lead = x.shape[1:-1]
        y = StackedLinear.apply(x.reshape(k, -1, x.shape[-1]), weight, bias)
        return y.reshape(k, *lead, y.shape[-1]), 0


class _MemberDense(nn.Linear):
    """A dense layer of the population's template (``MemberLinear``)."""

    def forward(self, x: Tensor) -> Tensor:
        return MemberLinear.apply(x, self.weight, self.bias)


def _member_template(module: nn.Module) -> nn.Module:
    """``module`` without storage, its dense layers made ``_MemberDense``
    (the same parameters under the same names)."""
    module = copy.deepcopy(module).to("meta")

    def swap(parent: nn.Module) -> None:
        for name, child in parent.named_children():
            if type(child) is nn.Linear:
                setattr(parent, name, _MemberDense(
                    child.in_features, child.out_features,
                    bias=child.bias is not None, device="meta",
                ))
            else:
                swap(child)

    swap(module)
    return module


class PopulationModel:
    """``models`` (one architecture, one instance a member) with their
    parameters stacked. ``params`` maps each parameter name to its ``(K,
    ...)`` leaf; the optimizer updates them in place."""

    def __init__(self, models: Sequence[nn.Module]) -> None:
        models = list(models)
        if not models:
            raise ValueError("a population needs at least one member")
        kinds = {type(m).__name__ for m in models}
        if len(kinds) != 1:
            raise ValueError(f"members of one population share an "
                             f"architecture, got {sorted(kinds)}")
        shapes = {tuple((n, tuple(p.shape)) for n, p in m.named_parameters())
                  for m in models}
        if len(shapes) != 1:
            raise ValueError("members of one population share their "
                             "parameter shapes")
        params, _ = stack_module_state(models)
        self.params: Dict[str, Tensor] = dict(params)
        # The architecture without storage: functional_call supplies the
        # parameters. A population of one keeps the plain layers (``map``).
        self.num_members = len(models)
        self.template = (_member_template(models[0]) if self.num_members > 1
                         else copy.deepcopy(models[0]).to("meta"))
        self.per_formation = bool(models[0].per_formation)
        self.policy = type(models[0]).__name__

    def named_parameters(self) -> Iterator[Tuple[str, Tensor]]:
        return iter(self.params.items())

    def to(self, device) -> "PopulationModel":
        """The stacked leaves moved to ``device`` (new leaves)."""
        self.params = {
            k: p.detach().to(device).requires_grad_(p.requires_grad)
            for k, p in self.params.items()
        }
        return self

    def member_call(self, params: Dict[str, Tensor], *args):
        """One member's forward with its ``params`` (inside ``map``)."""
        return functional_call(self.template, params, args)

    def map(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """``fn`` of one member over the member axis of its arguments and
        results: ``vmap(fn)``, or, for a population of one, ``fn`` itself
        on each tensor's slice 0 with its results' axis put back (see the
        module docstring)."""
        if self.num_members > 1:
            return vmap(fn)

        def one(*args):
            out = fn(*tree_map(lambda t: t[0] if isinstance(t, Tensor)
                               else t, args))
            return tree_map(lambda t: t.unsqueeze(0)
                            if isinstance(t, Tensor) else t, out)

        return one

    def __call__(self, obs: Tensor, *args) -> Tuple[Tensor, Tensor, Tensor]:
        """Every member on its own inputs: ``obs (K, ...)`` and any
        further per-member inputs -> ``(mean (K, ...), log_std (K,
        act_dim), value (K, ...))``."""
        return self.map(self.member_call)(self.params, obs, *args)

    def rollout_forward(
        self, obs: Tensor, mask: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """``collect_rollout``'s ``forward`` (``PopulationModel.
        rollout_forward``) over the members' formations in turn, ``obs
        (K*M, N, obs_dim)`` (and a per-formation model's agent ``mask
        (K*M, N)`` of padded formations): ``(mean (K*M, N, act_dim),
        log_std (K*M, 1, act_dim), value (K*M, N))``, each member's as
        ``algo.rollout.policy_forward`` computes it (whole formations for
        a per-formation model, agent rows otherwise)."""
        k = self.num_members
        km, n, d = obs.shape
        m = km // k
        x = obs.reshape(k, m, n, d)
        args = ()
        if mask is not None:
            if not self.per_formation:
                raise ValueError("an agent-factored model takes no agent "
                                 "mask")
            args = (mask.reshape(k, m, n),)
        if not self.per_formation:
            x = x.reshape(k, m * n, d)
        mean, log_std, value = self(x, *args)
        a = mean.shape[-1]
        if k == 1:
            # The single run's shapes (``policy_forward``), so that the
            # rollout's draws and densities make its calls (C9).
            return (mean.reshape(km, n, a), log_std[0],
                    value.reshape(km, n))
        log_std = log_std[:, None, None, :].expand(k, m, 1, a)
        return (mean.reshape(km, n, a), log_std.reshape(km, 1, a),
                value.reshape(km, n))
