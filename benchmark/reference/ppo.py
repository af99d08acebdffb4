"""PPO training iterations in plain PyTorch: rollout, GAE, and epochs of
shuffled minibatch steps with SB3's clipped loss, optax's global-norm clip
and Adam.

``run`` either samples its own actions and permutations from a generator
(the reference put in the program's place: the control, and the planted
faults) or follows a ``Record`` of another run's sampled actions and
permutations, as a served model's reference follows its served tokens. A
record holds what the check compares: each iteration's rollout rows and
mean loss, Adam's first moment after the first iteration, the parameters
after the last, and the followed actions' standardised noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from benchmark.reference import env as ref_env
from benchmark.reference.policy import entropy, forward, log_prob

Tensor = torch.Tensor
B1, B2 = 0.9, 0.999
ROW_FIELDS = ("obs", "old_log_probs", "advantages", "returns")


@dataclasses.dataclass
class Record:
    actions: List[Tensor] = dataclasses.field(default_factory=list)
    perms: List[Tensor] = dataclasses.field(default_factory=list)
    rows: List[Dict[str, Tensor]] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    start: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    mu1: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    params: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    # (sum z, sum z^2, count) of each followed iteration's noise.
    noise: List[tuple] = dataclasses.field(default_factory=list)


def gae(rewards, values, dones, last_value, gamma, lam):
    """``(advantages, returns)``; a done step neither bootstraps nor
    carries the advantage."""
    nxt = torch.cat([values[1:], last_value[None]])
    live = 1.0 - dones
    delta = rewards + gamma * nxt * live - values
    adv = torch.zeros_like(values)
    carry = torch.zeros_like(last_value)
    for t in reversed(range(values.shape[0])):
        carry = delta[t] + gamma * lam * live[t] * carry
        adv[t] = carry
    return adv, adv + values


def _policy(params, config, obs, precision):
    """``forward`` on ``(M, N, obs_dim)``: whole formations for the GNN,
    agent rows for the MLP."""
    return forward(params, config["model"], obs, precision)


def _rows(x: Tensor, per_formation: bool) -> Tensor:
    """Time-major ``(T, M, N, ...)`` as the update's rows: formations
    ``(T*M, N, ...)`` for a per-formation model, else agents."""
    lead = 2 if per_formation else 3
    return x.reshape(-1, *x.shape[lead:])


def _adam(params, grads, mu, nu, count, lr, eps):
    for name, g in grads.items():
        mu[name].mul_(B1).add_(g * (1 - B1))
        nu[name].mul_(B2).add_(g * g * (1 - B2))
    bc1, bc2 = 1 - B1 ** count, 1 - B2 ** count
    with torch.no_grad():
        for name in grads:
            params[name] -= lr * (mu[name] / bc1) / (
                torch.sqrt(nu[name] / bc2) + eps)


def run(config: Dict, weights: Dict[str, Tensor], state: ref_env.State,
        iterations: int, follow: Optional[Record] = None,
        generator: Optional[torch.Generator] = None,
        precision: str = "float32", fault: Optional[str] = None) -> Record:
    """``iterations`` PPO iterations from ``weights`` and ``state`` (see
    the module docstring). ``fault`` plants one fault in a sampling run:
    ``"half_batch"`` (each minibatch's loss over its first half only),
    ``"altered_action"`` (one formation's first step moved by another
    action than the one recorded) or ``"noise_dropped"`` (every action the
    policy's mean, drawn without its noise)."""
    env, ppo, model = config["env"], config["ppo"], config["model"]
    per_formation = model["kind"] == "gnn"
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    rec = Record(start={k: v.detach().clone() for k, v in params.items()})
    count = 0
    n = env["num_agents"]
    obs = ref_env.observe(state.agents, state.goal, env)
    for it in range(iterations):
        # Rollout.
        buf = {k: [] for k in ("obs", "actions", "log_probs", "values",
                               "rewards", "dones")}
        zsum = zsq = 0.0
        with torch.no_grad():
            for t in range(ppo["n_steps"]):
                mean, log_std, value = _policy(params, config, obs,
                                               precision)
                if follow is None:
                    eps = torch.randn(mean.shape, generator=generator,
                                      device=mean.device)
                    if fault == "noise_dropped":
                        eps = torch.zeros_like(eps)
                    action = mean + torch.exp(log_std) * eps
                else:
                    action = follow.actions[it][t]
                    z = (action - mean) * torch.exp(-log_std)
                    zsum += float(z.double().sum())
                    zsq += float((z.double() ** 2).sum())
                vel = env["max_speed"] * action.clamp(-1.0, 1.0)
                if fault == "altered_action" and it == 0 and t == 0:
                    vel = vel.clone()
                    vel[0] = -vel[0]
                state, reward, done, _ = ref_env.step(state, vel, env)
                if bool(done.any()):
                    raise RuntimeError("a formation finished its episode "
                                       "inside the followed iterations")
                for k, v in (("obs", obs), ("actions", action),
                             ("log_probs", log_prob(action, mean, log_std)),
                             ("values", value), ("rewards", reward),
                             ("dones", done[:, None].expand_as(reward)
                              .to(reward.dtype))):
                    buf[k].append(v)
                obs = ref_env.observe(state.agents, state.goal, env)
            _, _, last_value = _policy(params, config, obs, precision)
            roll = {k: torch.stack(v) for k, v in buf.items()}
            adv, ret = gae(roll["rewards"], roll["values"], roll["dones"],
                           last_value, ppo["gamma"], ppo["gae_lambda"])
        rows = {
            "obs": _rows(roll["obs"], per_formation),
            "actions": _rows(roll["actions"], per_formation),
            "old_log_probs": _rows(roll["log_probs"], per_formation),
            "advantages": _rows(adv, per_formation),
            "returns": _rows(ret, per_formation),
        }
        total = rows["obs"].shape[0]
        batch = ppo["batch_size"] // n if per_formation else ppo["batch_size"]
        batch = max(1, min(batch, total))
        minibatches = total // batch
        if follow is None:
            perms = torch.stack([
                torch.randperm(total, generator=generator,
                               device=obs.device)[:minibatches * batch]
                for _ in range(ppo["n_epochs"])])
        else:
            perms = follow.perms[it]
        rec.actions.append(roll["actions"])
        rec.perms.append(perms)
        rec.rows.append({k: rows[k] for k in ROW_FIELDS})
        if follow is not None:
            size = roll["actions"].numel()
            rec.noise.append((zsum, zsq, size))
        # Update.
        epoch_means = []
        for e in range(ppo["n_epochs"]):
            losses = []
            for j in range(minibatches):
                idx = perms[e, j * batch:(j + 1) * batch]
                if fault == "half_batch":
                    idx = idx[:batch // 2]
                mb = {k: v[idx] for k, v in rows.items()}
                adv_mb = mb["advantages"]
                adv_mb = (adv_mb - adv_mb.mean()) / (
                    adv_mb.std(correction=1) + 1e-8)
                mean, log_std, value = _policy(params, config, mb["obs"],
                                               precision)
                logp = log_prob(mb["actions"], mean, log_std)
                ratio = torch.exp(logp - mb["old_log_probs"])
                clipped = ratio.clamp(1 - ppo["clip_range"],
                                      1 + ppo["clip_range"])
                pg = -torch.minimum(adv_mb * ratio, adv_mb * clipped).mean()
                vf = ((mb["returns"] - value) ** 2).mean()
                loss = (pg - ppo["ent_coef"] * entropy(log_std)
                        + ppo["vf_coef"] * vf)
                grads = torch.autograd.grad(loss, list(params.values()))
                with torch.no_grad():
                    norm = torch.sqrt(sum((g * g).sum() for g in grads))
                    cap = ppo["max_grad_norm"]
                    grads = [torch.where(norm < cap, g, g / norm * cap)
                             for g in grads]
                    count += 1
                    _adam(params, dict(zip(params, grads)), mu, nu, count,
                          ppo["learning_rate"], ppo["adam_eps"])
                losses.append(loss.detach())
            epoch_means.append(torch.stack(losses).mean())
        rec.losses.append(float(torch.stack(epoch_means).mean()))
        if it == 0:
            rec.mu1 = {k: v.clone() for k, v in mu.items()}
    rec.params = {k: v.detach().clone() for k, v in params.items()}
    return rec
