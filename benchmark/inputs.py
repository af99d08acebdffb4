"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the policy's weights and the formations' start states,
made on the device by a generator there, in a few large draws."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from benchmark.reference.env import State
from benchmark.reference.policy import layer_shapes

Tensor = torch.Tensor


def stream(seed: int, tag: str, device) -> torch.Generator:
    """A generator on ``device`` for the ``tag`` stream of ``seed``, seeded
    from a hash of both: streams of one seed are independent, and any whole
    number is a seed."""
    digest = hashlib.blake2b(f"{int(seed)}:{tag}".encode(),
                             digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest, "little") >> 1)


def obs_dim(env: Dict) -> int:
    goal = 2 if env["goal_in_obs"] else 0
    if env["obs_mode"] == "knn":
        return 2 + 3 * env["knn_k"] + goal + env["knn_k"]
    return 6 + goal


def make_weights(config: Dict, seed: int, device) -> Dict[str, Tensor]:
    """Orthogonal weights with the program's gains, zero biases and
    ``log_std`` at ``log_std_init``: one normal draw for every matrix, then
    a QR decomposition each (``torch.nn.init.orthogonal_``'s rule)."""
    shapes = layer_shapes(config["model"], obs_dim(config["env"]))
    total = sum(o * i for (o, i), _ in shapes.values())
    gen = stream(seed, "weights", device)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, Tensor] = {}
    at = 0
    for name, ((rows, cols), gain) in shapes.items():
        a = flat[at:at + rows * cols].reshape(rows, cols)
        at += rows * cols
        if rows < cols:
            a = a.T
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        out[f"{name}.weight"] = (gain * q).contiguous()
        out[f"{name}.bias"] = torch.zeros(rows, device=device)
    act = config["model"]["act_dim"]
    out["log_std"] = torch.full((act,), float(config["ppo"]["log_std_init"]),
                                device=device)
    return out


def make_states(env: Dict, formations: int, seed: int, tag: str, device
                ) -> State:
    """Start states of ``formations`` formations, as the reference
    simulator resets them: agents uniform over the bottom
    ``agent_spawn_band`` of the world, the goal uniform inside a
    ``desired_radius`` margin, obstacles uniform over the middle band."""
    n, k = env["num_agents"], env["num_obstacles"]
    w, h = env["width"], env["height"]
    gen = stream(seed, tag, device)
    u = torch.rand(formations * (2 * n + 2 + 2 * k), generator=gen,
                   device=device)
    u_agents, u_goal, u_obs = torch.split(
        u, [formations * 2 * n, formations * 2, formations * 2 * k])

    def scale(x, lo, span):
        return (x * torch.tensor(span, device=device)
                + torch.tensor(lo, device=device))

    r, size, band = env["desired_radius"], env["obstacle_size"], \
        env["obstacle_margin_band"]
    agents = scale(u_agents.reshape(formations, n, 2), [0.0, 0.0],
                   [w, env["agent_spawn_band"]])
    goal = scale(u_goal.reshape(formations, 2), [r, r],
                 [w - 2 * r, h - 2 * r])
    obstacles = scale(u_obs.reshape(formations, k, 2), [size, band + size],
                      [w - 2 * size, h - 2 * band - 2 * size])
    steps = torch.zeros(formations, dtype=torch.int32, device=device)
    return State(agents, goal, obstacles, steps)
