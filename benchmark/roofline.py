"""The yardstick's arithmetic: the card's peaks, the k-NN search's least
time, and the policies' matmul FLOPs, all from shapes.

The numbers are frozen here so that a change to the program cannot move
them. Peaks are NVIDIA's published figures for one H100 SXM at 700 W; the
program keeps TF32 off, so float32 matmuls run off the tensor cores and the
compute peak is the float32 one.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Operations a candidate pair of the k-NN search: two differences, two
# products, a sum and a comparison.
KNN_OPS_PER_PAIR = 6
# Bytes a neighbor written: index, offset (two floats) and distance.
KNN_OUT_BYTES_PER_NEIGHBOR = 16
POINT_BYTES = 8  # one (x, y) float32 point


def knn_bound_s(m: int, n: int, k: int, with_valid: bool = False
                ) -> Tuple[float, str]:
    """Least seconds of one search over ``m`` formations of ``n`` points
    for ``k`` neighbors each: every input byte read once and every output
    byte written once against ``m * n * (n - 1)`` candidate pairs; returns
    the bound and what sets it (``"bytes"`` or ``"operations"``)."""
    nbytes = (m * n * POINT_BYTES + (m * n if with_valid else 0)
              + m * n * k * KNN_OUT_BYTES_PER_NEIGHBOR)
    ops = m * n * (n - 1) * KNN_OPS_PER_PAIR
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def dense_flops(widths: Sequence[int]) -> int:
    """Multiply-add FLOPs (2 a product) of a chain of dense layers with
    these widths, input first, for one row."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def gnn_forward_flops(model: Dict, critic: bool = True) -> int:
    """Matmul FLOPs of one agent's forward through the GNN actor-critic:
    the node embedding, each round's message over its ``k`` neighbors and
    its update, the actor tower and (with ``critic``) the pooled critic
    tower."""
    k, e, msg = model["knn_k"], model["embed_dim"], model["msg_dim"]
    node = 4 if model["goal_in_obs"] else 2
    hidden = list(model["hidden"])
    act = model["act_dim"]
    rounds = model["rounds"]
    per_round = k * 2 * (2 * e + 3) * msg + 2 * (e + msg + node) * e
    return (2 * node * e + rounds * per_round
            + dense_flops([e, *hidden, act])
            + (dense_flops([2 * e, *hidden, 1]) if critic else 0))


def mlp_forward_flops(model: Dict, critic: bool = True) -> int:
    """Matmul FLOPs of one agent's forward through the MLP actor-critic:
    the policy tower and head and (with ``critic``) the value tower and
    head."""
    hidden = list(model["hidden"])
    obs = model["obs_dim"]
    return (dense_flops([obs, *hidden, model["act_dim"]])
            + (dense_flops([obs, *hidden, 1]) if critic else 0))


def forward_flops(model: Dict, critic: bool = True) -> int:
    """Matmul FLOPs of one agent's forward through ``model`` (a
    configuration's ``model`` entry); without ``critic``, of the action
    alone, which is all that evaluation needs."""
    kinds = {"gnn": gnn_forward_flops, "mlp": mlp_forward_flops}
    return kinds[model["kind"]](model, critic)


def update_rows(config: Dict) -> Tuple[int, int, int]:
    """``(rows, minibatch rows, minibatches)`` of one PPO update: the rows
    are agent-transitions, or whole formations for a per-formation model,
    whose minibatch is ``batch_size // N`` formations; the rollout's
    remainder past whole minibatches is dropped, as SB3's shuffled pass
    does not."""
    env, ppo = config["env"], config["ppo"]
    m, n = config["num_formations"], env["num_agents"]
    per_formation = config["model"]["kind"] == "gnn"
    rows = ppo["n_steps"] * m * (1 if per_formation else n)
    batch = ppo["batch_size"] // n if per_formation else ppo["batch_size"]
    batch = max(1, min(batch, rows))
    return rows, batch, rows // batch


def train_iteration_flops(config: Dict) -> int:
    """Matmul FLOPs of one training iteration: ``n_steps + 1`` forwards of
    every agent in the rollout (the last for the bootstrap value), and a
    forward and backward (three forwards' worth) of every agent the update
    uses, each epoch."""
    env, ppo = config["env"], config["ppo"]
    m, n = config["num_formations"], env["num_agents"]
    per_agent = forward_flops(config["model"])
    _, batch, minibatches = update_rows(config)
    used_agents = minibatches * batch * (
        n if config["model"]["kind"] == "gnn" else 1)
    rollout = (ppo["n_steps"] + 1) * m * n * per_agent
    update = 3 * ppo["n_epochs"] * used_agents * per_agent
    return rollout + update


def eval_step_flops(config: Dict, num_formations: int) -> int:
    """Matmul FLOPs of one evaluation step: one forward of every agent to
    its action (the value, which evaluation does not use, not counted)."""
    return (num_formations * config["env"]["num_agents"]
            * forward_flops(config["model"], critic=False))
