"""Drive the formation env in your own loop.

    python -m marl_distributedformation_tpu_torch.examples.functional_env
    python -m marl_distributedformation_tpu_torch.examples.functional_env \\
        device=cpu

The whole API a custom training loop, another RL algorithm or an embedding
needs is two functions over M formations at once:

    reset_fn()               -> (state, obs)
    step_fn(state, actions)  -> (state, transition)

Actions are in policy space ([-1, 1], scaled by ``max_speed`` inside);
``transition`` carries obs, reward, done and metrics with the auto-reset
applied (the SB3 VecEnv convention: a done row's obs is the next episode's
first). Here the scripted baseline controller drives 256 formations of 10
agents for 300 steps and the example asserts that they converge.
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> float:
    """Run the example; returns the final mean ``avg_dist_to_goal``."""
    import torch

    import marl_distributedformation_tpu_torch as mdf
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.env import control
    from marl_distributedformation_tpu_torch.utils.config import (
        Config,
        apply_overrides,
    )

    cfg = Config(device=None)
    apply_overrides(cfg, sys.argv[1:] if argv is None else argv)
    device = resolve_device(cfg.device)

    params = mdf.EnvParams(num_agents=10)
    m = 256
    generator = torch.Generator(device=device).manual_seed(0)
    reset_fn, step_fn = mdf.make_vec_env(params, num_formations=m,
                                         device=device, generator=generator)
    state, obs = reset_fn()

    # Any controller works here: a policy network, a scripted rule, your
    # own code. The scripted controller emits raw velocities (the L0
    # contract, SURVEY.md Q8); divide by max_speed for step_fn's policy
    # space.
    t0 = time.perf_counter()
    for t in range(300):
        vel = control(state.agents, state.goal, state.obstacles, params)
        state, tr = step_fn(state, vel / params.max_speed)
        if (t + 1) % 100 == 0:
            d = float(tr.metrics["avg_dist_to_goal"].mean())
            s = float(tr.metrics["ave_dist_to_neighbor"].mean())
            print(f"t={t + 1:3d}  avg_dist_to_goal={d:7.2f}  "
                  f"ave_dist_to_neighbor={s:6.2f}")
    final = float(tr.metrics["avg_dist_to_goal"].mean())
    dt = time.perf_counter() - t0
    print(f"{300 * m / dt:,.0f} formation-steps/s ({m} formations x "
          f"{params.num_agents} agents, scripted control, {device})")
    assert final < 100, f"formation failed to converge: {final}"
    print("converged: the ring formed around the goal")
    return final


if __name__ == "__main__":
    main()
