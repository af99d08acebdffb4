"""Baseline potential-field controller demo: the reference's ``python
simulate.py`` workflow (simulate.py:321-329) on the port.

    python -m marl_distributedformation_tpu_torch.simulate
    python -m marl_distributedformation_tpu_torch.simulate headless=true \\
        num_agents=5 steps=1100
    python -m marl_distributedformation_tpu_torch.simulate headless=true \\
        num_obstacles=4 obstacle_mode=fixed device=cpu

N=10 agents driven by the scripted controller (``env.baseline.control``)
for 1000 frames through a ``compat.FormationVecEnv`` of one formation,
with live rendering (matplotlib). Knobs as the root ``simulate.py``'s:
``num_agents``, ``steps``, ``seed``, ``num_obstacles``, ``obstacle_mode``
(the obstacle demo: the controller's repulsion against the box geometry
and the renderer's red-on-collision), ``headless=true`` to print metrics
every 100 steps instead of rendering (no matplotlib needed), and
``device`` (``cuda`` unless ``device=cpu``) in place of ``platform``.
"""

from __future__ import annotations

import sys
from typing import Dict, List


def main(argv=None) -> List[Dict[str, float]]:
    """Run the demo; headless, returns the printed rows (step, mean
    reward, ``avg_dist_to_goal``, ``std_dist_to_neighbor``)."""
    from marl_distributedformation_tpu_torch.utils.config import (
        Config,
        apply_overrides,
        refuse_jax_only,
    )

    cfg = Config(
        num_agents=10,
        steps=1000,
        headless=False,
        seed=0,
        device=None,
        num_obstacles=0,
        obstacle_mode="fixed",
    )
    apply_overrides(cfg, sys.argv[1:] if argv is None else argv)
    refuse_jax_only(cfg)
    steps = int(cfg.steps)

    from marl_distributedformation_tpu_torch.compat.render import obstacle_hits
    from marl_distributedformation_tpu_torch.compat.vec_env import (
        FormationVecEnv,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams, control

    params = EnvParams(
        num_agents=int(cfg.num_agents),
        num_obstacles=int(cfg.num_obstacles),
        obstacle_mode=str(cfg.obstacle_mode),
    )
    env = FormationVecEnv(params, num_formations=1, seed=int(cfg.seed),
                          device=cfg.device)
    env.reset()

    def controller_step():
        s = env.state
        vel = control(s.agents, s.goal, s.obstacles, params)
        _, rewards, _, _ = env.step_velocities(vel.cpu().numpy())
        return rewards

    if bool(cfg.headless):
        rows = []
        for t in range(steps):
            rewards = controller_step()
            if t % 100 == 0 or t == steps - 1:
                m = env.last_metrics
                rows.append({
                    "step": t, "reward": float(rewards.mean()),
                    "avg_dist_to_goal": m["avg_dist_to_goal"],
                    "std_dist_to_neighbor": m["std_dist_to_neighbor"],
                })
                extra = ""
                if params.num_obstacles > 0:
                    # Sampled at print time only: a host read every step
                    # would bind the demo to the copy's latency.
                    hits = int(obstacle_hits(
                        env.agents_np(), env.obstacles_np(), params).sum())
                    extra = f" obstacle_hits={hits}"
                print(
                    f"step {t:4d} reward={rewards.mean():8.3f} "
                    f"avg_dist_to_goal={m['avg_dist_to_goal']:7.2f} "
                    f"std_neighbor={m['std_dist_to_neighbor']:6.2f}"
                    + extra
                )
        return rows

    from marl_distributedformation_tpu_torch.compat.render import (
        FormationRenderer,
        pyplot,
    )

    plt = pyplot()
    import matplotlib.animation as animation

    renderer = FormationRenderer(params, title="baseline controller")

    def frame(i):
        controller_step()
        renderer.update(env.agents_np(), env.goal_np(), env.obstacles_np())

    ani = animation.FuncAnimation(  # noqa: F841 (kept alive for the show loop)
        renderer.fig, frame, frames=range(steps), interval=1
    )
    plt.show()
    return []


if __name__ == "__main__":
    main()
