"""Trained-policy playback: the reference's ``python visualize_policy.py
name=x`` workflow (visualize_policy.py:11-48) on the port.

    python -m marl_distributedformation_tpu_torch.visualize_policy name=x
    python -m marl_distributedformation_tpu_torch.visualize_policy \\
        name=gnn100 policy=gnn obs_mode=knn num_agents_per_formation=100 \\
        headless=true steps=1003

Finds the newest ``rl_model_*_steps.msgpack`` under ``logs/{name}/`` (for
a population, the ranked-best member of ``sweep_summary.json``, or the
furthest-trained ``seed{i}`` member when the summary or its member's
checkpoint is missing), loads it (``compat.LoadedPolicy``), and plays one
formation (``num_formation`` is forced to 1) through a
``compat.FormationVecEnv``, printing every transition. With
``obs_mode=knn`` on the card each step launches ``knn_fused`` once, at
``(1, N, k)``.

Knobs as the root ``visualize_policy.py``'s: ``headless=true`` plays
without a display, ``steps`` limits the horizon, ``deterministic=false``
samples actions as in training, ``gif=path`` records an animated gif
(``gif_every``, ``gif_fps``) instead of opening a window, and ``device``
(``cuda`` unless ``device=cpu``) in place of ``platform``. The display and
``gif`` need matplotlib; ``headless=true`` does not.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import Optional


def find_checkpoint(checkpoint_dir: Path) -> Optional[Path]:
    """The newest checkpoint of a run, or of a population's member: the
    best of ``sweep_summary.json``, else the furthest-trained ``seed{i}``
    (an interrupted population has members but no summary)."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
        latest_checkpoint,
    )

    path = latest_checkpoint(checkpoint_dir)
    if path is not None:
        return path
    summary = checkpoint_dir / "sweep_summary.json"
    if summary.exists():
        best = json.loads(summary.read_text())["best_dir"]
        path = latest_checkpoint(checkpoint_dir / best)
        if path is not None:
            print(f"sweep run: playing best member {best}")
            return path
        print(f"sweep summary points at {best} but it has no checkpoint; "
              "falling back to furthest-trained member")
    members = [p for p in checkpoint_dir.glob("seed*")
               if p.is_dir() and re.fullmatch(r"seed\d+", p.name)]
    candidates = [(latest_checkpoint(d), d.name) for d in members]
    candidates = [(p, n) for p, n in candidates if p is not None]
    if not candidates:
        return None
    path, member = max(candidates, key=lambda c: checkpoint_step(c[0]))
    why = ("best member missing" if summary.exists()
           else "no final summary (interrupted?)")
    print(f"sweep run, {why}: playing furthest-trained member {member}")
    return path


def main(argv=None) -> int:
    """Play the run's policy; returns the number of steps played."""
    from marl_distributedformation_tpu_torch.utils import config

    overrides = sys.argv[1:] if argv is None else list(argv)
    cfg = config.load_config(overrides)
    config.refuse_jax_only(cfg, config.read_yaml("cfg/config.yaml"))

    checkpoint_dir = config.repo_root() / "logs" / str(cfg.name)
    path = find_checkpoint(checkpoint_dir)
    if path is None:
        raise SystemExit(
            f"no rl_model_*_steps checkpoint found in {checkpoint_dir} — "
            f"train first: python -m marl_distributedformation_tpu_torch."
            f"train name={cfg.name}"
        )
    cfg.num_formation = 1  # visualize_policy.py:36
    params = config.env_params_from_config(cfg)

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.compat.vec_env import (
        FormationVecEnv,
    )

    device = cfg.get("device")
    print(f"Loading model from {path}")  # visualize_policy.py:33
    policy = LoadedPolicy.from_checkpoint(path, env_params=params,
                                          device=device)
    env = FormationVecEnv(params, num_formations=1,
                          seed=int(cfg.get("seed", 0)), device=device)
    obs = env.reset()

    steps = int(cfg.get("steps", 1000))
    headless = bool(cfg.get("headless", False))
    gif = cfg.get("gif")
    quiet = bool(gif)  # a recording skips the per-step transition dump
    # deterministic=false plays the policy as it acts in training, its
    # actions sampled; the default is the reference's
    # model.predict(deterministic=True) (visualize_policy.py:16).
    deterministic = bool(cfg.get("deterministic", True))

    def playback_step(i, obs):
        if not quiet:
            print("-" * 10)
            print(f"Step {i}")
        actions, _ = policy.predict(obs, deterministic=deterministic)
        obs, rewards, dones, _ = env.step(actions)
        if not quiet:
            print(f"actions: {actions}")
            print(f"obs: {obs}")
            print(f"rewards: {rewards}")
            print(f"dones: {dones}")
        return obs

    if headless and not gif:
        for i in range(steps):
            obs = playback_step(i, obs)
        return steps

    from marl_distributedformation_tpu_torch.compat.render import (
        FormationRenderer,
        pyplot,
    )

    if gif:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib.animation import PillowWriter

        every = int(cfg.get("gif_every", 5))
        renderer = FormationRenderer(params, title=f"policy: {path.name}")
        writer = PillowWriter(fps=int(cfg.get("gif_fps", 20)))
        with writer.saving(renderer.fig, str(gif), dpi=60):
            for i in range(steps):
                obs = playback_step(i, obs)
                if i % every == 0:
                    renderer.update(
                        env.agents_np(), env.goal_np(), env.obstacles_np()
                    )
                    writer.grab_frame()
        print(f"wrote {steps // every} frames to {gif}")
        return steps

    plt = pyplot()
    import matplotlib.animation as animation

    renderer = FormationRenderer(params, title=f"policy: {path.name}")
    obs_holder = [obs]

    def frame(i):
        obs_holder[0] = playback_step(i, obs_holder[0])
        renderer.update(env.agents_np(), env.goal_np(), env.obstacles_np())

    ani = animation.FuncAnimation(  # noqa: F841 (kept alive for the show loop)
        renderer.fig, frame, frames=range(steps), interval=200
    )
    plt.show()
    return steps


if __name__ == "__main__":
    main()
