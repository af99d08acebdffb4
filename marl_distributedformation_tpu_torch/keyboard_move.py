"""Keyboard teleop: the reference's ``python keyboard_move.py`` workflow
(keyboard_move.py:6-49) on the port.

    python -m marl_distributedformation_tpu_torch.keyboard_move device=cpu

N=3 agents; digit keys select an agent, arrow keys move it at speed 10,
ESC quits; every transition (action, obs, reward, done, info) is printed.
Keys arrive as matplotlib key events, so they go to the figure window
(click it first), where the reference's pynput listener was system-global.
Knobs: ``num_agents`` and ``device`` (``cuda`` unless ``device=cpu``) in
place of ``platform``. Needs matplotlib.
"""

from __future__ import annotations

import sys

import numpy as np

SPEED = 10.0  # keyboard_move.py:24
ARROWS = {"up": (0.0, SPEED), "down": (0.0, -SPEED),
          "left": (-SPEED, 0.0), "right": (SPEED, 0.0)}


def main(argv=None):
    """Open the teleop window; returns the ``FormationVecEnv`` it drives
    (``plt.show`` returns at once under a non-interactive backend)."""
    from marl_distributedformation_tpu_torch.utils.config import (
        Config,
        apply_overrides,
        refuse_jax_only,
    )

    cfg = Config(num_agents=3, device=None)
    apply_overrides(cfg, sys.argv[1:] if argv is None else argv)
    refuse_jax_only(cfg)
    num_agents = int(cfg.num_agents)

    from marl_distributedformation_tpu_torch.compat.render import (
        FormationRenderer,
        pyplot,
    )
    from marl_distributedformation_tpu_torch.compat.vec_env import (
        FormationVecEnv,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams

    plt = pyplot()
    params = EnvParams(num_agents=num_agents)
    env = FormationVecEnv(params, num_formations=1, device=cfg.device)
    env.reset()
    selected = {"agent": 0}

    renderer = FormationRenderer(params,
                                 title="teleop (0-9 select, arrows move)")
    renderer.update(env.agents_np(), env.goal_np(), env.obstacles_np())

    def on_key(event) -> None:
        key = event.key
        if key == "escape":
            plt.close("all")
            return
        if key is not None and key.isdigit() and int(key) < num_agents:
            selected["agent"] = int(key)
            print(f"Moving agent {selected['agent']} from next move...")
            return
        if key not in ARROWS:
            return
        action = np.zeros((num_agents, 2), np.float32)
        action[selected["agent"]] = ARROWS[key]
        obs, rewards, done, info = env.step_velocities(action[None])
        renderer.update(env.agents_np(), env.goal_np(), env.obstacles_np())
        renderer.draw()
        print("-" * 10)
        print(f"{action=}\n{obs=}\n{rewards=}\n{done=}\n{info=}")

    renderer.fig.canvas.mpl_connect("key_press_event", on_key)
    print(f"Press 0-{num_agents - 1} to choose which agent to move.")
    print("Arrow keys move the selected agent; ESC exits.")
    print("(Keys go to the figure window — click the plot to focus it.)")
    plt.show()
    return env


if __name__ == "__main__":
    main()
