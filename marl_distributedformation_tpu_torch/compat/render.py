"""Matplotlib renderer for one formation — the reference's live view
(simulate.py:33-67): the world box, blue agent circles joined along the
ring, a red goal circle, green obstacle rectangles that turn red while an
agent is inside them (simulate.py:101-106).

Counterpart of the JAX package's ``compat/render.py``. ``obstacle_hits`` is
numpy; ``FormationRenderer`` imports matplotlib when it is built, so this
module imports without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from marl_distributedformation_tpu_torch.env import EnvParams


def obstacle_hits(
    agents: np.ndarray, obstacles: np.ndarray, params: EnvParams
) -> np.ndarray:
    """Per-obstacle collision flag ``(K,) bool``: any agent inside, in the
    env's containment geometry (``env/formation.py::_in_obstacle``, reduced
    per obstacle instead of per agent): ``parity`` the reference's
    lower-left-corner ``obstacle_size`` box (SURVEY.md Q2), ``fixed`` the
    centered ``2*obstacle_size`` box."""
    if obstacles.shape[0] == 0:
        return np.zeros((0,), dtype=bool)
    if params.obstacle_mode == "parity":
        lo = obstacles[:, None, :]
        hi = lo + params.obstacle_size
    else:  # "fixed"
        lo = obstacles[:, None, :] - params.obstacle_size
        hi = obstacles[:, None, :] + params.obstacle_size
    inside = (lo <= agents[None]) & (agents[None] <= hi)  # (K, N, 2)
    return inside.all(axis=-1).any(axis=1)


def pyplot():
    """``matplotlib.pyplot``, or an ``ImportError`` naming matplotlib."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "rendering needs the matplotlib package (run headless=true "
            "without it)"
        ) from e
    return plt


class FormationRenderer:
    def __init__(self, params: EnvParams, title: str = "") -> None:
        plt = pyplot()
        self.params = params
        self.fig = plt.figure(
            figsize=(params.width / 100, params.height / 100)
        )
        self.ax = self.fig.add_subplot(111)
        margin = 10  # simulate.py:37
        self.ax.set_xlim(-margin, params.width + margin)
        self.ax.set_ylim(-margin, params.height + margin)
        if title:
            self.ax.set_title(title)
        # World boundary (simulate.py:41).
        self.ax.plot(
            [0, params.width, params.width, 0, 0],
            [0, 0, params.height, params.height, 0],
            color="black",
        )

        self.agent_circles = []
        self.agent_lines = []
        for _ in range(params.num_agents):
            circle = plt.Circle((0, 0), radius=2, color="blue")
            self.agent_circles.append(circle)
            self.ax.add_artist(circle)
            line = plt.Line2D([0, 0], [0, 0], color="blue", linewidth=0.2)
            self.agent_lines.append(line)
            self.ax.add_artist(line)

        self.obstacle_rects = []
        for _ in range(params.num_obstacles):
            # A 2*obstacle_size box about the obstacle point
            # (simulate.py:55,129-130): the "fixed" collision geometry; in
            # "parity" mode collision deliberately differs (Q2).
            rect = plt.Rectangle(
                (0, 0),
                width=2 * params.obstacle_size,
                height=2 * params.obstacle_size,
                color="green",
            )
            self.obstacle_rects.append(rect)
            self.ax.add_artist(rect)

        self.goal_circle = plt.Circle((0, 0), radius=10, color="red")
        self.ax.add_artist(self.goal_circle)

    def update(
        self,
        agents: np.ndarray,
        goal: np.ndarray,
        obstacles: Optional[np.ndarray] = None,
    ) -> None:
        for pos, circle in zip(agents, self.agent_circles):
            circle.center = (pos[0], pos[1])
        ring = np.roll(agents, -1, axis=0)
        for pos, nxt, line in zip(agents, ring, self.agent_lines):
            line.set_data([pos[0], nxt[0]], [pos[1], nxt[1]])
        self.goal_circle.center = (goal[0], goal[1])
        if obstacles is not None and len(self.obstacle_rects) > 0:
            # Collision feedback (simulate.py:101-106).
            hits = obstacle_hits(
                np.asarray(agents), np.asarray(obstacles), self.params
            )
            for pos, hit, rect in zip(obstacles, hits, self.obstacle_rects):
                rect.xy = (
                    pos[0] - self.params.obstacle_size,
                    pos[1] - self.params.obstacle_size,
                )
                rect.set_color("red" if hit else "green")

    def draw(self) -> None:
        self.fig.canvas.draw_idle()
