"""The environment contract: ``EnvSpec`` and the declared observation layout.

Counterpart of the JAX package's ``envs/spec.py``. An ``EnvSpec`` bundles an
environment's functions, one formation's and batched, with two pieces of
metadata the rest of the port keys on:

- ``params_cls``: the env's frozen params dataclass. Downstream code resolves
  the spec from the params it already holds (``registry.spec_for_params``).
- ``obs_layout(params) -> ObsLayout``: the per-agent observation layout as
  named column blocks (``self`` / ``neighbor`` / ``goal``) and the neighbor
  topology (``ring`` | ``knn``). Scenario layers that blank observation
  columns read the blocks from here and fail fast when a block they need is
  not declared, instead of masking the wrong columns.

The functions carry the port's signatures, with resets drawn from a
``torch.Generator`` where the JAX package's take a key:

- ``reset(params, generator, device) -> state``: one formation;
- ``step(state, velocity, params, generator, with_obs=True) -> (state,
  Transition)``: one formation, raw per-agent velocities ``(N, 2)``,
  auto-reset on done;
- ``reset_batch(params, M, generator, device) -> state`` and
  ``step_batch(state, velocity, params, generator)``: M formations, the
  forms every trainer and evaluation runs;
- ``obs(state, params) -> obs``, batched or one formation's.

``reset_env`` and ``step_env`` give the gym-flavored view of the
one-formation functions, with the JAX package's meaning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np

Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """Declared per-agent observation layout (static, hashable).

    ``blocks`` maps a block name to a tuple of half-open column ranges: one
    logical block may occupy disjoint ranges (the knn ``neighbor`` block is
    offsets and distances early in the row plus the trailing index block).
    """

    dim: int
    topology: str  # "ring" | "knn": how the neighbor block is built
    blocks: Tuple[Tuple[str, Ranges], ...]

    def __post_init__(self) -> None:
        assert self.topology in ("ring", "knn"), self.topology
        for name, ranges in self.blocks:
            for start, stop in ranges:
                assert 0 <= start <= stop <= self.dim, (
                    f"block {name!r} range ({start}, {stop}) outside "
                    f"obs dim {self.dim}"
                )

    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.blocks)

    def block(self, name: str) -> Ranges | None:
        for block_name, ranges in self.blocks:
            if block_name == name:
                return ranges
        return None

    def require(self, name: str, needed_by: str = "caller") -> Ranges:
        """The block's ranges; raises when the block is not declared."""
        ranges = self.block(name)
        if ranges is None:
            raise ValueError(
                f"{needed_by} needs obs block {name!r}, but this env's "
                f"declared layout only has: {', '.join(self.names())} — "
                "declare the block in the env's obs_layout or don't apply "
                "this layer to it"
            )
        return ranges

    def columns(self, *names: str, needed_by: str = "caller") -> np.ndarray:
        """Static ``(dim,)`` bool mask of the named blocks' columns (every
        name must be declared, see ``require``)."""
        cols = np.zeros((self.dim,), dtype=bool)
        for name in names:
            for start, stop in self.require(name, needed_by=needed_by):
                cols[start:stop] = True
        return cols


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """A registered environment: its functions and metadata (module
    doc). Frozen, so a spec hashes like the params it dispatches on."""

    name: str
    description: str
    params_cls: type
    reset: Callable[..., Any]  # (params, generator, device) -> state
    step: Callable[..., Any]  # (state, velocity, params, generator, with_obs)
    reset_batch: Callable[..., Any]  # (params, M, generator, device) -> state
    step_batch: Callable[..., Any]  # (state, velocity, params, generator)
    obs: Callable[..., Any]  # (state, params) -> obs
    obs_layout: Callable[..., ObsLayout]  # (params) -> ObsLayout

    def reset_env(self, params, generator=None, device=None):
        """``(state, obs)``: one formation's reset and its first
        observation."""
        state = self.reset(params, generator, device)
        return state, self.obs(state, params)

    def step_env(self, state, velocity, params, generator=None):
        """``(state, obs, reward, done, info)`` of one formation's step;
        ``info`` is the transition's metrics."""
        next_state, tr = self.step(state, velocity, params, generator)
        return next_state, tr.obs, tr.reward, tr.done, tr.metrics

    def default_params(self, **overrides):
        """A fresh ``params_cls`` instance with keyword overrides."""
        return self.params_cls(**overrides)
