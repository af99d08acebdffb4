"""PPO trainer: rollout, GAE and the minibatch epochs, in a host loop.

Counterpart of the single-run path of the JAX package's ``train/trainer.py``
(``TrainConfig``, ``make_ppo_iteration`` and ``Trainer``'s host loop). The
JAX package compiles an iteration into one program; here an iteration is a
sequence of eager launches that never waits for the device, and the host
reads the device once per log interval: one batched transfer of the
iteration's metrics.

Timestep accounting matches SB3: ``num_timesteps`` counts agent-transitions
(``n_steps * M * N`` an iteration) and the default budget is ``5000 * M``
(reference vectorized_env.py:116,134). ``env_steps_per_sec`` counts
formation-steps (``n_steps * M`` an iteration), as the JAX trainer does.

Randomness: the model is initialised from a CPU generator seeded with
``seed``; resets, action noise and minibatch permutations draw, in that
order, from one generator on the training device seeded with ``seed +
2**32``. Its state is checkpointed, so a resume continues the stream.
Mesh, scenarios, health and recovery, fused dispatch and populations are
not ported (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo import (
    AdamState,
    MinibatchData,
    PPOConfig,
    adam_init,
    collect_rollout,
    compute_gae,
    ppo_update,
)
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.device import DeviceLike, resolve_device
from marl_distributedformation_tpu_torch.env.formation import (
    compute_obs,
    reset_batch,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    restore_latest_partial,
    save_checkpoint,
)
from marl_distributedformation_tpu_torch.utils.config import repo_root
from marl_distributedformation_tpu_torch.utils.logging import (
    MetricsLogger,
    Throughput,
)

Tensor = torch.Tensor

# The run generator is seeded apart from the init generator.
RUN_SEED_OFFSET = 1 << 32
ENV_FIELDS = ("agents", "goal", "obstacles", "steps")
RESUME_KEYS = (
    "policy", "params", "opt_state", "num_timesteps", "learning_rate",
    "torch_generator", "torch_env_state", "torch_obs", "torch_step",
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run-level configuration of the single-run host loop; fields and
    defaults as the JAX package's."""

    num_formations: int = 1000  # cfg/config.yaml:3
    total_timesteps: Optional[int] = None  # default 5000 * M
    seed: int = 0
    save_freq: int = 10  # vec-steps between checkpoints
    checkpoint: bool = True
    name: str = "default"
    log_dir: Optional[str] = None  # default <repo>/logs/{name}
    use_wandb: bool = False
    use_tensorboard: bool = False
    resume: bool = False
    log_interval: int = 1  # rollouts between metric records


def default_total_timesteps(config: TrainConfig) -> int:
    """``total_timesteps``, else ``5000 * M`` agent-transitions."""
    if config.total_timesteps is not None:
        return config.total_timesteps
    return 5000 * config.num_formations


def fill_ent_schedule(
    ppo: PPOConfig,
    env_params: EnvParams,
    config: TrainConfig,
    iterations: Optional[int] = None,
) -> PPOConfig:
    """Fill ``ppo.total_iterations``, the schedules' horizon, from the run's
    planned iteration count; a no-op without a schedule or when set."""
    if (
        ppo.ent_coef_final is None and ppo.log_std_final is None
    ) or ppo.total_iterations > 0:
        return ppo
    if iterations is None:
        per_iter = config.num_formations * env_params.num_agents * ppo.n_steps
        iterations = -(-default_total_timesteps(config) // per_iter)
    return dataclasses.replace(ppo, total_iterations=max(1, int(iterations)))


Iteration = Callable[..., Tuple[int, FormationState, Tensor, Dict[str, Any]]]


def make_ppo_iteration(
    env_params: EnvParams,
    ppo: PPOConfig,
    per_formation: bool = False,
    env_step_fn: Any = None,
) -> Iteration:
    """The training iteration ``(model, opt_state, step, env_state, obs,
    generator, noise=None, permutations=None, mark=None) -> (step,
    env_state, last_obs, metrics)``; updates ``model`` and ``opt_state`` in
    place.

    Per-formation models (the GNN) are minibatched by whole formations,
    ``batch_size // N`` of them, so the pooled critic sees every agent;
    ``batch_size`` stays in agent-transitions. ``noise``, ``permutations``
    and ``env_step_fn`` let tests inject the JAX package's draws.
    ``mark(phase)`` is called at "rollout", "update" and "end".
    """
    if per_formation:
        n = env_params.num_agents
        update_ppo = dataclasses.replace(
            ppo, batch_size=max(1, ppo.batch_size // n)
        )
        row_shape: Tuple[int, ...] = (n,)
    else:
        update_ppo = ppo
        row_shape = ()

    def iteration(model, opt_state, step, env_state, obs, generator,
                  noise=None, permutations=None, mark=None):
        if mark is not None:
            mark("rollout")
        env_state, last_obs, batch, last_value = collect_rollout(
            model, env_state, obs, generator, env_params, ppo.n_steps,
            env_step_fn=env_step_fn, noise=noise,
        )
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_value,
            ppo.gamma, ppo.gae_lambda,
        )
        flat = MinibatchData(
            obs=batch.obs.reshape(-1, *row_shape, env_params.obs_dim),
            actions=batch.actions.reshape(-1, *row_shape, env_params.act_dim),
            old_log_probs=batch.log_probs.reshape(-1, *row_shape),
            advantages=advantages.reshape(-1, *row_shape),
            returns=returns.reshape(-1, *row_shape),
        )
        if mark is not None:
            mark("update")
        step, update_metrics = ppo_update(
            model, opt_state, step, flat, generator, update_ppo, permutations
        )
        metrics: Dict[str, Any] = {
            k: v.mean() for k, v in batch.metrics.items()
        }
        metrics.update(update_metrics)
        metrics["reward"] = batch.rewards.mean()
        # Formation-level episode count: dones are broadcast to the agents.
        metrics["episode_dones"] = batch.dones[..., 0].sum()
        if mark is not None:
            mark("end")
        return step, env_state, last_obs, metrics

    return iteration


def metrics_to_host(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Floats of an iteration's metrics, sorted by name, with one
    device-to-host transfer for all the tensors."""
    names = [k for k, v in metrics.items() if isinstance(v, Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in names}
    if names:
        values = torch.stack([metrics[k].to(torch.float32) for k in names])
        out.update(zip(names, values.tolist()))
    return dict(sorted(out.items()))


class Trainer:
    """The single-run training loop of ``model``: iterations, metrics,
    checkpoints and resume."""

    def __init__(
        self,
        env_params: EnvParams,
        ppo: PPOConfig = PPOConfig(),
        config: TrainConfig = TrainConfig(),
        *,
        model: torch.nn.Module,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        ppo = fill_ent_schedule(ppo, env_params, config)
        self.env_params = env_params
        self.ppo = ppo
        self.config = config
        self.num_envs = config.num_formations * env_params.num_agents
        self.model = model.to(self.device)
        self.policy = type(model).__name__
        self.per_formation = model.per_formation

        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + RUN_SEED_OFFSET
        )
        self.env_state = reset_batch(
            env_params, config.num_formations, self.generator, self.device
        )
        self.obs = compute_obs(
            self.env_state.agents, self.env_state.goal, env_params
        )
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        self.step = 0  # optimizer steps, the schedules' clock
        self.num_timesteps = 0
        self._vec_steps_since_save = 0
        self._iteration = make_ppo_iteration(
            env_params, ppo, self.per_formation
        )
        self.log_dir = config.log_dir or str(
            repo_root() / "logs" / config.name
        )
        self.last_record: Dict[str, float] = {}
        if config.resume:
            self._try_resume()

    @property
    def total_timesteps(self) -> int:
        return default_total_timesteps(self.config)

    def run_iteration(
        self, mark: Optional[Callable[[str], None]] = None
    ) -> Dict[str, Any]:
        """One rollout and update; returns the metrics, still on the
        device. ``mark`` is passed to the iteration (``make_ppo_iteration``)."""
        self.step, self.env_state, self.obs, metrics = self._iteration(
            self.model, self.opt_state, self.step, self.env_state, self.obs,
            self.generator, mark=mark,
        )
        self.num_timesteps += self.ppo.n_steps * self.num_envs
        self._vec_steps_since_save += self.ppo.n_steps
        return metrics

    def train(self) -> Dict[str, float]:
        """The full run with metrics and checkpoints; returns the last
        record."""
        logger = MetricsLogger(
            self.log_dir,
            run_name=self.config.name,
            use_wandb=self.config.use_wandb,
            use_tensorboard=self.config.use_tensorboard,
        )
        meter = Throughput()
        iteration = 0
        try:
            while self.num_timesteps < self.total_timesteps:
                metrics = self.run_iteration()
                iteration += 1
                meter.tick(self.ppo.n_steps * self.config.num_formations)
                if iteration % self.config.log_interval == 0:
                    record = metrics_to_host(metrics)
                    record["env_steps_per_sec"] = meter.rate()
                    self.last_record = record
                    logger.log(record, self.num_timesteps)
                if (
                    self.config.checkpoint
                    and self._vec_steps_since_save >= self.config.save_freq
                ):
                    self.save()
            if self.config.checkpoint:
                self.save()
        finally:
            logger.close()
        return self.last_record

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_tree(self) -> Dict[str, Any]:
        """The checkpoint: the JAX trainer's learner keys in its layout, and
        the port's own resume state under ``torch_`` keys, which the JAX
        package's reader ignores (a learner-only checkpoint to it)."""
        params = dict(self.model.named_parameters())
        return {
            "policy": self.policy,
            "params": params_to_jax(params, self.policy),
            "opt_state": opt_state_to_jax(vars(self.opt_state), self.policy),
            "num_timesteps": int(self.num_timesteps),
            "learning_rate": float(self.ppo.learning_rate),
            "torch_generator": self.generator.get_state().numpy(),
            "torch_env_state": {
                f: getattr(self.env_state, f).cpu().numpy()
                for f in ENV_FIELDS
            },
            "torch_obs": self.obs.cpu().numpy(),
            "torch_step": int(self.step),
        }

    def save(self) -> Optional[str]:
        """Write a checkpoint; returns its path, or None when the
        non-finite gate refused the state."""
        path = save_checkpoint(
            self.log_dir, self.num_timesteps, self._checkpoint_tree()
        )
        self._vec_steps_since_save = 0
        return None if path is None else str(path)

    def _try_resume(self) -> None:
        """Restore the newest valid checkpoint in ``log_dir``. Params and,
        when present, the Adam state and ``num_timesteps`` come from the
        JAX trainer's keys; the generator, env state, observation and step
        from the port's ``torch_`` keys. A file without them (one the JAX
        package wrote) resumes the learner only, with a fresh env and step
        0, as the JAX package does with a learner-only file."""
        found = restore_latest_partial(self.log_dir, RESUME_KEYS)
        if found is None:
            return
        path, raw = found
        policy = raw.get("policy", "MLPActorCritic")
        if policy != self.policy:
            raise ValueError(
                f"checkpoint {path} holds a {policy}, this run trains a "
                f"{self.policy}"
            )
        if "num_timesteps" not in raw:
            raise ValueError(f"checkpoint {path} has no num_timesteps")
        self.model.load_state_dict(params_from_jax(raw["params"], policy))
        if "opt_state" in raw:
            opt = AdamState(**opt_state_from_jax(raw["opt_state"], policy))
            for k, p in self.model.named_parameters():
                if opt.mu[k].shape != p.shape or opt.nu[k].shape != p.shape:
                    raise ValueError(
                        f"checkpoint {path}: Adam state of {k} has shape "
                        f"{tuple(opt.mu[k].shape)}, the model {tuple(p.shape)}"
                    )
            # In the model's parameter order, which the optimizer zips by.
            names = [k for k, _ in self.model.named_parameters()]
            self.opt_state = dataclasses.replace(
                opt,
                count=opt.count.to(self.device),
                mu={k: opt.mu[k].to(self.device) for k in names},
                nu={k: opt.nu[k].to(self.device) for k in names},
            )
        self.num_timesteps = int(raw["num_timesteps"])
        ckpt_lr = raw.get("learning_rate")
        if ckpt_lr is not None and not np.isclose(
            float(ckpt_lr), self.ppo.learning_rate, rtol=1e-6
        ):
            print(
                f"[trainer] WARNING: checkpoint was trained at "
                f"learning_rate={float(ckpt_lr):g} but this run uses "
                f"{self.ppo.learning_rate:g}",
                file=sys.stderr,
            )
        if "torch_generator" in raw:
            self.generator.set_state(
                torch.from_numpy(np.array(raw["torch_generator"]))
            )
        if "torch_env_state" in raw:
            env = raw["torch_env_state"]
            if np.shape(env["agents"]) != tuple(self.env_state.agents.shape):
                raise ValueError(
                    f"checkpoint {path}: env state of shape "
                    f"{np.shape(env['agents'])}, this run has "
                    f"{tuple(self.env_state.agents.shape)}"
                )
            self.env_state = FormationState(**{
                f: torch.from_numpy(np.array(env[f])).to(self.device)
                for f in ENV_FIELDS
            })
            self.obs = torch.from_numpy(np.array(raw["torch_obs"])).to(
                self.device
            )
        self.step = int(raw.get("torch_step", 0))
        print(f"[trainer] resumed from {path} at {self.num_timesteps} steps")
