"""The trainer's runtime guards on the CPU (``guard_retraces``,
``guard_transfers``, ``guard_nans``), held against the JAX trainer's.

- ``guard_retraces=1``: the steady state passes; a forced rebuild raises
  ``RetraceError`` (JAX: a retrace over the budget raises the same).
- ``guard_nans``: a NaN-poisoned dispatch raises ``FloatingPointError``
  naming the aten op that made the NaN (JAX's ``jax_debug_nans`` raises
  ``FloatingPointError`` at its source primitive); the dispatch mode works
  on the CPU.
- ``guard_transfers``: a no-op on the CPU, as JAX's guard is on its CPU
  backend.
- The ``train`` CLI accepts the three keys and passes them to the trainer.
"""

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.chaos import (
    FaultSchedule as JaxFaultSchedule,
    FaultSpec as JaxFaultSpec,
    get_fault_plane as jax_get_fault_plane,
)
from marl_distributedformation_tpu.train import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
)
from marl_distributedformation_tpu_torch.analysis import (
    RetraceError,
    nan_guard,
    no_host_transfers,
)
from marl_distributedformation_tpu_torch.chaos import (
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.train import cli as train_cli
from test_torch_env import jax_params
from test_torch_recovery import PARAMS, PER_ITER, _jax_ppo, make_trainer

GUARDS = dict(guard_retraces=1, guard_transfers=True, guard_nans=True)


def test_guarded_run_passes_and_a_forced_rebuild_raises(tmp_path):
    trainer = make_trainer(tmp_path, total_timesteps=3 * PER_ITER, **GUARDS)
    trainer.train()
    assert trainer.retrace_guard.count == 1
    assert trainer.num_timesteps == 3 * PER_ITER
    for phase in trainer._phases:
        phase.drop()
    with pytest.raises(RetraceError, match="budget 1"):
        trainer.run_iteration()


def test_carry_poison_under_guard_nans_names_the_op_as_jax_raises(tmp_path):
    """The same poisoned dispatch in both trainers: both raise
    ``FloatingPointError``; the port's names the aten op."""
    plane = FaultPlane(enabled=True)
    plane.arm(FaultSchedule([FaultSpec("train.carry_poison", "raise", 2)]))
    previous = set_fault_plane(plane)
    try:
        trainer = make_trainer(tmp_path, total_timesteps=4 * PER_ITER,
                               **GUARDS)
        with pytest.raises(FloatingPointError, match=r"in aten\.\w+"):
            trainer.train()
    finally:
        set_fault_plane(previous)
    assert len(plane.fired) == 1
    jplane = jax_get_fault_plane()
    jplane.reset()
    jplane.arm(JaxFaultSchedule([JaxFaultSpec("train.carry_poison",
                                              "raise", 2)]))
    jplane.enabled = True
    try:
        with pytest.raises(FloatingPointError):
            JaxTrainer(jax_params(PARAMS), ppo=_jax_ppo(), config=(
                JaxTrainConfig(num_formations=4, seed=0, checkpoint=False,
                               total_timesteps=4 * PER_ITER,
                               log_dir=str(tmp_path / "jax"),
                               guard_nans=True))).train()
    finally:
        jplane.enabled = False
        jplane.reset()


def test_guard_nans_reruns_from_the_dispatch_start(tmp_path):
    """The eager re-run starts from the state the dispatch started from: a
    NaN made inside the dispatch (not before it) is found by the re-run."""
    trainer = make_trainer(tmp_path, guard_nans=True)
    trainer.run_iteration()
    start = [p.detach().clone() for p in trainer.model.parameters()]
    end = trainer._iteration.end
    calls = []

    def poisoned_end():
        end()
        if not calls:  # the captured (here: first) run only
            calls.append(1)
            trainer._poison_carry(float("nan"))

    trainer._iteration.end = poisoned_end
    for phase in trainer._phases:
        if phase.name == "end":
            phase.fn = poisoned_end
    with pytest.raises(FloatingPointError, match="made none"):
        trainer.run_iteration()
    # The re-run restored the starting parameters before it ran.
    assert calls == [1]
    assert all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters())
    assert not all(torch.equal(a, b) for a, b in
                   zip(start, trainer.model.parameters()))


def test_nan_guard_and_no_host_transfers_on_the_cpu():
    x = torch.ones(3)
    with nan_guard():
        torch.exp(x).sum()  # finite: passes
        # A NaN constant is a literal, not a result (JAX checks primitives).
        torch.where(x > 0, x, float("nan"))
        torch.full((2,), float("nan"))
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(-x)
    with nan_guard(enable=False):
        torch.log(-x)
    with no_host_transfers():  # no CUDA device here: a no-op
        assert float(torch.tensor(2.0).item()) == 2.0
    np.testing.assert_array_equal(x.numpy(), np.ones(3))


@pytest.mark.parametrize("key,value,want", [
    ("guard_retraces", "1", 1),
    ("guard_transfers", "true", True),
    ("guard_nans", "true", True),
])
def test_train_cli_accepts_the_guard_keys(tmp_path, monkeypatch, key, value,
                                          want):
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    assert key not in train_cli.UNPORTED
    trainer = train_cli.build_trainer(
        [f"{key}={value}", "device=cpu", "num_formation=2"])
    assert getattr(trainer.config, key) == want
    if key == "guard_retraces":
        assert trainer.retrace_guard.max_traces == 1


@pytest.mark.parametrize("key", ["guard_transfers", "guard_nans"])
def test_train_cli_refuses_the_dispatch_guards_under_sebulba(key):
    with pytest.raises(SystemExit, match="architecture=sebulba"):
        train_cli.build_trainer([f"{key}=true", "architecture=sebulba",
                                 "device=cpu", "num_formation=2"])
