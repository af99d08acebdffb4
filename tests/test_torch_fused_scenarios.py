"""Scenario training under the port's fused dispatch on the CPU: a stage
change inside a chunk against the host loop, severity 0 against the clean
run, a resume mid-schedule, and the mixes as a pure function of the draw
(the trainers and records of ``test_torch_fused.py``).

Tolerances: records, checkpoint bytes and carries bitwise (the same
operations in the same order).
"""

import numpy as np
import pytest
import torch

from test_torch_fused import ITERATIONS, KINDS, M, _files, _records, _trainer


# ---------------------------------------------------------------------------
# Scenario training
# ---------------------------------------------------------------------------

# Stage 0 ramps over 3 rollouts, so with fused_chunk=2 the change to stage
# 1 falls inside the second chunk (iterations 3 | 4).
SCHEDULE = ("[{rollouts: 3, scenarios: [storm, comm_dropout, moving_goal], "
            "severity: 1.0, severity_start: 0.2}, {rollouts: 2, scenarios: "
            "[actuator_fault, sensor_noise, wind], severity: 0.7}]")


def _schedule(text=SCHEDULE):
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )

    return schedule_from_cfg(text)


def _carry(trainer):
    """The trainer's state by name: learner, env carry (with the episode
    draws under scenarios), observation and generators."""
    it = trainer._iteration
    out = {f"learner {i}": t.clone()
           for i, t in enumerate(it.learner_tensors())}
    out.update({f: getattr(it.env, f).clone() for f in it.env_fields})
    out["obs"] = it.obs.clone()
    out["generator"] = trainer.generator.get_state()
    if trainer._scenario_schedule is not None:
        out["scenario generator"] = trainer.scenario_generator.get_state()
    return out


def _same_carry(a, b):
    a, b = _carry(a), _carry(b)
    for key in set(a) & set(b):
        assert torch.equal(a[key], b[key]), key
    return a, b


def test_scenario_fused_equals_the_host_loop_across_a_stage_change(
        tmp_path):
    """fused_chunk=2 against the host loop, the stage change inside the
    second chunk: records (scenario_severity included), checkpoint bytes
    and the carry bitwise; the severities are the schedule's. (The MLP:
    the mixes' dispatch does not depend on the model, and the GNN's
    dispatch modes are pinned above; the knn scenario path trains in
    ``test_scenario_resume_mid_schedule_is_bitwise``.)"""
    kind = "mlp"
    host = _trainer(tmp_path, kind, "host", _schedule())
    host.train()
    fused = _trainer(tmp_path, kind, "fused", _schedule(), fused_chunk=2)
    fused.train()
    want, got = _records(host), _records(fused)
    assert got == want and len(got) == ITERATIONS
    assert [r["scenario_severity"] for r in got] == [
        float(np.float32(_schedule().severity_at(i)))
        for i in range(ITERATIONS)]
    a, b = _same_carry(host, fused)
    assert set(a) == set(b) and "fault_u" in a
    host_files, fused_files = _files(host), _files(fused)
    assert fused_files and set(fused_files) <= set(host_files)
    for name, data in fused_files.items():
        assert data == host_files[name], name
    assert fused.graph_count() == 0  # eager on the CPU


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_scenario_severity_zero_trains_as_the_clean_run(tmp_path, kind):
    """Every layer at severity 0 (a mix of every scenario, ``fused_chunk``
    dispatch): the learner, env carry, generator and records equal the
    clean trainer's bitwise."""
    names = ", ".join(n for n in ("wind", "storm", "sensor_noise",
                                  "actuator_fault", "comm_dropout",
                                  "goal_switch", "moving_goal",
                                  "actuator_noise"))
    zero = _schedule(f"[{{rollouts: 4, scenarios: [{names}], severity: 0.0,"
                     " severity_start: 0.0}]")
    clean = _trainer(tmp_path, kind, "clean", fused_chunk=2)
    clean.train()
    scen = _trainer(tmp_path, kind, "zero", zero, fused_chunk=2)
    scen.train()
    got = _records(scen)
    assert {r.pop("scenario_severity") for r in got} == {0.0}
    assert got == _records(clean)
    a, b = _same_carry(clean, scen)
    assert set(a) < set(b)


def test_scenario_resume_mid_schedule_is_bitwise(tmp_path):
    """Two iterations, a checkpoint, and a resumed run of two more (into
    stage 1) equal four uninterrupted iterations bitwise: the schedule is
    re-entered at num_timesteps // (n_steps * M * N), the layers'
    generator and episode draws come back from the checkpoint."""
    full = _trainer(tmp_path, "gnn", "full", _schedule())
    full.train()
    per_iter = 10 * M * KINDS["gnn"].num_agents
    part = _trainer(tmp_path, "gnn", "part", _schedule(),
                    total_timesteps=2 * per_iter, save_freq=10)
    part.train()
    resumed = _trainer(tmp_path, "gnn", "part", _schedule(), resume=True)
    assert resumed._scenario_rollouts == resumed._scenario_draws == 2
    assert resumed.scenario_severity == _schedule().severity_at(2)
    resumed.train()
    a, b = _same_carry(full, resumed)
    assert set(a) == set(b)
    assert _records(resumed)[-2:] == _records(full)[-2:]


def test_scenario_mixes_are_a_pure_function_of_the_draw(tmp_path):
    """Draw d's mix repeats for the same (seed, d) and differs across d; a
    schedule swap restarts the schedule but not the draw counter."""
    trainer = _trainer(tmp_path, "mlp", "swap", _schedule())
    a, _ = trainer._scenario_rows(0, 5, 2)
    b, _ = trainer._scenario_rows(0, 5, 2)
    c, _ = trainer._scenario_rows(0, 6, 2)
    assert torch.equal(a.act_noise_sigma, b.act_noise_sigma)
    assert not torch.equal(a.fault_prob[1], c.fault_prob[0]) or not \
        torch.equal(a.obs_noise_sigma[1], c.obs_noise_sigma[0]) or \
        torch.equal(a.act_noise_sigma[1], c.act_noise_sigma[0])
    trainer.run_iteration()
    trainer.update_scenario_schedule(_schedule("[wind]"))
    assert trainer._scenario_rollouts == 0 and trainer._scenario_draws == 1
    trainer.request_scenario_schedule(_schedule("[storm]"))
    with pytest.raises(ValueError, match="unknown scenario"):
        from marl_distributedformation_tpu_torch.scenarios import (
            ScenarioSchedule,
            ScenarioStage,
        )
        trainer.request_scenario_schedule(ScenarioSchedule(
            (ScenarioStage(1, ("wnd",)),)))
    trainer.run_iteration()
    assert trainer._scenario_schedule.names == ("storm",)
    assert trainer._scenario_draws == 2
    assert float(trainer.scenario_params.act_noise_sigma[0]) == np.float32(
        2.0 * np.float32(0.5))
    clean = _trainer(tmp_path, "mlp", "plain")
    with pytest.raises(ValueError, match="built without scenario training"):
        clean.update_scenario_schedule(_schedule("[wind]"))
