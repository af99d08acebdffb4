#!/usr/bin/env python3
"""Device time of the PyTorch port's robustness-matrix cell and falsifier
population on one NVIDIA GPU.

    python3 scripts/port_matrix_profile.py

Builds the k-NN kernels, then profiles (``chip_smoke.profile_window``: the
union of the device intervals over the wall time, the top kernels) three
runs of 50 steps (max_steps 48) of a GNN at N=100, k=4 from a seeded init:
a matrix cell at M=256 under ``wind`` 0.5 with its step captured as a CUDA
graph, the same cell through the eager ``eval.evaluate_scenario``, and one
generation of a falsifier population of P=25 candidates x M=64 formations
(clean and four families at six severities). Each run is warmed up twice
first. Prints the card's name and power limit, and the graph's node count.
Imports nothing of JAX; exits non-zero without a GPU.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_matrix_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        evaluate_scenario,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.models import GNNActorCritic
    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda
    from marl_distributedformation_tpu_torch.scenarios import (
        MatrixProgram,
        get_scenario,
        make_population_runner,
        scenario_params_for,
    )
    from marl_distributedformation_tpu_torch.scenarios.adversary import (
        _stack_rows,
    )

    print(cs.card_line())
    _build.build([knn_cuda.SOURCE])
    dev = torch.device("cuda")
    model = GNNActorCritic(k=4, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    weights = model.state_dict()
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4, max_steps=48)
    steps = 50

    program = MatrixProgram(model, params, 256, device=dev)
    wind = scenario_params_for("wind", 0.5)
    for _ in range(2):
        program.run(weights, wind)
    cs.profile_window(lambda: program.run(weights, wind),
                      "matrix cell M=256 N=100 wind 0.5, captured, "
                      f"{steps} steps", steps, "step")

    act = policy_act_fn(model, params)

    def eager():
        evaluate_scenario(act, params, "wind", 0.5, 256, 1234, dev)

    eager()
    cs.profile_window(eager, "eager evaluate_scenario M=256 N=100 wind 0.5, "
                      f"{steps} steps", steps, "step")

    run, _ = make_population_runner(model, params, 64, device=dev)
    rows = _stack_rows([(get_scenario("clean"), 0.0)] + [
        (get_scenario(name), sev)
        for name in ("wind", "storm", "actuator_fault", "sensor_noise")
        for sev in (0.25, 0.5, 0.75, 1.0, 1.25, 1.5)])
    for _ in range(2):
        run(weights, rows)
    cs.profile_window(lambda: run(weights, rows),
                      "population P=25 x M=64 N=100, captured, "
                      f"{steps} steps", steps, "step")
    print(f"nodes of the matrix step's graph: {program.run.__self__._step.nodes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
