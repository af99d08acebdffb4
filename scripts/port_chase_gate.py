#!/usr/bin/env python3
"""What ``chase100`` (pursuit-evasion training at N=100, M=1024) learns in
20 iterations, by each measure a learning gate could read, on one NVIDIA
GPU.

    python3 scripts/port_chase_gate.py [seed ...]      # default: 0 1

For each seed: trains ``chip_smoke.CHASE100`` (``chip_smoke.train_run``,
20 captured iterations) after saving the seeded policy, then a control run
of the same command with ``learning_rate=0`` (the same states, streams and
episode steps, no updates). Evaluates the trained and the seeded policy at
M=1024, with their noise and by their mean action, over full episodes and
over the 200 steps the run trained on (``max_steps=198``), and for the
first seed the zero action and the baseline. Prints each reward curve,
each evaluation and, last, one JSON object of them all, after the card's
name and power limit. Imports nothing of JAX; exits non-zero without a
GPU.
"""

import json
import shutil
import sys
from pathlib import Path
from statistics import mean

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_chase_gate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from marl_distributedformation_tpu_torch.envs import PursuitParams
    from marl_distributedformation_tpu_torch.eval import (
        baseline_act_fn,
        evaluate,
        evaluate_checkpoint,
        zero_act_fn,
    )
    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    print(cs.card_line())
    _build.build([knn_cuda.SOURCE])
    seeds = [int(a) for a in argv] or [0, 1]
    out = {}
    for seed in seeds:
        seeded = {}

        def keep_seeded(trainer):
            path = Path(trainer.save())
            seeded["ckpt"] = str(path.with_name(f"seeded_{seed}.msgpack"))
            shutil.copy(path, seeded["ckpt"])

        trainer, rewards, _, s_iter = cs.train_run(
            f"chase_gate_s{seed}", cs.CHASE100 + (f"seed={seed}",),
            f"chase100 seed {seed}", before_train=keep_seeded)
        learned = str(latest_checkpoint(trainer.log_dir))
        _, control, _, _ = cs.train_run(
            f"chase_gate_control_s{seed}",
            cs.CHASE100 + (f"seed={seed}", "learning_rate=0.0"),
            f"chase100 control, learning_rate=0, seed {seed}")
        row = {"rewards": rewards, "control": control, "s_iter": s_iter}
        for horizon, max_steps in (("full", 1000), ("h200", 198)):
            p = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4,
                              max_steps=max_steps)
            for det in (False, True):
                for who, path in (("learned", learned),
                                  ("seeded", seeded["ckpt"])):
                    key = f"{horizon}_{'mean' if det else 'noisy'}_{who}"
                    row[key] = evaluate_checkpoint(
                        path, p, 1024, 1234, det,
                        "cuda")["episode_return_per_agent"]
                    print(f"[chase-gate] seed {seed} {key}: {row[key]:.2f}")
            if seed == seeds[0]:
                for who, act in (("zero", zero_act_fn()),
                                 ("baseline", baseline_act_fn(p))):
                    row[f"{horizon}_{who}"] = evaluate(
                        act, p, 1024, 1234,
                        "cuda")["episode_return_per_agent"]
                    print(f"[chase-gate] {horizon}_{who}: "
                          f"{row[f'{horizon}_{who}']:.2f}")
        print(f"[chase-gate] seed {seed}: first 3 {mean(rewards[:3]):.3f}, "
              f"last 3 {mean(rewards[-3:]):.3f}; control first 3 "
              f"{mean(control[:3]):.3f}, last 3 {mean(control[-3:]):.3f}")
        out[seed] = row
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
