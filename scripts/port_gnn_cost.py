#!/usr/bin/env python3
"""The PyTorch port's GNN cost in one checkout, for comparing two commits
on one card: ``gnn100`` captured for 10 iterations (steady s/iteration by
CUDA events, then one profiled iteration: busy ms and kernel launches), a
full-episode N=100, M=4096 evaluation of a seeded GNN (formation-steps/s)
and a profiled 6-step evaluation window. It uses the ``chip_smoke.py`` of
the checkout it runs in, so it measures each commit with that commit's own
code; run it from each checkout in turns (parent, change, change, parent):

    (cd <parent checkout> && python3 <this file> parent)
    (cd <change checkout> && python3 <this file> change)

Prints one ``RESULT`` JSON line and the card's name and power limit.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))


def main(tag: str) -> None:
    import chip_smoke as cs
    import torch

    from marl_distributedformation_tpu_torch.env.types import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        evaluate,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.models import GNNActorCritic
    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda

    _build.build([knn_cuda.SOURCE])
    out = {"tree": tag}
    trainer, rewards, _, s_iter = cs.train_run(
        "cost_gnn100",
        cs.GNN100[:-1] + ("total_timesteps=10240000", "fused_chunk=10"),
        f"{tag} gnn100 10 iterations")
    out.update(s_iter=s_iter, reward1=rewards[0])
    out["train_busy"] = cs.profile_window(
        lambda: trainer._dispatch(1), f"{tag} train", 1, "iteration")
    gnn = GNNActorCritic(k=4, generator=torch.Generator().manual_seed(0))
    gnn = gnn.to("cuda").eval()
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    act = policy_act_fn(gnn, params)
    evaluate(act, params.replace(max_steps=10), 4096, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate(act, params, 4096, seed=1234, device="cuda")
    torch.cuda.synchronize()
    out["eval_fsps"] = 4096 * 1002 / (time.perf_counter() - t0)
    cs.profile_breakdown(gnn, params, 4096)
    print("RESULT " + json.dumps(out))
    print(cs.card_line())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
