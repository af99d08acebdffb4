"""Worst-case severity search: minimal-severity falsifiers, one JSON.

Counterpart of the repository's ``scripts/adversarial_search.py`` for the
port: attack a run's checkpoints with the grid-refine falsifier search
(``scenarios/adversary.py``): per scenario family, the smallest severity at
which the policy's return drops more than ``drop_tolerance`` (relative)
below its own clean cell. A generation is one run of one program over the
whole candidate population, folded into the formation batch and built
once across every generation and checkpoint (``eval_compiles`` in the
report).

    python -m marl_distributedformation_tpu_torch.adversarial_search name=myrun
    python -m marl_distributedformation_tpu_torch.adversarial_search \\
        name=myrun "scenarios=[wind,storm]" drop_tolerance=0.15 \\
        max_severity=2 search_grid=6 search_generations=5 eval_formations=64
    python -m marl_distributedformation_tpu_torch.adversarial_search \\
        checkpoint=logs/x/rl_model_200_steps.msgpack device=cpu

Writes ``logs/{name}/falsifiers.json`` (the per-checkpoint reports,
schema-stamped) and the same report as one JSON line on stdout; the
falsifier records feed ``scenarios.from_falsifiers``. Unknown scenario
names and mistyped keys exit naming the valid entries. ``device`` defaults
to ``cuda``; the CPU runs only with ``device=cpu``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from marl_distributedformation_tpu_torch.device import resolve_device
from marl_distributedformation_tpu_torch.robustness_matrix import (
    device_fields,
    run_checkpoints,
    scenario_names,
)
from marl_distributedformation_tpu_torch.utils.config import (
    env_params_from_config,
    load_config,
    repo_root,
    validate_override_keys,
)

SEARCH_KEYS = (
    "checkpoint",
    "search_checkpoints",
    "drop_tolerance",
    "max_severity",
    "search_grid",
    "search_generations",
    "search_resolution",
    "eval_formations",
    "eval_seed",
    "eval_deterministic",
    "out",
    "device",
)


def main(argv=None) -> dict:
    return run(argv)[0]


def run(argv=None):
    """``main``'s work: ``(report, search)``, the ``AdversarySearch`` that
    made the report (its ``brackets`` and program, for a caller that
    re-evaluates the falsifiers)."""
    overrides = sys.argv[1:] if argv is None else list(argv)
    validate_override_keys(overrides, extra_keys=SEARCH_KEYS)
    cfg = load_config(overrides)
    dev = resolve_device(cfg.get("device"))

    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        AdversaryConfig,
        AdversarySearch,
    )
    from marl_distributedformation_tpu_torch.scenarios.adversary import (
        FALSIFIERS_SCHEMA,
    )

    params = env_params_from_config(cfg)
    checkpoints = run_checkpoints(cfg, "search_checkpoints", 1)
    search_cfg = AdversaryConfig(
        # Empty: every family except clean (the config's default).
        scenarios=tuple(scenario_names(cfg)),
        drop_tolerance=float(cfg.get("drop_tolerance", 0.2)),
        max_severity=float(cfg.get("max_severity", 1.5)),
        grid=int(cfg.get("search_grid", 6)),
        generations=int(cfg.get("search_generations", 4)),
        resolution=float(cfg.get("search_resolution", 0.02)),
        num_formations=int(cfg.get("eval_formations", 64)),
        seed=int(cfg.get("eval_seed", 1234)),
        deterministic=bool(cfg.get("eval_deterministic", True)),
    )

    policies = [
        LoadedPolicy.from_checkpoint(
            str(p), act_dim=params.act_dim, env_params=params, device=dev
        )
        for p in checkpoints
    ]
    search = AdversarySearch(policies[0].model, params, search_cfg,
                             device=dev)
    # Every architecture is validated before the first generation, so a
    # mismatched file fails the run up front, by name.
    for path, pol in zip(checkpoints, policies):
        search.check_params(pol.params, origin=str(path))

    searches = {}
    for path, pol in zip(checkpoints, policies):
        searches[str(path)] = search.search(pol.params, origin=str(path))

    report = {
        "schema": FALSIFIERS_SCHEMA,
        "name": str(cfg.name),
        "checkpoints": checkpoints,
        "scenarios": [s.name for s in search.specs],
        "drop_tolerance": search_cfg.drop_tolerance,
        "max_severity": search_cfg.max_severity,
        "num_agents": params.num_agents,
        "eval_formations": search_cfg.num_formations,
        "seed": search_cfg.seed,
        "searches": searches,
        "eval_compiles": search.compile_count,
        "candidates_per_sec": round(search.candidates_per_sec(), 1),
        **device_fields(dev),
    }

    # The minimal break point per checkpoint.
    print(
        f"[adversary] {len(checkpoints)} checkpoints x "
        f"{len(search.specs)} scenario families, "
        f"M={search_cfg.num_formations}, "
        f"compiles={report['eval_compiles']}, "
        f"{report['candidates_per_sec']:,.0f} candidates/s"
    )
    for ckpt, rep in searches.items():
        fals = {f["scenario"]: f["severity"] for f in rep["falsifiers"]}
        print(
            f"[adversary] {Path(ckpt).name}: falsified "
            f"{json.dumps(fals)} robust {rep['robust']} "
            f"({rep['generations']} generations)"
        )

    out = cfg.get("out") or str(
        repo_root() / "logs" / str(cfg.name) / "falsifiers.json"
    )
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    report["out"] = str(out)
    print(json.dumps(report))
    return report, search


if __name__ == "__main__":
    main()
