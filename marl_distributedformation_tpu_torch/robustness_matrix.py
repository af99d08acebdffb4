"""Robustness matrix: scenarios x severities x checkpoints, one JSON.

Counterpart of the repository's ``scripts/robustness_matrix.py`` for the
port: sweep a run's checkpoint series over the registered disturbance
scenarios at several severities, on identical initial states, through one
program built once (``scenarios/matrix.py``; on the card its step is one
CUDA graph), with the build count in the report (``eval_compiles``).

    python -m marl_distributedformation_tpu_torch.robustness_matrix name=myrun
    python -m marl_distributedformation_tpu_torch.robustness_matrix \\
        name=myrun "scenarios=[wind,storm]" "severities=[0,0.5,1]" \\
        matrix_checkpoints=3 eval_formations=256
    python -m marl_distributedformation_tpu_torch.robustness_matrix \\
        checkpoint=logs/x/rl_model_200_steps.msgpack device=cpu

By default the matrix covers every registered scenario at severities 0,
0.5 and 1.0 for the run's last 2 checkpoints, and writes
``logs/{name}/robustness_matrix.json`` and the same report as one JSON line
on stdout. Unknown scenario names and mistyped keys exit naming the valid
entries. ``device`` defaults to ``cuda``; the CPU runs only with
``device=cpu``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from marl_distributedformation_tpu_torch.device import resolve_device
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_step,
)
from marl_distributedformation_tpu_torch.utils.config import (
    env_params_from_config,
    load_config,
    repo_root,
    validate_override_keys,
)

MATRIX_KEYS = (
    "checkpoint",
    "eval_formations",
    "eval_seed",
    "eval_deterministic",
    "severities",
    "matrix_checkpoints",
    "out",
    "device",
)


def run_checkpoints(cfg, count_key: str, default: int) -> list:
    """Explicit ``checkpoint=`` (one path or a YAML list), else the last
    ``cfg[count_key]`` (default ``default``) checkpoints of the named run,
    by step."""
    explicit = cfg.get("checkpoint")
    if explicit:
        paths = explicit if isinstance(explicit, list) else [explicit]
        return [str(p) for p in paths]
    log_dir = repo_root() / "logs" / str(cfg.name)
    ckpts = sorted(log_dir.glob("rl_model_*_steps.*"), key=checkpoint_step)
    if not ckpts:
        raise SystemExit(
            f"no checkpoints under {log_dir}; pass checkpoint=... or "
            "name=<trained run>"
        )
    keep = max(1, int(cfg.get(count_key, default)))
    return [str(p) for p in ckpts[-keep:]]


def scenario_names(cfg) -> list:
    """The ``scenarios`` key's names (validated against the registry;
    an unknown one exits with the registry's message), or ``[]``."""
    from marl_distributedformation_tpu_torch.scenarios import get_scenario

    raw = cfg.get("scenarios")
    if not raw:
        return []
    names = raw if isinstance(raw, list) else [raw]
    try:
        return [get_scenario(str(n)).name for n in names]
    except ValueError as e:
        raise SystemExit(str(e)) from e


def device_fields(dev) -> dict:
    """The report's ``resolved_platform`` and ``resolved_device``."""
    import torch

    return {
        "resolved_platform": dev.type,
        "resolved_device": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
    }


def main(argv=None) -> dict:
    overrides = sys.argv[1:] if argv is None else list(argv)
    validate_override_keys(overrides, extra_keys=MATRIX_KEYS)
    cfg = load_config(overrides)
    dev = resolve_device(cfg.get("device"))
    from marl_distributedformation_tpu_torch.scenarios import (
        registered_scenarios,
        run_matrix,
    )

    params = env_params_from_config(cfg)
    checkpoints = run_checkpoints(cfg, "matrix_checkpoints", 2)
    scenarios = scenario_names(cfg) or list(registered_scenarios())
    severities = [
        float(s) for s in (cfg.get("severities") or (0.0, 0.5, 1.0))
    ]
    report = run_matrix(
        checkpoints,
        params,
        scenarios=scenarios,
        severities=severities,
        num_formations=int(cfg.get("eval_formations", 256)),
        seed=int(cfg.get("eval_seed", 1234)),
        deterministic=bool(cfg.get("eval_deterministic", True)),
        device=dev,
    )
    report["name"] = str(cfg.name)
    report.update(device_fields(dev))

    # Per checkpoint and scenario, the return at each severity: the
    # degradation is the robustness headline.
    key = "episode_return_per_agent"
    print(
        f"[matrix] {len(report['checkpoints'])} checkpoints x "
        f"{len(report['scenarios'])} scenarios x {len(severities)} "
        f"severities, M={report['eval_formations']}, "
        f"compiles={report['eval_compiles']}"
    )
    for ckpt, per_scenario in report["matrix"].items():
        print(f"[matrix] {Path(ckpt).name}:")
        for scenario, per_sev in per_scenario.items():
            vals = " ".join(
                f"s={sev}:{metrics[key]:,.0f}"
                for sev, metrics in per_sev.items()
            )
            print(f"  {scenario:<16} {vals}")

    out = cfg.get("out") or str(
        repo_root() / "logs" / str(cfg.name) / "robustness_matrix.json"
    )
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    report["out"] = str(out)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
