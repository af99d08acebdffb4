"""Evaluate a checkpoint against the scripted baseline and zero actions.

Counterpart of the repository's ``evaluate.py`` for the port: full episodes
on M formations, the same initial states for all three controllers, a table
and one JSON line. Reads ``cfg/config.yaml`` with ``key=value`` overrides.

    python -m marl_distributedformation_tpu_torch.evaluate name=myrun
    python -m marl_distributedformation_tpu_torch.evaluate \\
        checkpoint=logs/x/rl_model_200_steps.msgpack obs_mode=knn policy=gnn \\
        num_agents_per_formation=100 eval_formations=4096 device=cuda

``device`` defaults to ``cuda``; the CPU runs only with ``device=cpu``. The
policy architecture is the one the checkpoint records.

``scenario=NAME`` (with ``scenario_severity``, default 0.5) evaluates all
three controllers under a registered disturbance scenario (``scenarios/``),
as the repository's ``evaluate.py`` does, and refuses what it refuses: the
training key ``scenarios=``, a ``scenario_severity=`` with no scenario, and
an unknown name (with the registry's listing).

    python -m marl_distributedformation_tpu_torch.evaluate name=myrun \
        scenario=wind scenario_severity=0.5

A run directory with ``seed<N>/`` member directories (a population,
``train/sweep.py``) is evaluated in sweep mode, as the repository's
``evaluate.py`` does: every member's newest checkpoint, the baseline and
zero actions on the same held-out initial states, a table ranked by
return and one JSON line with ``eval_sweep``'s keys. Only directories named
exactly ``seed`` and digits count.
"""

from __future__ import annotations

import json
import re
import sys

import torch

from marl_distributedformation_tpu_torch.device import resolve_device
from marl_distributedformation_tpu_torch.eval import (
    baseline_act_fn,
    evaluate,
    evaluate_checkpoint,
    zero_act_fn,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import latest_checkpoint
from marl_distributedformation_tpu_torch.utils.config import (
    env_params_from_config,
    load_config,
    repo_root,
    validate_override_keys,
)

EVAL_KEYS = (
    "checkpoint",
    "eval_formations",
    "eval_seed",
    "eval_deterministic",
    "scenario",
    "device",
)
COLUMNS = (
    "episode_return_per_agent",
    "final_avg_dist_to_goal",
    "last100_avg_dist_to_goal",
    "final_ave_dist_to_neighbor",
)


def scenario_params(cfg, overrides):
    """``(params, name, severity)`` of ``scenario=NAME`` and
    ``scenario_severity``, or ``(None, None, None)``; exits, with the root
    ``evaluate.py``'s messages, on the plural training key ``scenarios=``,
    on a ``scenario_severity=`` override with no scenario, and on an
    unknown name (naming the registry's entries)."""
    name = cfg.get("scenario")
    override_keys = {o.split("=", 1)[0] for o in overrides if "=" in o}
    if "scenarios" in override_keys:
        raise SystemExit(
            "evaluate.py takes the SINGULAR scenario=<name> (scenarios= "
            "is the train.py domain-randomization key and would be "
            "ignored here); e.g. scenario=wind scenario_severity=0.5"
        )
    if not name:
        if "scenario_severity" in override_keys:
            raise SystemExit(
                "scenario_severity=... was given without scenario=<name> "
                "— it would silently apply to nothing; add scenario=<name>"
            )
        return None, None, None
    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )

    severity = float(cfg.get("scenario_severity", 0.5) or 0.0)
    try:
        return scenario_params_for(str(name), severity), str(name), severity
    except ValueError as e:
        raise SystemExit(str(e)) from e


def main(argv=None) -> dict:
    overrides = sys.argv[1:] if argv is None else list(argv)
    validate_override_keys(overrides, extra_keys=EVAL_KEYS)
    cfg = load_config(overrides)
    sp, scenario, severity = scenario_params(cfg, overrides)
    dev = resolve_device(cfg.get("device"))
    params = env_params_from_config(cfg)
    m = int(cfg.get("eval_formations", 1024))
    seed = int(cfg.get("eval_seed", 1234))
    det = bool(cfg.get("eval_deterministic", True))
    under = {"scenario_params": sp}
    named = ({"scenario": scenario, "scenario_severity": severity}
             if scenario else {})

    ckpt = cfg.get("checkpoint")
    if not ckpt:
        log_dir = repo_root() / "logs" / str(cfg.name)
        member_dirs = sorted(
            (p for p in log_dir.glob("seed*")
             if p.is_dir() and re.fullmatch(r"seed\d+", p.name)),
            key=lambda p: int(p.name.removeprefix("seed")),
        )
        if member_dirs:
            return eval_sweep(member_dirs, params, m, seed, det, dev,
                              sp, scenario, severity)
        ckpt = latest_checkpoint(log_dir)
        if ckpt is None:
            raise SystemExit(
                f"no checkpoint under {log_dir}; pass checkpoint=... or "
                "name=<trained run>"
            )

    rows = {
        "policy": evaluate_checkpoint(str(ckpt), params, m, seed, det, dev,
                                      **under),
        "baseline": evaluate(baseline_act_fn(params), params, m, seed, dev,
                             **under),
        "zero": evaluate(zero_act_fn(), params, m, seed, dev, **under),
    }

    name_w = max(len(k) for k in rows)
    print(f"[eval] checkpoint: {ckpt}")
    print(f"[eval] M={m} formations x N={params.num_agents} agents, "
          f"seed={seed}, full episodes, device={dev}")
    if scenario:
        print(f"[eval] scenario={scenario} severity={severity:g}")
    print(f"{'':<{name_w}} | " + " | ".join(f"{c:>26}" for c in COLUMNS))
    for name, r in rows.items():
        vals = " | ".join(f"{r[c]:>26.2f}" for c in COLUMNS)
        print(f"{name:<{name_w}} | {vals}")

    result = {
        "checkpoint": str(ckpt),
        "eval_formations": m,
        "num_agents": params.num_agents,
        "seed": seed,
        "eval_deterministic": det,
        **named,
        **{f"{name}_{c}": r[c] for name, r in rows.items() for c in COLUMNS},
        "beats_baseline": bool(
            rows["policy"]["episode_return_per_agent"]
            > rows["baseline"]["episode_return_per_agent"]
        ),
        "resolved_device": _device_name(dev),
    }
    print(json.dumps(result))
    return result


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def eval_sweep(member_dirs, params, m: int, seed: int, deterministic: bool,
               dev: torch.device, scenario_params=None, scenario=None,
               severity=None) -> dict:
    """Every member's newest checkpoint, then the baseline and zero
    actions, on the same initial states (under ``scenario_params`` when
    given); a ranked table and one JSON line."""
    under = {"scenario_params": scenario_params}
    rows = {}
    for d in member_dirs:
        ckpt = latest_checkpoint(d)
        if ckpt is None:
            print(f"[eval] {d.name}: no checkpoint, skipping")
            continue
        rows[d.name] = evaluate_checkpoint(str(ckpt), params, m, seed,
                                           deterministic, dev, **under)
    if not rows:
        raise SystemExit("no member checkpoints found under seed*/")
    rows["baseline"] = evaluate(baseline_act_fn(params), params, m, seed, dev,
                                **under)
    rows["zero"] = evaluate(zero_act_fn(), params, m, seed, dev, **under)

    key = "episode_return_per_agent"
    ranked = sorted(rows, key=lambda n: rows[n][key], reverse=True)
    members = [n for n in ranked if n.startswith("seed")]
    best = members[0]
    print(f"[eval] sweep: {len(members)} members, M={m} formations x "
          f"N={params.num_agents} agents, seed={seed}, full episodes, "
          f"device={dev}")
    if scenario:
        print(f"[eval] scenario={scenario} severity={severity:g}")
    name_w = max(len(n) for n in rows)
    print(f"{'':<{name_w}} | {key:>26} | final_avg_dist_to_goal")
    for n in ranked:
        marker = " <- best member" if n == best else ""
        print(f"{n:<{name_w}} | {rows[n][key]:>26.2f} | "
              f"{rows[n]['final_avg_dist_to_goal']:>22.2f}{marker}")
    result = {
        "sweep_members": len(members),
        "eval_formations": m,
        "num_agents": params.num_agents,
        "seed": seed,
        "eval_deterministic": deterministic,
        **({"scenario": scenario, "scenario_severity": severity}
           if scenario else {}),
        "member_returns": {n: rows[n][key] for n in members},
        "best_member": best,
        "best_return": rows[best][key],
        "baseline_return": rows["baseline"][key],
        "beats_baseline": bool(rows[best][key] > rows["baseline"][key]),
        "zero_return": rows["zero"][key],
        "resolved_platform": dev.type,
        "resolved_device": _device_name(dev),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
