"""``cfg/config.yaml`` with hydra-style ``key=value`` overrides.

A copy of the part of the JAX package's ``utils/config.py`` that evaluation
and training need: ``load_config`` with ``PRESETS``, ``apply_overrides``,
``validate_override_keys`` and ``env_params_from_config``, which resolve
``env=`` through the env registry (``envs/``) and validate overrides against
the selected env's params class, and ``scenario_schedule_from_config``. The
port reads the same YAML file and never writes it.
"""

from __future__ import annotations

import dataclasses
import difflib
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import yaml

from marl_distributedformation_tpu_torch.envs import EnvSpec, get_env

# Dot-less scientific notation that YAML 1.1 leaves as a string.
_SCI_NOTATION_RE = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


class Config(dict):
    """Dict with attribute access (``cfg.num_formation``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def repo_root() -> Path:
    """Root of the repository (where ``cfg/`` and ``logs/`` live)."""
    return Path(__file__).resolve().parent.parent.parent


def _parse_value(raw: str) -> Any:
    """YAML semantics, plus ``3e-4`` as a float (hydra's behavior)."""
    value = yaml.safe_load(raw)
    if isinstance(value, str) and _SCI_NOTATION_RE.match(value):
        return float(value)
    return value


def as_override(value: Any) -> Any:
    """``value`` as the override of its own text would parse: YAML leaves
    ``1.0e6`` a string, an override makes it a float."""
    if isinstance(value, str):
        return _parse_value(value)
    return value


def _to_config(data: Any) -> Any:
    if isinstance(data, dict):
        return Config({k: _to_config(v) for k, v in data.items()})
    return data


def read_yaml(config_path: str) -> Dict[str, Any]:
    path = Path(config_path)
    if not path.is_absolute() and not path.exists():
        path = repo_root() / config_path
    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_overrides(cfg: Dict[str, Any], overrides: Iterable[str]) -> None:
    """Apply ``key=value`` overrides (dotted keys allowed) in place."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, raw = item.split("=", 1)
        target = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            if not isinstance(target.get(part), dict):
                target[part] = Config()
            target = target[part]
        target[parts[-1]] = _parse_value(raw)


# Named hyperparameter bundles (``preset=tpu``), as in the JAX package.
# Precedence: YAML defaults < preset < explicit CLI overrides.
PRESETS: Dict[str, Dict[str, Any]] = {
    "tpu": {"batch_size": 16384},
}


def load_config(
    overrides: Optional[List[str]] = None,
    config_path: str = "cfg/config.yaml",
) -> Config:
    """The YAML config with its ``preset`` and then the CLI overrides
    applied. An unknown preset raises."""
    data = read_yaml(config_path)
    cfg = _to_config(data)
    overrides = list(overrides or [])
    preset = next(
        (
            _parse_value(o.split("=", 1)[1])
            for o in reversed(overrides)
            if "=" in o and o.split("=", 1)[0] == "preset"
        ),
        data.get("preset"),
    )
    if preset:
        if preset not in PRESETS:
            raise ValueError(
                f"unknown preset {preset!r}; available: {sorted(PRESETS)}"
            )
        cfg.update(_to_config(PRESETS[preset]))
    apply_overrides(cfg, overrides)
    return cfg


def scenario_schedule_from_config(cfg: Config):
    """The scenario-training schedule of the ``scenarios`` and
    ``scenario_severity`` keys, or None when scenario training is off.
    Unknown scenario names exit here, at config time, naming the
    registry's entries."""
    raw = cfg.get("scenarios")
    if not raw:
        return None
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )

    try:
        return schedule_from_cfg(
            raw, default_severity=float(cfg.get("scenario_severity") or 0.0)
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e


def env_spec_or_exit(name: Any) -> EnvSpec:
    """The registered env of that name; the registry's ValueError
    (did-you-mean and listing) becomes the entry point's SystemExit."""
    try:
        return get_env(str(name))
    except ValueError as e:
        raise SystemExit(str(e)) from e


def validate_override_keys(
    overrides: Iterable[str],
    extra_keys: Iterable[str] = (),
    config_path: str = "cfg/config.yaml",
) -> None:
    """Exit on a mistyped override key. Valid keys are the YAML's, the
    fields of the selected env's params class (``env=`` peeked from the
    overrides, so a mistyped env name exits here with the registry's
    did-you-mean) and ``extra_keys``; a dotted key validates its first
    segment."""
    overrides = list(overrides)
    data = read_yaml(config_path)
    known = set(data)
    env_name = next(
        (
            _parse_value(o.split("=", 1)[1])
            for o in reversed(overrides)
            if "=" in o and o.split("=", 1)[0] == "env"
        ),
        data.get("env", "formation"),
    )
    spec = env_spec_or_exit(env_name)
    known |= {f.name for f in dataclasses.fields(spec.params_cls)}
    known |= {"env"} | set(extra_keys)
    for item in overrides:
        if "=" not in item:
            continue  # apply_overrides raises its own error for these
        key = item.split("=", 1)[0].split(".")[0]
        if key not in known:
            close = difflib.get_close_matches(key, known, n=1)
            hint = f" (did you mean {close[0]!r}?)" if close else ""
            raise SystemExit(
                f"unknown config key {key!r}{hint}; valid keys: "
                f"{', '.join(sorted(known))}"
            )


# JAX-backend selectors with no meaning in the port: it picks its device
# with ``device``.
JAX_ONLY = ("platform", "backend")


def refuse_jax_only(cfg: Dict[str, Any],
                    defaults: Optional[Dict[str, Any]] = None) -> None:
    """Exit when ``cfg`` sets ``platform`` or ``backend`` to anything but
    its value in ``defaults`` (the YAML's, for an entry point that reads
    it)."""
    defaults = defaults or {}
    for key in JAX_ONLY:
        if cfg.get(key) != defaults.get(key):
            raise SystemExit(
                f"{key}={cfg[key]!r} selects the JAX backend; the port "
                "runs on PyTorch and picks its device with device=cuda|cpu"
            )


def env_params_from_config(cfg: Config):
    """The selected env's params (``env``, default ``formation``) from the
    flat config, every field the config sets forwarded
    (``share_reward_ratio`` included, SURVEY.md Q6)."""
    spec = env_spec_or_exit(cfg.get("env", "formation"))
    kwargs = {
        "num_agents": cfg.num_agents_per_formation,
        "share_reward_ratio": cfg.share_reward_ratio,
        "goal_in_obs": cfg.goal_in_obs,
    }
    for f in dataclasses.fields(spec.params_cls):
        if f.name in cfg and f.name != "num_agents":
            kwargs[f.name] = cfg[f.name]
    return spec.params_cls(**kwargs)
