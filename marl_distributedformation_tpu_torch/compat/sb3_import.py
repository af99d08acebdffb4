"""Stable-baselines3 PPO checkpoints into the framework's checkpoint format,
and back.

Counterpart of the JAX package's ``compat/sb3_import.py``. A reference
user's trained artifacts are SB3 ``PPO.save`` zips named
``rl_model_{steps}_steps.zip`` (reference vectorized_env.py:124,
visualize_policy.py:31-35). ``import_sb3_checkpoint`` converts one into an
``rl_model_{steps}_steps.msgpack`` in the JAX package's layout, written as
the port's checkpoint writer writes (``utils.checkpoint.write_atomic``:
footer, non-finite refusal, atomic rename), so playback, evaluation and a
warm start read it in either package. ``export_sb3_state_dict`` writes a
framework checkpoint's MLP back as a torch ``state_dict`` under SB3
naming.

Format facts (SB3 ``save_to_zip_file``): the zip holds ``data`` (JSON of
constructor arguments), ``policy.pth`` (a torch ``state_dict``) and
optimizer and system entries. For ``'MlpPolicy'`` (the reference's choice,
vectorized_env.py:126) the ``state_dict`` keys are::

    log_std                                          (act_dim,)
    mlp_extractor.policy_net.{0,2,...}.weight/.bias  pi hidden layers
    mlp_extractor.value_net.{0,2,...}.weight/.bias   vf hidden layers
    action_net.weight/.bias                          pi head
    value_net.weight/.bias                           vf head

The port's ``MLPActorCritic`` is the same two tanh towers in
``torch.nn.Linear``'s own ``(out, in)`` layout, so ``sb3_state_dict_to_torch``
renames and never transposes; ``compat.convert`` transposes into the JAX
package's ``(in, out)`` kernels for the file. stable_baselines3 itself is
not needed. A shared-trunk ``net_arch`` (``mlp_extractor.shared_net.*``,
the pre-1.6 SB3 default) is refused: the framework's MLP is the separate
towers the reference trains.
"""

from __future__ import annotations

import io
import re
import zipfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.compat.convert import (
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    msgpack_restore_file,
    write_atomic,
)

_LINEAR_KEY = re.compile(
    r"^mlp_extractor\.(policy|value)_net\.(\d+)\.(weight|bias)$"
)
_HEADS = ("action_net.weight", "action_net.bias", "value_net.weight",
          "value_net.bias", "log_std")


def _load_policy_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """``policy.pth`` of an SB3 zip, or a bare torch ``state_dict`` file
    (itself a zip since torch 1.6, so zip-ness alone identifies nothing),
    as numpy arrays."""
    blob = None
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            if "policy.pth" in names:
                blob = zf.read("policy.pth")
            elif not any(n.endswith("data.pkl") for n in names):
                raise ValueError(
                    f"{path} is a zip with neither policy.pth (SB3 "
                    f"PPO.save) nor data.pkl (torch state_dict) "
                    f"(entries: {sorted(names)[:8]}...)"
                )
    source = io.BytesIO(blob) if blob is not None else path
    state = torch.load(source, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in state.items()}


def sb3_state_dict_to_torch(
    state: Dict[str, np.ndarray],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """An SB3 ActorCriticPolicy ``state_dict`` as the port's
    ``MLPActorCritic`` ``state_dict`` (``pi_{j}``, ``vf_{j}``, ``pi_head``,
    ``vf_head``, ``log_std``), and ``info``: the inferred ``obs_dim``,
    ``act_dim`` and hidden widths."""
    if any(k.startswith("mlp_extractor.shared_net") for k in state):
        raise ValueError(
            "SB3 checkpoint uses a shared-trunk net_arch "
            "(mlp_extractor.shared_net.*); only the separate pi/vf "
            "networks of the reference's 'MlpPolicy' are importable"
        )
    # nn.Sequential interleaves activations, so the Linear indices are
    # 0, 2, 4, ...; sorting restores the layer order.
    hidden: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {
        "policy": {}, "value": {},
    }
    for key, arr in state.items():
        m = _LINEAR_KEY.match(key)
        if m:
            net, idx, part = m.group(1), int(m.group(2)), m.group(3)
            hidden[net].setdefault(idx, {})[part] = arr
    for head in _HEADS:
        if head not in state:
            raise ValueError(
                f"SB3 checkpoint missing {head!r} — keys: "
                f"{sorted(state)[:12]}..."
            )

    def tensor(arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}
    widths = []
    for net, prefix in (("policy", "pi"), ("value", "vf")):
        layers = [hidden[net][i] for i in sorted(hidden[net])]
        if not layers:
            raise ValueError(
                f"SB3 checkpoint has no mlp_extractor.{net}_net layers"
            )
        for j, layer in enumerate(layers):
            if "weight" not in layer or "bias" not in layer:
                missing = "bias" if "bias" not in layer else "weight"
                raise ValueError(
                    f"SB3 checkpoint's mlp_extractor.{net}_net layer {j} "
                    f"is missing {missing} — malformed state_dict"
                )
            out[f"{prefix}_{j}.weight"] = tensor(layer["weight"])
            out[f"{prefix}_{j}.bias"] = tensor(layer["bias"])
        if net == "policy":
            widths = [layer["weight"].shape[0] for layer in layers]
    for head, name in (("action_net", "pi_head"), ("value_net", "vf_head")):
        out[f"{name}.weight"] = tensor(state[f"{head}.weight"])
        out[f"{name}.bias"] = tensor(state[f"{head}.bias"])
    out["log_std"] = tensor(state["log_std"]).reshape(-1)
    info = {
        "obs_dim": int(out["pi_0.weight"].shape[1]),
        "act_dim": int(state["action_net.weight"].shape[0]),
        "hidden": tuple(widths),
    }
    return out, info


def torch_state_dict_to_sb3(
    params: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """The reverse mapping: an ``MLPActorCritic`` ``state_dict`` under SB3
    ActorCriticPolicy naming (the JAX package's
    ``flax_params_to_sb3_state_dict``, ``compat/sb3_import.py:239``). On
    the reference stack, load it with
    ``model.policy.load_state_dict(torch.load(path))``."""
    state = {"log_std": params["log_std"].detach().cpu().clone()}
    for prefix, net in (("pi", "policy"), ("vf", "value")):
        j = 0
        while f"{prefix}_{j}.weight" in params:
            for part in ("weight", "bias"):
                state[f"mlp_extractor.{net}_net.{2 * j}.{part}"] = (
                    params[f"{prefix}_{j}.{part}"].detach().cpu().clone())
            j += 1
        if j == 0:
            raise ValueError(
                f"params carry no {prefix}_0 layer — only MLPActorCritic "
                "checkpoints export to the SB3 MlpPolicy shape"
            )
    for name, head in (("pi_head", "action_net"), ("vf_head", "value_net")):
        for part in ("weight", "bias"):
            state[f"{head}.{part}"] = params[f"{name}.{part}"].detach(
            ).cpu().clone()
    return state


def _steps_from_name(path: Path) -> Optional[int]:
    m = re.search(r"rl_model_(\d+)_steps", path.name)
    return int(m.group(1)) if m else None


def output_path(
    src: Path,
    out_dir: Optional[str | Path] = None,
    num_timesteps: Optional[int] = None,
) -> Path:
    """Where ``import_sb3_checkpoint`` writes for these inputs."""
    steps = (num_timesteps if num_timesteps is not None
             else (_steps_from_name(src) or 0))
    base = Path(out_dir) if out_dir is not None else src.parent
    return base / f"rl_model_{steps}_steps.msgpack"


def import_sb3_checkpoint(
    src: str | Path,
    out_dir: Optional[str | Path] = None,
    num_timesteps: Optional[int] = None,
) -> Path:
    """Convert one SB3 ``rl_model_{steps}_steps.zip`` (or a bare policy
    ``.pth``) into a framework checkpoint next to it (or under
    ``out_dir``), named so ``utils.latest_checkpoint`` finds it.

    The file carries the policy's parameters only: a warm-started run
    starts a fresh optimizer state (SB3's Adam moments do not map onto
    optax's tree)."""
    src = Path(src)
    params, info = sb3_state_dict_to_torch(_load_policy_state_dict(src))
    steps = (num_timesteps if num_timesteps is not None
             else (_steps_from_name(src) or 0))
    out = output_path(src, out_dir, num_timesteps)
    write_atomic(out, {
        "policy": "MLPActorCritic",
        "params": params_to_jax(params, "MLPActorCritic"),
        "num_timesteps": steps,
        "sb3_import": {
            "source": src.name,
            "obs_dim": info["obs_dim"],
            "act_dim": info["act_dim"],
            "hidden": list(info["hidden"]),
        },
    })
    return out


def export_sb3_state_dict(
    src: str | Path, out: Optional[str | Path] = None
) -> Path:
    """Export a framework checkpoint's policy to ``{stem}.sb3.pth`` (a torch
    ``state_dict`` under SB3 naming; not a whole ``PPO.save`` zip, whose
    ``data`` entry is SB3's own version-dependent serialization)."""
    src = Path(src)
    raw = msgpack_restore_file(src)
    policy = raw.get("policy", "MLPActorCritic")
    if policy != "MLPActorCritic":
        raise ValueError(
            f"checkpoint policy {policy!r} has no SB3 equivalent; only "
            "MLPActorCritic maps onto 'MlpPolicy'"
        )
    state = torch_state_dict_to_sb3(
        params_from_jax(raw["params"], "MLPActorCritic"))
    out = Path(out) if out is not None else src.with_suffix(".sb3.pth")
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    return out


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert SB3 PPO checkpoints (rl_model_*_steps.zip) "
        "to framework checkpoints for playback/eval/fine-tuning — or, "
        "with --export, framework checkpoints back to torch state_dicts "
        "under SB3 MlpPolicy naming."
    )
    ap.add_argument("src", nargs="+", help="SB3 .zip (or bare policy "
                    ".pth); with --export: framework .msgpack checkpoints")
    ap.add_argument("--out-dir", default=None, help="output directory "
                    "(default: next to each source file)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override num_timesteps (default: parsed from "
                    "the rl_model_{steps}_steps filename)")
    ap.add_argument("--export", action="store_true",
                    help="reverse direction: framework checkpoint -> "
                    "{stem}.sb3.pth torch state_dict (load on the "
                    "reference stack via policy.load_state_dict)")
    args = ap.parse_args(argv)
    if args.export:
        if args.steps is not None:
            ap.error("--steps does not apply to --export")
        planned_out: Dict[Path, str] = {}
        for src in args.src:
            dest = (
                Path(args.out_dir) / (Path(src).stem + ".sb3.pth")
                if args.out_dir is not None
                else Path(src).with_suffix(".sb3.pth")
            )
            if dest in planned_out:
                ap.error(
                    f"output collision: {src} and {planned_out[dest]} "
                    f"both map to {dest}"
                )
            planned_out[dest] = src
        for dest, src in planned_out.items():
            print(f"{src} -> {export_sb3_state_dict(src, dest)}")
        return
    if args.steps is not None and len(args.src) > 1:
        ap.error("--steps with multiple sources would write every input "
                 "to the same rl_model_{steps}_steps.msgpack")
    # Every collision is found before the first write.
    planned: Dict[Path, str] = {}
    for src in args.src:
        out = output_path(Path(src), args.out_dir, args.steps)
        if out in planned:
            ap.error(
                f"output collision: {src} and {planned[out]} both map to "
                f"{out} — pass distinct --out-dir per run"
            )
        planned[out] = src
    for out, src in planned.items():
        import_sb3_checkpoint(src, args.out_dir, args.steps)
        print(f"{src} -> {out}")


if __name__ == "__main__":
    main()
