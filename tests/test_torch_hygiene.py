"""The port stands alone: no module of ``marl_distributedformation_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax or the JAX package; entry points
with no device raise when no GPU is found instead of running on the CPU.

The scan reads the sources' syntax trees; it does not look at
``sys.modules``, which the test process shares with the JAX tests.
"""

import ast
from pathlib import Path

import pytest
import torch

from marl_distributedformation_tpu_torch import adversarial_search
from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
from marl_distributedformation_tpu_torch import robustness_matrix
from marl_distributedformation_tpu_torch.device import resolve_device
from marl_distributedformation_tpu_torch.env import EnvParams, make_vec_env
from marl_distributedformation_tpu_torch.eval import evaluate, zero_act_fn
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train import cli as train_cli

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "marl_distributedformation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "marl_distributedformation_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", None)
        ) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"knn.py", "knn_cuda.py", "gnn.py", "eval.py", "chip_smoke.py"} <= names
    assert {"gae.py", "optim.py", "ppo.py", "rollout.py", "trainer.py",
            "cli.py", "__main__.py", "logging.py", "checkpoint.py",
            "convert.py"} <= names
    rel = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"envs/spec.py", "envs/registry.py", "envs/formation.py",
            "scenarios/params.py", "scenarios/registry.py",
            "scenarios/layers.py", "scenarios/engine.py",
            "scenarios/schedule.py", "scenarios/matrix.py",
            "scenarios/adversary.py", "envs/pursuit.py",
            "analysis/guards.py", "robustness_matrix.py",
            "adversarial_search.py", "obs/tracer.py", "obs/flightrec.py",
            "chaos/plane.py", "serving/engine.py", "serving/metrics.py",
            "serving/registry.py", "serving/scheduler.py",
            "serving/client.py", "serving/smoke.py", "serving/loadgen.py",
            "serving/autotune.py", "serve.py"} <= rel
    assert (PORT / "csrc" / "knn.cu").exists()


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_a_jax_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import numpy\nfrom marl_distributedformation_tpu.env import x\n"
        "def f():\n    import flax.linen as nn\n"
    )
    assert [m for m in _imports(src) if _forbidden(m)] == [
        "marl_distributedformation_tpu.env", "flax.linen",
    ]
    assert not _forbidden("marl_distributedformation_tpu_torch.env")


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    params = EnvParams(max_steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(zero_act_fn(), params, num_formations=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_vec_env(params, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_cli.main(["eval_formations=2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robustness_matrix.main(["eval_formations=2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adversarial_search.main(["eval_formations=2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(params, config=TrainConfig(num_formations=2),
                model=MLPActorCritic(params.obs_dim))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["num_formation=2", "total_timesteps=10"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert evaluate(zero_act_fn(), params, 2, device="cpu")["episodes"] == 2
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_make_vec_env_on_cpu():
    params = EnvParams(num_agents=6, obs_mode="knn", knn_k=2)
    reset_fn, step_fn = make_vec_env(
        params, 3, device="cpu", generator=torch.Generator().manual_seed(0)
    )
    state, obs = reset_fn()
    assert obs.shape == (3, 6, params.obs_dim)
    state, tr = step_fn(state, torch.ones(3, 6, 2))
    assert torch.equal(state.steps, torch.ones(3, dtype=torch.int32))
    assert tr.obs.shape == obs.shape and torch.isfinite(tr.reward).all()
