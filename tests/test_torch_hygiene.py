"""The port stands alone: no module of ``marl_distributedformation_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax or the JAX package; entry points
with no device raise when no GPU is found instead of running on the CPU;
every package imports without gymnasium and matplotlib; and each
subpackage exports what the JAX package's does, but for names mapped to a
counterpart or named by an open ROADMAP item.

The scan reads the sources' syntax trees; it does not look at
``sys.modules``, which the test process shares with the JAX tests.
"""

import ast
import importlib
import re
import subprocess
import sys
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
            "serving/autotune.py", "serve.py", "obs/metrics.py",
            "obs/export.py", "obs/ledger.py", "utils/profiling.py",
            "train/sebulba/__init__.py", "train/sebulba/queues.py",
            "train/sebulba/driver.py", "compat/vec_env.py",
            "compat/gym_env.py", "compat/gym_vector_env.py",
            "compat/render.py", "compat/sb3_import.py", "env/spaces.py",
            "simulate.py", "visualize_policy.py", "keyboard_move.py",
            "vectorized_env.py", "examples/functional_env.py",
            "examples/custom_policy.py", "chaos/watchdog.py",
            "chaos/invariants.py", "serving/fleet/__init__.py",
            "serving/fleet/metrics.py", "serving/fleet/reload.py",
            "serving/fleet/router.py", "serving/fleet/frontend.py",
            "serving/fleet/smoke.py"} <= rel
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


# ---------------------------------------------------------------------------
# The package surfaces against the JAX package's (ROADMAP C5)
# ---------------------------------------------------------------------------

JAX = ROOT / "marl_distributedformation_tpu"
# A JAX export the port does not export: its counterpart (a dotted path in
# the port) or the open ROADMAP item that ports it.
NOT_EXPORTED = {
    "parallel": "A12",
    "pipeline": "A13",
    # The static linter.
    "analysis": dict.fromkeys((
        "GraftlintConfig", "Violation", "lint_paths", "lint_source",
        "load_config"), "A14"),
    # It reads the pipeline's audit log.
    "chaos": {"check_audit_log": "A13"},
    "compat": {"sb3_state_dict_to_flax": "compat.sb3_state_dict_to_torch"},
    "env": {"tree_select": "env.formation._where"},
    "obs": dict.fromkeys((
        "RegressionSentinel", "Watch", "default_watches", "ledger_watches",
        "load_bench_record", "recovery_watches"), "A14"),
    "serving": dict.fromkeys((
        "CapacityController", "CapacityDecision", "ShardedPolicyEngine",
        "ShardedSpec"), "A13"),
    "train": {
        "assign_gate_device": "A13",
        "fold_recovery_key": "train.fold_recovery_generator",
        "make_fused_chunk": "train.capture.PhaseGraph",
    },
    "utils": {
        "broadcast_restore": "A12",
        "own_restored": "A12",
        "read_checkpoint_payload": "utils.strip_footer",
        "restore_checkpoint": "utils.restore_state_dict_partial",
        "restore_checkpoint_partial": "utils.restore_state_dict_partial",
        "setup_platform": "device.resolve_device",
    },
}


def _exported(init: Path):
    """The public names an ``__init__.py`` binds (imports, assignments,
    definitions), from its syntax tree: nothing of it runs."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


def _open_items():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("## Open items")
    return text[start:text.index("Closed (kept for the IDs", start)]


def _resolves(dotted: str) -> bool:
    module, _, attr = dotted.rpartition(".")
    try:
        mod = importlib.import_module(
            "marl_distributedformation_tpu_torch." + module)
    except ImportError:
        return False
    return hasattr(mod, attr)


SUBPACKAGES = sorted(p.parent.name for p in JAX.glob("*/__init__.py"))


@pytest.mark.parametrize("sub", ["", *SUBPACKAGES])
def test_package_surface_matches_jax(sub):
    jax_names = _exported(JAX / sub / "__init__.py")
    allowed = NOT_EXPORTED.get(sub, {})
    if isinstance(allowed, str):  # a whole subpackage still to port
        assert not (PORT / sub).exists(), sub
        assert re.search(rf"\*\*{allowed}\b", _open_items()), allowed
        return
    port = importlib.import_module(
        "marl_distributedformation_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in jax_names
                     if not hasattr(port, n) and n not in allowed)
    assert not missing, f"{sub or 'top level'}: not exported: {missing}"
    open_items = _open_items()
    for name, where in allowed.items():
        assert name in jax_names, f"{sub}.{name} is not the JAX package's"
        assert not hasattr(port, name), f"{sub}.{name} is exported now"
        if re.fullmatch(r"A\d+", where):
            assert re.search(rf"\*\*{where}\b", open_items), (name, where)
        else:
            assert _resolves(where), (name, where)


def test_packages_import_without_gymnasium_and_matplotlib():
    """Neither package is on the card's machine: every ``__init__``, the
    tools and the VecEnv import without them, and what needs one names
    it."""
    inits = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts[:-1])
                   for p in PORT.rglob("__init__.py"))
    tools = [f"marl_distributedformation_tpu_torch.{m}" for m in (
        "simulate", "visualize_policy", "keyboard_move", "vectorized_env",
        "compat.vec_env", "compat.render", "compat.sb3_import")]
    code = f"""
import importlib, sys
sys.modules["gymnasium"] = None
sys.modules["matplotlib"] = None
for name in {inits + tools!r}:
    importlib.import_module(name)
for name, needs in (("compat.gym_env", "gymnasium"),
                    ("compat.gym_vector_env", "gymnasium")):
    try:
        importlib.import_module("marl_distributedformation_tpu_torch." + name)
    except ImportError as e:
        assert needs in str(e), e
    else:
        raise AssertionError(name + " imported without " + needs)
from marl_distributedformation_tpu_torch.compat.render import FormationRenderer
from marl_distributedformation_tpu_torch.env import Box, EnvParams
for build, needs in ((lambda: FormationRenderer(EnvParams()), "matplotlib"),
                     (lambda: Box(-1.0, 1.0, (2,)).to_gymnasium(),
                      "gymnasium")):
    try:
        build()
    except ImportError as e:
        assert needs in str(e), e
    else:
        raise AssertionError("built without " + needs)
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


# ---------------------------------------------------------------------------
# The chaos plane's seam catalogue
# ---------------------------------------------------------------------------

# Injection points the port declares but no port code calls yet: the
# module that calls each one is still to port, under its ROADMAP item.
UNCALLED_SEAMS = {
    "stream.poll": "A13",  # pipeline/stream.py
    "gate.eval": "A13",  # pipeline/gate.py
    "pipeline.poll": "A13",  # pipeline/supervisor.py
    "mesh.rpc": "A13",  # serving/mesh/
    "mesh.heartbeat": "A13",
    "mesh.prepare": "A13",
    "mesh.commit": "A13",
    "elastic.prewarm": "A12",  # serving/elastic/ (A13, re-splits devices)
    "elastic.commit": "A12",
    "elastic.retire": "A12",
}


def _fault_point_callers():
    """Every ``fault_point("name", ...)`` literal in the port's sources."""
    names = set()
    for path in SOURCES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", None))
                    == "fault_point"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_every_injection_point_has_a_caller_or_an_open_item():
    """A seam in the catalogue that no code calls would let a seeded
    campaign arm faults that never fire and pass vacuously: each point has
    a ``fault_point`` caller in the port, or names the open ROADMAP item
    that ports its caller (and then has none yet)."""
    from marl_distributedformation_tpu_torch.chaos import INJECTION_POINTS

    called = _fault_point_callers()
    assert called <= set(INJECTION_POINTS), called - set(INJECTION_POINTS)
    open_items = _open_items()
    for point in INJECTION_POINTS:
        if point in UNCALLED_SEAMS:
            assert point not in called, f"{point} is called now"
            item = UNCALLED_SEAMS[point]
            assert re.search(rf"\*\*{item}\b", open_items), (point, item)
        else:
            assert point in called, f"{point} has no fault_point caller"
