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

from marl_distributedformation_tpu_torch import chaos_storm
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
            "serving/fleet/smoke.py", "serving/tenancy/__init__.py",
            "serving/tenancy/directory.py", "serving/tenancy/fleet.py",
            "serving/tenancy/smoke.py", "pipeline/__init__.py",
            "pipeline/stream.py", "pipeline/promote.py", "pipeline/gate.py",
            "pipeline/rollback.py", "pipeline/supervisor.py",
            "always_learning.py", "chaos_storm.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/ring.py", "parallel/distributed.py",
            "parallel/launch.py", "serving/mesh/__init__.py",
            "serving/mesh/rpc.py", "serving/mesh/coordinator.py",
            "serving/mesh/agent.py", "serving/mesh/router.py",
            "serving/mesh/host.py", "serving/mesh/loopback.py",
            "serving/mesh/smoke.py", "serving/sharded.py",
            "serving/elastic/__init__.py", "serving/elastic/controller.py",
            "weak_scaling.py"} <= rel
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
    for flag in ("--train", "--sebulba", "--mesh", "--elastic"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            chaos_storm.main([flag])
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
    # The static linter.
    "analysis": dict.fromkeys((
        "GraftlintConfig", "Violation", "lint_paths", "lint_source",
        "load_config"), "A14"),
    "compat": {"sb3_state_dict_to_flax": "compat.sb3_state_dict_to_torch"},
    "env": {"tree_select": "env.formation._where"},
    "obs": dict.fromkeys((
        "RegressionSentinel", "Watch", "default_watches", "ledger_watches",
        "load_bench_record", "recovery_watches"), "A14"),
    "train": {
        "fold_recovery_key": "train.fold_recovery_generator",
        "make_fused_chunk": "train.capture.PhaseGraph",
    },
    "utils": {
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
UNCALLED_SEAMS: dict = {}

# ``fault_point`` names that are no seam, and why.
NOT_SEAMS = {
    # chaos_storm._measure_overhead times the disabled plane's call on a
    # name that no schedule can arm (as the JAX script's does).
    "storm.overhead_probe": "the storm's overhead probe",
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
    assert not set(NOT_SEAMS) & set(INJECTION_POINTS)
    called -= set(NOT_SEAMS)
    assert called <= set(INJECTION_POINTS), called - set(INJECTION_POINTS)
    open_items = _open_items()
    for point in INJECTION_POINTS:
        if point in UNCALLED_SEAMS:
            assert point not in called, f"{point} is called now"
            item = UNCALLED_SEAMS[point]
            assert re.search(rf"\*\*{item}\b", open_items), (point, item)
        else:
            assert point in called, f"{point} has no fault_point caller"


# ---------------------------------------------------------------------------
# C6: every graph owner captures on a stream of its own
# ---------------------------------------------------------------------------


def _phase_graph_calls():
    """``(path, line, keywords)`` of every ``PhaseGraph(...)`` call in the
    port's package, in ``chip_smoke.py`` and in the port's tests (this
    file's refused calls aside); a keyword given as the literal ``None``
    is left out of its call's keywords. A call with ``capture=False``
    captures nothing and needs no stream."""
    tests = [path for path in sorted((ROOT / "tests").glob("test_torch_*.py"))
             if path.name != Path(__file__).name]
    for path in [*sorted(PORT.rglob("*.py")), ROOT / "chip_smoke.py",
                 *tests]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", None))
                    == "PhaseGraph"):
                keywords = {
                    k.arg for k in node.keywords
                    if not (isinstance(k.value, ast.Constant)
                            and k.value.value is None)}
                eager = any(k.arg == "capture"
                            and isinstance(k.value, ast.Constant)
                            and k.value.value is False
                            for k in node.keywords)
                if not eager:
                    yield path, node.lineno, keywords


def test_every_phase_graph_passes_its_owners_stream():
    """A graph captured on PyTorch's one process-wide capture stream shares
    that stream's cuBLAS workspace with every other graph captured there;
    graphs of different owners replay at once in one process (the trainer,
    the gate's matrix, the fleet's replicas), so each owner passes a stream
    of its own (``train.capture.own_stream``), never a literal None."""
    calls = list(_phase_graph_calls())
    owners = {path.relative_to(ROOT).as_posix() for path, _, _ in calls}
    assert {f"{PORT.name}/{owner}" for owner in (
        "train/trainer.py", "train/sweep.py", "train/sebulba/driver.py",
        "scenarios/matrix.py", "serving/engine.py")} <= owners, owners
    assert "chip_smoke.py" in owners, owners
    missing = [f"{path.relative_to(ROOT)}:{line}"
               for path, line, kw in calls if "stream" not in kw]
    assert not missing, f"PhaseGraph without stream=: {missing}"


def test_a_capturing_phase_graph_needs_its_owners_stream():
    """A phase that captures is refused without a stream, when it is built:
    there is no second way to get one (C6); an eager phase needs none."""
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    with pytest.raises(ValueError, match="own_stream"):
        PhaseGraph("rollout", lambda: None)
    eager = PhaseGraph("rollout", lambda: None, capture=False)
    eager()
    assert eager.calls == 1 and eager.stream is None


def test_launch_counts_go_to_each_owner_on_its_thread(monkeypatch):
    """``knn_cuda.counted_for``: a launch (here a replay's) counts in the
    process's total and in every owner's tally open on the launching
    thread, nested ones too, and in no other thread's."""
    import threading

    from marl_distributedformation_tpu_torch.ops import knn_cuda

    monkeypatch.setattr(knn_cuda, "LAUNCHES",
                        dict.fromkeys(knn_cuda.LAUNCHES, 0))
    outer, gate, other = {}, {}, {}

    def trainer():
        with knn_cuda.counted_for(other):
            for _ in range(5):
                knn_cuda.count_replay({"knn_fused": 10, "knn_tiled": 0})

    with knn_cuda.counted_for(outer):
        knn_cuda.count_replay({"knn_fused": 1})
        thread = threading.Thread(target=trainer)
        thread.start()
        with knn_cuda.counted_for(gate):
            knn_cuda.count_replay({"knn_fused": 7, "knn_tiled": 2})
        thread.join()
    knn_cuda.count_replay({"knn_fused": 100})
    assert other == {"knn_fused": 50, "knn_tiled": 0}
    assert gate == {"knn_fused": 7, "knn_tiled": 2}
    assert outer == {"knn_fused": 8, "knn_tiled": 2}
    assert knn_cuda.LAUNCHES == {"knn_fused": 158, "knn_tiled": 2}
