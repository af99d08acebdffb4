"""The harness on the CPU at tiny sizes: the cells run and come out
correct, the planted faults come out not correct, new parts are found by
name, and nothing imports JAX."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

ROOT = harness.ROOT
CELLS = ["tinygnn.train", "tinyring.train", "tinyshort.eval"]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny.make_bench(tmp_path_factory.mktemp("bench"))


def run_cell(spec, name, trace=False):
    result, rows, _ = harness.run(tiny.cell(spec, name), seed=2**31 + 11,
                                  seconds=0.2, trace=trace, device="cpu",
                                  t0=time.perf_counter())
    return result, rows


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_is_correct(spec, name):
    result, rows = run_cell(spec, name)
    assert result["correct"], rows
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = ("eval_agent_steps_per_s" if name.endswith("eval")
           else "train_agent_steps_per_s")
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert list(result)[-1] == "check"
    assert json.loads(json.dumps(result)) == result


def _plant(monkeypatch, fault):
    """One fault in the program, where it is produced."""
    from marl_distributedformation_tpu_torch import eval as program_eval
    from marl_distributedformation_tpu_torch.algo import ppo
    from marl_distributedformation_tpu_torch.algo.optim import global_norm
    from marl_distributedformation_tpu_torch.env import formation
    from marl_distributedformation_tpu_torch.models import distributions

    integrate = formation.integrate
    if fault == "state_unchanged":
        # The update's step leaves parameters and Adam's state as they are.
        monkeypatch.setattr(ppo, "clipped_adam_step",
                            lambda p, g, s, lr, cap, eps: global_norm(g))
    elif fault == "half_batch":
        take = ppo.MinibatchData.take
        monkeypatch.setattr(ppo.MinibatchData, "take",
                            lambda self, idx: take(self, idx[:len(idx) // 2]))
    elif fault == "altered_action":
        def altered(agents, velocity, params):
            velocity = velocity.clone()
            velocity[0] = -velocity[0]
            return integrate(agents, velocity, params)
        monkeypatch.setattr(formation, "integrate", altered)
    elif fault == "noise_dropped":
        # Every action drawn as the policy's mean, without its noise.
        monkeypatch.setattr(distributions, "sample",
                            lambda generator, mean, log_std: mean.clone())
    elif fault == "one_agent_nudged":
        # One agent of one formation a thousandth faster, every step.
        def nudged(agents, velocity, params):
            velocity = velocity.clone()
            velocity[0, 0] *= 1.001
            return integrate(agents, velocity, params)
        monkeypatch.setattr(formation, "integrate", nudged)
    elif fault == "frozen_env":
        monkeypatch.setattr(
            formation, "integrate",
            lambda agents, velocity, params: integrate(
                agents, torch.zeros_like(velocity), params))
    elif fault == "half_formations":
        step_row = program_eval.step_row
        monkeypatch.setattr(
            program_eval, "step_row",
            lambda tr, copies=1: step_row(type(tr)(
                obs=tr.obs, reward=tr.reward[: len(tr.reward) // 2],
                done=tr.done, metrics=tr.metrics), copies))
    elif fault == "answer_altered":
        summary = program_eval.episode_summary

        def dropped_last_step(rows, T):
            out = summary(rows, T)
            out["episode_return_per_agent"] = rows["reward"][..., :-1].sum(-1)
            return out
        monkeypatch.setattr(program_eval, "episode_summary",
                            dropped_last_step)


@pytest.mark.parametrize("name, fault", [
    ("tinygnn.train", "state_unchanged"),
    ("tinygnn.train", "half_batch"),
    ("tinygnn.train", "altered_action"),
    ("tinygnn.train", "noise_dropped"),
    ("tinyring.train", "state_unchanged"),
    ("tinyring.train", "half_batch"),
    ("tinyring.train", "altered_action"),
    ("tinyring.train", "noise_dropped"),
    ("tinyshort.eval", "frozen_env"),
    ("tinyshort.eval", "half_formations"),
    ("tinyshort.eval", "answer_altered"),
    ("tinyshort.eval", "altered_action"),
    ("tinyshort.eval", "one_agent_nudged"),
])
def test_planted_fault_is_not_correct(spec, monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    result, rows = run_cell(spec, name)
    assert not result["correct"], rows


@pytest.mark.parametrize("name", ["tinygnn.train", "tinyring.train",
                                  "tinyshort.eval"])
def test_control_is_not_correct(spec, name):
    """The reference in TF32 in the program's place fails the cell's
    limits (the tiny cells' own; the real cells' are read on the card)."""
    from benchmark import calibrate, check

    cell = tiny.cell(spec, name)
    for seed in (1, 2):
        numbers = calibrate.stand_in(cell, seed, "cpu", "tf32")
        ok, rows = check.verdict(numbers, cell.limits)
        assert not ok, rows


def test_new_parts_are_found_by_name(spec, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files run with no existing file edited."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(spec.parent / "benchmark", root / "benchmark")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    data = json.loads(spec.read_text())
    config = tiny.tiny_configs()["tinyring"]
    config["overrides"] = [o.replace("num_formation=8", "num_formation=6")
                           for o in config["overrides"]]
    config["num_formations"] = 6
    (root / "benchmark" / "configs" / "newring.json").write_text(
        json.dumps(config))
    (root / "benchmark" / "traffic" / "train_two.json").write_text(
        json.dumps({"kind": "train", "check_iterations": 2}))
    (root / "benchmark" / "workloads" / "newring.train.json").write_text(
        json.dumps({"limits": tiny.TRAIN_LIMITS}))
    (root / "benchmark" / "layers" / "window_gflop.train.py").write_text(
        "def read(r):\n    return r.flops / 1e9 if r.flops else None\n")
    data["configs"].append({"name": "newring", "source": "a test",
                            "file": "benchmark/configs/newring.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "newring.train", "config": "newring",
                              "traffic": "train_two", "chips": 1,
                              "why": "a test"})
    data["per_layer"].append({"name": "window_gflop.train", "unit": "GFLOP",
                              "better": "higher", "source": "host_clock",
                              "layer": "models",
                              "moves": "train_agent_steps_per_s",
                              "workloads": ["newring.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    cell = tiny.cell(root / "BENCHMARK.json", "newring.train")
    result, rows, _ = harness.run(cell, seed=5, seconds=0.2, trace=True,
                                  device="cpu", t0=time.perf_counter())
    assert result["correct"], rows
    assert result["metrics"]["window_gflop.train"]["value"] > 0
    for path, content in before.items():
        assert path.read_bytes() == content, path


def test_no_jax_in_a_run(spec):
    """A whole tiny run in a fresh interpreter loads neither JAX nor the
    JAX package (top-level names compared whole)."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
from benchmark.tests import tiny
from pathlib import Path
result, _, _ = harness.run(tiny.cell(Path({str(spec)!r}), "tinygnn.train"),
                        seed=3, seconds=0.2, trace=False, device="cpu",
                        t0=time.perf_counter())
assert result["correct"]
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"top": top, "forbidden":
                  harness.forbidden_modules(sys.modules)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    assert "marl_distributedformation_tpu_torch" in seen["top"]
    assert not {"jax", "jaxlib", "flax",
                "marl_distributedformation_tpu"} & set(seen["top"])


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(
        ["marl_distributedformation_tpu_torch.eval", "jaxtyping", "torch"]
    ) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "marl_distributedformation_tpu.env"]
    ) == ["jax", "marl_distributedformation_tpu"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "gnn100.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_checkout_prints_no_result(tmp_path):
    """With only BENCHMARK.json and the benchmark, the program is missing:
    the run fails before it prints a result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "harness.run(harness.Cell('ring5.train'), 1, 0.1, False, 'cpu',"
            " time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "marl_distributedformation_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
