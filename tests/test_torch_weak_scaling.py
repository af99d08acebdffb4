"""The port's weak-scaling script (``marl_distributedformation_tpu_torch/
weak_scaling.py``) on the CPU, held against ``scripts/weak_scaling.py``.

The knobs and their defaults equal the JAX script's; the script runs at
D=1 and D=2 gloo ranks with tiny knobs, and each of its rows carries the
JAX script's row schema (the keys of its ``emit``, found by an AST scan:
no JAX child runs) with finite positive timings, labelled with the device,
backend and what it measures.
"""

import ast
import importlib.util
import math
import os
import pathlib

import pytest
import torch

from marl_distributedformation_tpu_torch import weak_scaling

SCRIPT = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
          / "weak_scaling.py")
TINY = {"WS_M_TOTAL": "8", "WS_M_TRAIN": "8", "WS_M_MEMBER": "4",
        "WS_ENV_CHUNK": "2", "WS_MIN_TIMED_S": "0.05"}
KNOBS = ("WS_DEVICES", *TINY)


def _jax_script():
    """The JAX script at its defaults (its module imports no JAX)."""
    saved = {k: os.environ.pop(k) for k in KNOBS if k in os.environ}
    try:
        spec = importlib.util.spec_from_file_location("jax_weak_scaling",
                                                      SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        os.environ.update(saved)


def _jax_row_keys():
    """The keys of the row dict the JAX script's ``emit`` prints."""
    tree = ast.parse(SCRIPT.read_text())
    emit = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "emit")
    row = next(n for n in ast.walk(emit) if isinstance(n, ast.Dict))
    return tuple(k.value for k in row.keys)


def test_knobs_and_row_schema_equal_jax():
    jax_ws = _jax_script()
    for name in ("M_TOTAL", "M_TRAIN", "M_PER_MEMBER", "N_AGENTS",
                 "ENV_CHUNK", "MIN_TIMED_S"):
        if not any(k in os.environ for k in KNOBS):
            assert getattr(weak_scaling, name) == getattr(jax_ws, name), name
    assert weak_scaling.device_counts("cpu") == list(jax_ws.DEVICE_COUNTS)
    assert weak_scaling.ROW_KEYS == _jax_row_keys()


@pytest.fixture(scope="module")
def rows():
    saved = {k: os.environ.get(k) for k in TINY}
    os.environ.update(TINY)
    try:
        return weak_scaling.parent("cpu", [1, 2], timeout_s=300.0)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("phase", ["dp_env", "dp_train", "sweep"])
def test_rows_at_one_and_two_ranks(rows, phase):
    got = {r["devices"]: r for r in rows if r["phase"] == phase}
    assert sorted(got) == [1, 2]
    for d, row in got.items():
        assert set(weak_scaling.ROW_KEYS) <= set(row)
        assert row["phase"] == phase and row["devices"] == d
        assert math.isfinite(row["seconds_per_call"])
        assert row["seconds_per_call"] > 0
        assert row["steps_per_sec"] > 0
        assert row["device"] == "cpu" and row["backend"] == "gloo"
        assert f"{d} ranks" in row["note"]


def test_needs_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weak_scaling.main([])
