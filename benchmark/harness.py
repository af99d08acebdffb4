"""Finds a cell's parts by name and runs it.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the entry's ``file``): the model configuration;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``kind`` names
  the driver ``traffic/<kind>.py`` (``drive(...) -> readings.Outcome``);
- ``workloads/<cell>.json``: the cell's limits for the check's numbers
  (``limits``), and parameters of its own that override its mix's
  (``traffic``, such as the segment its traced run profiles);
- ``layers/<metric>.py``: a per-layer metric's reader, ``read(readings)``,
  which returns None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

from benchmark import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "marl_distributedformation_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its parts."""

    def __init__(self, name: str, bench_dir: Path = HERE,
                 spec_path: Path = ROOT / "BENCHMARK.json") -> None:
        spec = load_json(spec_path)
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise SystemExit(f"no workload {name!r} in {spec_path.name}; "
                             f"there are {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.dir = bench_dir
        config = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = load_json(spec_path.parent / config["file"])
        own = load_json(bench_dir / "workloads" / f"{name}.json")
        self.mix = {**load_json(bench_dir / "traffic"
                                / f"{self.entry['traffic']}.json"),
                    **own.get("traffic", {})}
        self.limits = own["limits"]
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, name)]

    def driver(self):
        kind = self.mix["kind"]
        return _load(self.dir / "traffic" / f"{kind}.py",
                     f"bench_traffic_{kind}")

    def reader(self, metric: str):
        return _load(self.dir / "layers" / f"{metric}.py",
                     f"bench_layer_{metric.replace('.', '_')}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> Tuple[Dict[str, Any], List[Tuple[str, float, float]],
                            Dict[str, Any]]:
    """One run of ``cell``: the result line's object, the check's ``(name,
    value, limit)`` rows and the traffic driver's diagnostics."""
    out = cell.driver().drive(config=cell.config, mix=cell.mix, seed=seed,
                              seconds=seconds, trace=trace, device=device,
                              t0=t0)
    ok, rows = check.verdict(out.numbers, cell.limits)
    metrics: Dict[str, Dict[str, Any]] = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        if trace:
            value = cell.reader(m["name"]).read(out.readings)
        else:
            value = out.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": ok and out.failed == 0,
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": device_info(device, out.readings, trace),
    }
    profile = out.readings.profile
    if trace and profile is not None:
        result["breakdown"] = {"device_ops": profile.device_ops(),
                               "idle_gaps": profile.idle_by_host()}
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows, out.notes


def device_info(device: str, readings, trace: bool) -> Dict[str, Any]:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(readings.peak_bytes)}
    if trace and readings.profile is not None:
        info["busy_s"] = readings.profile.busy_us / 1e6
        info["window_s"] = readings.profile.window_us / 1e6
    return info


def forbidden_modules(modules) -> List[str]:
    """Top-level names among ``modules`` (``sys.modules``' keys) that are
    JAX or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))
