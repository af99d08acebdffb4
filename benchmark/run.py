"""Runs one benchmark cell of the PyTorch/CUDA port on the card.

    python benchmark/run.py --workload gnn100.train --seed 7 --seconds 30 \\
        --trace 0

Set-up (imports, builds, weights and states from the seed, warm-up) is
timed from this process's start; then the window runs for about
``--seconds``; then the output of the window's first steps (training) or of
a finished episode (evaluation) is compared with the plain reference.
The last line of standard output is the result as one JSON object; the
check's numbers and limits are the last lines of standard error. Without
a CUDA device, or with JAX loaded, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed places inside the checkout.
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    why it could not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e!r}"
    return out.stdout.strip() or f"not read: {out.stderr.strip()}"


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"run.py: {args.workload} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    result, rows, notes = harness.run(cell, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T0)
    loaded = harness.forbidden_modules(list(sys.modules))
    if loaded:
        print(f"run.py: the process loaded {loaded}; no result",
              file=sys.stderr)
        return 4
    notes["card"] = power_limit()
    print(f"notes {json.dumps(notes)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
