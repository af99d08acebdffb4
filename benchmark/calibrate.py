"""The readings a cell's limits are set from, on the card at the cell's
own size (the limits and their readings are in ``PERF.md``):

- ``program``: the cell's own set-up and check (its driver with a window
  of one chunk or one episode) on each seed: the lower readings;
- ``control``: the reference put in the program's place, computed in
  TF32, judged by the float32 reference: the upper readings;
- ``fault:<name>``: the reference in the program's place with one planted
  fault (training: ``half_batch``, ``altered_action``, ``noise_dropped``).

    python benchmark/calibrate.py --workload gnn100.train --mode program \\
        --seeds 1 2 3

One JSON line a seed on standard output, and in ``--out`` when given.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def stand_in(cell, seed: int, device: str, precision: str, fault=None):
    """The check's numbers of the reference in the program's place."""
    from benchmark import check, inputs
    from benchmark.reference import episode as ref_episode
    from benchmark.reference import ppo as ref_ppo
    from benchmark.traffic.eval import SNAPSHOT

    config, mix = cell.config, cell.mix
    weights = inputs.make_weights(config, seed, device)
    if mix["kind"] == "train":
        state = inputs.make_states(config["env"], config["num_formations"],
                                   seed, "train", device)
        iters = int(mix["check_iterations"])
        gen = inputs.stream(seed, "stand-in", device)
        program = ref_ppo.run(config, weights, state, iters, generator=gen,
                              precision=precision, fault=fault)
        reference = ref_ppo.run(config, weights, state, iters,
                                follow=program)
        return check.train_numbers(program, reference)
    state = inputs.make_states(config["env"], int(mix["num_formations"]),
                               seed, "episode0", device)
    at = (SNAPSHOT, ref_episode.episode_length(config["env"]) - 1)
    program = ref_episode.run(config, weights, state, precision, at)
    return check.eval_numbers(
        program, ref_episode.run(config, weights, state, at=at),
        state.agents)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from benchmark import harness

    cell = harness.Cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        if args.mode == "program":
            numbers = cell.driver().drive(
                config=cell.config, mix=cell.mix, seed=seed, seconds=0.0,
                trace=False, device=args.device, t0=t).numbers
        elif args.mode == "control":
            numbers = stand_in(cell, seed, args.device, "tf32")
        elif args.mode.startswith("fault:"):
            numbers = stand_in(cell, seed, args.device, "float32",
                               args.mode.split(":", 1)[1])
        else:
            raise SystemExit(f"unknown mode {args.mode!r}")
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
