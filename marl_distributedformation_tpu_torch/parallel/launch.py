"""Start a command as the ranks of one host's ``torch.distributed`` world.

    python -m marl_distributedformation_tpu_torch.parallel.launch \\
        --nprocs 2 [--timeout 600] -- -m marl_distributedformation_tpu_torch.train \\
        "mesh={dp: 2}" name=dp2 device=cpu

Each rank is ``python <args>`` with the launcher's variables set
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR=localhost`` and ``MASTER_PORT``), which
``parallel.init_distributed`` reads. The launcher hosts the rendezvous
store itself, as torchrun does: it binds ``MASTER_PORT`` before any rank
starts (a port taken meanwhile costs a retry on a fresh one, never a
failed launch) and every rank, rank 0 included, connects to it as a client
(``TORCHELASTIC_USE_AGENT_STORE=True``). ``launch`` waits for every rank within
``timeout`` seconds; a rank that fails or outlives it takes the others
down, and no process outlives the call. The exit code is the first failed
rank's (124 when the time ran out), else 0.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Attempts at binding the rendezvous store, each on a fresh port.
STORE_BIND_ATTEMPTS = 5


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def rank_env(rank: int, nprocs: int, port: int,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of rank ``rank`` of ``nprocs`` on this host, whose
    rendezvous store the launcher hosts on ``port``."""
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
               LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE="True")
    return env


def host_store(nprocs: int, timeout: float) -> Any:
    """The rendezvous store, bound on ``localhost`` at a free port before
    any rank starts; a port taken between ``free_port`` and the bind is
    retried on a fresh one."""
    import torch.distributed as dist

    for attempt in range(STORE_BIND_ATTEMPTS):
        try:
            return dist.TCPStore(
                "localhost", free_port(), nprocs, True,
                datetime.timedelta(seconds=timeout), wait_for_workers=False,
            )
        except RuntimeError:
            if attempt == STORE_BIND_ATTEMPTS - 1:
                raise
    raise AssertionError("unreachable")


def launch(args: Sequence[str], nprocs: int, timeout: float = 600.0,
           env: Optional[Dict[str, str]] = None,
           cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``python <args>`` as ``nprocs`` ranks; returns each rank's
    ``(exit code, output)`` (stdout and stderr together), in rank order.
    A rank that exits non-zero, or the time running out, kills the
    others (their code is then the kill's, and 124 marks the timeout)."""
    store = host_store(nprocs, timeout)
    port = store.port
    # Files, not pipes: a rank that writes more than a pipe holds would
    # block until the others' wait ran out.
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(nprocs)]
    procs = [
        subprocess.Popen(
            [sys.executable, *args], env=rank_env(r, nprocs, port, env),
            cwd=cwd, stdout=log, stderr=subprocess.STDOUT, text=True,
        )
        for r, log in enumerate(logs)
    ]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        del store
    return [(124 if timed_out and p.returncode not in (0,) else p.returncode,
             out) for p, out in zip(procs, outs)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Start a python command as the ranks of one host.")
    parser.add_argument("--nprocs", type=int, required=True)
    parser.add_argument("--timeout", type=float, default=3600.0)
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="after --: python's arguments")
    ns = parser.parse_args(argv)
    args = ns.args[1:] if ns.args[:1] == ["--"] else ns.args
    results = launch(args, ns.nprocs, ns.timeout)
    for rank, (code, out) in enumerate(results):
        for line in out.splitlines():
            print(f"[rank {rank}] {line}")
    return next((code for code, _ in results if code != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
