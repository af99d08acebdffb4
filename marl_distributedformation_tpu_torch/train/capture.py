"""CUDA graphs of the training iteration: the port's counterpart of the
JAX package's ``jax.jit`` of ``make_ppo_iteration`` and of
``make_fused_chunk``.

The iteration runs as three phases (``train/iteration.py``); each becomes
one graph, a ``PhaseGraph``:

- the rollout (``n_steps`` policy forwards, env steps with their k-NN
  kernel, GAE, the update's rows and permutations), replayed once an
  iteration;
- one minibatch step (take, loss, ``autograd.grad``, optax's clip, Adam,
  the ``log_std`` ceiling, the metrics row), replayed ``n_epochs x
  num_minibatches`` times an iteration;
- the end (metric means, the health select, the carry write-back).

A phase runs eagerly on its first call, on a side stream, as PyTorch asks
before a capture: that keeps first-time work out of the graph (loading the
k-NN kernel's module, cuBLAS's workspace, the env's device constants). Its
second call captures it and replays it, and every later call replays. The
warm-up is a real call of the phase, so training is the same as with every
call replayed, and a kernel's launch count stays what the run launched: a
capture launches nothing, so the counts it adds are taken back, and every
replay adds the launches the graph holds (``ops/knn_cuda.count_replay``).

A failed capture or replay raises; nothing falls back to eager launches.
The generators a phase draws from are registered with its graph, so that
each replay draws the next numbers of their streams, as the eager calls
would.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from marl_distributedformation_tpu_torch.ops import knn_cuda


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """Nodes of a captured graph kept with ``keep_graph=True``, from the
    driver's ``cuGraphGetNodes``."""
    driver = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = driver.cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count)
    )
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(count.value)


class PhaseGraph:
    """``fn`` (a phase of the iteration, no arguments) as a CUDA graph on
    its second call; see the module docstring. With ``capture`` False every
    call runs ``fn`` eagerly on the current stream (the CPU, and the
    card's eager comparisons). ``guard`` (``analysis.guards.RetraceGuard``)
    counts the capture as a build of the program, for ``signature``."""

    def __init__(
        self,
        name: str,
        fn: Callable[[], None],
        generators: Sequence[torch.Generator] = (),
        capture: bool = True,
        guard=None,
        signature: tuple = (),
    ) -> None:
        self.name = name
        self.fn = fn
        self.generators = list(generators)
        self.capture = capture
        self.guard = guard
        self.signature = signature
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.nodes: Optional[int] = None
        self.capture_s: Optional[float] = None

    def __call__(self) -> None:
        if not self.capture:
            self.fn()
        elif self.calls == 0:
            self._warm_up()
        else:
            if self.graph is None:
                if self.guard is not None:
                    self.guard.record(*self.signature)
                self._capture()
            self.graph.replay()
            knn_cuda.count_replay(self.launches)
        self.calls += 1

    def _warm_up(self) -> None:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()
        main.wait_stream(side)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # A registered generator keeps its state through the capture; each
        # replay then draws from where the generator stands and moves it on.
        for gen in self.generators:
            graph.register_generator_state(gen)
        counted = dict(knn_cuda.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.fn()
        self.capture_s = time.perf_counter() - t0
        self.launches = {
            k: knn_cuda.LAUNCHES[k] - counted[k] for k in counted
        }
        knn_cuda.LAUNCHES.update(counted)
        self.nodes = graph_nodes(graph)
        graph.instantiate()
        self.graph = graph

    def stats(self) -> Dict[str, object]:
        """Nodes and capture seconds of the graph (None until captured)."""
        return {"phase": self.name, "nodes": self.nodes,
                "capture_s": self.capture_s, "calls": self.calls}
