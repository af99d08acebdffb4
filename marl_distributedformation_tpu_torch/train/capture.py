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

A phase named with a ``subsystem`` and a ``program`` is a program of the
ledger (``obs/ledger.py``): it registers at its build (the capture, with
the warm-up's wall and FLOPs, the capture seconds and the graph's nodes;
eagerly, its first call), and every later call records its host wall as a
dispatch. None of this happens inside the captured region.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from marl_distributedformation_tpu_torch.analysis.guards import (
    counted_run,
    dispatch_key_of,
    register_program,
)
from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
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
    counts the capture as a build of the program, for ``signature``.
    ``subsystem`` and ``program`` name it in the ledger (see the module
    docstring); without them it registers nothing. ``stream`` is the
    stream the capture runs on (default PyTorch's one capture stream): the
    cuBLAS workspace a captured GEMM writes is the capture stream's, so
    graphs that replay concurrently on different streams are captured on
    streams of their own."""

    def __init__(
        self,
        name: str,
        fn: Callable[[], None],
        generators: Sequence[torch.Generator] = (),
        capture: bool = True,
        guard=None,
        signature: tuple = (),
        subsystem: Optional[str] = None,
        program: Optional[str] = None,
        stream: Optional[torch.cuda.Stream] = None,
    ) -> None:
        self.name = name
        self.stream = stream
        self.fn = fn
        self.generators = list(generators)
        self.capture = capture
        self.guard = guard
        self.signature = signature
        self.subsystem = subsystem
        self.program = program
        self._dispatch_key = (None if subsystem is None
                              else dispatch_key_of(subsystem, program))
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.nodes: Optional[int] = None
        self.capture_s: Optional[float] = None
        self.warm_up_s: Optional[float] = None
        self._facts: tuple = ({}, "unavailable", None)

    def builds_next(self) -> bool:
        """Whether the next call builds the program: captures it (the
        card), or runs the eager step for the first time."""
        if self.capture:
            return self.calls == 1 and self.graph is None
        return self.calls == 0

    def drop(self) -> None:
        """Forget the build: the next call builds the program again (a
        forced rebuild, which a budget on the builds refuses)."""
        if self.capture:
            self.graph = None
            self.calls = min(self.calls, 1)
        else:
            self.calls = 0

    def __call__(self) -> None:
        ledger = get_ledger() if self._dispatch_key is not None else None
        if ledger is not None and not ledger.enabled:
            ledger = None
        if not self.capture:
            if self.calls == 0:
                self._eager_build()
            elif ledger is None:
                self.fn()
            else:
                t0 = time.perf_counter()
                self.fn()
                ledger.dispatch(self._dispatch_key, time.perf_counter() - t0)
        elif self.calls == 0:
            self._warm_up()
        elif self.graph is None:
            if self.guard is not None:
                self.guard.record(*self.signature)
            self._capture()
            self.graph.replay()
            knn_cuda.count_replay(self.launches)
            self._register(compile_seconds=self.capture_s)
        else:
            t0 = time.perf_counter()
            self.graph.replay()
            knn_cuda.count_replay(self.launches)
            if ledger is not None:
                ledger.dispatch(self._dispatch_key, time.perf_counter() - t0)
        self.calls += 1

    def _eager_build(self) -> None:
        """The first eager call: the build of an uncaptured program."""
        if self._dispatch_key is None:
            self.fn()
            return
        _, self.warm_up_s, *self._facts = counted_run(self.fn)
        self._register()

    def _register(self, compile_seconds: Optional[float] = None) -> None:
        if self._dispatch_key is None:
            return
        facts, source, error = self._facts
        timings = {"first_dispatch_seconds": self.warm_up_s}
        if compile_seconds is not None:
            timings["compile_seconds"] = compile_seconds
        register_program(
            name=self.program, subsystem=self.subsystem,
            signature=self.signature, timings=timings, facts=facts,
            analysis_source=source, analysis_error=error,
            graph_nodes=self.nodes,
            device="cuda" if self.capture else None,
        )

    def _warm_up(self) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            if self._dispatch_key is None:
                self.fn()
            else:
                _, _, *self._facts = counted_run(self.fn)
        main.wait_stream(side)
        if self._dispatch_key is not None:
            # The warm-up's wall, to the end of its device work.
            side.synchronize()
            self.warm_up_s = time.perf_counter() - t0

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # A registered generator keeps its state through the capture; each
        # replay then draws from where the generator stands and moves it on.
        for gen in self.generators:
            graph.register_generator_state(gen)
        counted = dict(knn_cuda.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
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
