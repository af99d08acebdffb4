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
capture launches nothing, so what it records goes to the capturing
thread's tally (``ops/knn_cuda.begin_capture_tally``), and every replay
adds the launches the graph holds (``ops/knn_cuda.count_replay``).

A failed capture or replay raises; nothing falls back to eager launches.
The generators a phase draws from are registered with its graph, so that
each replay draws the next numbers of their streams, as the eager calls
would.

Every owner of graphs (a trainer, a population, each Sebulba lane, the
matrix program, each serving engine) captures them on a stream of its own,
from ``own_stream``: a captured GEMM writes the cuBLAS workspace of the
stream it was captured on, so two owners whose graphs replay at once (an
always-learning process replays the trainer's, the gate's and every
replica's together) must not share PyTorch's one capture stream. A graph
replays on its owner's stream, which first waits for the caller's stream;
the caller's stream then waits for it, so the caller reads the graph's
outputs in order. An owner that runs many replays in a row (the matrix
program's episode of T steps) enters its stream once around them, and
a replay called on the owner's stream waits for nothing (C8).

A capture does not enter ``torch.cuda.graph``, whose start synchronizes
the device and empties the allocator's cache: in a process of several
owners that waits for every other owner's queued work (the gate's and the
fleet's captures waited seconds behind a trainer's queued chunks). The
capture stream waits for the caller's stream instead. The cache is emptied, after a synchronize, only when it holds
more than the device has free: a graph's private pool grows only into
free memory, so then the cache holds most of what the capture could use
(a process that built many graphs ran out of memory when it was never
emptied); otherwise emptying it would at most double the room, at the
price of that wait (a capture failed with ``CUBLAS_STATUS_EXECUTION_FAILED``
when the cache was emptied without it). Captures take one lock, one at a
time in the process, so the cache is never emptied under another
thread's capture. The cyclic garbage collector is off during a capture
(``torch.cuda.graph`` collects before it instead, at a cost a capture):
a graph of a dropped owner that it frees there would reset on the
capturing thread and fail the capture.

A phase named with a ``subsystem`` and a ``program`` is a program of the
ledger (``obs/ledger.py``): it registers at its build (the capture, with
the warm-up's wall and FLOPs, the capture seconds and the graph's nodes;
eagerly, its first call), and every later call records its host wall as a
dispatch. None of this happens inside the captured region.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from marl_distributedformation_tpu_torch.analysis.guards import (
    counted_run,
    dispatch_key_of,
    register_program,
)
from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
from marl_distributedformation_tpu_torch.ops import knn_cuda


# The capture stream each live graph owner holds, by its handle: no two
# owners on a card share one (PyTorch hands streams out of a pool of 32 a
# priority, round robin).
_OWNED_STREAMS: "weakref.WeakValueDictionary[int, Any]" = (
    weakref.WeakValueDictionary())
_STREAMS_LOCK = threading.Lock()
# One capture at a time in the process (see the module docstring).
_CAPTURE_LOCK = threading.Lock()


def own_stream(owner: Any, device: Any) -> Optional[torch.cuda.Stream]:
    """A CUDA stream on ``device`` that no other live owner holds, held
    for ``owner`` until it is garbage collected (an owner may take several,
    one a lane); None off the card. See the module docstring. The streams
    come from PyTorch's pool, so at most 32 owners' streams on a device
    are alive at once; one more raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with _STREAMS_LOCK:
        for _ in range(256):
            stream = torch.cuda.Stream(device)
            if stream.cuda_stream not in _OWNED_STREAMS:
                _OWNED_STREAMS[stream.cuda_stream] = owner
                return stream
    raise RuntimeError(
        f"no CUDA stream on {device} free of another graph owner: "
        f"{len(_OWNED_STREAMS)} live owners' streams hold PyTorch's pool")


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
    owner's stream (``own_stream``), which the graph is captured and
    replayed on (see the module docstring); a phase that captures needs
    one."""

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
        if capture and stream is None:
            raise ValueError(f"phase {name!r} captures, and needs its "
                             "owner's stream (own_stream)")
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

    def builds_next(self, calls: int = 1) -> bool:
        """Whether the next ``calls`` calls build the program: capture it
        (the card: the second call), or run the eager step for the first
        time."""
        if self.capture:
            return self.graph is None and self.calls <= 1 < self.calls + calls
        return self.calls == 0 and calls > 0

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
            self._replay()
            self._register(compile_seconds=self.capture_s)
        else:
            t0 = time.perf_counter()
            self._replay()
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

    def _replay(self) -> None:
        """The graph on its owner's stream, ordered after the caller's
        work and before the caller's next; a caller already on the owner's
        stream (the matrix program's episode) needs neither wait."""
        caller = torch.cuda.current_stream()
        if caller == self.stream:
            self.graph.replay()
        else:
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                self.graph.replay()
            caller.wait_stream(self.stream)
        knn_cuda.count_replay(self.launches)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # A registered generator keeps its state through the capture; each
        # replay then draws from where the generator stands and moves it on.
        for gen in self.generators:
            graph.register_generator_state(gen)
        with _CAPTURE_LOCK:
            knn_cuda.begin_capture_tally()
            t0 = time.perf_counter()
            # The cache, and the capture's order (see the module docstring).
            dev = self.stream.device
            free, _ = torch.cuda.mem_get_info(dev)
            cached = (torch.cuda.memory_reserved(dev)
                      - torch.cuda.memory_allocated(dev))
            if cached > free:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            self.stream.wait_stream(torch.cuda.current_stream())
            # No cyclic collection during the capture: a collected graph
            # owner's CUDAGraph resets on this thread, which the capture
            # does not allow, and the capture fails (the smoke's
            # smoke_profile64, after earlier trainers' graphs became
            # garbage). torch.cuda.graph runs gc.collect() first instead.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(self.stream):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        self.fn()
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
                self.launches = knn_cuda.end_capture_tally()
            self.capture_s = time.perf_counter() - t0
        self.nodes = graph_nodes(graph)
        graph.instantiate()
        self.graph = graph

    def stats(self) -> Dict[str, object]:
        """Nodes and capture seconds of the graph (None until captured)."""
        return {"phase": self.name, "nodes": self.nodes,
                "capture_s": self.capture_s, "calls": self.calls}
