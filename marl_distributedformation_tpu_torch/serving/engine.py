"""Bucketed policy act over a ladder of fixed batch shapes: the core of the
serving stack, one CUDA graph a rung.

Counterpart of the JAX package's ``serving/engine.py``. Serving traffic
arrives at arbitrary batch sizes; the engine serves a small ladder of fixed
batch shapes (1/8/64/512 by default) and pads every request up to the next
rung, so the programs it builds are bounded by ``len(buckets)`` for the
life of the process whatever sizes clients send. Where JAX compiles one
program a rung, the port builds one a rung: on the card, the rung's act
(forward, sample, select, clip) captured as a CUDA graph
(``train/capture.py::PhaseGraph``: warmed up eagerly on a side stream, then
captured, on the rung's first dispatch); on the CPU, the eager step. Each
rung's ``RetraceGuard`` (budget 1 by default) counts that build, so
``compile_counts()`` reads at most 1 a rung for the life of the process.

**Parameters stay an input in effect.** A graph reads fixed addresses, so
the graphs read the parameter tensors of the engine's own copy of the
policy's model. ``act(obs, nn_params=snapshot)`` copies a snapshot (a dict
of the model's ``state_dict`` names to tensors on the engine's device, as
``ModelRegistry.active()`` returns it) into those tensors before the rung
runs, only when it is another object than the one last loaded. A hot swap
is one device-to-device copy at the scheduler's batch barrier and never
rebuilds a rung; one set of parameter tensors serves every rung.
``nn_params=None`` serves the wrapped policy's parameters as they were
when the engine was built.

**One graph serves both modes.** ``deterministic`` is a 0-d device tensor
written before the rung runs; the sampled branch draws inside the graph
from the engine's generator (seeded from ``seed``, registered with every
graph), so every replay draws fresh noise. The draws are not JAX's (which
folds a dispatch counter into its key).

**The host path.** A request's rows are copied once into a staging buffer
laid out as the plan (each chunk its own slice, the padding zeroed, as JAX
pads), pinned on the card; each chunk is copied to its rung's static input
asynchronously, replayed, and its actions copied back to pinned memory, on
the engine's stream. A request larger than the top rung enqueues all its
chunks and waits once, at the end.

``dtype="bfloat16"`` serves the rungs in bf16: the float parameters and the
observations are cast inside the rung (parameters stay f32 at rest, so a
swap and its validation are unchanged), the forward runs in bf16, and
actions come back f32 before the clip. ``device.resolve_device`` keeps
cuBLAS's reduced-precision bf16 reductions off, so products accumulate in
f32 (``tests/bf16_budget.py``'s fact 2).

No fallback: a failed build or replay raises, and nothing serves eagerly on
the card unless the engine is built with ``capture=False`` (for
comparisons).
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.analysis.guards import RetraceGuard
from marl_distributedformation_tpu_torch.models import distributions
from marl_distributedformation_tpu_torch.train.capture import (
    PhaseGraph,
    own_stream,
)

# Powers-of-8-ish ladder: adjacent rungs are 8x apart, so padding waste is
# bounded (worst-case occupancy 1/8 just above a rung) while the build count
# stays at 4.
DEFAULT_BUCKETS = (1, 8, 64, 512)


def act_rows(model: torch.nn.Module, params: Mapping[str, torch.Tensor],
             dtype: Optional[torch.dtype], generator: torch.Generator,
             det: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The act of a rung over ``model``, whose ``state_dict`` is
    ``params``: forward (in ``dtype`` when one is given: the float
    parameters and the rows cast inside), sample from ``generator``, the
    deterministic select on ``det``, f32 actions clipped to the action
    space."""
    if dtype is None:
        mean, log_std, _ = model(x)
    else:
        cast = {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in params.items()}
        mean, log_std, _ = torch.func.functional_call(
            model, cast, (x.to(dtype),))
    sampled = distributions.sample(generator, mean, log_std)
    actions = torch.where(det, distributions.mode(mean), sampled)
    return actions.float().clamp(-1.0, 1.0)


def inference_dtype(dtype: Any) -> Optional[torch.dtype]:
    """None for f32 serving, ``torch.bfloat16`` for bf16; refuses others."""
    if dtype in (None, "float32", "f32", torch.float32):
        return None
    if dtype in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(
        f"inference dtype must be float32 or bfloat16, got {dtype!r}"
    )


class _Rung:
    """One rung: a static input of ``bucket`` rows and the act that reads
    it, captured or eager; ``out`` holds the actions the last run wrote."""

    def __init__(self, engine: "BucketedPolicyEngine", bucket: int,
                 row_shape: Tuple[int, ...]) -> None:
        self.x = torch.zeros((bucket, *row_shape), device=engine.device)
        self.out: Optional[torch.Tensor] = None

        def act() -> None:
            self.out = engine._act_core(self.x)

        self.graph = PhaseGraph(
            f"serving-act-bucket{bucket}", act,
            generators=[engine.generator], capture=engine.capture,
            guard=engine.guards[bucket] if engine.capture else None,
            signature=(self.x,),
            subsystem="serving",
            program=f"act_rung{bucket}_"
                    f"{'f32' if engine.dtype is None else 'bf16'}",
            stream=engine._stream,
        )


class BucketedPolicyEngine:
    """``act`` over a ladder of fixed batch shapes; see the module docstring.

    Args:
      policy: a ``compat.policy.LoadedPolicy`` (anything with ``.model``, a
        module on its device whose forward returns ``(mean, log_std,
        value)`` over leading batch axes, and ``.params``, its
        ``state_dict``).
      buckets: ascending batch-size ladder. Requests larger than the top
        rung are split into top-rung chunks plus a bucketed remainder.
      max_traces_per_bucket: ``RetraceGuard`` budget a rung; a second build
        raises ``RetraceError`` naming the drifting signature.
      seed: seed of the generator stochastic actions draw from.
      dtype: ``None``/"float32" serves f32; "bfloat16" casts inside the
        rung (see the module docstring).
      capture: on the card, capture each rung as a CUDA graph (the
        default); False runs every rung eagerly, for comparisons only.
        The CPU always runs eagerly.
      device: where the engine serves (default the policy's device); a
        fleet replica's engine takes its replica's device. On another
        device than the policy's, ``nn_params=None`` serves a copy of the
        policy's parameters made there.
    """

    def __init__(
        self,
        policy: Any,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        max_traces_per_bucket: Optional[int] = 1,
        seed: int = 0,
        dtype: Optional[str] = None,
        capture: bool = True,
        device: Any = None,
    ) -> None:
        self.policy = policy
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.dtype = inference_dtype(dtype)
        self.guards: Dict[int, RetraceGuard] = {
            b: RetraceGuard(
                f"serving-act-bucket{b}", max_traces=max_traces_per_bucket
            )
            for b in self.buckets
        }
        # The served model: the policy's architecture with parameter
        # tensors of its own, the ones every rung's graph reads.
        self.model = copy.deepcopy(policy.model).eval().requires_grad_(False)
        if device is not None:
            self.model.to(device)
        self.device = next(self.model.parameters()).device
        self.capture = bool(capture) and self.device.type == "cuda"
        self._params = self.model.state_dict()
        self._own = policy.params
        if next(iter(self._own.values())).device != self.device:
            self._own = {k: v.detach().clone()
                         for k, v in self._params.items()}
        self._loaded: Any = self._own
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._det = torch.ones((), dtype=torch.bool, device=self.device)
        self._rungs: Dict[int, _Rung] = {}
        # The rungs capture and replay on a stream no other live graph
        # owner holds (train/capture.py): fleet replicas on one card replay
        # at once, and graphs replaying at once over one cuBLAS workspace
        # can corrupt each other's GEMMs or wait on each other forever.
        self._stream = own_stream(self, self.device)
        self._stage_in: Optional[torch.Tensor] = None
        self._stage_out: Optional[torch.Tensor] = None
        self._lock = threading.Lock()
        # Trailing row shape, recorded on the first successful dispatch:
        # later mismatches fail fast as a ValueError.
        self._row_shape: Optional[Tuple[int, ...]] = None

    # -- the rung's act -------------------------------------------------

    def _act_core(self, x: torch.Tensor) -> torch.Tensor:
        """The act of one rung: forward, sample, the deterministic select,
        f32 actions clipped to the action space (``LoadedPolicy.predict``'s
        contract)."""
        return act_rows(self.model, self._params, self.dtype,
                        self.generator, self._det, x)

    # -- bucketing ------------------------------------------------------

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest rung holding ``n`` rows (``n`` <= max_bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} rows exceed the top bucket {self.max_bucket}")

    def plan(self, n: int) -> List[int]:
        """Rung sizes a dispatch of ``n`` rows pads into (top-rung chunks
        plus one bucketed remainder). ``sum(plan)`` is the padded capacity
        the batch occupies — the occupancy denominator."""
        if n <= 0:
            raise ValueError(f"need at least one row, got {n}")
        chunks = [self.max_bucket] * (n // self.max_bucket)
        rest = n % self.max_bucket
        if rest:
            chunks.append(self.bucket_for(rest))
        return chunks

    def compile_counts(self) -> Dict[int, int]:
        """Builds per rung so far (the serving contract: at most 1 each)."""
        return {b: g.count for b, g in self.guards.items()}

    @property
    def dtype_label(self) -> str:
        """Short dtype tag for metrics labels ("f32" / "bf16")."""
        return "bf16" if self.dtype == torch.bfloat16 else "f32"

    def rung(self, bucket: int) -> Optional[_Rung]:
        """The rung built for ``bucket``, or None before its first
        dispatch."""
        return self._rungs.get(bucket)

    # -- dispatch -------------------------------------------------------

    def _load(self, snapshot: Mapping[str, torch.Tensor]) -> None:
        """Copy ``snapshot`` into the served parameter tensors unless it is
        the one already loaded; refuses another architecture."""
        if snapshot is self._loaded:
            return
        if set(snapshot) != set(self._params):
            raise ValueError(
                f"parameter snapshot names {sorted(snapshot)} differ from "
                f"the served model's {sorted(self._params)}"
            )
        for name, dst in self._params.items():
            src = snapshot[name]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"parameter {name!r} is {src.dtype}{list(src.shape)}; the "
                    f"served model holds {dst.dtype}{list(dst.shape)} (a "
                    "swap never changes the architecture)"
                )
        for name, dst in self._params.items():
            dst.copy_(snapshot[name], non_blocking=True)
        self._loaded = snapshot

    def _staging(self, which: str, rows: int,
                 row_shape: Tuple[int, ...]) -> torch.Tensor:
        """A host buffer of at least ``rows`` rows (pinned on the card),
        kept between requests and grown in top-rung steps."""
        buf = getattr(self, which)
        if buf is None or buf.shape[0] < rows or buf.shape[1:] != row_shape:
            cap = -(-rows // self.max_bucket) * self.max_bucket
            buf = torch.zeros((cap, *row_shape),
                              pin_memory=self.device.type == "cuda")
            setattr(self, which, buf)
        return buf

    def _run_chunk(self, bucket: int, row_shape: Tuple[int, ...],
                   src: torch.Tensor) -> torch.Tensor:
        """Copy ``src`` into the rung's static input and run it (building
        the rung on its first dispatch); returns the rung's actions."""
        rung = self._rungs.get(bucket)
        if rung is not None:
            rung.x.copy_(src, non_blocking=True)
            rung.graph()
            return rung.out
        rung = _Rung(self, bucket, row_shape)
        rung.x.copy_(src, non_blocking=True)

        def build() -> None:
            rung.graph()  # eager; on the card the warm-up on a side stream
            if self.capture:
                rung.graph()  # captured (the guard counts it) and replayed

        # A build that raises (a malformed first request) is no build.
        (build if self.capture else self.guards[bucket].wrap(build))()
        self._rungs[bucket] = rung
        return rung.out

    def _rows(self, obs: Any) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """``obs`` as f32 rows and their trailing shape, which must be the
        one this engine serves."""
        obs = np.asarray(obs, np.float32)
        if obs.ndim < 2:
            raise ValueError(
                f"obs must be (n, *row_shape) with a leading batch axis, "
                f"got shape {obs.shape}"
            )
        row_shape = tuple(obs.shape[1:])
        if self._row_shape is not None and row_shape != self._row_shape:
            raise ValueError(
                f"obs rows have shape {row_shape}; this engine serves "
                f"{self._row_shape} rows (one compiled row shape per "
                "engine — the bucket ladder is the only shape axis)"
            )
        return obs, row_shape

    def _stage(self, obs: np.ndarray, chunks: List[int]
               ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
        """``obs`` copied into the input staging buffer laid out as the
        plan (each chunk its own slice, the padding zeroed); returns the
        buffer and each chunk's ``(offset, rows)``. Caller holds
        ``_lock``."""
        n = obs.shape[0]
        stage = self._staging("_stage_in", sum(chunks), obs.shape[1:])
        host = stage.numpy()
        offsets, off, start = [], 0, 0
        for bucket in chunks:
            k = min(bucket, n - start)
            host[off:off + k] = obs[start:start + k]
            host[off + k:off + bucket] = 0.0
            offsets.append((off, k))
            off, start = off + bucket, start + k
        return stage, offsets

    def act(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        nn_params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> np.ndarray:
        """Actions for ``obs`` rows ``(n, *row_shape)``: pads to the rungs
        of ``plan(n)``, runs them, slices the padding back off.
        ``nn_params=None`` serves the wrapped policy's parameters (the
        registry passes its active snapshot instead)."""
        obs, row_shape = self._rows(obs)
        chunks = self.plan(obs.shape[0])
        snapshot = self._own if nn_params is None else nn_params
        with self._lock, torch.no_grad():
            stage, offsets = self._stage(obs, chunks)
            cuda = self._stream is not None
            if cuda:
                self._stream.wait_stream(torch.cuda.current_stream())
            try:
                with torch.cuda.stream(self._stream):  # no-op without one
                    self._load(snapshot)
                    self._det.fill_(bool(deterministic))
                    for bucket, (off, _) in zip(chunks, offsets):
                        y = self._run_chunk(bucket, row_shape,
                                            stage[off:off + bucket])
                        out = self._staging("_stage_out", sum(chunks),
                                            tuple(y.shape[1:]))
                        out[off:off + bucket].copy_(y, non_blocking=True)
            finally:
                # One wait a request, after every chunk is enqueued; also
                # when a chunk raised, so no copy is left in flight from
                # the staging buffers the next request reuses.
                if cuda:
                    self._stream.synchronize()
            self._row_shape = row_shape
            actions = out.numpy()
            return np.concatenate([actions[o:o + k] for o, k in offsets])
