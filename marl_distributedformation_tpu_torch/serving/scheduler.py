"""Micro-batching request scheduler: the host-side half of serving.

Counterpart of the JAX package's ``serving/scheduler.py``, the same code
over the port's engine: at the batch barrier a group's parameter snapshot
is copied into the engine's captured parameter tensors (only when the
snapshot changed), where JAX passes it to the compiled rung as an input.

One worker thread owns the accelerator. Clients enqueue requests into a
bounded queue; the worker takes the first request, then keeps absorbing
arrivals until the coalescing deadline (``window_ms``) passes or the top
bucket is full, and dispatches the coalesced rows through the engine as
ONE padded batch. Per-request results are sliced back out and resolved
on each caller's future.

The three failure-shaped paths are explicit:

- **Backpressure** — a full queue rejects immediately with
  :class:`BackpressureError` carrying ``retry_after_s`` (priced from the
  current depth times the recent mean batch time). Rejecting at the door
  beats queueing unboundedly: the caller knows *now* and the p99 of
  accepted requests stays bounded.
- **Per-request timeouts** — a request whose deadline passed while it
  waited is failed with :class:`RequestTimeout` at dispatch time (never
  silently computed for a caller that already gave up).
- **Dispatch errors** — an engine exception fails that batch's futures
  and the worker keeps serving; a serving process never dies with
  requests in flight.

Model hot-swap composes here: the worker snapshots ``(params, step)``
from the registry once per micro-batch, so a swap lands atomically
between batches and every result records the checkpoint step that
produced it (``ServedResult.model_step``).

**SLO classes.** Every request carries an admission class —
``"interactive"`` (the default: a user is waiting) or ``"batch"``
(eval sweeps, backfills: work that tolerates deferral). Under
backpressure batch traffic YIELDS: (1) dispatch order prefers queued
interactive requests, so batch backlog cannot stretch the interactive
p95; (2) a full queue never rejects an interactive request while batch
requests are queued — the newest-queued batch request is *preempted*
(its future fails with ``BackpressureError`` + retry-after, the same
contract as a door reject, which the client retry loop already honors)
and the interactive request takes its slot. With all-default traffic
the queue is plain FIFO — the classes cost nothing until used.

**Tenant lanes.** Constructed with ``registries`` (a ``model_id`` →
registry mapping — serving/tenancy builds it), the scheduler multiplexes
NAMED MODEL LANES over the one engine: every request carries a
``model_id``, admission is a separate bounded two-class queue PER LANE
(one tenant's batch storm fills only its own lane — others admit
untouched, and preemption never crosses a lane), backpressure is priced
per lane, dispatch drains lanes round-robin with interactive-anywhere
ahead of batch-anywhere, and each dispatch group snapshots ITS lane's
``(params, step)`` and runs under ITS lane's batch barrier — so a
reload coordinator committing one lane quiesces only that lane's
groups while every other lane keeps dispatching. The params ride
``engine.act(nn_params=...)``, copied into the engine's parameter
tensors when the lane changes, so same-architecture lanes share the
engine's captured rungs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.obs import get_tracer
from marl_distributedformation_tpu_torch.serving.engine import BucketedPolicyEngine
from marl_distributedformation_tpu_torch.serving.metrics import ServingMetrics


class BackpressureError(RuntimeError):
    """Queue full: retry after ``retry_after_s`` (reject-with-retry-after)."""

    def __init__(self, retry_after_s: float) -> None:
        super().__init__(
            f"serving queue full; retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s


class RequestTimeout(TimeoutError):
    """The request's deadline passed while it waited in the queue."""


class SchedulerStopped(RuntimeError):
    """The scheduler shut down before this request was dispatched."""


SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_BATCH)


@dataclasses.dataclass
class ServedResult:
    """What a resolved request future carries."""

    actions: np.ndarray
    model_step: int  # checkpoint step of the params that answered
    latency_s: float  # enqueue -> result
    replica: int = -1  # fleet replica index (-1: single-engine serving)
    model_id: Optional[str] = None  # tenant lane (None: single-model)


@dataclasses.dataclass
class _Request:
    obs: np.ndarray
    deterministic: bool
    future: Future
    enqueued: float
    timeout_s: Optional[float]
    trace_id: Optional[str] = None
    slo_class: str = SLO_INTERACTIVE
    model_id: Optional[str] = None

    def expired(self, now: float) -> bool:
        return self.timeout_s is not None and (
            now - self.enqueued > self.timeout_s
        )


class _ClassedQueue:
    """Bounded two-class request queue: interactive ahead of batch.

    The ``queue.Queue`` subset the scheduler uses (``put_nowait`` /
    ``get`` / ``get_nowait`` / ``qsize``, ``queue.Full``/``Empty``
    semantics), with the SLO-class admission policy inside:

    - ``get`` pops the oldest INTERACTIVE request first; batch requests
      dispatch only when no interactive request is queued (each class
      stays FIFO within itself).
    - ``put_nowait`` on a full queue returns the preempted batch
      request when the arrival is interactive and batch work is queued
      (newest batch yields — it has waited least), instead of raising
      ``queue.Full``. The caller owns failing the preempted future.

    A plain lock+deques structure instead of queue.Queue: preemption
    needs to remove from the middle of the bound, which Queue cannot.
    """

    def __init__(self, maxsize: int) -> None:
        self._maxsize = maxsize
        self._cond = threading.Condition()
        self._interactive: "deque[_Request]" = deque()  # graftlock: guarded-by=_cond
        self._batch: "deque[_Request]" = deque()  # graftlock: guarded-by=_cond

    def qsize(self) -> int:
        with self._cond:
            return len(self._interactive) + len(self._batch)

    def put_nowait(self, req: _Request) -> Optional[_Request]:
        """Admit ``req``; returns a preempted batch request (fail its
        future) or None. Raises ``queue.Full`` when admission fails."""
        with self._cond:
            depth = len(self._interactive) + len(self._batch)
            lane = (
                self._batch
                if req.slo_class == SLO_BATCH
                else self._interactive
            )
            if depth < self._maxsize:
                lane.append(req)
                self._cond.notify()
                return None
            if req.slo_class != SLO_BATCH and self._batch:
                evicted = self._batch.pop()
                self._interactive.append(req)
                self._cond.notify()
                return evicted
            raise queue.Full

    # graftlock: holds=_cond
    def _pop(self) -> Optional[_Request]:
        if self._interactive:
            return self._interactive.popleft()
        if self._batch:
            return self._batch.popleft()
        return None

    def get(self, timeout: Optional[float] = None) -> _Request:
        deadline = (
            None if timeout is None else time.perf_counter() + timeout
        )
        with self._cond:
            while True:
                req = self._pop()
                if req is not None:
                    return req
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)

    def get_nowait(self) -> _Request:
        with self._cond:
            req = self._pop()
            if req is None:
                raise queue.Empty
            return req


class _TenantAdmission:
    """Per-tenant bounded admission: one two-class queue per model lane.

    The same ``put_nowait`` / ``get`` / ``get_nowait`` / ``qsize``
    surface as :class:`_ClassedQueue`, with the isolation contract
    inside:

    - **Bounds are per lane.** A tenant filling its own ``maxsize``
      admission budget gets ``queue.Full`` (→ per-tenant backpressure);
      every other lane's budget is untouched — a 512-rung batch storm on
      one lane cannot consume another lane's slots.
    - **Preemption stays within a lane.** A full lane's interactive
      arrival preempts the newest BATCH request of the SAME lane only;
      another tenant's batch work is never evicted for this tenant's
      interactive traffic.
    - **Draining is round-robin across lanes**, interactive-anywhere
      ahead of batch-anywhere: lane B's interactive request dispatches
      before lane A's batch backlog no matter how deep A's queue is,
      and equal-class lanes take turns instead of starving on arrival
      order.
    """

    def __init__(self, lanes: Any, maxsize: int) -> None:
        self._maxsize = maxsize  # per-lane admission bound
        self._cond = threading.Condition()
        # lane -> (interactive deque, batch deque), draining order fixed
        # at construction (the directory's lane order).
        self._lanes = {  # graftlock: guarded-by=_cond
            mid: (deque(), deque()) for mid in lanes
        }
        self._order = list(self._lanes)
        self._rr = 0  # graftlock: guarded-by=_cond

    def qsize(self) -> int:
        with self._cond:
            return sum(
                len(i) + len(b) for i, b in self._lanes.values()
            )

    def lane_depth(self, model_id: str) -> int:
        with self._cond:
            i, b = self._lanes[model_id]
            return len(i) + len(b)

    def put_nowait(self, req: _Request) -> Optional[_Request]:
        """Admit ``req`` into its lane; returns a preempted same-lane
        batch request (fail its future) or None. ``queue.Full`` when the
        LANE's budget is exhausted — per-tenant backpressure."""
        with self._cond:
            interactive, batch = self._lanes[req.model_id]
            depth = len(interactive) + len(batch)
            lane = batch if req.slo_class == SLO_BATCH else interactive
            if depth < self._maxsize:
                lane.append(req)
                self._cond.notify()
                return None
            if req.slo_class != SLO_BATCH and batch:
                evicted = batch.pop()
                interactive.append(req)
                self._cond.notify()
                return evicted
            raise queue.Full

    # graftlock: holds=_cond
    def _pop(self) -> Optional[_Request]:
        n = len(self._order)
        for cls_idx in (0, 1):  # 0: interactive pass, 1: batch pass
            for k in range(n):
                mid = self._order[(self._rr + k) % n]
                dq = self._lanes[mid][cls_idx]
                if dq:
                    self._rr = (self._rr + k + 1) % n
                    return dq.popleft()
        return None

    def get(self, timeout: Optional[float] = None) -> _Request:
        deadline = (
            None if timeout is None else time.perf_counter() + timeout
        )
        with self._cond:
            while True:
                req = self._pop()
                if req is not None:
                    return req
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)

    def get_nowait(self) -> _Request:
        with self._cond:
            req = self._pop()
            if req is None:
                raise queue.Empty
            return req


class MicroBatchScheduler:
    """Deadline-window micro-batching over a :class:`BucketedPolicyEngine`.

    Args:
      engine: the bucketed act (one captured graph a rung on the card).
      registry: optional ``ModelRegistry``; ``None`` serves the engine's
        wrapped policy params forever (step reported as 0).
      max_queue: bound on queued *requests*; the backpressure knob.
      window_ms: coalescing deadline. 0 disables coalescing (each request
        dispatches alone — the latency-over-throughput corner).
      default_timeout_s: per-request deadline when ``submit`` gets none.
      logger: optional ``utils.logging.MetricsLogger``; a metrics record
        is emitted every ``emit_every`` batches.
      registries: optional ``model_id`` → registry mapping — turns the
        scheduler multi-tenant (module docstring "Tenant lanes"): every
        ``submit`` must then carry a known ``model_id``, admission is a
        per-lane bounded queue, and each dispatch group runs under its
        lane's batch barrier with its lane's params. Mutually exclusive
        with ``registry``.
      tenant_max_queue: per-lane admission bound in tenant mode
        (default: ``max_queue``, applied per lane).
    """

    def __init__(
        self,
        engine: BucketedPolicyEngine,
        registry: Any = None,
        max_queue: int = 256,
        window_ms: float = 2.0,
        default_timeout_s: float = 10.0,
        metrics: Optional[ServingMetrics] = None,
        logger: Any = None,
        emit_every: int = 100,
        registries: Any = None,
        tenant_max_queue: Optional[int] = None,
        trace_recorder: Any = None,
    ) -> None:
        if registries is not None and registry is not None:
            raise ValueError(
                "pass either registry (single-model) or registries "
                "(tenant lanes), not both"
            )
        self.engine = engine
        self.registry = registry
        self.registries = registries
        self.window_s = window_ms / 1e3
        self.default_timeout_s = default_timeout_s
        self.metrics = metrics or ServingMetrics()
        self.logger = logger
        self.emit_every = emit_every
        if registries is not None:
            if not registries:
                raise ValueError("registries must declare at least one lane")
            self._queue: Any = _TenantAdmission(
                registries, maxsize=tenant_max_queue or max_queue
            )
        else:
            self._queue = _ClassedQueue(maxsize=max_queue)
        # Optional loadgen.TraceRecorder: OFFERED arrivals (rows + SLO
        # class) recorded at submit, before admission control — the
        # live-trace feed for the elastic retuner and --record-trace.
        self.trace_recorder = trace_recorder
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._busy = False  # worker mid-dispatch (drain estimation)

    # -- client side -----------------------------------------------------

    def submit(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        slo_class: str = SLO_INTERACTIVE,
        model_id: Optional[str] = None,
    ) -> Future:
        """Enqueue one request of ``(n, *row_shape)`` observation rows.
        Returns a future resolving to :class:`ServedResult`. Raises
        :class:`BackpressureError` when the queue is full. ``trace_id``
        rides the request to the dispatch batch span (obs/) so one ID
        correlates a request across frontend, router, and batch.
        ``slo_class`` is the admission class (module docstring): batch
        requests yield to interactive ones under backpressure.
        ``model_id`` names the tenant lane — required (and validated
        against the declared lanes) in tenant mode, rejected in
        single-model mode."""
        if self._thread is None:
            raise RuntimeError("scheduler not started (use start() / with)")
        if slo_class not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo_class {slo_class!r}; known: {SLO_CLASSES}"
            )
        if self.registries is not None:
            if model_id is None:
                raise ValueError(
                    "this scheduler serves tenant lanes: submit requires "
                    f"model_id (known: {sorted(self.registries)})"
                )
            if model_id not in self.registries:
                raise ValueError(
                    f"unknown model_id {model_id!r}; known lanes: "
                    f"{sorted(self.registries)}"
                )
        elif model_id is not None:
            raise ValueError(
                "this scheduler serves a single model; model_id "
                f"{model_id!r} names a lane it does not have"
            )
        obs = np.asarray(obs, np.float32)
        if obs.ndim < 2 or obs.shape[0] < 1:
            raise ValueError(
                f"obs must be (n >= 1, *row_shape), got shape {obs.shape}"
            )
        if self.trace_recorder is not None:
            # Before admission control: the retuner must see the
            # backpressured arrivals too, or it never sees overload.
            self.trace_recorder.record(int(obs.shape[0]), slo_class)
        req = _Request(
            obs=obs,
            deterministic=bool(deterministic),
            future=Future(),
            enqueued=time.perf_counter(),
            timeout_s=(
                self.default_timeout_s if timeout_s is None else timeout_s
            ),
            trace_id=trace_id,
            slo_class=slo_class,
            model_id=model_id,
        )
        try:
            preempted = self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.record_reject()
            raise BackpressureError(self.retry_after_s(model_id)) from None
        if preempted is not None:
            # A queued batch request yielded its slot to this
            # interactive arrival: same reject-with-retry-after
            # contract as a door reject — the client's existing retry
            # loop re-submits it once pressure eases. In tenant mode
            # the preempted request is by construction the SAME lane's.
            self.metrics.record_preempted()
            if not preempted.future.done():
                preempted.future.set_exception(
                    BackpressureError(self.retry_after_s(model_id))
                )
        if self._stop.is_set():
            # stop() may have drained the queue between our liveness
            # check and the put — there is no worker left to take this
            # request, so drain again ourselves (resolving the future,
            # whether ours or another racing submitter's).
            self._drain_stopped_queue()
        self.metrics.record_submit(self._queue.qsize())
        return req.future

    def retry_after_s(self, model_id: Optional[str] = None) -> float:
        """Backoff hint: the window plus roughly how long the current
        backlog takes to drain at the recent batch rate. With a
        ``model_id`` (tenant mode) the backlog is THAT lane's — one
        lane's storm prices its own retries, not its neighbors'."""
        return self.window_s + self.estimated_drain_s(model_id)

    def estimated_drain_s(self, model_id: Optional[str] = None) -> float:
        """Roughly how long the current backlog takes to drain at the
        recent batch rate — the number a fleet router routes on. The
        in-flight batch counts: a worker stuck in a slow dispatch with
        an empty queue is NOT an idle replica."""
        if model_id is not None and self.registries is not None:
            depth = self._queue.lane_depth(model_id)
        else:
            depth = self._queue.qsize()
        backlog = depth + (1 if self._busy else 0)
        return backlog * self.metrics.mean_batch_seconds()

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def lane_queue_depth(self, model_id: str) -> int:
        """Queued requests in one tenant lane (tenant mode only)."""
        if self.registries is None:
            raise ValueError("single-model scheduler has no tenant lanes")
        return self._queue.lane_depth(model_id)

    @property
    def alive(self) -> bool:
        """True while the worker thread is serving. A stopped (or
        crashed-at-interpreter-teardown) worker makes every queued future
        dead weight — the router's liveness probe checks this."""
        return self._thread is not None and self._thread.is_alive()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "MicroBatchScheduler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="microbatch-scheduler", daemon=True
        )
        self._thread.start()
        return self

    def restart(self) -> None:
        """Replace a DEAD worker thread (the watchdog's fleet lane): a
        crashed worker leaves ``_thread`` set but not alive — clear it
        and spawn a fresh one. No-op while the worker is alive (a live
        worker owns its queue) and after an explicit ``stop()`` (a
        stopped scheduler stays stopped)."""
        if self._stop.is_set():
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = None
        self.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._thread = None
        # Fail anything still queued — no silent dropped futures.
        self._drain_stopped_queue()

    def fail_queued(self) -> None:
        """Fail every queued future with :class:`SchedulerStopped` — the
        router's DEAD-WORKER cleanup. A worker that crashed (rather than
        being stopped) leaves its queue orphaned; without this drain
        those callers wedge forever, with it their futures fail over to
        surviving replicas like any replica fault. Only call when the
        worker is not alive (a live worker owns its queue)."""
        self._drain_stopped_queue()

    def _drain_stopped_queue(self) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(
                    SchedulerStopped("scheduler stopped before dispatch")
                )

    def __enter__(self) -> "MicroBatchScheduler":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- worker side -----------------------------------------------------

    def _run(self) -> None:
        try:
            self._serve_loop()
        except BaseException as e:
            # The per-batch backstop in _serve_loop contains dispatch
            # errors; anything escaping to here kills the worker thread
            # outright — every queued future wedges until the router's
            # liveness probe notices. Snapshot the ring for the
            # postmortem before dying.
            get_tracer().incident(
                "scheduler_worker_death",
                error=repr(e),
                queue_depth=self._queue.qsize(),
            )
            raise

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            # Chaos seam: a crash here is a WORKER DEATH — it escapes to
            # _run (incident + thread exit) with no request in hand, and
            # the router's circuit breaker + dead-worker queue drain own
            # the recovery. Deliberately outside the per-batch backstop.
            fault_point("scheduler.dispatch")
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            rows = first.obs.shape[0]
            deadline = time.perf_counter() + self.window_s
            # Coalesce until the window closes or the top bucket is full
            # (more rows than the top bucket would split into a second
            # dispatch anyway — no latency win in waiting further).
            while rows < self.engine.max_bucket:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(nxt)
                rows += nxt.obs.shape[0]
            try:
                self._busy = True
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — the worker must survive
                # Backstop: _dispatch_group already contains engine
                # errors, but nothing outside it may kill the worker —
                # a dead worker wedges every future client forever.
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
            finally:
                self._busy = False

    def _dispatch(self, batch: List[_Request]) -> None:
        now = time.perf_counter()
        live: List[_Request] = []
        expired = 0
        for req in batch:
            if req.expired(now):
                req.future.set_exception(
                    RequestTimeout(
                        f"request waited {now - req.enqueued:.3f}s "
                        f"(timeout {req.timeout_s:.3f}s)"
                    )
                )
                expired += 1
            else:
                live.append(req)
        if expired:
            self.metrics.record_timeout(expired)
        # Group by (model lane, deterministic, row shape):
        # ``deterministic`` is per-batch (one device scalar), rows of
        # different trailing shapes cannot share a concatenated buffer,
        # and different lanes answer with different params — one client
        # sending odd-shaped observations must never fail another's
        # request, and one tenant's rows must never meet another's
        # weights.
        groups: dict = {}
        for r in live:
            groups.setdefault(
                (r.model_id, r.deterministic, r.obs.shape[1:]), []
            ).append(r)
        if self.registries is not None:
            # Per-lane barriers: each group runs under ITS lane's
            # barrier only, so a coordinator committing one lane's swap
            # waits out that lane's in-flight groups while every other
            # lane's groups keep dispatching — per-model step
            # monotonicity without a fleet-wide pause.
            for (mid, flag, _), group in groups.items():
                with self.registries[mid].batch_lock:
                    self._dispatch_group(group, flag, model_id=mid)
            return
        # Batch barrier: a registry may expose ``batch_lock`` (the fleet
        # replica registry does), held for the whole dispatch. A reload
        # coordinator that acquires EVERY replica's lock before flipping
        # any pointer gets a fleet-wide point in time with zero batches
        # in flight — the foundation of globally step-monotonic swaps.
        lock = getattr(self.registry, "batch_lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            for (_, flag, _), group in groups.items():
                self._dispatch_group(group, flag)

    def _dispatch_group(
        self,
        group: List[_Request],
        flag: bool,
        model_id: Optional[str] = None,
    ) -> None:
        registry = (
            self.registries[model_id]
            if self.registries is not None
            else self.registry
        )
        if registry is not None:
            nn_params, step = registry.active()
        else:
            nn_params, step = None, 0
        sizes = [r.obs.shape[0] for r in group]
        obs = (
            group[0].obs
            if len(group) == 1
            else np.concatenate([r.obs for r in group], axis=0)
        )
        t0 = time.perf_counter()
        try:
            actions = self.engine.act(
                obs, deterministic=flag, nn_params=nn_params
            )
        except Exception as e:  # noqa: BLE001 — fail the batch, not the server
            for req in group:
                req.future.set_exception(e)
            return
        done = time.perf_counter()
        tracer = get_tracer()
        if tracer.enabled:
            # The batch span LINKS the coalesced requests' trace IDs: a
            # request traced at the frontend is findable inside the
            # dispatch that actually served it. One ring append per
            # batch — host-side, after the engine returned.
            tracer.add_span(
                "serve.batch",
                t0,
                done,
                rows=sum(sizes),
                requests=len(group),
                model_step=int(step),
                model_id=model_id,
                trace_ids=[r.trace_id for r in group if r.trace_id],
            )
        latencies = []
        offset = 0
        for req, n in zip(group, sizes):
            latency = done - req.enqueued
            latencies.append(latency)
            req.future.set_result(
                ServedResult(
                    actions=actions[offset : offset + n],
                    model_step=step,
                    latency_s=latency,
                    model_id=model_id,
                )
            )
            offset += n
        total = sum(sizes)
        self.metrics.record_batch(
            rows=total,
            padded_rows=sum(self.engine.plan(total)),
            batch_seconds=done - t0,
            latencies_s=latencies,
            queue_depth=self._queue.qsize(),
        )
        if (
            self.logger is not None
            and self.metrics.batches_total % self.emit_every == 0
        ):
            record = self.metrics.snapshot()
            record["model_step"] = float(step)
            if registry is not None:
                record["model_swap_count"] = float(registry.swap_count)
            self.logger.log(record, step=self.metrics.batches_total)
