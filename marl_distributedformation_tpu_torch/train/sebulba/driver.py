"""Sebulba: the split acting/learning architecture.

Counterpart of the JAX package's ``train/sebulba/driver.py``. The devices
are partitioned into an **actor slice**, which replays the captured rollout
phase against a snapshot of the parameters, and a **learner slice**, which
drains K trajectory batches a chunk and replays the captured update phases
on each. The two meet only at host seams: a bounded
:class:`~.queues.TransferQueue` forward (backpressure, seq and
parameter-version stamps) and a single-slot :class:`~.queues.ParamBus`
back (latest wins, read at the actor's dispatch boundary). On one card
both lanes share the device, each on its own CUDA stream.

The cut is the port's Anakin iteration's (``train/iteration.py``): the
actor runs the ``rollout`` phase on its own copy of the model (rollout,
GAE, the update's rows and every epoch's permutation, drawn from the run
generator in the Anakin order) and moves the env carry on; the learner
runs the ``minibatch`` phase ``num_minibatch_steps`` times and then
``end`` (the metrics row and the health select over the learner's own
state). The permutations ride in the trajectory as JAX's ``k_update``
does, so the learner draws nothing, depth-1 lockstep
(:meth:`SebulbaDriver.run_lockstep_iteration`) equals the Anakin host loop
bitwise, and a pipelined run depends on thread timing only through the
parameter versions the actor acts with.

What the port does where JAX's buffers are immutable:

- **Parameters are updated in place** by the learner's captured Adam
  step, and the actor's captured rollout reads fixed addresses. A publish
  copies the learner's parameters, on the learner's stream, into one of
  two snapshot buffers (the one the bus does not hold) and records an
  event; at its dispatch boundary the actor, when the version changed,
  waits for that event on its stream and copies the snapshot into its own
  model. One lock orders the two hosts' enqueues, and each buffer's
  read-done event keeps a publish from landing mid-copy.
- **Trajectories are static buffers** that the next replay overwrites:
  after each rollout the actor copies the update's rows, permutations and
  rollout metrics into a free **slot** (``transfer_queue_depth + K + 1``
  of them) and enqueues the slot; the learner copies a slot into its own
  rows before its graphs replay, then frees it. Events order both copies.
- **Carry ownership**: the env carry belongs to the actor. A checkpoint
  is taken only with the actor between rollouts (a lock it holds while it
  acts), after its last rollout's work and before its next.

Both lanes build their graphs on the calling thread before the actor
thread starts: the first chunk runs in lockstep (its rollouts acted on the
main thread). Each lane's build is counted by its own guard
(``actor_guard``, ``learner_guard``) and registered in the program ledger
(subsystem ``sebulba``); the base class's Anakin phases are never run.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.algo.ppo import MinibatchData
from marl_distributedformation_tpu_torch.analysis.guards import (
    RetraceGuard,
    sample_device_watermark,
)
from marl_distributedformation_tpu_torch.device import (
    DeviceLike,
    resolve_device,
)
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.obs.metrics import get_registry
from marl_distributedformation_tpu_torch.scenarios import (
    ScenarioParams,
    ScenarioStreams,
    broadcast_params,
)
from marl_distributedformation_tpu_torch.train.capture import (
    PhaseGraph,
    own_stream,
)
from marl_distributedformation_tpu_torch.train.iteration import (
    PhasedIteration,
)
from marl_distributedformation_tpu_torch.train.recovery import (
    record_health_flags,
)
from marl_distributedformation_tpu_torch.train.sebulba.queues import (
    ParamBus,
    TransferItem,
    TransferQueue,
)
from marl_distributedformation_tpu_torch.train.trainer import (
    ChunkMetrics,
    TrainConfig,
    Trainer,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
)
from marl_distributedformation_tpu_torch.utils.logging import Throughput

Tensor = torch.Tensor


def partition_devices(
    actor_devices: int = 1, device: DeviceLike = None
) -> Tuple[Tuple[torch.device, ...], Tuple[torch.device, ...]]:
    """Split the CUDA devices into ``(actor_slice, learner_slice)``: the
    first ``actor_devices`` act, the rest learn, and at least one is left
    for the learner. With one card (or on the CPU, ``device``'s type) both
    slices are the same device: the lanes still pipeline through the
    queue, each on its own stream."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or torch.cuda.device_count() <= 1:
        return (dev,), (dev,)
    devices = tuple(torch.device("cuda", i)
                    for i in range(torch.cuda.device_count()))
    n = max(1, min(int(actor_devices), len(devices) - 1))
    return devices[:n], devices[n:]


def assign_gate_device(
    actor_devices: int = 1, device: DeviceLike = None
) -> torch.device:
    """The promotion gate's own device under the Sebulba partition: a
    device neither the actor slice nor the learner's first device (the one
    its chunk dispatches on) holds, so gate evals never contend with
    either lane; on a pool too small to spare one, the last device of the
    learner slice. With one card that is the learner's own device: an
    honest time-share, which the supervisor records as ``gate_device``."""
    actor_slice, learner_slice = partition_devices(actor_devices, device)
    busy = set(actor_slice) | {learner_slice[0]}
    dev = torch.device("cuda" if device is None else device)
    pool = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    free = [d for d in pool if d not in busy]
    return free[-1] if free else learner_slice[-1]


def _event(device: torch.device) -> Optional[torch.cuda.Event]:
    return torch.cuda.Event() if device.type == "cuda" else None


def _wait(event: Optional[torch.cuda.Event]) -> None:
    """The current stream waits for ``event`` (nothing on the CPU)."""
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


def _record(event: Optional[torch.cuda.Event]) -> None:
    if event is not None:
        event.record()


class _Slot:
    """One trajectory in flight: the update's rows and permutations and
    the rollout's metric row, on the learner's device. ``filled`` closes
    the actor's copy in, ``drained`` the learner's copy out."""

    def __init__(self, data: MinibatchData, perms: Tensor, row: Tensor,
                 device: torch.device) -> None:
        self.data = MinibatchData(**{
            f: None if v is None else torch.empty_like(v, device=device)
            for f, v in vars(data).items()
        })
        self.perms = torch.empty_like(perms, device=device)
        self.row = torch.empty_like(row, device=device)
        self.filled = _event(device)
        self.drained = _event(device)


class _Snapshot:
    """One of the bus's two parameter buffers, on the actor's device.
    ``written`` closes a publish's copy in, ``read`` the actor's copy
    out."""

    def __init__(self, params: Sequence[Tensor],
                 device: torch.device) -> None:
        self.tensors = [torch.empty_like(p, device=device) for p in params]
        self.written = _event(device)
        self.read = _event(device)


def _on(stream):
    """The lane's stream as the current one (a no-op on the CPU)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class SebulbaDriver(Trainer):
    """The trainer of ``architecture=sebulba``.

    Subclasses :class:`~..trainer.Trainer` for everything that is not
    dispatch: model, optimizer state, env reset, scenario schedules (the
    thread-safe hand-over included), checkpoints and resume.
    ``fused_chunk`` is K, the batches the learner drains a chunk (0 means
    1). Two dispatch surfaces:

    - :meth:`run_lockstep_iteration`: one thread walks actor -> queue ->
      learner -> bus, through the real transfer plumbing; bitwise the
      Anakin host loop's ``run_iteration``.
    - :meth:`train`: the actor thread acts against the newest published
      parameters while this thread drains, updates and publishes; the
      queue's backpressure bounds the actor's lead, the staleness gate
      what the learner accepts.
    """

    def __init__(
        self,
        env_params: EnvParams,
        ppo: PPOConfig = PPOConfig(),
        config: TrainConfig = TrainConfig(),
        *,
        model: torch.nn.Module,
        device: DeviceLike = None,
        capture: bool = True,
        scenario_schedule: Any = None,
        shard_fn: Any = None,
    ) -> None:
        if shard_fn is not None:
            raise SystemExit(
                "sebulba partitions WHOLE devices into actor/learner "
                "slices; mesh sharding (shard_fn) is Anakin-only — drop "
                "the mesh or use architecture=anakin"
            )
        if config.recovery:
            raise SystemExit(
                "the recovery ladder is Anakin-only for now (its rollback "
                "restores the full carry on one thread; the sebulba "
                "learner does not own env state) — drop recovery or use "
                "architecture=anakin. The in-program health word itself "
                "rides the sebulba learner fine: health=true"
            )
        if config.iters_per_dispatch > 1:
            raise SystemExit(
                "iters_per_dispatch is the Anakin host-loop burst "
                "spelling; sebulba fuses at the learner — set fused_chunk "
                "to K, the batches drained per update chunk"
            )
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise SystemExit(
                "sebulba is single-host for now (the transfer queue and "
                "param bus are process-local); run single-process or use "
                "the mesh tier for cross-host scale"
            )
        resolved = resolve_device(device)
        self.actor_slice, self.learner_slice = partition_devices(
            config.actor_devices, resolved)
        super().__init__(
            env_params, ppo, config, model=model,
            device=self.learner_slice[0], capture=capture,
            scenario_schedule=scenario_schedule,
        )
        self.actor_device = self.actor_slice[0]
        self._split_slices = self.actor_device != self.device
        self._learner_chunk_k = max(1, self._fused_chunk)
        learner = self._iteration
        learner.writes_env = False
        self._moved_generators()
        self._build_actor()
        budget = self.config.guard_retraces or None
        self.actor_guard = RetraceGuard("sebulba_actor", max_traces=budget,
                                        subsystem="sebulba")
        self.learner_guard = RetraceGuard("sebulba_learner",
                                          max_traces=budget,
                                          subsystem="sebulba")
        # Each lane captures and replays its graphs on its own stream, one
        # no other graph owner holds (train/capture.py: C6): the actor's
        # and the learner's graphs replay at once.
        self._actor_stream = own_stream(self, self.actor_device)
        self._learner_stream = own_stream(self, self.device)
        self._actor_phase = PhaseGraph(
            "actor_rollout", self._actor_step, self._actor_generators,
            self.capture, subsystem="sebulba",
            program="sebulba_actor_rollout", stream=self._actor_stream,
        )
        # The learner draws nothing: its permutations came with the rows.
        self._learner_phases = tuple(
            PhaseGraph(f"learner_{name}", fn, (), self.capture,
                       subsystem="sebulba", program=f"sebulba_learner_{name}",
                       stream=self._learner_stream)
            for name, fn in (("minibatch", learner.minibatch),
                             ("end", learner.end))
        )
        self._queue = TransferQueue(config.transfer_queue_depth)
        self._bus = ParamBus()
        self._slots: List[_Slot] = []
        self._free: collections.deque = collections.deque()
        self._slot_cond = threading.Condition()
        params = [p for _, p in self.model.named_parameters()]
        self._snapshots = [_Snapshot(params, self.actor_device)
                           for _ in range(2)]
        self._snapshot_lock = threading.Lock()
        self._actor_version = -1
        # Held by the actor while it acts (between parameter refresh and
        # the end of its copies out): a checkpoint takes it to find the
        # env carry at rest.
        self._carry_lock = threading.Lock()
        self._actor_done = _event(self.actor_device)
        self._snapshot_taken = _event(self.device)
        # What the caller's stream queued (model and env set-up, a resume's
        # copies, the actor's copies of them) comes before either lane.
        self._lanes_wait_for_caller()
        # Version 0 = the initial (or resumed) parameters.
        self._learner_version = 0
        self._publish(0)
        # ``staleness_samples``: every dequeued batch's staleness, those the
        # gate then drops included (the p95's population);
        # ``consumed_staleness``: the batches that reached an update;
        # ``consumed_versions``: their parameter versions, in order.
        self.staleness_samples: collections.deque = collections.deque(
            maxlen=65536)
        self.consumed_staleness: collections.deque = collections.deque(
            maxlen=65536)
        self.consumed_versions: List[int] = []
        self.stale_dropped = 0
        self.rollouts = 0  # actor rollouts, dropped and unconsumed ones too
        self._dispatches = 0
        self._actor_thread: Optional[threading.Thread] = None
        self._actor_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._actor_meter = Throughput()
        # Set by attach_watchdog: each lane beats once a rollout / chunk.
        self._actor_heartbeat: Any = None
        self._learner_heartbeat: Any = None

    # ------------------------------------------------------------------
    # The actor lane
    # ------------------------------------------------------------------

    def _moved_generators(self) -> None:
        """On a split pool the actor draws: the run's generators move to
        the actor's device with their state (one card: nothing moves)."""
        self._actor_generators = [self.generator]
        if self._scenario_schedule is not None:
            self._actor_generators.append(self.scenario_generator)
        if not self._split_slices:
            return
        moved = []
        for gen in self._actor_generators:
            new = torch.Generator(device=self.actor_device)
            new.set_state(gen.get_state())
            moved.append(new)
        self.generator = moved[0]
        if self._scenario_schedule is not None:
            self.scenario_generator = moved[1]
        self._actor_generators = moved

    def _build_actor(self) -> None:
        """The actor's model (a copy of the learner's) and its iteration,
        which owns the env carry from here on."""
        learner = self._iteration
        dev = self.actor_device
        self._actor_model = copy.deepcopy(self.model).to(dev)
        scenario: Dict[str, Any] = {}
        if self._scenario_schedule is not None:
            scenario = {
                "scenario_params": broadcast_params(
                    ScenarioParams.zeros(), self.config.num_formations, dev),
                "scenario_streams": ScenarioStreams(self.scenario_generator),
            }
        env = type(learner.env)(**{f: getattr(learner.env, f).to(dev)
                                   for f in learner.env_fields})
        self.actor_iteration = PhasedIteration(
            self.env_params, self.ppo, self._actor_model,
            adam_init(dict(self._actor_model.named_parameters())),
            self.generator, env, learner.obs.to(dev),
            **self._iteration_options(), **scenario,
        )

    def _actor_step(self, noise: Optional[Tensor] = None,
                    permutations: Optional[Tensor] = None) -> None:
        """The actor's phase: the Anakin rollout phase on the actor's model
        (``noise`` and ``permutations`` replace its draws, in tests), then
        the env carry moved on."""
        it = self.actor_iteration
        it.rollout(noise, permutations)
        with torch.no_grad():
            for carry, pending in it.env_pairs():
                carry.copy_(pending)

    def _refresh_actor_params(self) -> int:
        """At the actor's dispatch boundary: the bus's newest version into
        the actor's model when it changed; returns the version acted
        with."""
        with self._snapshot_lock:
            version, snap = self._bus.latest()
            if version != self._actor_version:
                _wait(snap.written)
                with torch.no_grad():
                    for dst, src in zip(self._actor_model.parameters(),
                                        snap.tensors):
                        dst.copy_(src)
                _record(snap.read)
                self._actor_version = version
        return version

    def _take_slot(self) -> Optional[_Slot]:
        with self._slot_cond:
            while not self._free:
                if self._stop.is_set() or self._queue.closed:
                    return None
                self._slot_cond.wait(timeout=1.0)
            return self._free.popleft()

    def _release_slot(self, slot: _Slot) -> None:
        with self._slot_cond:
            self._free.append(slot)
            self._slot_cond.notify()

    def _make_slots(self) -> None:
        """After the actor's first rollout has made the update's rows:
        ``transfer_queue_depth + K + 1`` slots, enough that the actor never
        waits for one (the queue holds ``depth``, the learner up to K, the
        actor one)."""
        it = self.actor_iteration
        n = self.config.transfer_queue_depth + self._learner_chunk_k + 1
        self._slots = [_Slot(it.update.data, it.update.perms,
                             it._rollout_row, self.device)
                       for _ in range(n)]
        self._free.extend(self._slots)
        learner = self._iteration
        learner._rollout_names = it._rollout_names
        learner._rollout_row = torch.empty_like(it._rollout_row,
                                                device=self.device)
        learner.update.data = MinibatchData(**{
            f: None if v is None else torch.empty_like(v)
            for f, v in vars(self._slots[0].data).items()
        })

    def _act(self) -> Optional[int]:
        """One actor dispatch on the calling thread and the actor's
        stream: the newest parameters, this rollout's scenario mix, the
        rollout's replay, its rows into a slot, and the slot into the
        queue. Returns the seq, or None when the batch was dropped or the
        lane is stopping."""
        with _on(self._actor_stream):
            with self._carry_lock:
                _wait(self._snapshot_taken)
                version = self._refresh_actor_params()
                if self._scenario_schedule is not None:
                    rows, _ = self._load_scenario_rows(1)
                    self.actor_iteration.scenario_params.copy_(
                        rows.map(lambda t: t[0]))
                if self._actor_phase.builds_next():
                    self.actor_guard.record(self.actor_iteration.env.agents,
                                            self.actor_iteration.obs)
                self._actor_phase()
                self.rollouts += 1
                self._advance(1)
                if not self._slots:
                    self._make_slots()
                slot = self._take_slot()
                if slot is None:
                    return None
                self._fill(slot)
                _record(self._actor_done)
            seq = self._queue.put(slot, version)
            if seq is None:
                # A dropped batch is a seq gap; its slot goes back to the
                # pool, or each drop would lose one for good.
                self._release_slot(slot)
            return seq

    def _chunked_draws(self, k: int) -> bool:
        # The actor draws one mix a rollout, as JAX's sebulba resamples
        # after each (the single sampler, whatever K is).
        return False

    def _fill(self, slot: _Slot) -> None:
        """The actor's rows, permutations and metric row into ``slot``,
        after the learner has drained what it held."""
        it = self.actor_iteration
        _wait(slot.drained)
        with torch.no_grad():
            for f, dst in vars(slot.data).items():
                if dst is not None:
                    dst.copy_(getattr(it.update.data, f), non_blocking=True)
            slot.perms.copy_(it.update.perms, non_blocking=True)
            slot.row.copy_(it._rollout_row, non_blocking=True)
        _record(slot.filled)

    # ------------------------------------------------------------------
    # The learner lane
    # ------------------------------------------------------------------

    def _load(self, slot: _Slot) -> None:
        """A slot's rows into the learner's update (its static rows,
        permutations and the minibatch counter), the health backups, and
        the slot back to the pool."""
        learner = self._iteration
        update = learner.update
        _wait(slot.filled)
        with torch.no_grad():
            for f, src in vars(slot.data).items():
                if src is not None:
                    getattr(update.data, f).copy_(src)
            update.perms.copy_(slot.perms)
            update.counter.zero_()
            learner._rollout_row.copy_(slot.row)
        if learner.health is not None:
            learner.health.save()
        _record(slot.drained)
        self._release_slot(slot)

    def _learn(self, items: Sequence[TransferItem]) -> ChunkMetrics:
        """One learner chunk over ``items`` on the learner's stream: each
        batch loaded and trained (the minibatch graph replayed
        ``num_minibatch_steps`` times, then the end graph); returns the
        chunk's metric rows, still on the device."""
        learner = self._iteration
        minibatch, end = self._learner_phases
        with _on(self._learner_stream):
            for item in items:
                self._load(item.payload)
                if any(p.builds_next() for p in self._learner_phases):
                    self.learner_guard.record(learner.update.data.obs)
                for _ in range(learner.num_minibatch_steps):
                    minibatch()
                end()
                learner.ring.advance()
            ready = _event(self.device)
            _record(ready)
        get_registry().counter("train_iterations_total").inc(len(items))
        return ChunkMetrics(learner.metric_names(),
                            learner.ring.take(len(items)), ready)

    def _publish(self, version: int) -> bool:
        """The learner's parameters into the snapshot buffer the bus does
        not hold, on the learner's stream, then onto the bus."""
        with self._snapshot_lock:
            _, current = self._bus.latest()
            snap = (self._snapshots[1] if current is self._snapshots[0]
                    else self._snapshots[0])
            with _on(self._learner_stream):
                _wait(snap.read)
                with torch.no_grad():
                    for dst, src in zip(snap.tensors,
                                        self.model.parameters()):
                        dst.copy_(src, non_blocking=True)
                _record(snap.written)
            return self._bus.publish(snap, version)

    def _consume(self, item: TransferItem) -> bool:
        """The staleness gate: record the batch's staleness; False (and
        the slot back to the pool) when it is over the bound."""
        staleness = self._learner_version - item.params_version
        self.staleness_samples.append(staleness)
        get_registry().gauge("param_staleness_updates").set(float(staleness))
        if staleness > self.config.max_param_staleness:
            self.stale_dropped += 1
            get_registry().counter("sebulba_stale_dropped_total").inc()
            self._release_slot(item.payload)
            return False
        self.consumed_staleness.append(staleness)
        self.consumed_versions.append(item.params_version)
        return True

    def _lanes_wait_for_caller(self) -> None:
        """Both lanes' streams wait for the work the calling thread's
        stream has queued so far."""
        if self._actor_stream is not None:
            caller = torch.cuda.current_stream()
            self._actor_stream.wait_stream(caller)
            self._learner_stream.wait_stream(caller)

    def _caller_waits_for_lanes(self) -> None:
        """The calling thread's stream waits for both lanes, so that what
        it reads next (metrics, parameters, the env carry) is current."""
        if self._actor_stream is not None:
            caller = torch.cuda.current_stream()
            caller.wait_stream(self._actor_stream)
            caller.wait_stream(self._learner_stream)

    # ------------------------------------------------------------------
    # Anakin's dispatch surfaces are fenced off
    # ------------------------------------------------------------------

    def run_iteration(self) -> Dict[str, Tensor]:
        raise SystemExit(
            "sebulba dispatches via run_lockstep_iteration() (depth-1 "
            "parity mode) or train() (pipelined lanes) — Anakin's "
            "run_iteration() would compile the fused train program "
            "beside the slice programs"
        )

    def run_chunk(self) -> ChunkMetrics:
        raise SystemExit(
            "sebulba has no Anakin chunk dispatch; fused_chunk is K, the "
            "learner's drain width — use train() or "
            "run_lockstep_iteration()"
        )

    # ------------------------------------------------------------------
    # Lockstep
    # ------------------------------------------------------------------

    def run_lockstep_iteration(self) -> Dict[str, Tensor]:
        """One actor -> queue -> learner -> bus round trip on the calling
        thread, through the real plumbing (seq and version stamps,
        occupancy); bitwise the Anakin host loop's ``run_iteration``.
        Returns the iteration's metrics on the device. An enqueue drop
        (chaos) returns ``{}``: the rollout happened and was counted,
        nothing was learned."""
        self._apply_pending_schedule()
        self._lanes_wait_for_caller()
        try:
            if self._act() is None:
                return {}
            item = self._queue.get(timeout_s=5.0)
            if item is None or not self._consume(item):
                return {}
            chunk = self._learn([item])
            self._learner_version += 1
            self._publish(self._learner_version)
            self._dispatches += 1
        finally:
            self._caller_waits_for_lanes()
        # A copy: the ring's row is written again two iterations on.
        return self._iteration.metrics(chunk.rows[0].clone())

    def _lockstep_chunk(self, k: int) -> List[TransferItem]:
        """K batches acted on this thread, each dequeued as it lands (the
        first chunk of ``train``, which builds both lanes before the actor
        thread starts)."""
        items: List[TransferItem] = []
        while len(items) < k:
            self._apply_pending_schedule()
            if self._act() is None:
                continue
            item = self._queue.get(timeout_s=5.0)
            if item is not None and self._consume(item):
                items.append(item)
        return items

    # ------------------------------------------------------------------
    # Pipelined
    # ------------------------------------------------------------------

    def lanes_built(self) -> bool:
        """Whether both lanes' programs are built (graphs captured on the
        card, eager steps run on the CPU)."""
        phases = (self._actor_phase, *self._learner_phases)
        return all(p.calls > 0 and not p.builds_next() for p in phases)

    def _spawn_actor(self) -> None:
        self._actor_thread = threading.Thread(
            target=self._actor_loop, name="sebulba-actor", daemon=True)
        self._actor_thread.start()

    def _restart_actor(self) -> None:
        """The watchdog's restart of a dead actor thread: the carry still
        holds the last finished rollout's state, so the new thread goes on
        with the stream. No-op while the actor lives or after a stop."""
        if self._stop.is_set():
            return
        if self._actor_thread is not None and self._actor_thread.is_alive():
            return
        self._actor_error = None
        self._spawn_actor()

    def attach_watchdog(self, watchdog: Any) -> None:
        """Register both lanes with a ``chaos.LaneWatchdog``: their
        heartbeats age a rollout (actor) and a chunk (learner); a dead
        actor thread restarts through :meth:`_restart_actor`; a learner
        that stops beating past the wedge timeout is reported (it is the
        calling thread, which nothing restarts)."""
        from marl_distributedformation_tpu_torch.chaos.watchdog import (
            Heartbeat,
        )

        self._actor_heartbeat = Heartbeat("sebulba_actor")
        self._learner_heartbeat = Heartbeat("sebulba_learner")
        watchdog.register(
            "sebulba_actor", self._actor_heartbeat,
            is_alive=lambda: (self._actor_thread is None
                              or self._actor_thread.is_alive()
                              or self._stop.is_set()),
            restart=self._restart_actor,
        )
        watchdog.register(
            "sebulba_learner", self._learner_heartbeat,
            is_alive=lambda: True, restart=lambda: None,
        )

    def _actor_loop(self) -> None:
        """The producer lane: act against the newest parameters and
        enqueue, until stopped. The queue's backpressure is its only
        pacing. The env carry and the scenario counters are written only
        here while it runs."""
        try:
            while not self._stop.is_set():
                self._apply_pending_schedule()
                self._act()
                if self._queue.closed:
                    return
                if self._actor_heartbeat is not None:
                    self._actor_heartbeat.beat()
                self._actor_meter.tick(
                    self.ppo.n_steps * self.config.num_formations)
                get_registry().gauge("actor_env_steps_per_sec").set(
                    self._actor_meter.rate())
        except BaseException as exc:  # surfaced by the learner loop
            self._actor_error = exc
            self._queue.close()

    def _collect_chunk(
        self, k: int, timeout_s: float = 60.0
    ) -> Optional[List[TransferItem]]:
        """K fresh-enough batches for one learner chunk; staler ones are
        dropped here (counted, never trained on). None when the stream
        ended (queue closed, actor dead, timeout) before K arrived."""
        items: List[TransferItem] = []
        deadline = time.monotonic() + timeout_s
        while len(items) < k:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            item = self._queue.get(timeout_s=min(1.0, remaining))
            if item is None:
                if self._queue.closed or not (
                    self._actor_thread and self._actor_thread.is_alive()
                ):
                    return None
                continue
            if self._consume(item):
                items.append(item)
        return items

    def train(self) -> Dict[str, float]:
        """Pipelined training: the actor thread produces, this thread
        drains K batches a chunk, updates and publishes; records an
        iteration as the fused drain's, checkpoints at chunk boundaries
        on the background writer. The budget is counted at the actor; the
        batches still queued when it is reached are left unconsumed."""
        logger = self._logger()
        learner_meter = Throughput()
        writer = (
            AsyncCheckpointWriter(keep_last_n=self.config.keep_last_n,
                                  protect=self._protected_paths)
            if self.config.checkpoint else None
        )
        tracer = self.trace_window
        registry = get_registry()
        k = self._learner_chunk_k
        per_iter = self.ppo.n_steps * self.num_envs
        iteration = 0
        self._stop.clear()
        self._lanes_wait_for_caller()
        try:
            while self.num_timesteps < self.total_timesteps:
                if self.lanes_built():
                    if self._actor_thread is None:
                        self._spawn_actor()
                    items = self._collect_chunk(k)
                else:
                    items = self._lockstep_chunk(k)
                if items is None:
                    break
                steps_before = self.num_timesteps
                tracer.before_dispatch()
                chunk = self._learn(items)
                self._learner_version += 1
                self._publish(self._learner_version)
                tracer.after_dispatch()
                if self._learner_heartbeat is not None:
                    self._learner_heartbeat.beat()
                self._dispatches += 1
                t_drain = time.perf_counter()
                host = chunk.to_host()
                registry.histogram("train_chunk_drain_seconds").observe(
                    time.perf_counter() - t_drain)
                registry.counter("train_chunks_total").inc()
                sample_device_watermark()
                record_health_flags(host)
                learner_meter.tick(k)
                registry.gauge("learner_steps_per_sec").set(
                    learner_meter.rate())
                registry.gauge("train_compiles").set(
                    self.actor_guard.count + self.learner_guard.count)
                for i in range(k):
                    if (iteration + i + 1) % self.config.log_interval:
                        continue
                    record = {n: float(host[n][i]) for n in sorted(host)}
                    record["learner_steps_per_sec"] = learner_meter.rate()
                    record["actor_env_steps_per_sec"] = (
                        self._actor_meter.rate())
                    record["param_staleness_updates"] = float(
                        self._learner_version - 1 - items[i].params_version)
                    logger.log(record, steps_before + (i + 1) * per_iter)
                    self.last_record = record
                iteration += k
                if (writer is not None
                        and self._vec_steps_since_save
                        >= self.config.save_freq):
                    self.save_async(writer)
        finally:
            tracer.close()
            self._stop.set()
            self._queue.close()
            if self._actor_thread is not None:
                self._actor_thread.join(timeout=30.0)
            self._caller_waits_for_lanes()
            if writer is not None:
                if self._actor_error is None:
                    self.save_async(writer)
                writer.close_quietly()
            logger.close()
        if self._actor_error is not None:
            raise RuntimeError("sebulba actor lane died") \
                from self._actor_error
        return self.last_record

    # ------------------------------------------------------------------
    # Checkpoints: the env carry is the actor's
    # ------------------------------------------------------------------

    @property
    def env_state(self):
        return self.actor_iteration.env

    @property
    def obs(self) -> Tensor:
        return self.actor_iteration.obs

    @property
    def scenario_params(self) -> Optional[ScenarioParams]:
        return self.actor_iteration.scenario_params

    def _checkpoint_state(self) -> Dict[str, Any]:
        state = super()._checkpoint_state()
        it = self.actor_iteration
        state["env"] = {f: getattr(it.env, f) for f in it.env_fields}
        state["obs"] = it.obs
        return state

    def save(self) -> Optional[str]:
        with self._carry_lock:
            self._caller_waits_for_lanes()
            return super().save()

    def save_async(self, writer: AsyncCheckpointWriter) -> str:
        """A checkpoint with the actor between rollouts: the snapshot is
        queued on the learner's stream after the actor's last rollout, and
        the actor's next waits for it."""
        with self._carry_lock, _on(self._learner_stream):
            _wait(self._actor_done)
            path = super().save_async(writer)
            _record(self._snapshot_taken)
            return path

    # ------------------------------------------------------------------
    # Accessors
    # ------------------------------------------------------------------

    def graph_count(self) -> int:
        return sum(p.graph is not None
                   for p in (self._actor_phase, *self._learner_phases))

    def graph_stats(self) -> List[Dict[str, object]]:
        return [p.stats() for p in (self._actor_phase,
                                    *self._learner_phases)]

    def occupancy_p95(self) -> float:
        """p95 of the transfer queue's occupancy at each enqueue (0.0
        before any traffic)."""
        if not self._queue.occupancy_samples:
            return 0.0
        return float(np.percentile(
            np.asarray(self._queue.occupancy_samples), 95))

    def staleness_p95(self) -> float:
        """p95 of the parameter staleness (learner updates) of every batch
        the learner saw, consumed or dropped."""
        if not self.staleness_samples:
            return 0.0
        return float(np.percentile(np.asarray(self.staleness_samples), 95))

    @property
    def transfer_queue(self) -> TransferQueue:
        return self._queue

    @property
    def param_bus(self) -> ParamBus:
        return self._bus
