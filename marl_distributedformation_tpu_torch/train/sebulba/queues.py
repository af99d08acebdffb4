"""Host-side transfer plumbing of the Sebulba lane.

Counterpart of the JAX package's ``train/sebulba/queues.py``, with its
semantics and metric names. Two primitives connect the actor lane to the
learner lane:

- :class:`TransferQueue` — a bounded FIFO of trajectory batches. ``put``
  blocks when the queue is full (backpressure: the actor can never run
  more than ``depth`` rollouts ahead of the learner) and stamps every item
  with a monotone ``seq`` and the ``params_version`` the rollout was acted
  with. The consume side carries a seq guard: a redelivered item (the
  chaos ``sebulba.dequeue`` seam re-queues the item it just handed out) is
  absorbed and counted, never consumed twice.
- :class:`ParamBus` — the single-slot, latest-wins channel back.
  ``publish`` swaps the slot under a lock and ignores non-monotone
  versions; ``latest`` is the atomic read the actor makes at its dispatch
  boundary. A ``raise`` armed on ``sebulba.param_publish`` drops the
  publish: the actor keeps acting on the previous version until the next
  one lands, and the learner's staleness gate bounds the damage.

The queue and the bus carry handles, not tensors: where the JAX package
places the payload on the other slice at these seams, the port's driver
(``driver.py``) copies trajectories into device slots and parameters into
snapshot buffers on each lane's own stream, ordered by CUDA events, and
hands those over. Both ends record into the metrics registry at host
seams only (``transfer_queue_occupancy``, ``param_bus_version``, the drop
and duplicate counters) and keep small host lists (``consumed_seqs``,
``occupancy_samples``) that the invariants and percentiles are computed
from.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, List, NamedTuple, Optional, Tuple

from marl_distributedformation_tpu_torch.chaos.plane import (
    InjectedFault,
    fault_point,
)
from marl_distributedformation_tpu_torch.obs.metrics import get_registry

#: Artifact ring bound: campaigns and bench runs are short, but a
#: long-lived driver must not grow host lists without bound.
_MAX_SAMPLES = 65536


class TransferItem(NamedTuple):
    """One queued trajectory batch: ``seq`` is the queue's monotone
    enqueue stamp, ``params_version`` the :class:`ParamBus` version the
    actor acted with, ``payload`` what the actor hands over (the driver's
    trajectory slot)."""

    seq: int
    params_version: int
    payload: Any


class TransferQueue:
    """Bounded host-side queue between the actor and learner lanes."""

    def __init__(self, depth: int, name: str = "transfer_queue") -> None:
        if depth < 1:
            raise ValueError(
                f"transfer_queue_depth must be >= 1, got {depth}"
            )
        self.depth = int(depth)
        self.name = name
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._next_seq = 0
        self._last_consumed = -1
        self._closed = False
        # Campaign / bench artifacts (host ints only, bounded).
        self.consumed_seqs: collections.deque = collections.deque(
            maxlen=_MAX_SAMPLES
        )
        self.occupancy_samples: collections.deque = collections.deque(
            maxlen=_MAX_SAMPLES
        )
        self.enqueued_total = 0
        self.dropped_total = 0
        self.duplicates_absorbed = 0
        get_registry().gauge(f"{name}_depth").set(float(self.depth))

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def put(
        self,
        payload: Any,
        params_version: int,
        timeout_s: Optional[float] = None,
    ) -> Optional[int]:
        """Enqueue one trajectory batch; blocks while the queue is full
        (the backpressure contract). Returns the assigned seq, or None
        when the batch was dropped (queue closed, timeout expired, or
        the ``sebulba.enqueue`` chaos seam fired — a dropped batch is a
        seq GAP downstream, never a duplicate)."""
        # Both conditions share self._lock; acquiring the lock directly
        # keeps every guarded write visibly inside `with self._lock:`
        # (the graftlock contract) while wait/notify still work — a
        # Condition's wait releases and reacquires its backing lock.
        with self._lock:
            while len(self._items) >= self.depth and not self._closed:
                if not self._not_full.wait(timeout=timeout_s):
                    return None
            if self._closed:
                return None
            seq = self._next_seq
            self._next_seq += 1
        try:
            # Chaos seam (chaos/plane.py): an armed 'raise' is the DROP
            # effect — the batch vanishes in transfer, the seq is spent.
            fault_point("sebulba.enqueue")
        except InjectedFault:
            self.dropped_total += 1
            get_registry().counter(
                "sebulba_dropped_batches_total"
            ).inc()
            return None
        with self._lock:
            self._items.append(TransferItem(seq, int(params_version), payload))
            occupancy = len(self._items)
            self._not_empty.notify()
        self.enqueued_total += 1
        self.occupancy_samples.append(occupancy)
        get_registry().gauge(f"{self.name}_occupancy").set(float(occupancy))
        return seq

    def get(self, timeout_s: Optional[float] = None) -> Optional[TransferItem]:
        """Dequeue the next batch; blocks up to ``timeout_s`` (None =
        forever). Returns None on timeout or when the queue is closed
        and drained. Redelivered items (seq already consumed) are
        absorbed here — the consume-twice guard."""
        while True:
            item = self._pop(timeout_s)
            if item is None:
                return None
            try:
                # Chaos seam: an armed 'raise' is the DUPLICATE effect —
                # the item is re-queued at the head (a redelivery bug's
                # shape) while this delivery proceeds; the seq guard
                # below absorbs the replay on the next get.
                fault_point("sebulba.dequeue")
            except InjectedFault:
                with self._lock:
                    self._items.appendleft(item)
                    self._not_empty.notify()
            with self._lock:
                if item.seq <= self._last_consumed:
                    duplicate = True
                else:
                    duplicate = False
                    self._last_consumed = item.seq
            if duplicate:
                self.duplicates_absorbed += 1
                get_registry().counter(
                    "sebulba_duplicates_absorbed_total"
                ).inc()
                continue
            self.consumed_seqs.append(item.seq)
            get_registry().gauge(f"{self.name}_occupancy").set(
                float(len(self))
            )
            return item

    def _pop(self, timeout_s: Optional[float]) -> Optional[TransferItem]:
        with self._lock:
            while not self._items:
                if self._closed:
                    return None
                if not self._not_empty.wait(timeout=timeout_s):
                    return None
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def close(self) -> None:
        """Wake every blocked producer/consumer; puts fail from here on,
        gets drain the remaining items then return None."""
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()


class ParamBus:
    """Single-slot, latest-wins params channel from learner to actors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._version = -1
        self._params: Any = None
        self.publishes_dropped = 0
        self.versions_published: List[int] = []

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def publish(self, params: Any, version: int) -> bool:
        """Atomic slot swap. Returns False when the publish was dropped:
        by the ``sebulba.param_publish`` chaos seam (the stale-params
        effect — actors keep the previous version) or because a newer
        version already holds the slot (latest wins; version regression
        is structurally impossible at the actor)."""
        try:
            fault_point("sebulba.param_publish")
        except InjectedFault:
            self.publishes_dropped += 1
            get_registry().counter(
                "sebulba_param_publish_dropped_total"
            ).inc()
            return False
        with self._lock:
            if version <= self._version:
                return False
            self._params = params
            self._version = int(version)
            if len(self.versions_published) < _MAX_SAMPLES:
                self.versions_published.append(self._version)
        get_registry().gauge("param_bus_version").set(float(version))
        return True

    def latest(self) -> Tuple[int, Any]:
        """The atomic read at the actor dispatch boundary: the newest
        ``(version, params)`` pair, swapped in one lock acquisition."""
        with self._lock:
            return self._version, self._params
