"""Fleet-wide coordinated hot reload: poll once, swap everywhere,
globally step-monotonic.

Counterpart of the JAX package's ``serving/fleet/reload.py``.
``ModelRegistry`` (serving/registry.py) solves hot reload for ONE engine:
snapshot-per-batch plus a step-monotonic swap under a lock. A fleet of
replicas re-raises the consistency question — if each replica polled and
swapped independently, N replicas would pay N restores per checkpoint,
and a client hopping between replicas could observe ``model_step`` going
BACKWARD (replica A answers at step 200, then replica B, its poll racing
a slow restore, at step 100).

:class:`FleetReloadCoordinator` does what the JAX package's does:

1. **Poll once.** One watcher polls ``logs/{name}/`` through
   ``CheckpointDiscovery``; one restore and one validation a checkpoint,
   whatever the fleet's width.
2. **Stage.** The validated parameters are copied onto every replica's
   device, one copy a replica (a registry never aliases another's
   tensors), and those copies are finished — the staging stream
   synchronized — BEFORE any barrier closes: no replica stalls mid-swap on
   an upload, and no engine can load a half-written tensor.
3. **Commit at the fleet batch barrier.** Every replica's scheduler holds
   its registry's ``batch_lock`` over each dispatch. The coordinator
   acquires ALL replica locks — possible only when zero batches are in
   flight anywhere — flips every replica's ``(params, step)`` cell and
   releases. The engine copies the new snapshot into its captured
   parameter tensors at its next dispatch, inside that dispatch's barrier
   (``serving/engine.py``), so every response resolved before the commit
   carries the old step and every response dispatched after it the new
   one: ``model_step`` is monotonic in response order, fleet-wide.

Failure containment mirrors the single-engine registry: another
architecture, a drifted dtype or a foreign checkpoint is a recorded
``load_errors`` entry and the fleet keeps serving the old parameters;
older or equal steps are ignored; broken replicas receive the new
parameters too, so a revived replica serves the current step.

The cross-host two-phase commit the serving mesh drives
(``prepare_global`` / ``commit_prepared`` / ``abort_prepared``,
``serving/mesh``) splits the same commit at its commit point; the elastic
re-split (``commit_resplit``, ``serving/elastic``) lands a new replica set
at the same barrier.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.compat.convert import (
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.obs import get_tracer
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CheckpointDiscovery,
    checkpoint_step,
    latest_checkpoint,
    restore_state_dict_partial,
)


class BatchBarrier:
    """A dispatch lock with a coordinator-side gate.

    The worker side is a plain context manager held across each dispatch
    (``with registry.batch_lock:``). The subtlety is FAIRNESS: under load
    a worker releases its lock and re-acquires it microseconds later for
    the next batch, and CPython locks are not FIFO — a coordinator blocked
    in ``acquire()`` could starve behind that loop. So the coordinator
    first ``close()``s the gate; workers park at the gate BEFORE
    contending the lock, and the coordinator gets every lock within at
    most one in-flight batch. ``open()`` releases the parked workers after
    the commit.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._open = threading.Event()
        self._open.set()

    # -- worker side (one dispatch) --------------------------------------

    def __enter__(self) -> "BatchBarrier":
        self._open.wait()
        self._lock.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock.release()

    # -- coordinator side (fleet commit) ---------------------------------

    def close(self) -> None:
        self._open.clear()

    def acquire(self, timeout: Optional[float] = None) -> bool:
        return self._lock.acquire(timeout=-1 if timeout is None else timeout)

    def release(self) -> None:
        self._lock.release()

    def open(self) -> None:
        self._open.set()


def device_copy(params: Dict[str, torch.Tensor],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """``params`` copied onto ``device`` (always a copy, never an alias),
    the copies finished when this returns: on the card they run on a
    side stream that is synchronized. A sharded replica's ``device`` is
    its engine, which places the copies on its slice (``shard_params``)."""
    if hasattr(device, "shard_params"):
        return device.shard_params(params)
    device = torch.device(device)
    if device.type != "cuda":
        return {k: v.detach().to(device, copy=True)
                for k, v in params.items()}
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out = {k: v.detach().to(device, copy=True, non_blocking=True)
               for k, v in params.items()}
    stream.synchronize()
    return out


class ReplicaRegistry:
    """One replica's ``(params, step)`` cell plus its batch barrier.

    ``params`` is a dict of the served model's ``state_dict`` names to
    tensors on the replica's device, the registry's own copy. The
    scheduler holds ``batch_lock`` across each dispatch and reads
    :meth:`active` once per micro-batch; the coordinator writes through
    :meth:`install` only while holding every replica's barrier.
    ``active`` itself takes no lock — one attribute read is atomic in
    CPython, and the worker already holds the barrier when it snapshots
    (a locking ``active`` would deadlock on itself)."""

    def __init__(self, params: Any, step: int, device: Any = None) -> None:
        self.device = device
        self.batch_lock = BatchBarrier()
        self.swap_count = 0  # guarded by batch_lock
        self._snapshot: Tuple[Any, int] = (params, step)  # batch_lock

    def active(self) -> Tuple[Any, int]:
        return self._snapshot

    @property
    def active_step(self) -> int:
        return self._snapshot[1]

    def install(self, params: Any, step: int) -> None:
        """Replace the serving snapshot. Caller holds ``batch_lock``."""
        self._snapshot = (params, step)
        self.swap_count += 1


class FleetReloadCoordinator:
    """Single poller + fleet-wide batch-barrier swap over a router.

    Args:
      log_dir: the ``logs/{name}/`` directory the trainer checkpoints to.
      router: a ``fleet.FleetRouter``, started or not; the coordinator
        swaps through its replicas' :class:`ReplicaRegistry` cells.
      poll_interval_s: cadence of the background watcher (``start()``);
        ``refresh()`` may also be called directly.
      commit_timeout_s: bound on waiting for any one replica's barrier at
        commit time. A worker wedged inside a dispatch holds its lock
        indefinitely; without the bound one wedged replica would park the
        whole fleet behind closed gates. On timeout the commit aborts
        cleanly — locks released, gates reopened, a recorded
        ``load_errors`` entry — and every replica keeps serving the old
        step (never a partial swap); the next poll retries.
      model_id: optional tenant lane: the coordinator then commits into
        each replica's ``registries[model_id]`` cell and acquires only
        that lane's barriers, and ``fleet_step`` is that lane's own step.
    """

    def __init__(
        self,
        log_dir: str | Path,
        router: Any,
        poll_interval_s: float = 2.0,
        max_recorded_errors: int = 32,
        commit_timeout_s: float = 30.0,
        model_id: Optional[str] = None,
    ) -> None:
        self.log_dir = Path(log_dir)
        self.router = router
        self.model_id = model_id
        self.poll_interval_s = poll_interval_s
        self.commit_timeout_s = commit_timeout_s
        self.swap_count = 0  # guarded by _refresh_lock
        # The newest landed swap's attribution (one host, the round).
        self.last_commit: Optional[dict] = None  # guarded by _refresh_lock
        # Unlocked on purpose: deque.append is atomic under the GIL and
        # failure paths record without re-entering any lock.
        self.load_errors: Deque[Tuple[str, str]] = deque(
            maxlen=max_recorded_errors
        )
        # The longest barrier hold of the newest commit (gates closed to
        # gates reopened), in ms: the serving pause a swap costs.
        self.last_pause_ms = 0.0
        self._discovery = CheckpointDiscovery(self.log_dir)
        self._policy_name = type(router.policy.model).__name__
        # The restore template: the served architecture in the
        # checkpoint's layout (float32 leaves).
        self._template = params_to_jax(router.policy.params,
                                       self._policy_name)
        # The fleet step starts at the newest step any replica already
        # serves (the router seeds every replica identically).
        self._fleet_step = max(  # guarded by _refresh_lock
            reg.active_step for reg in self._commit_registries()
        )
        self._refresh_lock = threading.Lock()
        # The cross-host round this host has staged and awaits the mesh
        # coordinator's commit or abort for (``prepare_global``).
        self._staged: Optional[dict] = None  # guarded by _staged_lock
        self._staged_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _commit_registries(self) -> List[ReplicaRegistry]:
        """The cells this coordinator swaps, one a replica: each
        replica's ``registry``, or its ``registries[model_id]`` lane."""
        if self.model_id is None:
            return [r.registry for r in self.router.replicas]
        return [r.registries[self.model_id] for r in self.router.replicas]

    @property
    def fleet_step(self) -> int:
        """The step every post-commit dispatch serves (this lane's, when
        the coordinator is lane-keyed)."""
        return self._fleet_step

    # -- reload ---------------------------------------------------------

    def refresh(self, trace_id: Optional[str] = None) -> bool:
        """Check the directory once; coordinated-swap if a newer
        checkpoint landed. Returns True on swap. Load failures keep the
        old params serving fleet-wide and are recorded."""
        with self._refresh_lock:
            path = self._discovery.latest()
            if path is None:
                return False
            step = checkpoint_step(path)
            if step <= self._fleet_step:
                return False
            return self._load_and_commit(path, step, trace_id)

    def reload_pinned(
        self,
        path: str | Path,
        monotonic: bool = True,
        trace_id: Optional[str] = None,
    ) -> bool:
        """Coordinated swap of an explicit checkpoint path, bypassing
        discovery. ``monotonic=False`` is the demotion hook (a rollback
        to a last-good checkpoint at the same barrier; the caller retracts
        the demoted file from the watched directory). Same containment
        contract as :meth:`refresh`."""
        path = Path(path)
        with self._refresh_lock:
            try:
                step = checkpoint_step(path)
            except ValueError as e:
                self.load_errors.append((str(path), repr(e)))
                return False
            if monotonic and step <= self._fleet_step:
                return False
            if step == self._fleet_step:
                return False  # already serving exactly this step
            return self._load_and_commit(path, step, trace_id)

    def _load_and_commit(
        self, path: Path, step: int, trace_id: Optional[str] = None
    ) -> bool:
        """Restore + validate once, stage a copy a replica, then commit
        fleet-wide at the batch barrier. Caller holds ``_refresh_lock``."""
        tracer = get_tracer()
        try:
            with tracer.span(
                "reload.load", trace_id=trace_id, step=step, path=str(path)
            ):
                restored = self._load_validated(path)
            # Stage: one copy a replica, finished before any gate closes
            # — the commit window is lock acquisition plus pointer flips,
            # never a weight transfer.
            with tracer.span("reload.stage", trace_id=trace_id, step=step):
                staged = [
                    (reg, device_copy(restored, reg.device))
                    for reg in self._commit_registries()
                ]
        except Exception as e:  # noqa: BLE001 — serving must not die
            self.load_errors.append((str(path), repr(e)))
            return False
        barriers = [reg.batch_lock for reg, _ in staged]
        held: List[BatchBarrier] = []
        installed: List[Tuple[ReplicaRegistry, Tuple[Any, int]]] = []
        wedged_replica = None
        t_closed = time.perf_counter()
        try:
            # Close every gate first: workers finish their current batch
            # and park instead of re-contending their lock, so the
            # acquisitions complete within one in-flight batch. With all
            # locks held, zero batches are in flight fleet-wide: the
            # commit point. A wedged replica aborts the WHOLE commit.
            for b in barriers:
                b.close()
            for i, b in enumerate(barriers):
                fault_point("fleet.barrier")
                t_acq = time.perf_counter()
                acquired = b.acquire(timeout=self.commit_timeout_s)
                tracer.add_span(
                    "reload.barrier_acquire", t_acq, time.perf_counter(),
                    trace_id=trace_id, replica=i, acquired=acquired,
                )
                if not acquired:
                    self.load_errors.append((
                        str(path),
                        f"commit aborted: replica {i} barrier not acquired "
                        f"in {self.commit_timeout_s}s (wedged dispatch?); "
                        "old step keeps serving fleet-wide",
                    ))
                    wedged_replica = i
                    return False
                held.append(b)
            with tracer.span(
                "reload.commit", trace_id=trace_id, step=step,
                replicas=len(staged),
            ):
                for reg, params in staged:
                    prev = reg.active()
                    fault_point("registry.swap")
                    reg.install(params, step)
                    installed.append((reg, prev))
                self._fleet_step = step
                self.swap_count += 1
                self.last_commit = {
                    "commit_round": self.swap_count,
                    "host_count": 1,
                    "step": step,
                }
                if self.model_id is not None:
                    self.last_commit["model_id"] = self.model_id
        except Exception as e:  # noqa: BLE001 — contain + untear
            # A failure mid-commit must not leave a torn swap: roll every
            # installed replica back (all locks are still held, so the
            # fleet never serves the torn state) and keep the old step.
            for reg, (prev_params, prev_step) in reversed(installed):
                reg.install(prev_params, prev_step)
            self.load_errors.append((
                str(path),
                f"commit aborted mid-swap and rolled back: {e!r}; old "
                "step keeps serving fleet-wide",
            ))
            return False
        finally:
            for b in reversed(held):
                b.release()
            for b in barriers:
                b.open()
            self.last_pause_ms = (time.perf_counter() - t_closed) * 1e3
            if wedged_replica is not None:
                # After the gates reopen: the flight-recorder write must
                # not extend the serving pause.
                tracer.incident(
                    "wedged_barrier_abort", trace_id=trace_id,
                    replica=wedged_replica, step=step, path=str(path),
                    commit_timeout_s=self.commit_timeout_s,
                )
        # Both parameter generations are referenced here: the
        # double-residency peak, sampled after the gates reopened.
        from marl_distributedformation_tpu_torch.analysis.guards import (
            sample_device_watermark,
        )

        sample_device_watermark(force=True)
        return True

    def _load_validated(self, path: Path) -> Dict[str, torch.Tensor]:
        """One restore + validation for the whole fleet against the served
        architecture, as ``ModelRegistry.refresh`` validates; the
        parameters as host tensors by ``state_dict`` name."""
        from marl_distributedformation_tpu_torch.compat.policy import (
            load_checkpoint_raw,
        )

        raw = load_checkpoint_raw(path)
        want = self._policy_name
        got = raw.get("policy", want)
        if got != want:
            raise ValueError(
                f"checkpoint {path} was trained with policy {got!r}; this "
                f"fleet serves {want!r}"
            )
        restored = restore_state_dict_partial(
            raw, {"params": self._template}, origin=str(path)
        )
        return params_from_jax(restored["params"], want)

    # -- elastic re-split (serving/elastic) -------------------------------

    def commit_resplit(
        self,
        add: Any = (),
        retire: Any = (),
        sharded_min_rows: Optional[int] = None,
        trace_id: Optional[str] = None,
    ) -> dict:
        """Land a capacity re-split (replicas added, replicas retired, the
        big-rung routing threshold re-pinned) at the SAME fleet batch
        barrier a reload commits at, so no in-flight request sees a torn
        replica set and ``model_step`` stays monotonic (added replicas
        must already serve the fleet's step: a prewarm the fleet stepped
        past is refused, and the controller retries).

        ``add`` replicas come prewarmed from the controller: engines
        built, every rung captured off the serving path, schedulers
        started but unrouted. ``retire`` names replica indices to take out
        of routing; the CALLER drains and stops them after the gates
        reopen (``router.drain_replica``), so draining never lengthens the
        pause. A sharded replica's parameters were placed on its slice
        when it was built, and every later swap places them there once,
        at this barrier, like every other replica's copy.

        Returns a report dict; never raises. ``committed`` False means the
        old split keeps serving and ``load_errors`` records why.
        ``pause_ms`` is the barrier pause alone, gates closed to gates
        reopened: the whole serving interruption a re-split costs."""
        if self.model_id is not None:
            raise ValueError(
                "elastic re-split over a lane-keyed coordinator is not "
                "supported yet (docs/serving.md 'Limits / next')"
            )
        add = list(add)
        retire_set = {int(i) for i in retire}
        tracer = get_tracer()
        report: dict = {
            "committed": False,
            "pause_ms": 0.0,
            "added": [r.index for r in add],
            "retired": sorted(retire_set),
        }
        with self._refresh_lock:
            current = list(self.router.replicas)
            missing = retire_set - {r.index for r in current}
            if missing:
                self.load_errors.append((
                    "resplit",
                    f"resplit refused: retire names unknown replicas "
                    f"{sorted(missing)}",
                ))
                return report
            stale = [r.index for r in add
                     if r.registry.active_step != self._fleet_step]
            if stale:
                # The fleet stepped forward while the controller was
                # prewarming: committing these replicas would serve an
                # older step after a newer one.
                self.load_errors.append((
                    "resplit",
                    f"resplit refused: prewarmed replicas {stale} serve a "
                    f"step != fleet step {self._fleet_step} (reload landed "
                    "during prewarm); re-prewarm and retry",
                ))
                report["stale_prewarm"] = True
                return report
            barriers = [r.registry.batch_lock for r in current]
            held: List[BatchBarrier] = []
            wedged_replica = None
            t_closed = time.perf_counter()
            try:
                for b in barriers:
                    b.close()
                t_closed = time.perf_counter()
                for i, b in enumerate(barriers):
                    fault_point("fleet.barrier")
                    if not b.acquire(timeout=self.commit_timeout_s):
                        self.load_errors.append((
                            "resplit",
                            f"resplit aborted: replica {i} barrier not "
                            f"acquired in {self.commit_timeout_s}s (wedged "
                            "dispatch?); old split keeps serving",
                        ))
                        wedged_replica = i
                        return report
                    held.append(b)
                with tracer.span("elastic.commit", trace_id=trace_id,
                                 added=len(add), retired=len(retire_set)):
                    fault_point("elastic.commit")
                    self.router._commit_resplit(
                        add, retire_set, sharded_min_rows=sharded_min_rows)
                    report["committed"] = True
                    report["step"] = self._fleet_step
            except Exception as e:  # noqa: BLE001 — contain, keep serving
                # The membership swap is one list assignment: a fault
                # before it (the armed elastic.commit seam) leaves the old
                # split whole; nothing to untear.
                self.load_errors.append((
                    "resplit",
                    f"resplit commit aborted: {e!r}; old split keeps "
                    "serving",
                ))
                report["error"] = repr(e)
                return report
            finally:
                for b in reversed(held):
                    b.release()
                for b in barriers:
                    b.open()
                report["pause_ms"] = round(
                    max(0.0, time.perf_counter() - t_closed) * 1e3, 3)
                if wedged_replica is not None:
                    tracer.incident(
                        "wedged_barrier_abort", trace_id=trace_id,
                        replica=wedged_replica, step=self._fleet_step,
                        path="resplit",
                        commit_timeout_s=self.commit_timeout_s,
                    )
        # The retiring and the incoming engines' parameters are both live
        # here, the double-residency peak a reload reaches too; sampled
        # after the gates reopened.
        from marl_distributedformation_tpu_torch.analysis.guards import (
            sample_device_watermark,
        )

        sample_device_watermark(force=True)
        return report

    # -- cross-host staged two-phase (serving/mesh) ----------------------
    #
    # The mesh coordinator generalizes the batch-barrier commit across
    # hosts: it cannot hold every host's locks itself, so each host splits
    # _load_and_commit at the commit point. ``prepare_global`` does
    # everything UP TO the flip (restore + validate once, stage a copy a
    # replica, close the gates, acquire every replica barrier) and HOLDS
    # that state, the host serving nothing, until the coordinator decides:
    # ``commit_prepared`` installs every staged cell (each engine copies it
    # into its captured parameter tensors at its next dispatch, so no rung
    # is captured again) and resumes, ``abort_prepared`` resumes on the old
    # step. Every host pauses before any host commits, so no old-step
    # response can complete after a new-step one anywhere in the mesh.
    # ``ttl_s`` bounds an orphaned prepare (the coordinator died
    # mid-round): the host aborts on its own and keeps serving the old step.

    def prepare_global(
        self,
        path: str | Path,
        step: Optional[int] = None,
        monotonic: bool = True,
        trace_id: Optional[str] = None,
        ttl_s: Optional[float] = 60.0,
    ) -> Tuple[bool, str]:
        """Phase 1 of the cross-host swap: stage + pause. Returns
        ``(staged, reason)``; on False the host is untouched and keeps
        serving. The refresh lock stays held across a successful prepare,
        so no local reload interleaves with the mesh round; commit or
        abort releases it."""
        path = Path(path)
        # Refuse FAST when the lock is busy instead of parking: a prepare
        # that blocks past the coordinator's RPC timeout becomes a zombie
        # whose late "staged" ack lands after its round aborted. A quick
        # typed refusal lets the coordinator abort-and-clear and retry.
        if not self._refresh_lock.acquire(timeout=0.25):
            with self._staged_lock:
                staleness = (
                    f" (round {self._staged['round_tag']} is staged "
                    "here awaiting commit/abort)"
                    if self._staged is not None
                    else ""
                )
            return False, f"another reload holds the refresh lock{staleness}"
        staged_ok = False
        try:
            with self._staged_lock:
                if self._staged is not None:
                    return False, (
                        f"round {self._staged['round_tag']} is already "
                        "staged on this host (commit or abort it first)"
                    )
            try:
                step = checkpoint_step(path) if step is None else int(step)
            except ValueError as e:
                self.load_errors.append((str(path), repr(e)))
                return False, f"unparseable checkpoint name: {e}"
            if monotonic and step <= self._fleet_step:
                return False, (
                    f"stale step {step} <= served {self._fleet_step}"
                )
            if step == self._fleet_step:
                return False, f"already serving step {step}"
            tracer = get_tracer()
            try:
                with tracer.span(
                    "reload.load", trace_id=trace_id, step=step,
                    path=str(path),
                ):
                    restored = self._load_validated(path)
                with tracer.span(
                    "reload.stage", trace_id=trace_id, step=step
                ):
                    staged = [
                        (reg, device_copy(restored, reg.device))
                        for reg in self._commit_registries()
                    ]
            except Exception as e:  # noqa: BLE001 — serving must not die
                self.load_errors.append((str(path), repr(e)))
                return False, f"load failed: {e!r}"
            barriers = [reg.batch_lock for reg, _ in staged]
            held: List[BatchBarrier] = []
            wedged_replica = None
            try:
                for b in barriers:
                    b.close()
                for i, b in enumerate(barriers):
                    fault_point("fleet.barrier")
                    t_acq = time.perf_counter()
                    acquired = b.acquire(timeout=self.commit_timeout_s)
                    tracer.add_span(
                        "reload.barrier_acquire", t_acq, time.perf_counter(),
                        trace_id=trace_id, replica=i, acquired=acquired,
                    )
                    if not acquired:
                        reason = (
                            f"prepare aborted: replica {i} barrier not "
                            f"acquired in {self.commit_timeout_s}s "
                            "(wedged dispatch?); old step keeps serving"
                        )
                        self.load_errors.append((str(path), reason))
                        wedged_replica = i
                        return False, reason
                    held.append(b)
            except BaseException as e:
                # An exception with the gates closed (an armed
                # fleet.barrier fault) must not leave the host paused
                # forever: the finally below reopens them.
                reason = f"prepare aborted mid-acquisition: {e!r}"
                self.load_errors.append((str(path), reason))
                if isinstance(e, Exception):
                    return False, reason
                raise  # SimulatedCrash-grade: die, but gates reopened
            finally:
                if len(held) != len(barriers):
                    for h in reversed(held):
                        h.release()
                    for b in barriers:
                        b.open()
                if wedged_replica is not None:
                    # After the gates reopened: the flight-recorder write
                    # must not extend the pause the wedge already caused.
                    tracer.incident(
                        "wedged_barrier_abort", trace_id=trace_id,
                        replica=wedged_replica, step=step, path=str(path),
                        commit_timeout_s=self.commit_timeout_s,
                    )
            entry = {
                "round_tag": f"step{step}",
                "path": path,
                "step": step,
                "staged": staged,
                "barriers": barriers,
                "held": held,
                "trace_id": trace_id,
                "timer": None,
                "t_closed": time.perf_counter(),
            }
            if ttl_s is not None:
                timer = threading.Timer(ttl_s, self._ttl_abort, args=(entry,))
                timer.daemon = True
                entry["timer"] = timer
            with self._staged_lock:
                self._staged = entry
            if entry["timer"] is not None:
                entry["timer"].start()
            staged_ok = True
            return True, f"staged step {step}"
        finally:
            if not staged_ok:
                self._refresh_lock.release()

    def _take_staged(self) -> Optional[dict]:
        with self._staged_lock:
            entry, self._staged = self._staged, None
        if entry is not None and entry["timer"] is not None:
            entry["timer"].cancel()
        return entry

    def _resume(self, entry: dict) -> None:
        """Release a staged round's barriers, reopen its gates and the
        refresh lock ``prepare_global`` kept."""
        for b in reversed(entry["held"]):
            b.release()
        for b in entry["barriers"]:
            b.open()
        self.last_pause_ms = (time.perf_counter() - entry["t_closed"]) * 1e3
        self._refresh_lock.release()

    def commit_prepared(self, trace_id: Optional[str] = None) -> bool:
        """Phase 2: install every staged replica cell and resume. Returns
        False when nothing is staged (an aborted or TTL-expired round: the
        coordinator treats that as this host having dropped out). The
        refresh lock ``prepare_global`` acquired is released here (or by
        abort)."""
        entry = self._take_staged()
        if entry is None:
            return False
        tracer = get_tracer()
        installed: List[Tuple[ReplicaRegistry, Tuple[Any, int]]] = []
        try:
            with tracer.span(
                "reload.commit", trace_id=trace_id or entry["trace_id"],
                step=entry["step"], replicas=len(entry["staged"]),
            ):
                for reg, params in entry["staged"]:
                    prev = reg.active()
                    fault_point("registry.swap")
                    reg.install(params, entry["step"])
                    installed.append((reg, prev))
                self._fleet_step = entry["step"]
                self.swap_count += 1
        except Exception as e:  # noqa: BLE001 — contain + untear
            for reg, (prev_params, prev_step) in reversed(installed):
                reg.install(prev_params, prev_step)
            self.load_errors.append((
                str(entry["path"]),
                f"staged commit aborted mid-swap and rolled back: {e!r}; "
                "old step keeps serving",
            ))
            return False
        finally:
            self._resume(entry)
        from marl_distributedformation_tpu_torch.analysis.guards import (
            sample_device_watermark,
        )

        sample_device_watermark(force=True)
        return True

    def abort_prepared(self, reason: str = "") -> bool:
        """Resume on the old step without installing anything (the round
        failed on another host, or the local TTL expired). Always safe to
        call; returns False when nothing was staged."""
        entry = self._take_staged()
        if entry is None:
            return False
        self._resume(entry)
        if reason:
            self.load_errors.append(
                (str(entry["path"]), f"prepare aborted: {reason}")
            )
        return True

    def _ttl_abort(self, entry: dict) -> None:
        """An orphaned prepare (no commit or abort before the TTL): the
        coordinator is presumed dead, so serving resumes on the OLD step.
        Fires only if this exact entry is still the staged one (a landing
        commit wins the race)."""
        with self._staged_lock:
            if self._staged is not entry:
                return
        self.abort_prepared(
            "prepare TTL expired with no commit/abort — coordinator "
            "presumed dead; serving resumed on the old step"
        )
        get_tracer().incident(
            "orphaned_prepare_abort", trace_id=entry["trace_id"],
            step=entry["step"], path=str(entry["path"]),
        )

    # -- background watcher ---------------------------------------------

    def start(self) -> "FleetReloadCoordinator":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="fleet-reload-coordinator", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.refresh()

    def __enter__(self) -> "FleetReloadCoordinator":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def fleet_from_checkpoint_dir(
    log_dir: str | Path,
    env_params: Any = None,
    act_dim: int = 2,
    poll_interval_s: float = 2.0,
    device: Any = None,
    **router_kwargs: Any,
):
    """A ``(FleetRouter, FleetReloadCoordinator)`` pair serving the newest
    checkpoint under ``log_dir``: the fleet twin of a ``ModelRegistry``
    built from a directory. ``device`` places the loaded policy (default
    ``cuda``; raises without a GPU unless ``"cpu"``); router kwargs
    (``buckets``, ``num_replicas``, ``devices``, ``window_ms``, ...) pass
    through, and ``devices`` defaults to the policy's device when
    ``device`` is given."""
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.serving.fleet.router import (
        FleetRouter,
    )

    log_dir = Path(log_dir)
    path = latest_checkpoint(log_dir)
    if path is None:
        raise FileNotFoundError(
            f"no rl_model_*_steps.msgpack checkpoint under {log_dir} to "
            "serve"
        )
    policy = LoadedPolicy.from_checkpoint(
        path, act_dim=act_dim, env_params=env_params, device=device
    )
    if device is not None and router_kwargs.get("devices") is None:
        router_kwargs["devices"] = [policy.device]
    router = FleetRouter(
        policy, initial_step=checkpoint_step(path), **router_kwargs
    )
    coordinator = FleetReloadCoordinator(
        log_dir, router, poll_interval_s=poll_interval_s
    )
    return router, coordinator
