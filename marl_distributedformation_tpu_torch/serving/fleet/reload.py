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

The elastic re-split (``commit_resplit``) and the cross-host two-phase
commit (``prepare_global`` / ``commit_prepared`` / ``abort_prepared``)
are not ported: they raise naming their ROADMAP items.
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
    side stream that is synchronized."""
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

    # -- not ported ------------------------------------------------------

    def commit_resplit(self, *args: Any, **kwargs: Any) -> dict:
        """The elastic re-split: not ported (ROADMAP A13, serving/elastic;
        it re-splits devices, A12)."""
        raise NotImplementedError(
            "commit_resplit (elastic capacity) is not ported yet (ROADMAP "
            "A13: serving/elastic, with A12)"
        )

    def prepare_global(self, *args: Any, **kwargs: Any) -> Tuple[bool, str]:
        """The cross-host two-phase commit: not ported (ROADMAP A13,
        serving/mesh)."""
        raise NotImplementedError(
            "prepare_global (the cross-host mesh commit) is not ported yet "
            "(ROADMAP A13: serving/mesh)"
        )

    commit_prepared = prepare_global
    abort_prepared = prepare_global

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
