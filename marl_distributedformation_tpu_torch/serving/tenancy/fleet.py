"""TenantFleet: N named model lanes served by ONE fleet.

Counterpart of the JAX package's ``serving/tenancy/fleet.py``: the
multi-tenant serving plane, assembled from the lane-aware pieces under it
(nothing here builds a program):

- The :class:`~.directory.TenantDirectory` is grouped by arch signature.
  Each group gets ONE :class:`~..fleet.router.FleetRouter` in lanes mode:
  one ``BucketedPolicyEngine`` a replica serves EVERY lane of the group.
  The engine's rungs are CUDA graphs over its own parameter tensors, and a
  lane's snapshot is ``copy_``'d into them at dispatch when it is not the
  one loaded (JAX passes parameters as traced inputs instead), so adding a
  same-arch lane costs no capture: the census is one capture a (arch,
  rung, replica), however many lanes ride it. A lane of another
  architecture lands in its own group, with its own engines and budget-1
  receipts.
- Every lane with a ``promoted/`` directory gets its own lane-keyed
  :class:`~..fleet.reload.FleetReloadCoordinator`: N always-learning
  pipelines promote into one fleet, and a commit takes only ITS lane's
  batch barriers, so swapping lane A never pauses lane B, while lane A's
  own step stays monotonic in response completion order.
- Admission is per lane all the way down (the scheduler's
  ``_TenantAdmission``): lane A's batch storm fills lane A's queue and
  quotes lane A's Retry-After; lane B stays interactive.

The fleet speaks the router surface ``FleetFrontend`` uses (``submit``,
``snapshot``, ``lane_ids``, ``lane_steps``, ``healthy_replicas``,
``replicas``, ``default_timeout_s``), so the HTTP layer serves lanes
without knowing it.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.serving.engine import DEFAULT_BUCKETS
from marl_distributedformation_tpu_torch.serving.fleet.reload import (
    FleetReloadCoordinator,
)
from marl_distributedformation_tpu_torch.serving.fleet.router import (
    FleetRouter,
)
from marl_distributedformation_tpu_torch.serving.fleet.smoke import (
    warmup_fleet,
)
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
)
from marl_distributedformation_tpu_torch.serving.tenancy.directory import (
    TenantDirectory,
)


def _state_signature(params: Mapping[str, Any]) -> Tuple:
    """Names, shapes and dtypes of a ``state_dict``: what must match for
    two lanes to ride one engine's captured rungs."""
    return tuple(sorted(
        (name, tuple(leaf.shape), str(leaf.dtype))
        for name, leaf in params.items()
    ))


class TenantFleet:
    """Named model lanes over shared per-arch fleet routers.

    Args:
      directory: the declared lanes (``TenantDirectory``).
      policies: ``model_id`` -> ``LoadedPolicy`` seeding each lane. Every
        declared lane needs exactly one. Within an arch group every lane's
        ``state_dict`` must match the group's first one (names, shapes,
        dtypes), checked here: a mismatch would otherwise surface inside a
        rung at the first dispatch.
      steps: optional ``model_id`` -> initial checkpoint step (default 0;
        ``tenant_fleet_from_directory`` passes each lane's real step).
      devices / num_replicas / buckets / window_ms / max_queue /
      default_timeout_s / seed / max_failovers / probe_interval_s:
        passed to every arch group's ``FleetRouter``.
      tenant_max_queue: per-lane admission bound (default ``max_queue``).
      poll_interval_s / commit_timeout_s: passed to every lane's reload
        coordinator.
      watch: ``start()`` also starts each lane coordinator's background
        watcher (tests drive ``refresh()`` by hand instead).
    """

    def __init__(
        self,
        directory: TenantDirectory,
        policies: Mapping[str, Any],
        steps: Optional[Mapping[str, int]] = None,
        devices: Optional[Sequence[Any]] = None,
        num_replicas: Optional[int] = None,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        window_ms: float = 2.0,
        max_queue: int = 256,
        tenant_max_queue: Optional[int] = None,
        default_timeout_s: float = 10.0,
        seed: int = 0,
        max_failovers: int = 1,
        probe_interval_s: float = 1.0,
        poll_interval_s: float = 2.0,
        commit_timeout_s: float = 30.0,
        watch: bool = False,
    ) -> None:
        if len(directory) == 0:
            raise ValueError("TenantFleet needs at least one declared lane")
        missing = [mid for mid in directory if mid not in policies]
        if missing:
            raise ValueError(
                f"no seed policy for declared lanes: {missing}"
            )
        extra = [mid for mid in policies if mid not in directory]
        if extra:
            raise ValueError(
                f"policies for undeclared lanes: {extra} "
                f"(declared: {sorted(directory)})"
            )
        self.directory = directory
        self.default_timeout_s = default_timeout_s
        self.lane_ids: Tuple[str, ...] = tuple(directory)
        self.watch = watch
        steps = dict(steps or {})
        # One router an arch group; the group's lanes share its engines.
        self.routers: Dict[str, FleetRouter] = {}
        self._router_for: Dict[str, FleetRouter] = {}
        for arch, specs in directory.arch_groups().items():
            rep = policies[specs[0].model_id]
            rep_sig = _state_signature(rep.params)
            for spec in specs[1:]:
                sig = _state_signature(policies[spec.model_id].params)
                if sig != rep_sig:
                    raise ValueError(
                        f"lane {spec.model_id!r} declares arch {arch} "
                        f"(same as {specs[0].model_id!r}) but its param "
                        "tree differs in structure/shape/dtype — it "
                        "cannot share the group's compiled rungs"
                    )
            lanes = {
                spec.model_id: (
                    policies[spec.model_id].params,
                    int(steps.get(spec.model_id, 0)),
                )
                for spec in specs
            }
            router = FleetRouter(
                rep,
                devices=devices,
                num_replicas=num_replicas,
                buckets=buckets,
                window_ms=window_ms,
                max_queue=max_queue,
                tenant_max_queue=tenant_max_queue,
                default_timeout_s=default_timeout_s,
                seed=seed,
                max_failovers=max_failovers,
                probe_interval_s=probe_interval_s,
                lanes=lanes,
            )
            self.routers[arch] = router
            for spec in specs:
                self._router_for[spec.model_id] = router
        # One lane-keyed coordinator a promoting lane: its commit takes
        # only that lane's barriers in that lane's arch router.
        self.coordinators: Dict[str, FleetReloadCoordinator] = {
            spec.model_id: FleetReloadCoordinator(
                spec.promoted_dir,
                self._router_for[spec.model_id],
                poll_interval_s=poll_interval_s,
                commit_timeout_s=commit_timeout_s,
                model_id=spec.model_id,
            )
            for spec in directory.lanes()
            if spec.promoted_dir is not None
        }
        self._count_lock = threading.Lock()
        self._lane_requests: Dict[str, int] = {  # guarded by _count_lock
            mid: 0 for mid in self.lane_ids
        }
        self._lane_rejected: Dict[str, int] = {  # guarded by _count_lock
            mid: 0 for mid in self.lane_ids
        }

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "TenantFleet":
        for router in self.routers.values():
            router.start()
        if self.watch:
            for coord in self.coordinators.values():
                coord.start()
        return self

    def stop(self) -> None:
        for coord in self.coordinators.values():
            coord.stop()
        for router in self.routers.values():
            router.stop()

    def __enter__(self) -> "TenantFleet":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- client side -----------------------------------------------------

    def router_for(self, model_id: str) -> FleetRouter:
        """The arch-group router serving ``model_id`` (a did-you-mean on
        unknown lanes, as ``ValueError``: the frontend's 400 class)."""
        try:
            self.directory.get(model_id)
        except KeyError as e:
            raise ValueError(str(e)) from None
        return self._router_for[model_id]

    def submit(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        on_result: Optional[Any] = None,
        trace_id: Optional[str] = None,
        slo_class: Optional[str] = None,
        model_id: Optional[str] = None,
    ) -> Any:
        """Route one request down its lane. ``model_id`` is required;
        ``slo_class=None`` is the lane's declared class. Backpressure is
        per lane: a rejection carries the LANE's Retry-After, and only
        that lane's counter moves."""
        if model_id is None:
            raise ValueError(
                "model_id is required on a tenant fleet; declared "
                f"lanes: {sorted(self.lane_ids)}"
            )
        router = self.router_for(model_id)
        spec = self.directory.get(model_id)
        with self._count_lock:
            self._lane_requests[model_id] += 1
        try:
            return router.submit(
                obs,
                deterministic=deterministic,
                timeout_s=timeout_s,
                on_result=on_result,
                trace_id=trace_id,
                slo_class=spec.slo_class if slo_class is None else slo_class,
                model_id=model_id,
            )
        except BackpressureError:
            with self._count_lock:
                self._lane_rejected[model_id] += 1
            raise

    # -- observability ---------------------------------------------------

    @property
    def replicas(self) -> List[Any]:
        return [r for router in self.routers.values() for r in router.replicas]

    @property
    def healthy_replicas(self) -> int:
        return sum(
            router.healthy_replicas for router in self.routers.values()
        )

    def lane_steps(self) -> Dict[str, int]:
        """Each lane's served step across every arch group, each lane
        monotonic on its own."""
        steps: Dict[str, int] = {}
        for router in self.routers.values():
            steps.update(router.lane_steps())
        return steps

    def snapshot(self) -> Dict[str, float]:
        """One flat dict over every arch group: ``model_{id}__*`` keys pass
        through (lane names are unique), ``*_total`` counters and the
        fleet widths SUM, and the rest (latency percentiles, per-replica
        gauges, rung receipts) take the MAX, the worst case where groups
        share a key (replica indices restart a group). Adds the fleet's
        per-lane request and reject counters, which ``obs/export.py``
        folds into ``model``-labelled families."""
        snap: Dict[str, float] = {}
        summed = (
            "fleet_replicas",
            "fleet_healthy_replicas",
            "fleet_estimated_drain_s",
        )
        for router in self.routers.values():
            for key, value in router.snapshot().items():
                if key.startswith("model_") and "__" in key:
                    snap[key] = value
                elif key.endswith("_total") or key in summed:
                    snap[key] = snap.get(key, 0.0) + value
                elif key not in snap or value > snap[key]:
                    snap[key] = value
        steps = self.lane_steps()
        snap["model_step"] = float(max(steps.values()))
        with self._count_lock:
            for mid in self.lane_ids:
                snap[f"model_{mid}__requests_total"] = float(
                    self._lane_requests[mid]
                )
                snap[f"model_{mid}__rejected_total"] = float(
                    self._lane_rejected[mid]
                )
        return snap

    def compile_counts(self) -> Dict[str, Dict[int, Dict[int, int]]]:
        """Builds an arch group, a replica, a rung."""
        return {
            arch: router.compile_counts()
            for arch, router in self.routers.items()
        }

    def shared_rung_compiles(self) -> Dict[str, int]:
        """The sharing receipt: ``{"{arch}:rung{b}": count}``, the most
        builds any replica of the group paid for that rung. Every value
        must be <= 1: N same-arch lanes share one build a (arch, rung),
        and each distinct arch pays its own."""
        out: Dict[str, int] = {}
        for arch, router in self.routers.items():
            for counts in router.compile_counts().values():
                for bucket, count in counts.items():
                    key = f"{arch}:rung{bucket}"
                    out[key] = max(out.get(key, 0), int(count))
        return out

    def warmup(self) -> None:
        """Build every rung of every arch group once, before traffic: one
        warm-up a GROUP, not a lane (the proof of sharing is that no
        lane's traffic adds a build afterwards)."""
        for arch, specs in self.directory.arch_groups().items():
            warmup_fleet(self.routers[arch], specs[0].row_shape)


def tenant_fleet_from_directory(
    directory: TenantDirectory,
    poll_interval_s: float = 2.0,
    device: Any = None,
    **fleet_kwargs: Any,
) -> TenantFleet:
    """A :class:`TenantFleet` serving each lane's newest promoted
    checkpoint: the multi-tenant twin of ``fleet_from_checkpoint_dir``.
    Every lane must declare a ``promoted_dir`` holding at least one
    checkpoint (its coordinator then watches that directory). ``device``
    places the loaded policies (default ``cuda``; raises without a GPU
    unless ``"cpu"``), and ``devices`` defaults to it when given."""
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
        latest_checkpoint,
    )

    policies: Dict[str, Any] = {}
    steps: Dict[str, int] = {}
    for spec in directory.lanes():
        if spec.promoted_dir is None:
            raise ValueError(
                f"lane {spec.model_id!r} declares no promoted_dir; "
                "tenant_fleet_from_directory seeds every lane from its "
                "newest promoted checkpoint"
            )
        path = latest_checkpoint(Path(spec.promoted_dir))
        if path is None:
            raise FileNotFoundError(
                f"lane {spec.model_id!r}: no rl_model_*_steps.msgpack "
                f"checkpoint under {spec.promoted_dir} to serve"
            )
        policies[spec.model_id] = LoadedPolicy.from_checkpoint(
            path, act_dim=spec.act_dim, env_params=spec.env_params(),
            device=device,
        )
        steps[spec.model_id] = checkpoint_step(path)
    if device is not None and fleet_kwargs.get("devices") is None:
        fleet_kwargs["devices"] = [next(iter(policies.values())).device]
    return TenantFleet(
        directory,
        policies,
        steps=steps,
        poll_interval_s=poll_interval_s,
        **fleet_kwargs,
    )
