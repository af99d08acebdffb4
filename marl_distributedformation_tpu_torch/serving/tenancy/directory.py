"""TenantDirectory: the declared set of named model lanes.

Counterpart of the JAX package's ``serving/tenancy/directory.py``. One
fleet, many models. A :class:`TenantSpec` names a lane: which environment
its policies act in, which architecture they are, what SLO class its
traffic defaults to, and which ``promoted/`` directory its always-learning
pipeline publishes into. The :class:`TenantDirectory` is the fail-fast
registry over those lanes (the did-you-mean discipline of
``envs.get_env``) and the ARCH GROUPING the fleet builds from: lanes whose
signature matches share one engine a replica and its captured rungs (a
lane's parameters are copied into the rungs' tensors at dispatch), while
distinct architectures get engines and budget-1 build receipts of their
own.

The signature is JAX's ``(policy, hidden, obs_dim, act_dim)``. A
per-formation policy (CTDE, GNN) serves whole formations, so its request
row is ``(num_agents, obs_dim)`` and the agent count joins the signature;
a GNN's captured forward also holds its ``knn_k``, which joins it too.
``env_overrides`` sets env params beyond ``num_agents`` (a GNN lane's
``obs_mode=knn`` and ``knn_k``, which the JAX spec has no field for).

Lane names become Prometheus label values and ``model_{id}__{metric}``
snapshot keys (``obs/export.py`` folds on the FIRST double underscore), so
``model_id`` is restricted to ``[A-Za-z0-9_.-]`` without a ``__`` run.
"""

from __future__ import annotations

import dataclasses
import difflib
import re
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from marl_distributedformation_tpu_torch.serving.scheduler import SLO_CLASSES

_MODEL_ID_OK = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One named model lane.

    Args:
      model_id: the lane's name: it rides requests, responses, promotion
        log lines (schema 5) and the ``model`` Prometheus label.
      env: environment the lane's policies act in (``envs`` registry
        name); decides the observation row shape and so the arch group.
      policy: policy class name (``compat.policy.POLICY_REGISTRY``).
      hidden: the policy tower's widths (part of the arch signature).
      slo_class: default admission class of this lane's traffic when a
        request does not say ("interactive" or "batch").
      promoted_dir: the lane's always-learning ``promoted/`` directory,
        which its lane-keyed reload coordinator watches; None is a static
        lane (seeded once, never hot-swapped).
      num_agents: optional env override (changes the row shape).
      act_dim: action dimensionality.
      max_queue: optional per-lane admission bound (default the fleet's
        ``tenant_max_queue``).
      env_overrides: further env params by name (a mapping or pairs), e.g.
        ``{"obs_mode": "knn", "knn_k": 4}`` for a GNN lane.
    """

    model_id: str
    env: str = "formation"
    policy: str = "MLPActorCritic"
    hidden: Tuple[int, ...] = (64, 64)
    slo_class: str = "interactive"
    promoted_dir: Optional[Path] = None
    num_agents: Optional[int] = None
    act_dim: int = 2
    max_queue: Optional[int] = None
    env_overrides: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if not _MODEL_ID_OK.match(self.model_id) or "__" in self.model_id:
            raise ValueError(
                f"bad model_id {self.model_id!r}: must match "
                f"{_MODEL_ID_OK.pattern} with no '__' (it becomes a "
                "metric label and a model_{id}__{metric} snapshot key)"
            )
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"lane {self.model_id!r}: unknown slo_class "
                f"{self.slo_class!r}; known: {SLO_CLASSES}"
            )
        from marl_distributedformation_tpu_torch.compat.policy import (
            POLICY_REGISTRY,
        )

        if self.policy not in POLICY_REGISTRY:
            raise ValueError(
                f"lane {self.model_id!r}: unknown policy {self.policy!r}; "
                f"known: {sorted(POLICY_REGISTRY)}"
            )
        object.__setattr__(self, "hidden", tuple(self.hidden))
        overrides = self.env_overrides
        if isinstance(overrides, dict):
            overrides = overrides.items()
        object.__setattr__(self, "env_overrides",
                           tuple(sorted((str(k), v) for k, v in overrides)))
        if self.promoted_dir is not None:
            object.__setattr__(
                self, "promoted_dir", Path(self.promoted_dir)
            )
        # A misspelled env name fails at DECLARATION time (the registry's
        # did-you-mean), not at the first request.
        self.env_params()

    def env_params(self) -> Any:
        """The lane's environment params (the env registry's defaults with
        this lane's overrides): what the fleet builder hands to
        ``LoadedPolicy.from_checkpoint``."""
        from marl_distributedformation_tpu_torch import envs

        overrides = dict(self.env_overrides)
        if self.num_agents is not None:
            overrides["num_agents"] = self.num_agents
        return envs.get_env(self.env).default_params(**overrides)

    @property
    def obs_dim(self) -> int:
        return int(self.env_params().obs_dim)

    @property
    def per_formation(self) -> bool:
        from marl_distributedformation_tpu_torch.compat.policy import (
            POLICY_REGISTRY,
        )

        return bool(POLICY_REGISTRY[self.policy].per_formation)

    @property
    def row_shape(self) -> Tuple[int, ...]:
        """One request row: ``(obs_dim,)``, or a whole formation's
        ``(num_agents, obs_dim)`` for a per-formation policy."""
        params = self.env_params()
        if self.per_formation:
            return (int(params.num_agents), int(params.obs_dim))
        return (int(params.obs_dim),)

    def arch_key(self) -> str:
        """The rung-sharing signature: lanes with equal keys serve through
        ONE engine a replica (shared captured rungs); distinct keys get
        engines and budget-1 receipts of their own."""
        widths = "x".join(str(w) for w in self.hidden)
        key = (f"{self.policy}_h{widths}_obs{self.obs_dim}"
               f"_act{self.act_dim}")
        if self.per_formation:
            key += f"_n{self.row_shape[0]}"
        if self.policy == "GNNActorCritic":
            params = self.env_params()
            key += f"_k{params.knn_k}"
            if params.goal_in_obs:
                key += "_goal"
        return key


class TenantDirectory:
    """Ordered, fail-fast registry of :class:`TenantSpec` lanes."""

    def __init__(self, specs: Iterable[TenantSpec] = ()) -> None:
        self._lanes: Dict[str, TenantSpec] = {}
        for spec in specs:
            self.add(spec)

    def add(self, spec: TenantSpec) -> TenantSpec:
        if spec.model_id in self._lanes:
            raise ValueError(
                f"duplicate model_id {spec.model_id!r} in directory"
            )
        self._lanes[spec.model_id] = spec
        return spec

    def get(self, model_id: str) -> TenantSpec:
        """Fail-fast lookup with a did-you-mean hint (the contract of
        ``envs.get_env``)."""
        try:
            return self._lanes[model_id]
        except KeyError:
            close = difflib.get_close_matches(
                str(model_id), list(self._lanes), n=1
            )
            hint = f" (did you mean {close[0]!r}?)" if close else ""
            raise KeyError(
                f"unknown model_id {model_id!r}{hint}; declared lanes: "
                f"{sorted(self._lanes)}"
            ) from None

    def lanes(self) -> Tuple[TenantSpec, ...]:
        return tuple(self._lanes.values())

    def arch_groups(self) -> Dict[str, List[TenantSpec]]:
        """Lanes grouped by signature, declaration order kept within each
        group."""
        groups: Dict[str, List[TenantSpec]] = {}
        for spec in self._lanes.values():
            groups.setdefault(spec.arch_key(), []).append(spec)
        return groups

    def __contains__(self, model_id: object) -> bool:
        return model_id in self._lanes

    def __iter__(self) -> Iterator[str]:
        return iter(self._lanes)

    def __len__(self) -> int:
        return len(self._lanes)
