"""EnvSpec registry: named environments and dispatch on the params type.

Counterpart of the JAX package's ``envs/registry.py``. Every lookup fails
fast on an unknown name with a did-you-mean and the registry's listing, so
a typo never trains or evaluates the default environment.
``spec_for_params(params)`` resolves the spec from the type of the params
that downstream code already holds (eval, the scenario engine).
"""

from __future__ import annotations

import difflib
from typing import Dict, Tuple

from marl_distributedformation_tpu_torch.envs.spec import EnvSpec

_REGISTRY: Dict[str, EnvSpec] = {}
_BY_PARAMS_CLS: Dict[type, EnvSpec] = {}


def registered_envs() -> Tuple[str, ...]:
    """Registered environment names, registration order."""
    return tuple(_REGISTRY)


def register_env(spec: EnvSpec, overwrite: bool = False) -> None:
    """Add an environment. Overwriting a name is opt-in, and each env
    brings its own ``params_cls``, so that ``spec_for_params`` stays
    unambiguous."""
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"environment {spec.name!r} is already registered; pass "
            "overwrite=True to replace it"
        )
    claimed = _BY_PARAMS_CLS.get(spec.params_cls)
    if claimed is not None and claimed.name != spec.name and not overwrite:
        raise ValueError(
            f"params class {spec.params_cls.__name__!r} is already claimed "
            f"by environment {claimed.name!r}; give {spec.name!r} its own "
            "params subclass so spec_for_params stays unambiguous"
        )
    if overwrite and spec.name in _REGISTRY:
        # A replacement with a new params type leaves no stale claim.
        _BY_PARAMS_CLS.pop(_REGISTRY[spec.name].params_cls, None)
    _REGISTRY[spec.name] = spec
    _BY_PARAMS_CLS[spec.params_cls] = spec


def get_env(name: str) -> EnvSpec:
    """The named spec; an unknown name raises with a did-you-mean and the
    registered names."""
    spec = _REGISTRY.get(name)
    if spec is None:
        close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
        hint = f" (did you mean {close[0]!r}?)" if close else ""
        raise ValueError(
            f"unknown environment {name!r}{hint}; registered environments: "
            f"{', '.join(registered_envs())}"
        )
    return spec


def spec_for_params(params) -> EnvSpec:
    """The spec of a params instance's most-derived registered type; an
    unregistered type raises naming the registered (env, params-class)
    pairs."""
    for cls in type(params).__mro__:
        spec = _BY_PARAMS_CLS.get(cls)
        if spec is not None:
            return spec
    pairs = ", ".join(
        f"{s.name} ({s.params_cls.__name__})" for s in _REGISTRY.values()
    )
    raise ValueError(
        f"no registered environment for params type "
        f"{type(params).__name__!r}; registered: {pairs} — register the "
        "env with envs.register_env (docs/environments.md)"
    )
