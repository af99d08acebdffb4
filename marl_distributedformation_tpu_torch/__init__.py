"""PyTorch and CUDA port of the formation-control framework, for one NVIDIA H100.

The JAX package ``marl_distributedformation_tpu`` beside this one is the
reference: every module here is held against its counterpart there by the
``tests/test_torch_*.py`` tests. This package imports ``torch`` and never
JAX, flax or anything of the JAX package; where it needs a piece of that
package (``EnvParams``, the checkpoint codec, the config parser) it keeps its
own copy.

The slices ported so far: policy evaluation on the k-NN swarm; PPO training
(single runs, populations, CTDE and the curriculum over padded formations,
captured as CUDA graphs, the Anakin and Sebulba lanes); the env-spec layer
and the disturbance scenarios; the robustness matrix, the falsifier search
and pursuit-evasion; the serving stack, its fleet and tenant lanes; the
training observability plane; the reference's own user surface (the
single-formation API, the SB3 VecEnv and Gymnasium adapters, SB3 import and
the tools); and the always-learning pipeline:

- ``env``       — the formation environment, batched over ``(M, N, 2)``
                  and one formation at a time (``reset``, ``step``)
- ``envs``      — the env contract (``EnvSpec``, declared obs layouts) and
                  its fail-fast registry; pursuit-evasion
- ``scenarios`` — disturbance layers around the env step, their registry,
                  engine, training schedules, matrix and falsifier search
- ``ops``       — k-nearest-neighbor search: plain PyTorch versions and two
                  CUDA C++ kernels for Hopper (``csrc/knn.cu``)
- ``models``    — MLP, CTDE and GNN actor-critics as ``nn.Module``s
- ``algo``      — rollout, GAE, the PPO loss and update, optax's clipped Adam
- ``train``     — the trainers; ``python -m ...train`` is their CLI
- ``serving``   — the micro-batching policy server, its fleet and tenant
                  lanes; ``serve`` is its CLI
- ``pipeline``  — train -> gate -> promote -> fleet -> rollback in one
                  process; ``always_learning`` is its CLI
- ``chaos``     — fault seams, invariant checkers, the lane watchdog
- ``obs``       — tracer, flight recorder, metrics registry, program
                  ledger, regression sentinel
- ``analysis``  — the build and runtime guards, and graftlint: the static
                  linter of captured scopes (``python -m ...analysis``)
- ``compat``    — ``FormationVecEnv`` (the reference's SB3 VecEnv contract),
                  the Gymnasium adapters, the renderer, SB3 checkpoint
                  import and export, ``LoadedPolicy``, and parameters to and
                  from the JAX package's trees
- ``utils``     — checkpoints, metrics logging, the config parser, profiling
- ``eval``      — full-episode evaluation; ``evaluate`` is its CLI
- tools         — ``python -m marl_distributedformation_tpu_torch.simulate``,
                  ``visualize_policy``, ``keyboard_move``, ``vectorized_env``
- ``examples``  — ``functional_env.py`` and ``custom_policy.py``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``); with no GPU they raise. Nothing here imports
``gymnasium`` or ``matplotlib`` unless a Gymnasium adapter, the renderer or
a tool's display path is used.

The env's names below load on first use, so that importing a subpackage
that needs no torch (``analysis``, the linter's CLI) imports none.
"""

__version__ = "0.1.0"

_ENV_EXPORTS = ("EnvParams", "FormationState", "Transition", "make_vec_env",
                "reset", "step")


def __getattr__(name):
    if name in _ENV_EXPORTS:
        from marl_distributedformation_tpu_torch import env

        return getattr(env, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted({*globals(), *_ENV_EXPORTS})
