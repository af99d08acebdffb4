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
and pursuit-evasion; the serving stack; the training observability plane;
and the reference's own user surface (the single-formation API, the SB3
VecEnv and Gymnasium adapters, SB3 import and the tools):

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
- ``serving``   — the micro-batching policy server; ``serve`` is its CLI
- ``obs``       — tracer, flight recorder, metrics registry, program ledger
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
"""

__version__ = "0.1.0"

from marl_distributedformation_tpu_torch.env import (  # noqa: F401
    EnvParams,
    FormationState,
    Transition,
    make_vec_env,
    reset,
    step,
)
