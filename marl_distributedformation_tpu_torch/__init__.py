"""PyTorch and CUDA port of the formation-control framework, for one NVIDIA H100.

The JAX package ``marl_distributedformation_tpu`` beside this one is the
reference: every module here is held against its counterpart there by the
``tests/test_torch_*.py`` tests. This package imports ``torch`` and never
JAX, flax or anything of the JAX package; where it needs a piece of that
package (``EnvParams``, the checkpoint codec, the config parser) it keeps its
own copy.

The slices ported so far: policy evaluation on the k-NN swarm, PPO
training (single runs, populations, CTDE and the curriculum over padded
formations, captured as CUDA graphs), and the env-spec layer with the
disturbance scenarios:

- ``env``     — the formation environment, batched over ``(M, N, 2)``
- ``envs``    — the env contract (``EnvSpec``, declared obs layouts) and
                its fail-fast registry
- ``scenarios`` — disturbance layers around the env step, their registry,
                engine and training schedules
- ``ops``     — k-nearest-neighbor search: a plain PyTorch version and two
                CUDA C++ kernels for Hopper (``csrc/knn.cu``)
- ``models``  — MLP and GNN actor-critics as ``nn.Module``s
- ``algo``    — rollout, GAE, the PPO loss and update, optax's clipped Adam
- ``train``   — the trainer; ``python -m ...train`` is its CLI
- ``compat``  — parameters and Adam state to and from the JAX package's
                trees, ``LoadedPolicy``
- ``utils``   — checkpoints, metrics logging and the config parser
- ``eval``    — full-episode evaluation; ``evaluate`` is its CLI

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``); with no GPU they raise.
"""

__version__ = "0.1.0"
