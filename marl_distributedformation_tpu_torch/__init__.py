"""PyTorch and CUDA port of the formation-control framework, for one NVIDIA H100.

The JAX package ``marl_distributedformation_tpu`` beside this one is the
reference: every module here is held against its counterpart there by the
``tests/test_torch_*.py`` tests. This package imports ``torch`` and never
JAX, flax or anything of the JAX package; where it needs a piece of that
package (``EnvParams``, the checkpoint codec, the config parser) it keeps its
own copy.

The slices ported so far are policy evaluation on the k-NN swarm and
single-run PPO training:

- ``env``     — the formation environment, batched over ``(M, N, 2)``
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
