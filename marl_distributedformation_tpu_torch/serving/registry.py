"""Checkpoint watcher + atomic hot swap: the model side of serving.

Counterpart of the JAX package's ``serving/registry.py``. The trainer drops
``rl_model_{steps}_steps.msgpack`` files into ``logs/{name}/`` atomically
(a dot-prefixed temp file renamed into place, so discovery never observes a
torn checkpoint). The registry polls that directory with
``latest_checkpoint`` and, when a newer step appears, restores it against
the served architecture and swaps the active parameters under a lock.

Swap semantics (the hot-reload contract):

- **Atomic between batches** — the scheduler snapshots ``(params, step)``
  once per micro-batch via :meth:`active`; a swap lands between snapshots,
  so every request in a batch is answered by exactly one model version.
- **Uploaded once** — a restored snapshot is copied to the device once, at
  swap time, on the registry's own stream, and synchronized before it is
  published; the engine's copy into its captured parameter tensors at the
  batch barrier is then device to device.
- **Same architecture only** — the restore is validated leaf by leaf in
  the checkpoint's layout (``restore_state_dict_partial``): another
  architecture, or the same shapes at a drifted dtype, is a recorded
  error, never a swap. The engine's rungs read fixed tensors, which the
  validation holds fixed: a swap never rebuilds a rung.
- **Never go backward, never go down** — older/equal steps are ignored,
  and any load failure keeps the previous params serving (the error is
  appended to :attr:`load_errors`).
"""

from __future__ import annotations

import threading
from collections import deque
from pathlib import Path
from typing import Any, Deque, Dict, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.compat.convert import (
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.compat.policy import (
    LoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu_torch.device import DeviceLike
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_step,
    latest_checkpoint,
    restore_state_dict_partial,
)


class ModelRegistry:
    """Serve-side view of one checkpoint directory.

    Args:
      log_dir: the ``logs/{name}/`` directory the trainer checkpoints to.
      policy: optionally a pre-built ``LoadedPolicy``; by default the newest
        checkpoint in ``log_dir`` is loaded (``env_params`` / ``act_dim`` /
        ``device`` forwarded to ``LoadedPolicy.from_checkpoint``; a GNN
        needs ``env_params`` for its k).
      poll_interval_s: cadence of the background watcher thread
        (``start()``); ``refresh()`` may also be called directly.
      model_id: optional tenant-lane name, an identity stamp only.
    """

    def __init__(
        self,
        log_dir: str | Path,
        policy: Optional[LoadedPolicy] = None,
        env_params: Any = None,
        act_dim: int = 2,
        poll_interval_s: float = 2.0,
        max_recorded_errors: int = 32,
        model_id: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        self.log_dir = Path(log_dir)
        self.model_id = model_id
        if policy is None:
            path = latest_checkpoint(self.log_dir)
            if path is None:
                raise FileNotFoundError(
                    f"no rl_model_*_steps.msgpack checkpoint under "
                    f"{self.log_dir} to serve"
                )
            policy = LoadedPolicy.from_checkpoint(
                path, act_dim=act_dim, env_params=env_params, device=device
            )
            step = checkpoint_step(path)
        else:
            # A pre-built policy's provenance is unknown — report step 0
            # so the first refresh() upgrades to whatever newest checkpoint
            # the directory holds.
            step = 0
        self.policy = policy
        self.device = policy.device
        self._policy_name = type(policy.model).__name__
        # The restore template: the served architecture in the
        # checkpoint's layout, ``{"params": ...}`` of float32 leaves.
        self._template = params_to_jax(policy.params, self._policy_name)
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        self.poll_interval_s = poll_interval_s
        self.swap_count = 0  # guarded by _lock
        self.load_errors: Deque[Tuple[str, str]] = deque(
            maxlen=max_recorded_errors
        )
        self._lock = threading.Lock()
        self._params: Dict[str, torch.Tensor] = policy.params  # _lock
        self._step = step  # guarded by _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- serving snapshot -----------------------------------------------

    def active(self) -> Tuple[Dict[str, torch.Tensor], int]:
        """The ``(params, step)`` snapshot a micro-batch dispatches with."""
        with self._lock:
            return self._params, self._step

    @property
    def active_step(self) -> int:
        """Checkpoint step of the params currently serving (every
        ``ServedResult`` carries the step it was computed with)."""
        with self._lock:
            return self._step

    # -- reload ---------------------------------------------------------

    def _upload(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``state`` on the registry's device, the copies finished."""
        if self._upload_stream is None:
            return {k: v.to(self.device) for k, v in state.items()}
        with torch.cuda.stream(self._upload_stream):
            out = {k: v.to(self.device, non_blocking=True)
                   for k, v in state.items()}
        self._upload_stream.synchronize()
        return out

    def refresh(self) -> bool:
        """Check the directory once; swap if a newer checkpoint landed.
        Returns True on swap. Load failures (architecture mismatches,
        foreign or corrupt files) keep the old params serving and are
        recorded in ``load_errors``."""
        path = latest_checkpoint(self.log_dir)
        if path is None:
            return False
        step = checkpoint_step(path)
        if step <= self.active_step:
            return False
        try:
            raw = load_checkpoint_raw(path)
            want = self._policy_name
            got = raw.get("policy", want)
            if got != want:
                raise ValueError(
                    f"checkpoint {path} was trained with policy {got!r}; "
                    f"this registry serves {want!r}"
                )
            restored = restore_state_dict_partial(
                raw, {"params": self._template}, origin=str(path)
            )
            params = self._upload(
                params_from_jax(restored["params"], self._policy_name)
            )
        except Exception as e:  # noqa: BLE001 — serving must not die
            self.load_errors.append((str(path), repr(e)))
            return False
        with self._lock:
            if step <= self._step:
                # A concurrent refresh (watcher thread vs. a manual call)
                # finished a newer load meanwhile — never swap backward.
                return False
            self._params = params
            self._step = step
            self.swap_count += 1
        return True

    # -- background watcher ---------------------------------------------

    def start(self) -> "ModelRegistry":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="model-registry-watch", daemon=True
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

    def __enter__(self) -> "ModelRegistry":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
