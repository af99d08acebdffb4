"""Promoter + PromotionLog: publication and the audit trail.

Counterpart of the JAX package's ``pipeline/promote.py``; the log's bytes
are the same, so either package reads the other's.

The fleet's reload coordinator must only ever see VETTED checkpoints —
pointing it at the trainer's own directory would serve candidates the
gate has not judged yet. The Promoter therefore owns a separate
``promoted/`` directory: passing checkpoints are published into it with
the same atomic-rename discipline the trainer uses (hardlink or copy to
a dot-prefixed temp name, then ``os.replace``), the original
``rl_model_{steps}_steps`` naming preserved so every discovery/step
contract keeps working, and the coordinator watches ONLY this
directory. ``retract_above`` is the rollback half: demoted checkpoints
are removed so the coordinator's next poll cannot re-promote them.

``PromotionLog`` is the versioned ``promotions.jsonl`` verdict log: one
JSON object per line, schema-stamped, append-only — the audit trail of
every promote / reject / rollback decision the pipeline ever made.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List

from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_step,
)

# Bump when the line shape changes; the repository's
# scripts/check_bench_record.py and the
# schema unit test pin the current shape.
#
# Schema history:
#   1 — event/time/step/checkpoint + gate verdict payload.
#   2 — obs spine: verdict-bearing lines additionally carry ``trace_id``
#       (the candidate's promotion trace, minted by the supervisor) and
#       promoted lines a ``spans`` dict — the per-stage decomposition
#       (``stream_poll_s`` / ``gate_eval_s`` / ``publish_s`` /
#       ``barrier_commit_s`` / ``first_serve_s`` [+ ``deferred_wait_s``])
#       whose values sum to ``promotion_latency_s`` (within clock skew).
#   3 — adversarial gate rung (scenarios/adversary.py): when the rung
#       ran, verdict lines carry ``falsifiers`` (the search's
#       ``Falsifier.record()`` list — scenario, minimal severity, drop
#       vs clean, and the concrete ScenarioParams knob dict) plus
#       ``gate_adversary_compiles`` (the search program's budget-1
#       receipt); new event ``curriculum_updated`` records the
#       supervisor feeding a rejection's falsifiers back into the
#       trainer's schedule (and ``curriculum_update_failed`` when the
#       trainer has no scenario seam to feed).
#   4 — mesh tier (serving/mesh/): ``promoted`` and ``rolled_back``
#       lines carry ``host_count`` (hosts the coordinator's barrier
#       round committed — 1 for a single-host fleet) and
#       ``commit_round`` (the coordinator's monotone round number), so
#       the audit log attributes every swap to the cross-host commit
#       that served it.
#   5 — tenant lanes (serving/tenancy/): EVERY line carries
#       ``model_id`` — the named lane this pipeline promotes into
#       (None for a single-model pipeline). N independent pipelines
#       promoting into one fleet write N logs; the stamp is what lets
#       a merged audit view attribute each verdict to its lane.
PROMOTIONS_SCHEMA = 5

# Schemas the reader accepts. Older lines stay readable forever: the
# reader backfills ``trace_id``/``spans`` (schema 2), ``falsifiers``
# (schema 3), ``host_count``/``commit_round`` (schema 4), and
# ``model_id`` (schema 5) as None.
READABLE_SCHEMAS = (1, 2, 3, 4, 5)


class PromotionLog:
    """Append-only JSONL verdict log. Every line carries ``schema``,
    ``event`` (``promoted`` / ``rejected`` / ``rolled_back`` /
    ``curriculum_updated`` / ...), and ``time`` (epoch seconds); the
    rest is the event's payload. ``model_id`` names the tenant lane
    this log's pipeline promotes into (schema 5) — stamped on every
    line, None for a single-model pipeline."""

    def __init__(
        self, path: str | Path, model_id: str | None = None
    ) -> None:
        self.path = Path(path)
        self.model_id = model_id
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def append(self, event: str, **fields) -> dict:
        record = {
            "schema": PROMOTIONS_SCHEMA,
            "event": event,
            "time": round(time.time(), 3),
            "model_id": self.model_id,
            **fields,
        }
        line = json.dumps(record)
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
        return record

    @staticmethod
    def read(path: str | Path) -> List[dict]:
        """Every record in the log, oldest first. Accepts all
        ``READABLE_SCHEMAS`` — schema-1 lines come back with
        ``trace_id``/``spans`` backfilled to None so readers written
        against schema 2 need no per-line branching. A line stamped
        with an UNKNOWN schema raises: silently misreading a future
        shape is worse than failing loudly."""
        p = Path(path)
        if not p.exists():
            return []
        records: List[dict] = []
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            schema = rec.get("schema", 1)
            if schema not in READABLE_SCHEMAS:
                raise ValueError(
                    f"promotions.jsonl line has schema {schema!r}; this "
                    f"reader understands {READABLE_SCHEMAS} — upgrade "
                    "the reader before consuming this log"
                )
            if schema < 2:
                rec.setdefault("trace_id", None)
                rec.setdefault("spans", None)
            # Unconditional: schema-3 lines carry `falsifiers` only when
            # the adversarial rung RAN — readers get None, never a
            # KeyError, whichever way the gate was configured.
            rec.setdefault("falsifiers", None)
            # Same discipline for the schema-4 commit attribution:
            # non-swap events (rejections, curriculum updates) never
            # carry them either.
            rec.setdefault("host_count", None)
            rec.setdefault("commit_round", None)
            # Schema 5: pre-tenancy logs are single-model by
            # construction — their lane is the None lane.
            rec.setdefault("model_id", None)
            records.append(rec)
        return records


class Promoter:
    """Publish passing checkpoints into the coordinator-watched
    directory; retract demoted ones."""

    def __init__(self, promoted_dir: str | Path) -> None:
        self.promoted_dir = Path(promoted_dir)
        self.promoted_dir.mkdir(parents=True, exist_ok=True)

    def publish(self, source: str | Path) -> Path:
        """Atomically land ``source`` in the promoted directory under
        its own name. Hardlink when the filesystem allows (zero-copy —
        the trainer's file IS the promoted file), bytewise copy
        otherwise; either way the visible name appears complete-or-not
        via ``os.replace``, the same torn-write invariant as
        ``write_atomic``."""
        source = Path(source)
        dst = self.promoted_dir / source.name
        tmp = self.promoted_dir / f".{source.name}.tmp"
        tmp.unlink(missing_ok=True)
        try:
            os.link(source, tmp)
        except OSError:  # cross-device / no-hardlink filesystem
            shutil.copyfile(source, tmp)
        os.replace(tmp, dst)
        return dst

    def retract_above(self, step: int) -> List[Path]:
        """Remove every promoted checkpoint with a step strictly above
        ``step`` (the rollback path: a demoted checkpoint must not be
        re-promotable by the coordinator's next poll). Returns what was
        removed."""
        removed: List[Path] = []
        for p in sorted(self.promoted_dir.glob("rl_model_*_steps.msgpack")):
            if checkpoint_step(p) > step:
                p.unlink(missing_ok=True)
                removed.append(p)
        return removed

    def published_steps(self) -> Dict[int, Path]:
        return {
            checkpoint_step(p): p
            for p in self.promoted_dir.glob("rl_model_*_steps.msgpack")
        }
