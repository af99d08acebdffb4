"""FaultPlane: deterministic fault injection at the host seams.

Counterpart of the JAX package's ``chaos/plane.py``, the same code, so a
schedule drawn from a seed here equals the JAX package's record for
record (``FaultSchedule.from_seed`` draws from the standard library's
``random.Random``). The catalogue keeps every JAX injection point, and
the port calls each of them where the JAX package does.

Five PRs of failure machinery (circuit break, failover, wedged-barrier
abort, rollback, torn-write invisibility) each earned ONE hand-written
test. This module makes arbitrary fault sequences cheap: the code that
owns a host seam declares a named **injection point**
(:func:`fault_point`), and a seeded :class:`FaultSchedule` arms faults
at those points — crash before/after a checkpoint rename, a wedged gate
eval, ENOSPC under the async writer, a bit-flipped checkpoint byte — so
a chaos campaign replays bit-identically from its seed instead of
depending on thread timing.

Design constraints, in the MetricsRegistry/Tracer tradition:

1. **Disabled is free.** The process-global plane ships disabled;
   :func:`fault_point` is one global load + one attribute read + return.
   Injection points therefore stay wired into production seams
   unconditionally, exactly like tracer spans and registry counters.
2. **Never in the captured path.** Injection points live at host seams
   only: a call inside a captured CUDA graph would run once, at capture,
   and never on a replay.
3. **Deterministic.** A fault fires at the N-th *hit* of its point
   (per-point hit counters are deterministic on the thread that owns
   the seam), and :meth:`FaultSchedule.from_seed` is a pure function of
   its seed — same seed, same armed schedule, byte for byte.

This module imports nothing but the standard library.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: Everything a schedule may arm. ``crash`` raises
#: :class:`SimulatedCrash` (a BaseException — ordinary ``except
#: Exception`` containment must NOT swallow a kill); ``raise`` raises
#: :class:`InjectedFault`; ``enospc`` raises ``OSError(ENOSPC)``;
#: ``delay``/``wedge`` sleep (a wedge is a delay sized past the
#: watchdog/commit timeout it exists to trip); ``truncate``/``bitflip``
#: corrupt the file the point passes as ``path``.
FAULT_KINDS = (
    "crash", "raise", "enospc", "delay", "wedge", "truncate", "bitflip",
)

#: Kinds that need the injection point to pass a ``path``.
FILE_KINDS = frozenset({"truncate", "bitflip"})

#: Kinds that interrupt service (the storm measures MTTR from these).
DISRUPTIVE_KINDS = frozenset({"crash", "wedge"})

#: The injection-point catalogue: every host seam that declares a
#: :func:`fault_point`, with the fault kinds that make sense there
#: (docs/chaos.md walks each one). ``FaultSchedule.from_seed`` draws
#: from this table; arming a kind a point cannot express (a bitflip
#: with no file in hand) is a schedule-construction error, not a silent
#: no-op at fire time.
INJECTION_POINTS: Dict[str, Tuple[str, ...]] = {
    # utils/checkpoint._write_atomic — the torn-write seam. Failure
    # modes here are IO-shaped by construction: ENOSPC (retried, then
    # skip-with-audit), crash (the write is lost), corruption. A
    # generic ``raise`` would be a PROGRAM error, which the writer
    # rightly surfaces instead of degrading — so it is not armable.
    "checkpoint.write": ("enospc", "delay"),
    "checkpoint.pre_rename": ("crash", "delay"),
    "checkpoint.post_rename": ("crash", "truncate", "bitflip"),
    # utils/checkpoint.AsyncCheckpointWriter.submit_write (the TRAINING
    # thread: only a stall makes sense — an exception here would kill
    # the training loop, which is the writer's surfacing contract).
    "ckpt_writer.submit": ("delay",),
    # train/trainer.py dispatch boundary — the train lane's divergence
    # seams (train/recovery.py, docs/recovery.md). A 'raise' armed here
    # is CAUGHT by the seam and interpreted as state corruption: the
    # deterministic stand-in for organic divergence the in-program
    # health word + recovery ladder must absorb.
    #   carry_poison: NaN bomb into the live params (loss goes NaN,
    #     every later iteration is flagged until the ladder rolls back)
    "train.carry_poison": ("raise", "delay"),
    #   grad_bomb: a FINITE 1e18 scale on the params — loss/gradients
    #   explode without NaN, exercising the bounded-grad-norm and
    #   param-drift checks (and the finite-but-poisoned-checkpoint
    #   quarantine walk) rather than the finiteness ones.
    "train.grad_bomb": ("raise",),
    #   snapshot: checkpoint-time state corruption — poisons the
    #   snapshot COPY handed to the writer (never the live carry); the
    #   non-finite write gate (utils/checkpoint.py) must keep it
    #   invisible to discovery.
    "train.snapshot": ("raise", "delay"),
    # train/sebulba/queues.py — the transfer seams between the actor
    # and learner slices (docs/sebulba.md). Each seam CATCHES an armed
    # 'raise' and interprets it as that seam's characteristic transport
    # failure; the lane invariants (chaos/invariants.py) then pin that
    # the plumbing degrades instead of corrupting.
    #   enqueue: DROP — the trajectory batch vanishes in transfer (its
    #     seq is spent: downstream sees a gap, never a duplicate).
    "sebulba.enqueue": ("raise", "delay"),
    #   dequeue: DUPLICATE — the delivered item is re-queued at the
    #     head (a retrying-consumer bug's shape); the queue's seq guard
    #     must absorb the redelivery (no trajectory consumed twice).
    "sebulba.dequeue": ("raise", "delay"),
    #   param_publish: STALE PARAMS — the learner's publish is dropped,
    #     actors keep acting on the previous version; the learner's
    #     staleness gate bounds how old a consumed batch may be.
    "sebulba.param_publish": ("raise", "delay"),
    # pipeline/stream.CheckpointStream.poll.
    "stream.poll": ("raise", "delay"),
    # pipeline/gate.PromotionGate eval body (runs on the gate's thread,
    # so a wedge here exercises the gate_timeout_s deadline).
    "gate.eval": ("wedge", "delay", "raise"),
    # pipeline/supervisor run-loop body (the watchdog's lane).
    "pipeline.poll": ("crash", "wedge", "delay", "raise"),
    # serving/fleet/reload barrier acquisition + registry swap.
    "fleet.barrier": ("raise", "delay"),
    "registry.swap": ("raise", "delay"),
    # serving/scheduler worker loop (a crash here is a worker death the
    # router must circuit-break and fail over).
    "scheduler.dispatch": ("crash", "delay"),
    # serving/fleet/frontend HTTP handler.
    "frontend.handler": ("raise", "delay"),
    # serving/mesh — the cross-host tier's control-plane seams.
    # Coordinator side: the barrier RPC legs (prepare/commit round
    # trips) and the heartbeat handler; a delay here stretches a
    # global commit, a raise aborts the round (every host restored).
    "mesh.rpc": ("raise", "delay"),
    "mesh.heartbeat": ("raise", "delay"),
    # Host-agent side: the staged two-phase handlers. A wedge on
    # mesh.prepare is the canonical wedged-host case — the
    # coordinator's prepare timeout must abort the WHOLE round and
    # every host must resume on the old step.
    "mesh.prepare": ("wedge", "raise", "delay"),
    "mesh.commit": ("raise", "delay"),
    # serving/elastic — the capacity controller's re-split seams. A
    # raise at prewarm aborts the round before anything routes (old
    # split keeps serving, compiles already paid are receipted and
    # reusable); at commit it fires INSIDE the closed barrier before
    # the membership swap (the swap is one list assignment — nothing
    # to untear, gates reopen on the old split); at retire it fires in
    # the drain worker AFTER the new split routes (the retired replica
    # is stopped undrained and its queued requests fail over).
    "elastic.prewarm": ("raise", "delay"),
    "elastic.commit": ("raise", "delay"),
    "elastic.retire": ("raise", "delay"),
}


class InjectedFault(RuntimeError):
    """A deliberately injected failure (kind ``raise``)."""


class SimulatedCrash(BaseException):
    """An injected kill of the current component.

    Deliberately a ``BaseException``: the blanket ``except Exception``
    containment at every seam must treat this like a real ``kill -9`` —
    the component dies and its supervisor (watchdog, router circuit
    breaker, writer skip-with-audit) owns the recovery, not the local
    try/except.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: fire ``kind`` on the ``at_hit``-th hit
    (1-based) of injection point ``point``."""

    point: str
    kind: str
    at_hit: int
    seconds: float = 0.0  # delay/wedge duration

    def record(self) -> dict:
        """Deterministic JSON shape (key order fixed by construction)."""
        return {
            "point": self.point,
            "kind": self.kind,
            "at_hit": self.at_hit,
            "seconds": round(self.seconds, 4),
        }


class FaultSchedule:
    """An ordered, deterministic set of :class:`FaultSpec`.

    ``from_seed`` is a pure function of ``(seed, faults, points, kinds,
    ...)`` — the reason a failing campaign replays bit-identically. At
    most one fault per ``(point, at_hit)`` cell, so firing order within
    a point is total.
    """

    def __init__(self, specs: List[FaultSpec], seed: Optional[int] = None):
        seen: set = set()
        for spec in specs:
            if spec.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {spec.kind!r}")
            allowed = INJECTION_POINTS.get(spec.point)
            if allowed is not None and spec.kind not in allowed:
                raise ValueError(
                    f"point {spec.point!r} cannot express kind "
                    f"{spec.kind!r} (allowed: {allowed})"
                )
            cell = (spec.point, spec.at_hit)
            if cell in seen:
                raise ValueError(f"duplicate fault cell {cell}")
            seen.add(cell)
        self.specs = list(specs)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.specs)

    def record(self) -> List[dict]:
        """Schedule as JSON-ready dicts, sorted ``(point, at_hit)`` —
        the deterministic section of a campaign report."""
        return [
            s.record()
            for s in sorted(self.specs, key=lambda s: (s.point, s.at_hit))
        ]

    @staticmethod
    def from_seed(
        seed: int,
        faults: int = 25,
        points: Optional[Dict[str, Tuple[str, ...]]] = None,
        kinds: Optional[Tuple[str, ...]] = None,
        max_hit: int = 6,
        windows: Optional[Dict[str, int]] = None,
        delay_s: float = 0.02,
        wedge_s: float = 1.0,
    ) -> "FaultSchedule":
        """Draw ``faults`` specs deterministically from ``seed``.

        The first draws guarantee KIND COVERAGE: one fault of every
        requested kind lands at a compatible point before the remainder
        fills in uniformly, so even a small campaign spans crash /
        wedge / corrupt / ENOSPC / delay. ``max_hit`` bounds the hit
        window per point (``windows`` overrides it per point — rare
        seams like the fleet barrier only see a few hits per campaign,
        so their faults must land early); the storm paces each leg
        until its points' armed cells have all fired, so low windows
        keep campaigns short.
        """
        points = dict(points if points is not None else INJECTION_POINTS)
        kinds = tuple(kinds if kinds is not None else FAULT_KINDS)
        windows = dict(windows or {})
        # Each (point, hit) cell holds at most one fault: more faults
        # than cells can never be drawn — fail loudly instead of
        # spinning the draw loop forever.
        capacity = sum(windows.get(p, max_hit) for p in points)
        if faults > capacity:
            raise ValueError(
                f"cannot arm {faults} faults over {len(points)} points "
                f"with {capacity} (point, hit) cells — raise max_hit/"
                "windows or lower the fault count"
            )
        rng = random.Random(int(seed))
        point_names = sorted(points)
        used: set = set()
        specs: List[FaultSpec] = []

        def draw(kind: str) -> Optional[FaultSpec]:
            compatible = [p for p in point_names if kind in points[p]]
            if not compatible:
                return None
            for _ in range(64):  # bounded re-draw over free cells
                point = rng.choice(compatible)
                at_hit = rng.randint(1, windows.get(point, max_hit))
                if (point, at_hit) in used:
                    continue
                used.add((point, at_hit))
                seconds = 0.0
                if kind == "delay":
                    seconds = round(rng.uniform(0.5, 1.5) * delay_s, 4)
                elif kind == "wedge":
                    seconds = round(rng.uniform(1.0, 1.5) * wedge_s, 4)
                return FaultSpec(point, kind, at_hit, seconds)
            return None

        for kind in kinds:  # coverage pass: one of each kind first
            if len(specs) >= faults:
                break
            spec = draw(kind)
            if spec is not None:
                specs.append(spec)
        misses = 0
        while len(specs) < faults:
            spec = draw(rng.choice(kinds))
            if spec is None:
                # Kind-compatible cells can exhaust before total
                # capacity does (e.g. every crash-capable cell full) —
                # bounded misses turn "stuck" into a loud error.
                misses += 1
                if misses > 64 * max(1, len(kinds)):
                    raise ValueError(
                        f"schedule draw exhausted after {len(specs)} of "
                        f"{faults} faults: no free cells for the "
                        f"requested kinds {kinds} — raise max_hit/"
                        "windows or lower the fault count"
                    )
                continue
            misses = 0
            specs.append(spec)
        return FaultSchedule(specs, seed=int(seed))


class FaultPlane:
    """Per-point hit counters plus the armed fault cells.

    ``hit`` is the only hot call: disabled, it returns after one
    attribute read; enabled-but-idle, it bumps one counter under a lock
    and returns. Firing is rare by construction.
    """

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._armed: Dict[Tuple[str, int], FaultSpec] = {}  # graftlock: guarded-by=_lock
        self._hits: Dict[str, int] = {}  # graftlock: guarded-by=_lock
        #: Fired faults, in firing order: dicts with the spec record
        #: plus a monotonic ``t`` (the storm's MTTR anchor).
        self.fired: List[dict] = []  # graftlock: guarded-by=_lock

    # -- arming ----------------------------------------------------------

    def arm(self, schedule: FaultSchedule) -> None:
        with self._lock:
            for spec in schedule.specs:
                self._armed[(spec.point, spec.at_hit)] = spec

    def disarm(self) -> None:
        """Drop every armed-but-unfired fault (teardown between legs)."""
        with self._lock:
            self._armed.clear()

    def reset(self) -> None:
        """Fresh campaign: counters, armed cells, firing log all clear."""
        with self._lock:
            self._armed.clear()
            self._hits.clear()
            del self.fired[:]

    def pending(self, points: Optional[Tuple[str, ...]] = None) -> int:
        """Armed-but-unfired fault count (optionally for a point
        subset) — the storm's pacing signal."""
        with self._lock:
            if points is None:
                return len(self._armed)
            wanted = set(points)
            return sum(1 for p, _ in self._armed if p in wanted)

    def armed_record(self) -> List[dict]:
        """Still-armed cells, sorted — chaos_violation incident context."""
        with self._lock:
            specs = sorted(
                self._armed.values(), key=lambda s: (s.point, s.at_hit)
            )
        return [s.record() for s in specs]

    def fired_record(self) -> List[dict]:
        """Fired faults sorted by ``(point, at_hit)`` — deterministic
        across replays whenever every armed fault fired (firing ORDER
        across points is thread timing; the sorted set is not)."""
        with self._lock:
            fired = list(self.fired)
        return sorted(
            (
                {k: v for k, v in f.items() if k != "t"}
                for f in fired
            ),
            key=lambda f: (f["point"], f["at_hit"]),
        )

    # -- the hot call ----------------------------------------------------

    def hit(self, point: str, path: Optional[Any] = None) -> None:
        """One occurrence of ``point``. Fires the armed fault for this
        hit index, if any. ``path`` is the file the seam is touching —
        required context for the corrupt kinds."""
        if not self.enabled:
            return
        with self._lock:
            n = self._hits.get(point, 0) + 1
            self._hits[point] = n
            spec = self._armed.pop((point, n), None)
            if spec is not None:
                self.fired.append(
                    {**spec.record(), "t": time.perf_counter()}
                )
        if spec is not None:
            self._fire(spec, path)

    # -- effects ---------------------------------------------------------

    @staticmethod
    def _fire(spec: FaultSpec, path: Optional[Any]) -> None:
        kind = spec.kind
        if kind == "raise":
            raise InjectedFault(
                f"injected fault at {spec.point} (hit {spec.at_hit})"
            )
        if kind == "enospc":
            raise OSError(
                errno.ENOSPC,
                f"No space left on device (injected at {spec.point})",
            )
        if kind in ("delay", "wedge"):
            time.sleep(spec.seconds)
            return
        if kind == "crash":
            raise SimulatedCrash(
                f"simulated crash at {spec.point} (hit {spec.at_hit})"
            )
        if kind in FILE_KINDS:
            if path is None:
                return  # point passed no file; recorded as fired anyway
            _corrupt_file(os.fspath(path), kind)
            return
        raise AssertionError(f"unhandled fault kind {kind!r}")


def _corrupt_file(path: str, kind: str) -> None:
    """Silent on-media damage: truncate to half, or flip one mid-file
    bit — both invisible to the rename-is-publication protocol, which is
    exactly why restore needs the checksum footer."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    if kind == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return
    with open(path, "r+b") as f:  # bitflip
        offset = size // 2
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x40]) if byte else b"\x40")


# ----------------------------------------------------------------------
# Process-global plane
# ----------------------------------------------------------------------

_default_plane = FaultPlane(enabled=False)


def get_fault_plane() -> FaultPlane:
    """The process-global plane every injection point resolves at call
    time."""
    return _default_plane


def set_fault_plane(plane: FaultPlane) -> FaultPlane:
    """Swap the process-global plane (tests/campaigns); returns the
    previous one."""
    global _default_plane
    previous = _default_plane
    _default_plane = plane
    return previous


def configure_chaos(enabled: Optional[bool] = None) -> FaultPlane:
    """Re-shape the process-global plane in place (the entry points'
    ``chaos`` knob)."""
    plane = get_fault_plane()
    if enabled is not None:
        plane.enabled = bool(enabled)
    return plane


def fault_point(name: str, path: Optional[Any] = None) -> None:
    """Declare one occurrence of injection point ``name``.

    THE call production seams make. Disabled (the shipped default) it
    costs one global load + one attribute read + return, so points stay
    wired unconditionally — the same discipline that keeps tracer spans
    and registry counters in the hot paths. Host-side only: never inside
    a captured graph.
    """
    plane = _default_plane
    if not plane.enabled:
        return
    plane.hit(name, path=path)
