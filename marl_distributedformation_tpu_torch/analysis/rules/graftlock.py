"""graftlock rule family: host-concurrency lock discipline.

Counterpart of the JAX package's four graftlock rules, over the port's
locks too: the capture locks (``train/capture.py``'s ``_STREAMS_LOCK``
and ``_CAPTURE_LOCK``), the engines' act locks and the fleet's gates.
The chaos plane proves the threaded host seams RECOVER from injected
faults; these rules statically prove the seams cannot deadlock or race
in the first place. All four replay findings the call-graph engine
(``analysis/callgraph.py``) computed once per package snapshot — the
lock model, annotation grammar (``# graftlock: guarded-by= / holds= /
gate / lock=``), and traversal bounds live there; the rules are lookup
tables keyed on the linted module's path.

- **lock-ordering-cycle** — the may-acquire-while-holding graph (only
  UNTIMED acquisitions create edges; same-name pairs are instance
  iteration, not nesting) contains a cycle: two threads entering from
  different edges deadlock. The report carries the full acquisition
  chain, one edge per site.
- **unguarded-shared-mutation** — an attribute declared
  ``guarded-by=<lock>`` is written (assignment, subscript store, or
  container-mutator call) from a thread-target-reachable function on a
  path that does not hold the guard. Opt-in: only declared attributes
  are checked, so the rule has zero false-positive surface on
  unannotated code.
- **blocking-call-under-dispatch-lock** — ``torch.cuda.synchronize``,
  untimed
  ``queue.get()`` / ``acquire()`` / ``wait()``, file IO, HTTP, or
  flight-record incident dumps reachable while a dispatch/batch gate
  (``batch_lock`` by convention, or ``# graftlock: gate``) is held —
  the exact shape that extends a fleet-wide serving pause.
- **lock-released-across-await-seam** — a callback (thread target,
  timer, executor submit, done-callback, handler-table entry) is
  registered while holding a lock the callback re-acquires; if the
  registering thread waits on the callback, or the callback can run
  synchronously, the seam deadlocks.

Suppression policy: a finding that is correct-by-design is suppressed
in place with ``# graftlint: disable=<rule>`` plus a rationale on the
same comment.
"""

from __future__ import annotations

from typing import Iterator, Tuple

from marl_distributedformation_tpu_torch.analysis import callgraph
from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
)


class _GraftlockRule(Rule):
    """Shared replay shell: findings come from the package graph."""

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        pg = callgraph.ENGINE.package_for(ctx)
        key = callgraph.ENGINE.module_key_for(ctx)
        yield from pg.findings_for(key, self.name)


class LockOrderingCycle(_GraftlockRule):
    name = callgraph.LOCK_ORDERING_CYCLE
    default_severity = "error"
    description = (
        "the may-acquire-while-holding graph has a cycle — threads "
        "entering from different edges deadlock; acquire locks in one "
        "global order or make an edge a timed acquire with an abort path"
    )


class UnguardedSharedMutation(_GraftlockRule):
    name = callgraph.UNGUARDED_SHARED_MUTATION
    default_severity = "error"
    description = (
        "an attribute declared `# graftlock: guarded-by=<lock>` is "
        "written from thread-reachable code on a path that does not "
        "hold its guard"
    )


class BlockingCallUnderDispatchLock(_GraftlockRule):
    name = callgraph.BLOCKING_UNDER_GATE
    default_severity = "error"
    description = (
        "a blocking call (torch.cuda.synchronize, untimed "
        "queue.get/acquire/wait, "
        "file IO, HTTP) is reachable while a dispatch/batch gate is "
        "held — it extends the fleet-wide serving pause"
    )


class LockReleasedAcrossAwaitSeam(_GraftlockRule):
    name = callgraph.CALLBACK_LOCK_SEAM
    default_severity = "error"
    description = (
        "a callback is registered while holding a lock the callback "
        "re-acquires — a deadlock whenever the registration side waits "
        "on (or runs) the callback; register after releasing"
    )
