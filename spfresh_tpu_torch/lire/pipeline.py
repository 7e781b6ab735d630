"""LIRE two-stage background pipeline (counterpart of
``spfresh_tpu/lire/pipeline.py``; the Rust reference's ``pipeline.rs``).

Front stage (caller thread) submits Split/Merge/Reassign/GC tasks; the
background stage is one worker thread draining a queue (mpsc + std::thread
parity, pipeline.rs:37,55-83).  Per-partition status transitions
Ready -> Processing -> Ready | NeedsMaintenance under a lock
(pipeline.rs:85-172), with NeedsMaintenance as the soft-failure flag the
reference uses (no repair loop there; here `drain()` lets callers join the
queue, and failed ops record their exception for inspection).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging
import queue
import threading
from typing import Callable, Dict, Iterable, List, Optional

from spfresh_tpu_torch.lire.operations import LireContext, OperationResult, PartitionOperation
from spfresh_tpu_torch.utils import metrics
from spfresh_tpu_torch.utils.profiling import current_span_id, span

log = logging.getLogger(__name__)


class PartitionStatus(enum.Enum):
    """Mirror of PartitionStatus (pipeline.rs:21-25)."""

    READY = "ready"
    PROCESSING = "processing"
    NEEDS_MAINTENANCE = "needs_maintenance"


class PipelineError(Exception):
    """LireError::Pipeline parity (lire/mod.rs:19-30)."""


_SHUTDOWN = object()  # BackgroundTask::Shutdown (pipeline.rs:12-17)


@dataclasses.dataclass
class TaskOutcome:
    op: PartitionOperation
    result: Optional[OperationResult]
    error: Optional[Exception]


class TwoStagePipeline:
    """Mirror of TwoStagePipeline (pipeline.rs:28-33)."""

    def __init__(self, ctx: LireContext, on_complete: Optional[Callable[[TaskOutcome], None]] = None):
        self.ctx = ctx
        self.on_complete = on_complete
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._status_lock = threading.Lock()
        self._status: Dict[int, PartitionStatus] = {}
        # Bounded archive: a long-running serving process completes
        # thousands of maintenance ops (each Reassign op holds per-vector
        # triple lists) — an unbounded list is a slow leak on the host.
        self._outcomes: "collections.deque[TaskOutcome]" = collections.deque(
            maxlen=1024
        )
        # Partitions whose maintenance was REFUSED because an op covering
        # them was already in flight: when that op completes, they surface
        # as NEEDS_MAINTENANCE (for repair()/flush()) instead of READY —
        # a refused Split/Merge must not vanish (the trigger may never
        # re-fire).
        self._recheck: set = set()
        self._started = False

    # -- lifecycle (pipeline.rs:186-215) -----------------------------------

    def start(self) -> None:
        if self._started:
            raise PipelineError("pipeline already started")
        self._thread = threading.Thread(
            target=self._worker, name="lire-background", daemon=True
        )
        self._started = True
        self._thread.start()
        log.info("LIRE pipeline started")

    def stop(self) -> None:
        if not self._started:
            raise PipelineError("pipeline not started")
        self._queue.put(_SHUTDOWN)
        self._thread.join()
        self._thread = None
        self._started = False
        log.info("LIRE pipeline stopped")

    @property
    def is_running(self) -> bool:
        return self._started

    # -- submission (pipeline.rs:174-184) ----------------------------------

    def submit_task(self, op: PartitionOperation) -> None:
        if not self._started:
            raise PipelineError("cannot submit task: pipeline not started")
        # Record the affected set HERE and ship it with the op: the worker's
        # catch-all needs it to un-wedge these partitions if _process raises
        # before its own status handling (a throwing
        # get_affected_partitions would leave them PROCESSING forever,
        # refusing all future maintenance).
        affected = [int(p) for p in op.get_affected_partitions()]
        for pid in affected:
            self._set_status(pid, PartitionStatus.PROCESSING)
        # The submitting span, the cause of the worker's ``lire.op`` span.
        self._queue.put((op, affected, current_span_id()))

    def drain(self) -> None:
        """Block until every submitted task has been processed."""
        self._queue.join()

    # -- status (pipeline.rs:217-222) --------------------------------------

    def get_partition_status(self, partition_id: int) -> PartitionStatus:
        with self._status_lock:
            return self._status.get(partition_id, PartitionStatus.READY)

    def _set_status(self, partition_id: int, status: PartitionStatus) -> None:
        with self._status_lock:
            self._status[partition_id] = status

    def outcomes(self) -> List[TaskOutcome]:
        with self._status_lock:
            return list(self._outcomes)

    def defer_recheck(self, partition_ids: Iterable[int]) -> None:
        """Mark partitions for a threshold re-check once their in-flight op
        completes (see schedule_maintenance's refusal path)."""
        with self._status_lock:
            self._recheck.update(int(p) for p in partition_ids)

    def _finish_status(self, pid: int) -> None:
        with self._status_lock:
            if pid in self._recheck:
                self._recheck.discard(pid)
                self._status[pid] = PartitionStatus.NEEDS_MAINTENANCE
            else:
                self._status[pid] = PartitionStatus.READY

    # -- background stage (pipeline.rs:62-172) -----------------------------

    def _worker(self) -> None:
        while True:
            task = self._queue.get()
            if task is _SHUTDOWN:
                self._queue.task_done()
                return
            op, affected, cause = task
            try:
                # Closed before task_done: a drain() sees the op's span counted.
                with span("lire.op", cause=cause) as sp:
                    outcome = self._process(op, affected)
                    if outcome.result is not None:
                        sp.items = outcome.result.vectors_moved
                    with self._status_lock:
                        self._outcomes.append(outcome)
                    if self.on_complete is not None:
                        try:
                            self.on_complete(outcome)
                        except Exception:  # callback bugs must not kill the worker
                            log.exception("LIRE on_complete callback failed")
            except Exception:
                # A raise anywhere outside execute()'s own handling must not
                # kill the worker: a dead worker leaves task_done uncalled and
                # every future drain()/flush()/close() deadlocks in
                # queue.join().  Flip the submit-time affected set to
                # NEEDS_MAINTENANCE so repair() can recover them — leaving
                # them PROCESSING would refuse all their future maintenance.
                log.exception("LIRE worker: unexpected failure processing task")
                for pid in affected:
                    self._set_status(pid, PartitionStatus.NEEDS_MAINTENANCE)
            finally:
                self._queue.task_done()

    def _process(self, op: PartitionOperation, affected: List[int]) -> TaskOutcome:
        try:
            if op.is_stale(self.ctx):
                # Source posting(s) retired by an earlier queued op: the op
                # is obsolete, not failed (see PartitionOperation.is_stale).
                # Partitions that still exist may still carry the condition
                # that triggered the op — flag them for the repair loop's
                # threshold re-check instead of silently dropping pending
                # maintenance (stale_survivors).
                metrics.inc(f"lire.{type(op).__name__.lower()}.stale")
                try:
                    survivors = set(op.stale_survivors(self.ctx))
                except Exception:  # noqa: BLE001 — never block the skip path
                    survivors = set()
                for pid in affected:
                    if pid in survivors:
                        self._set_status(pid, PartitionStatus.NEEDS_MAINTENANCE)
                    else:
                        self._finish_status(pid)
                return TaskOutcome(op, None, None)
        except Exception:  # noqa: BLE001 — fall through to execute's handling
            pass
        try:
            result = op.execute(self.ctx)
        except Exception as e:  # noqa: BLE001 — op failure flags maintenance
            metrics.inc(f"lire.{type(op).__name__.lower()}.failed")
            log.warning("LIRE op %s failed: %s", type(op).__name__, e)
            for pid in affected:
                self._set_status(pid, PartitionStatus.NEEDS_MAINTENANCE)
            return TaskOutcome(op, None, e)
        metrics.inc(f"lire.{type(op).__name__.lower()}.ok")
        metrics.inc("lire.vectors_moved", result.vectors_moved)
        for pid in affected:
            self._finish_status(pid)
        for pid in result.new_postings:
            self._finish_status(pid)
        return TaskOutcome(op, result, None)
