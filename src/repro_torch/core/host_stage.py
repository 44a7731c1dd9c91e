"""Host-stage worker thread for the async dispatch pipeline.

In ``stage_dispatch="async"`` mode the per-layer host stage does not
block the dispatch thread on the FlashD2H write-back: the engine gathers
the appended-KV stripe on the device, enqueues its copy into pinned host
memory with a CUDA event behind it (``DevicePoolPlane.new_token_kv_async``
/ ``PrefillPlane.read_group_kv_async``), hands that pending copy to a
:class:`HostStageWorker` job, and goes on to launch ``attend(l)`` /
``select(l+1)``.  The worker waits on the event (the actual blocking
transfer), stages the stripes into the DRAM pools
(``save_new_tokens_fused`` + ``flush``), and records completion per *key*
(jobs are keyed by attention-layer index).

Correctness hinges on two fences the engine issues:

- ``fence(lidx)`` before any ``load_blocks_fused(lidx, ...)`` gather
  while a write-back job for that layer is outstanding (the
  *writeback-before-gather* / restore-before-use invariant), and
- ``drain()`` at the end of every iteration, before sampling and before
  any request release drops a DRAM pool the worker may still write
  (the *writeback-before-drop* invariant).

Exceptions raised by a job are captured and re-raised on the dispatch
thread at the next ``fence``/``drain``/``submit`` touching the worker,
so a failed write-back fails the iteration instead of vanishing on a
daemon thread.

The device pools are updated in place, so the stripe must be copied out
of the pool before the next write to it: the stripe gather is a new
device tensor launched on the current stream right after the layer's
select, and every later pool write is launched after it on the same
stream, so the copy the worker waits for always holds the pool's values
as of the gather.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.obs.tracing import NULL_TRACER


class HostStageError(RuntimeError):
    """A host-stage job failed; carries the original exception as cause."""


class _Job:
    __slots__ = ("key", "fn", "args", "done")

    def __init__(self, key: Any, fn: Callable[..., None], args: tuple):
        self.key = key
        self.fn = fn
        self.args = args
        self.done = threading.Event()


class HostStageWorker:
    """Single daemon thread executing host-stage jobs in FIFO order.

    FIFO execution means jobs for the same key complete in submission
    order, so ``fence(key)`` only needs to wait for the *last* job
    submitted under that key.
    """

    def __init__(self, name: str = "host-stage", tracer=None):
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._last: Dict[Any, _Job] = {}       # key -> most recent job
        self._lock = threading.Lock()
        self._exc: Optional[BaseException] = None
        self._closed = False
        self.jobs_run = 0
        self.busy_s = 0.0                      # total time inside job fns
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # -- worker side --------------------------------------------------------
    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                if self._exc is None:          # fail fast after first error
                    t0 = time.perf_counter()
                    job.fn(*job.args)
                    dt = time.perf_counter() - t0
                    self.busy_s += dt
                    self.jobs_run += 1
                    tr = self.tracer
                    if tr.enabled:
                        # same t0/dt as busy_s, so the trace and counter
                        # overlap instruments cannot drift on one run
                        tr.complete_at("host-stage", "host-stage-worker",
                                       t0, dt, key=job.key)
            except BaseException as e:         # noqa: BLE001 - re-raised
                self._exc = e                  # on the dispatch thread
            finally:
                job.done.set()

    # -- dispatch-thread side ----------------------------------------------
    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise HostStageError(
                f"host-stage job failed: {exc!r}") from exc

    def submit(self, key: Any, fn: Callable[..., None], *args: Any) -> None:
        """Enqueue ``fn(*args)`` under ``key``; raises pending job errors."""
        self._raise_pending()
        if self._closed:
            raise HostStageError("submit() after close()")
        job = _Job(key, fn, args)
        with self._lock:
            self._last[key] = job
        self._q.put(job)

    def pending(self, key: Any) -> bool:
        """True while a job submitted under ``key`` has not completed."""
        with self._lock:
            job = self._last.get(key)
        return job is not None and not job.done.is_set()

    def fence(self, key: Any) -> None:
        """Block until every job submitted under ``key`` has completed."""
        with self._lock:
            job = self._last.get(key)
        if job is not None:
            job.done.wait()
        self._raise_pending()

    def drain(self) -> None:
        """Block until every submitted job has completed."""
        with self._lock:
            jobs = list(self._last.values())
        for job in jobs:
            job.done.wait()
        # anything still queued was submitted concurrently by this thread —
        # there is a single producer, so _last covers the full queue.
        self._raise_pending()

    def close(self) -> None:
        """Drain outstanding work and stop the thread (idempotent).

        Errors from outstanding jobs surface here rather than being
        swallowed by shutdown.
        """
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    @property
    def closed(self) -> bool:
        return self._closed
