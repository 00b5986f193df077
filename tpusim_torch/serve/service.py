"""ScenarioFleet: the what-if capacity-planning service.

The life of a request:

  submit()   admission: bounded-queue backpressure; a rejection resolves the
             future at once with a REJECT_* reason.
  stage      host staging on the worker side: snapshot resolution, the
             policy's compile, compile_cluster, or a staged-cache hit.
  bucket     shape-class filing; a full bucket dispatches at once, a partial
             one waits for siblings until its deadline.
  dispatch   one batched program a bucket (ghost-padded if partial), from
             the executor's caches where it can.
  decode     each request's placements; its future resolves with a
             WhatIfResponse.

The worker thread (`start`/`stop`) gives the service its asynchronous shape;
tests and the CLI drive the same pipeline synchronously through `pump`,
`drain` or `run`, which keeps every deadline decision under the injected
clock.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.serve.batcher import Bucket, PendingEntry, ShapeClassBatcher
from tpusim_torch.serve.executor import ServeExecutor
from tpusim_torch.serve.queue import AdmissionQueue
from tpusim_torch.serve.request import (
    REJECT_DEADLINE,
    REJECT_QUEUE_FULL,
    REJECT_SHED,
    REJECT_SHUTDOWN,
    ServeRejected,
    WhatIfRequest,
    WhatIfResponse,
)


class ScenarioFleet:
    def __init__(self, provider: str = "DefaultProvider",
                 bucket_size: int = 4, flush_after_s: float = 0.05,
                 max_queue: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 deadline_s: Optional[float] = None, device="cuda"):
        """device: "cuda" (the default: the batched scan on the card) or
        "cpu" (its plain version)."""
        self.executor = ServeExecutor(provider=provider, device=device)
        self.queue = AdmissionQueue(max_queue)
        self.batcher = ShapeClassBatcher(bucket_size=bucket_size,
                                         flush_after_s=flush_after_s,
                                         clock=clock)
        self._clock = clock
        self.deadline_s = deadline_s  # fleet-wide default request deadline
        self._requeued: set = set()   # request_ids requeued after a worker
        self._thread: Optional[threading.Thread] = None  # death (at most 1x)
        self._stopping = threading.Event()

    def register_snapshot(self, ref: str, snapshot: ClusterSnapshot) -> str:
        return self.executor.register_snapshot(ref, snapshot)

    # -- admission ---------------------------------------------------------

    @staticmethod
    def _reject(request: WhatIfRequest, reason: str,
                message: str) -> WhatIfResponse:
        return WhatIfResponse(request_id=request.request_id, error=message,
                              rejected=reason)

    def submit(self, request: WhatIfRequest) -> "Future[WhatIfResponse]":
        """Admit one request; the future resolves to a WhatIfResponse (a
        rejection resolves it at once: submit never raises for a problem of
        the request)."""
        future: "Future[WhatIfResponse]" = Future()
        admitted, victim = self.queue.offer(
            (request, future, self._clock()), priority=request.priority)
        if victim is not None:
            # a full queue shed its earliest lowest-priority waiter to make
            # room for this higher-priority newcomer
            v_request, v_future, _ = victim
            if not v_future.done():
                v_future.set_result(self._reject(
                    v_request, REJECT_SHED,
                    f"shed by higher-priority {request.request_id} "
                    f"(priority {request.priority} > "
                    f"{v_request.priority}) on a full queue"))
        if not admitted:
            reason = (REJECT_SHUTDOWN if self.queue.closed
                      else REJECT_QUEUE_FULL)
            future.set_result(self._reject(
                request, reason,
                "fleet is shutting down" if reason == REJECT_SHUTDOWN
                else f"admission queue full ({self.queue.maxsize})"))
        return future

    # -- pipeline ----------------------------------------------------------

    def _deadline_for(self, request: WhatIfRequest) -> Optional[float]:
        return (request.deadline_s if request.deadline_s is not None
                else self.deadline_s)

    def _expired(self, request: WhatIfRequest, admitted_at: float) -> bool:
        limit = self._deadline_for(request)
        return limit is not None and self._clock() - admitted_at > limit

    def _process(self, request: WhatIfRequest, future: Future,
                 admitted_at: float) -> None:
        if self._expired(request, admitted_at):
            # aged out in the admission queue: reject before staging
            future.set_result(self._reject(
                request, REJECT_DEADLINE,
                f"deadline {self._deadline_for(request)}s expired before "
                "staging"))
            return
        try:
            (staged, shape_class, plan_sig, cp,
             hard_weight) = self.executor.stage(request)
        except ServeRejected as exc:
            future.set_result(self._reject(request, exc.reason, str(exc)))
            return
        entry = PendingEntry(request=request, staged=staged, future=future,
                             admitted_at=admitted_at,
                             shape_class=shape_class, plan_sig=plan_sig,
                             cp=cp, hard_weight=hard_weight)
        full = self.batcher.add(entry)
        if full is not None:
            self._dispatch(full)

    def _dispatch(self, bucket: Bucket) -> None:
        # entries whose deadline lapsed waiting for siblings are rejected,
        # not run: the bucket shrinks (ghosts grow), so the others still
        # run through the same program
        live = []
        for entry in bucket.entries:
            if self._expired(entry.request, entry.admitted_at):
                if not entry.future.done():
                    entry.future.set_result(self._reject(
                        entry.request, REJECT_DEADLINE,
                        f"deadline {self._deadline_for(entry.request)}s "
                        "expired waiting for a bucket"))
            else:
                live.append(entry)
        if not live:
            return
        if len(live) < len(bucket.entries):
            bucket = Bucket(key=bucket.key, size=bucket.size, entries=live)
        try:
            results, warm = self.executor.dispatch(bucket)
        except Exception as exc:  # a bucket failure fails its members only
            for entry in bucket.entries:
                if not entry.future.done():
                    entry.future.set_result(WhatIfResponse(
                        request_id=entry.request.request_id,
                        error=f"{type(exc).__name__}: {exc}"))
            return
        now = self._clock()
        for entry, result in zip(bucket.entries, results):
            if not entry.future.done():
                entry.future.set_result(WhatIfResponse(
                    request_id=entry.request.request_id, result=result,
                    bucket_real=len(bucket.entries),
                    bucket_ghosts=bucket.ghosts, compile_cache_hit=warm,
                    latency_s=now - entry.admitted_at))

    def _process_guarded(self, item) -> None:
        """_process with worker-death containment: an unexpected exception
        (not a rejection, which _process resolves itself) requeues the item
        at most once; a second one resolves the future with the error, so
        no future is resolved twice and none is lost."""
        request, future, admitted_at = item
        try:
            self._process(request, future, admitted_at)
        except Exception as exc:
            if future.done():
                return
            if request.request_id not in self._requeued:
                self._requeued.add(request.request_id)
                if self.queue.put(item, priority=request.priority):
                    return
            future.set_result(WhatIfResponse(
                request_id=request.request_id,
                error=f"{type(exc).__name__}: {exc}"))

    def _flush_due(self) -> None:
        for bucket in self.batcher.due():
            self._dispatch(bucket)

    # -- synchronous driving (tests, CLI) ----------------------------------

    def pump(self) -> None:
        """Process everything already queued, then flush due buckets."""
        while True:
            item = self.queue.pop()
            if item is None:
                break
            self._process_guarded(item)
        self._flush_due()

    def drain(self) -> None:
        """pump(), then dispatch every partial bucket whatever its
        deadline."""
        self.pump()
        for bucket in self.batcher.flush_all():
            self._dispatch(bucket)

    def run(self, requests: Sequence[WhatIfRequest]) -> List[WhatIfResponse]:
        """Submit all, drain, and return the responses in submission
        order."""
        futures = [self.submit(r) for r in requests]
        self.drain()
        return [f.result() for f in futures]

    # -- worker thread -----------------------------------------------------

    def start(self) -> "ScenarioFleet":
        if self._thread is not None:
            raise RuntimeError("fleet already started")
        self._stopping.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="scenario-fleet", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stopping.is_set():
            deadline = self.batcher.next_deadline()
            timeout = (max(0.001, deadline - self._clock())
                       if deadline is not None else 0.05)
            item = self.queue.pop(timeout=timeout)
            if item is not None:
                self._process_guarded(item)
            self._flush_due()
        self.drain()

    def stop(self) -> None:
        """Stop admitting and finish what is queued (partial buckets too);
        then whatever is still pending (a dead worker's leftovers, items a
        join timeout stranded) resolves REJECT_SHUTDOWN, so no submitted
        future is left unresolved."""
        self.queue.close()
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=600)
            self._thread = None
        else:
            self.drain()
        leftovers = []
        while True:
            item = self.queue.pop()
            if item is None:
                break
            leftovers.append(item[:2])  # (request, future)
        leftovers.extend((e.request, e.future)
                         for b in self.batcher.flush_all()
                         for e in b.entries)
        for request, future in leftovers:
            if not future.done():
                future.set_result(self._reject(
                    request, REJECT_SHUTDOWN,
                    "fleet stopped before this request dispatched"))
