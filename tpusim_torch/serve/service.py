"""ScenarioFleet: the what-if capacity-planning service.

The life of a request:

  submit()   admission: bounded-queue backpressure; a rejection resolves the
             future at once with a REJECT_* reason.
  overlay    a request naming a live twin's ref (attach_stream) is answered
             at once by an overlay query on the twin's resident carry, and
             never buckets; where the overlay refuses it goes on staged.
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

On a scenario mesh (mesh=) every rank builds the fleet and makes the same
calls: run() the same number of times, or start() then stop(). Rank 0 is
the controller (ServeExecutor): its queue, batcher and clock decide every
bucket, and the other ranks dispatch the buckets it sends. Rank 0's run()
returns the responses, the other ranks' an empty list; stop() ends the
other ranks' loops.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import slo, tracectx
from tpusim_torch.obs.recorder import (
    flow_end,
    flow_start,
    note_serve,
    note_serve_retry,
    span,
)
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
                 deadline_s: Optional[float] = None, max_retries: int = 2,
                 device="cuda", mesh: Optional[object] = None):
        """device: "cuda" (the default: the batched scan on the card) or
        "cpu" (its plain version). max_retries: the retries of a bucket
        whose dispatch an installed chaos plan faulted, before the host
        pipeline answers it; the clock paces their backoff. mesh: a
        ("scenario", "node") DeviceMesh over every rank (module
        docstring); the bucket size must divide over its scenario axis."""
        self.executor = ServeExecutor(provider=provider, device=device,
                                      max_retries=max_retries, clock=clock,
                                      mesh=mesh)
        if mesh is not None:
            from tpusim_torch.sharding import _axis_size

            n = _axis_size(mesh, "scenario")
            if bucket_size % n != 0:
                raise ValueError(
                    f"bucket_size={bucket_size} does not divide over the "
                    f"mesh's scenario axis ({n} shards)")
        self.mesh = mesh
        self.controller = self.executor.controller
        self._follow_error: Optional[BaseException] = None
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

    def attach_stream(self, session, ref: str = "live") -> str:
        """Serve `ref` from a live StreamSession's resident twin: requests
        naming the ref ride the overlay path and fall back to staging the
        session's current host picture."""
        return self.executor.attach_twin(ref, session)

    def attach_replica(self, follower, ref: str = "live") -> None:
        """Serve `ref`'s overlay reads from a FollowerTwin replica first
        (the standby's twin), the leader's twin only where the replica
        refuses."""
        self.executor.attach_replica(ref, follower)

    # -- admission ---------------------------------------------------------

    def _reject(self, request: WhatIfRequest, reason: str,
                message: str) -> WhatIfResponse:
        register().serve_rejected.inc(reason)
        note_serve("reject", {"id": request.request_id, "reason": reason})
        self._end_flows(request)
        return WhatIfResponse(request_id=request.request_id, error=message,
                              rejected=reason)

    @staticmethod
    def _end_flows(request: WhatIfRequest) -> None:
        """End a request's trace hand-off arrows still open when it
        resolves off the happy path (shed, deadline, shutdown): a flow
        start without its finish would dangle in the trace."""
        ctx = getattr(request, "trace", None)
        if ctx is None:
            return
        if getattr(request, "_queue_flow", False):
            request._queue_flow = False
            flow_end("serve:enqueue", f"{ctx.trace_id}:q")
        if getattr(request, "_bucket_flow", False):
            request._bucket_flow = False
            flow_end("serve:bucket", f"{ctx.trace_id}:b")

    def submit(self, request: WhatIfRequest) -> "Future[WhatIfResponse]":
        """Admit one request; the future resolves to a WhatIfResponse (a
        rejection resolves it at once: submit never raises for a problem of
        the request)."""
        if not self.controller:
            raise RuntimeError(
                "a serve mesh's rank 0 takes the requests; call run() or "
                "start()/stop() on every other rank")
        future: "Future[WhatIfResponse]" = Future()
        # one TraceContext a request: it rides the request object across
        # the worker thread, and the queue hand-off is a flow arrow keyed on
        # the trace id
        ctx = tracectx.start()
        if ctx is not None:
            request.trace = ctx
        with tracectx.activate(ctx), span("serve:admit") as sp:
            if sp:
                sp.set("id", request.request_id)
            admitted, victim = self.queue.offer(
                (request, future, self._clock()), priority=request.priority)
            if victim is not None:
                # a full queue shed its earliest lowest-priority waiter to
                # make room for this higher-priority newcomer
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
            else:
                note_serve("admit", {"id": request.request_id})
                if ctx is not None:
                    request._queue_flow = True
                    flow_start("serve:enqueue", f"{ctx.trace_id}:q",
                               site="serve")
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
        # the admission's TraceContext again, on this (worker) thread; the
        # queue hand-off arrow ends before any span opens
        ctx = getattr(request, "trace", None)
        with tracectx.activate(ctx):
            if ctx is not None and getattr(request, "_queue_flow", False):
                request._queue_flow = False
                flow_end("serve:enqueue", f"{ctx.trace_id}:q")
            self._process_in_ctx(request, future, admitted_at, ctx)

    def _process_in_ctx(self, request: WhatIfRequest, future: Future,
                        admitted_at: float, ctx) -> None:
        if self._expired(request, admitted_at):
            # aged out in the admission queue: reject before staging
            future.set_result(self._reject(
                request, REJECT_DEADLINE,
                f"deadline {self._deadline_for(request)}s expired before "
                "staging"))
            return
        try:
            hit = self.executor.try_overlay(request)
            if hit is not None:
                # the live twin answered: resolve now (an overlay never
                # buckets; the resident program ran already)
                result, warm, path = hit
                latency = self._clock() - admitted_at
                register().serve_request_latency.observe(
                    latency * 1e6,
                    exemplar=ctx.trace_id if ctx is not None else None)
                slo.observe_cycle("serve", latency * 1e6)
                note_serve("overlay_resolve", {"id": request.request_id,
                                               "path": path})
                future.set_result(WhatIfResponse(
                    request_id=request.request_id, result=result,
                    bucket_real=1, bucket_ghosts=0, compile_cache_hit=warm,
                    latency_s=latency, degraded=None))
                return
            with span("serve:stage") as sp:
                if sp:
                    sp.set("id", request.request_id)
                (staged, shape_class, plan_sig, cp,
                 hard_weight) = self.executor.stage(request)
        except ServeRejected as exc:
            future.set_result(self._reject(request, exc.reason, str(exc)))
            return
        entry = PendingEntry(request=request, staged=staged, future=future,
                             admitted_at=admitted_at,
                             shape_class=shape_class, plan_sig=plan_sig,
                             cp=cp, hard_weight=hard_weight)
        with span("serve:bucket"):
            full = self.batcher.add(entry)
        note_serve("bucket", {"id": request.request_id,
                              "shape": shape_class.describe()})
        if ctx is not None:
            # the bucket -> dispatch hand-off: the entry may wait for
            # siblings; the arrow lands on whichever dispatch (or deadline
            # rejection) takes it
            request._bucket_flow = True
            flow_start("serve:bucket", f"{ctx.trace_id}:b", site="serve")
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
        reg = register()
        reg.serve_batch_occupancy.observe(len(bucket.entries))
        # every member's bucket arrow lands on this dispatch; the shared
        # program then runs under the first member's context, so its spans
        # carry a trace id that resolves
        for entry in bucket.entries:
            self._end_flows(entry.request)
        lead = getattr(bucket.entries[0].request, "trace", None)
        try:
            with tracectx.activate(lead):
                results, warm = self.executor.dispatch(bucket)
        except Exception as exc:  # a bucket failure fails its members only
            for entry in bucket.entries:
                if not entry.future.done():
                    entry.future.set_result(WhatIfResponse(
                        request_id=entry.request.request_id,
                        error=f"{type(exc).__name__}: {exc}"))
            return
        now = self._clock()
        degraded = self.executor.last_path
        for entry, result in zip(bucket.entries, results):
            latency = now - entry.admitted_at
            entry_ctx = getattr(entry.request, "trace", None)
            reg.serve_request_latency.observe(
                latency * 1e6,
                exemplar=entry_ctx.trace_id if entry_ctx is not None
                else None)
            slo.observe_cycle("serve", latency * 1e6)
            if not entry.future.done():
                entry.future.set_result(WhatIfResponse(
                    request_id=entry.request.request_id, result=result,
                    bucket_real=len(bucket.entries),
                    bucket_ghosts=bucket.ghosts, compile_cache_hit=warm,
                    latency_s=latency, degraded=degraded))

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
                note_serve_retry("worker_death",
                                 {"id": request.request_id,
                                  "error": f"{type(exc).__name__}: {exc}"})
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
        order. On a mesh's other ranks: dispatch rank 0's buckets until its
        run ends, and return an empty list (`requests` unread: rank 0 holds
        the responses)."""
        if not self.controller:
            self._expect("done")
            return []
        futures = [self.submit(r) for r in requests]
        self.drain()
        responses = [f.result() for f in futures]
        if self.mesh is not None:
            self.executor.send(("done",))
        return responses

    def _follow(self) -> None:
        """A mesh worker's thread: rank 0's buckets until it closes; an
        error is kept for stop() to raise."""
        try:
            self._expect("close")
        except BaseException as exc:  # noqa: BLE001 (raised by stop)
            self._follow_error = exc

    def _expect(self, kind: str):
        message = self.executor.follow()
        if message[0] != kind:
            raise RuntimeError(f"serve mesh: rank 0 sent {message[0]!r} "
                               f"where this rank awaited {kind!r}")
        return message

    # -- worker thread -----------------------------------------------------

    def start(self) -> "ScenarioFleet":
        if self._thread is not None:
            raise RuntimeError("fleet already started")
        self._stopping.clear()
        target = self._loop if self.controller else self._follow
        self._thread = threading.Thread(target=target,
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
        future is left unresolved. On a mesh rank 0 then ends the other
        ranks' loops, which return here."""
        if not self.controller:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            else:
                self._expect("close")
            error, self._follow_error = self._follow_error, None
            if error is not None:
                raise error
            return
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
        if self.mesh is not None:
            self.executor.send(("close",))
