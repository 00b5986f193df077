"""Flight recorder: span and event timeline across the host/device boundary.

Every scheduling attempt (host phases: queue wait, predicates, priorities,
select host, preempt, assume, bind) and every piece of device work (cluster
compile, kernel dispatch, victim-path selection) lands on one timeline,
exported as Chrome ``trace_event`` JSON (loadable in Perfetto or
chrome://tracing) or as a raw JSONL span stream. Span names, categories and
argument keys are the JAX package's, so a trace of either package reads the
same.

Design constraints:

- **Zero cost when disabled.** `span()` returns a falsy shared no-op
  singleton when no recorder is installed: no dict, no Span object, no
  per-pod allocation. Call sites guard argument construction with
  ``if sp:`` so label strings are never built on the disabled path.
- **Deterministic under an injected clock.** The recorder never calls
  `time.perf_counter` directly; the clock is a constructor argument, so
  goldens can pin span structure byte for byte.
- **Device time without a synchronize.** A ``"device"`` span opened with a
  CUDA ``device`` records a CUDA event at each end, on the device's current
  stream, beside its wall. The time between the two events is read when the
  trace is exported (``args.device_us``), never inside the timed region.
- **Causal ids.** Every event recorded while an obs.tracectx context is
  active carries its ``trace_id`` and ``span_id`` in its args; flows
  (``flow_start``/``flow_end``) link a hand-off across threads.

Counters and histograms do not live here: they land in the
`framework/metrics.py` registry, and the `note_*` helpers below feed both
sinks.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from tpusim_torch.framework import metrics as _metrics

PID = 1
# stable Perfetto track ids per category
_TIDS = {"host": 1, "device": 2, "tool": 3}
# completed CUDA event pairs are resolved without waiting once this many are
# pending, so an always-on recorder's pending list stays bounded
_PENDING_SWEEP = 4096
# the fills a device clock sync launches, one after each reading: a single
# launch's latency under a profiler strays by tens of µs, the fastest of
# eight by a few
CLOCK_FILLS = 8


class _NoopSpan:
    """Shared do-nothing span; falsy so call sites can skip building args."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass

    def end(self) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("rec", "name", "cat", "t0", "args", "cuda")

    def __init__(self, rec: "FlightRecorder", name: str, cat: str, t0: float,
                 cuda: Optional[Tuple[Any, Any]] = None):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.args: Optional[Dict[str, Any]] = None
        # (stream, start event) of a device span on a CUDA device
        self.cuda = cuda

    def __bool__(self) -> bool:
        return True

    def set(self, key: str, value: Any) -> None:
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: object) -> bool:
        self.end()
        return False

    def end(self) -> None:
        self.rec._finish(self)


def _cuda_stream(device) -> Any:
    """The current stream of `device` when it is a CUDA device, else None."""
    if device is None:
        return None
    import torch

    d = torch.device(device)
    if d.type != "cuda":
        return None
    return torch.cuda.current_stream(d)


def _cuda_event(stream) -> Any:
    import torch

    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


class FlightRecorder:
    """Collects complete ('X'), instant ('i') and flow ('s'/'f') trace
    events in memory.

    The timeline is a bounded ring (``max_events``): an always-on serve or
    stream process can run for days without its host memory growing without
    bound. When the ring is full the OLDEST event is dropped and
    ``tpusim_obs_dropped_events_total`` increments, so an exported trace that
    lost its head says so on the scrape."""

    DEFAULT_MAX_EVENTS = 262_144

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: Optional[int] = None,
                 pid: Optional[int] = None, process_name: str = "tpusim"):
        self.clock: Callable[[], float] = clock or time.perf_counter
        self._epoch = self.clock()
        self.max_events = (self.DEFAULT_MAX_EVENTS if max_events is None
                           else max(1, int(max_events)))
        self.events: Deque[Dict[str, Any]] = deque(maxlen=self.max_events)
        self.dropped = 0
        self.dropped_by_category: Dict[str, int] = {}
        self.pid = PID if pid is None else int(pid)
        self.process_name = process_name
        # per-instance track registry: an unknown category gets a track of
        # its own instead of piling onto the shared "tool" lane
        self._tids: Dict[str, int] = dict(_TIDS)
        # clock anchors for aligning several processes' traces (name ->
        # recorder-relative microseconds), exported in otherData as the JAX
        # package's recorder exports them; the replication hello sets them,
        # and sync_device_clock a list of readings for a device trace
        self.anchors: Dict[str, Any] = {}
        # device spans whose CUDA event pair is not read yet:
        # (event dict, start event, end event)
        self._pending: List[Tuple[Dict[str, Any], Any, Any]] = []
        self._lock = threading.Lock()

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self.events) == self.max_events:
                cat = self.events[0].get("cat", "meta")
                self.dropped += 1
                self.dropped_by_category[cat] = \
                    self.dropped_by_category.get(cat, 0) + 1
                _metrics.register().obs_dropped_events.inc(cat)
            self.events.append(ev)

    def _tid(self, cat: str) -> int:
        tid = self._tids.get(cat)
        if tid is None:
            with self._lock:
                tid = self._tids.get(cat)
                if tid is None:
                    tid = max(self._tids.values()) + 1
                    self._tids[cat] = tid
        return tid

    # -- timestamps -------------------------------------------------------
    def _ts(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 3)

    def now_us(self) -> float:
        """Recorder-relative microseconds: the clock a replication hello
        frame carries, so two processes' traces can be aligned."""
        return self._ts(self.clock())

    def set_anchor(self, name: str, value: Optional[float] = None) -> None:
        """Pin a named clock reading (now by default), exported in
        otherData."""
        self.anchors[name] = self.now_us() if value is None else value

    def sync_device_clock(self, device, name: str = "device_sync_us"
                          ) -> Any:
        """Put a device trace on this recorder's clock. Launch a
        one-element fill and wait for it (the first launch of a profiler
        session can start half a millisecond late), then CLOCK_FILLS times:
        wait for the device, read this clock, launch the fill again. The
        readings are pinned as the anchor `name` (a list of µs, exported in
        otherData); a profiler's start times of those fills, less the
        readings, give its clock's offset from this one to within the
        fastest launch's latency. Returns the fill's tensor."""
        import torch

        d = torch.device(device)
        marker = torch.zeros(1, device=d)
        readings = []
        for i in range(CLOCK_FILLS):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
            readings.append(self.now_us())
            marker.fill_(float(i))
        self.anchors[name] = readings
        return marker

    # -- trace-context stamping -------------------------------------------
    def _stamp(self, ev: Dict[str, Any]) -> None:
        """Attach the active TraceContext's ids to an event's args: one
        contextvar read an event, nothing when no context is active."""
        ctx = _current_trace()
        if ctx is not None:
            args = ev.get("args")
            if args is None:
                args = ev["args"] = {}
            args.setdefault("trace_id", ctx.trace_id)
            args.setdefault("span_id", ctx.span_id)

    # -- recording --------------------------------------------------------
    def span(self, name: str, cat: str = "host", device=None) -> Span:
        """A live span. device: a CUDA device makes a ``"device"`` span
        record a CUDA event at each end as well (ignored otherwise)."""
        t0 = self.clock()
        cuda = None
        if cat == "device":
            stream = _cuda_stream(device)
            if stream is not None:
                # the start event is recorded after the host's t0 and the
                # end event before its t1, so the device interval falls
                # inside the wall even with the card idle at both ends
                cuda = (stream, _cuda_event(stream))
        return Span(self, name, cat, t0, cuda)

    def _finish(self, span: Span) -> None:
        end_event = (_cuda_event(span.cuda[0]) if span.cuda is not None
                     else None)
        t1 = self.clock()
        ev: Dict[str, Any] = {
            "name": span.name,
            "cat": span.cat,
            "ph": "X",
            "ts": self._ts(span.t0),
            "dur": round((t1 - span.t0) * 1e6, 3),
            "pid": self.pid,
            "tid": self._tid(span.cat),
        }
        if span.args:
            ev["args"] = span.args
        self._stamp(ev)
        if end_event is not None:
            with self._lock:
                self._pending.append((ev, span.cuda[1], end_event))
                if len(self._pending) >= _PENDING_SWEEP:
                    self._resolve_locked(wait=False)
        self._append(ev)

    def _resolve_locked(self, wait: bool) -> None:
        """Read the device time of pending CUDA event pairs into their
        events' ``args.device_us``: all of them (waiting for the device)
        when `wait`, else only those the device has passed already."""
        keep = []
        for ev, start, end in self._pending:
            if not wait and not end.query():
                keep.append((ev, start, end))
                continue
            end.synchronize()
            args = ev.get("args")
            if args is None:
                args = ev["args"] = {}
            args["device_us"] = round(start.elapsed_time(end) * 1e3, 3)
        self._pending = keep

    def resolve_device_times(self) -> None:
        """Read every pending device span's CUDA-event time. Export calls
        this; it waits for the device, so it never runs inside a span."""
        with self._lock:
            self._resolve_locked(wait=True)

    def add_span(self, name: str, cat: str, t0: float, t1: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a span from explicit clock readings (e.g. queue wait)."""
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": self._ts(t0),
            "dur": round((t1 - t0) * 1e6, 3),
            "pid": self.pid,
            "tid": self._tid(cat),
        }
        if args:
            ev["args"] = args
        self._stamp(ev)
        self._append(ev)

    def instant(self, name: str, cat: str = "host",
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "g",
            "ts": self._ts(self.clock()),
            "pid": self.pid,
            "tid": self._tid(cat),
        }
        if args:
            ev["args"] = args
        self._stamp(ev)
        self._append(ev)

    def _flow(self, ph: str, name: str, flow_id: str, cat: str,
              args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "id": str(flow_id),
            "ts": self._ts(self.clock()),
            "pid": self.pid,
            "tid": self._tid(cat),
        }
        if ph == "f":
            # bind to the enclosing slice's end, so the arrow lands on the
            # consuming span
            ev["bp"] = "e"
        if args:
            ev["args"] = args
        self._stamp(ev)
        self._append(ev)

    def flow_start(self, name: str, flow_id: str, cat: str = "host",
                   args: Optional[Dict[str, Any]] = None) -> None:
        """Chrome flow start ('s'): the producing side of a cross-thread
        hand-off, matched to flow_end by (cat, id)."""
        self._flow("s", name, flow_id, cat, args)

    def flow_end(self, name: str, flow_id: str, cat: str = "host",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Chrome flow finish ('f'): the consuming side of the hand-off."""
        self._flow("f", name, flow_id, cat, args)

    def tail(self, limit: int = 100) -> List[Dict[str, Any]]:
        """The most recent events, oldest first: copies, taken under the
        lock. The telemetry server reads it from a thread of its own, so it
        waits for no device: a device span gets its ``device_us`` here only
        if the card has passed its end event already (export reads the
        rest)."""
        with self._lock:
            self._resolve_locked(wait=False)
            events = [dict(ev, args=dict(ev["args"])) if "args" in ev
                      else dict(ev) for ev in self.events]
        _metrics.register().trace_ring_events.set(len(events))
        if limit > 0:
            events = events[-limit:]
        return events

    # -- export -----------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        self.resolve_device_times()
        with self._lock:
            events = list(self.events)
            tids = sorted(self._tids.items(), key=lambda kv: kv[1])
        meta = [
            {"name": "process_name", "ph": "M", "ts": 0, "pid": self.pid,
             "tid": 0, "args": {"name": self.process_name}},
        ]
        for cat, tid in tids:
            meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                         "pid": self.pid, "tid": tid, "args": {"name": cat}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"pid": self.pid,
                              "process_name": self.process_name,
                              "anchors": dict(self.anchors)}}

    def to_chrome_json(self) -> str:
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":")) + "\n"

    def to_jsonl(self) -> str:
        self.resolve_device_times()
        with self._lock:
            events = list(self.events)
        return "".join(
            json.dumps(ev, sort_keys=True, separators=(",", ":")) + "\n"
            for ev in events)

    def write(self, path: str) -> None:
        """Chrome trace for ``.json``, raw span stream for ``.jsonl``."""
        text = (self.to_jsonl() if path.endswith(".jsonl")
                else self.to_chrome_json())
        with open(path, "w") as f:
            f.write(text)


# -- trace-context bridge (lazy: tracectx imports this module) -----------

_tracectx: Any = None


def _current_trace() -> Any:
    global _tracectx
    if _tracectx is None:
        from tpusim_torch.obs import tracectx
        _tracectx = tracectx
    return _tracectx.current()


# -- module-level active recorder ----------------------------------------

_active: Optional[FlightRecorder] = None


def install(rec: FlightRecorder) -> FlightRecorder:
    global _active
    _active = rec
    return rec


def uninstall() -> None:
    global _active
    _active = None


def get_recorder() -> Optional[FlightRecorder]:
    return _active


def span(name: str, cat: str = "host", device=None) -> Any:
    """A live Span when a recorder is installed, else the shared no-op.

    Takes no args kwargs: attach labels through ``span.set`` inside an
    ``if sp:`` guard, so the disabled path allocates nothing. device: the
    torch device a ``"device"`` span's work runs on (CUDA event timing on
    a CUDA device)."""
    rec = _active
    if rec is None:
        return NOOP_SPAN
    return rec.span(name, cat, device)


def instant(name: str, cat: str = "host",
            args: Optional[Dict[str, Any]] = None) -> None:
    rec = _active
    if rec is not None:
        rec.instant(name, cat, args)


def flow_start(name: str, flow_id: str, cat: str = "host", site: str = "",
               args: Optional[Dict[str, Any]] = None) -> None:
    """Emit a flow start ('s') on the active recorder and count it under
    tpusim_trace_flows_total{site}; a no-op when tracing is off."""
    rec = _active
    if rec is not None:
        rec.flow_start(name, flow_id, cat, args)
        if site:
            _metrics.register().trace_flows.inc(site)


def flow_end(name: str, flow_id: str, cat: str = "host",
             args: Optional[Dict[str, Any]] = None) -> None:
    rec = _active
    if rec is not None:
        rec.flow_end(name, flow_id, cat, args)


# -- telemetry bridges (metrics registry + recorder instants) ------------

def note_route(route: str, pods: Optional[int] = None) -> None:
    """A batch's execution route: the torch backend's kernel, scan and
    reference, or a runtime's overlay_fallback."""
    _metrics.register().backend_route.inc(route)
    rec = _active
    if rec is not None:
        rec.instant("route:" + route, "device",
                    {"pods": pods} if pods is not None else None)


def note_fast_fallback(reason: str, detail: Optional[str] = None) -> None:
    """plan_fast refused a batch: `reason` is the low-cardinality blocker
    class (backend.fast_fallback_key), `detail` the full reason string
    (trace only: too high-cardinality for a metric label)."""
    rec = _active
    if rec is not None:
        rec.instant("fallback:" + reason, "device",
                    {"why": detail} if detail is not None else None)


def note_victim_path(path: str) -> None:
    """A preemption's victim-selection path: device or host (mirrors
    preempt.PREEMPT_CLASS_STATS)."""
    _metrics.register().backend_victim_path.inc(path)
    rec = _active
    if rec is not None:
        rec.instant("victim:" + path, "device")


def note_gang(event: str, args: Optional[Dict[str, Any]] = None) -> None:
    """A gang admission decision: admit/reject/rollback/release. The
    matching counters (gang_admitted/gang_rejected/gang_partial_rollback)
    are incremented by the caller, which knows the reason label; this bridge
    only emits the recorder instant."""
    rec = _active
    if rec is not None:
        rec.instant("gang:" + event, "host", args)


def note_fault(kind: str, args: Optional[Dict[str, Any]] = None) -> None:
    """A chaos-injected fault: node_delete/node_cordon/node_flap/
    node_restore/pod_evict, watch_drop/watch_dup/watch_disconnect,
    device_exception/device_corrupt_*, gang_release, process_crash,
    invariant_violation."""
    _metrics.register().fault_injected.inc(kind)
    rec = _active
    if rec is not None:
        rec.instant("fault:" + kind, "host", args)


def note_breaker(name: str, transition: str, state_value: float,
                 detail: Optional[str] = None) -> None:
    """A dispatch circuit-breaker transition: open/half_open/reopen/close.
    Mirrors the live state into the tpusim_breaker_state gauge."""
    reg = _metrics.register()
    reg.breaker_transitions.inc(transition)
    reg.breaker_state.set(state_value)
    rec = _active
    if rec is not None:
        args: Dict[str, Any] = {"breaker": name}
        if detail:
            args["detail"] = detail
        rec.instant("breaker:" + transition, "device", args)


def note_serve(event: str, args: Optional[Dict[str, Any]] = None) -> None:
    """A scenario-fleet lifecycle point: admit/reject/bucket/dispatch/
    overlay/overlay_resolve. Request-scoped phases also open `serve:*`
    spans at the call sites; these instants mark the zero-duration
    transitions between them."""
    rec = _active
    if rec is not None:
        rec.instant("serve:" + event, "host", args)


def note_recovery(event: str, args: Optional[Dict[str, Any]] = None) -> None:
    """A crash-recovery point of stream.persist: checkpoint / replay. The
    latencies land in the tpusim_recovery_* histograms at the call sites;
    the replay itself also runs under a `recover:replay` span."""
    rec = _active
    if rec is not None:
        rec.instant("recover:" + event, "host", args)


def note_serve_retry(reason: str,
                     args: Optional[Dict[str, Any]] = None) -> None:
    """The serve fleet retried work after a fault: device_fault (an injected
    dispatch death), worker_death (the processing thread died mid-request
    and the request was requeued at most once)."""
    _metrics.register().serve_retry.inc(reason)
    rec = _active
    if rec is not None:
        rec.instant("serve_retry:" + reason, "host", args)


def note_serve_degraded(path: str,
                        args: Optional[Dict[str, Any]] = None) -> None:
    """A serve bucket answered through a degraded path: breaker_open /
    retry_exhausted (the host pipeline answered) or verify_divergence (host
    results replaced the suspect device output)."""
    _metrics.register().serve_degraded.inc(path)
    rec = _active
    if rec is not None:
        rec.instant("serve_degraded:" + path, "host", args)


def note_stream_restage(reason: str, detail: Optional[str] = None) -> None:
    """The stream runtime dropped its device-resident state and paid a full
    restage: `reason` is the low-cardinality residency-miss class
    (cold_start/policy_plan_change/node_set/groups_dirty/scalar_set/
    new_signature/sig_evict/group_shape/interpod_delta/forced_restage/
    reference_fallback and the forced reasons), `detail` trace-only
    context."""
    _metrics.register().stream_restage.inc(reason)
    rec = _active
    if rec is not None:
        rec.instant("restage:" + reason, "device",
                    {"why": detail} if detail is not None else None)


def note_stream_cycle(path: str, pods: Optional[int] = None) -> None:
    """One StreamSession cycle: stream_scan (resident dispatch), pipelined
    (resident dispatch with deferred decode), restage_scan (full restage and
    dispatch), host (the reference route), gang (a group cycle through the
    gang driver) or no_nodes (nothing to dispatch)."""
    _metrics.register().stream_cycles.inc(path)
    rec = _active
    if rec is not None:
        rec.instant("stream:" + path, "device",
                    {"pods": pods} if pods is not None else None)


def note_slo(event: str, args: Optional[Dict[str, Any]] = None) -> None:
    """An SLO burn-rate threshold crossing (obs.slo): burn_start when the
    windowed burn rate rises to or above the alerting threshold, burn_end
    when it falls back under. The live burn rate is the tpusim_slo_burn_rate
    gauge; these instants put the crossings on the timeline."""
    rec = _active
    if rec is not None:
        rec.instant("slo:" + event, "host", args)


def note_watch_overflow(resource: str) -> None:
    """A watch stream died on buffer overflow (the "410 Gone" analog): the
    consumer must relist to resync."""
    _metrics.register().watch_overflow.inc(resource)
    rec = _active
    if rec is not None:
        rec.instant("watch_overflow", "host", {"resource": resource})

