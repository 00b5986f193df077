"""Watch streams, their wire frames, the event-log reader and the event
recorder.

Reference: pkg/framework/watch/watch.go (WatchBuffer: an io.ReadCloser JSON
frame stream fed by EmitWatchEvent) and pkg/framework/record/recorder.go
(channel-backed EventRecorder, buffer 10, drained one event per Bind/Update).

The WatchBuffer here is a bounded queue of (type, object) frames with
replay-current-objects-as-Added semantics on subscribe (restclient.go:380-426),
not the reference's hand-rolled reader/writer lock. A recorded stream
replays through load_event_log.
"""

from __future__ import annotations

import io
import json
import queue
from dataclasses import dataclass
from typing import Iterator, Optional

from tpusim_torch.api.types import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    ResourceType,
    Service,
)
from tpusim_torch.framework.store import (
    ADDED,
    DELETED,
    MODIFIED,
    ResourceStore,
)


@dataclass
class WatchEvent:
    type: str   # ADDED | MODIFIED | DELETED
    object: object

    def to_frame(self) -> str:
        """The JSON wire frame the reference streams (watch.go:99-125);
        event types are capitalized on the wire ("Added"/"Modified"/"Deleted")."""
        return json.dumps({"type": self.type.capitalize(),
                           "object": self.object.to_obj()}, sort_keys=True)


# A lagging watcher's buffered window is finite, like an apiserver's etcd
# watch cache: past this many undrained frames the stream dies with the
# "410 Gone" analog and the consumer must relist (WatchExpiredError).
DEFAULT_WATCH_BUFFER_SIZE = 4096


class WatchExpiredError(Exception):
    """The watch stream's buffered window is gone: the apiserver's "410
    Gone" or "too old resource version". The consumer cannot resume from
    where it was; it must relist and watch again (framework/reflector.py)."""

    code = 410


class WatchBuffer:
    """A bounded FIFO of watch events; close() wakes readers.

    Overflow tears the stream: the queued frames nobody drained are dropped
    (that window is what the consumer can no longer trust) and every later
    read() raises WatchExpiredError."""

    _CLOSED = object()
    _ERROR = object()

    def __init__(self, maxsize: int = DEFAULT_WATCH_BUFFER_SIZE,
                 resource: str = ""):
        # one slot more, so the error sentinel always fits after a drain
        self._q: queue.Queue = queue.Queue(maxsize=maxsize + 1 if maxsize
                                           else 0)
        self.maxsize = maxsize
        self.resource = resource
        self.closed = False
        self.error: Optional[Exception] = None

    def emit(self, event_type: str, obj) -> None:
        if self.closed:
            return
        if self.maxsize and self._q.qsize() >= self.maxsize:
            self._overflow()
            return
        self._q.put(WatchEvent(event_type, obj))

    def _overflow(self) -> None:
        from tpusim_torch.obs.recorder import note_watch_overflow

        note_watch_overflow(self.resource or "unknown")
        self.close_with_error(WatchExpiredError(
            f"watch buffer overflow ({self.maxsize} undrained frames) on "
            f"{self.resource or 'stream'}: too old resource version"),
            drop_pending=True)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._q.put(self._CLOSED)

    def close_with_error(self, exc: Exception,
                         drop_pending: bool = False) -> None:
        """End the stream with a transport error: readers drain the frames
        that survive, then read() raises `exc` (once a call)."""
        if self.closed:
            return
        self.closed = True
        self.error = exc
        if drop_pending:
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        self._q.put(self._ERROR)

    def read(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._ERROR:
            self._q.put(self._ERROR)  # every later read fails too
            raise self.error
        if item is self._CLOSED:
            return None
        return item

    def __iter__(self) -> Iterator[WatchEvent]:
        while True:
            ev = self.read(timeout=0)
            if ev is None:
                return
            yield ev

    def drain(self, limit: Optional[int] = None) -> list:
        """Non-blocking batch read: every frame queued now (up to `limit`)
        as a list. An expired stream raises WatchExpiredError as read()
        does, but never swallows frames: the frames read before the error
        sentinel are returned, and the NEXT drain() raises."""
        out: list = []
        while limit is None or len(out) < limit:
            try:
                ev = self.read(timeout=0)
            except WatchExpiredError:
                if out:
                    return out
                raise
            if ev is None:
                break
            out.append(ev)
        return out


def watch_resource(store: ResourceStore, resource: ResourceType) -> WatchBuffer:
    """Subscribe to a resource: the current objects replay as ADDED, then
    the live events stream (restclient.go:380-426 list and watch)."""
    buf = WatchBuffer(resource=resource.value)
    for obj in store.list(resource):
        buf.emit(ADDED, obj)
    store.register_event_handler(resource, buf.emit)
    return buf


_EVENT_KINDS = {"Pod": Pod, "Node": Node, "Service": Service,
                "PersistentVolume": PersistentVolume,
                "PersistentVolumeClaim": PersistentVolumeClaim}


def load_event_log(path: str) -> list:
    """Parse a watch-event log: JSON lines in the reference's wire-frame shape
    {"type": "Added|Modified|Deleted", "object": {kind, ...}} (watch.go:99-125;
    WatchEvent.to_frame writes the same format). Returns
    [(EVENT_TYPE, obj), ...] ready for delta.IncrementalCluster.apply_events
    and run_simulation(events=...). A bad line raises ValueError naming the
    file and line."""
    valid = {ADDED, MODIFIED, DELETED}
    events = []
    with io.open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                frame = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: not JSON: {exc}") from exc
            event_type = str(frame.get("type", "")).upper()
            if event_type not in valid:
                raise ValueError(f"{path}:{lineno}: unknown event type "
                                 f"{frame.get('type')!r}")
            obj = frame.get("object") or {}
            if not isinstance(obj, dict):
                raise ValueError(f"{path}:{lineno}: \"object\" must be a "
                                 f"JSON object, got {type(obj).__name__}")
            cls = _EVENT_KINDS.get(obj.get("kind", ""))
            if cls is None:
                raise ValueError(f"{path}:{lineno}: unsupported object kind "
                                 f"{obj.get('kind')!r} (expected Pod/Node/"
                                 "Service/PersistentVolume/"
                                 "PersistentVolumeClaim)")
            try:
                events.append((event_type, cls.from_obj(obj)))
            except (TypeError, AttributeError, KeyError) as exc:
                raise ValueError(
                    f"{path}:{lineno}: malformed {obj.get('kind')} object: "
                    f"{exc}") from exc
    return events


@dataclass
class Event:
    """client-go record.Event essentials."""

    object_kind: str = ""
    object_name: str = ""
    event_type: str = ""   # Normal | Warning
    reason: str = ""
    message: str = ""


class Recorder:
    """Bounded event sink. Reference: record/recorder.go:33-61 — the simulator
    creates it with capacity 10 (simulator.go:240) and drains one event per
    Bind/Update completion."""

    def __init__(self, buffer_size: int = 10):
        self.events: queue.Queue = queue.Queue(maxsize=buffer_size)

    def eventf(self, obj, event_type: str, reason: str, message_fmt: str,
               *args) -> None:
        event = Event(object_kind=getattr(obj, "kind", ""),
                      object_name=getattr(obj, "name", ""),
                      event_type=event_type, reason=reason,
                      message=(message_fmt % args) if args else message_fmt)
        try:
            self.events.put_nowait(event)
        except queue.Full:
            pass  # reference behavior: the channel blocks; we drop instead of deadlock

    def drain_one(self, timeout: float = 0.0) -> Optional[Event]:
        try:
            return self.events.get(timeout=timeout) if timeout else self.events.get_nowait()
        except queue.Empty:
            return None
