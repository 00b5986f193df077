"""Watch-event frames, the event-log reader and the event recorder.

Reference: pkg/framework/watch/watch.go (the JSON wire frames a WatchBuffer
streams) and pkg/framework/record/recorder.go (channel-backed
EventRecorder, buffer 10, drained one event per Bind/Update). The live watch
streams of the reference's framework/watch (WatchBuffer, watch_resource) are
not ported yet; a recorded stream replays through load_event_log.
"""

from __future__ import annotations

import io
import json
import queue
from dataclasses import dataclass
from typing import Optional

from tpusim_torch.api.types import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    Service,
)
from tpusim_torch.framework.store import ADDED, DELETED, MODIFIED


@dataclass
class WatchEvent:
    type: str   # ADDED | MODIFIED | DELETED
    object: object

    def to_frame(self) -> str:
        """The JSON wire frame the reference streams (watch.go:99-125);
        event types are capitalized on the wire ("Added"/"Modified"/"Deleted")."""
        return json.dumps({"type": self.type.capitalize(),
                           "object": self.object.to_obj()}, sort_keys=True)


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
