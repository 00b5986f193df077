"""The event recorder.

Reference: pkg/framework/record/recorder.go (channel-backed EventRecorder,
buffer 10, drained one event per Bind/Update). The watch streams of the
reference's framework/watch are not ported yet.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass
from typing import Optional


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
