"""Bounded admission queue of the scenario fleet.

Backpressure lives here, not in the batcher: a full queue rejects at submit
time, so callers see overload at once instead of a latency that grows
without bound; or, when the newcomer outranks a waiter, it sheds the
earliest entry of the lowest priority instead (`offer`). Every transition
sets the tpusim_serve_queue_depth gauge.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional, Tuple

from tpusim_torch.framework.metrics import register


class AdmissionQueue:
    """Thread-safe bounded FIFO with priority-aware shedding. `put`/`offer`
    never block; `pop` optionally waits. Closing wakes every waiter; a
    closed queue still drains what it holds."""

    def __init__(self, maxsize: int = 256):
        if maxsize < 1:
            raise ValueError(f"maxsize={maxsize}: need at least 1")
        self.maxsize = maxsize
        self._items: deque = deque()   # (item, priority)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def put(self, item: Any, priority: int = 0) -> bool:
        admitted, _ = self.offer(item, priority=priority, shed=False)
        return admitted

    def offer(self, item: Any, priority: int = 0,
              shed: bool = True) -> Tuple[bool, Optional[Any]]:
        """Admit `item`: (admitted, shed victim). On a full queue with
        `shed`, the earliest waiter of the lowest priority is evicted, but
        only when it ranks strictly below the newcomer, so saturated traffic
        of one priority is rejected queue_full instead of churning."""
        with self._lock:
            if self._closed:
                return False, None
            if len(self._items) < self.maxsize:
                self._items.append((item, priority))
                register().serve_queue_depth.set(len(self._items))
                self._nonempty.notify()
                return True, None
            if not shed:
                return False, None
            # min() is stable: the earliest entry of the lowest priority
            vi = min(range(len(self._items)),
                     key=lambda i: self._items[i][1])
            victim, victim_priority = self._items[vi]
            if victim_priority >= priority:
                return False, None
            del self._items[vi]
            self._items.append((item, priority))
            register().serve_queue_depth.set(len(self._items))
            self._nonempty.notify()
            return True, victim

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Next item, or None when empty after `timeout` (0/None: no wait).
        The wait loops on a monotonic deadline, so a spurious wakeup or a
        notify taken by a racing popper never ends it early."""
        deadline = (time.monotonic() + timeout) if timeout else None
        with self._lock:
            while not self._items:
                if deadline is None or self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._nonempty.wait(remaining)
            item, _priority = self._items.popleft()
            register().serve_queue_depth.set(len(self._items))
            return item

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
