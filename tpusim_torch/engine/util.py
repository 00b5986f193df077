"""Scheduler utilities: pod priority helpers + per-pod exponential backoff.

Reference: util/utils.go (GetPodPriority, SortableList/HigherPriorityPod) and
util/backoff_utils.go (PodBackoff: 1s initial, 60s max, doubling).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from tpusim_torch.api.types import Pod

DEFAULT_POD_PRIORITY = 0
MAX_INT32 = 2**31 - 1


def get_pod_priority(pod: Pod) -> int:
    """util.GetPodPriority: spec.priority or 0."""
    if pod.spec.priority is not None:
        return pod.spec.priority
    return DEFAULT_POD_PRIORITY


def sort_by_priority_desc(pods: list) -> list:
    """SortableList with HigherPriorityPod: highest priority first; stable."""
    return sorted(pods, key=lambda p: -get_pod_priority(p))


class BackoffEntry:
    def __init__(self):
        self.backoff = 1.0  # seconds (initial)
        self.last_update = 0.0


class PodBackoff:
    """Reference: backoff_utils.go:88-135 — exponential per-pod backoff with
    doubling up to max; entries garbage-collected by age."""

    def __init__(self, default_duration: float = 1.0, max_duration: float = 60.0,
                 clock=time.monotonic):
        self.default_duration = default_duration
        self.max_duration = max_duration
        self._clock = clock
        self._entries: Dict[str, BackoffEntry] = {}

    def get_entry(self, pod_id: str) -> BackoffEntry:
        """GetEntry also refreshes lastUpdate (backoff_utils.go:122-132)."""
        entry = self._entries.get(pod_id)
        if entry is None:
            entry = BackoffEntry()
            entry.backoff = self.default_duration
            self._entries[pod_id] = entry
        entry.last_update = self._clock()
        return entry

    def get_backoff_time(self, pod_id: str) -> float:
        """Current duration, then double it (getBackoff semantics)."""
        entry = self.get_entry(pod_id)
        duration = entry.backoff
        entry.backoff = min(duration * 2, self.max_duration)
        entry.last_update = self._clock()
        return duration

    def try_backoff_and_wait(self, pod_id: str) -> bool:
        """Non-sleeping variant used by the simulator: reports whether the pod
        is allowed to retry now (no real wall-clock waits in an offline sim).
        Reads the entry WITHOUT the GetEntry lastUpdate refresh — the elapsed
        time since the last recorded backoff is the whole question."""
        entry = self._entries.get(pod_id)
        now = self._clock()
        if entry is None:
            self.get_entry(pod_id)  # creates the entry (stamps lastUpdate)
            return True
        if now - entry.last_update >= entry.backoff:
            entry.last_update = now
            return True
        return False

    def gc(self, max_age: float = None) -> None:
        """backoff_utils.go Gc: entries idle longer than maxDuration drop."""
        if max_age is None:
            max_age = self.max_duration
        now = self._clock()
        stale = [k for k, e in self._entries.items()
                 if now - e.last_update > max_age]
        for k in stale:
            del self._entries[k]

    def clear_pod_backoff(self, pod_id: str) -> None:
        self._entries.pop(pod_id, None)
