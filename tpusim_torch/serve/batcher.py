"""Shape-class batcher: staged requests grouped into fixed-shape buckets.

A bucket's key is (ShapeClass, plan signature), both functions of the
request's content, and entries join buckets in arrival order. A bucket
dispatches when full (bucket_size entries) or when its oldest entry has
waited `flush_after_s`; the executor then pads it with ghost scenarios, so
the program's shape never changes. The clock is injected for deterministic
deadline tests.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpusim_torch.serve.request import ShapeClass, WhatIfRequest

BucketKey = Tuple[ShapeClass, Any]  # (shape class, policy plan signature)


@dataclass
class PendingEntry:
    """One admitted request staged to host trees, waiting for a bucket."""

    request: WhatIfRequest
    staged: Any  # whatif.StagedScenario
    future: Any  # concurrent.futures.Future[WhatIfResponse]
    admitted_at: float
    shape_class: ShapeClass
    plan_sig: Any
    cp: Any = None  # compiled policy (shared across the bucket)
    hard_weight: int = 10


@dataclass
class Bucket:
    key: BucketKey
    size: int  # the fixed scenario count (ghosts fill the gap)
    entries: List[PendingEntry] = field(default_factory=list)

    @property
    def ghosts(self) -> int:
        return self.size - len(self.entries)


class ShapeClassBatcher:
    def __init__(self, bucket_size: int = 4, flush_after_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if bucket_size < 1:
            raise ValueError(f"bucket_size={bucket_size}: need at least 1")
        self.bucket_size = bucket_size
        self.flush_after_s = flush_after_s
        self._clock = clock
        self._open: Dict[BucketKey, Bucket] = {}

    def pending(self) -> int:
        return sum(len(b.entries) for b in self._open.values())

    def add(self, entry: PendingEntry) -> Optional[Bucket]:
        """File the entry under its bucket key; returns the bucket when the
        entry fills it (the caller dispatches it), else None."""
        key = (entry.shape_class, entry.plan_sig)
        bucket = self._open.get(key)
        if bucket is None:
            bucket = self._open[key] = Bucket(key=key, size=self.bucket_size)
        bucket.entries.append(entry)
        if len(bucket.entries) >= self.bucket_size:
            del self._open[key]
            return bucket
        return None

    def _deadline(self, bucket: Bucket) -> float:
        return bucket.entries[0].admitted_at + self.flush_after_s

    def next_deadline(self) -> Optional[float]:
        """The earliest partial bucket's deadline (clock units), or None
        when nothing waits: the service loop's wait bound."""
        if not self._open:
            return None
        return min(self._deadline(b) for b in self._open.values())

    def due(self) -> List[Bucket]:
        """Remove and return every partial bucket whose oldest entry has
        waited past flush_after_s."""
        now = self._clock()
        ready = [key for key, b in self._open.items()
                 if now >= self._deadline(b)]
        return [self._open.pop(key) for key in ready]

    def flush_all(self) -> List[Bucket]:
        """Remove and return every open bucket (drain and shutdown)."""
        buckets = list(self._open.values())
        self._open.clear()
        return buckets
