"""Scenario-fleet request and response types, and shape classes.

A `WhatIfRequest` is one capacity question ("will these pods fit on this
cluster?") against an inline snapshot or a `snapshot_ref` registered with the
fleet. Requests are bucketed by `ShapeClass`: a fixed (node, pod, axis
budget) padding target, each dimension rounded up to a power of two, so that
every bucket of a class runs through one built batched program instead of a
new one for each request shape.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod
from tpusim_torch.whatif import WhatIfResult, _axis_targets

# why a request was not run (WhatIfResponse.rejected)
REJECT_QUEUE_FULL = "queue_full"
REJECT_INVALID = "invalid"
REJECT_UNKNOWN_SNAPSHOT = "unknown_snapshot"
REJECT_UNSUPPORTED = "unsupported"
REJECT_SHUTDOWN = "shutdown"
REJECT_DEADLINE = "deadline"   # its deadline expired before it dispatched
REJECT_SHED = "shed"           # evicted by a higher-priority newcomer


class ServeRejected(Exception):
    """A request the fleet will not run; `reason` is a REJECT_* value,
    str(exc) the detail returned to the caller."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


_ids = itertools.count()


@dataclass
class WhatIfRequest:
    """One capacity query. `cache_key` is an optional caller-chosen identity
    of the (snapshot, pods) content: requests that carry one are eligible
    for the staged-scenario and device-batch caches (a repeat query skips
    the host compile and the upload). Callers must not reuse a key for
    different content."""

    pods: List[Pod]
    snapshot: Optional[ClusterSnapshot] = None
    snapshot_ref: Optional[str] = None
    policy: Any = None
    cache_key: Optional[str] = None
    # deadline_s: the longest admission-to-dispatch age before the request
    # is rejected REJECT_DEADLINE instead of run (None: the fleet's).
    # priority: on a full admission queue, a newcomer sheds the earliest
    # waiter of the lowest priority if that is strictly lower (REJECT_SHED)
    deadline_s: Optional[float] = None
    priority: int = 0
    request_id: str = field(default_factory=lambda: f"req-{next(_ids)}")


@dataclass
class WhatIfResponse:
    request_id: str
    result: Optional[WhatIfResult] = None
    error: Optional[str] = None
    rejected: Optional[str] = None  # a REJECT_* reason, None if admitted
    bucket_real: int = 0    # real scenarios in the dispatched bucket
    bucket_ghosts: int = 0  # ghost scenarios the bucket was padded with
    compile_cache_hit: bool = False  # its bucket ran a program built before
    latency_s: float = 0.0  # admission -> decoded result

    @property
    def ok(self) -> bool:
        return self.rejected is None and self.error is None


def _budget(n: int, floor: int = 4) -> int:
    """Next power of two >= n, at least `floor`: the shape-class rounding
    (a 3-node and a 4-node cluster share a program)."""
    return max(floor, 1 << max(0, (int(n) - 1).bit_length()))


@dataclass(frozen=True)
class ShapeClass:
    """A fixed padding target: node and pod extents and a budget for every
    named non-node axis of the axis registries. Two requests of one class
    have the same array shapes after padding, so they share a bucket and a
    built program."""

    n_nodes: int
    n_pods: int
    axes: Tuple[Tuple[str, int], ...]  # sorted (axis name, budget)

    @property
    def targets(self) -> Dict[str, int]:
        return dict(self.axes)

    def describe(self) -> str:
        return f"nodes<={self.n_nodes} pods<={self.n_pods}"


def shape_class_for(staged) -> ShapeClass:
    """The ShapeClass of one staged scenario (whatif.StagedScenario): every
    axis the unifier pads, rounded up to its power-of-two budget."""
    targets = _axis_targets([(staged.statics, staged.carry, staged.xs)])
    return ShapeClass(
        n_nodes=_budget(staged.statics.alloc_cpu.shape[0]),
        n_pods=_budget(staged.xs.req_cpu.shape[0]),
        axes=tuple(sorted((name, _budget(size))
                          for name, size in targets.items())))
