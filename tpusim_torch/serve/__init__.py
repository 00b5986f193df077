"""Scenario fleet: the what-if capacity-planning service.

A front over tpusim_torch.whatif: requests are admitted through a bounded
queue, bucketed into fixed shape classes and dispatched, full or padded with
ghost scenarios, as one batched program a bucket. See service.ScenarioFleet
for the life of a request.
"""

from tpusim_torch.serve.batcher import Bucket, PendingEntry, ShapeClassBatcher
from tpusim_torch.serve.executor import ServeExecutor
from tpusim_torch.serve.queue import AdmissionQueue
from tpusim_torch.serve.request import (
    REJECT_DEADLINE,
    REJECT_INVALID,
    REJECT_QUEUE_FULL,
    REJECT_SHED,
    REJECT_SHUTDOWN,
    REJECT_UNKNOWN_SNAPSHOT,
    REJECT_UNSUPPORTED,
    ServeRejected,
    ShapeClass,
    WhatIfRequest,
    WhatIfResponse,
    shape_class_for,
)
from tpusim_torch.serve.service import ScenarioFleet

__all__ = [
    "AdmissionQueue",
    "Bucket",
    "PendingEntry",
    "REJECT_DEADLINE",
    "REJECT_INVALID",
    "REJECT_QUEUE_FULL",
    "REJECT_SHED",
    "REJECT_SHUTDOWN",
    "REJECT_UNKNOWN_SNAPSHOT",
    "REJECT_UNSUPPORTED",
    "ScenarioFleet",
    "ServeExecutor",
    "ServeRejected",
    "ShapeClass",
    "ShapeClassBatcher",
    "WhatIfRequest",
    "WhatIfResponse",
    "shape_class_for",
]
