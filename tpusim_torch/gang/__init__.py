"""Gang admission: all-or-nothing pod-group scheduling.

Pods carrying the ``pod-group.tpusim.io/name`` annotation are admitted as a
group: either at least ``min-available`` members place together against one
consistent picture of the cluster, or the whole gang is rejected with one
shared FitError and no bind. Placement is rank-aware: members pack toward
the zone and rack domains already holding their mates, solved jointly from
the scan's per-member feasibility and score lanes (scan.gang_lanes) by the
packing solve on the device (scan.gang_select) or its numpy oracle
(oracle.select_oracle).

The member lanes are evaluated against one frozen picture and the joint
solve re-checks capacity arithmetically as members stack, so the decision
is a consistent group admission, not optimistic multi-pod placement.
"""

from tpusim_torch.gang.group import (
    GANG_MIN_AVAILABLE_ANNOTATION,
    GANG_NAME_ANNOTATION,
    FeedSegment,
    PodGroup,
    gang_fit_message,
    gang_min_available,
    gang_name,
    has_gangs,
    mark_gang,
    split_feed,
)

__all__ = [
    "GANG_NAME_ANNOTATION",
    "GANG_MIN_AVAILABLE_ANNOTATION",
    "FeedSegment",
    "PodGroup",
    "gang_fit_message",
    "gang_name",
    "gang_min_available",
    "has_gangs",
    "mark_gang",
    "split_feed",
]
