"""Pod-group annotations and feed planning.

A pod names its group with the pod-group.tpusim.io/name annotation (the
kube-batch / coscheduling lineage), with an optional min-available floor, so
podspecs, the load generator and watch events carry gangs with no new type.
A gang is admitted all or nothing: by the host orchestrator
(simulator.ClusterCapacity) on the host route, by gang.driver on the device
routes and in the streaming twin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from tpusim_torch.api.types import Pod

GANG_NAME_ANNOTATION = "pod-group.tpusim.io/name"
GANG_MIN_AVAILABLE_ANNOTATION = "pod-group.tpusim.io/min-available"


def gang_name(pod: Pod) -> str:
    """The pod's group name, or "" for an ungrouped pod."""
    annotations = pod.metadata.annotations
    if not annotations:
        return ""
    return str(annotations.get(GANG_NAME_ANNOTATION, "") or "")


def gang_min_available(pod: Pod) -> int:
    """The pod's declared min-available floor; 0 = "all members"."""
    annotations = pod.metadata.annotations
    if not annotations:
        return 0
    raw = annotations.get(GANG_MIN_AVAILABLE_ANNOTATION, "")
    try:
        return max(0, int(raw))
    except (TypeError, ValueError):
        return 0


def mark_gang(pod: Pod, name: str, min_available: int = 0) -> Pod:
    """Stamp the group annotations onto `pod` (in place) and return it."""
    pod.metadata.annotations[GANG_NAME_ANNOTATION] = name
    if min_available:
        pod.metadata.annotations[GANG_MIN_AVAILABLE_ANNOTATION] = \
            str(min_available)
    return pod


def has_gangs(pods: Sequence[Pod]) -> bool:
    """True when any pod in the batch carries a group annotation: the only
    trigger of the gang paths, so a gang-free feed runs the code it ran
    before them."""
    return any(gang_name(p) for p in pods)


@dataclass
class PodGroup:
    """One gang, in feed order."""

    name: str
    pods: List[Pod] = field(default_factory=list)

    @property
    def min_available(self) -> int:
        """The group's admission floor: the max declared min-available
        across members (they should agree), defaulting to the full group
        size — plain gangs are strictly all-or-nothing."""
        declared = max((gang_min_available(p) for p in self.pods), default=0)
        if declared <= 0:
            return len(self.pods)
        return min(declared, len(self.pods))


@dataclass
class FeedSegment:
    """A contiguous run of the feed: either ungrouped pods (scheduled pod by
    pod) or one complete gang."""

    pods: Optional[List[Pod]] = None
    group: Optional[PodGroup] = None


def split_feed(pods: Sequence[Pod]) -> List[FeedSegment]:
    """Partition a feed into ordered segments: maximal runs of ungrouped pods
    and complete gangs. A gang's decision point is its FIRST member's feed
    position; members arriving later in the feed are pulled forward into the
    group (as the queue gathers them from the pending pods)."""
    segments: List[FeedSegment] = []
    groups: dict = {}
    run: List[Pod] = []
    for pod in pods:
        name = gang_name(pod)
        if not name:
            run.append(pod)
            continue
        group = groups.get(name)
        if group is None:
            if run:
                segments.append(FeedSegment(pods=run))
                run = []
            group = PodGroup(name=name)
            groups[name] = group
            segments.append(FeedSegment(group=group))
        group.pods.append(pod)
    if run:
        segments.append(FeedSegment(pods=run))
    return segments


def gang_fit_message(group: PodGroup, num_nodes: int, placed: int) -> str:
    """The single FitError message shared by every member of a rejected
    gang: the group identity and the shortfall, not a per-member reason
    histogram (the decision is joint, so the attribution is too)."""
    return (f"0/{num_nodes} nodes are available: pod group "
            f"\"{group.name}\" requires {group.min_available}/"
            f"{len(group.pods)} members, only {placed} fit jointly.")
