"""Pod-group (gang) annotations: the port's own copy of the detector, the
group and its shared FitError text.

A pod names its group with the pod-group.tpusim.io/name annotation (the
kube-batch / coscheduling lineage), with an optional min-available floor. A
gang is admitted all or nothing. The host orchestrator
(simulator.ClusterCapacity) admits gangs; the device routes have no gang
driver yet, so run_simulation refuses a gang feed on backend "torch".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

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


def has_gangs(pods: Sequence[Pod]) -> bool:
    """True when any pod in the batch carries a group annotation."""
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


def gang_fit_message(group: PodGroup, num_nodes: int, placed: int) -> str:
    """The single FitError message shared by every member of a rejected
    gang: the group identity and the shortfall, not a per-member reason
    histogram (the decision is joint, so the attribution is too)."""
    return (f"0/{num_nodes} nodes are available: pod group "
            f"\"{group.name}\" requires {group.min_available}/"
            f"{len(group.pods)} members, only {placed} fit jointly.")
