"""Pod-group (gang) annotations: the port's own copy of the detector.

A pod names its group with the pod-group.tpusim.io/name annotation (the
kube-batch / coscheduling lineage). A gang is admitted all or nothing; the
port has no gang driver yet, so its entry points refuse a feed that holds
one instead of placing the members pod by pod.
"""

from __future__ import annotations

from typing import Sequence

from tpusim_torch.api.types import Pod

GANG_NAME_ANNOTATION = "pod-group.tpusim.io/name"


def gang_name(pod: Pod) -> str:
    """The pod's group name, or "" for an ungrouped pod."""
    annotations = pod.metadata.annotations
    if not annotations:
        return ""
    return str(annotations.get(GANG_NAME_ANNOTATION, "") or "")


def has_gangs(pods: Sequence[Pod]) -> bool:
    """True when any pod in the batch carries a group annotation."""
    return any(gang_name(p) for p in pods)
