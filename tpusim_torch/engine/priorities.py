"""The priority map functions the cluster compile step tabulates per
(signature, node) cell. MaxPriority = 10 (api/types.go:36).

Reference: node_affinity.go:34-79, node_prefer_avoid_pods.go,
image_locality.go, and utilnode.GetZoneKey (the zone domain of
SelectorSpreadPriority).
"""

from __future__ import annotations

import json
from typing import Optional

from tpusim_torch.api.types import (
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
    Node,
    Pod,
)

MAX_PRIORITY = 10


def calculate_node_affinity_priority_map(pod: Pod, node: Node) -> int:
    """Sum of the weights of the preferred node-affinity terms the node
    matches (normalized on the device over the feasible nodes)."""
    affinity = pod.spec.affinity
    count = 0
    if affinity is not None and affinity.node_affinity is not None:
        for term in affinity.node_affinity.preferred:
            if term.weight == 0:
                continue
            if term.preference.matches(node.metadata.labels):
                count += term.weight
    return count


def calculate_node_prefer_avoid_pods_priority_map(pod: Pod, node: Node) -> int:
    """0 when the node's preferAvoidPods annotation names the pod's
    ReplicationController/ReplicaSet, else MAX_PRIORITY."""
    controller_ref = pod.metadata.controller_ref()
    if controller_ref is not None and controller_ref.kind not in (
            "ReplicationController", "ReplicaSet"):
        controller_ref = None
    if controller_ref is None:
        return MAX_PRIORITY
    ann = node.metadata.annotations.get("scheduler.alpha.kubernetes.io/preferAvoidPods")
    if not ann:
        return MAX_PRIORITY
    try:
        avoids = json.loads(ann)
    except ValueError:
        return MAX_PRIORITY
    for avoid in avoids.get("preferAvoidPods", []):
        ctrl = (avoid.get("podSignature") or {}).get("podController") or {}
        if ctrl.get("kind") == controller_ref.kind and ctrl.get("uid") == controller_ref.uid:
            return 0
    return MAX_PRIORITY


_MB = 1024 * 1024
_MIN_IMG_SIZE = 23 * _MB
_MAX_IMG_SIZE = 1000 * _MB


def image_locality_priority_map(pod: Pod, node: Node) -> int:
    """ImageLocalityPriority (image_locality.go): the summed size of the
    pod's container images already on the node, scored 0 below 23 MB,
    MAX_PRIORITY from 1000 MB, linear (+1) between."""
    sum_size = 0
    for container in pod.spec.containers:
        for image in node.status.images:
            if container.image in image.names:
                sum_size += image.size_bytes
                break
    if sum_size == 0 or sum_size < _MIN_IMG_SIZE:
        return 0
    if sum_size >= _MAX_IMG_SIZE:
        return MAX_PRIORITY
    return int(MAX_PRIORITY * (sum_size - _MIN_IMG_SIZE)
               // (_MAX_IMG_SIZE - _MIN_IMG_SIZE) + 1)


def get_zone_key(node: Optional[Node]) -> str:
    """utilnode.GetZoneKey: region + ":\\x00:" + zone; "" when both absent."""
    if node is None:
        return ""
    labels = node.metadata.labels
    region = labels.get(LABEL_ZONE_REGION, "")
    zone = labels.get(LABEL_ZONE_FAILURE_DOMAIN, "")
    if not region and not zone:
        return ""
    return f"{region}:\x00:{zone}"
