"""Cluster snapshots and the synthetic generators.

Reference: pkg/main.go:189-231 (createSamplePods / newSampleNode). A snapshot
is the frozen cluster state a simulation schedules against: nodes, the pods
already running on them, the services, and the persistent volumes and claims
that pod volumes resolve through.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tpusim_torch.api.types import (
    LABEL_HOSTNAME,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    Service,
)


@dataclass
class ClusterSnapshot:
    """A frozen cluster state: the simulator's 'checkpoint'."""

    nodes: List[Node] = field(default_factory=list)
    pods: List[Pod] = field(default_factory=list)  # already-scheduled (Running) pods
    services: List[Service] = field(default_factory=list)
    pvs: List[PersistentVolume] = field(default_factory=list)
    pvcs: List[PersistentVolumeClaim] = field(default_factory=list)


def make_node(
    name: str,
    milli_cpu: int = 4000,
    memory: int = 16 * 1024**3,
    pods: int = 110,
    gpus: int = 0,
    labels: Optional[dict] = None,
    taints: Optional[list] = None,
    unschedulable: bool = False,
    ready: bool = True,
    scalars: Optional[dict] = None,
) -> Node:
    """Build a schedulable node fixture (reference: pkg/main.go:200-231 newSampleNode)."""
    cpu = f"{milli_cpu}m"
    obj = {
        "metadata": {"name": name, "labels": {LABEL_HOSTNAME: name, **(labels or {})}},
        "spec": {},
        "status": {
            "capacity": {"cpu": cpu, "memory": str(memory), "pods": str(pods)},
            "allocatable": {"cpu": cpu, "memory": str(memory), "pods": str(pods)},
            "conditions": [{"type": "Ready", "status": "True" if ready else "False"}],
        },
    }
    if gpus:
        obj["status"]["capacity"]["alpha.kubernetes.io/nvidia-gpu"] = str(gpus)
        obj["status"]["allocatable"]["alpha.kubernetes.io/nvidia-gpu"] = str(gpus)
    for res, qty in (scalars or {}).items():
        obj["status"]["capacity"][res] = str(qty)
        obj["status"]["allocatable"][res] = str(qty)
    if unschedulable:
        obj["spec"]["unschedulable"] = True
    if taints:
        obj["spec"]["taints"] = taints
    return Node.from_obj(obj)


def make_pod(
    name: str,
    milli_cpu: int = 0,
    memory: int = 0,
    gpus: int = 0,
    namespace: str = "default",
    node_name: str = "",
    phase: str = "",
    labels: Optional[dict] = None,
    node_selector: Optional[dict] = None,
    tolerations: Optional[list] = None,
    affinity: Optional[dict] = None,
    volumes: Optional[list] = None,
    scalars: Optional[dict] = None,
) -> Pod:
    """Build a pod fixture (reference: pkg/main.go:189-198 newSamplePod)."""
    requests = {}
    if milli_cpu:
        requests["cpu"] = f"{milli_cpu}m"
    if memory:
        requests["memory"] = str(memory)
    if gpus:
        requests["alpha.kubernetes.io/nvidia-gpu"] = str(gpus)
    for res, qty in (scalars or {}).items():
        requests[res] = str(qty)
    obj = {
        "metadata": {"name": name, "namespace": namespace, "uid": name,
                     "labels": labels or {}},
        "spec": {"containers": [{"name": "c", "resources": {"requests": requests}}]},
        "status": {},
    }
    if node_name:
        obj["spec"]["nodeName"] = node_name
    if phase:
        obj["status"]["phase"] = phase
    if node_selector:
        obj["spec"]["nodeSelector"] = node_selector
    if tolerations:
        obj["spec"]["tolerations"] = tolerations
    if affinity:
        obj["spec"]["affinity"] = affinity
    if volumes:
        obj["spec"]["volumes"] = volumes
    return Pod.from_obj(obj)


def make_pod_volume(name: str, source: Optional[dict] = None,
                    pvc: str = "") -> dict:
    """A pod .spec.volumes entry: either a direct source dict (e.g.
    {"gcePersistentDisk": {...}}) or a PVC reference."""
    obj: dict = {"name": name}
    if pvc:
        obj["persistentVolumeClaim"] = {"claimName": pvc}
    if source:
        obj.update(source)
    return obj


def make_pv(name: str, storage: str = "1Gi", labels: Optional[dict] = None,
            source: Optional[dict] = None) -> PersistentVolume:
    """Build a PersistentVolume fixture."""
    spec: dict = {"capacity": {"storage": storage}}
    if source:
        spec.update(source)
    return PersistentVolume.from_obj(
        {"metadata": {"name": name, "labels": labels or {}}, "spec": spec})


def make_pvc(name: str, namespace: str = "default", volume_name: str = "",
             storage: str = "1Gi") -> PersistentVolumeClaim:
    """Build a PersistentVolumeClaim fixture; volume_name='' = unbound."""
    spec: dict = {"resources": {"requests": {"storage": storage}}}
    if volume_name:
        spec["volumeName"] = volume_name
    return PersistentVolumeClaim.from_obj(
        {"metadata": {"name": name, "namespace": namespace}, "spec": spec})


def synthetic_cluster(
    num_nodes: int,
    milli_cpu: int = 4000,
    memory: int = 16 * 1024**3,
    pods_per_node: int = 110,
    name_prefix: str = "node",
) -> ClusterSnapshot:
    """Homogeneous synthetic cluster."""
    nodes = [make_node(f"{name_prefix}-{i}", milli_cpu=milli_cpu, memory=memory,
                       pods=pods_per_node) for i in range(num_nodes)]
    return ClusterSnapshot(nodes=nodes)
