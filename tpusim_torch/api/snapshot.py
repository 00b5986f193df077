"""Cluster snapshots: file checkpoints and synthetic generators.

Reference: pkg/main.go:147-179 (pods.json / nodes.json checkpoint readers) and
pkg/main.go:189-231 (createSamplePods / newSampleNode synthetic generators).
The file format is a JSON list of v1 objects, as produced by a live-cluster
List call — Running pods + all nodes (cmd/app/server.go:104-118).
"""

from __future__ import annotations

from dataclasses import dataclass, field
import json
from typing import List, Optional

from tpusim_torch.api.types import (
    LABEL_HOSTNAME,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    Service,
    StorageClass,
)


@dataclass
class ClusterSnapshot:
    """A frozen cluster state: the simulator's 'checkpoint' (SURVEY.md §5)."""

    nodes: List[Node] = field(default_factory=list)
    pods: List[Pod] = field(default_factory=list)  # already-scheduled (Running) pods
    services: List[Service] = field(default_factory=list)
    pvs: List[PersistentVolume] = field(default_factory=list)
    pvcs: List[PersistentVolumeClaim] = field(default_factory=list)
    storage_classes: List[StorageClass] = field(default_factory=list)

    def to_obj(self) -> dict:
        o = {
            "nodes": [n.to_obj() for n in self.nodes],
            "pods": [p.to_obj() for p in self.pods],
            "services": [s.to_obj() for s in self.services],
        }
        if self.pvs:
            o["persistentVolumes"] = [pv.to_obj() for pv in self.pvs]
        if self.pvcs:
            o["persistentVolumeClaims"] = [pvc.to_obj() for pvc in self.pvcs]
        if self.storage_classes:
            o["storageClasses"] = [sc.to_obj() for sc in self.storage_classes]
        return o

    @classmethod
    def from_obj(cls, o: dict) -> "ClusterSnapshot":
        return cls(
            nodes=[Node.from_obj(n) for n in o.get("nodes") or []],
            pods=[Pod.from_obj(p) for p in o.get("pods") or []],
            services=[Service.from_obj(s) for s in o.get("services") or []],
            pvs=[PersistentVolume.from_obj(v)
                 for v in o.get("persistentVolumes") or []],
            pvcs=[PersistentVolumeClaim.from_obj(v)
                  for v in o.get("persistentVolumeClaims") or []],
            storage_classes=[StorageClass.from_obj(v)
                             for v in o.get("storageClasses") or []],
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_obj(), f)

    @classmethod
    def load(cls, path: str) -> "ClusterSnapshot":
        with open(path) as f:
            return cls.from_obj(json.load(f))


def load_pods_checkpoint(path: str) -> List[Pod]:
    """Reference: pkg/main.go:147-162 (getPodsCheckPoint from pods.json).

    Accepts either a bare JSON list of pods or a v1 List envelope {"items": [...]}.
    """
    with open(path) as f:
        data = json.load(f)
    items = data["items"] if isinstance(data, dict) else data
    return [Pod.from_obj(p) for p in items]


def load_nodes_checkpoint(path: str) -> List[Node]:
    """Reference: pkg/main.go:164-179 (getNodeCheckPoint from nodes.json)."""
    with open(path) as f:
        data = json.load(f)
    items = data["items"] if isinstance(data, dict) else data
    return [Node.from_obj(n) for n in items]


# ---------------------------------------------------------------------------
# synthetic generators
# ---------------------------------------------------------------------------


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


def make_pv(
    name: str,
    storage: str = "1Gi",
    labels: Optional[dict] = None,
    storage_class: str = "",
    access_modes: Optional[list] = None,
    claim_ref: Optional[dict] = None,
    node_affinity_terms: Optional[list] = None,
    source: Optional[dict] = None,
) -> PersistentVolume:
    """Build a PersistentVolume fixture."""
    spec: dict = {"capacity": {"storage": storage}}
    if storage_class:
        spec["storageClassName"] = storage_class
    if access_modes:
        spec["accessModes"] = list(access_modes)
    if claim_ref:
        spec["claimRef"] = dict(claim_ref)
    if node_affinity_terms is not None:
        spec["nodeAffinity"] = {
            "required": {"nodeSelectorTerms": node_affinity_terms}}
    if source:
        spec.update(source)
    return PersistentVolume.from_obj(
        {"metadata": {"name": name, "labels": labels or {}}, "spec": spec})


def make_pvc(
    name: str,
    namespace: str = "default",
    volume_name: str = "",
    storage: str = "1Gi",
    storage_class: Optional[str] = None,
    access_modes: Optional[list] = None,
    selector: Optional[dict] = None,
) -> PersistentVolumeClaim:
    """Build a PersistentVolumeClaim fixture; volume_name='' = unbound."""
    spec: dict = {"resources": {"requests": {"storage": storage}}}
    if volume_name:
        spec["volumeName"] = volume_name
    if storage_class is not None:
        spec["storageClassName"] = storage_class
    if access_modes:
        spec["accessModes"] = list(access_modes)
    if selector:
        spec["selector"] = dict(selector)
    return PersistentVolumeClaim.from_obj(
        {"metadata": {"name": name, "namespace": namespace}, "spec": spec})


def make_storage_class(name: str, binding_mode: str = "") -> StorageClass:
    obj: dict = {"metadata": {"name": name}}
    if binding_mode:
        obj["volumeBindingMode"] = binding_mode
    return StorageClass.from_obj(obj)


def synthetic_cluster(
    num_nodes: int,
    milli_cpu: int = 4000,
    memory: int = 16 * 1024**3,
    pods_per_node: int = 110,
    name_prefix: str = "node",
) -> ClusterSnapshot:
    """Homogeneous synthetic cluster (BASELINE.md config 2 shape)."""
    nodes = [make_node(f"{name_prefix}-{i}", milli_cpu=milli_cpu, memory=memory,
                       pods=pods_per_node) for i in range(num_nodes)]
    return ClusterSnapshot(nodes=nodes)
