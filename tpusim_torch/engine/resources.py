"""Resource accounting: Resource, NodeInfo and the request views.

Reference: schedulercache/node_info.go (NodeInfo + Resource),
algorithm/priorities/util/non_zero.go (non-zero request defaults). The port
compiles static node state from a NodeInfo and never binds into one, so only
the node side (set_node) is kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from tpusim_torch.api.types import (
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_NVIDIA_GPU,
    RESOURCE_PODS,
    Node,
    Pod,
    is_scalar_resource_name,
)

# non_zero.go:31-34 — defaults applied for priority computation only
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


@dataclass
class Resource:
    """Reference: node_info.go:66-76."""

    milli_cpu: int = 0
    memory: int = 0
    nvidia_gpu: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar: Dict[str, int] = field(default_factory=dict)

    def add_resource_list(self, rl: dict) -> None:
        """Reference: node_info.go Resource.Add — accumulate a v1.ResourceList."""
        for name, q in rl.items():
            if name == RESOURCE_CPU:
                self.milli_cpu += q.milli_value()
            elif name == RESOURCE_MEMORY:
                self.memory += q.value()
            elif name == RESOURCE_NVIDIA_GPU:
                self.nvidia_gpu += q.value()
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage += q.value()
            elif name == RESOURCE_PODS:
                self.allowed_pod_number += q.value()
            elif is_scalar_resource_name(name):
                self.scalar[name] = self.scalar.get(name, 0) + q.value()


def get_resource_request(pod: Pod) -> Resource:
    """Reference: predicates.go:659-697 — sum containers, then per-resource max
    with each init container."""
    result = Resource()
    for c in pod.spec.containers:
        result.add_resource_list(c.requests)
    for c in pod.spec.init_containers:
        for name, q in c.requests.items():
            if name == RESOURCE_MEMORY:
                result.memory = max(result.memory, q.value())
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                result.ephemeral_storage = max(result.ephemeral_storage, q.value())
            elif name == RESOURCE_CPU:
                result.milli_cpu = max(result.milli_cpu, q.milli_value())
            elif name == RESOURCE_NVIDIA_GPU:
                result.nvidia_gpu = max(result.nvidia_gpu, q.value())
            elif is_scalar_resource_name(name):
                result.scalar[name] = max(result.scalar.get(name, 0), q.value())
    return result


def get_nonzero_requests(requests: dict) -> tuple[int, int]:
    """Reference: non_zero.go:36-54 — default unset (not explicit-zero) cpu/mem."""
    if RESOURCE_CPU in requests:
        cpu = requests[RESOURCE_CPU].milli_value()
    else:
        cpu = DEFAULT_MILLI_CPU_REQUEST
    if RESOURCE_MEMORY in requests:
        mem = requests[RESOURCE_MEMORY].value()
    else:
        mem = DEFAULT_MEMORY_REQUEST
    return cpu, mem


def get_nonzero_pod_request(pod: Pod) -> Resource:
    """Reference: resource_allocation.go:75-84 (getNonZeroRequests): containers
    only, no init-container max."""
    result = Resource()
    for c in pod.spec.containers:
        cpu, mem = get_nonzero_requests(c.requests)
        result.milli_cpu += cpu
        result.memory += mem
    return result


def is_pod_best_effort(pod: Pod) -> bool:
    """v1qos.GetPodQOS(pod) == BestEffort: no container has cpu/memory in
    requests or limits (the supported QoS compute resources)."""
    for c in pod.spec.containers:
        for rl in (c.requests, c.limits):
            for name in rl:
                if name in (RESOURCE_CPU, RESOURCE_MEMORY):
                    return False
    return True


class NodeInfo:
    """The static node view of node_info.go:35-63 / :400-448 (SetNode
    condition caching): allocatable resources, taints and pressure flags."""

    def __init__(self):
        self.node: Optional[Node] = None
        self.allocatable_resource = Resource()
        self.taints: list = []
        self.memory_pressure = False
        self.disk_pressure = False

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable_resource = Resource()
        self.allocatable_resource.add_resource_list(node.status.allocatable)
        self.taints = list(node.spec.taints)
        self.memory_pressure = any(
            c.type == "MemoryPressure" and c.status == "True" for c in node.status.conditions)
        self.disk_pressure = any(
            c.type == "DiskPressure" and c.status == "True" for c in node.status.conditions)
