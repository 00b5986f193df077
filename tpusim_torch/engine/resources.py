"""Resource accounting: Resource, HostPortInfo, NodeInfo.

Reference: schedulercache/node_info.go (NodeInfo + Resource + incremental
AddPod/RemovePod accounting), util/utils.go (HostPortInfo),
algorithm/priorities/util/non_zero.go (non-zero request defaults).
"""

from __future__ import annotations

import itertools

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpusim_torch.api.quantity import parse_quantity
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

    def add(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.nvidia_gpu += other.nvidia_gpu
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) + v

    def subtract(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.nvidia_gpu -= other.nvidia_gpu
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) - v

    def clone(self) -> "Resource":
        return Resource(self.milli_cpu, self.memory, self.nvidia_gpu,
                        self.ephemeral_storage, self.allowed_pod_number,
                        dict(self.scalar))


# Scoped request memo: preemption's victim selection recomputes the same
# pods' requests hundreds of times (clone/strip/reprieve per candidate node).
# When a scope is active, results are cached by object identity — the pod
# reference is held alongside so a recycled id() can never alias — and MUST be
# treated as immutable by callers (the one historical mutator,
# priorities._resource_allocation_map, clones its copy).
_REQ_MEMO: Optional[dict] = None
_NZ_MEMO: Optional[dict] = None
_PORTS_MEMO: Optional[dict] = None


@contextmanager
def request_memo():
    global _REQ_MEMO, _NZ_MEMO, _PORTS_MEMO
    prev = (_REQ_MEMO, _NZ_MEMO, _PORTS_MEMO)
    _REQ_MEMO, _NZ_MEMO, _PORTS_MEMO = {}, {}, {}
    try:
        yield
    finally:
        _REQ_MEMO, _NZ_MEMO, _PORTS_MEMO = prev


def get_resource_request(pod: Pod) -> Resource:
    """Reference: predicates.go:659-697 — sum containers, then per-resource max
    with each init container."""
    memo = _REQ_MEMO
    if memo is not None:
        hit = memo.get(id(pod))
        if hit is not None:
            return hit[1]
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
    if memo is not None:
        memo[id(pod)] = (pod, result)
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
    memo = _NZ_MEMO
    if memo is not None:
        hit = memo.get(id(pod))
        if hit is not None:
            return hit[1]
    result = Resource()
    for c in pod.spec.containers:
        cpu, mem = get_nonzero_requests(c.requests)
        result.milli_cpu += cpu
        result.memory += mem
    if memo is not None:
        memo[id(pod)] = (pod, result)
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


def get_container_ports(pod: Pod) -> list:
    """Reference: util/utils.go GetContainerPorts — every containerPort entry of
    the pod's (non-init) containers."""
    memo = _PORTS_MEMO
    if memo is not None:
        hit = memo.get(id(pod))
        if hit is not None:
            return hit[1]
    ports = []
    for c in pod.spec.containers:
        ports.extend(c.ports)
    if memo is not None:
        memo[id(pod)] = (pod, ports)
    return ports


DEFAULT_BIND_ALL_HOST_IP = "0.0.0.0"


class HostPortInfo:
    """Reference: util/utils.go:51-137 — (ip, protocol, port) occupancy with
    0.0.0.0 wildcard semantics."""

    def __init__(self):
        self._by_ip: Dict[str, set] = {}

    @staticmethod
    def _sanitize(ip: str, protocol: str) -> tuple[str, str]:
        return (ip or DEFAULT_BIND_ALL_HOST_IP, protocol or "TCP")

    def add(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip, protocol = self._sanitize(ip, protocol)
        self._by_ip.setdefault(ip, set()).add((protocol, port))

    def remove(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip, protocol = self._sanitize(ip, protocol)
        s = self._by_ip.get(ip)
        if s is not None:
            s.discard((protocol, port))
            if not s:
                del self._by_ip[ip]

    def check_conflict(self, ip: str, protocol: str, port: int) -> bool:
        if port <= 0:
            return False
        ip, protocol = self._sanitize(ip, protocol)
        pp = (protocol, port)
        if ip == DEFAULT_BIND_ALL_HOST_IP:
            return any(pp in s for s in self._by_ip.values())
        for key in (DEFAULT_BIND_ALL_HOST_IP, ip):
            if pp in self._by_ip.get(key, ()):
                return True
        return False

    def __len__(self) -> int:
        return sum(len(s) for s in self._by_ip.values())

    def clone(self) -> "HostPortInfo":
        h = HostPortInfo()
        h._by_ip = {k: set(v) for k, v in self._by_ip.items()}
        return h


_generation_counter = itertools.count(1)


def _next_generation() -> int:
    """Globally monotonic NodeInfo generation. A shared counter (instead of
    per-instance increments) makes generations unique across instances, so a
    mutated snapshot clone can never collide with the live cache entry in
    SchedulerCache.update_node_name_to_info_map's equality check."""
    return next(_generation_counter)


class NodeInfo:
    """Aggregated per-node scheduling state.

    Reference: node_info.go:35-63 (struct) / :318-398 (AddPod/RemovePod) /
    :400-448 (calculateResource, SetNode condition caching).
    """

    def __init__(self, *pods: Pod):
        self.node: Optional[Node] = None
        self.pods: List[Pod] = []
        self.requested_resource = Resource()
        self.nonzero_request = Resource()
        self.allocatable_resource = Resource()
        self.used_ports = HostPortInfo()
        self.taints: list = []
        self.memory_pressure = False
        self.disk_pressure = False
        self.generation = 0
        for p in pods:
            self.add_pod(p)

    # --- lifecycle ---

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable_resource = Resource()
        self.allocatable_resource.add_resource_list(node.status.allocatable)
        self.taints = list(node.spec.taints)
        self.memory_pressure = any(
            c.type == "MemoryPressure" and c.status == "True" for c in node.status.conditions)
        self.disk_pressure = any(
            c.type == "DiskPressure" and c.status == "True" for c in node.status.conditions)
        self.generation = _next_generation()

    def remove_node(self) -> None:
        self.node = None
        self.allocatable_resource = Resource()
        self.taints = []
        self.memory_pressure = False
        self.disk_pressure = False
        self.generation = _next_generation()

    def add_pod(self, pod: Pod) -> None:
        res = get_resource_request(pod)
        self.requested_resource.add(res)
        non0 = get_nonzero_pod_request(pod)
        self.nonzero_request.milli_cpu += non0.milli_cpu
        self.nonzero_request.memory += non0.memory
        self.pods.append(pod)
        for port in get_container_ports(pod):
            self.used_ports.add(port.host_ip, port.protocol, port.host_port)
        self.generation = _next_generation()

    def remove_pod(self, pod: Pod) -> None:
        # identity-first scan: callers (victim selection, cache accounting)
        # overwhelmingly pass the exact object held in self.pods, and the
        # key() fallback builds two strings per compared entry — measurably
        # hot at preemption's ~15 removals per candidate node
        for i, p in enumerate(self.pods):
            if p is pod:
                del self.pods[i]
                break
        else:
            key = pod.key()
            for i, p in enumerate(self.pods):
                if p.key() == key:
                    del self.pods[i]
                    break
            else:
                raise KeyError(f"no corresponding pod {key} in pods of node")
        res = get_resource_request(pod)
        self.requested_resource.subtract(res)
        non0 = get_nonzero_pod_request(pod)
        self.nonzero_request.milli_cpu -= non0.milli_cpu
        self.nonzero_request.memory -= non0.memory
        for port in get_container_ports(pod):
            self.used_ports.remove(port.host_ip, port.protocol, port.host_port)
        self.generation = _next_generation()

    # --- views ---

    def allowed_pod_number(self) -> int:
        return self.allocatable_resource.allowed_pod_number

    def memory_pressure_condition(self) -> bool:
        return self.memory_pressure

    def disk_pressure_condition(self) -> bool:
        return self.disk_pressure

    def clone(self) -> "NodeInfo":
        c = NodeInfo()
        c.node = self.node
        c.pods = list(self.pods)
        c.requested_resource = self.requested_resource.clone()
        c.nonzero_request = self.nonzero_request.clone()
        c.allocatable_resource = self.allocatable_resource.clone()
        c.used_ports = self.used_ports.clone()
        c.taints = list(self.taints)
        c.memory_pressure = self.memory_pressure
        c.disk_pressure = self.disk_pressure
        c.generation = self.generation
        return c

    def clone_without(self, excluded: List[Pod]) -> "NodeInfo":
        """Equivalent to clone() followed by remove_pod() for each of
        `excluded` (identity-matched members of self.pods), but built by
        re-accumulating the SURVIVORS: victim selection strips most of a
        node's pods, so rebuilding from the few kept ones is cheaper than
        paying per-removal accounting. Integer adds make the rebuilt
        aggregates bit-identical to subtract-per-removal."""
        c = NodeInfo()
        c.node = self.node
        excluded_ids = {id(p) for p in excluded}
        c.pods = [p for p in self.pods if id(p) not in excluded_ids]
        c.allocatable_resource = self.allocatable_resource.clone()
        c.taints = list(self.taints)
        c.memory_pressure = self.memory_pressure
        c.disk_pressure = self.disk_pressure
        for p in c.pods:
            c.requested_resource.add(get_resource_request(p))
            non0 = get_nonzero_pod_request(p)
            c.nonzero_request.milli_cpu += non0.milli_cpu
            c.nonzero_request.memory += non0.memory
            for port in get_container_ports(p):
                c.used_ports.add(port.host_ip, port.protocol, port.host_port)
        c.generation = _next_generation()
        return c


def new_node_info_map(nodes: List[Node], pods: List[Pod]) -> Dict[str, NodeInfo]:
    """Build name->NodeInfo from a snapshot (CreateNodeNameToInfoMap parity):
    pods with spec.nodeName are accounted to their node."""
    infos: Dict[str, NodeInfo] = {}
    for pod in pods:
        name = pod.spec.node_name
        if not name:
            continue
        infos.setdefault(name, NodeInfo()).add_pod(pod)
    for node in nodes:
        info = infos.setdefault(node.name, NodeInfo())
        info.set_node(node)
    return infos
