"""Priority (scoring) functions: map/reduce model with weighted summation.

Reference: algorithm/priorities/*.go. A priority is either a per-node map
function plus optional reduce (normalize) function, or a legacy whole-list
function (InterPodAffinity). MaxPriority = 10 (api/types.go:36).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tpusim_torch.api.types import (
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
    TAINT_PREFER_NO_SCHEDULE,
    Node,
    Pod,
    tolerations_tolerate_taint,
)
from tpusim_torch.engine.predicates import (
    get_namespaces_from_pod_affinity_term,
    nodes_have_same_topology_key,
    pod_matches_term_namespace_and_selector,
)
from tpusim_torch.engine.resources import (
    NodeInfo,
    Resource,
    get_nonzero_pod_request,
)

MAX_PRIORITY = 10


@dataclass
class HostPriority:
    """Reference: api/types.go HostPriority{Host,Score}."""

    host: str
    score: int


@dataclass
class PriorityConfig:
    name: str
    weight: int = 1
    map_fn: Optional[Callable] = None      # (pod, meta, node_info) -> HostPriority
    reduce_fn: Optional[Callable] = None   # (pod, meta, node_info_map, result) -> None
    function: Optional[Callable] = None    # legacy: (pod, node_info_map, nodes) -> [HostPriority]


# ---------------------------------------------------------------------------
# resource-allocation family (resource_allocation.go scaffold)
# ---------------------------------------------------------------------------


def _resource_allocation_map(pod: Pod, meta, node_info: NodeInfo, scorer) -> HostPriority:
    if node_info.node is None:
        raise ValueError("node not found")
    if meta is not None and meta.nonzero_request is not None:
        requested = meta.nonzero_request.clone()
    else:
        # clone: the memoized request (engine/resources.request_memo) is a
        # shared object and the += below must not corrupt it
        requested = get_nonzero_pod_request(pod).clone()
    requested.milli_cpu += node_info.nonzero_request.milli_cpu
    requested.memory += node_info.nonzero_request.memory
    return HostPriority(node_info.node.name,
                        int(scorer(requested, node_info.allocatable_resource)))


def _least_requested_score(requested: int, capacity: int) -> int:
    """least_requested.go:41-52 — ((capacity-requested)*10)/capacity, int division."""
    if capacity == 0 or requested > capacity:
        return 0
    return ((capacity - requested) * MAX_PRIORITY) // capacity


def least_requested_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    return _resource_allocation_map(
        pod, meta, node_info,
        lambda req, alloc: (_least_requested_score(req.milli_cpu, alloc.milli_cpu)
                            + _least_requested_score(req.memory, alloc.memory)) // 2)


def _most_requested_score(requested: int, capacity: int) -> int:
    """most_requested.go:44-55."""
    if capacity == 0 or requested > capacity:
        return 0
    return (requested * MAX_PRIORITY) // capacity


def most_requested_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    return _resource_allocation_map(
        pod, meta, node_info,
        lambda req, alloc: (_most_requested_score(req.milli_cpu, alloc.milli_cpu)
                            + _most_requested_score(req.memory, alloc.memory)) // 2)


def _balanced_scorer(requested: Resource, allocatable: Resource) -> int:
    """balanced_resource_allocation.go:39-63, in exact rational arithmetic.

    Go computes int64((1 - |cpuFrac - memFrac|) * 10) in float64; this is the
    same quantity as floor(10 * (den - |rc*am - rm*ac|) / den) with
    den = ac*am, evaluated exactly (DEVIATIONS.md #16: scores deviate from
    Go only where float64 rounding crosses an integer boundary, and are
    identical on the host and the device)."""
    rc, ac = requested.milli_cpu, allocatable.milli_cpu
    rm, am = requested.memory, allocatable.memory
    # fractionOfCapacity: capacity 0 -> fraction 1; fraction >= 1 -> score 0
    if ac == 0 or rc >= ac or am == 0 or rm >= am:
        return 0
    num = abs(rc * am - rm * ac)
    den = ac * am
    return (MAX_PRIORITY * (den - num)) // den


def balanced_resource_allocation_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    return _resource_allocation_map(pod, meta, node_info, _balanced_scorer)


# ---------------------------------------------------------------------------
# normalize reduce (reduce.go:29-62)
# ---------------------------------------------------------------------------


def normalize_reduce(max_priority: int, reverse: bool) -> Callable:
    def reduce_fn(pod: Pod, meta, node_info_map: Dict[str, NodeInfo],
                  result: List[HostPriority]) -> None:
        max_count = 0
        for hp in result:
            if hp.score > max_count:
                max_count = hp.score
        if max_count == 0:
            if reverse:
                for hp in result:
                    hp.score = max_priority
            return
        for hp in result:
            score = max_priority * hp.score // max_count
            if reverse:
                score = max_priority - score
            hp.score = score

    return reduce_fn


# ---------------------------------------------------------------------------
# node affinity (node_affinity.go:34-79)
# ---------------------------------------------------------------------------


def calculate_node_affinity_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    node = node_info.node
    if node is None:
        raise ValueError("node not found")
    affinity = meta.affinity if meta is not None else pod.spec.affinity
    count = 0
    if affinity is not None and affinity.node_affinity is not None:
        for term in affinity.node_affinity.preferred:
            if term.weight == 0:
                continue
            if term.preference.matches(node.metadata.labels):
                count += term.weight
    return HostPriority(node.name, count)


calculate_node_affinity_priority_reduce = normalize_reduce(MAX_PRIORITY, False)


# ---------------------------------------------------------------------------
# taint toleration (taint_toleration.go:30-75)
# ---------------------------------------------------------------------------


def _tolerations_prefer_no_schedule(tolerations: list) -> list:
    return [t for t in tolerations if not t.effect or t.effect == TAINT_PREFER_NO_SCHEDULE]


def compute_taint_toleration_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    node = node_info.node
    if node is None:
        raise ValueError("node not found")
    if meta is not None and meta.pod_tolerations is not None:
        tolerations = meta.pod_tolerations
    else:
        tolerations = _tolerations_prefer_no_schedule(pod.spec.tolerations)
    intolerable = 0
    for taint in node.spec.taints:
        if taint.effect != TAINT_PREFER_NO_SCHEDULE:
            continue
        if not tolerations_tolerate_taint(tolerations, taint):
            intolerable += 1
    return HostPriority(node.name, intolerable)


compute_taint_toleration_priority_reduce = normalize_reduce(MAX_PRIORITY, True)


# ---------------------------------------------------------------------------
# node prefer avoid pods (node_prefer_avoid_pods.go, weight 10000)
# ---------------------------------------------------------------------------


def calculate_node_prefer_avoid_pods_priority_map(pod: Pod, meta,
                                                  node_info: NodeInfo) -> HostPriority:
    node = node_info.node
    if node is None:
        raise ValueError("node not found")
    controller_ref = pod.metadata.controller_ref()
    if controller_ref is not None and controller_ref.kind not in (
            "ReplicationController", "ReplicaSet"):
        controller_ref = None
    if controller_ref is None:
        return HostPriority(node.name, MAX_PRIORITY)
    import json

    ann = node.metadata.annotations.get("scheduler.alpha.kubernetes.io/preferAvoidPods")
    if not ann:
        return HostPriority(node.name, MAX_PRIORITY)
    try:
        avoids = json.loads(ann)
    except ValueError:
        return HostPriority(node.name, MAX_PRIORITY)
    for avoid in avoids.get("preferAvoidPods", []):
        ctrl = (avoid.get("podSignature") or {}).get("podController") or {}
        if ctrl.get("kind") == controller_ref.kind and ctrl.get("uid") == controller_ref.uid:
            return HostPriority(node.name, 0)
    return HostPriority(node.name, MAX_PRIORITY)


# ---------------------------------------------------------------------------
# image locality (image_locality.go)
# ---------------------------------------------------------------------------

_MB = 1024 * 1024
_MIN_IMG_SIZE = 23 * _MB
_MAX_IMG_SIZE = 1000 * _MB


def image_locality_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    node = node_info.node
    if node is None:
        raise ValueError("node not found")
    sum_size = 0
    for container in pod.spec.containers:
        for image in node.status.images:
            if container.image in image.names:
                sum_size += image.size_bytes
                break
    if sum_size == 0 or sum_size < _MIN_IMG_SIZE:
        score = 0
    elif sum_size >= _MAX_IMG_SIZE:
        score = MAX_PRIORITY
    else:
        score = int(MAX_PRIORITY * (sum_size - _MIN_IMG_SIZE)
                    // (_MAX_IMG_SIZE - _MIN_IMG_SIZE) + 1)
    return HostPriority(node.name, score)


# ---------------------------------------------------------------------------
# resource limits (resource_limits.go; feature-gated registration)
# ---------------------------------------------------------------------------


def resource_limits_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    node = node_info.node
    if node is None:
        raise ValueError("node not found")
    allocatable = node_info.allocatable_resource
    cpu_limit = 0
    mem_limit = 0
    for c in pod.spec.containers:
        if "cpu" in c.limits:
            cpu_limit += c.limits["cpu"].milli_value()
        if "memory" in c.limits:
            mem_limit += c.limits["memory"].value()
    score = 0
    cpu_score = 1 if (cpu_limit > 0 and allocatable.milli_cpu >= cpu_limit) else 0
    mem_score = 1 if (mem_limit > 0 and allocatable.memory >= mem_limit) else 0
    if cpu_score == 1 or mem_score == 1:
        score = 1
    return HostPriority(node.name, score)


# ---------------------------------------------------------------------------
# node label (policy-configured)
# ---------------------------------------------------------------------------


def make_node_label_priority_map(label: str, presence: bool) -> Callable:
    def node_label_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
        node = node_info.node
        if node is None:
            raise ValueError("node not found")
        exists = label in node.metadata.labels
        score = MAX_PRIORITY if exists == presence else 0
        return HostPriority(node.name, score)

    return node_label_priority_map


def equal_priority_map(pod: Pod, meta, node_info: NodeInfo) -> HostPriority:
    """core.EqualPriorityMap — weight-1 constant."""
    if node_info.node is None:
        raise ValueError("node not found")
    return HostPriority(node_info.node.name, 1)


# ---------------------------------------------------------------------------
# selector spreading (selector_spreading.go:66-175)
# ---------------------------------------------------------------------------

# Go's zoneWeighting = 2.0/3.0 (selector_spreading.go:41) appears below (and
# in the scan and the kernel) as its exact rational form node/3 + 2*zone/3, evaluated
# in integer arithmetic with one floor at the end — see DEVIATIONS.md #16.


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


class SelectorSpread:
    def __init__(self, service_lister, controller_lister=None,
                 replica_set_lister=None, stateful_set_lister=None):
        self.service_lister = service_lister        # () -> [Service]
        self.controller_lister = controller_lister or (lambda: [])
        self.replica_set_lister = replica_set_lister or (lambda: [])
        self.stateful_set_lister = stateful_set_lister or (lambda: [])

    def _get_selectors(self, pod: Pod) -> list:
        """getSelectors — selector callables from matching services / RCs / RSs /
        StatefulSets. The simulator wires empty fakes for everything but services
        (simulator.go:352-366)."""
        selectors = []
        for svc in self.service_lister():
            if (svc.namespace == pod.namespace and svc.selector
                    and all(pod.metadata.labels.get(k) == v
                            for k, v in svc.selector.items())):
                sel = dict(svc.selector)
                selectors.append(lambda labels, sel=sel: all(
                    labels.get(k) == v for k, v in sel.items()))
        for obj in (list(self.controller_lister()) + list(self.replica_set_lister())
                    + list(self.stateful_set_lister())):
            sel_obj = getattr(obj, "selector", None)
            matches = getattr(obj, "matches", None)
            if callable(matches) and obj.namespace == pod.namespace \
                    and matches(pod.metadata.labels):
                selectors.append(matches)
            elif sel_obj and obj.namespace == pod.namespace and all(
                    pod.metadata.labels.get(k) == v for k, v in sel_obj.items()):
                selectors.append(lambda labels, sel=dict(sel_obj): all(
                    labels.get(k) == v for k, v in sel.items()))
        return selectors

    def calculate_spread_priority_map(self, pod: Pod, meta,
                                      node_info: NodeInfo) -> HostPriority:
        node = node_info.node
        if node is None:
            raise ValueError("node not found")
        if meta is not None and meta.pod_selectors is not None:
            selectors = meta.pod_selectors
        else:
            selectors = self._get_selectors(pod)
        if not selectors:
            return HostPriority(node.name, 0)
        count = 0
        for node_pod in node_info.pods:
            if pod.namespace != node_pod.namespace:
                continue
            if any(sel(node_pod.metadata.labels) for sel in selectors):
                count += 1
        return HostPriority(node.name, count)

    def calculate_spread_priority_reduce(self, pod: Pod, meta,
                                         node_info_map: Dict[str, NodeInfo],
                                         result: List[HostPriority]) -> None:
        counts_by_zone: Dict[str, int] = {}
        max_count_by_node = 0
        for hp in result:
            if hp.score > max_count_by_node:
                max_count_by_node = hp.score
            info = node_info_map.get(hp.host)
            zone_id = get_zone_key(info.node if info else None)
            if not zone_id:
                continue
            counts_by_zone[zone_id] = counts_by_zone.get(zone_id, 0) + hp.score
        max_count_by_zone = max(counts_by_zone.values(), default=0)
        have_zones = bool(counts_by_zone)
        # Exact rational form of Go's float64 math (DEVIATIONS.md #16):
        # nodeScore = 10*(mn-c)/mn (10 when mn==0), zoneScore likewise, and
        # the zone blend is nodeScore/3 + 2*zoneScore/3 (selector_spreading.go
        # hardcodes zoneWeighting = 2.0/3.0) — one floor at the end.
        for hp in result:
            mn = max_count_by_node
            node_num, node_den = (mn - hp.score, mn) if mn > 0 else (1, 1)
            zone_id = None
            if have_zones:
                info = node_info_map.get(hp.host)
                zone_id = get_zone_key(info.node if info else None)
            if zone_id:
                mz = max_count_by_zone
                zone_num, zone_den = ((mz - counts_by_zone[zone_id], mz)
                                      if mz > 0 else (1, 1))
                hp.score = (MAX_PRIORITY
                            * (node_num * zone_den + 2 * zone_num * node_den)
                            ) // (3 * node_den * zone_den)
            else:
                hp.score = (MAX_PRIORITY * node_num) // node_den


# ---------------------------------------------------------------------------
# service anti-affinity (selector_spreading.go:176-280; policy-configured via
# PriorityArgument.ServiceAntiAffinity)
# ---------------------------------------------------------------------------


class ServiceAntiAffinity:
    """Spread pods of the first matching service across node groups identified
    by a node label (selector_spreading.go:176-280)."""

    def __init__(self, pod_lister, service_lister, label: str):
        self.pod_lister = pod_lister        # () -> [Pod] (unused; node_info has pods)
        self.service_lister = service_lister  # () -> [Service]
        self.label = label

    def _first_service_selector(self, pod: Pod) -> Optional[dict]:
        """getFirstServiceSelector — selector of the first service whose
        selector matches the pod's labels, in lister order."""
        for svc in self.service_lister():
            if (svc.namespace == pod.namespace and svc.selector
                    and all(pod.metadata.labels.get(k) == v
                            for k, v in svc.selector.items())):
                return dict(svc.selector)
        return None

    def calculate_anti_affinity_priority_map(self, pod: Pod, meta,
                                             node_info: NodeInfo) -> HostPriority:
        """Score = count of same-namespace pods on this node matching the
        pod's first-service selector (selector_spreading.go:223-244)."""
        node = node_info.node
        if node is None:
            raise ValueError("node not found")
        selector = self._first_service_selector(pod)
        if selector is None:
            return HostPriority(node.name, 0)
        count = sum(
            1 for node_pod in node_info.pods
            if node_pod.namespace == pod.namespace
            and all(node_pod.metadata.labels.get(k) == v
                    for k, v in selector.items()))
        return HostPriority(node.name, count)

    def calculate_anti_affinity_priority_reduce(self, pod: Pod, meta,
                                                node_info_map: Dict[str, NodeInfo],
                                                result: List[HostPriority]) -> None:
        """Nodes without the label score 0; labeled nodes score
        MaxPriority * (total - podsInGroup) / total (selector_spreading.go:
        246-280)."""
        num_service_pods = 0
        pod_counts: Dict[str, int] = {}
        label_of_host: Dict[str, str] = {}
        for hp in result:
            num_service_pods += hp.score
            info = node_info_map.get(hp.host)
            node = info.node if info else None
            if node is None or self.label not in node.metadata.labels:
                continue
            label = node.metadata.labels[self.label]
            label_of_host[hp.host] = label
            pod_counts[label] = pod_counts.get(label, 0) + hp.score
        for hp in result:
            label = label_of_host.get(hp.host)
            if label is None:
                hp.score = 0
                continue
            # exact rational form of Go's float64 math (DEVIATIONS.md #16)
            if num_service_pods > 0:
                hp.score = (MAX_PRIORITY
                            * (num_service_pods - pod_counts[label])
                            ) // num_service_pods
            else:
                hp.score = MAX_PRIORITY


def make_service_anti_affinity_priority(pod_lister, service_lister, label: str):
    """NewServiceAntiAffinityPriority (selector_spreading.go:183-192)."""
    anti = ServiceAntiAffinity(pod_lister, service_lister, label)
    return (anti.calculate_anti_affinity_priority_map,
            anti.calculate_anti_affinity_priority_reduce)


# ---------------------------------------------------------------------------
# inter-pod affinity priority (interpod_affinity.go:118+, legacy Function form)
# ---------------------------------------------------------------------------


class InterPodAffinityPriority:
    def __init__(self, node_info_getter, hard_pod_affinity_weight: int = 10):
        self._node_info = node_info_getter  # (name) -> NodeInfo | None
        self.hard_pod_affinity_weight = hard_pod_affinity_weight

    def calculate(self, pod: Pod, node_info_map: Dict[str, NodeInfo],
                  nodes: List[Node]) -> List[HostPriority]:
        affinity = pod.spec.affinity
        has_affinity = affinity is not None and affinity.pod_affinity is not None
        has_anti_affinity = affinity is not None and affinity.pod_anti_affinity is not None

        # integer weights summed in exact integer arithmetic (Go uses float64
        # for the same integer-valued quantities; DEVIATIONS.md #16)
        counts: Dict[str, int] = {n.name: 0 for n in nodes}

        def process_term(term, pod_defining, pod_to_check, fixed_node: Node,
                         weight: int) -> None:
            namespaces = get_namespaces_from_pod_affinity_term(pod_defining, term)
            if not pod_matches_term_namespace_and_selector(
                    pod_to_check, namespaces, term.label_selector):
                return
            for node in nodes:
                if nodes_have_same_topology_key(node, fixed_node, term.topology_key):
                    counts[node.name] += weight

        def process_weighted_terms(terms, pod_defining, pod_to_check, fixed_node,
                                   multiplier: int) -> None:
            for wt in terms:
                process_term(wt.pod_affinity_term, pod_defining, pod_to_check,
                             fixed_node, wt.weight * multiplier)

        def process_pod(existing_pod: Pod) -> None:
            existing_info = self._node_info(existing_pod.spec.node_name)
            if existing_info is None or existing_info.node is None:
                return
            existing_node = existing_info.node
            ex_affinity = existing_pod.spec.affinity
            ex_has_affinity = ex_affinity is not None and ex_affinity.pod_affinity is not None
            ex_has_anti = ex_affinity is not None and ex_affinity.pod_anti_affinity is not None
            if has_affinity:
                process_weighted_terms(affinity.pod_affinity.preferred, pod,
                                       existing_pod, existing_node, 1)
            if has_anti_affinity:
                process_weighted_terms(affinity.pod_anti_affinity.preferred, pod,
                                       existing_pod, existing_node, -1)
            if ex_has_affinity:
                if self.hard_pod_affinity_weight > 0:
                    for term in ex_affinity.pod_affinity.required:
                        process_term(term, existing_pod, pod, existing_node,
                                     self.hard_pod_affinity_weight)
                process_weighted_terms(ex_affinity.pod_affinity.preferred,
                                       existing_pod, pod, existing_node, 1)
            if ex_has_anti:
                process_weighted_terms(ex_affinity.pod_anti_affinity.preferred,
                                       existing_pod, pod, existing_node, -1)

        for node_info in node_info_map.values():
            if node_info.node is None:
                continue
            if has_affinity or has_anti_affinity:
                pods = node_info.pods
            else:
                pods = [p for p in node_info.pods if p.spec.affinity is not None]
            for existing_pod in pods:
                process_pod(existing_pod)

        max_count = max(max((counts[n.name] for n in nodes), default=0), 0)
        min_count = min(min((counts[n.name] for n in nodes), default=0), 0)

        result = []
        for node in nodes:
            score = 0
            if (max_count - min_count) > 0:
                # exact rational form of Go's float64 normalize
                # (DEVIATIONS.md #16); numerator is nonnegative, so floor
                # division equals Go's toward-zero int() conversion
                score = (MAX_PRIORITY * (counts[node.name] - min_count)
                         ) // (max_count - min_count)
            result.append(HostPriority(node.name, score))
        return result


# ---------------------------------------------------------------------------
# priority metadata (algorithm/priorities/metadata.go)
# ---------------------------------------------------------------------------


@dataclass
class PriorityMetadata:
    nonzero_request: Optional[Resource] = None
    pod_tolerations: Optional[list] = None
    affinity: Optional[object] = None
    pod_selectors: Optional[list] = None
    controller_ref: Optional[object] = None


def get_priority_metadata(pod: Pod, selector_spread: Optional[SelectorSpread] = None
                          ) -> PriorityMetadata:
    return PriorityMetadata(
        nonzero_request=get_nonzero_pod_request(pod),
        pod_tolerations=_tolerations_prefer_no_schedule(pod.spec.tolerations),
        affinity=pod.spec.affinity,
        pod_selectors=(selector_spread._get_selectors(pod)
                       if selector_spread is not None else None),
        controller_ref=pod.metadata.controller_ref(),
    )
