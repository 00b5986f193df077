"""Fit predicates with the reference's ordering, semantics, and failure reasons.

Reference: algorithm/predicates/predicates.go. Each predicate has signature
``(pod, meta, node_info) -> (fits, [PredicateFailureReason])``; podFitsOnNode
runs them in PREDICATES_ORDERING and short-circuits on first failure unless
always_check_all_predicates (generic_scheduler.go:420-534).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpusim_torch.api.types import (
    LABEL_HOSTNAME,
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_NVIDIA_GPU,
    RESOURCE_PODS,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    Node,
    Pod,
    find_matching_untolerated_taint,
)
from tpusim_torch.engine import errors as err
from tpusim_torch.engine.resources import (
    NodeInfo,
    get_container_ports,
    get_resource_request,
    is_pod_best_effort,
)

# predicates.go:130-136 — evaluation (and reason-reporting) order
CHECK_NODE_CONDITION_PRED = "CheckNodeCondition"
CHECK_NODE_UNSCHEDULABLE_PRED = "CheckNodeUnschedulable"
GENERAL_PRED = "GeneralPredicates"
HOSTNAME_PRED = "HostName"
POD_FITS_HOST_PORTS_PRED = "PodFitsHostPorts"
MATCH_NODE_SELECTOR_PRED = "MatchNodeSelector"
POD_FITS_RESOURCES_PRED = "PodFitsResources"
NO_DISK_CONFLICT_PRED = "NoDiskConflict"
POD_TOLERATES_NODE_TAINTS_PRED = "PodToleratesNodeTaints"
POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED = "PodToleratesNodeNoExecuteTaints"
CHECK_NODE_LABEL_PRESENCE_PRED = "CheckNodeLabelPresence"
CHECK_SERVICE_AFFINITY_PRED = "CheckServiceAffinity"
MAX_EBS_VOLUME_COUNT_PRED = "MaxEBSVolumeCount"
MAX_GCE_PD_VOLUME_COUNT_PRED = "MaxGCEPDVolumeCount"
MAX_AZURE_DISK_VOLUME_COUNT_PRED = "MaxAzureDiskVolumeCount"
CHECK_VOLUME_BINDING_PRED = "CheckVolumeBinding"
NO_VOLUME_ZONE_CONFLICT_PRED = "NoVolumeZoneConflict"
CHECK_NODE_MEMORY_PRESSURE_PRED = "CheckNodeMemoryPressure"
CHECK_NODE_DISK_PRESSURE_PRED = "CheckNodeDiskPressure"
MATCH_INTERPOD_AFFINITY_PRED = "MatchInterPodAffinity"

PREDICATES_ORDERING = [
    CHECK_NODE_CONDITION_PRED, CHECK_NODE_UNSCHEDULABLE_PRED,
    GENERAL_PRED, HOSTNAME_PRED, POD_FITS_HOST_PORTS_PRED,
    MATCH_NODE_SELECTOR_PRED, POD_FITS_RESOURCES_PRED, NO_DISK_CONFLICT_PRED,
    POD_TOLERATES_NODE_TAINTS_PRED, POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
    CHECK_NODE_LABEL_PRESENCE_PRED,
    CHECK_SERVICE_AFFINITY_PRED, MAX_EBS_VOLUME_COUNT_PRED, MAX_GCE_PD_VOLUME_COUNT_PRED,
    MAX_AZURE_DISK_VOLUME_COUNT_PRED, CHECK_VOLUME_BINDING_PRED, NO_VOLUME_ZONE_CONFLICT_PRED,
    CHECK_NODE_MEMORY_PRESSURE_PRED, CHECK_NODE_DISK_PRESSURE_PRED,
    MATCH_INTERPOD_AFFINITY_PRED,
]

PredicateResult = tuple  # (bool, List[PredicateFailureReason])
FitPredicate = Callable[[Pod, Optional["PredicateMetadata"], NodeInfo], PredicateResult]


# ---------------------------------------------------------------------------
# predicate metadata (reference: algorithm/predicates/metadata.go:47-190)
# ---------------------------------------------------------------------------


@dataclass
class MatchingAntiAffinityTerm:
    term: object  # PodAffinityTerm
    node: Node


@dataclass
class PredicateMetadata:
    pod: Pod
    pod_best_effort: bool
    pod_request: object  # Resource
    pod_ports: list
    # existing-pod full name -> [MatchingAntiAffinityTerm] whose selector matched self.pod
    matching_anti_affinity_terms: Dict[str, List[MatchingAntiAffinityTerm]] = field(
        default_factory=dict)
    # extended resources managed (and ignored) by an extender
    # (RegisterPredicateMetadataProducerWithExtendedResourceOptions,
    # predicates.go:718-725)
    ignored_extended_resources: Optional[set] = None

    def add_pod(self, added_pod: Pod, node: Node) -> None:
        """metadata.go AddPod — incremental update for preemption simulations."""
        if added_pod.key() == self.pod.key():
            raise ValueError("added pod cannot be the same as the original pod")
        terms = get_matching_anti_affinity_terms_of_existing_pod(self.pod, added_pod, node)
        if terms:
            self.matching_anti_affinity_terms.setdefault(
                added_pod.key(), []).extend(terms)

    def remove_pod(self, deleted_pod: Pod) -> None:
        if deleted_pod.key() == self.pod.key():
            raise ValueError("deleted pod cannot be the same as the original pod")
        self.matching_anti_affinity_terms.pop(deleted_pod.key(), None)

    def shallow_copy(self) -> "PredicateMetadata":
        return PredicateMetadata(
            pod=self.pod,
            pod_best_effort=self.pod_best_effort,
            pod_request=self.pod_request,
            pod_ports=list(self.pod_ports),
            matching_anti_affinity_terms={
                k: list(v) for k, v in self.matching_anti_affinity_terms.items()},
        )


def get_namespaces_from_pod_affinity_term(pod: Pod, term) -> set:
    """priorityutil.GetNamespacesFromPodAffinityTerm: empty namespaces default
    to the term-owning pod's namespace."""
    if term.namespaces:
        return set(term.namespaces)
    return {pod.namespace}


def pod_matches_term_namespace_and_selector(target_pod: Pod, namespaces: set, selector) -> bool:
    """priorityutil.PodMatchesTermsNamespaceAndSelector; a nil selector matches
    nothing (LabelSelectorAsSelector(nil) == labels.Nothing())."""
    if target_pod.namespace not in namespaces:
        return False
    if selector is None:
        return False
    return selector.matches(target_pod.metadata.labels)


def nodes_have_same_topology_key(node_a: Optional[Node], node_b: Optional[Node],
                                 topology_key: str) -> bool:
    """priorityutil.NodesHaveSameTopologyKey."""
    if not topology_key or node_a is None or node_b is None:
        return False
    a = node_a.metadata.labels.get(topology_key)
    b = node_b.metadata.labels.get(topology_key)
    return a is not None and b is not None and a == b


def get_pod_affinity_terms(pod_affinity) -> list:
    """GetPodAffinityTerms: required terms only."""
    return list(pod_affinity.required) if pod_affinity is not None else []


def get_pod_anti_affinity_terms(pod_anti_affinity) -> list:
    return list(pod_anti_affinity.required) if pod_anti_affinity is not None else []


def get_matching_anti_affinity_terms_of_existing_pod(
        new_pod: Pod, existing_pod: Pod, node: Node) -> List[MatchingAntiAffinityTerm]:
    """predicates.go getMatchingAntiAffinityTermsOfExistingPod."""
    result: List[MatchingAntiAffinityTerm] = []
    affinity = existing_pod.spec.affinity
    if affinity is not None and affinity.pod_anti_affinity is not None:
        for term in get_pod_anti_affinity_terms(affinity.pod_anti_affinity):
            namespaces = get_namespaces_from_pod_affinity_term(existing_pod, term)
            if pod_matches_term_namespace_and_selector(new_pod, namespaces, term.label_selector):
                result.append(MatchingAntiAffinityTerm(term=term, node=node))
    return result


def get_matching_anti_affinity_terms(
        pod: Pod, node_info_map: Dict[str, NodeInfo]) -> Dict[str, List[MatchingAntiAffinityTerm]]:
    """predicates.go getMatchingAntiAffinityTerms, serial form."""
    result: Dict[str, List[MatchingAntiAffinityTerm]] = {}
    for node_info in node_info_map.values():
        node = node_info.node
        if node is None:
            continue
        for existing_pod in node_info.pods:
            terms = get_matching_anti_affinity_terms_of_existing_pod(pod, existing_pod, node)
            if terms:
                result.setdefault(existing_pod.key(), []).extend(terms)
    return result


def get_predicate_metadata(pod: Pod,
                           node_info_map: Dict[str, NodeInfo],
                           ignored_extended_resources: Optional[set] = None
                           ) -> PredicateMetadata:
    """The PredicateMetadataProducer (metadata.go:47-75)."""
    return PredicateMetadata(
        pod=pod,
        pod_best_effort=is_pod_best_effort(pod),
        pod_request=get_resource_request(pod),
        pod_ports=get_container_ports(pod),
        matching_anti_affinity_terms=get_matching_anti_affinity_terms(pod, node_info_map),
        ignored_extended_resources=ignored_extended_resources,
    )


# ---------------------------------------------------------------------------
# simple predicates
# ---------------------------------------------------------------------------


def pod_fits_resources(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:706-776."""
    if node_info.node is None:
        raise ValueError("node not found")
    fails: list = []
    allowed = node_info.allowed_pod_number()
    if len(node_info.pods) + 1 > allowed:
        fails.append(err.InsufficientResourceError(
            RESOURCE_PODS, 1, len(node_info.pods), allowed))

    pod_request = meta.pod_request if meta is not None else get_resource_request(pod)
    if (pod_request.milli_cpu == 0 and pod_request.memory == 0
            and pod_request.nvidia_gpu == 0 and pod_request.ephemeral_storage == 0
            and not pod_request.scalar):
        return (not fails), fails

    alloc = node_info.allocatable_resource
    used = node_info.requested_resource
    if alloc.milli_cpu < pod_request.milli_cpu + used.milli_cpu:
        fails.append(err.InsufficientResourceError(
            RESOURCE_CPU, pod_request.milli_cpu, used.milli_cpu, alloc.milli_cpu))
    if alloc.memory < pod_request.memory + used.memory:
        fails.append(err.InsufficientResourceError(
            RESOURCE_MEMORY, pod_request.memory, used.memory, alloc.memory))
    if alloc.nvidia_gpu < pod_request.nvidia_gpu + used.nvidia_gpu:
        fails.append(err.InsufficientResourceError(
            RESOURCE_NVIDIA_GPU, pod_request.nvidia_gpu, used.nvidia_gpu, alloc.nvidia_gpu))
    if alloc.ephemeral_storage < pod_request.ephemeral_storage + used.ephemeral_storage:
        fails.append(err.InsufficientResourceError(
            RESOURCE_EPHEMERAL_STORAGE, pod_request.ephemeral_storage,
            used.ephemeral_storage, alloc.ephemeral_storage))
    ignored = getattr(meta, "ignored_extended_resources", None) or set()
    for name, quant in pod_request.scalar.items():
        # extended resources managed by an IgnoredByScheduler extender are
        # skipped (predicates.go:754-761)
        if "/" in name and name in ignored:
            continue
        if alloc.scalar.get(name, 0) < quant + used.scalar.get(name, 0):
            fails.append(err.InsufficientResourceError(
                name, quant, used.scalar.get(name, 0), alloc.scalar.get(name, 0)))
    return (not fails), fails


def pod_matches_node_labels(pod: Pod, node: Node) -> bool:
    """Reference: predicates.go:778-846 (podMatchesNodeLabels +
    nodeMatchesNodeSelectorTerms): nodeSelector map AND required
    node-affinity. Terms are ORed in order; an empty term list matches
    nothing; a term whose selector fails validation (match_result None —
    NodeSelectorRequirementsAsSelector error) makes the whole affinity a
    non-match immediately."""
    if pod.spec.node_selector:
        for k, v in pod.spec.node_selector.items():
            if node.metadata.labels.get(k) != v:
                return False
    affinity = pod.spec.affinity
    if affinity is not None and affinity.node_affinity is not None:
        na = affinity.node_affinity
        if na.required_terms is not None:
            for t in na.required_terms:
                r = t.match_result(node.metadata.labels)
                if r is None:
                    return False  # parse error: "regarding as not match"
                if r:
                    break
            else:
                return False
    return True


def pod_match_node_selector(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    if node_info.node is None:
        raise ValueError("node not found")
    if pod_matches_node_labels(pod, node_info.node):
        return True, []
    return False, [err.ERR_NODE_SELECTOR_NOT_MATCH]


def pod_fits_host(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:853-865."""
    if not pod.spec.node_name:
        return True, []
    if node_info.node is None:
        raise ValueError("node not found")
    if pod.spec.node_name == node_info.node.name:
        return True, []
    return False, [err.ERR_POD_NOT_MATCH_HOST_NAME]


def pod_fits_host_ports(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:1019-1039."""
    want_ports = meta.pod_ports if meta is not None else get_container_ports(pod)
    if not want_ports:
        return True, []
    existing = node_info.used_ports
    for port in want_ports:
        if existing.check_conflict(port.host_ip, port.protocol, port.host_port):
            return False, [err.ERR_POD_NOT_FITS_HOST_PORTS]
    return True, []


def general_predicates(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:1059-1123 — PodFitsResources + PodFitsHost +
    PodFitsHostPorts + PodMatchNodeSelector, all evaluated (no short-circuit)."""
    fails: list = []
    for pred in (pod_fits_resources, pod_fits_host, pod_fits_host_ports,
                 pod_match_node_selector):
        fit, reasons = pred(pod, meta, node_info)
        if not fit:
            fails.extend(reasons)
    return (not fails), fails


def _taint_filter_no_schedule_no_execute(taint) -> bool:
    return taint.effect in (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE)


def _taint_filter_no_execute(taint) -> bool:
    return taint.effect == TAINT_NO_EXECUTE


def pod_tolerates_node_taints(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:1465-1478."""
    taint = find_matching_untolerated_taint(
        node_info.taints, pod.spec.tolerations, _taint_filter_no_schedule_no_execute)
    if taint is None:
        return True, []
    return False, [err.ERR_TAINTS_TOLERATIONS_NOT_MATCH]


def pod_tolerates_node_no_execute_taints(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    taint = find_matching_untolerated_taint(
        node_info.taints, pod.spec.tolerations, _taint_filter_no_execute)
    if taint is None:
        return True, []
    return False, [err.ERR_TAINTS_TOLERATIONS_NOT_MATCH]


def check_node_memory_pressure(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:1502-1521 — only BestEffort pods are rejected."""
    best_effort = meta.pod_best_effort if meta is not None else is_pod_best_effort(pod)
    if not best_effort:
        return True, []
    if node_info.memory_pressure_condition():
        return False, [err.ERR_NODE_UNDER_MEMORY_PRESSURE]
    return True, []


def check_node_disk_pressure(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    if node_info.disk_pressure_condition():
        return False, [err.ERR_NODE_UNDER_DISK_PRESSURE]
    return True, []


def check_node_condition(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go:1533-1561 — Ready/OutOfDisk/NetworkUnavailable
    conditions plus spec.unschedulable."""
    if node_info is None or node_info.node is None:
        return False, [err.ERR_NODE_UNKNOWN_CONDITION]
    node = node_info.node
    reasons: list = []
    for cond in node.status.conditions:
        if cond.type == "Ready" and cond.status != "True":
            reasons.append(err.ERR_NODE_NOT_READY)
        elif cond.type == "OutOfDisk" and cond.status != "False":
            reasons.append(err.ERR_NODE_OUT_OF_DISK)
        elif cond.type == "NetworkUnavailable" and cond.status != "False":
            reasons.append(err.ERR_NODE_NETWORK_UNAVAILABLE)
    if node.spec.unschedulable:
        reasons.append(err.ERR_NODE_UNSCHEDULABLE)
    return (not reasons), reasons


def check_node_unschedulable(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """CheckNodeUnschedulablePred (registered under TaintNodesByCondition)."""
    if node_info.node is None:
        return False, [err.ERR_NODE_UNKNOWN_CONDITION]
    if node_info.node.spec.unschedulable:
        return False, [err.ERR_NODE_UNSCHEDULABLE]
    return True, []


# ---------------------------------------------------------------------------
# volume predicates (predicates.go:220-276, 288-533, 1563-1619)
# ---------------------------------------------------------------------------


def _have_overlap(a: list, b: list) -> bool:
    """predicates.go haveOverlap — any shared element."""
    if len(a) > len(b):
        a, b = b, a
    s = set(a)
    return any(x in s for x in b)


def is_volume_conflict(volume, pod: Pod) -> bool:
    """predicates.go isVolumeConflict:220-264 — GCE PD (read-only OK),
    AWS EBS (any sharing conflicts), ISCSI (same IQN, not both read-only),
    RBD (overlapping monitors + same pool/image, not both read-only)."""
    gce, ebs = volume.gce_persistent_disk, volume.aws_elastic_block_store
    rbd, iscsi = volume.rbd, volume.iscsi
    if gce is None and ebs is None and rbd is None and iscsi is None:
        return False
    for existing in pod.spec.volumes:
        egce = existing.gce_persistent_disk
        if gce is not None and egce is not None:
            if gce.get("pdName") == egce.get("pdName") and not (
                    gce.get("readOnly") and egce.get("readOnly")):
                return True
        eebs = existing.aws_elastic_block_store
        if ebs is not None and eebs is not None:
            if ebs.get("volumeID") == eebs.get("volumeID"):
                return True
        eiscsi = existing.iscsi
        if iscsi is not None and eiscsi is not None:
            if iscsi.get("iqn") == eiscsi.get("iqn") and not (
                    iscsi.get("readOnly") and eiscsi.get("readOnly")):
                return True
        erbd = existing.rbd
        if rbd is not None and erbd is not None:
            if (_have_overlap(rbd.get("monitors") or [], erbd.get("monitors") or [])
                    and rbd.get("pool") == erbd.get("pool")
                    and rbd.get("image") == erbd.get("image")
                    and not (rbd.get("readOnly") and erbd.get("readOnly"))):
                return True
    return False


def no_disk_conflict(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
    """Reference: predicates.go NoDiskConflict:266-276."""
    for volume in pod.spec.volumes:
        for existing in node_info.pods:
            if is_volume_conflict(volume, existing):
                return False, [err.ERR_DISK_CONFLICT]
    return True, []


# MaxPDVolumeCount (predicates.go:288-460)

EBS_VOLUME_FILTER_TYPE = "EBS"
GCE_PD_VOLUME_FILTER_TYPE = "GCE"
AZURE_DISK_VOLUME_FILTER_TYPE = "AzureDisk"

DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16
# (EBS, GCE PD, AzureDisk) — the tuple order the device routes' MaxPD
# stage uses; single source for the host and the device
DEFAULT_MAXPD_LIMITS = (DEFAULT_MAX_EBS_VOLUMES, DEFAULT_MAX_GCE_PD_VOLUMES,
                        DEFAULT_MAX_AZURE_DISK_VOLUMES)
KUBE_MAX_PD_VOLS_ENV = "KUBE_MAX_PD_VOLS"

_VOLUME_FILTERS = {
    # (volume source accessor, PV source accessor, id field)
    EBS_VOLUME_FILTER_TYPE: (
        lambda v: v.aws_elastic_block_store, lambda pv: pv.aws_elastic_block_store,
        "volumeID", DEFAULT_MAX_EBS_VOLUMES),
    GCE_PD_VOLUME_FILTER_TYPE: (
        lambda v: v.gce_persistent_disk, lambda pv: pv.gce_persistent_disk,
        "pdName", DEFAULT_MAX_GCE_PD_VOLUMES),
    AZURE_DISK_VOLUME_FILTER_TYPE: (
        lambda v: v.azure_disk, lambda pv: pv.azure_disk,
        "diskName", DEFAULT_MAX_AZURE_DISK_VOLUMES),
}


def get_max_vols(default: int) -> int:
    """predicates.go getMaxVols: KUBE_MAX_PD_VOLS env override when valid."""
    import os

    raw = os.environ.get(KUBE_MAX_PD_VOLS_ENV, "")
    if raw:
        try:
            parsed = int(raw)
        except ValueError:
            return default
        if parsed > 0:
            return parsed
    return default


def effective_maxpd_limits() -> tuple:
    """The three per-type limits with the env override applied."""
    return tuple(get_max_vols(d) for d in DEFAULT_MAXPD_LIMITS)


def make_max_pd_volume_count_predicate(
        filter_type: str, pvc_getter=None, pv_getter=None,
        max_volumes: Optional[int] = None) -> FitPredicate:
    """Reference: predicates.go NewMaxPDVolumeCountPredicate:306-345 +
    filterVolumes:361-420 + predicate:422-460. Counts unique relevant volume
    ids (direct + resolved through PVC->PV); unresolvable PVCs count
    conservatively under a synthetic id."""
    if filter_type not in _VOLUME_FILTERS:
        raise KeyError(
            f"Wrong filterName, Only Support {EBS_VOLUME_FILTER_TYPE} "
            f"{GCE_PD_VOLUME_FILTER_TYPE} {AZURE_DISK_VOLUME_FILTER_TYPE}")
    vol_src, pv_src, id_field, default_max = _VOLUME_FILTERS[filter_type]
    limit = max_volumes if max_volumes is not None else get_max_vols(default_max)
    pvc_getter = pvc_getter or (lambda namespace, name: None)
    pv_getter = pv_getter or (lambda name: None)

    def filter_volumes(volumes, namespace: str, filtered: set) -> None:
        for vol in volumes:
            src = vol_src(vol)
            if src is not None:
                filtered.add((filter_type, src.get(id_field, "")))
                continue
            pvc_name = vol.pvc_name
            if pvc_name is None:
                continue
            if pvc_name == "":
                raise err.PredicateError("PersistentVolumeClaim had no name")
            # stand-in id: unresolvable claims count toward the limit
            # (predicates.go:379-410 logs and assumes relevant)
            pvc_id = ("pvc", f"{namespace}/{pvc_name}")
            pvc = pvc_getter(namespace, pvc_name)
            if pvc is None:
                filtered.add(pvc_id)
                continue
            pv_name = pvc.volume_name
            if not pv_name:
                filtered.add(pvc_id)
                continue
            pv = pv_getter(pv_name)
            if pv is None:
                filtered.add(pvc_id)
                continue
            pv_source = pv_src(pv)
            if pv_source is not None:
                filtered.add((filter_type, pv_source.get(id_field, "")))

    def max_pd_volume_count(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
        if not pod.spec.volumes:
            return True, []
        new_volumes: set = set()
        filter_volumes(pod.spec.volumes, pod.namespace, new_volumes)
        if not new_volumes:
            return True, []
        existing: set = set()
        for existing_pod in node_info.pods:
            filter_volumes(existing_pod.spec.volumes, existing_pod.namespace,
                           existing)
        if len(existing | new_volumes) > limit:
            return False, [err.ERR_MAX_VOLUME_COUNT_EXCEEDED]
        return True, []

    max_pd_volume_count.__name__ = f"max_{filter_type.lower()}_volume_count"
    return max_pd_volume_count


# NoVolumeZoneConflict (predicates.go:510-533 VolumeZoneChecker.predicate)

LABEL_ZONE_FAILURE_DOMAIN = "failure-domain.beta.kubernetes.io/zone"
LABEL_ZONE_REGION = "failure-domain.beta.kubernetes.io/region"
_ZONE_LABELS = (LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION)


def label_zones_to_set(value: str) -> set:
    """volumeutil.LabelZonesToSet: '__'-separated zone list; raises on an
    empty element (ZonesToSet errors)."""
    zones = set()
    for zone in value.split("__"):
        if zone == "":
            raise ValueError(
                f"{value} content is not valid, content should not be empty")
        zones.add(zone)
    return zones


def make_no_volume_zone_conflict_predicate(
        pvc_getter=None, pv_getter=None, class_getter=None,
        volume_scheduling_enabled: bool = False) -> FitPredicate:
    """Reference: predicates.go VolumeZoneChecker.predicate:510-533 — bound
    PVs' zone/region labels must include the node's value for the same label."""
    pvc_getter = pvc_getter or (lambda namespace, name: None)
    pv_getter = pv_getter or (lambda name: None)
    class_getter = class_getter or (lambda name: None)

    def no_volume_zone_conflict(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
        if not pod.spec.volumes:
            return True, []
        node = node_info.node
        if node is None:
            raise err.PredicateError("node not found")
        constraints = {k: v for k, v in node.metadata.labels.items()
                       if k in _ZONE_LABELS}
        if not constraints:
            return True, []
        for volume in pod.spec.volumes:
            pvc_name = volume.pvc_name
            if pvc_name is None:
                continue
            if pvc_name == "":
                raise err.PredicateError("PersistentVolumeClaim had no name")
            pvc = pvc_getter(pod.namespace, pvc_name)
            if pvc is None:
                raise err.PredicateError(
                    f'PersistentVolumeClaim was not found: "{pvc_name}"')
            pv_name = pvc.volume_name
            if not pv_name:
                if volume_scheduling_enabled:
                    sc_name = pvc.storage_class_name
                    if sc_name:
                        sc = class_getter(sc_name)
                        if sc is not None:
                            from tpusim_torch.api.types import VOLUME_BINDING_WAIT

                            if sc.volume_binding_mode is None:
                                raise err.PredicateError(
                                    "VolumeBindingMode not set for "
                                    f'StorageClass "{sc_name}"')
                            if sc.volume_binding_mode == VOLUME_BINDING_WAIT:
                                continue  # skip unbound delayed-binding volumes
                raise err.PredicateError(
                    f'PersistentVolumeClaim is not bound: "{pvc_name}"')
            pv = pv_getter(pv_name)
            if pv is None:
                raise err.PredicateError(
                    f'PersistentVolume not found: "{pv_name}"')
            for k, v in pv.metadata.labels.items():
                if k not in _ZONE_LABELS:
                    continue
                node_value = constraints.get(k)
                try:
                    volume_zones = label_zones_to_set(v)
                except ValueError:
                    continue  # unparsable label ignored (predicates.go:555-558)
                if node_value not in volume_zones:
                    return False, [err.ERR_VOLUME_ZONE_CONFLICT]
        return True, []

    return no_volume_zone_conflict


def make_check_volume_binding_predicate(binder) -> FitPredicate:
    """Reference: predicates.go VolumeBindingChecker.predicate:1586-1619 over a
    volume.VolumeBinder; trivially true while the VolumeScheduling feature gate
    is off (the reference's default)."""
    from tpusim_torch.engine.volume import VolumeBinderError

    def check_volume_binding(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
        if binder is None or not binder.enabled:
            return True, []
        node = node_info.node
        if node is None:
            raise err.PredicateError("node not found")
        try:
            unbound_ok, bound_ok = binder.find_pod_volumes(pod, node)
        except VolumeBinderError as exc:
            raise err.PredicateError(str(exc))
        reasons = []
        if not bound_ok:
            reasons.append(err.ERR_VOLUME_NODE_CONFLICT)
        if not unbound_ok:
            reasons.append(err.ERR_VOLUME_BIND_CONFLICT)
        if reasons:
            return False, reasons
        return True, []

    return check_volume_binding


# ---------------------------------------------------------------------------
# label-presence / service-affinity (policy-configured)
# ---------------------------------------------------------------------------


def make_node_label_presence_predicate(labels: List[str], presence: bool) -> FitPredicate:
    """Reference: predicates.go NewNodeLabelPredicate (policy-configured)."""

    def check_node_label_presence(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
        if node_info.node is None:
            raise ValueError("node not found")
        node_labels = node_info.node.metadata.labels
        for label in labels:
            exists = label in node_labels
            if exists != presence:
                return False, [err.ERR_NODE_LABEL_PRESENCE_VIOLATED]
        return True, []

    return check_node_label_presence


def make_service_affinity_predicate(affinity_labels: List[str],
                                    pod_lister: Callable[[], List[Pod]],
                                    service_lister: Callable[[], list],
                                    node_getter: Callable[[str], Optional[Node]] = lambda name: None,
                                    ) -> FitPredicate:
    """Reference: predicates.go NewServiceAffinityPredicate (policy-configured).

    The pod must land on a node whose values for ``affinity_labels`` equal the
    values on the node of an arbitrary existing pod of the same service (or the
    pod's own nodeSelector values when no service peer exists). ``node_getter``
    resolves a peer pod's nodeName to its Node.
    """

    def check_service_affinity(pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
        if node_info.node is None:
            raise ValueError("node not found")
        # labels the pod itself pins via its nodeSelector
        affinity_selector = {k: v for k, v in (pod.spec.node_selector or {}).items()
                             if k in affinity_labels}
        unresolved = [l for l in affinity_labels if l not in affinity_selector]
        if unresolved:
            services = [s for s in service_lister()
                        if s.namespace == pod.namespace and s.selector
                        and all(pod.metadata.labels.get(k) == v
                                for k, v in s.selector.items())]
            if services:
                selector = services[0].selector
                service_pods = [p for p in pod_lister()
                                if p.namespace == pod.namespace
                                and all(p.metadata.labels.get(k) == v
                                        for k, v in selector.items())]
                if service_pods:
                    first = service_pods[0]
                    if first.spec.node_name:
                        other = node_getter(first.spec.node_name)
                        # the factory wires the scheduler cache's NodeInfo
                        # getter (providers.py register_custom_fit_predicate);
                        # accept a bare Node too
                        other_node = getattr(other, "node", other)
                        if other_node is not None:
                            labels = other_node.metadata.labels
                            for l in unresolved:
                                if l in labels:
                                    affinity_selector[l] = labels[l]
        node_labels = node_info.node.metadata.labels
        for k, v in affinity_selector.items():
            if node_labels.get(k) != v:
                return False, [err.ERR_SERVICE_AFFINITY_VIOLATED]
        return True, []

    return check_service_affinity


# ---------------------------------------------------------------------------
# inter-pod affinity (reference: predicates.go:1125-1450, PodAffinityChecker)
# ---------------------------------------------------------------------------


class PodAffinityChecker:
    def __init__(self, node_info_getter: Callable[[str], Optional[NodeInfo]],
                 pod_lister: Callable[[], List[Pod]]):
        self._node_info = node_info_getter
        self._pod_lister = pod_lister

    def _filtered_pods(self, node_info: NodeInfo) -> List[Pod]:
        """podLister.FilteredList(nodeInfo.Filter): drop pods that claim
        node_info's node but aren't tracked in it; pods elsewhere pass."""
        node = node_info.node
        tracked = {p.key() for p in node_info.pods}
        out = []
        for p in self._pod_lister():
            if node is not None and p.spec.node_name == node.name and p.key() not in tracked:
                continue
            out.append(p)
        return out

    def interpod_affinity_matches(self, pod: Pod, meta, node_info: NodeInfo) -> PredicateResult:
        if node_info.node is None:
            raise ValueError("node not found")
        failed = self._satisfies_existing_pods_anti_affinity(pod, meta, node_info)
        if failed is not None:
            return False, [err.ERR_POD_AFFINITY_NOT_MATCH, failed]
        affinity = pod.spec.affinity
        if affinity is None or (affinity.pod_affinity is None
                                and affinity.pod_anti_affinity is None):
            return True, []
        failed = self._satisfies_pods_affinity_anti_affinity(pod, node_info, affinity)
        if failed is not None:
            return False, [err.ERR_POD_AFFINITY_NOT_MATCH, failed]
        return True, []

    def _satisfies_existing_pods_anti_affinity(self, pod: Pod, meta,
                                               node_info: NodeInfo):
        node = node_info.node
        if meta is not None:
            matching_terms = meta.matching_anti_affinity_terms
        else:
            filtered = self._filtered_pods(node_info)
            matching_terms = {}
            for existing in filtered:
                existing_node_info = self._node_info(existing.spec.node_name)
                if existing_node_info is None or existing_node_info.node is None:
                    continue
                terms = get_matching_anti_affinity_terms_of_existing_pod(
                    pod, existing, existing_node_info.node)
                if terms:
                    matching_terms.setdefault(existing.key(), []).extend(terms)
        for terms in matching_terms.values():
            for mt in terms:
                if not mt.term.topology_key:
                    return err.ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH
                if nodes_have_same_topology_key(node, mt.node, mt.term.topology_key):
                    return err.ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH
        return None

    def _any_pod_matches_term(self, pod: Pod, pods: List[Pod], node_info: NodeInfo,
                              term) -> tuple[bool, bool]:
        if not term.topology_key:
            raise ValueError("empty topologyKey is not allowed except for "
                             "PreferredDuringScheduling pod anti-affinity")
        matching_pod_exists = False
        namespaces = get_namespaces_from_pod_affinity_term(pod, term)
        selector = term.label_selector
        # predicates.go: topologyKey == hostname restricts the search to this node
        pods_to_check = node_info.pods if term.topology_key == LABEL_HOSTNAME else pods
        for existing in pods_to_check:
            if pod_matches_term_namespace_and_selector(existing, namespaces, selector):
                matching_pod_exists = True
                existing_node_info = self._node_info(existing.spec.node_name)
                existing_node = existing_node_info.node if existing_node_info else None
                if nodes_have_same_topology_key(node_info.node, existing_node,
                                                term.topology_key):
                    return True, True
        return False, matching_pod_exists

    def _satisfies_pods_affinity_anti_affinity(self, pod: Pod, node_info: NodeInfo,
                                               affinity):
        filtered = self._filtered_pods(node_info)
        for term in get_pod_affinity_terms(affinity.pod_affinity):
            try:
                term_matches, matching_pod_exists = self._any_pod_matches_term(
                    pod, filtered, node_info, term)
            except ValueError:
                return err.ERR_POD_AFFINITY_RULES_NOT_MATCH
            if not term_matches:
                # first-pod-of-its-group special case (predicates.go:1303-1320)
                if matching_pod_exists:
                    return err.ERR_POD_AFFINITY_RULES_NOT_MATCH
                namespaces = get_namespaces_from_pod_affinity_term(pod, term)
                if not pod_matches_term_namespace_and_selector(
                        pod, namespaces, term.label_selector):
                    return err.ERR_POD_AFFINITY_RULES_NOT_MATCH
        for term in get_pod_anti_affinity_terms(affinity.pod_anti_affinity):
            try:
                term_matches, _ = self._any_pod_matches_term(pod, filtered, node_info, term)
            except ValueError:
                return err.ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH
            if term_matches:
                return err.ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH
        return None


def make_pod_affinity_predicate(node_info_getter, pod_lister) -> FitPredicate:
    return PodAffinityChecker(node_info_getter, pod_lister).interpod_affinity_matches
