"""The predicate names and their evaluation order, and the predicate helpers
the cluster compile step evaluates per (signature, node) cell.

Reference: predicates.go:130-136 (the ordering), predicates.go:778-846
(podMatchesNodeLabels + nodeMatchesNodeSelectorTerms), the volume
predicates' helpers (predicates.go:220-533) and the inter-pod term helpers
(priorityutil/topologies.go, predicates.go GetPodAffinityTerms).
"""

from __future__ import annotations

import os

from tpusim_torch.api.types import (
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
    Node,
    Pod,
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


def pod_matches_node_labels(pod: Pod, node: Node) -> bool:
    """nodeSelector map AND required node-affinity. Terms are ORed in order;
    an empty term list matches nothing; a term whose selector fails
    validation (match_result None — NodeSelectorRequirementsAsSelector
    error) makes the whole affinity a non-match immediately."""
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


# ---------------------------------------------------------------------------
# inter-pod (anti)affinity terms: the helpers the group compile step uses to
# intern terms and match them against pod groups
# ---------------------------------------------------------------------------


def get_namespaces_from_pod_affinity_term(pod: Pod, term) -> set:
    """priorityutil.GetNamespacesFromPodAffinityTerm: empty namespaces default
    to the term-owning pod's namespace."""
    if term.namespaces:
        return set(term.namespaces)
    return {pod.namespace}


def pod_matches_term_namespace_and_selector(target_pod: Pod, namespaces: set,
                                            selector) -> bool:
    """priorityutil.PodMatchesTermsNamespaceAndSelector; a nil selector matches
    nothing (LabelSelectorAsSelector(nil) == labels.Nothing())."""
    if target_pod.namespace not in namespaces:
        return False
    if selector is None:
        return False
    return selector.matches(target_pod.metadata.labels)


def get_pod_affinity_terms(pod_affinity) -> list:
    """GetPodAffinityTerms: required terms only."""
    return list(pod_affinity.required) if pod_affinity is not None else []


def get_pod_anti_affinity_terms(pod_anti_affinity) -> list:
    return (list(pod_anti_affinity.required)
            if pod_anti_affinity is not None else [])


# ---------------------------------------------------------------------------
# volume predicates (predicates.go:220-276, 288-460, 510-533): the helpers
# the group compile step evaluates per volume set
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


# MaxPDVolumeCount (predicates.go:288-460)

DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16
# (EBS, GCE PD, AzureDisk): the order of the kernel's per-type limits
DEFAULT_MAXPD_LIMITS = (DEFAULT_MAX_EBS_VOLUMES, DEFAULT_MAX_GCE_PD_VOLUMES,
                        DEFAULT_MAX_AZURE_DISK_VOLUMES)
KUBE_MAX_PD_VOLS_ENV = "KUBE_MAX_PD_VOLS"

_VOLUME_FILTERS = {
    # (volume source accessor, PV source accessor, id field, default limit)
    "EBS": (lambda v: v.aws_elastic_block_store,
            lambda pv: pv.aws_elastic_block_store, "volumeID",
            DEFAULT_MAX_EBS_VOLUMES),
    "GCE": (lambda v: v.gce_persistent_disk,
            lambda pv: pv.gce_persistent_disk, "pdName",
            DEFAULT_MAX_GCE_PD_VOLUMES),
    "AzureDisk": (lambda v: v.azure_disk, lambda pv: pv.azure_disk,
                  "diskName", DEFAULT_MAX_AZURE_DISK_VOLUMES),
}


def get_max_vols(default: int) -> int:
    """predicates.go getMaxVols: KUBE_MAX_PD_VOLS env override when valid."""
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


# NoVolumeZoneConflict (predicates.go:510-533)

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
