"""Predicate failure reasons.

Reference: algorithm/predicates/error.go — the reason strings become the
report's failure histogram, so they must match byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass


class PredicateError(Exception):
    """A hard predicate-evaluation error (the Go predicate's non-nil err
    return): findNodesThatFit aggregates these per message and aborts the
    pod's scheduling (generic_scheduler.go:330-352)."""


class PredicateFailureReason:
    def get_reason(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class PredicateFailureError(PredicateFailureReason):
    predicate_name: str
    predicate_desc: str

    def get_reason(self) -> str:
        return self.predicate_desc


@dataclass(frozen=True)
class InsufficientResourceError(PredicateFailureReason):
    """Reference: error.go:101-135."""

    resource_name: str
    requested: int
    used: int
    capacity: int

    def get_reason(self) -> str:
        return f"Insufficient {self.resource_name}"

    def get_insufficient_amount(self) -> int:
        return self.requested - (self.capacity - self.used)


@dataclass(frozen=True)
class FailureReason(PredicateFailureReason):
    reason: str

    def get_reason(self) -> str:
        return self.reason


def _e(name: str, desc: str) -> PredicateFailureError:
    return PredicateFailureError(name, desc)


ERR_DISK_CONFLICT = _e("NoDiskConflict", "node(s) had no available disk")
ERR_VOLUME_ZONE_CONFLICT = _e("NoVolumeZoneConflict", "node(s) had no available volume zone")
ERR_NODE_SELECTOR_NOT_MATCH = _e("MatchNodeSelector", "node(s) didn't match node selector")
ERR_POD_AFFINITY_NOT_MATCH = _e("MatchInterPodAffinity",
                                "node(s) didn't match pod affinity/anti-affinity")
ERR_POD_AFFINITY_RULES_NOT_MATCH = _e("PodAffinityRulesNotMatch",
                                      "node(s) didn't match pod affinity rules")
ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH = _e("PodAntiAffinityRulesNotMatch",
                                           "node(s) didn't match pod anti-affinity rules")
ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH = _e(
    "ExistingPodsAntiAffinityRulesNotMatch",
    "node(s) didn't satisfy existing pods anti-affinity rules")
ERR_TAINTS_TOLERATIONS_NOT_MATCH = _e("PodToleratesNodeTaints",
                                      "node(s) had taints that the pod didn't tolerate")
ERR_POD_NOT_MATCH_HOST_NAME = _e("HostName", "node(s) didn't match the requested hostname")
ERR_POD_NOT_FITS_HOST_PORTS = _e("PodFitsHostPorts",
                                 "node(s) didn't have free ports for the requested pod ports")
ERR_NODE_LABEL_PRESENCE_VIOLATED = _e("CheckNodeLabelPresence",
                                      "node(s) didn't have the requested labels")
ERR_SERVICE_AFFINITY_VIOLATED = _e("CheckServiceAffinity", "node(s) didn't match service affinity")
ERR_MAX_VOLUME_COUNT_EXCEEDED = _e("MaxVolumeCount", "node(s) exceed max volume count")
ERR_NODE_UNDER_MEMORY_PRESSURE = _e("NodeUnderMemoryPressure", "node(s) had memory pressure")
ERR_NODE_UNDER_DISK_PRESSURE = _e("NodeUnderDiskPressure", "node(s) had disk pressure")
ERR_NODE_OUT_OF_DISK = _e("NodeOutOfDisk", "node(s) were out of disk space")
ERR_NODE_NOT_READY = _e("NodeNotReady", "node(s) were not ready")
ERR_NODE_NETWORK_UNAVAILABLE = _e("NodeNetworkUnavailable", "node(s) had unavailable network")
ERR_NODE_UNSCHEDULABLE = _e("NodeUnschedulable", "node(s) were unschedulable")
ERR_NODE_UNKNOWN_CONDITION = _e("NodeUnknownCondition", "node(s) had unknown conditions")
ERR_VOLUME_NODE_CONFLICT = _e("VolumeNodeAffinityConflict",
                              "node(s) had volume node affinity conflict")
ERR_VOLUME_BIND_CONFLICT = _e("VolumeBindingNoMatch",
                              "node(s) didn't find available persistent volumes to bind")
ERR_FAKE_PREDICATE = _e("FakePredicateError", "Nodes failed the fake predicate")
