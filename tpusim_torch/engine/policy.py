"""Scheduler policy-as-data: the Policy schema, validation, and loaders.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/api/types.go:52-160 (Policy,
PredicatePolicy, PriorityPolicy, PredicateArgument, PriorityArgument,
ExtenderConfig, ExtenderManagedResource), api/validation/validation.go:34-67
(ValidatePolicy), and the two sourcing paths in pkg/scheduler/simulator.go:
372-424 — policy from a serialized file, or from a ConfigMap object under the
key "policy.cfg" (componentconfig.SchedulerPolicyConfigMapKey,
apis/componentconfig/types.go:41).

The JSON/YAML wire shape matches schedulerapi/v1 (kind: Policy,
apiVersion: v1) so existing kube-scheduler policy files load unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

MAX_PRIORITY = 10  # api/types.go:36
MAX_INT = 2**63 - 1
MAX_WEIGHT = MAX_INT // MAX_PRIORITY  # api/types.go:38


class PolicyError(ValueError):
    """Invalid policy configuration (the Go side aggregates field errors)."""


# ---------------------------------------------------------------------------
# schema (api/types.go:52-160)
# ---------------------------------------------------------------------------


@dataclass
class ServiceAffinityArg:
    """api/types.go ServiceAffinity: node labels that must all match for a node
    to host pods of the same service group."""
    labels: List[str] = field(default_factory=list)


@dataclass
class LabelsPresenceArg:
    """api/types.go LabelsPresence: labels required present (or absent)."""
    labels: List[str] = field(default_factory=list)
    presence: bool = False


@dataclass
class ServiceAntiAffinityArg:
    """api/types.go ServiceAntiAffinity: the node label identifying groups."""
    label: str = ""


@dataclass
class LabelPreferenceArg:
    """api/types.go LabelPreference."""
    label: str = ""
    presence: bool = False


@dataclass
class PredicateArgument:
    """Only one member may be set (api/types.go:101-110)."""
    service_affinity: Optional[ServiceAffinityArg] = None
    labels_presence: Optional[LabelsPresenceArg] = None


@dataclass
class PriorityArgument:
    """Only one member may be set (api/types.go:112-121)."""
    service_anti_affinity: Optional[ServiceAntiAffinityArg] = None
    label_preference: Optional[LabelPreferenceArg] = None


@dataclass
class PredicatePolicy:
    name: str = ""
    argument: Optional[PredicateArgument] = None


@dataclass
class PriorityPolicy:
    name: str = ""
    weight: int = 0
    argument: Optional[PriorityArgument] = None


@dataclass
class ExtenderManagedResource:
    name: str = ""
    ignored_by_scheduler: bool = False


@dataclass
class ExtenderConfig:
    """api/types.go:164-205. TLS options are accepted but unused (the offline
    transport is in-process; a real HTTP transport honors url_prefix only)."""
    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    weight: int = 0
    bind_verb: str = ""
    enable_https: bool = False
    tls_config: Optional[dict] = None
    http_timeout: float = 0.0  # seconds; 0 → DefaultExtenderTimeout (5s)
    node_cache_capable: bool = False
    managed_resources: List[ExtenderManagedResource] = field(default_factory=list)


@dataclass
class Policy:
    """api/types.go:52-77. Semantics preserved exactly:
    predicates=None → provider defaults; predicates=[] → only mandatory
    predicates; priorities=None → provider defaults; priorities=[] → none."""
    predicates: Optional[List[PredicatePolicy]] = None
    priorities: Optional[List[PriorityPolicy]] = None
    extender_configs: List[ExtenderConfig] = field(default_factory=list)
    hard_pod_affinity_symmetric_weight: int = 0
    always_check_all_predicates: bool = False


# ---------------------------------------------------------------------------
# validation (api/validation/validation.go:34-67)
# ---------------------------------------------------------------------------


def validate_policy(policy: Policy) -> None:
    errors: List[str] = []
    for priority in policy.priorities or []:
        if priority.weight <= 0 or priority.weight >= MAX_WEIGHT:
            errors.append(
                f"Priority {priority.name} should have a positive weight "
                "applied to it or it has overflown")
    binders = 0
    seen_resources = set()
    for ext in policy.extender_configs:
        if ext.prioritize_verb and ext.weight <= 0:
            errors.append(f"Priority for extender {ext.url_prefix} should have "
                          "a positive weight applied to it")
        if ext.bind_verb:
            binders += 1
        for resource in ext.managed_resources:
            if "/" not in resource.name:
                errors.append(f"{resource.name} is an invalid extended resource name")
            if resource.name in seen_resources:
                errors.append("Duplicate extender managed resource name "
                              f"{resource.name}")
            seen_resources.add(resource.name)
    if binders > 1:
        errors.append(f"Only one extender can implement bind, found {binders}")
    if errors:
        raise PolicyError("; ".join(errors))


# ---------------------------------------------------------------------------
# decoding (schedulerapi/v1 JSON/YAML wire shape)
# ---------------------------------------------------------------------------


def _decode_predicate(o: dict) -> PredicatePolicy:
    arg = None
    a = o.get("argument")
    if a:
        sa, lp = a.get("serviceAffinity"), a.get("labelsPresence")
        arg = PredicateArgument(
            service_affinity=ServiceAffinityArg(labels=list(sa.get("labels") or []))
            if sa is not None else None,
            labels_presence=LabelsPresenceArg(
                labels=list(lp.get("labels") or []),
                presence=bool(lp.get("presence", False)))
            if lp is not None else None)
    return PredicatePolicy(name=o.get("name", ""), argument=arg)


def _decode_priority(o: dict) -> PriorityPolicy:
    arg = None
    a = o.get("argument")
    if a:
        saa, lp = a.get("serviceAntiAffinity"), a.get("labelPreference")
        arg = PriorityArgument(
            service_anti_affinity=ServiceAntiAffinityArg(label=saa.get("label", ""))
            if saa is not None else None,
            label_preference=LabelPreferenceArg(
                label=lp.get("label", ""),
                presence=bool(lp.get("presence", False)))
            if lp is not None else None)
    return PriorityPolicy(name=o.get("name", ""), weight=int(o.get("weight", 0)),
                          argument=arg)


def _decode_extender(o: dict) -> ExtenderConfig:
    managed = [ExtenderManagedResource(name=m.get("name", ""),
                                       ignored_by_scheduler=bool(
                                           m.get("ignoredByScheduler", False)))
               for m in o.get("managedResources") or []]
    # the Go type uses time.Duration (nanoseconds) in the internal type but
    # the v1 JSON carries it as nanoseconds too; accept seconds if small floats
    timeout = o.get("httpTimeout", 0) or 0
    if isinstance(timeout, (int, float)) and timeout > 1e6:
        timeout = timeout / 1e9  # nanoseconds → seconds
    return ExtenderConfig(
        url_prefix=o.get("urlPrefix", ""),
        filter_verb=o.get("filterVerb", ""),
        prioritize_verb=o.get("prioritizeVerb", ""),
        weight=int(o.get("weight", 0)),
        bind_verb=o.get("bindVerb", ""),
        enable_https=bool(o.get("enableHttps", False)),
        tls_config=o.get("tlsConfig"),
        http_timeout=float(timeout),
        node_cache_capable=bool(o.get("nodeCacheCapable", False)),
        managed_resources=managed)


def decode_policy(obj: dict) -> Policy:
    """Decode a schedulerapi/v1 Policy object (already parsed from JSON/YAML).

    Mirrors runtime.DecodeInto(latestschedulerapi.Codec, data, policy)
    (simulator.go:397-399): unknown kinds are rejected, absent lists keep
    their nil-vs-empty distinction.
    """
    kind = obj.get("kind", "Policy")
    if kind != "Policy":
        raise PolicyError(f"unexpected kind {kind!r}, expected \"Policy\"")
    preds = obj.get("predicates")
    pris = obj.get("priorities")
    # validation is owned by providers.create_from_config (the Go owner is
    # factory.CreateFromConfig); decode stays a pure structural transform
    return Policy(
        predicates=[_decode_predicate(p) for p in preds] if preds is not None else None,
        priorities=[_decode_priority(p) for p in pris] if pris is not None else None,
        extender_configs=[_decode_extender(e) for e in obj.get("extenders") or []],
        hard_pod_affinity_symmetric_weight=int(
            obj.get("hardPodAffinitySymmetricWeight", 0)),
        always_check_all_predicates=bool(obj.get("alwaysCheckAllPredicates", False)))


def _parse_document(data: str, what: str) -> dict:
    """JSON-then-YAML parse; any syntax failure or non-mapping document
    surfaces as PolicyError (the analog of runtime.DecodeInto's error)."""
    try:
        obj = json.loads(data)
    except json.JSONDecodeError:
        import yaml
        try:
            obj = yaml.safe_load(data)
        except yaml.YAMLError as exc:
            raise PolicyError(f"invalid policy: {what}: {exc}")
    if not isinstance(obj, dict):
        raise PolicyError(f"invalid policy document in {what}")
    return obj


def load_policy_file(path: str) -> Policy:
    """Policy from a serialized file (simulator.go:386-399). JSON or YAML."""
    with open(path) as f:
        data = f.read()
    return decode_policy(_parse_document(data, path))


SCHEDULER_POLICY_CONFIGMAP_KEY = "policy.cfg"  # componentconfig/types.go:41


def policy_from_configmap(configmap_obj) -> Policy:
    """Policy from a ConfigMap object's data["policy.cfg"] value
    (simulator.go:401-415). Takes the ConfigMap as a parsed dict — the
    offline build has no apiserver to Get() it from."""
    if not isinstance(configmap_obj, dict):
        raise PolicyError("config map document is not an object")
    data = (configmap_obj.get("data") or {})
    raw = data.get(SCHEDULER_POLICY_CONFIGMAP_KEY)
    if raw is None:
        raise PolicyError("missing policy config map value at key "
                          f'"{SCHEDULER_POLICY_CONFIGMAP_KEY}"')
    return decode_policy(_parse_document(raw, "config map"))


def load_policy_configmap_file(path: str) -> Policy:
    """Policy from a ConfigMap object saved to a file as JSON/YAML — the
    offline stand-in for reading the ConfigMap off the apiserver."""
    with open(path) as f:
        data = f.read()
    return policy_from_configmap(_parse_document(data, path))
