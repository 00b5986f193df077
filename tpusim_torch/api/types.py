"""Domain model: the subset of the Kubernetes object model the scheduling engine reads.

Mirrors the reference's typed API layer (reference: pkg/api/api.go:27-83) plus the
v1 fields consumed by the vendored engine (requests/limits, init containers,
nodeSelector/affinity, tolerations, host ports, node conditions, taints,
allocatable, labels — see SURVEY.md §7 step 1). Objects round-trip to/from
k8s-style camelCase dicts so `pods.json` / `nodes.json` checkpoints
(reference: pkg/main.go:147-179) load unchanged.
"""

from __future__ import annotations

import copy as _copy_mod
import enum
import re
from dataclasses import dataclass, field, is_dataclass
from typing import Any, Optional

from tpusim_torch.api.quantity import Quantity, parse_quantity

# v1 resource names as of the reference's vintage (k8s ~1.10):
# v1.ResourceNvidiaGPU = "alpha.kubernetes.io/nvidia-gpu".
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_NVIDIA_GPU = "alpha.kubernetes.io/nvidia-gpu"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"

DEFAULT_NAMESPACE = "default"

# effects
TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

# well-known topology labels (kubeletapis.LabelHostname / LabelZoneFailureDomain /
# LabelZoneRegion at the reference's vintage)
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE_FAILURE_DOMAIN = "failure-domain.beta.kubernetes.io/zone"
LABEL_ZONE_REGION = "failure-domain.beta.kubernetes.io/region"


def is_scalar_resource_name(name: str) -> bool:
    """Reference: v1helper.IsScalarResourceName = extended or hugepages.

    Extended means namespaced outside the default namespace: the name contains a
    "/", does not contain "kubernetes.io/", and is not "requests."-prefixed
    (quota notation; v1helper.IsExtendedResourceName). Used at
    predicates.go:687-696, 755-767. "alpha.kubernetes.io/nvidia-gpu" is
    therefore NOT scalar — GPUs are tracked as a first-class field.
    """
    extended = ("/" in name and "kubernetes.io/" not in name
                and not name.startswith("requests."))
    return extended or name.startswith("hugepages-")


class ResourceType(enum.Enum):
    """Reference: pkg/api/api.go:27-58 (ResourceType enum + ObjectType mapping)."""

    PODS = "pods"
    PERSISTENT_VOLUMES = "persistentvolumes"
    NODES = "nodes"
    SERVICES = "services"
    PERSISTENT_VOLUME_CLAIMS = "persistentvolumeclaims"
    STORAGE_CLASSES = "storageclasses"

    @staticmethod
    def from_string(s: str) -> "ResourceType":
        """Reference: pkg/api/api.go:60-77 (StringToResourceType)."""
        try:
            return ResourceType(s.lower())
        except ValueError:
            raise ValueError(f"unknown resource type: {s}")

    def object_type(self):
        return _RESOURCE_OBJECT_TYPES[self]


def _get(d: dict, *keys, default=None):
    for k in keys:
        if d is None:
            return default
        d = d.get(k)
    return d if d is not None else default


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False

    @classmethod
    def from_obj(cls, o: dict) -> "OwnerReference":
        return cls(
            api_version=o.get("apiVersion", ""),
            kind=o.get("kind", ""),
            name=o.get("name", ""),
            uid=o.get("uid", ""),
            controller=bool(o.get("controller", False)),
        )

    def to_obj(self) -> dict:
        o = {"apiVersion": self.api_version, "kind": self.kind, "name": self.name, "uid": self.uid}
        if self.controller:
            o["controller"] = True
        return o


@dataclass
class ObjectMeta:
    """namespace stays "" when absent (cluster-scoped objects like Node never
    get one); namespaced accessors default it to DEFAULT_NAMESPACE at read time
    so checkpoints round-trip byte-identical."""

    name: str = ""
    namespace: str = ""
    uid: str = ""
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    owner_references: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> "ObjectMeta":
        o = o or {}
        return cls(
            name=o.get("name", ""),
            namespace=o.get("namespace") or "",
            uid=o.get("uid", ""),
            labels=dict(o.get("labels") or {}),
            annotations=dict(o.get("annotations") or {}),
            owner_references=[OwnerReference.from_obj(r) for r in o.get("ownerReferences") or []],
        )

    def to_obj(self) -> dict:
        o: dict[str, Any] = {"name": self.name}
        if self.namespace:
            o["namespace"] = self.namespace
        if self.uid:
            o["uid"] = self.uid
        if self.labels:
            o["labels"] = dict(self.labels)
        if self.annotations:
            o["annotations"] = dict(self.annotations)
        if self.owner_references:
            o["ownerReferences"] = [r.to_obj() for r in self.owner_references]
        return o

    def controller_ref(self) -> Optional[OwnerReference]:
        for r in self.owner_references:
            if r.controller:
                return r
        return None


# ---------------------------------------------------------------------------
# selectors / affinity
# ---------------------------------------------------------------------------

# apimachinery validation (labels.NewRequirement -> util/validation):
# label values are <= 63 chars, empty or alphanumeric with -_. inside;
# label keys are [prefix/]name with a DNS-1123-subdomain prefix and a
# 63-char qualified name part
_LABEL_VALUE_RE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")
_LABEL_NAME_RE = re.compile(r"^([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$")
_DNS1123_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?"
                         r"(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")


def _valid_label_value(v: str) -> bool:
    return len(v) <= 63 and bool(_LABEL_VALUE_RE.match(v))


def _valid_label_key(k: str) -> bool:
    prefix, sep, name = k.rpartition("/")
    if sep and not prefix:
        return False  # IsQualifiedName: "prefix part must be non-empty"
    if prefix and (len(prefix) > 253 or not _DNS1123_RE.match(prefix)):
        return False
    return 0 < len(name) <= 63 and bool(_LABEL_NAME_RE.match(name))


_INT64_RE = re.compile(r"^[+-]?[0-9]+$")
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def _parse_int64(s: str) -> Optional[int]:
    """Go strconv.ParseInt(s, 10, 64): plain decimal digits only (no
    underscores, no whitespace) within int64 range."""
    if not _INT64_RE.match(s):
        return None
    v = int(s)
    return v if _INT64_MIN <= v <= _INT64_MAX else None


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: dict) -> "NodeSelectorRequirement":
        return cls(key=o.get("key", ""), operator=o.get("operator", "In"),
                   values=list(o.get("values") or []))

    def to_obj(self) -> dict:
        o = {"key": self.key, "operator": self.operator}
        if self.values:
            o["values"] = list(self.values)
        return o

    def invalid(self) -> bool:
        """labels.NewRequirement validation (apimachinery selector.go:134-169)
        as invoked by NodeSelectorRequirementsAsSelector: a requirement that
        would fail construction (bad operator, wrong value count, non-integer
        Gt/Lt value, invalid label key/value) errors the WHOLE selector."""
        if not _valid_label_key(self.key):
            return True
        if self.operator in ("In", "NotIn"):
            if not self.values:
                return True
        elif self.operator in ("Exists", "DoesNotExist"):
            if self.values:
                return True
        elif self.operator in ("Gt", "Lt"):
            if len(self.values) != 1:
                return True
            if _parse_int64(self.values[0]) is None:
                return True
        else:
            return True
        return any(not _valid_label_value(v) for v in self.values)

    def matches(self, labels: dict) -> bool:
        """apimachinery labels.Requirement.Matches semantics (for a
        requirement that passed `invalid()` validation)."""
        has = self.key in labels
        if self.operator == "In":
            return has and labels[self.key] in self.values
        if self.operator == "NotIn":
            return (not has) or labels[self.key] not in self.values
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator in ("Gt", "Lt"):
            if not has or len(self.values) != 1:
                return False
            lhs = _parse_int64(labels[self.key])
            rhs = _parse_int64(self.values[0])
            if lhs is None or rhs is None:
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        return False


@dataclass
class NodeSelectorTerm:
    match_expressions: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: dict) -> "NodeSelectorTerm":
        return cls(match_expressions=[NodeSelectorRequirement.from_obj(e)
                                      for e in o.get("matchExpressions") or []])

    def to_obj(self) -> dict:
        return {"matchExpressions": [e.to_obj() for e in self.match_expressions]}

    def match_result(self, labels: dict) -> Optional[bool]:
        """NodeSelectorRequirementsAsSelector semantics (v1 helpers.go:215):
        None when any requirement fails validation (the selector errors),
        False for an empty term ([] builds labels.Nothing()), else the ANDed
        requirement match."""
        if not self.match_expressions:
            return False
        if any(e.invalid() for e in self.match_expressions):
            return None
        return all(e.matches(labels) for e in self.match_expressions)

    def matches(self, labels: dict) -> bool:
        """match_result collapsed: errors and the empty-term Nothing()
        selector both count as no-match (the preferred-affinity scorer path;
        the required path needs the tri-state — predicates.go:778-792)."""
        return self.match_result(labels) is True


@dataclass
class PreferredSchedulingTerm:
    weight: int = 0
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)

    @classmethod
    def from_obj(cls, o: dict) -> "PreferredSchedulingTerm":
        return cls(weight=int(o.get("weight", 0)),
                   preference=NodeSelectorTerm.from_obj(o.get("preference") or {}))

    def to_obj(self) -> dict:
        return {"weight": self.weight, "preference": self.preference.to_obj()}


@dataclass
class NodeAffinity:
    # requiredDuringSchedulingIgnoredDuringExecution: list of terms (ORed)
    required_terms: Optional[list] = None
    preferred: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: dict) -> "NodeAffinity":
        req = o.get("requiredDuringSchedulingIgnoredDuringExecution")
        return cls(
            required_terms=None if req is None else [
                NodeSelectorTerm.from_obj(t) for t in req.get("nodeSelectorTerms") or []],
            preferred=[PreferredSchedulingTerm.from_obj(t)
                       for t in o.get("preferredDuringSchedulingIgnoredDuringExecution") or []],
        )

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.required_terms is not None:
            o["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [t.to_obj() for t in self.required_terms]}
        if self.preferred:
            o["preferredDuringSchedulingIgnoredDuringExecution"] = [
                t.to_obj() for t in self.preferred]
        return o


@dataclass
class LabelSelector:
    """A nil selector in Go is represented as None here (matches nothing at call
    sites); an empty LabelSelector() matches everything."""

    match_labels: dict = field(default_factory=dict)
    match_expressions: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> Optional["LabelSelector"]:
        if o is None:
            return None
        return cls(match_labels=dict(o.get("matchLabels") or {}),
                   match_expressions=[NodeSelectorRequirement.from_obj(e)
                                      for e in o.get("matchExpressions") or []])

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.match_labels:
            o["matchLabels"] = dict(self.match_labels)
        if self.match_expressions:
            o["matchExpressions"] = [e.to_obj() for e in self.match_expressions]
        return o

    def matches(self, labels: dict) -> bool:
        """metav1.LabelSelectorAsSelector: matchLabels AND matchExpressions.
        An empty selector matches all objects."""
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(e.matches(labels) for e in self.match_expressions)


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: list = field(default_factory=list)
    topology_key: str = ""

    @classmethod
    def from_obj(cls, o: dict) -> "PodAffinityTerm":
        return cls(label_selector=LabelSelector.from_obj(o.get("labelSelector")),
                   namespaces=list(o.get("namespaces") or []),
                   topology_key=o.get("topologyKey", ""))

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.label_selector is not None:
            o["labelSelector"] = self.label_selector.to_obj()
        if self.namespaces:
            o["namespaces"] = list(self.namespaces)
        if self.topology_key:
            o["topologyKey"] = self.topology_key
        return o


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 0
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)

    @classmethod
    def from_obj(cls, o: dict) -> "WeightedPodAffinityTerm":
        return cls(weight=int(o.get("weight", 0)),
                   pod_affinity_term=PodAffinityTerm.from_obj(o.get("podAffinityTerm") or {}))

    def to_obj(self) -> dict:
        return {"weight": self.weight, "podAffinityTerm": self.pod_affinity_term.to_obj()}


@dataclass
class PodAffinity:
    required: list = field(default_factory=list)  # list[PodAffinityTerm]
    preferred: list = field(default_factory=list)  # list[WeightedPodAffinityTerm]

    @classmethod
    def from_obj(cls, o: dict) -> "PodAffinity":
        return cls(
            required=[PodAffinityTerm.from_obj(t)
                      for t in o.get("requiredDuringSchedulingIgnoredDuringExecution") or []],
            preferred=[WeightedPodAffinityTerm.from_obj(t)
                       for t in o.get("preferredDuringSchedulingIgnoredDuringExecution") or []],
        )

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.required:
            o["requiredDuringSchedulingIgnoredDuringExecution"] = [t.to_obj() for t in self.required]
        if self.preferred:
            o["preferredDuringSchedulingIgnoredDuringExecution"] = [t.to_obj() for t in self.preferred]
        return o


class PodAntiAffinity(PodAffinity):
    pass


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> Optional["Affinity"]:
        if not o:
            return None
        return cls(
            node_affinity=NodeAffinity.from_obj(o["nodeAffinity"]) if o.get("nodeAffinity") else None,
            pod_affinity=PodAffinity.from_obj(o["podAffinity"]) if o.get("podAffinity") else None,
            pod_anti_affinity=PodAntiAffinity.from_obj(o["podAntiAffinity"]) if o.get("podAntiAffinity") else None,
        )

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.node_affinity is not None:
            o["nodeAffinity"] = self.node_affinity.to_obj()
        if self.pod_affinity is not None:
            o["podAffinity"] = self.pod_affinity.to_obj()
        if self.pod_anti_affinity is not None:
            o["podAntiAffinity"] = self.pod_anti_affinity.to_obj()
        return o


# ---------------------------------------------------------------------------
# taints / tolerations
# ---------------------------------------------------------------------------


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = ""  # NoSchedule | PreferNoSchedule | NoExecute

    @classmethod
    def from_obj(cls, o: dict) -> "Taint":
        return cls(key=o.get("key", ""), value=o.get("value", ""), effect=o.get("effect", ""))

    def to_obj(self) -> dict:
        return {"key": self.key, "value": self.value, "effect": self.effect}


@dataclass
class Toleration:
    key: str = ""
    operator: str = ""  # "" (== Equal) | Equal | Exists
    value: str = ""
    effect: str = ""
    toleration_seconds: Optional[int] = None

    @classmethod
    def from_obj(cls, o: dict) -> "Toleration":
        return cls(key=o.get("key", ""), operator=o.get("operator", ""),
                   value=o.get("value", ""), effect=o.get("effect", ""),
                   toleration_seconds=o.get("tolerationSeconds"))

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.key:
            o["key"] = self.key
        if self.operator:
            o["operator"] = self.operator
        if self.value:
            o["value"] = self.value
        if self.effect:
            o["effect"] = self.effect
        if self.toleration_seconds is not None:
            o["tolerationSeconds"] = self.toleration_seconds
        return o

    def tolerates(self, taint: Taint) -> bool:
        """v1.Toleration.ToleratesTaint semantics: empty effect matches all effects,
        empty key with Exists matches all taints."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return True
        return False


def tolerations_tolerate_taint(tolerations: list, taint: Taint) -> bool:
    """v1helper.TolerationsTolerateTaint."""
    return any(t.tolerates(taint) for t in tolerations)


def find_matching_untolerated_taint(taints: list, tolerations: list, taint_filter) -> Optional[Taint]:
    """v1helper.FindMatchingUntoleratedTaint: first filtered taint not tolerated."""
    for taint in taints:
        if not taint_filter(taint):
            continue
        if not tolerations_tolerate_taint(tolerations, taint):
            return taint
    return None


# ---------------------------------------------------------------------------
# pods
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    host_ip: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"

    @classmethod
    def from_obj(cls, o: dict) -> "ContainerPort":
        return cls(host_ip=o.get("hostIP", ""), host_port=int(o.get("hostPort", 0) or 0),
                   container_port=int(o.get("containerPort", 0) or 0),
                   protocol=o.get("protocol") or "TCP")

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.host_ip:
            o["hostIP"] = self.host_ip
        if self.host_port:
            o["hostPort"] = self.host_port
        if self.container_port:
            o["containerPort"] = self.container_port
        if self.protocol != "TCP":
            o["protocol"] = self.protocol
        return o


_COPY_ATOMIC = (str, int, float, bool, bytes, type(None), Quantity)


def _structural_copy(o):
    """Deep-copy a dataclass/list/dict graph, sharing atomic leaves.
    Quantity counts as atomic: its only writes are idempotent lazy memos."""
    if isinstance(o, _COPY_ATOMIC):
        return o
    if isinstance(o, list):
        return [_structural_copy(x) for x in o]
    if isinstance(o, dict):
        return {k: _structural_copy(v) for k, v in o.items()}
    if is_dataclass(o):
        new = object.__new__(type(o))
        d = new.__dict__
        for k, v in o.__dict__.items():
            d[k] = _structural_copy(v)
        return new
    return _copy_mod.deepcopy(o)


def _parse_resource_list(o: Optional[dict]) -> dict:
    return {k: parse_quantity(v) for k, v in (o or {}).items()}


def _resource_list_to_obj(rl: dict) -> dict:
    return {k: str(v) for k, v in rl.items()}


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: dict = field(default_factory=dict)  # resource name -> Quantity
    limits: dict = field(default_factory=dict)
    ports: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: dict) -> "Container":
        res = o.get("resources") or {}
        return cls(
            name=o.get("name", ""),
            image=o.get("image", ""),
            requests=_parse_resource_list(res.get("requests")),
            limits=_parse_resource_list(res.get("limits")),
            ports=[ContainerPort.from_obj(p) for p in o.get("ports") or []],
        )

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.name:
            o["name"] = self.name
        if self.image:
            o["image"] = self.image
        res: dict[str, Any] = {}
        if self.requests:
            res["requests"] = _resource_list_to_obj(self.requests)
        if self.limits:
            res["limits"] = _resource_list_to_obj(self.limits)
        if res:
            o["resources"] = res
        if self.ports:
            o["ports"] = [p.to_obj() for p in self.ports]
        return o


@dataclass
class Volume:
    """A pod volume. Only the sources the scheduler reads are typed
    (NoDiskConflict: GCE PD / AWS EBS / RBD / ISCSI, predicates.go:220-276;
    MaxPDVolumeCount filters + PVC references, predicates.go:361-460); the
    raw object is kept for round-trip."""

    name: str = ""
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_obj(cls, o: dict) -> "Volume":
        return cls(name=o.get("name", ""), raw=dict(o))

    def to_obj(self) -> dict:
        return dict(self.raw)

    @property
    def gce_persistent_disk(self) -> Optional[dict]:
        return self.raw.get("gcePersistentDisk")

    @property
    def aws_elastic_block_store(self) -> Optional[dict]:
        return self.raw.get("awsElasticBlockStore")

    @property
    def rbd(self) -> Optional[dict]:
        return self.raw.get("rbd")

    @property
    def iscsi(self) -> Optional[dict]:
        return self.raw.get("iscsi")

    @property
    def azure_disk(self) -> Optional[dict]:
        return self.raw.get("azureDisk")

    @property
    def pvc_name(self) -> Optional[str]:
        """persistentVolumeClaim.claimName; None when not a PVC volume."""
        pvc = self.raw.get("persistentVolumeClaim")
        if pvc is None:
            return None
        return pvc.get("claimName", "")


@dataclass
class PodSpec:
    containers: list = field(default_factory=list)
    init_containers: list = field(default_factory=list)
    node_name: str = ""
    node_selector: Optional[dict] = None
    affinity: Optional[Affinity] = None
    tolerations: list = field(default_factory=list)
    scheduler_name: str = ""
    priority: Optional[int] = None
    host_network: bool = False
    volumes: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> "PodSpec":
        o = o or {}
        return cls(
            containers=[Container.from_obj(c) for c in o.get("containers") or []],
            init_containers=[Container.from_obj(c) for c in o.get("initContainers") or []],
            node_name=o.get("nodeName", ""),
            node_selector=dict(o["nodeSelector"]) if o.get("nodeSelector") else None,
            affinity=Affinity.from_obj(o.get("affinity")),
            tolerations=[Toleration.from_obj(t) for t in o.get("tolerations") or []],
            scheduler_name=o.get("schedulerName", ""),
            priority=o.get("priority"),
            host_network=bool(o.get("hostNetwork", False)),
            volumes=[Volume.from_obj(v) for v in o.get("volumes") or []],
        )

    def to_obj(self) -> dict:
        o: dict[str, Any] = {"containers": [c.to_obj() for c in self.containers]}
        if self.init_containers:
            o["initContainers"] = [c.to_obj() for c in self.init_containers]
        if self.node_name:
            o["nodeName"] = self.node_name
        if self.node_selector is not None:
            o["nodeSelector"] = dict(self.node_selector)
        if self.affinity is not None:
            o["affinity"] = self.affinity.to_obj()
        if self.tolerations:
            o["tolerations"] = [t.to_obj() for t in self.tolerations]
        if self.scheduler_name:
            o["schedulerName"] = self.scheduler_name
        if self.priority is not None:
            o["priority"] = self.priority
        if self.host_network:
            o["hostNetwork"] = True
        if self.volumes:
            o["volumes"] = [v.to_obj() for v in self.volumes]
        return o


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""

    @classmethod
    def from_obj(cls, o: dict) -> "PodCondition":
        return cls(type=o.get("type", ""), status=o.get("status", ""),
                   reason=o.get("reason", ""), message=o.get("message", ""))

    def to_obj(self) -> dict:
        o = {"type": self.type, "status": self.status}
        if self.reason:
            o["reason"] = self.reason
        if self.message:
            o["message"] = self.message
        return o


@dataclass
class PodStatus:
    phase: str = ""
    conditions: list = field(default_factory=list)
    reason: str = ""
    message: str = ""
    nominated_node_name: str = ""

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> "PodStatus":
        o = o or {}
        return cls(phase=o.get("phase", ""),
                   conditions=[PodCondition.from_obj(c) for c in o.get("conditions") or []],
                   reason=o.get("reason", ""), message=o.get("message", ""),
                   nominated_node_name=o.get("nominatedNodeName", ""))

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.phase:
            o["phase"] = self.phase
        if self.conditions:
            o["conditions"] = [c.to_obj() for c in self.conditions]
        if self.reason:
            o["reason"] = self.reason
        if self.message:
            o["message"] = self.message
        if self.nominated_node_name:
            o["nominatedNodeName"] = self.nominated_node_name
        return o


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    @classmethod
    def from_obj(cls, o: dict) -> "Pod":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")),
                   spec=PodSpec.from_obj(o.get("spec")),
                   status=PodStatus.from_obj(o.get("status")))

    def to_obj(self) -> dict:
        return {"apiVersion": "v1", "kind": "Pod", "metadata": self.metadata.to_obj(),
                "spec": self.spec.to_obj(), "status": self.status.to_obj()}

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace or DEFAULT_NAMESPACE

    def key(self) -> str:
        """cache.MetaNamespaceKeyFunc."""
        return f"{self.namespace}/{self.metadata.name}"

    def copy(self) -> "Pod":
        """Independent deep copy. Structural (field-graph) rather than a
        to_obj/from_obj round-trip: the simulator's Bind seam copies every
        bound pod, and re-serializing + re-parsing quantities dominated the
        mirror cost of the preemption hybrid. Quantity leaves are immutable
        (lazy memo only) and shared; equality and scheduling behavior match
        the round-trip for any pod built through from_obj."""
        return _structural_copy(self)


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------


@dataclass
class NodeCondition:
    type: str = ""
    status: str = ""

    @classmethod
    def from_obj(cls, o: dict) -> "NodeCondition":
        return cls(type=o.get("type", ""), status=o.get("status", ""))

    def to_obj(self) -> dict:
        return {"type": self.type, "status": self.status}


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> "NodeSpec":
        o = o or {}
        return cls(unschedulable=bool(o.get("unschedulable", False)),
                   taints=[Taint.from_obj(t) for t in o.get("taints") or []])

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.unschedulable:
            o["unschedulable"] = True
        if self.taints:
            o["taints"] = [t.to_obj() for t in self.taints]
        return o


@dataclass
class ContainerImage:
    names: list = field(default_factory=list)
    size_bytes: int = 0

    @classmethod
    def from_obj(cls, o: dict) -> "ContainerImage":
        return cls(names=list(o.get("names") or []), size_bytes=int(o.get("sizeBytes", 0) or 0))

    def to_obj(self) -> dict:
        return {"names": list(self.names), "sizeBytes": self.size_bytes}


@dataclass
class NodeStatus:
    capacity: dict = field(default_factory=dict)
    allocatable: dict = field(default_factory=dict)
    conditions: list = field(default_factory=list)
    images: list = field(default_factory=list)

    @classmethod
    def from_obj(cls, o: Optional[dict]) -> "NodeStatus":
        o = o or {}
        return cls(capacity=_parse_resource_list(o.get("capacity")),
                   allocatable=_parse_resource_list(o.get("allocatable")),
                   conditions=[NodeCondition.from_obj(c) for c in o.get("conditions") or []],
                   images=[ContainerImage.from_obj(i) for i in o.get("images") or []])

    def to_obj(self) -> dict:
        o: dict[str, Any] = {}
        if self.capacity:
            o["capacity"] = _resource_list_to_obj(self.capacity)
        if self.allocatable:
            o["allocatable"] = _resource_list_to_obj(self.allocatable)
        if self.conditions:
            o["conditions"] = [c.to_obj() for c in self.conditions]
        if self.images:
            o["images"] = [i.to_obj() for i in self.images]
        return o


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    @classmethod
    def from_obj(cls, o: dict) -> "Node":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")),
                   spec=NodeSpec.from_obj(o.get("spec")),
                   status=NodeStatus.from_obj(o.get("status")))

    def to_obj(self) -> dict:
        return {"apiVersion": "v1", "kind": "Node", "metadata": self.metadata.to_obj(),
                "spec": self.spec.to_obj(), "status": self.status.to_obj()}

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return self.metadata.name

    def copy(self) -> "Node":
        return Node.from_obj(self.to_obj())


# ---------------------------------------------------------------------------
# other resource kinds (modelled thinly; the simulator stores but rarely reads them)
# ---------------------------------------------------------------------------


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: dict = field(default_factory=dict)

    kind = "Service"

    @classmethod
    def from_obj(cls, o: dict) -> "Service":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")),
                   selector=dict(_get(o, "spec", "selector", default={}) or {}))

    def to_obj(self) -> dict:
        return {"apiVersion": "v1", "kind": "Service", "metadata": self.metadata.to_obj(),
                "spec": {"selector": dict(self.selector)}}

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace or DEFAULT_NAMESPACE

    def key(self) -> str:
        return f"{self.namespace}/{self.metadata.name}"


# beta annotation override for StorageClassName (v1helper
# GetPersistentVolume(Claim)Class reads it before the spec field)
ANN_STORAGE_CLASS = "volume.beta.kubernetes.io/storage-class"
# alpha node-affinity annotation on PVs (volumehelper checkAlphaNodeAffinity)
ANN_ALPHA_NODE_AFFINITY = "volume.alpha.kubernetes.io/node-affinity"

VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    raw: dict = field(default_factory=dict)

    kind = "PersistentVolume"

    @classmethod
    def from_obj(cls, o: dict) -> "PersistentVolume":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")), raw=dict(o))

    def to_obj(self) -> dict:
        o = dict(self.raw)
        o.setdefault("apiVersion", "v1")
        o["kind"] = "PersistentVolume"
        o["metadata"] = self.metadata.to_obj()
        return o

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return self.metadata.name

    def copy(self) -> "PersistentVolume":
        """Deep copy: raw holds nested spec dicts, and the binder's assume path
        mutates spec.claimRef — a shallow dict() would alias the original."""
        import copy as _copy

        return PersistentVolume(metadata=ObjectMeta.from_obj(self.metadata.to_obj()),
                                raw=_copy.deepcopy(self.raw))

    # --- typed spec accessors the scheduler reads ---

    @property
    def spec_raw(self) -> dict:
        return self.raw.get("spec") or {}

    @property
    def capacity_storage(self) -> int:
        """spec.capacity.storage in bytes (Quantity.Value semantics); memoized —
        it sits in the per-pod-per-node CheckVolumeBinding hot path."""
        v = self.__dict__.get("_capacity_storage")
        if v is None:
            qty = (self.spec_raw.get("capacity") or {}).get("storage")
            v = 0 if qty is None else parse_quantity(str(qty)).value()
            self.__dict__["_capacity_storage"] = v
        return v

    @property
    def claim_ref(self) -> Optional[dict]:
        return self.spec_raw.get("claimRef")

    @property
    def access_modes(self) -> list:
        return list(self.spec_raw.get("accessModes") or [])

    @property
    def volume_mode(self) -> str:
        return self.spec_raw.get("volumeMode") or "Filesystem"

    @property
    def storage_class_name(self) -> str:
        """v1helper.GetPersistentVolumeClass: beta annotation FIRST, then the
        spec field (helpers.go:398-405)."""
        if ANN_STORAGE_CLASS in self.metadata.annotations:
            return self.metadata.annotations[ANN_STORAGE_CLASS]
        return self.spec_raw.get("storageClassName") or ""

    @property
    def gce_persistent_disk(self) -> Optional[dict]:
        return self.spec_raw.get("gcePersistentDisk")

    @property
    def aws_elastic_block_store(self) -> Optional[dict]:
        return self.spec_raw.get("awsElasticBlockStore")

    @property
    def azure_disk(self) -> Optional[dict]:
        return self.spec_raw.get("azureDisk")

    def node_affinity_terms(self) -> Optional[list]:
        """Required node-affinity terms (ORed NodeSelectorTerm list) from
        spec.nodeAffinity.required, else the alpha annotation
        (volumeutil.CheckNodeAffinity reads both). None = unconstrained.
        Memoized — evaluated per pod per node by CheckVolumeBinding."""
        if "_node_affinity_terms" in self.__dict__:
            return self.__dict__["_node_affinity_terms"]
        na = self.spec_raw.get("nodeAffinity")
        req = (na or {}).get("required")
        if req is None:
            ann = self.metadata.annotations.get(ANN_ALPHA_NODE_AFFINITY)
            if ann:
                import json as _json

                affinity = _json.loads(ann)
                req = affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
        terms = None if req is None else [
            NodeSelectorTerm.from_obj(t)
            for t in req.get("nodeSelectorTerms") or []]
        self.__dict__["_node_affinity_terms"] = terms
        return terms


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    raw: dict = field(default_factory=dict)

    kind = "PersistentVolumeClaim"

    @classmethod
    def from_obj(cls, o: dict) -> "PersistentVolumeClaim":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")), raw=dict(o))

    def to_obj(self) -> dict:
        o = dict(self.raw)
        o.setdefault("apiVersion", "v1")
        o["kind"] = "PersistentVolumeClaim"
        o["metadata"] = self.metadata.to_obj()
        return o

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace or DEFAULT_NAMESPACE

    def key(self) -> str:
        return f"{self.namespace}/{self.metadata.name}"

    def copy(self) -> "PersistentVolumeClaim":
        return PersistentVolumeClaim.from_obj(self.to_obj())

    # --- typed spec accessors the scheduler reads ---

    @property
    def spec_raw(self) -> dict:
        return self.raw.get("spec") or {}

    @property
    def volume_name(self) -> str:
        return self.spec_raw.get("volumeName") or ""

    @property
    def access_modes(self) -> list:
        return list(self.spec_raw.get("accessModes") or [])

    @property
    def volume_mode(self) -> str:
        return self.spec_raw.get("volumeMode") or "Filesystem"

    @property
    def storage_class_name(self) -> str:
        """v1helper.GetPersistentVolumeClaimClass: beta annotation FIRST, then
        the spec field, which may be an explicit "" (helpers.go:409-420)."""
        if ANN_STORAGE_CLASS in self.metadata.annotations:
            return self.metadata.annotations[ANN_STORAGE_CLASS]
        sc = self.spec_raw.get("storageClassName")
        return sc if sc is not None else ""

    @property
    def request_storage(self) -> int:
        v = self.__dict__.get("_request_storage")
        if v is None:
            qty = ((self.spec_raw.get("resources") or {}).get("requests")
                   or {}).get("storage")
            v = 0 if qty is None else parse_quantity(str(qty)).value()
            self.__dict__["_request_storage"] = v
        return v

    def selector(self) -> Optional["LabelSelector"]:
        if "_selector" not in self.__dict__:
            self.__dict__["_selector"] = LabelSelector.from_obj(
                self.spec_raw.get("selector"))
        return self.__dict__["_selector"]


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    raw: dict = field(default_factory=dict)

    kind = "StorageClass"

    @classmethod
    def from_obj(cls, o: dict) -> "StorageClass":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")), raw=dict(o))

    def to_obj(self) -> dict:
        o = dict(self.raw)
        o.setdefault("apiVersion", "storage.k8s.io/v1")
        o["kind"] = "StorageClass"
        o["metadata"] = self.metadata.to_obj()
        return o

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return self.metadata.name

    @property
    def volume_binding_mode(self) -> Optional[str]:
        """None when unset — shouldDelayBinding errors on a gate-on class with
        no mode (pv_controller.go:290-292)."""
        return self.raw.get("volumeBindingMode")


@dataclass
class PodDisruptionBudget:
    """Minimal policy/v1beta1 PDB: the scheduler reads namespace, selector, and
    status.disruptionsAllowed (preemption victim filtering,
    core/generic_scheduler.go filterPodsWithPDBViolation)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    disruptions_allowed: int = 0

    kind = "PodDisruptionBudget"

    @classmethod
    def from_obj(cls, o: dict) -> "PodDisruptionBudget":
        return cls(metadata=ObjectMeta.from_obj(o.get("metadata")),
                   selector=LabelSelector.from_obj(_get(o, "spec", "selector")),
                   disruptions_allowed=int(
                       _get(o, "status", "disruptionsAllowed", default=0) or 0))

    def to_obj(self) -> dict:
        o: dict[str, Any] = {"apiVersion": "policy/v1beta1",
                             "kind": "PodDisruptionBudget",
                             "metadata": self.metadata.to_obj(), "spec": {},
                             "status": {"disruptionsAllowed": self.disruptions_allowed}}
        if self.selector is not None:
            o["spec"]["selector"] = self.selector.to_obj()
        return o

    @property
    def namespace(self) -> str:
        return self.metadata.namespace or DEFAULT_NAMESPACE

    def key(self) -> str:
        return f"{self.namespace}/{self.metadata.name}"


_RESOURCE_OBJECT_TYPES = {
    ResourceType.PODS: Pod,
    ResourceType.PERSISTENT_VOLUMES: PersistentVolume,
    ResourceType.NODES: Node,
    ResourceType.SERVICES: Service,
    ResourceType.PERSISTENT_VOLUME_CLAIMS: PersistentVolumeClaim,
    ResourceType.STORAGE_CLASSES: StorageClass,
}


# ---------------------------------------------------------------------------
# SimulationPod (podspec schema)
# ---------------------------------------------------------------------------


@dataclass
class SimulationPod:
    """Reference: pkg/api/api.go:79-83 — {name, pod, num} podspec entries."""

    name: str = ""
    pod: Pod = field(default_factory=Pod)
    num: int = 1

    @classmethod
    def from_obj(cls, o: dict) -> "SimulationPod":
        return cls(name=o.get("name", ""), pod=Pod.from_obj(o.get("pod") or {}),
                   num=int(o.get("num", 1)))

    def to_obj(self) -> dict:
        return {"name": self.name, "pod": self.pod.to_obj(), "num": self.num}
