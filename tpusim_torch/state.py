"""Columnar cluster state: SoA arrays + signature interning + static tables.

The host compile step of the port (numpy only). NodeInfo's cached aggregates
(schedulercache/node_info.go:35-76) become per-node column vectors; the
symbolic pod features become interned signature ids with precompiled
[signature, node] tables, so the device scan carries only numeric state.

Pod-group features — host ports, services (SelectorSpreadPriority), pod
volumes (NoDiskConflict, MaxPDVolumeCount, NoVolumeZoneConflict) and
inter-pod (anti)affinity (MatchInterPodAffinity, InterPodAffinityPriority) —
compile into GroupTables: pods are interned by group signature and merged by
match profile, and the device carries a [G, N] presence count per merged
group (and, for inter-pod terms, its per-topology-domain sums).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import (
    LABEL_HOSTNAME,
    TAINT_PREFER_NO_SCHEDULE,
    Node,
    Pod,
    find_matching_untolerated_taint,
    tolerations_tolerate_taint,
)
from tpusim_torch.engine.predicates import (
    _VOLUME_FILTERS,
    _ZONE_LABELS,
    DEFAULT_MAXPD_LIMITS,
    effective_maxpd_limits,
    get_namespaces_from_pod_affinity_term,
    get_pod_affinity_terms,
    get_pod_anti_affinity_terms,
    is_volume_conflict,
    label_zones_to_set,
    pod_matches_node_labels,
    pod_matches_term_namespace_and_selector,
)
from tpusim_torch.engine.priorities import (
    calculate_node_affinity_priority_map,
    calculate_node_prefer_avoid_pods_priority_map,
    get_zone_key,
)
from tpusim_torch.engine.resources import (
    NodeInfo,
    get_nonzero_pod_request,
    get_resource_request,
    is_pod_best_effort,
)
from tpusim_torch.engine.util import get_pod_priority

# ---------------------------------------------------------------------------
# failure reason bit layout (decoded back to error.go strings for the report)
# ---------------------------------------------------------------------------

BIT_NODE_NOT_READY = 0
BIT_NODE_OUT_OF_DISK = 1
BIT_NODE_NETWORK_UNAVAILABLE = 2
BIT_NODE_UNSCHEDULABLE = 3
BIT_INSUFFICIENT_PODS = 4
BIT_INSUFFICIENT_CPU = 5
BIT_INSUFFICIENT_MEMORY = 6
BIT_INSUFFICIENT_GPU = 7
BIT_INSUFFICIENT_EPHEMERAL = 8
BIT_HOSTNAME_MISMATCH = 9
BIT_NODE_SELECTOR_MISMATCH = 10
BIT_TAINTS_NOT_TOLERATED = 11
BIT_MEMORY_PRESSURE = 12
BIT_DISK_PRESSURE = 13
BIT_HOST_PORTS = 14
BIT_AFFINITY_NOT_MATCH = 15     # MatchInterPodAffinity umbrella reason
BIT_EXISTING_ANTI_AFFINITY = 16
BIT_AFFINITY_RULES = 17
BIT_ANTI_AFFINITY_RULES = 18
BIT_DISK_CONFLICT = 19          # NoDiskConflict (error.go ErrDiskConflict)
BIT_MAX_VOLUME_COUNT = 20       # MaxPDVolumeCount
BIT_VOLUME_ZONE_CONFLICT = 21   # NoVolumeZoneConflict
BIT_NODE_LABEL_PRESENCE = 22    # CheckNodeLabelPresence (policy-configured)
BIT_SERVICE_AFFINITY = 23       # CheckServiceAffinity (policy-configured)
NUM_FIXED_BITS = 24
# bits >= NUM_FIXED_BITS: Insufficient <scalar resource s>, per interned name

REASON_STRINGS = [
    "node(s) were not ready",
    "node(s) were out of disk space",
    "node(s) had unavailable network",
    "node(s) were unschedulable",
    "Insufficient pods",
    "Insufficient cpu",
    "Insufficient memory",
    "Insufficient alpha.kubernetes.io/nvidia-gpu",
    "Insufficient ephemeral-storage",
    "node(s) didn't match the requested hostname",
    "node(s) didn't match node selector",
    "node(s) had taints that the pod didn't tolerate",
    "node(s) had memory pressure",
    "node(s) had disk pressure",
    "node(s) didn't have free ports for the requested pod ports",
    "node(s) didn't match pod affinity/anti-affinity",
    "node(s) didn't satisfy existing pods anti-affinity rules",
    "node(s) didn't match pod affinity rules",
    "node(s) didn't match pod anti-affinity rules",
    "node(s) had no available disk",
    "node(s) exceed max volume count",
    "node(s) had no available volume zone",
    "node(s) didn't have the requested labels",
    "node(s) didn't match service affinity",
]

# Pod-group budgets (env-overridable). Groups are merged by match profile, so
# the limits bound device memory and host precompute, not workload diversity:
#   MAX_GROUPS          — merged groups (presence rows)
#   MAX_RAW_GROUPS      — distinct raw signatures before merging
#   MAX_MATCH_WORK      — host matcher evaluations
#   MAX_PRESENCE_BYTES  — presence[G, N] carry size
MAX_GROUPS = 8192
MAX_RAW_GROUPS = 262_144
MAX_MATCH_WORK = 8_000_000
MAX_PRESENCE_BYTES = 1 << 30
MAX_VOLUME_IDS = 4096


def env_int(name: str, default: int) -> int:
    """An integer setting from the environment; `default` when unset or
    not an integer."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _group_budgets():
    return (env_int("TPUSIM_MAX_GROUPS", MAX_GROUPS),
            env_int("TPUSIM_MAX_RAW_GROUPS", MAX_RAW_GROUPS),
            env_int("TPUSIM_MAX_MATCH_WORK", MAX_MATCH_WORK),
            env_int("TPUSIM_MAX_PRESENCE_BYTES", MAX_PRESENCE_BYTES))


_DICT_TAG = object()  # can never equal any JSON value


def _freeze(x):
    """Signature -> hashable canonical key; type-tagged leaves so Python's
    cross-type equality (True == 1 == 1.0) never merges distinct
    signatures."""
    t = type(x)
    if t is str or x is None:
        return x
    if t is int or t is bool or t is float:
        return (t.__name__, x)
    if t is dict:
        try:
            items = sorted(x.items())
        except TypeError:  # mixed-type keys: order by a stable stringification
            items = sorted(x.items(), key=lambda kv: (str(type(kv[0])),
                                                      str(kv[0])))
        # the sentinel keeps {} distinct from [] (and any dict distinct from
        # a list that happens to freeze to the same item tuple)
        return (_DICT_TAG,) + tuple((k, _freeze(v)) for k, v in items)
    if t is list or t is tuple:
        return tuple(_freeze(v) for v in x)
    if isinstance(x, (bool, int, float)):  # numeric subclasses
        return (type(x).__name__, x)
    if isinstance(x, str):
        return str(x)
    if isinstance(x, dict):
        return _freeze(dict(x))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return str(x)


class Interner:
    """Canonical signature -> dense id."""

    def __init__(self):
        self._ids: Dict[object, int] = {}
        self.representatives: List[Pod] = []

    def intern(self, signature, representative) -> int:
        key = _freeze(signature)
        if key not in self._ids:
            self._ids[key] = len(self.representatives)
            self.representatives.append(representative)
        return self._ids[key]

    def __len__(self) -> int:
        return len(self.representatives)


@dataclass
class NodeStatics:
    """Per-node static columns (never mutated by binds)."""

    names: List[str]
    alloc_cpu: np.ndarray        # [N] int64, milli
    alloc_mem: np.ndarray        # [N] int64, bytes
    alloc_gpu: np.ndarray        # [N] int64
    alloc_eph: np.ndarray        # [N] int64
    allowed_pods: np.ndarray     # [N] int64
    alloc_scalar: np.ndarray     # [N, S] int64
    cond_fail_bits: np.ndarray   # [N] int64 (condition+unschedulable reason bits)
    mem_pressure: np.ndarray     # [N] bool
    disk_pressure: np.ndarray    # [N] bool


@dataclass
class SignatureTables:
    """[signature, node] static evaluation tables."""

    selector_ok: np.ndarray      # [Csel, N] bool — nodeSelector + required node affinity
    taint_ok: np.ndarray         # [Ctol, N] bool — NoSchedule/NoExecute taints tolerated
    taint_ok_noexec: np.ndarray  # [Ctol, N] bool — NoExecute-only variant (policy pred)
    intolerable: np.ndarray      # [Ctol, N] int64 — PreferNoSchedule intolerable count
    affinity_count: np.ndarray   # [Caff, N] int64 — preferred node-affinity weight sum
    avoid_score: np.ndarray      # [Cavoid, N] int64 — NodePreferAvoidPods (0 or 10)
    host_ok: np.ndarray          # [Chost, N] bool — spec.nodeName pin


@dataclass
class PodColumns:
    """Per-pod numeric columns + signature ids (the scan's xs)."""

    req_cpu: np.ndarray          # [P] int64 milli
    req_mem: np.ndarray          # [P] int64
    req_gpu: np.ndarray          # [P] int64
    req_eph: np.ndarray          # [P] int64
    req_scalar: np.ndarray       # [P, S] int64
    nz_cpu: np.ndarray           # [P] int64 (non-zero-default cpu, priorities only)
    nz_mem: np.ndarray           # [P] int64
    zero_request: np.ndarray     # [P] bool (PodFitsResources fast path)
    best_effort: np.ndarray      # [P] bool
    sel_id: np.ndarray           # [P] int32
    tol_id: np.ndarray           # [P] int32
    aff_id: np.ndarray           # [P] int32
    avoid_id: np.ndarray         # [P] int32
    host_id: np.ndarray          # [P] int32
    group_id: np.ndarray         # [P] int32 — merged pod-group id (GroupTables)
    # pod-image-set signature id (ImageLocalityPriority table; zeros unless a
    # policy enables the priority — policyc fills it then)
    img_id: np.ndarray           # [P] int32
    # ServiceAffinity predicate column (policy-only; policyc fills it)
    sa_self_id: np.ndarray       # [P] int32 — own-nodeSelector-pin signature


@dataclass
class DynamicInit:
    """Mutable aggregates seeded from pre-scheduled snapshot pods
    (NodeInfo.AddPod accounting, node_info.go:318-398)."""

    used_cpu: np.ndarray         # [N] int64
    used_mem: np.ndarray
    used_gpu: np.ndarray
    used_eph: np.ndarray
    used_scalar: np.ndarray      # [N, S] int64
    nonzero_cpu: np.ndarray      # [N] int64
    nonzero_mem: np.ndarray
    pod_count: np.ndarray        # [N] int64


@dataclass
class GroupTables:
    """Pod-group tables for the features whose state depends on which pods
    sit where: host ports (predicates.go:1019-1039), the volume predicates
    (predicates.go:266-276, 288-460, 510-533), SelectorSpreadPriority
    (selector_spreading.go:66-175) and inter-pod (anti)affinity
    (predicates.go:1125-1450, interpod_affinity.go).

    A "group" is an interned (namespace, labels, pod-(anti)affinity, host
    ports, volumes) pod signature over new + placed-existing pods, MERGED by
    match profile: raw signatures every compiled matcher treats identically
    (same term matches, same service-selector matches, same port set, same
    volume set) and that act identically (same own terms) collapse into one
    group. The pairwise tables are factored through interned spaces so
    nothing is O(G^2): term_match over (namespaces, selector) term
    signatures (row 0 reserved all-False), port_conflict over port sets,
    disk_conflict over volume sets, ss_rows over spread signatures;
    per-group ids index them.

    Topology domains: for each used topologyKey k, topo_dom[k, n] interns
    the node's label value with 0 = label missing (never matches); zone_dom
    likewise interns utilnode.GetZoneKey with 0 = no zone. Term tensors are
    padded on the term axis with valid=False rows."""

    group_of_pod: np.ndarray     # [P] int32 — new pods' group ids
    presence: np.ndarray         # [G, N] int32 — placed existing pods per group
    port_conflict: np.ndarray    # [Pp, Pp] bool — wanted ports of a hit ports of b
    port_sig: np.ndarray         # [G] int32 — group -> port-set id (0 = none)
    disk_conflict: np.ndarray    # [Dv, Dv] bool — volume-set a conflicts with b
    disk_sig: np.ndarray         # [G] int32 — group -> volume-set id (0 = none)
    vol_mask: np.ndarray         # [G, V] bool — MaxPD-relevant volume ids used
    vol_type: np.ndarray         # [V, 3] bool — id counts toward (EBS,GCE,Azure)
    zone_ok: np.ndarray          # [G, N] bool — NoVolumeZoneConflict passes
    used_vols_init: np.ndarray   # [N, V] bool — placed pods' volume ids per node
    ss_rows: np.ndarray          # [Sd, G] bool — b counts toward spread sig s
    ss_sig: np.ndarray           # [G] int32 — group -> its spread sig (0 = none)
    # ServiceAntiAffinity and ServiceAffinity (policy): first-matching-
    # service selector signatures (the lister-order-first service; services
    # are static during a run, so "first" is a compile-time property)
    saa_rows: np.ndarray         # [Fd, G] bool — b counts toward first-sel f
    saa_sig: np.ndarray          # [G] int32 — group -> its first-sel sig (0 = none)
    term_match: np.ndarray       # [Td, G] bool — term t matches a pod of group b
    zone_dom: np.ndarray         # [N] int32
    topo_dom: np.ndarray         # [K, N] int32
    aff_valid: np.ndarray        # [G, Ta] bool — required pod-affinity terms
    aff_err: np.ndarray          # [G] bool — any term with empty topologyKey
    aff_empty: np.ndarray        # [G, Ta] bool — per-term empty topologyKey
    aff_term: np.ndarray         # [G, Ta] int32 (into Td)
    aff_key: np.ndarray          # [G, Ta] int32 (into K)
    aff_hostname: np.ndarray     # [G, Ta] bool — topologyKey == kubernetes.io/hostname
    aff_self: np.ndarray         # [G, Ta] bool — the pod matches its own term
    aff_unplaced: np.ndarray     # [G, Ta] bool — an unplaced snapshot pod matches
    anti_valid: np.ndarray       # [G, Tb] bool — required pod-anti-affinity terms
    anti_err: np.ndarray         # [G] bool
    anti_empty: np.ndarray       # [G, Tb] bool
    anti_term: np.ndarray        # [G, Tb] int32 (into Td)
    anti_key: np.ndarray         # [G, Tb] int32
    anti_hostname: np.ndarray    # [G, Tb] bool
    pref_w: np.ndarray           # [G, Tp] float64 — preferred terms, signed weight
    pref_term: np.ndarray        # [G, Tp] int32 (into Td)
    pref_key: np.ndarray         # [G, Tp] int32
    # (namespace, selector) per first-sel sig, index 0 = None; the
    # ServiceAffinity first-pod locks resolve against these
    saa_defs: list = field(default_factory=list)


@dataclass
class CompiledCluster:
    statics: NodeStatics
    tables: SignatureTables
    groups: GroupTables
    dynamic: DynamicInit
    scalar_names: List[str]
    node_index: Dict[str, int]
    # pod-group features present in the batch or among the placed pods
    has_ports: bool = False
    has_services: bool = False
    has_interpod: bool = False
    has_disk_conflict: bool = False
    has_maxpd: bool = False
    has_vol_zone: bool = False
    # taint_ok_noexec and the saa tables hold real rows (the no-policy
    # compile ships dummies of the right shape)
    has_noexec_table: bool = False
    has_saa_table: bool = False
    maxpd_limits: tuple = DEFAULT_MAXPD_LIMITS   # (EBS, GCE PD, AzureDisk)
    n_topo_doms: int = 1         # segment count for topo_dom (incl. invalid 0)
    n_zone_doms: int = 1
    # group budgets exceeded or volume semantics that need the host engine;
    # the port has none, so the backend raises with these reasons
    unsupported: List[str] = field(default_factory=list)


def _selector_signature(pod: Pod):
    aff = pod.spec.affinity
    na = aff.node_affinity.to_obj() if (aff and aff.node_affinity) else None
    return {"nodeSelector": pod.spec.node_selector,
            "required": (na or {}).get("requiredDuringSchedulingIgnoredDuringExecution")}


def _toleration_signature(pod: Pod):
    return {"tolerations": [t.to_obj() for t in pod.spec.tolerations]}


def _affinity_signature(pod: Pod):
    aff = pod.spec.affinity
    na = aff.node_affinity.to_obj() if (aff and aff.node_affinity) else None
    return {"preferred": (na or {}).get("preferredDuringSchedulingIgnoredDuringExecution")}


def _avoid_signature(pod: Pod):
    ref = pod.metadata.controller_ref()
    if ref is None or ref.kind not in ("ReplicationController", "ReplicaSet"):
        return None
    return {"kind": ref.kind, "uid": ref.uid}


def _host_signature(pod: Pod):
    return pod.spec.node_name or None


# ---------------------------------------------------------------------------
# pod-group compilation (host ports / volumes / selector spreading)
# ---------------------------------------------------------------------------

_ANY_IP = "0.0.0.0"


def _sanitized_ports(pod: Pod) -> list:
    """Wanted (ip, protocol, port) triples, HostPortInfo-sanitized
    (util/utils.go:51-137: ip defaults 0.0.0.0, protocol TCP, port>0 only)."""
    out = set()
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                out.add((p.host_ip or _ANY_IP, p.protocol or "TCP", p.host_port))
    return sorted(out)


def _ports_conflict(wants: list, occupied: list) -> bool:
    """check_conflict over a full pod pair: 0.0.0.0 wildcards either side."""
    for wip, wproto, wport in wants:
        for oip, oproto, oport in occupied:
            if (wport == oport and wproto == oproto
                    and (wip == _ANY_IP or oip == _ANY_IP or wip == oip)):
                return True
    return False


def _group_signature(pod: Pod):
    aff = pod.spec.affinity
    return {
        "ns": pod.namespace,
        "labels": pod.metadata.labels,
        "aff": aff.pod_affinity.to_obj() if (aff and aff.pod_affinity) else None,
        "anti": (aff.pod_anti_affinity.to_obj()
                 if (aff and aff.pod_anti_affinity) else None),
        "ports": _sanitized_ports(pod),
        # volumes drive NoDiskConflict/MaxPDVolumeCount/NoVolumeZoneConflict;
        # [] keeps volume-less pods in one signature class
        "vols": sorted(json.dumps(v.to_obj(), sort_keys=True)
                       for v in pod.spec.volumes),
    }


def _has_interpod_terms(pod: Pod) -> bool:
    a = pod.spec.affinity
    return a is not None and (a.pod_affinity is not None
                              or a.pod_anti_affinity is not None)


def _req_aff_terms(pod: Pod) -> list:
    a = pod.spec.affinity
    return get_pod_affinity_terms(a.pod_affinity) if a else []


def _req_anti_terms(pod: Pod) -> list:
    a = pod.spec.affinity
    return get_pod_anti_affinity_terms(a.pod_anti_affinity) if a else []


def _pref_terms(pod: Pod) -> list:
    """Signed (weight, term): preferred affinity positive, anti negative
    (interpod_affinity.go processWeightedTerms multipliers)."""
    a = pod.spec.affinity
    out = []
    if a and a.pod_affinity:
        out += [(wt.weight, wt.pod_affinity_term)
                for wt in a.pod_affinity.preferred]
    if a and a.pod_anti_affinity:
        out += [(-wt.weight, wt.pod_affinity_term)
                for wt in a.pod_anti_affinity.preferred]
    return out


class _VolumeFallback(Exception):
    """Raised during volume compilation when the workload needs host-side
    semantics (resolution errors the reference reports per pod) or exceeds a
    budget."""


_MAXPD_TYPES = ("EBS", "GCE", "AzureDisk")


def _compile_volumes(raw_reps: List[Pod], nodes: List[Node],
                     snapshot: ClusterSnapshot, max_work: int):
    """Device tables for NoDiskConflict / MaxPDVolumeCount /
    NoVolumeZoneConflict (predicates.go:266-276, 288-460, 510-533).

    Volume sets are interned per (namespace, volumes) signature; PVC->PV
    resolution happens here against the snapshot, so the device only carries
    a per-node used-volume-id matrix and static conflict/zone tables.
    Returns (vsig_raw[Graw], disk_conflict[Dv,Dv], vol_mask[Dv,V],
    vol_type[V,3], zone_rows[Dv,N], limits, has_disk, has_maxpd,
    has_zone)."""
    graw = len(raw_reps)
    n = len(nodes)
    pvcs = {pvc.key(): pvc for pvc in snapshot.pvcs}
    pvs = {pv.name: pv for pv in snapshot.pvs}
    node_constraints = [
        {k: v for k, v in node.metadata.labels.items() if k in _ZONE_LABELS}
        for node in nodes]
    any_zone_nodes = any(node_constraints)

    # --- volume-set signature interning over raw groups ---
    vsig_ids: Dict[str, int] = {"": 0}
    vsig_reps: List[Optional[Pod]] = [None]
    vsig_raw = np.zeros(graw, np.int32)
    for b, rep in enumerate(raw_reps):
        if not rep.spec.volumes:
            continue
        key = json.dumps([rep.namespace,
                          sorted(json.dumps(v.to_obj(), sort_keys=True)
                                 for v in rep.spec.volumes)])
        vid = vsig_ids.get(key)
        if vid is None:
            vid = len(vsig_reps)
            vsig_ids[key] = vid
            vsig_reps.append(rep)
        vsig_raw[b] = vid
    dv = len(vsig_reps)
    if dv * dv + dv * n > max_work:
        raise _VolumeFallback(
            f"volume-set precompute ({dv} sets, {n} nodes) exceeds the jax "
            f"backend work budget ({max_work})")

    # --- NoDiskConflict: pairwise conflicts between volume sets ---
    disk_conflict = np.zeros((dv, dv), dtype=bool)
    for a in range(1, dv):
        for b in range(1, dv):
            disk_conflict[a, b] = any(
                is_volume_conflict(v, vsig_reps[b])
                for v in vsig_reps[a].spec.volumes)
    has_disk = bool(disk_conflict.any())

    # --- MaxPDVolumeCount: per-set relevant volume ids (resolved via PVC->PV;
    # unresolvable claims count conservatively toward every filter type) ---
    vol_ids: Dict[tuple, int] = {}
    set_ids: List[List[int]] = [[] for _ in range(dv)]
    id_types: List[set] = []

    def intern_vol(key: tuple, types: set) -> int:
        vid = vol_ids.get(key)
        if vid is None:
            vid = len(id_types)
            vol_ids[key] = vid
            id_types.append(set())
        id_types[vid] |= types
        return vid

    for s in range(1, dv):
        rep = vsig_reps[s]
        for vol in rep.spec.volumes:
            direct = False
            for t, name in enumerate(_MAXPD_TYPES):
                vol_src, _, id_field, _ = _VOLUME_FILTERS[name]
                src = vol_src(vol)
                if src is not None:
                    set_ids[s].append(intern_vol(
                        (name, src.get(id_field, "")), {t}))
                    direct = True
                    break
            if direct:
                continue
            pvc_name = vol.pvc_name
            if pvc_name is None:
                continue
            if pvc_name == "":
                raise _VolumeFallback(
                    "a pod volume has a PersistentVolumeClaim with no name")
            pvc = pvcs.get(f"{rep.namespace}/{pvc_name}")
            pv = pvs.get(pvc.volume_name) if (pvc and pvc.volume_name) else None
            if pv is None:
                # missing PVC / unbound PVC / missing PV: conservative id
                # counted toward every type (predicates.go:379-410); the zone
                # predicate would error on these when zone constraints exist
                if any_zone_nodes:
                    raise _VolumeFallback(
                        f'unresolvable PersistentVolumeClaim "{pvc_name}" with '
                        "zone-constrained nodes (NoVolumeZoneConflict errors "
                        "host-side)")
                set_ids[s].append(intern_vol(
                    ("pvc", f"{rep.namespace}/{pvc_name}"), {0, 1, 2}))
                continue
            for t, name in enumerate(_MAXPD_TYPES):
                _, pv_src, id_field, _ = _VOLUME_FILTERS[name]
                src = pv_src(pv)
                if src is not None:
                    set_ids[s].append(intern_vol(
                        (name, src.get(id_field, "")), {t}))
                    break
    v_count = len(id_types)
    max_vol_ids = env_int("TPUSIM_MAX_VOLUME_IDS", MAX_VOLUME_IDS)
    if v_count > max_vol_ids:
        raise _VolumeFallback(
            f"{v_count} distinct MaxPD volume ids exceed the jax backend "
            f"limit ({max_vol_ids})")
    v_dim = max(v_count, 1)
    vol_mask = np.zeros((dv, v_dim), dtype=bool)
    for s in range(dv):
        for vid in set_ids[s]:
            vol_mask[s, vid] = True
    vol_type = np.zeros((v_dim, 3), dtype=bool)
    for vid, types in enumerate(id_types):
        for t in types:
            vol_type[vid, t] = True
    has_maxpd = v_count > 0
    limits = effective_maxpd_limits()

    # --- NoVolumeZoneConflict: static (volume set, node) pass/fail ---
    zone_rows = np.ones((dv, n), dtype=bool)
    has_zone = False
    if any_zone_nodes:
        for s in range(1, dv):
            rep = vsig_reps[s]
            for vol in rep.spec.volumes:
                pvc_name = vol.pvc_name
                if not pvc_name:
                    continue
                pvc = pvcs[f"{rep.namespace}/{pvc_name}"]  # resolved above
                pv = pvs[pvc.volume_name]
                for k, v in pv.metadata.labels.items():
                    if k not in _ZONE_LABELS:
                        continue
                    try:
                        allowed = label_zones_to_set(v)
                    except ValueError:
                        continue  # unparsable label ignored
                    for i, constraints in enumerate(node_constraints):
                        if not constraints:
                            continue  # zone-label-less node passes trivially
                        # a constrained node missing the PV's label fails too
                        # (nodeConstraints[k] yields "" in the reference)
                        if constraints.get(k) not in allowed:
                            zone_rows[s, i] = False
                            has_zone = True
    return (vsig_raw, disk_conflict, vol_mask, vol_type, zone_rows, limits,
            has_disk, has_maxpd, has_zone)


def _trivial_groups(num_pods: int, n: int) -> GroupTables:
    z = np.zeros
    return GroupTables(
        group_of_pod=z(num_pods, np.int32), presence=z((1, n), np.int32),
        port_conflict=z((1, 1), bool), port_sig=z(1, np.int32),
        disk_conflict=z((1, 1), bool), disk_sig=z(1, np.int32),
        vol_mask=z((1, 1), bool), vol_type=z((1, 3), bool),
        zone_ok=np.ones((1, n), bool), used_vols_init=z((n, 1), bool),
        ss_rows=z((1, 1), bool), ss_sig=z(1, np.int32),
        saa_rows=z((1, 1), bool), saa_sig=z(1, np.int32),
        term_match=z((1, 1), bool),
        zone_dom=z(n, np.int32), topo_dom=z((1, n), np.int32),
        aff_valid=z((1, 1), bool), aff_err=z(1, bool), aff_empty=z((1, 1), bool),
        aff_term=z((1, 1), np.int32), aff_key=z((1, 1), np.int32),
        aff_hostname=z((1, 1), bool), aff_self=z((1, 1), bool),
        aff_unplaced=z((1, 1), bool),
        anti_valid=z((1, 1), bool), anti_err=z(1, bool), anti_empty=z((1, 1), bool),
        anti_term=z((1, 1), np.int32), anti_key=z((1, 1), np.int32),
        anti_hostname=z((1, 1), bool),
        pref_w=z((1, 1), np.float64), pref_term=z((1, 1), np.int32),
        pref_key=z((1, 1), np.int32))


@dataclass
class _GroupCompile:
    """What `_compile_groups` hands compile_cluster."""

    tables: GroupTables
    has_ports: bool = False
    has_services: bool = False
    has_interpod: bool = False
    has_disk_conflict: bool = False
    has_maxpd: bool = False
    has_vol_zone: bool = False
    maxpd_limits: tuple = DEFAULT_MAXPD_LIMITS
    n_topo_doms: int = 1
    n_zone_doms: int = 1
    unsupported: List[str] = field(default_factory=list)
    # each raw canonical group signature key -> its merged group id (the
    # incremental cluster scatters a placed pod's presence through it)
    sig_to_gid: Dict[object, int] = field(default_factory=dict)


def _compile_groups(snapshot: ClusterSnapshot, pods: List[Pod],
                    nodes: List[Node], node_index: Dict[str, int],
                    need_saa: bool = False) -> _GroupCompile:
    """Build GroupTables and the feature flags. need_saa: intern the
    first-matching-service signatures a policy's ServiceAntiAffinity and
    ServiceAffinity read."""
    n = len(nodes)
    placed = [p for p in snapshot.pods if p.spec.node_name in node_index]
    # pods with an unknown-but-set nodeName still count for "a matching pod
    # exists"; nodeName-less (pending) pods are not scheduled pods and never
    # count
    unplaced = [p for p in snapshot.pods
                if p.spec.node_name and p.spec.node_name not in node_index]
    both = list(pods) + placed

    has_ports = any(_sanitized_ports(p) for p in both)
    has_interpod = any(_has_interpod_terms(p) for p in both)
    has_services = bool(snapshot.services)
    has_volumes = any(p.spec.volumes for p in both)
    trivial = _trivial_groups(len(pods), n)
    if not (has_ports or has_interpod or has_services or has_volumes):
        return _GroupCompile(tables=trivial)

    max_groups, max_raw, max_work, max_presence = _group_budgets()

    def fallback(reason: str) -> _GroupCompile:
        return _GroupCompile(tables=trivial, unsupported=[reason])

    # --- 1. raw signature interning ---
    gi = Interner()
    raw_of_pod = [gi.intern(_group_signature(p), p) for p in pods]
    placed_raw = [gi.intern(_group_signature(p), p) for p in placed]
    graw = len(gi)
    if graw > max_raw:
        return fallback(f"{graw} distinct raw pod groups exceed the jax "
                        f"backend limit ({max_raw})")
    raw_reps = gi.representatives
    raw_keys = list(gi._ids)  # insertion-ordered: index == raw id

    # --- volume tables (NoDiskConflict / MaxPDVolumeCount / NoVolumeZone) ---
    if has_volumes:
        try:
            (vsig_raw, disk_conflict, vsig_mask, vol_type, zone_rows,
             maxpd_limits, has_disk, has_maxpd, has_zone) = _compile_volumes(
                 raw_reps, nodes, snapshot, max_work)
        except _VolumeFallback as exc:
            return fallback(str(exc))
    else:
        vsig_raw = np.zeros(graw, np.int32)
        disk_conflict = np.zeros((1, 1), bool)
        vsig_mask = np.zeros((1, 1), bool)
        vol_type = np.zeros((1, 3), bool)
        zone_rows = np.ones((1, n), bool)
        maxpd_limits = DEFAULT_MAXPD_LIMITS
        has_disk = has_maxpd = has_zone = False

    # --- 2. intern matcher spaces: terms, spread signatures, port sets ---
    # term signature = (resolved namespaces, selector): that pair fully
    # determines which pods a term matches (predicates.go
    # podMatchesTermNamespaceAndSelector)
    term_defs: List[Optional[tuple]] = [None]  # index 0 reserved: matches nothing
    term_ids: Dict[str, int] = {}

    def intern_term(rep: Pod, term) -> int:
        namespaces = get_namespaces_from_pod_affinity_term(rep, term)
        sel = term.label_selector
        key = json.dumps([sorted(namespaces),
                          sel.to_obj() if sel is not None else None],
                         sort_keys=True)
        tid = term_ids.get(key)
        if tid is None:
            tid = len(term_defs)
            term_ids[key] = tid
            term_defs.append((namespaces, sel))
        return tid

    # raw per-group actor term lists: [(tid, topology_key[, weight])] per
    # kind, interned rep by rep (the term ids follow that order)
    aff_of: List[list] = []
    anti_of: List[list] = []
    pref_of: List[list] = []
    if has_interpod:
        for rep in raw_reps:
            aff_of.append([(intern_term(rep, t), t.topology_key)
                           for t in _req_aff_terms(rep)])
            anti_of.append([(intern_term(rep, t), t.topology_key)
                            for t in _req_anti_terms(rep)])
            pref_of.append([(intern_term(rep, t), t.topology_key, w)
                            for w, t in _pref_terms(rep)])
    else:
        aff_of = anti_of = pref_of = [[] for _ in raw_reps]
    td = len(term_defs)

    # spread signature = (namespace, selected service selectors); 0 = none
    spread_defs: List[tuple] = [None]
    spread_ids: Dict[str, int] = {}
    ss_sig_raw = np.zeros(graw, np.int32)
    if has_services and len(snapshot.services) * graw > max_work:
        # the service->group scan below is O(services * graw); budget it like
        # the matcher rows so a huge snapshot can't hang host compile
        return fallback(
            f"pod-group service scan ({len(snapshot.services)} services x "
            f"{graw} raw groups) exceeds the jax backend work budget "
            f"({max_work})")
    saa_defs: List[Optional[tuple]] = [None]
    saa_ids: Dict[str, int] = {}
    saa_sig_raw = np.zeros(graw, np.int32)
    if has_services:
        for b, rep in enumerate(raw_reps):
            sels = [dict(svc.selector) for svc in snapshot.services
                    if (svc.namespace == rep.namespace and svc.selector
                        and all(rep.metadata.labels.get(k) == v
                                for k, v in svc.selector.items()))]
            if not sels:
                continue
            key = json.dumps([rep.namespace,
                              sorted(json.dumps(s, sort_keys=True) for s in sels)])
            sid = spread_ids.get(key)
            if sid is None:
                sid = len(spread_defs)
                spread_ids[key] = sid
                spread_defs.append((rep.namespace, sels))
            ss_sig_raw[b] = sid
            if need_saa:
                # the first matching service's selector is sels[0]
                # (sels keeps the lister order)
                fkey = json.dumps([rep.namespace,
                                   json.dumps(sels[0], sort_keys=True)])
                fid = saa_ids.get(fkey)
                if fid is None:
                    fid = len(saa_defs)
                    saa_ids[fkey] = fid
                    saa_defs.append((rep.namespace, sels[0]))
                saa_sig_raw[b] = fid
    sd = len(spread_defs)
    fd = len(saa_defs)
    if (td + sd + (fd - 1)) * graw > max_work:
        return fallback(
            f"pod-group matcher precompute ({td} terms + {sd} spread sigs + "
            f"{fd - 1} service-anti-affinity sigs x {graw} raw groups) "
            f"exceeds the jax backend work budget ({max_work})")

    # port-set interning; 0 = no ports
    port_defs: List[list] = [[]]
    port_ids: Dict[tuple, int] = {(): 0}
    port_sig_raw = np.zeros(graw, np.int32)
    if has_ports:
        for b, rep in enumerate(raw_reps):
            ports = tuple(_sanitized_ports(rep))
            pid = port_ids.get(ports)
            if pid is None:
                pid = len(port_defs)
                port_ids[ports] = pid
                port_defs.append(list(ports))
            port_sig_raw[b] = pid
    pp = len(port_defs)
    port_conflict = np.zeros((pp, pp), dtype=bool)
    for a in range(1, pp):
        for b in range(1, pp):
            port_conflict[a, b] = _ports_conflict(port_defs[a], port_defs[b])

    # --- 3. matcher rows over raw groups ---
    term_match_raw = np.zeros((td, graw), dtype=bool)
    unplaced_match = np.zeros(td, dtype=bool)
    for tid in range(1, td):
        namespaces, sel = term_defs[tid]
        for b, rep in enumerate(raw_reps):
            term_match_raw[tid, b] = pod_matches_term_namespace_and_selector(
                rep, namespaces, sel)
        unplaced_match[tid] = any(
            pod_matches_term_namespace_and_selector(u, namespaces, sel)
            for u in unplaced)

    ss_rows_raw = np.zeros((sd, graw), dtype=bool)
    for sid in range(1, sd):
        ns, sels = spread_defs[sid]
        for b, rep in enumerate(raw_reps):
            ss_rows_raw[sid, b] = rep.namespace == ns and any(
                all(rep.metadata.labels.get(k) == v for k, v in sel.items())
                for sel in sels)

    saa_rows_raw = np.zeros((fd, graw), dtype=bool)
    for fid in range(1, fd):
        ns, sel = saa_defs[fid]
        for b, rep in enumerate(raw_reps):
            saa_rows_raw[fid, b] = rep.namespace == ns and all(
                rep.metadata.labels.get(k) == v for k, v in sel.items())

    # --- 4. merge raw groups by match profile ---
    # two raw groups are indistinguishable when every matcher treats them the
    # same (same term, spread and first-service columns, same port set, same
    # volume set) and they act identically (same own terms with the same
    # topology keys and weights, same spread and first-service sigs)
    merged: Dict[tuple, int] = {}
    gid_of_raw = np.zeros(graw, np.int32)
    rep_raw_idx: List[int] = []
    for b in range(graw):
        profile = (term_match_raw[:, b].tobytes(), ss_rows_raw[:, b].tobytes(),
                   saa_rows_raw[:, b].tobytes(),
                   int(port_sig_raw[b]), int(ss_sig_raw[b]),
                   int(saa_sig_raw[b]), int(vsig_raw[b]),
                   tuple(aff_of[b]), tuple(anti_of[b]), tuple(pref_of[b]))
        gid = merged.get(profile)
        if gid is None:
            gid = len(rep_raw_idx)
            merged[profile] = gid
            rep_raw_idx.append(b)
        gid_of_raw[b] = gid
    g = len(rep_raw_idx)
    if g > max_groups:
        return fallback(f"{g} distinct pod groups exceed the jax backend "
                        f"limit ({max_groups})")
    if g * n * 4 > max_presence:
        return fallback(
            f"pod-group presence state ({g} groups x {n} nodes) exceeds the "
            f"jax backend memory budget ({max_presence} bytes)")

    group_of_pod = (gid_of_raw[np.array(raw_of_pod, dtype=np.int64)]
                    if raw_of_pod else np.zeros(0, np.int32)).astype(np.int32)
    sel_cols = np.array(rep_raw_idx, dtype=np.int64)
    term_match = term_match_raw[:, sel_cols] if graw else term_match_raw
    ss_rows = ss_rows_raw[:, sel_cols] if graw else ss_rows_raw
    saa_rows = saa_rows_raw[:, sel_cols] if graw else saa_rows_raw
    presence = np.zeros((g, n), dtype=np.int32)
    used_vols_init = np.zeros((n, vsig_mask.shape[1]), dtype=bool)
    for raw_id, p in zip(placed_raw, placed):
        i = node_index[p.spec.node_name]
        presence[gid_of_raw[raw_id], i] += 1
        if has_maxpd:
            used_vols_init[i] |= vsig_mask[vsig_raw[raw_id]]

    zone_dom = np.zeros(n, dtype=np.int32)
    n_zone_doms = 1
    if has_services:
        zvals: Dict[str, int] = {}
        for i, node in enumerate(nodes):
            z = get_zone_key(node)
            if z:
                zone_dom[i] = zvals.setdefault(z, len(zvals) + 1)
        n_zone_doms = len(zvals) + 1

    # --- 5. topology keys + per-group actor tensors over merged groups ---
    topo_keys: List[str] = []
    if has_interpod:
        seen_keys = set()
        for b in rep_raw_idx:
            keys = ([key for _, key in aff_of[b] + anti_of[b]]
                    + [key for _, key, _ in pref_of[b]])
            for key in keys:
                if key and key not in seen_keys:
                    seen_keys.add(key)
                    topo_keys.append(key)
    key_idx = {key: i for i, key in enumerate(topo_keys)}
    topo_dom = np.zeros((max(len(topo_keys), 1), n), dtype=np.int32)
    n_topo_doms = 1
    for k, key in enumerate(topo_keys):
        vals: Dict[str, int] = {}
        for i, node in enumerate(nodes):
            v = node.metadata.labels.get(key)
            if v is not None:
                topo_dom[k, i] = vals.setdefault(v, len(vals) + 1)
        n_topo_doms = max(n_topo_doms, len(vals) + 1)

    ta = max([1] + [len(aff_of[b]) for b in rep_raw_idx])
    tb = max([1] + [len(anti_of[b]) for b in rep_raw_idx])
    tp = max([1] + [len(pref_of[b]) for b in rep_raw_idx])
    ip = {name: np.zeros((g, t), dtype)
          for name, t, dtype in (
              ("aff_valid", ta, bool), ("aff_empty", ta, bool),
              ("aff_term", ta, np.int32), ("aff_key", ta, np.int32),
              ("aff_hostname", ta, bool), ("aff_self", ta, bool),
              ("aff_unplaced", ta, bool),
              ("anti_valid", tb, bool), ("anti_empty", tb, bool),
              ("anti_term", tb, np.int32), ("anti_key", tb, np.int32),
              ("anti_hostname", tb, bool),
              ("pref_w", tp, np.float64), ("pref_term", tp, np.int32),
              ("pref_key", tp, np.int32))}
    ip["aff_err"] = np.zeros(g, bool)
    ip["anti_err"] = np.zeros(g, bool)
    for a, b in enumerate(rep_raw_idx):
        for t, (tid, key) in enumerate(aff_of[b]):
            ip["aff_valid"][a, t] = True
            ip["aff_term"][a, t] = tid
            if not key:
                # an empty topologyKey errors the whole predicate
                ip["aff_empty"][a, t] = True
                ip["aff_err"][a] = True
            else:
                ip["aff_key"][a, t] = key_idx[key]
                ip["aff_hostname"][a, t] = key == LABEL_HOSTNAME
            ip["aff_self"][a, t] = term_match[tid, a]
            ip["aff_unplaced"][a, t] = unplaced_match[tid]
        for t, (tid, key) in enumerate(anti_of[b]):
            ip["anti_valid"][a, t] = True
            ip["anti_term"][a, t] = tid
            if not key:
                ip["anti_empty"][a, t] = True
                ip["anti_err"][a] = True
            else:
                ip["anti_key"][a, t] = key_idx[key]
                ip["anti_hostname"][a, t] = key == LABEL_HOSTNAME
        for t, (tid, key, w) in enumerate(pref_of[b]):
            if not key:
                continue  # NodesHaveSameTopologyKey("") is always False
            ip["pref_w"][a, t] = float(w)
            ip["pref_term"][a, t] = tid
            ip["pref_key"][a, t] = key_idx[key]

    tables = GroupTables(
        group_of_pod=group_of_pod, presence=presence,
        port_conflict=port_conflict,
        port_sig=port_sig_raw[sel_cols].astype(np.int32),
        disk_conflict=disk_conflict,
        disk_sig=vsig_raw[sel_cols].astype(np.int32),
        vol_mask=vsig_mask[vsig_raw[sel_cols]], vol_type=vol_type,
        zone_ok=zone_rows[vsig_raw[sel_cols]], used_vols_init=used_vols_init,
        ss_rows=ss_rows, ss_sig=ss_sig_raw[sel_cols].astype(np.int32),
        saa_rows=saa_rows, saa_sig=saa_sig_raw[sel_cols].astype(np.int32),
        saa_defs=list(saa_defs),
        term_match=term_match, zone_dom=zone_dom, topo_dom=topo_dom, **ip)
    return _GroupCompile(
        tables=tables, has_ports=has_ports, has_services=has_services,
        has_interpod=has_interpod, has_disk_conflict=has_disk,
        has_maxpd=has_maxpd, has_vol_zone=has_zone, maxpd_limits=maxpd_limits,
        n_topo_doms=n_topo_doms, n_zone_doms=n_zone_doms,
        sig_to_gid={key: int(gid_of_raw[b]) for b, key in enumerate(raw_keys)})


def node_static_row(node: Node, ni: NodeInfo, scalar_idx: Dict[str, int],
                    s: int):
    """One node's static column values:
    (cpu, mem, gpu, eph, pods, scalar_row[s], cond_bits, mem_p, disk_p)."""
    r = ni.allocatable_resource
    scalar_row = np.zeros(s, dtype=np.int64)
    for name, v in r.scalar.items():
        scalar_row[scalar_idx[name]] = v
    bits = 0
    for cond in node.status.conditions:
        if cond.type == "Ready" and cond.status != "True":
            bits |= 1 << BIT_NODE_NOT_READY
        elif cond.type == "OutOfDisk" and cond.status != "False":
            bits |= 1 << BIT_NODE_OUT_OF_DISK
        elif cond.type == "NetworkUnavailable" and cond.status != "False":
            bits |= 1 << BIT_NODE_NETWORK_UNAVAILABLE
    if node.spec.unschedulable:
        bits |= 1 << BIT_NODE_UNSCHEDULABLE
    return (r.milli_cpu, r.memory, r.nvidia_gpu, r.ephemeral_storage,
            r.allowed_pod_number, scalar_row, bits, ni.memory_pressure,
            ni.disk_pressure)


def signature_row_fns(nodes: List[Node], node_infos: List[NodeInfo]):
    """Per-signature-table cell evaluators: kind -> (fn(rep, node_idx), dtype).
    The interner each table reads from is fixed: selector_ok<-sel,
    taint_ok+intolerable<-tol, affinity_count<-aff, avoid_score<-avoid,
    host_ok<-host."""

    def selector_fn(rep: Pod, i: int) -> bool:
        return pod_matches_node_labels(rep, nodes[i])

    def taint_ok_fn(rep: Pod, i: int) -> bool:
        return find_matching_untolerated_taint(
            node_infos[i].taints, rep.spec.tolerations,
            lambda t: t.effect in ("NoSchedule", "NoExecute")) is None

    def taint_ok_noexec_fn(rep: Pod, i: int) -> bool:
        # PodToleratesNodeNoExecuteTaints (policy-registered): NoExecute only
        return find_matching_untolerated_taint(
            node_infos[i].taints, rep.spec.tolerations,
            lambda t: t.effect == "NoExecute") is None

    def intolerable_fn(rep: Pod, i: int) -> int:
        tols = [t for t in rep.spec.tolerations
                if not t.effect or t.effect == TAINT_PREFER_NO_SCHEDULE]
        return sum(1 for taint in node_infos[i].taints
                   if taint.effect == TAINT_PREFER_NO_SCHEDULE
                   and not tolerations_tolerate_taint(tols, taint))

    def affinity_fn(rep: Pod, i: int) -> int:
        return calculate_node_affinity_priority_map(rep, None, node_infos[i]).score

    def avoid_fn(rep: Pod, i: int) -> int:
        return calculate_node_prefer_avoid_pods_priority_map(
            rep, None, node_infos[i]).score

    def host_fn(rep: Pod, i: int) -> bool:
        return (not rep.spec.node_name) or rep.spec.node_name == nodes[i].name

    return {
        "selector_ok": (selector_fn, bool),
        "taint_ok": (taint_ok_fn, bool),
        "taint_ok_noexec": (taint_ok_noexec_fn, bool),
        "intolerable": (intolerable_fn, np.int64),
        "affinity_count": (affinity_fn, np.int64),
        "avoid_score": (avoid_fn, np.int64),
        "host_ok": (host_fn, bool),
    }


def fill_pod_request_row(cols: PodColumns, j: int, pod: Pod, req,
                         scalar_idx: Dict[str, int]) -> None:
    """Fill one pod's numeric request columns."""
    cols.req_cpu[j] = req.milli_cpu
    cols.req_mem[j] = req.memory
    cols.req_gpu[j] = req.nvidia_gpu
    cols.req_eph[j] = req.ephemeral_storage
    for name, v in req.scalar.items():
        cols.req_scalar[j, scalar_idx[name]] = v
    cols.zero_request[j] = (req.milli_cpu == 0 and req.memory == 0
                            and req.nvidia_gpu == 0 and req.ephemeral_storage == 0
                            and not req.scalar)
    nz = get_nonzero_pod_request(pod)
    cols.nz_cpu[j] = nz.milli_cpu
    cols.nz_mem[j] = nz.memory
    cols.best_effort[j] = is_pod_best_effort(pod)


def compile_cluster(snapshot: ClusterSnapshot, pods: List[Pod],
                    need_noexec: bool = False, need_saa: bool = False
                    ) -> Tuple[CompiledCluster, PodColumns]:
    """Build columnar state for `pods` scheduled against `snapshot`.

    need_noexec: compute the PodToleratesNodeNoExecuteTaints table (only a
    policy enables that predicate; otherwise an all-pass dummy of the right
    shape). need_saa: intern the first-matching-service signatures of a
    policy's ServiceAntiAffinity and ServiceAffinity."""
    nodes = snapshot.nodes
    n = len(nodes)

    # single pass: NodeInfos, per-pod requests, and the scalar name space
    node_infos: List[NodeInfo] = []
    for node in nodes:
        ni = NodeInfo()
        ni.set_node(node)
        node_infos.append(ni)
    pod_requests = [get_resource_request(pod) for pod in pods]
    existing_requests = [get_resource_request(pod) for pod in snapshot.pods]

    scalar_names: List[str] = []
    seen = set()

    def _note_scalars(names):
        for name in names:
            if name not in seen:
                seen.add(name)
                scalar_names.append(name)

    for req in pod_requests + existing_requests:
        _note_scalars(req.scalar)
    for ni in node_infos:
        _note_scalars(ni.allocatable_resource.scalar)
    s = len(scalar_names)
    scalar_idx = {name: i for i, name in enumerate(scalar_names)}

    # --- node statics ---
    alloc = {k: np.zeros(n, dtype=np.int64)
             for k in ("cpu", "mem", "gpu", "eph", "pods")}
    alloc_scalar = np.zeros((n, s), dtype=np.int64)
    cond_bits = np.zeros(n, dtype=np.int64)
    mem_pressure = np.zeros(n, dtype=bool)
    disk_pressure = np.zeros(n, dtype=bool)
    for i, node in enumerate(nodes):
        row = node_static_row(node, node_infos[i], scalar_idx, s)
        alloc["cpu"][i], alloc["mem"][i], alloc["gpu"][i] = row[0], row[1], row[2]
        alloc["eph"][i], alloc["pods"][i] = row[3], row[4]
        alloc_scalar[i] = row[5]
        cond_bits[i], mem_pressure[i], disk_pressure[i] = row[6], row[7], row[8]

    statics = NodeStatics(
        names=[nd.name for nd in nodes],
        alloc_cpu=alloc["cpu"], alloc_mem=alloc["mem"], alloc_gpu=alloc["gpu"],
        alloc_eph=alloc["eph"], allowed_pods=alloc["pods"],
        alloc_scalar=alloc_scalar, cond_fail_bits=cond_bits,
        mem_pressure=mem_pressure, disk_pressure=disk_pressure)

    # --- pod columns + signature interning ---
    p = len(pods)
    cols = PodColumns(
        req_cpu=np.zeros(p, dtype=np.int64), req_mem=np.zeros(p, dtype=np.int64),
        req_gpu=np.zeros(p, dtype=np.int64), req_eph=np.zeros(p, dtype=np.int64),
        req_scalar=np.zeros((p, s), dtype=np.int64),
        nz_cpu=np.zeros(p, dtype=np.int64), nz_mem=np.zeros(p, dtype=np.int64),
        zero_request=np.zeros(p, dtype=bool), best_effort=np.zeros(p, dtype=bool),
        sel_id=np.zeros(p, dtype=np.int32), tol_id=np.zeros(p, dtype=np.int32),
        aff_id=np.zeros(p, dtype=np.int32), avoid_id=np.zeros(p, dtype=np.int32),
        host_id=np.zeros(p, dtype=np.int32), group_id=np.zeros(p, dtype=np.int32),
        img_id=np.zeros(p, dtype=np.int32),
        sa_self_id=np.zeros(p, dtype=np.int32))

    sel_i, tol_i, aff_i, avoid_i, host_i = (Interner() for _ in range(5))
    for j, pod in enumerate(pods):
        fill_pod_request_row(cols, j, pod, pod_requests[j], scalar_idx)
        cols.sel_id[j] = sel_i.intern(_selector_signature(pod), pod)
        cols.tol_id[j] = tol_i.intern(_toleration_signature(pod), pod)
        cols.aff_id[j] = aff_i.intern(_affinity_signature(pod), pod)
        cols.avoid_id[j] = avoid_i.intern(_avoid_signature(pod), pod)
        cols.host_id[j] = host_i.intern(_host_signature(pod), pod)

    node_index = {nd.name: i for i, nd in enumerate(nodes)}
    grp = _compile_groups(snapshot, pods, nodes, node_index,
                          need_saa=need_saa)
    cols.group_id = grp.tables.group_of_pod

    # --- static [signature, node] tables ---
    row_fns = signature_row_fns(nodes, node_infos)

    def table(interner: Interner, kind: str):
        fn, dtype = row_fns[kind]
        t = np.zeros((max(len(interner), 1), n), dtype=dtype)
        for sig_id, rep in enumerate(interner.representatives):
            for i in range(n):
                t[sig_id, i] = fn(rep, i)
        return t

    tables = SignatureTables(
        selector_ok=table(sel_i, "selector_ok"),
        taint_ok=table(tol_i, "taint_ok"),
        taint_ok_noexec=(table(tol_i, "taint_ok_noexec") if need_noexec else
                         np.ones((max(len(tol_i), 1), n), dtype=bool)),
        intolerable=table(tol_i, "intolerable"),
        affinity_count=table(aff_i, "affinity_count"),
        avoid_score=table(avoid_i, "avoid_score"),
        host_ok=table(host_i, "host_ok"),
    )

    # --- dynamic aggregates from pre-scheduled pods ---
    dyn = DynamicInit(
        used_cpu=np.zeros(n, dtype=np.int64), used_mem=np.zeros(n, dtype=np.int64),
        used_gpu=np.zeros(n, dtype=np.int64), used_eph=np.zeros(n, dtype=np.int64),
        used_scalar=np.zeros((n, s), dtype=np.int64),
        nonzero_cpu=np.zeros(n, dtype=np.int64), nonzero_mem=np.zeros(n, dtype=np.int64),
        pod_count=np.zeros(n, dtype=np.int64))
    for k, existing in enumerate(snapshot.pods):
        i = node_index.get(existing.spec.node_name)
        if i is None:
            continue
        req = existing_requests[k]
        dyn.used_cpu[i] += req.milli_cpu
        dyn.used_mem[i] += req.memory
        dyn.used_gpu[i] += req.nvidia_gpu
        dyn.used_eph[i] += req.ephemeral_storage
        for name, v in req.scalar.items():
            dyn.used_scalar[i, scalar_idx[name]] += v
        nz = get_nonzero_pod_request(existing)
        dyn.nonzero_cpu[i] += nz.milli_cpu
        dyn.nonzero_mem[i] += nz.memory
        dyn.pod_count[i] += 1

    compiled = CompiledCluster(
        statics=statics, tables=tables, groups=grp.tables, dynamic=dyn,
        scalar_names=scalar_names, node_index=node_index,
        has_ports=grp.has_ports, has_services=grp.has_services,
        has_interpod=grp.has_interpod,
        has_disk_conflict=grp.has_disk_conflict, has_maxpd=grp.has_maxpd,
        has_vol_zone=grp.has_vol_zone, has_noexec_table=need_noexec,
        has_saa_table=need_saa, maxpd_limits=grp.maxpd_limits,
        n_topo_doms=grp.n_topo_doms, n_zone_doms=grp.n_zone_doms,
        unsupported=grp.unsupported)
    return compiled, cols


def reason_strings(scalar_names: List[str]) -> List[str]:
    return REASON_STRINGS + [f"Insufficient {name}" for name in scalar_names]


def victim_order_columns(pods: List[Pod], node_index: Dict[str, int]):
    """The victim columns of device-side preemption: one row per placed pod
    of `pods` on a known node, in list order.

    Row order is what keeps victim selection exact: the host's
    sort_by_priority_desc over NodeInfo.pods is a stable sort, and
    NodeInfo.pods is in snapshot then bind order, so a table seeded in
    snapshot order and appended to on every bind gives the host's victim
    order under a stable sort by descending priority.

    Returns (node_i int32[R], prio int64[R], req int64[R, 4] of cpu, memory,
    gpu and ephemeral storage in get_resource_request units, the
    row-parallel list of pods)."""
    rows = [(node_index[p.spec.node_name], p) for p in pods
            if p.spec.node_name and p.spec.node_name in node_index]
    r = len(rows)
    node_i = np.zeros(r, dtype=np.int32)
    prio = np.zeros(r, dtype=np.int64)
    req = np.zeros((r, 4), dtype=np.int64)
    objs = []
    for k, (i, p) in enumerate(rows):
        node_i[k] = i
        prio[k] = get_pod_priority(p)
        pr = get_resource_request(p)
        req[k] = (pr.milli_cpu, pr.memory, pr.nvidia_gpu,
                  pr.ephemeral_storage)
        objs.append(p)
    return node_i, prio, req, objs
