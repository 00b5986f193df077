"""Columnar cluster state: SoA arrays + signature interning + static tables.

The host compile step of the port (numpy only). NodeInfo's cached aggregates
(schedulercache/node_info.go:35-76) become per-node column vectors; the
symbolic pod features become interned signature ids with precompiled
[signature, node] tables, so the device scan carries only numeric state.

Pod-group features (host ports, services, inter-pod affinity, volumes) are
detected but not compiled: the group-free kernel does not carry them, and
`fastplan.plan_fast` refuses such a workload with the feature's name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import (
    TAINT_PREFER_NO_SCHEDULE,
    Node,
    Pod,
    find_matching_untolerated_taint,
    tolerations_tolerate_taint,
)
from tpusim_torch.engine.predicates import pod_matches_node_labels
from tpusim_torch.engine.priorities import (
    calculate_node_affinity_priority_map,
    calculate_node_prefer_avoid_pods_priority_map,
)
from tpusim_torch.engine.resources import (
    NodeInfo,
    get_nonzero_pod_request,
    get_resource_request,
    is_pod_best_effort,
)

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
class CompiledCluster:
    statics: NodeStatics
    tables: SignatureTables
    dynamic: DynamicInit
    scalar_names: List[str]
    node_index: Dict[str, int]
    # pod-group features present in the batch or among the placed pods
    has_ports: bool = False
    has_services: bool = False
    has_interpod: bool = False
    has_volumes: bool = False


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


def _has_host_ports(pod: Pod) -> bool:
    return any(p.host_port > 0 for c in pod.spec.containers for p in c.ports)


def _has_interpod_terms(pod: Pod) -> bool:
    a = pod.spec.affinity
    return a is not None and (a.pod_affinity is not None
                              or a.pod_anti_affinity is not None)


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

    def intolerable_fn(rep: Pod, i: int) -> int:
        tols = [t for t in rep.spec.tolerations
                if not t.effect or t.effect == TAINT_PREFER_NO_SCHEDULE]
        return sum(1 for taint in node_infos[i].taints
                   if taint.effect == TAINT_PREFER_NO_SCHEDULE
                   and not tolerations_tolerate_taint(tols, taint))

    def affinity_fn(rep: Pod, i: int) -> int:
        return calculate_node_affinity_priority_map(rep, nodes[i])

    def avoid_fn(rep: Pod, i: int) -> int:
        return calculate_node_prefer_avoid_pods_priority_map(rep, nodes[i])

    def host_fn(rep: Pod, i: int) -> bool:
        return (not rep.spec.node_name) or rep.spec.node_name == nodes[i].name

    return {
        "selector_ok": (selector_fn, bool),
        "taint_ok": (taint_ok_fn, bool),
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


def compile_cluster(snapshot: ClusterSnapshot, pods: List[Pod]
                    ) -> Tuple[CompiledCluster, PodColumns]:
    """Build columnar state for `pods` scheduled against `snapshot`."""
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
        host_id=np.zeros(p, dtype=np.int32))

    sel_i, tol_i, aff_i, avoid_i, host_i = (Interner() for _ in range(5))
    for j, pod in enumerate(pods):
        fill_pod_request_row(cols, j, pod, pod_requests[j], scalar_idx)
        cols.sel_id[j] = sel_i.intern(_selector_signature(pod), pod)
        cols.tol_id[j] = tol_i.intern(_toleration_signature(pod), pod)
        cols.aff_id[j] = aff_i.intern(_affinity_signature(pod), pod)
        cols.avoid_id[j] = avoid_i.intern(_avoid_signature(pod), pod)
        cols.host_id[j] = host_i.intern(_host_signature(pod), pod)

    node_index = {nd.name: i for i, nd in enumerate(nodes)}

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

    # the group features are judged over the batch and the placed pods, as
    # the reference's group compile does
    placed = [p for p in snapshot.pods if p.spec.node_name in node_index]
    both = list(pods) + placed
    compiled = CompiledCluster(
        statics=statics, tables=tables, dynamic=dyn, scalar_names=scalar_names,
        node_index=node_index,
        has_ports=any(_has_host_ports(p) for p in both),
        has_services=bool(snapshot.services),
        has_interpod=any(_has_interpod_terms(p) for p in both),
        has_volumes=any(p.spec.volumes for p in both))
    return compiled, cols


def reason_strings(scalar_names: List[str]) -> List[str]:
    return REASON_STRINGS + [f"Insufficient {name}" for name in scalar_names]
