"""The incremental cluster: watch events folded into compiled columns.

`IncrementalCluster` owns a mutable picture of the cluster (nodes, placed
pods, services, volumes) and the column caches compile_cluster builds from
it, and exposes what the preemption hybrid (preempt.py) calls:

  apply(event_type, pod)   one ADDED/MODIFIED/DELETED event for a Pod
  compile(pods)            (CompiledCluster, PodColumns) for a new-pod batch
  refresh_dynamic(c)       only the dynamic aggregates and group presence of
                           an earlier compile, after placed-pod churn
  to_snapshot()            the equivalent ClusterSnapshot

What is incremental, against a fresh state.compile_cluster:
  * a placed pod's add, update or delete scatters into the dynamic
    aggregates and the group presence: no recompilation;
  * signature-table rows ([signature, node] cells) are memoized across
    batches (the reference's equivalence cache, core/equivalence_cache.go,
    keyed by table and signature instead of node, predicate and pod hash);
  * the pod-group tables (ports, services, volumes, inter-pod terms) are
    rebuilt lazily, only when the group structure changes (a new signature,
    a pod with volumes).

Node, Service and volume events, the delta journal and the NoExecute and
ServiceAffinity tables of the streaming runtime are not carried: nothing on
the hybrid's path sends or reads them.

Equivalence contract: after any event sequence, compile(pods) equals a
fresh compile_cluster of to_snapshot() with the same pods.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    Service,
)
from tpusim_torch.engine.resources import (
    NodeInfo,
    get_nonzero_pod_request,
    get_resource_request,
)
from tpusim_torch.framework.store import ADDED, DELETED, MODIFIED
from tpusim_torch.state import (
    CompiledCluster,
    DynamicInit,
    NodeStatics,
    PodColumns,
    SignatureTables,
    _affinity_signature,
    _avoid_signature,
    _compile_groups,
    _freeze,
    _group_signature,
    _has_interpod_terms,
    _host_signature,
    _sanitized_ports,
    _selector_signature,
    _toleration_signature,
    fill_pod_request_row,
    node_static_row,
    signature_row_fns,
)

_SIG_KINDS = (
    # (pod-column name, signature fn, table kinds fed by that signature)
    ("sel_id", _selector_signature, ("selector_ok",)),
    ("tol_id", _toleration_signature,
     ("taint_ok", "taint_ok_noexec", "intolerable")),
    ("aff_id", _affinity_signature, ("affinity_count",)),
    ("avoid_id", _avoid_signature, ("avoid_score",)),
    ("host_id", _host_signature, ("host_ok",)),
)

# The canonical signature key: it MUST be the interner's own key function,
# because group ids are looked up in tables keyed by compile_cluster's
# interners
_key = _freeze

# signature-row memo bound (the reference's equivalence cache is a 100-entry
# per-node LRU, equivalence_cache.go:33-47; rows here are N wide, so one
# global LRU bound keeps memory proportional to live signature diversity)
MAX_SIG_ROWS = 8192

_STATIC_FIELDS = ("alloc_cpu", "alloc_mem", "alloc_gpu", "alloc_eph",
                  "allowed_pods", "cond_fail_bits", "mem_pressure",
                  "disk_pressure")
_DYN_FIELDS = ("used_cpu", "used_mem", "used_gpu", "used_eph", "nonzero_cpu",
               "nonzero_mem", "pod_count")


def _needs_groups(pod: Pod) -> bool:
    return bool(_sanitized_ports(pod)) or _has_interpod_terms(pod)


def _copy_dynamic(dyn: DynamicInit) -> DynamicInit:
    return DynamicInit(**{name: getattr(dyn, name).copy()
                          for name in _DYN_FIELDS + ("used_scalar",)})


class IncrementalCluster:
    def __init__(self, snapshot: Optional[ClusterSnapshot] = None):
        snapshot = snapshot or ClusterSnapshot()
        self.nodes: List[Node] = list(snapshot.nodes)
        self.services: List[Service] = list(snapshot.services)
        # volume tables are part of the group tables and rebuild from
        # to_snapshot() when dirty, so the objects are all this needs
        self.pvs: Dict[str, PersistentVolume] = {pv.name: pv
                                                 for pv in snapshot.pvs}
        self.pvcs: Dict[str, PersistentVolumeClaim] = {pvc.key(): pvc
                                                       for pvc in snapshot.pvcs}
        self._pods: Dict[str, Pod] = {p.key(): p for p in snapshot.pods}

        self._node_index: Dict[str, int] = {}
        self._node_infos: List[NodeInfo] = []
        self._scalar_names: List[str] = []
        self._scalar_idx: Dict[str, int] = {}

        # memoized [signature, node] rows: (table kind, sig key) -> row [N]
        self._sig_rows: Dict[tuple, np.ndarray] = {}
        self._sig_reps: Dict[tuple, Pod] = {}     # sig key -> representative

        # node statics and dynamic aggregates, maintained column-wise
        self._statics: Optional[NodeStatics] = None
        self._dyn: Optional[DynamicInit] = None

        # the group tables' cache
        self._groups = None                       # state._GroupCompile
        self._groups_batch_keys: Optional[tuple] = None
        self._groups_dirty = True
        self._groups_active = False               # any group feature on
        self._presence: Optional[np.ndarray] = None

        self._rebuild_nodes()
        for pod in self._pods.values():
            self._note_pod_scalars(pod)
            self._apply_dynamic(pod, +1)

    # -- snapshot view ------------------------------------------------------

    def to_snapshot(self) -> ClusterSnapshot:
        """The equivalent point-in-time ClusterSnapshot (shared objects)."""
        return ClusterSnapshot(nodes=list(self.nodes),
                               pods=list(self._pods.values()),
                               services=list(self.services),
                               pvs=list(self.pvs.values()),
                               pvcs=list(self.pvcs.values()))

    # -- node-side caches ---------------------------------------------------

    def _rebuild_nodes(self) -> None:
        self._node_index = {nd.name: i for i, nd in enumerate(self.nodes)}
        self._node_infos = [self._make_node_info(node) for node in self.nodes]
        self._row_fns = signature_row_fns(self.nodes, self._node_infos)

    @staticmethod
    def _make_node_info(node: Node) -> NodeInfo:
        ni = NodeInfo()
        ni.set_node(node)
        return ni

    def _note_scalar(self, name: str) -> None:
        if name in self._scalar_idx:
            return
        self._scalar_idx[name] = len(self._scalar_names)
        self._scalar_names.append(name)
        n = len(self.nodes)
        if self._statics is not None:
            self._statics.alloc_scalar = np.concatenate(
                [self._statics.alloc_scalar, np.zeros((n, 1), np.int64)],
                axis=1)
        if self._dyn is not None:
            self._dyn.used_scalar = np.concatenate(
                [self._dyn.used_scalar, np.zeros((n, 1), np.int64)], axis=1)

    def _note_pod_scalars(self, pod: Pod) -> None:
        for name in get_resource_request(pod).scalar:
            self._note_scalar(name)

    def _note_node_scalars(self, ni: NodeInfo) -> None:
        for name in ni.allocatable_resource.scalar:
            self._note_scalar(name)

    def _statics_row(self, i: int):
        return node_static_row(self.nodes[i], self._node_infos[i],
                               self._scalar_idx, len(self._scalar_names))

    def _ensure_statics(self) -> NodeStatics:
        if self._statics is None:
            n = len(self.nodes)
            for i in range(n):
                self._note_node_scalars(self._node_infos[i])
            st = NodeStatics(
                names=[nd.name for nd in self.nodes],
                alloc_cpu=np.zeros(n, np.int64), alloc_mem=np.zeros(n, np.int64),
                alloc_gpu=np.zeros(n, np.int64), alloc_eph=np.zeros(n, np.int64),
                allowed_pods=np.zeros(n, np.int64),
                alloc_scalar=np.zeros((n, len(self._scalar_names)), np.int64),
                cond_fail_bits=np.zeros(n, np.int64),
                mem_pressure=np.zeros(n, bool), disk_pressure=np.zeros(n, bool))
            for i in range(n):
                self._set_statics_row(st, i, self._statics_row(i))
            self._statics = st
        return self._statics

    @staticmethod
    def _set_statics_row(st: NodeStatics, i: int, row) -> None:
        (st.alloc_cpu[i], st.alloc_mem[i], st.alloc_gpu[i], st.alloc_eph[i],
         st.allowed_pods[i]) = row[0], row[1], row[2], row[3], row[4]
        st.alloc_scalar[i, :len(row[5])] = row[5]
        st.cond_fail_bits[i], st.mem_pressure[i], st.disk_pressure[i] = \
            row[6], row[7], row[8]

    def _ensure_dyn(self) -> DynamicInit:
        if self._dyn is None:
            n = len(self.nodes)
            self._dyn = DynamicInit(
                **{name: np.zeros(n, np.int64) for name in _DYN_FIELDS},
                used_scalar=np.zeros((n, len(self._scalar_names)), np.int64))
        return self._dyn

    # -- pod-side scatter ---------------------------------------------------

    def _apply_dynamic(self, pod: Pod, sign: int) -> None:
        """Add (+1) or remove (-1) a placed pod's aggregate contributions:
        the NodeInfo.AddPod/RemovePod accounting (node_info.go:318-398) as a
        column scatter."""
        i = self._node_index.get(pod.spec.node_name)
        if i is None:
            return
        self._note_pod_scalars(pod)
        dyn = self._ensure_dyn()
        req = get_resource_request(pod)
        nz = get_nonzero_pod_request(pod)
        dyn.used_cpu[i] += sign * req.milli_cpu
        dyn.used_mem[i] += sign * req.memory
        dyn.used_gpu[i] += sign * req.nvidia_gpu
        dyn.used_eph[i] += sign * req.ephemeral_storage
        for name, v in req.scalar.items():
            dyn.used_scalar[i, self._scalar_idx[name]] += sign * v
        dyn.nonzero_cpu[i] += sign * nz.milli_cpu
        dyn.nonzero_mem[i] += sign * nz.memory
        dyn.pod_count[i] += sign

        # group presence: a known signature scatters, an unknown one rebuilds
        if self._groups_active and not self._groups_dirty \
                and self._presence is not None:
            gid = self._groups.sig_to_gid.get(_key(_group_signature(pod)))
            if gid is None:
                self._groups_dirty = True
            else:
                self._presence[gid, i] += sign
        elif not self._groups_active and _needs_groups(pod):
            # a ports or affinity pod arriving in a feature-free cluster
            self._groups_dirty = True

    # -- event application --------------------------------------------------

    def apply(self, event_type: str, pod: Pod) -> None:
        """One Pod event: a bind (ADDED, or MODIFIED with the node set) or a
        deletion."""
        if not isinstance(pod, Pod):
            raise TypeError(f"unsupported event object: {type(pod).__name__}")
        key = pod.key()
        old = self._pods.get(key)
        if event_type == DELETED:
            if old is not None:
                self._apply_dynamic(old, -1)
                del self._pods[key]
        elif event_type in (ADDED, MODIFIED):
            if old is not None:
                self._apply_dynamic(old, -1)
            self._pods[key] = pod
            self._apply_dynamic(pod, +1)
        else:
            raise ValueError(f"unknown event type {event_type!r}")
        for p in (old, pod if event_type != DELETED else None):
            # a pod parked on an unknown node name still counts for "a
            # matching pod exists" (aff_unplaced); a placed pod's volumes
            # feed used_vols_init, which only a rebuild refreshes
            if p is not None and ((p.spec.node_name
                                   and p.spec.node_name not in self._node_index)
                                  or p.spec.volumes):
                self._groups_dirty = True

    # -- batch compilation --------------------------------------------------

    def _sig_table(self, kind: str, interned_keys: List) -> np.ndarray:
        """The memoized rows of a batch's interned signatures, stacked;
        only rows never seen before are computed."""
        fn, dtype = self._row_fns[kind]
        n = len(self.nodes)
        rows = []
        for sig_key in interned_keys:
            cache_key = (kind, sig_key)
            row = self._sig_rows.pop(cache_key, None)
            if row is None:
                rep = self._sig_reps[sig_key]
                row = np.fromiter((fn(rep, i) for i in range(n)),
                                  dtype=dtype, count=n)
            # re-insert (move to the end), so eviction is least recently
            # used, as the upstream equivalence cache
            self._sig_rows[cache_key] = row
            rows.append(row)
        if not rows:
            return np.zeros((1, n), dtype=dtype)
        return np.stack(rows)

    def _evict_sig_rows(self) -> None:
        """Bound the signature-row memo (least recently used first) and drop
        representatives no cached row references anymore."""
        if len(self._sig_rows) <= MAX_SIG_ROWS:
            return
        overflow = len(self._sig_rows) - MAX_SIG_ROWS
        for cache_key in list(self._sig_rows)[:overflow]:
            del self._sig_rows[cache_key]
        live = {sig for (_, sig) in self._sig_rows}
        self._sig_reps = {k: v for k, v in self._sig_reps.items() if k in live}

    def _batch_columns(self, pods: List[Pod]
                       ) -> Tuple[PodColumns, Dict[str, List]]:
        """A batch's request columns and its signature interning over the
        memoized rows: (cols, interned key list per kind); group_id is left
        zero for the caller."""
        for pod in pods:
            self._note_pod_scalars(pod)
        s, p = len(self._scalar_names), len(pods)
        i32 = {name: np.zeros(p, np.int32)
               for name in ("sel_id", "tol_id", "aff_id", "avoid_id",
                            "host_id", "group_id", "img_id", "sa_self_id")}
        cols = PodColumns(
            req_cpu=np.zeros(p, np.int64), req_mem=np.zeros(p, np.int64),
            req_gpu=np.zeros(p, np.int64), req_eph=np.zeros(p, np.int64),
            req_scalar=np.zeros((p, s), np.int64),
            nz_cpu=np.zeros(p, np.int64), nz_mem=np.zeros(p, np.int64),
            zero_request=np.zeros(p, bool), best_effort=np.zeros(p, bool),
            **i32)
        batch_keys: Dict[str, Dict] = {name: {} for name, _, _ in _SIG_KINDS}
        key_lists: Dict[str, List] = {name: [] for name, _, _ in _SIG_KINDS}
        for j, pod in enumerate(pods):
            fill_pod_request_row(cols, j, pod, get_resource_request(pod),
                                 self._scalar_idx)
            for name, sig_fn, _kinds in _SIG_KINDS:
                # family-prefixed: two families' signatures can freeze to
                # the same key (both None), and one pod must not become the
                # representative of both
                sig_key = (name, _key(sig_fn(pod)))
                ids = batch_keys[name]
                if sig_key not in ids:
                    ids[sig_key] = len(ids)
                    key_lists[name].append(sig_key)
                    self._sig_reps.setdefault(sig_key, pod)
                getattr(cols, name)[j] = ids[sig_key]
        return cols, key_lists

    @staticmethod
    def batch_group_keys(pods: List[Pod]) -> tuple:
        """The batch's deduped canonical group-signature keys: compile()
        reuses the cached group tables when they match."""
        return tuple(dict.fromkeys(_key(_group_signature(pod)) for pod in pods))

    def compile(self, pods: List[Pod]
                ) -> Tuple[CompiledCluster, PodColumns]:
        """Compile a new-pod batch against the current picture, as
        state.compile_cluster does without the NoExecute and ServiceAffinity
        tables; the arrays are copies (later events do not change them)."""
        cols, key_lists = self._batch_columns(pods)
        statics = self._ensure_statics()
        dyn = self._ensure_dyn()

        tables = SignatureTables(
            selector_ok=self._sig_table("selector_ok", key_lists["sel_id"]),
            taint_ok=self._sig_table("taint_ok", key_lists["tol_id"]),
            taint_ok_noexec=np.ones(
                (max(len(key_lists["tol_id"]), 1), len(self.nodes)),
                dtype=bool),
            intolerable=self._sig_table("intolerable", key_lists["tol_id"]),
            affinity_count=self._sig_table("affinity_count",
                                           key_lists["aff_id"]),
            avoid_score=self._sig_table("avoid_score", key_lists["avoid_id"]),
            host_ok=self._sig_table("host_ok", key_lists["host_id"]),
        )
        self._evict_sig_rows()

        # the group tables: rebuilt only on a structural change
        group_keys = self.batch_group_keys(pods)
        if (self._groups_dirty or self._groups is None
                or group_keys != self._groups_batch_keys):
            grp = _compile_groups(self.to_snapshot(), pods, self.nodes,
                                  self._node_index, need_saa=False)
            self._groups = grp
            self._groups_batch_keys = group_keys
            # volume-only workloads still need real group ids (disk_sig and
            # vol_mask are indexed by group)
            self._groups_active = (grp.has_ports or grp.has_services
                                   or grp.has_interpod
                                   or grp.has_disk_conflict or grp.has_maxpd
                                   or grp.has_vol_zone)
            self._presence = grp.tables.presence
            self._groups_dirty = False
        grp = self._groups
        if self._groups_active and not grp.unsupported:
            group_id = np.fromiter(
                (grp.sig_to_gid[_key(_group_signature(pod))] for pod in pods),
                dtype=np.int32, count=len(pods))
        else:
            group_id = np.zeros(len(pods), np.int32)  # trivial tables
        cols.group_id = group_id
        groups_out = replace(grp.tables, presence=self._presence.copy(),
                             group_of_pod=group_id)
        statics_out = NodeStatics(
            names=list(statics.names),
            **{name: getattr(statics, name).copy()
               for name in _STATIC_FIELDS + ("alloc_scalar",)})
        compiled = CompiledCluster(
            statics=statics_out, tables=tables, groups=groups_out,
            dynamic=_copy_dynamic(dyn), scalar_names=list(self._scalar_names),
            node_index=dict(self._node_index),
            has_ports=grp.has_ports, has_services=grp.has_services,
            has_interpod=grp.has_interpod, has_noexec_table=False,
            has_saa_table=False,
            has_disk_conflict=grp.has_disk_conflict, has_maxpd=grp.has_maxpd,
            has_vol_zone=grp.has_vol_zone, maxpd_limits=grp.maxpd_limits,
            n_topo_doms=grp.n_topo_doms, n_zone_doms=grp.n_zone_doms,
            unsupported=list(grp.unsupported))
        return compiled, cols

    def refresh_dynamic(self, compiled: CompiledCluster
                        ) -> Optional[CompiledCluster]:
        """`compiled` with only its dynamic aggregates and group presence
        taken anew, after placed-pod churn fed through apply() (binds as
        ADDED, victims as DELETED): the preemption hybrid's re-arm, a few
        array copies where compile() is O(remaining pods).

        Valid only while no structural rebuild is pending: group tables
        clean, node set and scalar universe unchanged since `compiled`.
        Returns None where a full compile() is required."""
        if (self._groups_dirty or self._statics is None or self._dyn is None
                or self._groups is None or self._presence is None
                or len(self.nodes) != len(compiled.statics.names)
                or len(self._scalar_names) != len(compiled.scalar_names)):
            return None
        return replace(compiled, dynamic=_copy_dynamic(self._dyn),
                       groups=replace(compiled.groups,
                                      presence=self._presence.copy()))
