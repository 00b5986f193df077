"""The incremental cluster: watch events folded into compiled columns.

`IncrementalCluster` owns a mutable picture of the cluster (nodes, placed
pods, services, volumes) and the column caches compile_cluster builds from
it, and exposes:

  apply(event_type, obj)   one ADDED/MODIFIED/DELETED event for a Pod, Node,
                           Service, PersistentVolume or PersistentVolumeClaim
  apply_events(events)     a sequence of (event_type, obj)
  compile(pods)            (CompiledCluster, PodColumns) for a new-pod batch
  refresh_dynamic(c)       only the dynamic aggregates and group presence of
                           an earlier compile, after placed-pod churn (the
                           preemption hybrid, preempt.py)
  schedule(pods)           compile and run TorchBackend
  to_snapshot()            the equivalent ClusterSnapshot

and, for the streaming twin (stream.runtime), the delta journal: the node
rows and presence cells touched since the last drain (drain_journal, with
journal_mark / journal_rollback / journal_release brackets) and the nodes
whose labels or taints alone changed (drain_column_journal).

What is incremental, against a fresh state.compile_cluster:
  * a placed pod's add, update or delete scatters into the dynamic
    aggregates and the group presence: no recompilation;
  * signature-table rows ([signature, node] cells) are memoized across
    batches (the reference's equivalence cache, core/equivalence_cache.go,
    keyed by table and signature instead of node, predicate and pod hash);
    a node event patches one column of each;
  * a node add, update or delete patches the static columns;
  * the pod-group tables (ports, services, volumes, inter-pod terms) are
    rebuilt lazily, only when the group structure changes (a new signature,
    a pod with volumes, a node, Service or volume event).

Equivalence contract: after any event sequence, compile(pods) equals a
fresh compile_cluster of to_snapshot() with the same pods.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Iterable, List, Optional, Set, Tuple

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
        # node name -> keys of the pods claiming it (placed or parked), so a
        # node event touches only its own pods
        self._pods_on_node: Dict[str, Set[str]] = {}
        for key, pod in self._pods.items():
            if pod.spec.node_name:
                self._pods_on_node.setdefault(pod.spec.node_name,
                                              set()).add(key)

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
        self._groups_need_saa = False             # ServiceAffinity defs in
        self._presence: Optional[np.ndarray] = None

        # the delta journal: node rows and presence cells _apply_dynamic
        # touched since the last drain. The streaming twin scatters them
        # onto its resident carry, so a cycle's device update is O(touched).
        # Meaningful only while the structure holds: a node, scalar or group
        # change restages, which drops the journal.
        self._journal_nodes: Set[int] = set()
        self._journal_presence: Set[Tuple[int, int]] = set()
        self._journal_mark_active = False         # marks are exclusive
        # nodes whose labels or taints alone changed: with no group feature
        # on, the structural caches stay valid and only per-(signature,
        # node) and per-(policy row, node) static cells move, which the
        # streaming twin scatters instead of restaging
        self._journal_node_columns: Set[int] = set()
        # signature-row memo evictions so far: a residency miss after one
        # may be memo pressure ("sig_evict"), not a new signature
        self.sig_evictions = 0
        # the last _batch_columns interning (per-kind key lists): a restage
        # records it as the resident row order
        self.last_batch_key_lists: Optional[Dict[str, List]] = None
        # committed-delta hook (stream.persist): called as
        # on_event(event_type, obj) AFTER each apply() dispatches, so a WAL
        # sees every delta exactly when it commits, whichever way it arrived
        # (apply, apply_events, ingest, a Reflector)
        self.on_event = None

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
        # the row functions hold self.nodes and self._node_infos as list
        # objects; node events patch those lists in place, so they stay
        # current without a rebuild
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
        self._journal_nodes.add(i)

        # group presence: a known signature scatters, an unknown one rebuilds
        if self._groups_active and not self._groups_dirty \
                and self._presence is not None:
            gid = self._groups.sig_to_gid.get(_key(_group_signature(pod)))
            if gid is None:
                self._groups_dirty = True
            else:
                self._presence[gid, i] += sign
                self._journal_presence.add((gid, i))
        elif not self._groups_active and _needs_groups(pod):
            # a ports or affinity pod arriving in a feature-free cluster
            self._groups_dirty = True

    # -- event application --------------------------------------------------

    def apply(self, event_type: str, obj) -> None:
        """One watch event: ADDED, MODIFIED or DELETED of a Pod, Node,
        Service, PersistentVolume or PersistentVolumeClaim."""
        if isinstance(obj, Pod):
            self._apply_pod(event_type, obj)
        elif isinstance(obj, Node):
            self._apply_node(event_type, obj)
        elif isinstance(obj, Service):
            self._apply_service(event_type, obj)
        elif isinstance(obj, PersistentVolume):
            self._apply_pv(event_type, obj)
        elif isinstance(obj, PersistentVolumeClaim):
            self._apply_pvc(event_type, obj)
        else:
            raise TypeError(f"unsupported event object: {type(obj).__name__}")
        if self.on_event is not None:
            self.on_event(event_type, obj)

    def apply_events(self, events: Iterable[Tuple[str, object]]) -> None:
        for event_type, obj in events:
            self.apply(event_type, obj)

    def ingest(self, watch_buffer) -> int:
        """Drain a framework.events.WatchBuffer (non-blocking); returns the
        number of events applied. A torn stream raises WatchExpiredError
        after the frames before the tear are applied."""
        count = 0
        for ev in watch_buffer:
            self.apply(ev.type, ev.object)
            count += 1
        return count

    def _apply_pod(self, event_type: str, pod: Pod) -> None:
        """A bind (ADDED, or MODIFIED with the node set), an update or a
        deletion."""
        key = pod.key()
        old = self._pods.get(key)
        if old is not None and old.spec.node_name:
            self._pods_on_node.get(old.spec.node_name, set()).discard(key)
        if event_type == DELETED:
            if old is not None:
                self._apply_dynamic(old, -1)
                del self._pods[key]
        elif event_type in (ADDED, MODIFIED):
            if old is not None:
                self._apply_dynamic(old, -1)
            self._pods[key] = pod
            if pod.spec.node_name:
                self._pods_on_node.setdefault(pod.spec.node_name,
                                              set()).add(key)
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

    def _apply_node(self, event_type: str, node: Node) -> None:
        i = self._node_index.get(node.name)
        if (event_type in (ADDED, MODIFIED) and i is not None
                and not self._groups_active
                and self._column_only_change(self.nodes[i], node)):
            # labels or taints alone: _update_node patches the statics, the
            # aggregates and the memoized signature rows in place; with no
            # group feature on, the cached (trivial) group tables never read
            # node labels, so the structural caches stay valid. With a group
            # feature on, topology and zone domains may read these labels:
            # the rebuild below.
            self._update_node(i, node)
            self._journal_node_columns.add(i)
            return
        self._groups_dirty = True  # topology and zone domains follow nodes
        if event_type == ADDED and i is None:
            self._append_node(node)
        elif event_type in (ADDED, MODIFIED) and i is not None:
            self._update_node(i, node)
        elif event_type == MODIFIED and i is None:
            self._append_node(node)
        elif event_type == DELETED:
            if i is not None:
                self._delete_node(i)
        else:
            raise ValueError(f"unknown event type {event_type!r}")

    @staticmethod
    def _column_only_change(old: Node, node: Node) -> bool:
        """True when the event changes metadata.labels and spec.taints and
        nothing else, the empty change (a resync) included. Compared on the
        to_obj() wire form, the canonical form Node.copy() goes through."""
        a, b = old.to_obj(), node.to_obj()
        a["metadata"].pop("labels", None)
        b["metadata"].pop("labels", None)
        a["spec"].pop("taints", None)
        b["spec"].pop("taints", None)
        return a == b

    def _apply_service(self, event_type: str, svc: Service) -> None:
        self._groups_dirty = True
        self.services = [s for s in self.services
                         if (s.namespace, s.name) != (svc.namespace, svc.name)]
        if event_type in (ADDED, MODIFIED):
            self.services.append(svc)

    def _apply_pv(self, event_type: str, pv: PersistentVolume) -> None:
        # MaxPD volume ids and the zone tables read PV objects: any PV event
        # invalidates them (factory.go wires its PV handlers to the
        # equivalence cache's invalidation, factory.go:139-299)
        self._groups_dirty = True
        if event_type == DELETED:
            self.pvs.pop(pv.name, None)
        elif event_type in (ADDED, MODIFIED):
            self.pvs[pv.name] = pv
        else:
            raise ValueError(f"unknown event type {event_type!r}")

    def _apply_pvc(self, event_type: str, pvc: PersistentVolumeClaim) -> None:
        self._groups_dirty = True
        if event_type == DELETED:
            self.pvcs.pop(pvc.key(), None)
        elif event_type in (ADDED, MODIFIED):
            self.pvcs[pvc.key()] = pvc
        else:
            raise ValueError(f"unknown event type {event_type!r}")

    # -- node column patches ------------------------------------------------

    def _append_node(self, node: Node) -> None:
        self._ensure_statics()
        self._ensure_dyn()

        def grow(arr):
            return np.concatenate([arr, np.zeros(1, arr.dtype)])

        # grow the node axis first (while the widths still agree), then
        # register the node, then note its scalars (which widens the scalar
        # axis over arrays already consistent)
        st, dyn = self._statics, self._dyn
        st.names.append(node.name)
        for name in _STATIC_FIELDS:
            setattr(st, name, grow(getattr(st, name)))
        st.alloc_scalar = np.concatenate(
            [st.alloc_scalar, np.zeros((1, st.alloc_scalar.shape[1]),
                                       np.int64)], axis=0)
        for name in _DYN_FIELDS:
            setattr(dyn, name, grow(getattr(dyn, name)))
        dyn.used_scalar = np.concatenate(
            [dyn.used_scalar, np.zeros((1, dyn.used_scalar.shape[1]),
                                       np.int64)], axis=0)

        # list patches in place keep the row functions current
        self.nodes.append(node)
        i = len(self.nodes) - 1
        self._node_infos.append(self._make_node_info(node))
        self._node_index[node.name] = i
        self._note_node_scalars(self._node_infos[i])
        self._set_statics_row(st, i, self._statics_row(i))

        # every memoized signature row gains one computed cell
        for (kind, sig_key), row_arr in list(self._sig_rows.items()):
            fn, dtype = self._row_fns[kind]
            cell = np.asarray([fn(self._sig_reps[sig_key], i)], dtype=dtype)
            self._sig_rows[(kind, sig_key)] = np.concatenate([row_arr, cell])

        # pods parked on this node name materialize their aggregates
        for key in self._pods_on_node.get(node.name, ()):
            self._apply_dynamic(self._pods[key], +1)

    def _update_node(self, i: int, node: Node) -> None:
        # remove the aggregates computed against the old column, patch,
        # re-add (allocatable may widen the scalar axis; conditions move
        # the condition bits)
        affected = [self._pods[k]
                    for k in self._pods_on_node.get(node.name, ())]
        for pod in affected:
            self._apply_dynamic(pod, -1)
        self.nodes[i] = node
        self._node_infos[i] = self._make_node_info(node)
        self._note_node_scalars(self._node_infos[i])
        self._ensure_statics()
        self._set_statics_row(self._statics, i, self._statics_row(i))
        for (kind, sig_key), row_arr in self._sig_rows.items():
            fn, _ = self._row_fns[kind]
            row_arr[i] = fn(self._sig_reps[sig_key], i)
        for pod in affected:
            self._apply_dynamic(pod, +1)

    def _delete_node(self, i: int) -> None:
        self._ensure_statics()
        self._ensure_dyn()
        del self.nodes[i]
        del self._node_infos[i]
        self._node_index = {nd.name: j for j, nd in enumerate(self.nodes)}
        st, dyn = self._statics, self._dyn
        del st.names[i]
        for name in _STATIC_FIELDS:
            setattr(st, name, np.delete(getattr(st, name), i))
        st.alloc_scalar = np.delete(st.alloc_scalar, i, axis=0)
        for name in _DYN_FIELDS:
            setattr(dyn, name, np.delete(getattr(dyn, name), i))
        dyn.used_scalar = np.delete(dyn.used_scalar, i, axis=0)
        for key_pair, row_arr in list(self._sig_rows.items()):
            self._sig_rows[key_pair] = np.delete(row_arr, i)

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
        self.sig_evictions += overflow
        for cache_key in list(self._sig_rows)[:overflow]:
            del self._sig_rows[cache_key]
        live = {sig for (_, sig) in self._sig_rows}
        self._sig_reps = {k: v for k, v in self._sig_reps.items() if k in live}

    def _batch_columns(self, pods: List[Pod]
                       ) -> Tuple[PodColumns, Dict[str, List]]:
        """A batch's request columns and its signature interning over the
        memoized rows: (cols, interned key list per kind); group_id is left
        zero for the caller. The streaming twin calls it alone, without the
        O(nodes) table stacking of compile()."""
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
        self.last_batch_key_lists = key_lists
        return cols, key_lists

    @staticmethod
    def batch_group_keys(pods: List[Pod]) -> tuple:
        """The batch's deduped canonical group-signature keys: compile()
        reuses the cached group tables when they match."""
        return tuple(dict.fromkeys(_key(_group_signature(pod)) for pod in pods))

    def assign_group_ids(self, cols: PodColumns, pods: List[Pod]) -> bool:
        """Fill cols.group_id from the cached signature -> merged group map.
        False when the cached group tables are dirty or miss a signature of
        the batch: then a compile() is required."""
        if self._groups_dirty or self._groups is None:
            return False
        if self._groups_active and not self._groups.unsupported:
            try:
                cols.group_id[:] = np.fromiter(
                    (self._groups.sig_to_gid[_key(_group_signature(pod))]
                     for pod in pods), dtype=np.int32, count=len(pods))
            except KeyError:
                return False
        # else: trivial tables, group_id stays all zero
        return True

    def drain_journal(self) -> Tuple[Set[int], Set[Tuple[int, int]]]:
        """Hand over (touched node indices, touched presence cells) since
        the last drain and reset both, and the column journal with them.
        Meaningless after a structural event (node indices may have
        shifted): callers restage there instead."""
        nodes, cells = self._journal_nodes, self._journal_presence
        self._journal_nodes, self._journal_presence = set(), set()
        self._journal_node_columns = set()
        return nodes, cells

    def journal_mark(self) -> Tuple[Set[int], Set[Tuple[int, int]]]:
        """Snapshot the pod-delta journal, for journal_rollback (the
        streaming twin's pipelined fold-back and overlay queries, whose
        applies the resident carry already holds) or journal_release (a
        gang's commit, whose applies stay journaled). Marks are exclusive: a
        second mark before the first is resolved raises, as a nested
        rollback would lose the outer bracket's entries."""
        if self._journal_mark_active:
            raise RuntimeError(
                "journal_mark is exclusive: an unresolved mark is active "
                "(rollback or release it first)")
        self._journal_mark_active = True
        return set(self._journal_nodes), set(self._journal_presence)

    def journal_rollback(self, mark) -> None:
        """Discard the journal entries added since journal_mark."""
        self._journal_nodes, self._journal_presence = mark
        self._journal_mark_active = False

    def journal_release(self) -> None:
        """Resolve an active journal_mark and keep the entries added since
        it."""
        self._journal_mark_active = False

    def drain_column_journal(self) -> Set[int]:
        """Hand over the nodes whose labels or taints alone changed since
        the last drain, and reset. Meaningful only while the node set is
        unchanged, as drain_journal."""
        cols = self._journal_node_columns
        self._journal_node_columns = set()
        return cols

    def compile(self, pods: List[Pod], need_noexec: bool = False,
                need_saa: bool = False
                ) -> Tuple[CompiledCluster, PodColumns]:
        """Compile a new-pod batch against the current picture, as
        state.compile_cluster does; the arrays are copies (later events do
        not change them). need_noexec: compute the NoExecute taint table a
        policy's PodToleratesNodeNoExecuteTaints reads (else an all-pass
        dummy); need_saa: intern the first-matching-service signatures a
        policy's ServiceAffinity and ServiceAntiAffinity read."""
        cols, key_lists = self._batch_columns(pods)
        statics = self._ensure_statics()
        dyn = self._ensure_dyn()

        tables = SignatureTables(
            selector_ok=self._sig_table("selector_ok", key_lists["sel_id"]),
            taint_ok=self._sig_table("taint_ok", key_lists["tol_id"]),
            taint_ok_noexec=(
                self._sig_table("taint_ok_noexec", key_lists["tol_id"])
                if need_noexec else
                np.ones((max(len(key_lists["tol_id"]), 1), len(self.nodes)),
                        dtype=bool)),
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
                or group_keys != self._groups_batch_keys
                or need_saa != self._groups_need_saa):
            grp = _compile_groups(self.to_snapshot(), pods, self.nodes,
                                  self._node_index, need_saa=need_saa)
            self._groups = grp
            self._groups_batch_keys = group_keys
            self._groups_need_saa = need_saa
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
            has_interpod=grp.has_interpod, has_noexec_table=need_noexec,
            has_saa_table=need_saa,
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

    # -- scheduling ---------------------------------------------------------

    def schedule(self, pods: List[Pod], provider: str = "DefaultProvider",
                 fallback: str = "reference",
                 hard_pod_affinity_symmetric_weight: int = 10,
                 device="cuda"):
        """Compile the batch against the current picture and run
        TorchBackend on `device`; the placements are NOT folded back (feed
        the binds through apply() to make them stick, as the simulator's
        Bind -> store.Update loop does)."""
        from tpusim_torch.backend import TorchBackend

        backend = TorchBackend(
            provider=provider, fallback=fallback, device=device,
            hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight)
        return backend.schedule(pods, self.to_snapshot(),
                                precompiled=self.compile(pods))
