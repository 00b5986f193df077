"""Preemption on the torch backend: a host-device hybrid.

Reference: the Preempt pipeline (core/generic_scheduler.go:205-1000) driven
from scheduleOne's error arm (scheduler.go:449-455). The split is the JAX
package's:

  device  the scan (the fused CUDA kernel, or the exact scan where the int32
          plan refuses) places every pod that fits; a pod that fails leaves
          the carry untouched and does not advance the round-robin counter,
          so the decisions after a failed pod stay valid;
  host    when a pod fails with PodPriority on, victim selection picks a
          node and victims: on the device (scan.preempt_select) for the
          arithmetic reprieve class, else the exact engine pipeline
          (GenericScheduler.preempt) against a host mirror of the cluster
          (simulator.ClusterCapacity, fed through its Bind and Update seams).

A preemption deletes victims, which invalidates the device's decisions for
every later pod, so the scan restarts at the failed pod. Two things keep
restarts cheap:

  1. Speculation chunks. The batch is compiled and staged on the device
     once; the scan runs chunks of TPUSIM_PREEMPT_CHUNK0 (128) pods,
     doubling up to TPUSIM_PREEMPT_CHUNK_MAX (8192) while no preemption
     happens and starting again at CHUNK0 after one, with the carry chained
     on the device from one chunk to the next. A preemption wastes at most
     the rest of one chunk.
  2. Re-arm from the incremental cluster. Binds stream into an
     IncrementalCluster as ADDED events and victims as DELETED events; after
     a preemption the carry is rebuilt from refresh_dynamic (a few array
     copies) and the compiled statics, tables and pod columns are reused.
     Only structural churn (a bind or victim with volumes dirties the group
     tables), or a refreshed value the kernel's int32 plan cannot hold,
     recompiles the remaining feed.

A cheap host gate skips the attempt when no placed pod has a lower priority
than the failed pod. Nothing here hides a fault of the card: a kernel error
raises, and so does any disagreement between the device's verdict and the
host's (a pod the scan found infeasible that fits on the host, a device
victim pick that contradicts the scan).
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from dataclasses import replace
from time import perf_counter
from typing import List, Optional

import numpy as np
import torch

from tpusim_torch import scan
from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod, PodCondition, ResourceType
from tpusim_torch.backend import (
    _MOST_REQUESTED_PROVIDERS,
    ROUTES,
    format_fit_error,
)
from tpusim_torch.config import config_for
from tpusim_torch.delta import IncrementalCluster
from tpusim_torch.device import resolve_device
from tpusim_torch.engine.generic_scheduler import (
    ERR_NO_NODES_AVAILABLE,
    FitError,
    SchedulingError,
)
from tpusim_torch.engine.providers import DEFAULT_PROVIDER
from tpusim_torch.engine.resources import get_resource_request, request_memo
from tpusim_torch.engine.util import get_pod_priority
from tpusim_torch.fastplan import init_carry, plan_fast, rearm_carry
from tpusim_torch.fastscan import DevicePlan, fast_scan
from tpusim_torch.framework.metrics import since_in_microseconds
from tpusim_torch.framework.report import Status
from tpusim_torch.framework.store import ADDED, DELETED
from tpusim_torch.obs import recorder as flight
from tpusim_torch.policyc import classify_preemption_class
from tpusim_torch.simulator import ClusterCapacity, SchedulerServerConfig
from tpusim_torch.state import reason_strings, victim_order_columns

log = logging.getLogger(__name__)

VICTIM_ARMS = ("auto", "host")

# Process-cumulative counts of how each preemption's victims were picked:
# "device" (scan.preempt_select, committed through commit_preemption) or
# "host" (GenericScheduler.preempt). Reset with reset_preempt_stats().
PREEMPT_CLASS_STATS: Counter = Counter()
# Process-cumulative counts of the hybrid's own events: "compiles" (the
# first compile of a run and every recompile), "recompiles", "rearms",
# "route_kernel" and "route_scan" (a compile's route), "fast_scan_calls" and
# "scan_calls" (speculation chunks run), "pods_scanned" (pods those chunks
# held, wasted speculation included), "host_orchestrator" (a run the first
# compile classified unsupported), "no_candidates" (a device victim
# attempt with no stripped-fit node, left to the host arm).
HYBRID_STATS: Counter = Counter()


def reset_preempt_stats() -> None:
    PREEMPT_CLASS_STATS.clear()
    HYBRID_STATS.clear()


def _note_victim_path(path: str) -> None:
    """One preemption's victim-selection path: the in-module Counter and
    the tpusim_backend_victim_path_total family with its recorder instant."""
    PREEMPT_CLASS_STATS[path] += 1
    flight.note_victim_path(path)


class _VictimTable:
    """A columnar mirror of every placed pod, kept beside the host cache so
    that victim selection can run on the device.

    Row order keeps it exact: rows are appended in placement-event order
    (the snapshot through state.victim_order_columns, then every bind), and
    a removal only clears the alive bit, so the alive rows of a node are
    NodeInfo.pods in order, and a stable sort by descending priority gives
    sort_by_priority_desc's victim order."""

    def __init__(self, compiled, placed_pods: List[Pod]):
        self._node_index = dict(compiled.node_index)
        n = len(compiled.statics.names)
        node_i, prio, req, objs = victim_order_columns(placed_pods,
                                                       self._node_index)
        self.size = len(objs)
        cap = max(256, 1 << self.size.bit_length())
        self.node_i = np.zeros(cap, np.int32)
        self.node_i[:self.size] = node_i
        self.prio = np.zeros(cap, np.int64)
        self.prio[:self.size] = prio
        self.req = np.zeros((cap, 4), np.int64)   # cpu, mem, gpu, eph
        self.req[:self.size] = req
        self.alive = np.zeros(cap, bool)
        self.alive[:self.size] = True
        self.objs: List = list(objs) + [None] * (cap - self.size)
        self._row = {p.key(): i for i, p in enumerate(objs)}
        # per-node totals over alive rows: NodeInfo's requested resources
        # and pod count
        self.tot = np.zeros((n, 4), np.int64)
        np.add.at(self.tot, node_i, req)
        self.tot_n = np.bincount(node_i, minlength=n).astype(np.int64)

    def _grow(self) -> None:
        cap = len(self.alive) * 2
        for name in ("node_i", "prio", "alive", "req"):
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], old.dtype)
            new[:self.size] = old[:self.size]
            setattr(self, name, new)
        self.objs.extend([None] * (cap - len(self.objs)))

    def add(self, pod: Pod) -> None:
        i = self._node_index.get(pod.spec.node_name)
        if i is None:
            return
        if self.size == len(self.alive):
            self._grow()
        r = self.size
        self.size = r + 1
        pr = get_resource_request(pod)
        self.node_i[r] = i
        self.prio[r] = get_pod_priority(pod)
        self.req[r] = (pr.milli_cpu, pr.memory, pr.nvidia_gpu,
                       pr.ephemeral_storage)
        self.alive[r] = True
        self.objs[r] = pod
        self._row[pod.key()] = r
        self.tot[i] += self.req[r]
        self.tot_n[i] += 1

    def remove(self, pod: Pod) -> None:
        r = self._row.pop(pod.key(), None)
        if r is None:
            return
        self.alive[r] = False
        self.objs[r] = None
        i = self.node_i[r]
        self.tot[i] -= self.req[r]
        self.tot_n[i] -= 1


def _stripped_fit(vtable: _VictimTable, st, pod: Pod):
    """podFitsOnNode's resource half on every node once each lower-priority
    pod is stripped from it (selectVictimsOnNode,
    core/generic_scheduler.go:583-665), over the victim table: the pod count
    and cpu, memory, gpu and ephemeral storage as PodFitsResources
    (predicates.go:706-776) checks them, with its all-zero-request early-out.
    Scalar resources are left out: an omitted check only admits more nodes,
    so a node that fails here is provably no preemption candidate.

    Returns (fit bool[N], zero_req, the lower-priority rows, n_base[N] and
    used_base[N, 4] (what stays on each node), want[4], alloc[N, 4])."""
    n_nodes = len(st.names)
    pp = get_pod_priority(pod)
    preq = get_resource_request(pod)
    zero_req = (preq.milli_cpu == 0 and preq.memory == 0
                and preq.nvidia_gpu == 0 and preq.ephemeral_storage == 0
                and not preq.scalar)
    size = vtable.size
    lower = vtable.alive[:size] & (vtable.prio[:size] < pp)
    vrows = np.nonzero(lower)[0]
    node_of = vtable.node_i[:size]
    lower_sum = np.zeros((n_nodes, 4), np.int64)
    np.add.at(lower_sum, node_of[vrows], vtable.req[:size][vrows])
    lower_n = np.bincount(node_of[vrows], minlength=n_nodes)
    n_base = vtable.tot_n - lower_n
    used_base = vtable.tot - lower_sum
    fit = n_base + 1 <= st.allowed_pods
    want = np.array([preq.milli_cpu, preq.memory, preq.nvidia_gpu,
                     preq.ephemeral_storage], np.int64)
    alloc = np.stack([st.alloc_cpu, st.alloc_mem, st.alloc_gpu,
                      st.alloc_eph], axis=1)
    if not zero_req:
        fit = fit & (used_base + want <= alloc).all(axis=1)
    return fit, zero_req, vrows, n_base, used_base, want, alloc


def _victim_lanes(vtable: _VictimTable, compiled, cols, row: int, pod: Pod):
    """The candidate lanes and victim slots of one failed pod, as numpy
    arrays in preempt_select's argument order after zero_req, with the
    lanes' node indices and the slots' victim-table rows: (zero_req, args,
    cand, v_row). args is None where no node passes the stripped fit.

    A lane is a node whose only failure can be its resources (in the
    arithmetic class every predicate is node-static or PodFitsResources,
    and a static failure is _UNRESOLVABLE while a resource failure is not)
    where the pod fits once every lower-priority pod is stripped. Raises
    RuntimeError where a lane has no victim to strip: the node fits as it
    is, which contradicts the scan that found the pod infeasible."""
    st, tb = compiled.statics, compiled.tables
    n_nodes = len(st.names)
    ok = ((st.cond_fail_bits == 0)
          & tb.host_ok[cols.host_id[row]]
          & tb.selector_ok[cols.sel_id[row]]
          & tb.taint_ok[cols.tol_id[row]]
          & ~st.disk_pressure)
    if cols.best_effort[row]:
        ok = ok & ~st.mem_pressure
    fit, zero_req, vrows, n_base, used_base, want, alloc = _stripped_fit(
        vtable, st, pod)
    fit = fit & ok
    size = vtable.size
    node_of = vtable.node_i[:size]
    cand = np.nonzero(fit)[0]
    if cand.size == 0:
        return zero_req, None, cand, None

    # victims on the candidate lanes, stable-sorted by descending priority
    # (row order within a priority is NodeInfo.pods order)
    rows = vrows[fit[node_of[vrows]]]
    lane_of_node = np.full(n_nodes, -1, np.int64)
    lane_of_node[cand] = np.arange(cand.size)
    counts = np.bincount(lane_of_node[node_of[rows]], minlength=cand.size)
    if int(counts.min()) == 0:
        raise RuntimeError(
            f"preemption of pod {pod.key()}: node "
            f"{st.names[int(cand[np.argmin(counts)])]} fits the pod without "
            "a victim, but the device scan found the pod infeasible")
    rows = rows[np.argsort(-vtable.prio[:size][rows], kind="stable")]
    lane = lane_of_node[node_of[rows]]
    g = np.argsort(lane, kind="stable")   # group by lane, keep prio order
    rows_g, lane_g = rows[g], lane[g]
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    pos_in = np.arange(rows_g.size) - starts[lane_g]
    shape = (cand.size, int(counts.max()))
    v_prio = np.zeros(shape, np.int64)
    v_req = np.zeros(shape + (4,), np.int64)
    v_valid = np.zeros(shape, bool)
    v_row = np.full(shape, -1, np.int64)
    v_prio[lane_g, pos_in] = vtable.prio[:size][rows_g]
    v_req[lane_g, pos_in] = vtable.req[:size][rows_g]
    v_valid[lane_g, pos_in] = True
    v_row[lane_g, pos_in] = rows_g
    base = used_base[cand] + want
    args = (np.ones(cand.size, bool), cand.astype(np.int64),
            *(alloc[cand, k] for k in range(4)), st.allowed_pods[cand],
            n_base[cand], *(base[:, k] for k in range(4)),
            v_prio, *(v_req[:, :, k] for k in range(4)), v_valid)
    return zero_req, args, cand, v_row


def _device_select_victims(vtable: _VictimTable, compiled, cols, row: int,
                           pod: Pod, device):
    """One failed pod through the device victim selection: the lanes and
    slots on the host (_victim_lanes), the reprieve and the pick on the
    device (scan.preempt_select). Returns (node index, victims in reprieve
    order), or None where no node passes the stripped fit (the host arm
    then writes the pod's FitError). Raises RuntimeError where the device's
    pick contradicts the scan."""
    zero_req, args, cand, v_row = _victim_lanes(vtable, compiled, cols, row,
                                                pod)
    if args is None:
        return None
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in args]
    winner, empty_winner, victim_mask, _num = scan.preempt_select(
        zero_req, *tensors)
    win, empty = int(winner), int(empty_winner)
    if empty < scan.PREEMPT_NONE or win >= scan.PREEMPT_NONE:
        raise RuntimeError(
            f"preemption of pod {pod.key()}: the device victim selection "
            + ("found a node that fits without a victim" if
               empty < scan.PREEMPT_NONE else "picked no node")
            + ", against the device scan that found the pod infeasible")
    lane = int(np.searchsorted(cand, win))
    mask = victim_mask[lane].cpu().numpy()
    slot_rows = v_row[lane][mask & (v_row[lane] >= 0)]
    return win, [vtable.objs[int(r)] for r in slot_rows]


def _victim_class(cc, config):
    """The victim-selection class of a compile: the key/flag
    classification, the live PDB gate and the scheduler's own reprieve
    chain (GenericScheduler.preemption_reprieve_class)."""
    cc.scheduler.reprieve_feature_hints = {
        "has_ports": config.has_ports,
        "has_disk_conflict": config.has_disk_conflict,
        "has_maxpd": config.has_maxpd,
        "has_interpod": config.has_interpod,
    }
    vclass, why = classify_preemption_class(
        frozenset(cc.scheduler.predicates),
        cc.scheduler.reprieve_feature_hints,
        has_extenders=bool(cc.scheduler.extenders))
    if vclass == "arithmetic" and cc.scheduler.pdb_lister():
        vclass, why = "general", "pod disruption budgets registered"
    if (vclass == "arithmetic"
            and cc.scheduler.preemption_reprieve_class() != "arithmetic"):
        vclass, why = ("general",
                       "reprieve chain kept a pod-set-dependent predicate")
    return vclass, why


def _mesh_carry(mesh, compiled, device):
    """A fresh carry of `compiled` on the mesh: its node axis padded to the
    shard multiple and cut to this rank's block (the post-preemption
    re-arm against statics placed before)."""
    from tpusim_torch.sharding import (
        _axis_size,
        node_shardings,
        pad_carry_node_axis,
        stage_tree,
    )

    _, ca_spec = node_shardings(mesh)
    carry = pad_carry_node_axis(scan.carry_init_host(compiled),
                                _axis_size(mesh, "node"))
    return stage_tree(carry, ca_spec, device)


def _mesh_stage(mesh, config, compiled, cols, device):
    """A compile's scan state on the mesh, once the ranks agree on its host
    picture: (statics and carry, this rank's padded node block; every
    pod's columns; the node-sharded scan)."""
    from tpusim_torch.backend import check_ranks_agree
    from tpusim_torch.sharding import shard_for_mesh

    host = (scan.statics_to_host(compiled), scan.carry_init_host(compiled),
            scan.pod_columns_to_host(cols))
    check_ranks_agree(mesh, device, *host, axes=tuple(mesh.mesh_dim_names),
                      route="preemption mesh")
    statics, carry, xs_all = shard_for_mesh(mesh, *host, device)
    fn = scan.sharded_scan_fn(replace(config, shard_axis="node"), mesh)
    return statics, carry, xs_all, fn


def run_with_preemption(pods: List[Pod], snapshot: ClusterSnapshot,
                        provider: str = DEFAULT_PROVIDER,
                        hard_pod_affinity_symmetric_weight: int = 10,
                        incremental: Optional[IncrementalCluster] = None,
                        device="cuda", route: str = "auto",
                        victims: str = "auto",
                        mesh: Optional[object] = None) -> Status:
    """Run `pods` (podspec order; the LIFO feed reversal happens here, as
    in the reference's store.go:223-233 queue) with PodPriority on, and
    return the final Status: the successful, failed and preempted pods and
    the stop reason of the host orchestrator's run, byte for byte.

    incremental: an IncrementalCluster already equivalent to `snapshot`
    (an event-log replay's fold), used in place of a fresh one.
    device: where the scan and the victim selection run ("cuda" launches
    the CUDA kernel, "cpu" runs the plain versions). route: "auto" (the
    kernel where plan_fast accepts a compile's plan, the exact scan
    otherwise), "kernel" (raise where plan_fast refuses) or "scan".
    victims: "auto" picks victims on the device wherever the class is
    arithmetic and the pod has no scalar requests and no volumes (the host
    pipeline elsewhere); "host" always runs the host pipeline, the
    reference the device arm is held against. A workload the first compile
    classifies unsupported runs on the host orchestrator, as the torch
    backend reroutes it (HYBRID_STATS["host_orchestrator"]).

    mesh: a ("snap", "node") DeviceMesh of ranks (sharding.make_mesh), every
    rank making this call with the same inputs: the speculation chunks run
    the node-sharded scan (scan.sharded_scan_fn) on this rank's block of
    the node axis, padded to the shard multiple, and each re-arm pads a
    fresh carry and keeps the block; the host arms see every node on every
    rank. Before the chunks of each compile the ranks check that they agree
    on the host picture. A mesh takes the scan route: route "kernel"
    raises ValueError."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r} (expected one of "
                         f"{', '.join(ROUTES)})")
    if victims not in VICTIM_ARMS:
        raise ValueError(f"unknown victims {victims!r} (expected one of "
                         f"{', '.join(VICTIM_ARMS)})")
    if mesh is not None:
        from tpusim_torch.sharding import check_mesh, shard_device

        if check_mesh(mesh, "preemption mesh") != "snap":
            raise ValueError(
                "the preemption hybrid shards the node axis: pass a "
                "('snap', 'node') mesh (sharding.make_mesh); got axes "
                f"{tuple(mesh.mesh_dim_names)!r}")
        if route == "kernel":
            raise ValueError(
                "route='kernel' cannot run on a preemption mesh: the fused "
                "kernel is one device's; a mesh takes the scan route "
                "(route 'auto' or 'scan')")
        device = shard_device(device)
    else:
        device = resolve_device(device)
    host_config = SchedulerServerConfig(
        algorithm_provider=provider,
        hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
        enable_pod_priority=True)

    # the host mirror: the orchestrator the host route runs, fed by hand
    # (binds through the Bind seam, failures through the Update seam,
    # preemption through attempt_preemption or commit_preemption)
    cc = ClusterCapacity(host_config, new_pods=[],
                         scheduled_pods=snapshot.pods, nodes=snapshot.nodes,
                         services=snapshot.services, pvs=snapshot.pvs,
                         pvcs=snapshot.pvcs,
                         storage_classes=snapshot.storage_classes)
    feed = list(reversed(pods))
    if not feed:
        cc.status.stop_reason = cc.STOP_REASONS["run"]
        cc.close()
        return cc.status
    if not snapshot.nodes:
        # generic_scheduler raises ERR_NO_NODES_AVAILABLE: the plain
        # SchedulingError arm, which never enters the preemption pipeline
        for pod in feed:
            cc.resource_store.add(ResourceType.PODS, pod)
            cc.update(pod, PodCondition(
                type="PodScheduled", status="False", reason="Unschedulable",
                message=str(ERR_NO_NODES_AVAILABLE)))
        cc.status.stop_reason = cc.STOP_REASONS["failed"]
        cc.close()
        return cc.status

    inc = incremental if incremental is not None else IncrementalCluster(snapshot)
    metrics = cc.metrics
    by_name = {n.name: n for n in cc.nodes}
    most_requested = provider in _MOST_REQUESTED_PROVIDERS
    # priority histogram of placed pods: the preemption-possible gate
    placed_priorities: Counter = Counter(
        get_pod_priority(p) for p in snapshot.pods if p.spec.node_name)
    attempts: dict = {}   # pod key -> preemption attempts (budget 1, as
    #                       _schedule_one's preempt_budget)
    # every placed pod's request joins plan_fast's gcds, the snapshot's and
    # each bind's (a superset is safe, so victims stay in the list)
    placed_for_gcd = [p for p in snapshot.pods if p.spec.node_name]
    last_outcome = "run"
    first_compile = True
    vtable = None
    rr_start = 0          # lastNodeIndex persists across the whole run
    #                       (generic_scheduler.go:97); restarts resume it
    pos = 0               # the next unprocessed pod of `feed`
    chunk0 = max(1, int(os.environ.get("TPUSIM_PREEMPT_CHUNK0", "128")))
    chunk_max = max(chunk0,
                    int(os.environ.get("TPUSIM_PREEMPT_CHUNK_MAX", "8192")))

    def placed(pod: Pod) -> None:
        """Fold a pod the Bind seam just placed into the hybrid's state."""
        nonlocal last_outcome
        stored, _ = cc.resource_store.get(ResourceType.PODS, pod.key())
        inc.apply(ADDED, stored)
        placed_for_gcd.append(stored)
        placed_priorities[get_pod_priority(stored)] += 1
        vtable.add(stored)
        last_outcome = "bound"

    # the stripped fit prunes only nodes the resource check rejects; a
    # predicate set without it keeps every candidate
    resource_pred = ("GeneralPredicates" in cc.scheduler.predicates
                     or "PodFitsResources" in cc.scheduler.predicates)

    def candidates(pod: Pod, compiled):
        """The host pipeline's candidate filter: the names of the nodes
        that pass the stripped fit, or None where every node does."""
        if not resource_pred:
            return None
        fit, *_ = _stripped_fit(vtable, compiled.statics, pod)
        if fit.all():
            return None
        names = compiled.statics.names
        return {names[i] for i in np.nonzero(fit)[0]}.__contains__

    def fail(pod: Pod, message: str) -> None:
        nonlocal last_outcome
        cc.update(pod, PodCondition(type="PodScheduled", status="False",
                                    reason="Unschedulable", message=message))
        last_outcome = "failed"

    # pod specs do not change during the run (only status and node_name),
    # so request computation is memoized for the whole loop
    with request_memo():
        while pos < len(feed):
            # (re)compile feed[pos:] against the current picture: once up
            # front, again only after structural churn
            compile_start = perf_counter()
            with flight.span("compile_cluster") as csp:
                compiled, cols = inc.compile(feed[pos:])
                if csp:
                    csp.set("pods", len(feed) - pos)
            metrics.backend_compile_latency.observe(
                since_in_microseconds(compile_start))
            HYBRID_STATS["compiles"] += 1
            HYBRID_STATS["recompiles"] += int(not first_compile)
            if compiled.unsupported:
                detail = "; ".join(sorted(set(compiled.unsupported))[:5])
                if not first_compile:
                    raise RuntimeError(
                        "torch preemption: the compile fell back after binds "
                        f"were made ({detail})")
                log.warning("torch backend (preemption) falling back to "
                            "reference for: %s", detail)
                HYBRID_STATS["host_orchestrator"] += 1
                ref = ClusterCapacity(
                    host_config, new_pods=pods, scheduled_pods=snapshot.pods,
                    nodes=snapshot.nodes, services=snapshot.services,
                    pvs=snapshot.pvs, pvcs=snapshot.pvcs,
                    storage_classes=snapshot.storage_classes)
                ref.run()
                return ref.status
            if first_compile:
                vtable = _VictimTable(compiled, snapshot.pods)
            first_compile = False

            config = config_for(compiled, most_requested=most_requested,
                                hard_weight=hard_pod_affinity_symmetric_weight)
            vclass, vclass_why = _victim_class(cc, config)
            device_victims = victims == "auto" and vclass == "arithmetic"
            strings = reason_strings(compiled.scalar_names)
            names = compiled.statics.names
            base = pos            # plan and column row i hold feed[base + i]

            # the route, decided once per compile as TorchBackend decides it
            fplan, why = None, "route='scan' asked for"
            if mesh is not None:
                why = "a mesh takes the scan route"
            elif route != "scan":
                fplan, why = plan_fast(config, compiled, cols,
                                       placed_pods=placed_for_gcd)
                if fplan is None and route == "kernel":
                    raise NotImplementedError(f"torch backend: {why}")
            if fplan is not None:
                HYBRID_STATS["route_kernel"] += 1
                staged = DevicePlan(fplan, device)
                fcarry = init_carry(fplan, rr=rr_start)
            else:
                HYBRID_STATS["route_scan"] += 1
                log.info("preemption on the scan route (%s); victims: %s%s",
                         why, vclass, f" ({vclass_why})" if vclass_why else "")
                if mesh is None:
                    statics = scan.statics_to(compiled, device)
                    xs_all = scan.pod_columns_to(cols, device)
                    carry = scan.carry_init(compiled, device)
                else:
                    statics, carry, xs_all, scan_fn = _mesh_stage(
                        mesh, config, compiled, cols, device)
                carry.rr.fill_(rr_start)
            engine = "kernel" if fplan is not None else "scan"
            flight.note_route(engine, len(feed) - pos)
            chunk = chunk0

            while pos < len(feed):
                take = min(chunk, len(feed) - pos)
                off = pos - base
                HYBRID_STATS["pods_scanned"] += take
                dispatch_start = perf_counter()
                dsp = flight.span("device_dispatch", "device", device)
                if fplan is not None:
                    HYBRID_STATS["fast_scan_calls"] += 1
                    with flight.profiled("tpusim:fast_scan"):
                        choices, counts, advanced, carry_out = fast_scan(
                            fplan, start=off, stop=off + take,
                            carry_in=fcarry, return_carry=True,
                            staged=staged)
                else:
                    HYBRID_STATS["scan_calls"] += 1
                    xs = scan.PodX(*(a[off:off + take] for a in xs_all))
                    with flight.profiled("tpusim:schedule_scan"):
                        if mesh is None:
                            carry_out, choices, counts, advanced = \
                                scan.schedule_scan(
                                    config, carry, statics, xs,
                                    graph_steps=scan.GRAPH_STEPS)
                        else:
                            carry_out, choices, counts, advanced = \
                                scan_fn(carry, statics, xs)
                        choices = choices.cpu().numpy()
                        counts = counts.cpu().numpy()
                        advanced = advanced.cpu().numpy()
                if dsp:
                    dsp.set("engine", engine)
                    dsp.set("chunk", chunk)
                    dsp.set("take", take)
                    dsp.end()
                metrics.backend_dispatch_latency.observe(
                    since_in_microseconds(dispatch_start))
                metrics.scheduling_algorithm_latency.observe(
                    since_in_microseconds(dispatch_start))

                mutated = False
                for j in range(take):
                    pod = feed[pos + j]
                    cc.resource_store.add(ResourceType.PODS, pod)  # nextPod
                    c = int(choices[j])
                    if c >= 0:
                        cc.bind(pod, names[c])
                        placed(pod)
                        continue

                    # a failure: the scan left the carry untouched, so later
                    # decisions stay valid unless a preemption changes state
                    pod_priority = get_pod_priority(pod)
                    if not (attempts.get(pod.key(), 0) < 1
                            and any(count > 0 and pri < pod_priority
                                    for pri, count
                                    in placed_priorities.items())):
                        fail(pod, format_fit_error(len(names), counts[j],
                                                   strings))
                        continue

                    rr_here = rr_start + int(np.sum(advanced[:j]))
                    picked = None
                    preq = get_resource_request(pod)
                    if (device_victims and not preq.scalar
                            and not pod.spec.volumes):
                        select_start = perf_counter()
                        picked = _device_select_victims(
                            vtable, compiled, cols, off + j, pod, device)
                        HYBRID_STATS["no_candidates"] += int(picked is None)
                    if picked is not None:
                        # commit the device's pick through the store, status
                        # and event sequence the host pipeline uses
                        win, chosen = picked
                        name = names[win]
                        metrics.preemption_attempts.inc()
                        to_clear = cc.scheduler._get_lower_priority_nominated_pods(
                            pod, name)
                        metrics.preemption_evaluation.observe(
                            since_in_microseconds(select_start))
                        _note_victim_path("device")
                        _node, chosen = cc.commit_preemption(
                            pod, by_name[name], chosen, to_clear)
                    else:
                        # the host arm: per-node failure reasons (the device
                        # ships only the histogram), then the exact Preempt
                        # pipeline, against the cache's snapshot
                        node_infos = cc.refresh_node_info_snapshot()
                        try:
                            filtered, failed = cc.scheduler.find_nodes_that_fit(
                                pod, cc.nodes, node_infos)
                        except SchedulingError as exc:
                            fail(pod, str(exc))
                            continue
                        if filtered:
                            raise RuntimeError(
                                f"preemption of pod {pod.key()}: the host "
                                f"finds {len(filtered)} feasible node(s) "
                                f"({filtered[0].name}, ...) where the device "
                                "scan found none")
                        fit_err = FitError(pod, len(cc.nodes), failed)
                        _note_victim_path("host")
                        node, chosen = cc.attempt_preemption(
                            pod, fit_err,
                            candidate_filter=candidates(pod, compiled))
                        if node is None:
                            fail(pod, fit_err.error())
                            continue
                    for victim in chosen:
                        inc.apply(DELETED, victim)
                        placed_priorities[get_pod_priority(victim)] -= 1
                        vtable.remove(victim)
                    attempts[pod.key()] = attempts.get(pod.key(), 0) + 1
                    # scheduleOne retries the nominated pod at once (the
                    # orchestrator's preempt_budget arm); every later
                    # decision was made against the state before it
                    pos += j
                    rr_start = rr_here
                    mutated = True
                    break

                if not mutated:
                    pos += take
                    if fplan is not None:
                        fcarry = carry_out
                    else:
                        carry = carry_out
                    rr_start += int(np.sum(advanced))
                    chunk = min(chunk * 2, chunk_max)
                    continue
                if pos >= len(feed):
                    break
                # the state changed: re-arm the carry from the incremental
                # picture, or leave for a full recompile of feed[pos:]
                refreshed = inc.refresh_dynamic(compiled)
                if refreshed is None:
                    break
                compiled = refreshed
                if fplan is not None:
                    fcarry = rearm_carry(fplan, compiled, rr_start)
                    if fcarry is None:
                        log.info("preemption: the refreshed state does not "
                                 "fit the plan's units; recompiling")
                        break
                elif mesh is None:
                    carry = scan.carry_init(compiled, device)
                    carry.rr.fill_(rr_start)
                else:
                    carry = _mesh_carry(mesh, compiled, device)
                    carry.rr.fill_(rr_start)
                HYBRID_STATS["rearms"] += 1
                chunk = chunk0

    cc.status.stop_reason = cc.STOP_REASONS[last_outcome]
    cc.close()
    return cc.status
