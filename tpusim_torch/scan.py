"""The exact sequential scan on PyTorch tensors: one step per pod, pod t's
bind seen by pod t+1, the same filter -> score -> select -> bind pipeline
as the fused kernel, held in int64 (and integer-valued float64 counts) so it
carries every plan the kernel's int32 plan refuses.

Reference mapping:
  findNodesThatFit (generic_scheduler.go:289-377)  -> staged fail masks + reason bits
  PrioritizeNodes  (generic_scheduler.go:542-680)  -> vectorized scores + masked normalize
  selectHost       (generic_scheduler.go:183-198)  -> masked argmax + round-robin tie pick
  assume/bind      (scheduler.go:431-497)          -> scatter-add into the carry

Every tensor lives on the device the caller names. A step never reads a
tensor value on the host and never copies one from it (no .item(), no
branch on a tensor, no boolean mask indexing, no tensor built from a Python
value), so on a GPU the whole batch queues without a stall, its outputs
come back in one copy, and blocks of steps can be captured as CUDA graphs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpusim_torch.config import EngineConfig, policy_weights
from tpusim_torch.engine.predicates import (
    CHECK_NODE_DISK_PRESSURE_PRED,
    CHECK_NODE_LABEL_PRESENCE_PRED,
    CHECK_NODE_MEMORY_PRESSURE_PRED,
    CHECK_NODE_UNSCHEDULABLE_PRED,
    CHECK_SERVICE_AFFINITY_PRED,
    CHECK_VOLUME_BINDING_PRED,
    GENERAL_PRED,
    HOSTNAME_PRED,
    MATCH_INTERPOD_AFFINITY_PRED,
    MATCH_NODE_SELECTOR_PRED,
    MAX_AZURE_DISK_VOLUME_COUNT_PRED,
    MAX_EBS_VOLUME_COUNT_PRED,
    MAX_GCE_PD_VOLUME_COUNT_PRED,
    NO_DISK_CONFLICT_PRED,
    NO_VOLUME_ZONE_CONFLICT_PRED,
    POD_FITS_HOST_PORTS_PRED,
    POD_FITS_RESOURCES_PRED,
    POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
    POD_TOLERATES_NODE_TAINTS_PRED,
)
from tpusim_torch.state import (
    BIT_AFFINITY_NOT_MATCH,
    BIT_AFFINITY_RULES,
    BIT_ANTI_AFFINITY_RULES,
    BIT_DISK_CONFLICT,
    BIT_DISK_PRESSURE,
    BIT_EXISTING_ANTI_AFFINITY,
    BIT_HOST_PORTS,
    BIT_HOSTNAME_MISMATCH,
    BIT_INSUFFICIENT_CPU,
    BIT_INSUFFICIENT_EPHEMERAL,
    BIT_INSUFFICIENT_GPU,
    BIT_INSUFFICIENT_MEMORY,
    BIT_INSUFFICIENT_PODS,
    BIT_MAX_VOLUME_COUNT,
    BIT_MEMORY_PRESSURE,
    BIT_NODE_LABEL_PRESENCE,
    BIT_NODE_SELECTOR_MISMATCH,
    BIT_NODE_UNSCHEDULABLE,
    BIT_SERVICE_AFFINITY,
    BIT_TAINTS_NOT_TOLERATED,
    BIT_VOLUME_ZONE_CONFLICT,
    NUM_FIXED_BITS,
    CompiledCluster,
    PodColumns,
)

MAX_PRIORITY = 10
I64 = torch.int64
# steps a CUDA graph on the card: the step is a few hundred small kernels,
# launched from Python in ~9 ms a pod and replayed from a graph in under 1
# ms; small blocks keep the capture (one eager pass) short
GRAPH_STEPS = 8


class Carry(NamedTuple):
    used_cpu: torch.Tensor      # [N] int64
    used_mem: torch.Tensor
    used_gpu: torch.Tensor
    used_eph: torch.Tensor
    used_scalar: torch.Tensor   # [N, S]
    nonzero_cpu: torch.Tensor
    nonzero_mem: torch.Tensor
    pod_count: torch.Tensor
    presence: torch.Tensor      # [G, N] int32: pods per (group, node)
    presence_dom: torch.Tensor  # [G, K, D] int32: presence summed per domain
    used_vols: torch.Tensor     # [N, V] bool: MaxPD volume ids mounted per node
    # ServiceAffinity (policy): per first-service signature, the node index
    # of the first matching pod once it binds; -1 not yet locked, -2 never
    sa_lock: torch.Tensor       # [Fd] int32
    rr: torch.Tensor            # 0-d int64: selectHost's lastNodeIndex


class Statics(NamedTuple):
    """The cluster's static columns and tables; every integer id column is
    widened to int64 so it can index."""

    alloc_cpu: torch.Tensor
    alloc_mem: torch.Tensor
    alloc_gpu: torch.Tensor
    alloc_eph: torch.Tensor
    allowed_pods: torch.Tensor
    alloc_scalar: torch.Tensor
    cond_fail_bits: torch.Tensor
    mem_pressure: torch.Tensor
    disk_pressure: torch.Tensor
    selector_ok: torch.Tensor
    taint_ok: torch.Tensor
    taint_ok_noexec: torch.Tensor
    intolerable: torch.Tensor
    affinity_count: torch.Tensor
    avoid_score: torch.Tensor
    host_ok: torch.Tensor
    # pod-group tables (state.GroupTables)
    port_conflict: torch.Tensor
    port_sig: torch.Tensor
    disk_conflict: torch.Tensor
    disk_sig: torch.Tensor
    vol_mask: torch.Tensor
    vol_type: torch.Tensor
    zone_ok: torch.Tensor
    ss_rows: torch.Tensor
    ss_sig: torch.Tensor
    saa_rows: torch.Tensor
    saa_sig: torch.Tensor
    term_match: torch.Tensor
    zone_dom: torch.Tensor
    topo_dom: torch.Tensor
    aff_valid: torch.Tensor
    aff_err: torch.Tensor
    aff_empty: torch.Tensor
    aff_term: torch.Tensor
    aff_key: torch.Tensor
    aff_hostname: torch.Tensor
    aff_self: torch.Tensor
    aff_unplaced: torch.Tensor
    anti_valid: torch.Tensor
    anti_err: torch.Tensor
    anti_empty: torch.Tensor
    anti_term: torch.Tensor
    anti_key: torch.Tensor
    anti_hostname: torch.Tensor
    pref_w: torch.Tensor
    pref_term: torch.Tensor
    pref_key: torch.Tensor
    # a policy's rows (policyc.PolicyTables; trivial without a policy):
    # label-presence pass masks [L, N], the NodeLabel priority row [N],
    # ImageLocality scores [Si, N], ServiceAntiAffinity label domains
    # [E, N], ServiceAffinity node values [La, N] and pod pins [Cs, La]
    label_ok: torch.Tensor
    label_prio: torch.Tensor
    image_score: torch.Tensor
    saa_dom: torch.Tensor
    sa_val: torch.Tensor
    sa_pin: torch.Tensor


class PodX(NamedTuple):
    """The pods' columns, [P] (req_scalar [P, S]); ids widened to int64."""

    req_cpu: torch.Tensor
    req_mem: torch.Tensor
    req_gpu: torch.Tensor
    req_eph: torch.Tensor
    req_scalar: torch.Tensor
    nz_cpu: torch.Tensor
    nz_mem: torch.Tensor
    zero_request: torch.Tensor
    best_effort: torch.Tensor
    sel_id: torch.Tensor
    tol_id: torch.Tensor
    aff_id: torch.Tensor
    avoid_id: torch.Tensor
    host_id: torch.Tensor
    group_id: torch.Tensor
    img_id: torch.Tensor
    sa_self_id: torch.Tensor


def _upload(a, device, index: bool = False) -> torch.Tensor:
    """A fresh copy of numpy array `a` on `device`; `index` widens int32 to
    int64."""
    t = torch.tensor(np.asarray(a), device=device)
    if index and t.dtype == torch.int32:
        t = t.to(I64)
    return t


def statics_to(compiled: CompiledCluster, device, ptabs=None) -> Statics:
    """Statics of `compiled` on `device`, with a policy's rows from `ptabs`
    (policyc.PolicyTables) when given."""
    s, t, gt = compiled.statics, compiled.tables, compiled.groups
    n = len(s.alloc_cpu)
    if ptabs is None:
        rows = dict(label_ok=np.ones((1, n), dtype=bool),
                    label_prio=np.zeros(n, dtype=np.int64),
                    image_score=np.zeros((1, n), dtype=np.int64),
                    saa_dom=np.zeros((1, n), dtype=np.int32),
                    sa_val=np.zeros((1, n), dtype=np.int32),
                    sa_pin=np.zeros((1, 1), dtype=np.int32))
    else:
        rows = {name: getattr(ptabs, name) for name in (
            "label_ok", "label_prio", "image_score", "saa_dom", "sa_val",
            "sa_pin")}
    host = dict(
        alloc_cpu=s.alloc_cpu, alloc_mem=s.alloc_mem, alloc_gpu=s.alloc_gpu,
        alloc_eph=s.alloc_eph, allowed_pods=s.allowed_pods,
        alloc_scalar=s.alloc_scalar, cond_fail_bits=s.cond_fail_bits,
        mem_pressure=s.mem_pressure, disk_pressure=s.disk_pressure,
        selector_ok=t.selector_ok, taint_ok=t.taint_ok,
        taint_ok_noexec=t.taint_ok_noexec, intolerable=t.intolerable,
        affinity_count=t.affinity_count, avoid_score=t.avoid_score,
        host_ok=t.host_ok, **rows)
    host.update({name: getattr(gt, name) for name in Statics._fields
                 if name not in host})
    return Statics(**{name: _upload(host[name], device, index=True)
                      for name in Statics._fields})


def _presence_dom_init(presence: np.ndarray, topo_dom: np.ndarray,
                       n_doms: int) -> np.ndarray:
    """presence_dom[g, k, d] = sum of presence[g, n] over nodes in domain d."""
    g = presence.shape[0]
    k = topo_dom.shape[0]
    pd = np.zeros((g, k, n_doms), dtype=np.int32)
    for ki in range(k):
        np.add.at(pd[:, ki, :], (slice(None), topo_dom[ki]), presence)
    return pd


def carry_init(compiled: CompiledCluster, device,
               sa_lock_init: Optional[np.ndarray] = None) -> Carry:
    """The initial carry of `compiled` on `device`; a policy's
    ServiceAffinity locks from `sa_lock_init` when given."""
    d, gt = compiled.dynamic, compiled.groups
    if sa_lock_init is None:
        sa_lock_init = np.full(gt.saa_rows.shape[0], -1, dtype=np.int32)
    host = dict(
        used_cpu=d.used_cpu, used_mem=d.used_mem, used_gpu=d.used_gpu,
        used_eph=d.used_eph, used_scalar=d.used_scalar,
        nonzero_cpu=d.nonzero_cpu, nonzero_mem=d.nonzero_mem,
        pod_count=d.pod_count, presence=gt.presence,
        presence_dom=_presence_dom_init(gt.presence, gt.topo_dom,
                                        compiled.n_topo_doms),
        used_vols=gt.used_vols_init, sa_lock=sa_lock_init,
        rr=np.int64(0))
    return Carry(**{name: _upload(host[name], device)
                    for name in Carry._fields})


def pod_columns_to(cols: PodColumns, device) -> PodX:
    return PodX(**{name: _upload(getattr(cols, name), device, index=True)
                   for name in PodX._fields})


def scan_inputs(config: EngineConfig, compiled: CompiledCluster,
                cols: PodColumns, ptabs, device):
    """(carry, statics, xs) on `device`: under a policy its rows grafted
    onto the statics and, with ServiceAffinity, its initial locks onto the
    carry (the same tables plan_fast bakes into the kernel's plan)."""
    ps = config.policy
    sa_lock_init = (ptabs.sa_lock_init if ps is not None and ps.sa_enabled
                    else None)
    return (carry_init(compiled, device, sa_lock_init),
            statics_to(compiled, device, ptabs),
            pod_columns_to(cols, device))


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _ratio_score(requested, capacity, most: bool):
    """least_requested.go:41-52 / most_requested.go:44-55, elementwise."""
    valid = (capacity > 0) & (requested <= capacity)
    num = requested if most else capacity - requested
    return torch.where(valid, _fdiv(num * MAX_PRIORITY, capacity.clamp(min=1)),
                       0)


# --- exact 128-bit arithmetic on 16-bit limbs held in int64 ----------------
# Score arithmetic must be exact, not float64: products like req_cpu *
# alloc_mem overflow int64 on large-memory nodes. Torch has no general
# uint64 arithmetic and the product of two 32-bit limbs overflows int64, so
# a value is split into 16-bit limbs: a limb product is < 2^32 and a column
# of four such products < 2^34, so a product's columns need no carry until
# the final sign test, and every linear combination of a few products stays
# far inside int64.

_LIMB_BITS = 16
_LIMB_MASK = (1 << _LIMB_BITS) - 1
_NUM_LIMBS = 4                   # a nonnegative int64 is < 2^63
_NUM_COLS = 2 * _NUM_LIMBS - 1   # columns of a limb product


def _limbs(a):
    """[...] nonnegative int64 -> [4, ...] 16-bit limbs, least significant
    first."""
    shifts = torch.arange(0, _NUM_LIMBS * _LIMB_BITS, _LIMB_BITS,
                          device=a.device).view(-1, *([1] * a.dim()))
    return (a.unsqueeze(0) >> shifts) & _LIMB_MASK


def _mul_limbs(a, b):
    """The exact product a * b of nonnegative int64 tensors as [7, ...]
    column sums (least significant first, uncarried): sum_k col[k] 2^(16k)
    = a * b, each column < 2^34."""
    la, lb = _limbs(a), _limbs(b)
    prod = la.unsqueeze(1) * lb.unsqueeze(0)            # [4, 4, ...]
    # column i + j of limb product (i, j), built on the device: a tensor
    # made from a Python list would be a host copy that waits for the card
    limb = torch.arange(_NUM_LIMBS, device=a.device)
    col = (limb[:, None] + limb[None, :]).reshape(-1)
    out = torch.zeros((_NUM_COLS,) + a.shape, dtype=I64, device=a.device)
    return out.index_add_(0, col, prod.reshape((-1,) + a.shape))


def _nonneg_limbs(cols):
    """sum_k cols[:, k] 2^(16k) >= 0 for signed uncarried columns [R, C,
    ...]: carry from the least significant column up; the value is c 2^(16C)
    plus a remainder in [0, 2^(16C)), so its sign is the last carry's."""
    c = torch.zeros_like(cols[:, 0])
    for k in range(cols.shape[1]):
        c = (cols[:, k] + c) >> _LIMB_BITS
    return c >= 0


def _balanced_score(req_cpu, req_mem, alloc_cpu, alloc_mem):
    """balanced_resource_allocation.go:39-63 in exact rational arithmetic.

    score = #{t in 0..9 : t * den >= 10 * num}, num = |rc*am - rm*ac|, den =
    ac*am: the quantity Go computes as int64((1-|cpuFrac-memFrac|)*10) in
    float64, evaluated exactly. t * den >= 10 * |d| holds when both t * den
    - 10 d and t * den + 10 d are nonnegative, so all twenty tests are one
    linear combination of the three products' columns and one carry pass."""
    p = _mul_limbs(torch.stack([req_cpu, req_mem, alloc_cpu]),
                   torch.stack([alloc_mem, alloc_cpu, alloc_mem]))
    d10 = MAX_PRIORITY * (p[:, 0] - p[:, 1])                # [7, N]
    t = torch.arange(MAX_PRIORITY, device=req_cpu.device).view(-1, 1, 1)
    tden = t * p[:, 2].unsqueeze(0)                         # [10, 7, N]
    ok = _nonneg_limbs(torch.cat([tden - d10, tden + d10]))  # [20, N]
    score = (ok[:MAX_PRIORITY] & ok[MAX_PRIORITY:]).sum(0)
    zero = ((alloc_cpu == 0) | (req_cpu >= alloc_cpu)
            | (alloc_mem == 0) | (req_mem >= alloc_mem))
    return torch.where(zero, 0, score)


def _seg_rows(values, doms, num_segments: int):
    """Row-wise segment sums: [T, N] values x [T, N] domain ids -> [T, D]."""
    out = torch.zeros((values.shape[0], num_segments), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(1, doms, values)


def _seg(values, doms, num_segments: int):
    """Segment sums of [N] values over [N] domain ids -> [D]."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.scatter_add_(0, doms, values)


def _row(table, i1):
    """table[i] for a one-element index tensor i1 (no host read)."""
    return table.index_select(0, i1)[0]


class _Const:
    """Per-run constants of the step: bit positions and one-hot key tables
    that depend only on the statics."""

    def __init__(self, config: EngineConfig, st: Statics):
        dev = st.alloc_cpu.device
        n_scal = st.alloc_scalar.shape[-1]
        self.num_bits = NUM_FIXED_BITS + n_scal
        self.bit_ids = torch.arange(self.num_bits, dtype=I64, device=dev)
        self.scalar_shifts = NUM_FIXED_BITS + torch.arange(
            n_scal, dtype=I64, device=dev)
        self.no_counts = torch.zeros(self.num_bits, dtype=torch.int32,
                                     device=dev)
        if config.has_maxpd:
            self.vol_type = st.vol_type.to(torch.float64)
        if config.has_interpod:
            k = st.topo_dom.shape[0]
            self.keys = torch.arange(k, device=dev)
            self.key_oh = torch.nn.functional.one_hot(
                st.anti_key, k).to(torch.float64)
            self.key_oh_p = torch.nn.functional.one_hot(
                st.pref_key, k).to(torch.float64)
            self.key_oh_a = torch.nn.functional.one_hot(
                st.aff_key, k).to(torch.float64)


def _evaluate(config: EngineConfig, carry: Carry, st: Statics, x: PodX,
              g1, const: _Const):
    """Filter + score one pod against the carried aggregates: (feasible[N],
    reason_bits[N], score[N], n_feasible, aca_counts).

    x holds one pod's columns (0-d tensors); g1 is its group id as a
    one-element index. With config.policy set, stages and components are
    gated to the policy's predicate set and weights (factory.go
    CreateFromConfig); stages always follow PREDICATES_ORDERING, so the
    first failing stage gives the host engine's reason."""
    ps = config.policy
    en = ps.pred_keys if ps is not None else None

    def on(name):
        # None = the provider's default predicate set (the full pipeline)
        return en is None or name in en

    def one(i):
        return i.reshape(1)

    # ---- filter: staged fail masks in predicatesOrdering ----
    # CheckNodeCondition is mandatory; the condition bits already carry
    # spec.unschedulable and fail first with the same reason
    fail_cond = st.cond_fail_bits != 0
    stages = [(fail_cond, st.cond_fail_bits)]
    if (ps is not None and ps.always_check_all and en is not None
            and CHECK_NODE_UNSCHEDULABLE_PRED in en):
        # with always-check-all a registered CheckNodeUnschedulable reports
        # the unschedulable reason a second time (the host runs both)
        unsched = (st.cond_fail_bits & (1 << BIT_NODE_UNSCHEDULABLE)) != 0
        stages.append((unsched, 1 << BIT_NODE_UNSCHEDULABLE))

    # policy label-presence predicates evaluate at the ordering slot of the
    # name they were registered under; "tail:<k>" after the fixed ordering
    label_at: dict = {}
    if ps is not None:
        for i, slot in enumerate(ps.label_rows):
            label_at.setdefault(slot, []).append(i)

    if ps is not None and ps.sa_slots:
        # ServiceAffinity (predicates.py check_service_affinity): the node
        # must match the labels the pod pins by its own nodeSelector and,
        # for the other entry labels, the values on the locked first
        # service pod's node (when a lock exists and that node carries the
        # label)
        sa_lock = carry.sa_lock.index_select(
            0, one(_row(st.saa_sig, g1)))[0]
        sa_li = sa_lock.clamp(min=0).to(I64)
        sa_pin = _row(st.sa_pin, one(x.sa_self_id))                # [La]
        sa_unres = sa_pin == 0
        sa_own_l = sa_unres[:, None] | (st.sa_val == sa_pin[:, None])
        sa_locked = st.sa_val.index_select(1, one(sa_li))[:, 0]   # [La]
        sa_pinned = sa_unres & (sa_locked > 0)
        sa_lock_l = (~sa_pinned[:, None]
                     | (st.sa_val == sa_locked[:, None]))          # [La, N]
        sa_off = [0]
        for seg in ps.sa_segs:
            sa_off.append(sa_off[-1] + seg)

    def sa_fail(e):
        l0, l1 = sa_off[e], sa_off[e + 1]
        own_ok = torch.all(sa_own_l[l0:l1], dim=0)
        lock_ok = torch.all(sa_lock_l[l0:l1], dim=0)
        return ~(own_ok & (lock_ok | (sa_lock < 0)))

    def emit_label(slot_name):
        for i in label_at.get(slot_name, ()):
            stages.append((~st.label_ok[i], 1 << BIT_NODE_LABEL_PRESENCE))
        if ps is not None:
            for e, slot in enumerate(ps.sa_slots):
                if slot == slot_name:
                    stages.append((sa_fail(e), 1 << BIT_SERVICE_AFFINITY))
            if slot_name in ps.ports_slots and config.has_ports:
                # the PodFitsPorts tail alias runs the port stage again
                stages.append((port_bad, 1 << BIT_HOST_PORTS))

    emit_label(CHECK_NODE_UNSCHEDULABLE_PRED)

    general_on = on(GENERAL_PRED)
    part_on = {name: en is not None and name in en
               for name in (HOSTNAME_PRED, POD_FITS_HOST_PORTS_PRED,
                            MATCH_NODE_SELECTOR_PRED, POD_FITS_RESOURCES_PRED)}

    if general_on or part_on[POD_FITS_RESOURCES_PRED]:
        insuff_pods = (carry.pod_count + 1) > st.allowed_pods
        check_res = ~x.zero_request
        insuff_cpu = check_res & (st.alloc_cpu < x.req_cpu + carry.used_cpu)
        insuff_mem = check_res & (st.alloc_mem < x.req_mem + carry.used_mem)
        insuff_gpu = check_res & (st.alloc_gpu < x.req_gpu + carry.used_gpu)
        insuff_eph = check_res & (st.alloc_eph < x.req_eph + carry.used_eph)
        insuff_scalar = check_res & (
            st.alloc_scalar < x.req_scalar[None, :] + carry.used_scalar)
        fail_res = (insuff_pods | insuff_cpu | insuff_mem | insuff_gpu
                    | insuff_eph | torch.any(insuff_scalar, dim=-1))
        bits_res = (
            insuff_pods.to(I64) << BIT_INSUFFICIENT_PODS
            | insuff_cpu.to(I64) << BIT_INSUFFICIENT_CPU
            | insuff_mem.to(I64) << BIT_INSUFFICIENT_MEMORY
            | insuff_gpu.to(I64) << BIT_INSUFFICIENT_GPU
            | insuff_eph.to(I64) << BIT_INSUFFICIENT_EPHEMERAL)
        if st.alloc_scalar.shape[-1] > 0:
            bits_res = bits_res | torch.sum(
                insuff_scalar.to(I64) << const.scalar_shifts, dim=-1)
    if general_on or part_on[HOSTNAME_PRED]:
        host_bad = ~_row(st.host_ok, one(x.host_id))
    if general_on or part_on[MATCH_NODE_SELECTOR_PRED]:
        sel_bad = ~_row(st.selector_ok, one(x.sel_id))
    ports_alias_on = ps is not None and bool(ps.ports_slots)
    if config.has_ports and (general_on or part_on[POD_FITS_HOST_PORTS_PRED]
                             or ports_alias_on):
        # PodFitsHostPorts (predicates.go:1019-1039): a wanted port of my
        # group conflicts with the occupancy of any group present
        conflict_row = _row(st.port_conflict,
                            one(_row(st.port_sig, g1)))[st.port_sig]
        port_bad = torch.any(conflict_row[:, None] & (carry.presence > 0),
                             dim=0)

    if general_on:
        fail_general = fail_res | host_bad | sel_bad
        bits_general = (bits_res
                        | host_bad.to(I64) << BIT_HOSTNAME_MISMATCH
                        | sel_bad.to(I64) << BIT_NODE_SELECTOR_MISMATCH)
        if config.has_ports:
            fail_general = fail_general | port_bad
            bits_general = bits_general | (port_bad.to(I64) << BIT_HOST_PORTS)
        stages.append((fail_general, bits_general))
    emit_label(GENERAL_PRED)
    # individually named parts run as separate stages in the ordering slots
    # HostName -> PodFitsHostPorts -> MatchNodeSelector -> PodFitsResources
    if part_on[HOSTNAME_PRED]:
        stages.append((host_bad, 1 << BIT_HOSTNAME_MISMATCH))
    emit_label(HOSTNAME_PRED)
    if part_on[POD_FITS_HOST_PORTS_PRED] and config.has_ports:
        stages.append((port_bad, 1 << BIT_HOST_PORTS))
    emit_label(POD_FITS_HOST_PORTS_PRED)
    if part_on[MATCH_NODE_SELECTOR_PRED]:
        stages.append((sel_bad, 1 << BIT_NODE_SELECTOR_MISMATCH))
    emit_label(MATCH_NODE_SELECTOR_PRED)
    if part_on[POD_FITS_RESOURCES_PRED]:
        stages.append((fail_res, bits_res))
    emit_label(POD_FITS_RESOURCES_PRED)

    if config.has_disk_conflict and on(NO_DISK_CONFLICT_PRED):
        # NoDiskConflict (predicates.go:266-276): my volume set conflicts
        # with the volume set of any group present on the node
        disk_row = _row(st.disk_conflict,
                        one(_row(st.disk_sig, g1)))[st.disk_sig]
        fail_disk = torch.any(disk_row[:, None] & (carry.presence > 0), dim=0)
        stages.append((fail_disk, 1 << BIT_DISK_CONFLICT))
    emit_label(NO_DISK_CONFLICT_PRED)

    if on(POD_TOLERATES_NODE_TAINTS_PRED):
        stages.append((~_row(st.taint_ok, one(x.tol_id)),
                       1 << BIT_TAINTS_NOT_TOLERATED))
    emit_label(POD_TOLERATES_NODE_TAINTS_PRED)
    if en is not None and POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED in en:
        stages.append((~_row(st.taint_ok_noexec, one(x.tol_id)),
                       1 << BIT_TAINTS_NOT_TOLERATED))
    emit_label(POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED)
    emit_label(CHECK_NODE_LABEL_PRESENCE_PRED)
    emit_label(CHECK_SERVICE_AFFINITY_PRED)

    maxpd_on = (on(MAX_EBS_VOLUME_COUNT_PRED), on(MAX_GCE_PD_VOLUME_COUNT_PRED),
                on(MAX_AZURE_DISK_VOLUME_COUNT_PRED))
    if config.has_maxpd and any(maxpd_on):
        # Max{EBS,GCEPD,AzureDisk}VolumeCount (predicates.go:422-460): the
        # distinct counted volume ids on the node with mine against the
        # type's limit; a pod adding none passes; a disabled type never
        # fails. The counts are small integers: float64 products are exact.
        mask_g = _row(st.vol_mask, g1)                               # [V]
        union = (carry.used_vols | mask_g[None, :]).to(torch.float64)
        union_counts = union @ const.vol_type                        # [N, 3]
        my_counts = mask_g.to(torch.float64) @ const.vol_type        # [3]
        limits = [lim if enabled else (1 << 30)
                  for lim, enabled in zip(config.maxpd_limits, maxpd_on)]
        over = torch.stack([union_counts[:, i] > lim
                            for i, lim in enumerate(limits)], dim=1)
        fail_maxpd = torch.any((my_counts[None, :] > 0) & over, dim=1)
        stages.append((fail_maxpd, 1 << BIT_MAX_VOLUME_COUNT))
    emit_label(MAX_EBS_VOLUME_COUNT_PRED)
    emit_label(MAX_GCE_PD_VOLUME_COUNT_PRED)
    emit_label(MAX_AZURE_DISK_VOLUME_COUNT_PRED)
    emit_label(CHECK_VOLUME_BINDING_PRED)

    if config.has_vol_zone and on(NO_VOLUME_ZONE_CONFLICT_PRED):
        # NoVolumeZoneConflict (predicates.go:510-533): static per
        # (volume set, node)
        stages.append((~_row(st.zone_ok, g1), 1 << BIT_VOLUME_ZONE_CONFLICT))
    emit_label(NO_VOLUME_ZONE_CONFLICT_PRED)

    if on(CHECK_NODE_MEMORY_PRESSURE_PRED):
        stages.append((st.mem_pressure & x.best_effort,
                       1 << BIT_MEMORY_PRESSURE))
    emit_label(CHECK_NODE_MEMORY_PRESSURE_PRED)
    if on(CHECK_NODE_DISK_PRESSURE_PRED):
        stages.append((st.disk_pressure, 1 << BIT_DISK_PRESSURE))
    emit_label(CHECK_NODE_DISK_PRESSURE_PRED)

    f64 = torch.float64
    if config.has_interpod:
        # shared by MatchInterPodAffinity and InterPodAffinityPriority; the
        # counts are integer-valued float64 far below 2^53, so every sum is
        # exact whatever its order (atomic scatter-adds on a GPU included)
        presence_f = carry.presence.to(f64)
        pd_f = carry.presence_dom.to(f64)
        tm_col = st.term_match.index_select(1, g1)[:, 0]          # [Td]

    if config.has_interpod and on(MATCH_INTERPOD_AFFINITY_PRED):
        # MatchInterPodAffinity (predicates.go:1125-1450), last in
        # predicatesOrdering: matching is precompiled per group; only the
        # presence and topology aggregation runs here

        # my required affinity terms
        aff_term = _row(st.aff_term, g1)                            # [Ta]
        mcount = st.term_match[aff_term].to(f64) @ presence_f      # [Ta, N]
        dom_rows = st.topo_dom[_row(st.aff_key, g1)]               # [Ta, N]
        valid_dom = dom_rows > 0
        dc_at = torch.gather(_seg_rows(mcount, dom_rows, config.n_topo_doms),
                             1, dom_rows)
        is_host = _row(st.aff_hostname, g1)[:, None]
        on_node = mcount > 0.5
        term_matches = torch.where(is_host, valid_dom & on_node,
                                   valid_dom & (dc_at > 0.5))
        # hostname terms look at this node's pods only; other keys count a
        # matching pod anywhere (unplaced snapshot pods included)
        exists = torch.where(
            is_host, on_node,
            ((torch.sum(mcount, dim=1) > 0.5)
             | _row(st.aff_unplaced, g1))[:, None])
        term_ok = term_matches | ((~exists) & _row(st.aff_self, g1)[:, None])
        aff_fail = (torch.any(_row(st.aff_valid, g1)[:, None] & ~term_ok,
                              dim=0)
                    | _row(st.aff_err, g1))

        # my required anti-affinity terms
        bmcount = (st.term_match[_row(st.anti_term, g1)].to(f64)
                   @ presence_f)
        bdom_rows = st.topo_dom[_row(st.anti_key, g1)]
        bvalid = bdom_rows > 0
        bdc_at = torch.gather(
            _seg_rows(bmcount, bdom_rows, config.n_topo_doms), 1, bdom_rows)
        b_is_host = _row(st.anti_hostname, g1)[:, None]
        b_matches = torch.where(b_is_host, bvalid & (bmcount > 0.5),
                                bvalid & (bdc_at > 0.5))
        anti_fail = (torch.any(_row(st.anti_valid, g1)[:, None] & b_matches,
                               dim=0)
                     | _row(st.anti_err, g1))

        # existing pods' anti-affinity against me (checked first)
        w = st.anti_valid & tm_col[st.anti_term]                   # [G, Tb]
        grp_present = torch.sum(carry.presence, dim=1) > 0         # [G]
        fail_all = torch.any(w & st.anti_empty & grp_present[:, None])
        bad_dom = torch.einsum("gtk,gt,gkd->kd", const.key_oh,
                               (w & ~st.anti_empty).to(f64), pd_f)
        bad_at = torch.gather(bad_dom, 1, st.topo_dom)             # [K, N]
        exist_fail = (torch.any((st.topo_dom > 0) & (bad_at > 0.5), dim=0)
                      | fail_all)

        fail_interpod = exist_fail | aff_fail | anti_fail
        # two reasons a failure: the umbrella and the rule, in the engine's
        # check order (existing anti-affinity, affinity, anti-affinity)
        interpod_bits = (1 << BIT_AFFINITY_NOT_MATCH) | torch.where(
            exist_fail, 1 << BIT_EXISTING_ANTI_AFFINITY,
            torch.where(aff_fail, 1 << BIT_AFFINITY_RULES,
                        1 << BIT_ANTI_AFFINITY_RULES))
        stages.append((fail_interpod, interpod_bits))
    emit_label(MATCH_INTERPOD_AFFINITY_PRED)
    # customs under names outside the ordering run after it in the host's
    # alphabetical order: policyc gives each its position as "tail:<k>"
    if ps is not None:
        tail_ks = sorted(
            int(s.split(":", 1)[1])
            for s in set(ps.label_rows) | set(ps.sa_slots) | set(ps.ports_slots)
            if s.startswith("tail:"))
        for k in tail_ks:
            emit_label(f"tail:{k}")

    fail_any = stages[0][0]
    for fail, _ in stages[1:]:
        fail_any = fail_any | fail
    feasible = ~fail_any
    reason_bits = torch.zeros_like(st.cond_fail_bits)
    aca_counts = None
    if ps is not None and ps.always_check_all:
        # alwaysCheckAllPredicates: every failing stage reports, so the
        # histogram sums stage firings (a reason string can occur several
        # times a node); reason_bits stays zero
        fail_stack = torch.stack([fail for fail, _ in stages])
        bits_stack = torch.stack([
            bits.expand(fail.shape) if isinstance(bits, torch.Tensor)
            else torch.full(fail.shape, bits, dtype=I64, device=fail.device)
            for fail, bits in stages])
        aca_counts = (fail_stack, bits_stack)
    else:
        # short-circuit: the first failing stage gives the reasons
        for fail, bits in reversed(stages):
            reason_bits = torch.where(fail, bits, reason_bits)
    n_feasible = torch.sum(feasible)

    # ---- score (weighted sum, generic_scheduler.go:631-639) ----
    (w_least, w_most, w_balanced, w_node_aff, w_taint, w_avoid, w_spread,
     w_interpod) = policy_weights(ps, config.most_requested)

    score = torch.zeros_like(st.alloc_cpu)
    if w_least or w_most or w_balanced:
        total_cpu = x.nz_cpu + carry.nonzero_cpu
        total_mem = x.nz_mem + carry.nonzero_mem
    if w_least:
        # least_requested.go:41-52
        score = score + w_least * _fdiv(
            _ratio_score(total_cpu, st.alloc_cpu, False)
            + _ratio_score(total_mem, st.alloc_mem, False), 2)
    if w_most:
        # most_requested.go:44-55
        score = score + w_most * _fdiv(
            _ratio_score(total_cpu, st.alloc_cpu, True)
            + _ratio_score(total_mem, st.alloc_mem, True), 2)
    if w_balanced:
        score = score + w_balanced * _balanced_score(
            total_cpu, total_mem, st.alloc_cpu, st.alloc_mem)

    if w_node_aff:
        # NodeAffinityPriority: NormalizeReduce(10, False) over feasible nodes
        aff = _row(st.affinity_count, one(x.aff_id))
        aff_max = torch.max(torch.where(feasible, aff, 0))
        score = score + w_node_aff * torch.where(
            aff_max > 0, _fdiv(MAX_PRIORITY * aff, aff_max.clamp(min=1)), 0)

    if w_taint:
        # TaintTolerationPriority: NormalizeReduce(10, True) over feasible
        intol = _row(st.intolerable, one(x.tol_id))
        intol_max = torch.max(torch.where(feasible, intol, 0))
        score = score + w_taint * torch.where(
            intol_max > 0,
            MAX_PRIORITY - _fdiv(MAX_PRIORITY * intol, intol_max.clamp(min=1)),
            MAX_PRIORITY)

    if w_avoid:
        score = score + _row(st.avoid_score, one(x.avoid_id)) * w_avoid

    if ps is not None and ps.has_label_prio:
        # NodeLabel/LabelPreference priorities: static pre-weighted row
        score = score + st.label_prio

    if ps is not None and ps.w_image:
        # ImageLocalityPriority (image_locality.go): static per
        # (pod image set, node)
        score = score + _row(st.image_score, one(x.img_id)) * ps.w_image

    if ps is not None and ps.saa_weights:
        # ServiceAntiAffinity (selector_spreading.go:176-280): spread the
        # pods my first service selects over the node groups the policy
        # label names; the reduce runs over feasible nodes, unlabeled nodes
        # score 0
        saa_row = _row(st.saa_rows, one(_row(st.saa_sig, g1)))
        saa_cnt = (saa_row.to(f64) @ carry.presence.to(f64)).to(I64)  # [N]
        saa_fcnt = torch.where(feasible, saa_cnt, 0)
        saa_total = torch.sum(saa_fcnt)
        saa_term = torch.zeros_like(score)
        for e, w_saa in enumerate(ps.saa_weights):
            dom = st.saa_dom[e]
            labeled = dom > 0
            grp = _seg(torch.where(labeled, saa_fcnt, 0), dom,
                       config.n_saa_doms)
            grp[0].fill_(0)     # a fill, not a host copy
            f_score = torch.where(
                saa_total > 0,
                _fdiv(MAX_PRIORITY * (saa_total - grp[dom]),
                      saa_total.clamp(min=1)),
                MAX_PRIORITY)
            saa_term = saa_term + torch.where(labeled, f_score, 0) * w_saa
        score = score + saa_term

    if config.has_services and w_spread:
        # SelectorSpreadPriority (selector_spreading.go:66-175): my
        # services' matched pods per node, then the node/zone blend over
        # feasible nodes in exact integers with one floor at the end (Go's
        # nodeScore/3 + 2*zoneScore/3)
        ss_row = _row(st.ss_rows, one(_row(st.ss_sig, g1)))
        cnt = (ss_row.to(f64) @ carry.presence.to(f64)).to(I64)     # [N]
        fcnt = torch.where(feasible, cnt, 0)
        max_node = torch.max(fcnt)
        zdom = st.zone_dom
        zvalid = zdom > 0
        zcnt = _seg(fcnt, zdom, config.n_zone_doms)
        zcnt[0].fill_(0)
        have_zones = torch.any(feasible & zvalid)
        max_zone = torch.max(zcnt)
        node_num = torch.where(max_node > 0, max_node - cnt, 1)
        node_den = max_node.clamp(min=1)
        zone_num = torch.where(max_zone > 0, max_zone - zcnt[zdom], 1)
        zone_den = max_zone.clamp(min=1)
        plain = _fdiv(MAX_PRIORITY * node_num, node_den)
        blend = _fdiv(MAX_PRIORITY * (node_num * zone_den
                                      + 2 * zone_num * node_den),
                      3 * node_den * zone_den)
        score = score + torch.where(have_zones & zvalid, blend, plain) \
            * w_spread

    if config.has_interpod and w_interpod:
        # InterPodAffinityPriority (interpod_affinity.go:118+): counts from
        # (a) my preferred terms over existing pods, (b) existing pods'
        # preferred terms over me, (c) their required affinity x the hard
        # weight
        p_w = _row(st.pref_w, g1)                                   # [Tp]
        pcount = (st.term_match[_row(st.pref_term, g1)].to(f64)
                  @ presence_f)                                     # [Tp, N]
        pdom = st.topo_dom[_row(st.pref_key, g1)]                   # [Tp, N]
        pdc_at = torch.gather(_seg_rows(pcount, pdom, config.n_topo_doms),
                              1, pdom)
        counts = torch.sum(p_w[:, None] * torch.where(pdom > 0, pdc_at, 0.0),
                           dim=0)
        wb = st.pref_w * tm_col[st.pref_term]                       # [G, Tp]
        wc = float(config.hard_weight) * (
            st.aff_valid & ~st.aff_empty & tm_col[st.aff_term]).to(f64)
        wsum = (torch.einsum("gtk,gt,gkd->kd", const.key_oh_p, wb, pd_f)
                + torch.einsum("gtk,gt,gkd->kd", const.key_oh_a, wc, pd_f))
        wsum_at = torch.gather(wsum, 1, st.topo_dom)                # [K, N]
        counts = counts + torch.sum(
            torch.where(st.topo_dom > 0, wsum_at, 0.0), dim=0)

        # the normalize is exact integer arithmetic on the integer counts
        counts_i = counts.to(I64)
        big = 1 << 62
        maxc = torch.max(torch.where(feasible, counts_i, -big)).clamp(min=0)
        minc = torch.min(torch.where(feasible, counts_i, big)).clamp(max=0)
        rng = maxc - minc
        ip = torch.where(rng > 0, _fdiv(MAX_PRIORITY * (counts_i - minc),
                                        rng.clamp(min=1)), 0)
        score = score + ip * w_interpod

    return feasible, reason_bits, score, n_feasible, aca_counts


def _select(feasible, score, n_feasible, rr):
    """selectHost (generic_scheduler.go:183-198): stable descending order
    and round-robin over the max-score ties; rr is consumed only when more
    than one node passed the filter (scheduleOne returns a lone feasible
    node directly, :176-180)."""
    masked = torch.where(feasible, score, -1)
    max_score = torch.max(masked)
    tie = feasible & (masked == max_score)
    ties = torch.sum(tie).clamp(min=1)
    k = torch.where(n_feasible > 1, torch.remainder(rr, ties), 0)
    rank = torch.cumsum(tie.to(I64), dim=0) - 1
    pick = tie & (rank == k)
    choice = torch.argmax(pick.to(torch.int32)).to(torch.int32)
    found = n_feasible > 0
    return torch.where(found, choice, -1), found


def _reason_histogram(reason_bits, const: _Const):
    present = (reason_bits[:, None] >> const.bit_ids[None, :]) & 1
    return torch.sum(present, dim=0).to(torch.int32)


def _aca_histogram(aca_counts, const: _Const):
    """Count mode: per reason, its occurrences over every failing stage."""
    fail_stack, bits_stack = aca_counts
    decoded = ((bits_stack[..., None] >> const.bit_ids) & 1) != 0  # [S, N, B]
    return torch.sum(fail_stack[..., None] & decoded,
                     dim=(0, 1)).to(torch.int32)


_BOOL_FIELDS = ("zero_request", "best_effort")


def _pack_pods(xs: PodX):
    """The pods' columns as one [P, F] int64 matrix (req_scalar spread over
    S columns) and a function from a row of it to a PodX of 0-d views."""
    cols, at = [], {}
    for name in PodX._fields:
        col = getattr(xs, name).to(I64)
        col = col if col.dim() == 2 else col[:, None]
        at[name] = (sum(c.shape[1] for c in cols), col.shape[1])
        cols.append(col)
    packed = torch.cat(cols, dim=1)

    def unpack(row) -> PodX:
        fields = {}
        for name, (lo, width) in at.items():
            v = row[lo:lo + width] if name == "req_scalar" else row[lo]
            fields[name] = v != 0 if name in _BOOL_FIELDS else v
        return PodX(**fields)

    return packed, unpack


class ScanOutputs(NamedTuple):
    choices: torch.Tensor    # [P] int32
    counts: torch.Tensor     # [P, bits] int32
    advanced: torch.Tensor   # [P] bool


def make_step(config: EngineConfig, st: Statics, xs: PodX, carry: Carry,
              out: ScanOutputs, t1):
    """The exact sequential step over device-held state: step() takes pod
    t1 (a one-element int64 counter on the device), binds it into `carry`
    in place, writes its row of `out` and advances t1. Nothing in it reads
    the device from the host, so a block of steps can be captured in a
    CUDA graph."""
    const = _Const(config, st)
    packed, unpack = _pack_pods(xs)
    group_bound = (config.has_ports or config.has_services
                   or config.has_interpod or config.has_disk_conflict)
    sa_on = config.policy is not None and config.policy.sa_enabled

    def step():
        x = unpack(packed.index_select(0, t1)[0])
        g1 = x.group_id.reshape(1)
        feasible, reason_bits, score, n_feasible, aca_counts = _evaluate(
            config, carry, st, x, g1, const)
        choice, found = _select(feasible, score, n_feasible, carry.rr)
        advanced = n_feasible > 1

        idx1 = choice.clamp(min=0).to(I64).reshape(1)
        gate = found.to(I64)
        gate32 = found.to(torch.int32).reshape(1)
        if group_bound:
            n = carry.presence.shape[1]
            carry.presence.view(-1).index_add_(0, g1 * n + idx1, gate32)
        if config.has_maxpd:
            cur = carry.used_vols.index_select(0, idx1)
            row = torch.where(found, cur | st.vol_mask.index_select(0, g1),
                              cur)
            carry.used_vols.index_copy_(0, idx1, row)
        if config.has_interpod:
            _, k_count, d_count = carry.presence_dom.shape
            dom_at = st.topo_dom.index_select(1, idx1)[:, 0]           # [K]
            flat = (g1 * k_count + const.keys) * d_count + dom_at
            carry.presence_dom.view(-1).index_add_(
                0, flat, gate32.expand(k_count))
        if sa_on:
            # the first bound pod a selector matches locks its signature to
            # the chosen node (assigned order is bind order here)
            match_f = st.saa_rows.index_select(1, g1)[:, 0] & found  # [F]
            carry.sa_lock.copy_(torch.where(
                (carry.sa_lock == -1) & match_f, idx1.to(torch.int32),
                carry.sa_lock))
        for name, req in (("used_cpu", x.req_cpu), ("used_mem", x.req_mem),
                          ("used_gpu", x.req_gpu), ("used_eph", x.req_eph),
                          ("nonzero_cpu", x.nz_cpu),
                          ("nonzero_mem", x.nz_mem), ("pod_count", 1)):
            getattr(carry, name).index_add_(0, idx1, (gate * req).reshape(1))
        carry.used_scalar.index_add_(0, idx1, (gate * x.req_scalar)[None])
        carry.rr.add_(advanced.to(I64))

        hist = (_aca_histogram(aca_counts, const) if aca_counts is not None
                else _reason_histogram(reason_bits, const))
        out.choices.index_copy_(0, t1, choice.reshape(1))
        out.counts.index_copy_(
            0, t1, torch.where(found, const.no_counts, hist)[None])
        out.advanced.index_copy_(0, t1, advanced.reshape(1))
        t1.add_(1)

    return step


def schedule_scan(config: EngineConfig, carry: Carry, statics: Statics,
                  xs: PodX, graph_steps: int = 0):
    """Every pod of `xs` in order: (final_carry, choices int32 [P], counts
    int32 [P, bits], advanced bool [P]), all on the statics' device.
    `carry` is left as it was (the scan binds into a copy).

    graph_steps > 0 on a CUDA device captures that many steps in one CUDA
    graph and replays it over the batch (the steps left over, and the
    first, run eagerly): one launch a block instead of a few hundred a pod,
    the same operations in the same order."""
    carry = Carry(*(t.clone() for t in carry))
    num_pods = xs.req_cpu.shape[0]
    dev = statics.alloc_cpu.device
    num_bits = NUM_FIXED_BITS + statics.alloc_scalar.shape[-1]
    out = ScanOutputs(
        choices=torch.empty(num_pods, dtype=torch.int32, device=dev),
        counts=torch.empty((num_pods, num_bits), dtype=torch.int32,
                           device=dev),
        advanced=torch.empty(num_pods, dtype=torch.bool, device=dev))
    t1 = torch.zeros(1, dtype=I64, device=dev)
    step = make_step(config, statics, xs, carry, out, t1)
    done = 0
    if graph_steps > 0 and dev.type == "cuda" and num_pods > graph_steps:
        step()              # the first step eagerly: warms up every op
        done = 1
        blocks = (num_pods - done) // graph_steps
        if blocks:
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(graph_steps):
                    step()
            for _ in range(blocks):
                graph.replay()
            done += blocks * graph_steps
    for _ in range(num_pods - done):
        step()
    return (carry,) + tuple(out)


# ---------------------------------------------------------------------------
# Preemption victim selection (the JAX package's preempt_select), for the
# arithmetic reprieve class (policyc.classify_preemption_class):
#   selectVictimsOnNode (core/generic_scheduler.go:583-665) -> a cumulative
#       reprieve over the victim slots, one lane a candidate node
#   pickOneNodeForPreemption (:739-831) -> the tie-break criteria as staged
#       min-filters over the lanes
# The preemption hybrid (preempt.py) builds the lanes (the static-predicate
# mask and the stripped-node resource fit) and the priority-sorted slots
# from its victim table.

PRIO_SUM_OFFSET = 1 << 31  # util.MAX_INT32 + 1 (pickOneNode criterion 4)
PREEMPT_NONE = 1 << 62     # the "no lane qualifies" sentinel


def preempt_select(zero_req: bool, lane_valid, node_idx, alloc_cpu,
                   alloc_mem, alloc_gpu, alloc_eph, allowed, n_base,
                   base_cpu, base_mem, base_gpu, base_eph, v_prio, v_cpu,
                   v_mem, v_gpu, v_eph, v_valid):
    """One failed pod against C candidate lanes x V victim slots, all int64
    tensors (bool for the two masks) on one device.

    Per lane [C]: node_idx the node's index (insertion-order tie-breaks),
    alloc_* and allowed its allocatables, n_base its resident pods after
    every lower-priority pod is stripped, base_* the stripped usage plus
    the incoming pod's request. Per slot [C, V]: the lane's lower-priority
    pods sorted by descending priority (stable in NodeInfo.pods order);
    v_valid masks the real slots. zero_req: the incoming pod requests
    nothing, so only the pod count is checked (predicates.go:706-776).

    Returns (winner, empty_winner, victim [C, V] bool, num [C]): winner is
    the node index criteria 2-5 pick over lanes with victims (criterion 2,
    the PDB violations, is uniformly 0 in this class), empty_winner the
    first lane with no victim at all (criterion 1: the node fits without
    preempting anyone, which the caller must treat as a disagreement with
    the scan); both 0-d tensors, PREEMPT_NONE when no lane qualifies."""
    n, cpu, mem, gpu, eph = n_base, base_cpu, base_mem, base_gpu, base_eph
    zero = torch.zeros((), dtype=I64, device=n_base.device)
    victim_cols = []
    for v in range(v_prio.shape[1]):
        vc, vm, vg, ve = v_cpu[:, v], v_mem[:, v], v_gpu[:, v], v_eph[:, v]
        valid = v_valid[:, v]
        # the state holds the incoming pod already: +2 = the victim + the pod
        fits = n + 2 <= allowed
        if not zero_req:
            fits = (fits & (alloc_cpu >= cpu + vc) & (alloc_mem >= mem + vm)
                    & (alloc_gpu >= gpu + vg) & (alloc_eph >= eph + ve))
        reprieved = fits & valid
        n = n + reprieved.to(I64)
        cpu = cpu + torch.where(reprieved, vc, zero)
        mem = mem + torch.where(reprieved, vm, zero)
        gpu = gpu + torch.where(reprieved, vg, zero)
        eph = eph + torch.where(reprieved, ve, zero)
        victim_cols.append(valid & ~fits)
    victim = (torch.stack(victim_cols, dim=1) if victim_cols
              else torch.zeros_like(v_valid))

    big = torch.full((), PREEMPT_NONE, dtype=I64, device=n_base.device)
    num = victim.to(I64).sum(dim=1)
    empty_winner = torch.where(lane_valid & (num == 0), node_idx, big).min()

    # criterion 3: the lowest highest-victim priority; slots are sorted by
    # descending priority, so a lane's first victim carries its highest
    first = victim.to(torch.int32).argmax(dim=1, keepdim=True)
    highest = v_prio.gather(1, first)[:, 0]
    # criterion 4: the smallest sum of (priority + MAX_INT32 + 1)
    psum = torch.where(victim, v_prio + PRIO_SUM_OFFSET, zero).sum(dim=1)

    # staged min-filters; a single surviving lane passes every later filter,
    # as the host's len(names) > 1 guards have it
    sel = lane_valid & (num > 0)
    for key in (highest, psum, num):
        sel = sel & (key == torch.where(sel, key, big).min())
    winner = torch.where(sel, node_idx, big).min()  # criterion 5: the first
    return winner, empty_winner, victim, num
