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

The same step runs a batch whole (schedule_scan), in chunks of pods whose
columns reach the device one chunk at a time (schedule_scan_chunked), or
over S scenarios stacked on a leading axis in lockstep (BatchedScan, the
what-if route).
"""

from __future__ import annotations

import threading
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpusim_torch.config import (
    EXPLAIN_SENTINEL,
    EngineConfig,
    explain_part_names,
    policy_weights,
)
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
from tpusim_torch.kernels.resident_step import (
    MAX_NODES,
    MAX_SCALARS,
    make_fused_step,
)
from tpusim_torch.packing import encode_gang_rank, encode_topk_keys
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
# cond_fail_bits of a node padded onto the node axis: fails the condition
# stage and lies past every decoded reason bit
PAD_SENTINEL = 1 << 62
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


# Axis registries: for each field of a tree, a tuple naming every array
# axis. sharding.py pads the "node" axis; whatif.py unifies every other named
# axis to one size across scenarios. PodX omits its leading pod axis.
STATICS_AXES = dict(
    alloc_cpu=("node",), alloc_mem=("node",), alloc_gpu=("node",),
    alloc_eph=("node",), allowed_pods=("node",),
    alloc_scalar=("node", "scalar"), cond_fail_bits=("node",),
    mem_pressure=("node",), disk_pressure=("node",),
    selector_ok=("sig_sel", "node"), taint_ok=("sig_tol", "node"),
    taint_ok_noexec=("sig_tol", "node"), intolerable=("sig_tol", "node"),
    affinity_count=("sig_aff", "node"), avoid_score=("sig_avoid", "node"),
    host_ok=("sig_host", "node"),
    port_conflict=("port_sig", "port_sig"), port_sig=("group",),
    disk_conflict=("disk_sig", "disk_sig"), disk_sig=("group",),
    vol_mask=("group", "vol_id"), vol_type=("vol_id", "vol_filter"),
    zone_ok=("group", "node"),
    ss_rows=("spread_sig", "group"), ss_sig=("group",),
    saa_rows=("saa_sig", "group"), saa_sig=("group",),
    term_match=("term_sig", "group"),
    zone_dom=("node",), topo_dom=("topo_key", "node"),
    aff_valid=("group", "aff_term"), aff_err=("group",),
    aff_empty=("group", "aff_term"), aff_term=("group", "aff_term"),
    aff_key=("group", "aff_term"), aff_hostname=("group", "aff_term"),
    aff_self=("group", "aff_term"), aff_unplaced=("group", "aff_term"),
    anti_valid=("group", "anti_term"), anti_err=("group",),
    anti_empty=("group", "anti_term"), anti_term=("group", "anti_term"),
    anti_key=("group", "anti_term"), anti_hostname=("group", "anti_term"),
    pref_w=("group", "pref_term"), pref_term=("group", "pref_term"),
    pref_key=("group", "pref_term"),
    label_ok=("label_pred", "node"), label_prio=("node",),
    image_score=("sig_img", "node"), saa_dom=("saa_entry", "node"),
    sa_val=("sa_label", "node"),
    sa_pin=("sig_sa_self", "sa_label"),
)
CARRY_AXES = dict(
    used_cpu=("node",), used_mem=("node",), used_gpu=("node",),
    used_eph=("node",), used_scalar=("node", "scalar"),
    nonzero_cpu=("node",), nonzero_mem=("node",), pod_count=("node",),
    presence=("group", "node"),
    presence_dom=("group", "topo_key", "topo_dom"),
    used_vols=("node", "vol_id"), sa_lock=("saa_sig",), rr=(),
)
PODX_AXES = dict(
    req_cpu=(), req_mem=(), req_gpu=(), req_eph=(), req_scalar=("scalar",),
    nz_cpu=(), nz_mem=(), zero_request=(), best_effort=(), sel_id=(),
    tol_id=(), aff_id=(), avoid_id=(), host_id=(), group_id=(), img_id=(),
    sa_self_id=(),
)
# Node-axis pad fill per field (default 0); sharding.pad_node_axis gives
# cond_fail_bits its infeasible sentinel instead.
PAD_FILLS: dict = {}


def _upload(a, device, index: bool = False) -> torch.Tensor:
    """A fresh copy of numpy array `a` on `device`; `index` widens int32 to
    int64."""
    t = torch.tensor(np.asarray(a), device=device)
    if index and t.dtype == torch.int32:
        t = t.to(I64)
    return t


def tree_to(tree, device, index: bool = False):
    """A tree of host numpy arrays (Statics, Carry or PodX) on `device`;
    `index` widens int32 ids to int64 (Statics and PodX)."""
    return type(tree)(*(_upload(a, device, index) for a in tree))


def statics_to_host(compiled: CompiledCluster, ptabs=None) -> Statics:
    """Statics of `compiled` over host numpy arrays, with a policy's rows
    from `ptabs` (policyc.PolicyTables) when given, trivial rows
    otherwise."""
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
    return Statics(**host)


def statics_to(compiled: CompiledCluster, device, ptabs=None) -> Statics:
    """Statics of `compiled` on `device`, with a policy's rows from `ptabs`
    (policyc.PolicyTables) when given."""
    return tree_to(statics_to_host(compiled, ptabs), device, index=True)


def _presence_dom_init(presence: np.ndarray, topo_dom: np.ndarray,
                       n_doms: int) -> np.ndarray:
    """presence_dom[g, k, d] = sum of presence[g, n] over nodes in domain d."""
    g = presence.shape[0]
    k = topo_dom.shape[0]
    pd = np.zeros((g, k, n_doms), dtype=np.int32)
    for ki in range(k):
        np.add.at(pd[:, ki, :], (slice(None), topo_dom[ki]), presence)
    return pd


def carry_init_host(compiled: CompiledCluster,
                    sa_lock_init: Optional[np.ndarray] = None) -> Carry:
    """The initial carry of `compiled` over host numpy arrays; a policy's
    ServiceAffinity locks from `sa_lock_init` when given."""
    d, gt = compiled.dynamic, compiled.groups
    if sa_lock_init is None:
        sa_lock_init = np.full(gt.saa_rows.shape[0], -1, dtype=np.int32)
    return Carry(
        used_cpu=d.used_cpu, used_mem=d.used_mem, used_gpu=d.used_gpu,
        used_eph=d.used_eph, used_scalar=d.used_scalar,
        nonzero_cpu=d.nonzero_cpu, nonzero_mem=d.nonzero_mem,
        pod_count=d.pod_count, presence=gt.presence,
        presence_dom=_presence_dom_init(gt.presence, gt.topo_dom,
                                        compiled.n_topo_doms),
        used_vols=gt.used_vols_init, sa_lock=sa_lock_init,
        rr=np.int64(0))


def carry_init(compiled: CompiledCluster, device,
               sa_lock_init: Optional[np.ndarray] = None) -> Carry:
    """The initial carry of `compiled` on `device`; a policy's
    ServiceAffinity locks from `sa_lock_init` when given."""
    return tree_to(carry_init_host(compiled, sa_lock_init), device)


def pod_columns_to_host(cols: PodColumns) -> PodX:
    """The pods' columns over host numpy arrays."""
    return PodX(*(getattr(cols, name) for name in PodX._fields))


def pod_columns_to(cols: PodColumns, device) -> PodX:
    return tree_to(pod_columns_to_host(cols), device, index=True)


def scan_inputs_host(config: EngineConfig, compiled: CompiledCluster,
                     cols: PodColumns, ptabs):
    """(carry, statics, xs) over host numpy arrays: under a policy its rows
    grafted onto the statics and, with ServiceAffinity, its initial locks
    onto the carry (the same tables plan_fast bakes into the kernel's
    plan)."""
    ps = config.policy
    sa_lock_init = (ptabs.sa_lock_init if ps is not None and ps.sa_enabled
                    else None)
    return (carry_init_host(compiled, sa_lock_init),
            statics_to_host(compiled, ptabs), pod_columns_to_host(cols))


def scan_inputs(config: EngineConfig, compiled: CompiledCluster,
                cols: PodColumns, ptabs, device, host_pods: bool = False):
    """scan_inputs_host's (carry, statics, xs) on `device`. host_pods
    leaves xs in host memory (schedule_scan_chunked)."""
    carry, statics, xs = scan_inputs_host(config, compiled, cols, ptabs)
    return (tree_to(carry, device), tree_to(statics, device, index=True),
            xs if host_pods else tree_to(xs, device, index=True))


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
    # out of place: the batched scan maps this over scenarios (torch.func.
    # vmap), where an in-place add of a batched product into a fresh zeros
    # tensor is refused
    out = torch.zeros((_NUM_COLS,) + a.shape, dtype=I64, device=a.device)
    return out.index_add(0, col, prod.reshape((-1,) + a.shape))


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
    return out.scatter_add(1, doms, values)     # out of place, as _mul_limbs


def _seg(values, doms, num_segments: int):
    """Segment sums of [N] values over [N] domain ids -> [D]."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.scatter_add(0, doms, values)


def _row(table, i1):
    """table[i] for a one-element index tensor i1 (no host read)."""
    return table.index_select(0, i1)[0]


# ---------------------------------------------------------------------------
# Node-axis collectives. On the node-sharded route (sharded_scan_fn) each
# process holds a contiguous block of the node axis, and every cross-node
# reduction of the step funnels through these four helpers: with no shard
# they return their operand (the single-device step is untouched), with one
# they all_reduce it over the shard's process group. Every reduced quantity
# is an integer or an integer-valued float64 count below 2^53, so the sums,
# maxima and minima are exact whatever the order the ranks combine in.


class Shard(NamedTuple):
    """This process's block of a node-sharded step: the node axis's
    process group, this rank's index in it and the group's size, the
    block's node count, and the global index of its first node. `vmapped`
    marks a step whose reductions run inside torch.func.vmap (the batched
    scan's evaluate and select): there they go through _NodeAllReduce,
    whose batching rule reduces every scenario's operand in one
    collective."""
    group: object
    rank: int
    size: int
    n_local: int
    base: int
    vmapped: bool = False


# all_reduces issued by the node-axis helpers this process, one a call of
# dist.all_reduce (a vmapped reduction over S scenarios counts once)
_COLLECTIVES = {"all_reduce": 0}


def collective_count() -> int:
    """The node-axis all_reduces issued this process (_COLLECTIVES)."""
    return _COLLECTIVES["all_reduce"]


def _reduced(v, op: str, group):
    """v all-reduced over `group` with op "sum", "max" or "min", as a new
    tensor of v's shape and dtype (a bool operand is reduced as int32): the
    one place the node-axis helpers call dist.all_reduce, counted."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    buf = v.reshape(-1).to(torch.int32 if v.dtype == torch.bool
                           else v.dtype, copy=True)
    _COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(buf, op=ops[op], group=group)
    buf = buf.reshape(v.shape)
    return buf != 0 if v.dtype == torch.bool else buf


def _all_reduce(v, shard: Shard, op: str):
    """v all-reduced over the shard's group (_reduced). On a vmapped shard
    the reduction goes through _NodeAllReduce, which vmap can batch."""
    if shard.vmapped:
        return _NodeAllReduce.apply(v, shard.group, op)
    return _reduced(v, op, shard.group)


class _NodeAllReduce(torch.autograd.Function):
    """_reduced as a function torch.func.vmap batches by one collective
    over the whole batched operand (every scenario's rows at once), so a
    vmapped step issues one all_reduce a reduction site whatever the
    scenario count. (An autograd.Function with a vmap rule, not a
    torch.library custom op: the latter's first call imports
    torch._dynamo, about 2 s a process.)"""

    @staticmethod
    def forward(v, group, op):
        return _reduced(v, op, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, v, group, op):
        # the batch dimension reduces with the rest: each scenario's slice
        # is summed (or maxed) with the same scenario's on the other ranks
        return _NodeAllReduce.apply(v, group, op), in_dims[0]


def _ax_sum(v, shard: Optional[Shard]):
    return v if shard is None else _all_reduce(v, shard, "sum")


def _ax_max(v, shard: Optional[Shard]):
    return v if shard is None else _all_reduce(v, shard, "max")


def _ax_min(v, shard: Optional[Shard]):
    return v if shard is None else _all_reduce(v, shard, "min")


def _ax_any(v, shard: Optional[Shard]):
    return v if shard is None else _all_reduce(v, shard, "max")


def gather_nodes(shard: Shard, t, dim: int = 0):
    """The whole node axis (dim) of a node-sharded tensor on every rank:
    each rank writes its block into zeros and the blocks are summed (one
    all_reduce; a bool tensor travels as int32)."""
    shape = list(t.shape)
    shape[dim] = shard.n_local * shard.size
    full = torch.zeros(shape, dtype=torch.int32 if t.dtype == torch.bool
                       else t.dtype, device=t.device)
    full.narrow(dim, shard.base, shard.n_local).copy_(t)
    return _ax_sum(full, shard) != 0 if t.dtype == torch.bool \
        else _ax_sum(full, shard)


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
              g1, const: _Const, parts: Optional[list] = None,
              shard: Optional[Shard] = None):
    """Filter + score one pod against the carried aggregates: (feasible[N],
    reason_bits[N], score[N], n_feasible, aca_counts). A `parts` list gets
    each weighted score component ([N]) as it is added, in
    explain_part_names order: they sum to the score.

    x holds one pod's columns (0-d tensors); g1 is its group id as a
    one-element index. With config.policy set, stages and components are
    gated to the policy's predicate set and weights (factory.go
    CreateFromConfig); stages always follow PREDICATES_ORDERING, so the
    first failing stage gives the host engine's reason. With `shard` the
    node columns are this rank's block and every reduction over nodes is
    an all_reduce over the shard's group (the JAX package's sites)."""
    ps = config.policy
    en = ps.pred_keys if ps is not None else None
    ax = shard

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
        if ax is None:
            sa_locked = st.sa_val.index_select(1, one(sa_li))[:, 0]  # [La]
        else:
            # the locked node's labels from the rank that holds it: a
            # global index, read by one sum over the node group
            sa_loc = sa_li - ax.base
            sa_own = (sa_loc >= 0) & (sa_loc < ax.n_local)
            sa_locked = _ax_sum(torch.where(sa_own, st.sa_val.index_select(
                1, one(sa_loc.clamp(0, ax.n_local - 1)))[:, 0], 0), ax)
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
        dc_at = torch.gather(
            _ax_sum(_seg_rows(mcount, dom_rows, config.n_topo_doms), ax),
            1, dom_rows)
        is_host = _row(st.aff_hostname, g1)[:, None]
        on_node = mcount > 0.5
        term_matches = torch.where(is_host, valid_dom & on_node,
                                   valid_dom & (dc_at > 0.5))
        # hostname terms look at this node's pods only; other keys count a
        # matching pod anywhere (unplaced snapshot pods included)
        exists = torch.where(
            is_host, on_node,
            ((_ax_sum(torch.sum(mcount, dim=1), ax) > 0.5)
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
            _ax_sum(_seg_rows(bmcount, bdom_rows, config.n_topo_doms), ax),
            1, bdom_rows)
        b_is_host = _row(st.anti_hostname, g1)[:, None]
        b_matches = torch.where(b_is_host, bvalid & (bmcount > 0.5),
                                bvalid & (bdc_at > 0.5))
        anti_fail = (torch.any(_row(st.anti_valid, g1)[:, None] & b_matches,
                               dim=0)
                     | _row(st.anti_err, g1))

        # existing pods' anti-affinity against me (checked first)
        w = st.anti_valid & tm_col[st.anti_term]                   # [G, Tb]
        grp_present = _ax_sum(torch.sum(carry.presence, dim=1), ax) > 0  # [G]
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
        # times a node); reason_bits stays zero. A node padded on (bit 62 of
        # its condition bits, sharding.pad_node_axis) reports nothing.
        is_pad = (st.cond_fail_bits & PAD_SENTINEL) != 0
        fail_stack = torch.stack([fail & ~is_pad for fail, _ in stages])
        bits_stack = torch.stack([
            bits.expand(fail.shape) if isinstance(bits, torch.Tensor)
            else torch.full(fail.shape, bits, dtype=I64, device=fail.device)
            for fail, bits in stages])
        aca_counts = (fail_stack, bits_stack)
    else:
        # short-circuit: the first failing stage gives the reasons
        for fail, bits in reversed(stages):
            reason_bits = torch.where(fail, bits, reason_bits)
    n_feasible = _ax_sum(torch.sum(feasible), ax)

    # ---- score (weighted sum, generic_scheduler.go:631-639) ----
    (w_least, w_most, w_balanced, w_node_aff, w_taint, w_avoid, w_spread,
     w_interpod) = policy_weights(ps, config.most_requested)

    score = torch.zeros_like(st.alloc_cpu)

    def add(term):
        # a weighted component: into the score and, for the explain lanes,
        # into `parts` in explain_part_names order
        nonlocal score
        score = score + term
        if parts is not None:
            parts.append(torch.broadcast_to(term, score.shape))

    if w_least or w_most or w_balanced:
        total_cpu = x.nz_cpu + carry.nonzero_cpu
        total_mem = x.nz_mem + carry.nonzero_mem
    if w_least:
        # least_requested.go:41-52
        add(w_least * _fdiv(
            _ratio_score(total_cpu, st.alloc_cpu, False)
            + _ratio_score(total_mem, st.alloc_mem, False), 2))
    if w_most:
        # most_requested.go:44-55
        add(w_most * _fdiv(
            _ratio_score(total_cpu, st.alloc_cpu, True)
            + _ratio_score(total_mem, st.alloc_mem, True), 2))
    if w_balanced:
        add(w_balanced * _balanced_score(
            total_cpu, total_mem, st.alloc_cpu, st.alloc_mem))

    if w_node_aff:
        # NodeAffinityPriority: NormalizeReduce(10, False) over feasible nodes
        aff = _row(st.affinity_count, one(x.aff_id))
        aff_max = _ax_max(torch.max(torch.where(feasible, aff, 0)), ax)
        add(w_node_aff * torch.where(
            aff_max > 0, _fdiv(MAX_PRIORITY * aff, aff_max.clamp(min=1)), 0))

    if w_taint:
        # TaintTolerationPriority: NormalizeReduce(10, True) over feasible
        intol = _row(st.intolerable, one(x.tol_id))
        intol_max = _ax_max(torch.max(torch.where(feasible, intol, 0)), ax)
        add(w_taint * torch.where(
            intol_max > 0,
            MAX_PRIORITY - _fdiv(MAX_PRIORITY * intol, intol_max.clamp(min=1)),
            MAX_PRIORITY))

    if w_avoid:
        add(_row(st.avoid_score, one(x.avoid_id)) * w_avoid)

    if ps is not None and ps.has_label_prio:
        # NodeLabel/LabelPreference priorities: static pre-weighted row
        add(st.label_prio)

    if ps is not None and ps.w_image:
        # ImageLocalityPriority (image_locality.go): static per
        # (pod image set, node)
        add(_row(st.image_score, one(x.img_id)) * ps.w_image)

    if ps is not None and ps.saa_weights:
        # ServiceAntiAffinity (selector_spreading.go:176-280): spread the
        # pods my first service selects over the node groups the policy
        # label names; the reduce runs over feasible nodes, unlabeled nodes
        # score 0
        saa_row = _row(st.saa_rows, one(_row(st.saa_sig, g1)))
        saa_cnt = (saa_row.to(f64) @ carry.presence.to(f64)).to(I64)  # [N]
        saa_fcnt = torch.where(feasible, saa_cnt, 0)
        saa_total = _ax_sum(torch.sum(saa_fcnt), ax)
        saa_term = torch.zeros_like(score)
        for e, w_saa in enumerate(ps.saa_weights):
            dom = st.saa_dom[e]
            labeled = dom > 0
            grp = _ax_sum(_seg(torch.where(labeled, saa_fcnt, 0), dom,
                               config.n_saa_doms), ax)
            grp[0].fill_(0)     # a fill, not a host copy
            f_score = torch.where(
                saa_total > 0,
                _fdiv(MAX_PRIORITY * (saa_total - grp[dom]),
                      saa_total.clamp(min=1)),
                MAX_PRIORITY)
            saa_term = saa_term + torch.where(labeled, f_score, 0) * w_saa
        # the entries add up into one part
        add(saa_term)

    if config.has_services and w_spread:
        # SelectorSpreadPriority (selector_spreading.go:66-175): my
        # services' matched pods per node, then the node/zone blend over
        # feasible nodes in exact integers with one floor at the end (Go's
        # nodeScore/3 + 2*zoneScore/3)
        ss_row = _row(st.ss_rows, one(_row(st.ss_sig, g1)))
        cnt = (ss_row.to(f64) @ carry.presence.to(f64)).to(I64)     # [N]
        fcnt = torch.where(feasible, cnt, 0)
        max_node = _ax_max(torch.max(fcnt), ax)
        zdom = st.zone_dom
        zvalid = zdom > 0
        zcnt = _ax_sum(_seg(fcnt, zdom, config.n_zone_doms), ax)
        zcnt[0].fill_(0)
        have_zones = _ax_any(torch.any(feasible & zvalid), ax)
        max_zone = torch.max(zcnt)
        node_num = torch.where(max_node > 0, max_node - cnt, 1)
        node_den = max_node.clamp(min=1)
        zone_num = torch.where(max_zone > 0, max_zone - zcnt[zdom], 1)
        zone_den = max_zone.clamp(min=1)
        plain = _fdiv(MAX_PRIORITY * node_num, node_den)
        blend = _fdiv(MAX_PRIORITY * (node_num * zone_den
                                      + 2 * zone_num * node_den),
                      3 * node_den * zone_den)
        add(torch.where(have_zones & zvalid, blend, plain) * w_spread)

    if config.has_interpod and w_interpod:
        # InterPodAffinityPriority (interpod_affinity.go:118+): counts from
        # (a) my preferred terms over existing pods, (b) existing pods'
        # preferred terms over me, (c) their required affinity x the hard
        # weight
        p_w = _row(st.pref_w, g1)                                   # [Tp]
        pcount = (st.term_match[_row(st.pref_term, g1)].to(f64)
                  @ presence_f)                                     # [Tp, N]
        pdom = st.topo_dom[_row(st.pref_key, g1)]                   # [Tp, N]
        pdc_at = torch.gather(
            _ax_sum(_seg_rows(pcount, pdom, config.n_topo_doms), ax), 1, pdom)
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
        maxc = _ax_max(torch.max(torch.where(feasible, counts_i, -big)),
                       ax).clamp(min=0)
        minc = _ax_min(torch.min(torch.where(feasible, counts_i, big)),
                       ax).clamp(max=0)
        rng = maxc - minc
        ip = torch.where(rng > 0, _fdiv(MAX_PRIORITY * (counts_i - minc),
                                        rng.clamp(min=1)), 0)
        add(ip * w_interpod)

    return feasible, reason_bits, score, n_feasible, aca_counts


_INT32_MAX = (1 << 31) - 1


def _select(feasible, score, n_feasible, rr, shard: Optional[Shard] = None):
    """selectHost (generic_scheduler.go:183-198): stable descending order
    and round-robin over the max-score ties; rr is consumed only when more
    than one node passed the filter (scheduleOne returns a lone feasible
    node directly, :176-180).

    With `shard` the same selection runs over every rank's block: the tie
    threshold is a max over the group, each rank's tie count lands in its
    own slot of a zero [S] vector that one sum gathers (the total and the
    ties of the ranks before this one), each rank ranks its ties from that
    offset, so `rank == k` fires on one node of the whole axis, and the
    owner publishes its global index through a min (the others offer
    int32's largest). The choice is the single-device scan's, on every
    rank."""
    masked = torch.where(feasible, score, -1)
    max_score = _ax_max(torch.max(masked), shard)
    tie = feasible & (masked == max_score)
    if shard is None:
        ties = torch.sum(tie).clamp(min=1)
    else:
        slots = torch.arange(shard.size, device=tie.device)
        per_rank = _ax_sum(torch.where(slots == shard.rank, torch.sum(tie),
                                       0), shard)                    # [S]
        ties = torch.sum(per_rank).clamp(min=1)
    k = torch.where(n_feasible > 1, torch.remainder(rr, ties), 0)
    rank = torch.cumsum(tie.to(I64), dim=0) - 1
    if shard is not None:
        rank = rank + torch.sum(torch.where(slots < shard.rank, per_rank, 0))
    pick = tie & (rank == k)
    choice = torch.argmax(pick.to(torch.int32)).to(torch.int32)
    if shard is not None:
        choice = _ax_min(torch.where(torch.any(pick), shard.base + choice,
                                     _INT32_MAX).to(torch.int32), shard)
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


def _pod_layout(n_scalars: int):
    """Where each PodX field sits in the packed int64 matrix of the pods'
    columns: ({name: (first column, width)}, total width); req_scalar
    spreads over its n_scalars columns."""
    at, lo = {}, 0
    for name in PodX._fields:
        width = n_scalars if name == "req_scalar" else 1
        at[name] = (lo, width)
        lo += width
    return at, lo


def _pack_pods(xs: PodX) -> torch.Tensor:
    """The pods' columns as one [..., P, F] int64 matrix (_pod_layout)."""
    return torch.cat([col.to(I64) if name == "req_scalar"
                      else col.to(I64)[..., None]
                      for name, col in zip(PodX._fields, xs)], dim=-1)


def _unpacker(n_scalars: int):
    """A function from a packed row [..., F] to a PodX of views ([...]
    each, req_scalar [..., S])."""
    at, _ = _pod_layout(n_scalars)

    def unpack(row) -> PodX:
        fields = {}
        for name, (lo, width) in at.items():
            v = row[..., lo:lo + width] if name == "req_scalar" else row[..., lo]
            fields[name] = v != 0 if name in _BOOL_FIELDS else v
        return PodX(**fields)

    return unpack


class ScanOutputs(NamedTuple):
    choices: torch.Tensor    # [P] int32
    counts: torch.Tensor     # [P, bits] int32
    advanced: torch.Tensor   # [P] bool


def _outputs(lead: tuple, num_bits: int, dev) -> ScanOutputs:
    return ScanOutputs(
        choices=torch.empty(lead, dtype=torch.int32, device=dev),
        counts=torch.empty(lead + (num_bits,), dtype=torch.int32, device=dev),
        advanced=torch.empty(lead, dtype=torch.bool, device=dev))


class ExplainLanes(NamedTuple):
    """The explain lanes of a scan, a row a pod: the top k nodes by final
    score, best first (equal scores lower index first, as jax.lax.top_k
    lists them), with their scores and score parts. An infeasible node
    scores 2 * EXPLAIN_SENTINEL, so fewer than k feasible nodes leave
    padding rows at or below the sentinel."""
    top_idx: torch.Tensor     # [P, k] int32
    top_scores: torch.Tensor  # [P, k] int64
    top_parts: torch.Tensor   # [P, k, C] int64, C = len(explain_part_names)


def _explain_lanes(config: EngineConfig, num_pods: int, num_nodes: int,
                   dev) -> Optional[ExplainLanes]:
    """The lanes' buffers of a scan under `config` (None when explain_k is
    0): k = min(explain_k, nodes)."""
    if config.explain_k <= 0:
        return None
    k = min(config.explain_k, num_nodes)
    c = len(explain_part_names(config))
    return ExplainLanes(
        top_idx=torch.empty((num_pods, k), dtype=torch.int32, device=dev),
        top_scores=torch.empty((num_pods, k), dtype=I64, device=dev),
        top_parts=torch.zeros((num_pods, k, c), dtype=I64, device=dev))


_I64_MIN = -(1 << 63)


def _top_k_first(values, k: int):
    """The indices of the k largest values, equal values lower index first:
    k rounds of a first-occurrence argmax, each pick then set below every
    value (torch.topk promises no order among ties)."""
    work = values.clone()
    picks = []
    for _ in range(k):
        i = torch.argmax(work).reshape(1)
        picks.append(i)
        work.index_fill_(0, i, _I64_MIN)
    return torch.cat(picks)


def make_step(config: EngineConfig, st: Statics, pods, carry: Carry,
              out: ScanOutputs, t1, lanes: Optional[ExplainLanes] = None,
              shard: Optional[Shard] = None):
    """The exact sequential step over device-held state: step() takes pod
    t1 (a one-element int64 counter on the device) from `pods`, the packed
    [P, F] columns (_pack_pods), binds it into `carry` in place, writes its
    row of `out` (and of `lanes`, the explain lanes, where given) and
    advances t1. Nothing in it reads the device from the host, so a block
    of steps can be captured in a CUDA graph.

    With `shard` (the node-sharded route) `st` and the carry's node columns
    are this rank's block; the reductions are all_reduces over the shard's
    group, the choice is a global node index on every rank, only its owner
    binds it into the node columns, and the replicated presence_dom takes
    the owner's domain column through a sum. The outputs are the same on
    every rank."""
    const = _Const(config, st)
    unpack = _unpacker(st.alloc_scalar.shape[-1])
    group_bound = (config.has_ports or config.has_services
                   or config.has_interpod or config.has_disk_conflict)
    sa_on = config.policy is not None and config.policy.sa_enabled

    def step():
        x = unpack(pods.index_select(0, t1)[0])
        g1 = x.group_id.reshape(1)
        parts = [] if lanes is not None else None
        feasible, reason_bits, score, n_feasible, aca_counts = _evaluate(
            config, carry, st, x, g1, const, parts, shard)
        choice, found = _select(feasible, score, n_feasible, carry.rr, shard)
        advanced = n_feasible > 1

        if shard is None:
            bind = found
            idx1 = choice.clamp(min=0).to(I64).reshape(1)
        else:
            local = choice.to(I64) - shard.base
            bind = found & (local >= 0) & (local < shard.n_local)
            idx1 = local.clamp(0, shard.n_local - 1).reshape(1)
        gate = bind.to(I64)
        gate32 = bind.to(torch.int32).reshape(1)
        if group_bound:
            n = carry.presence.shape[1]
            carry.presence.view(-1).index_add_(0, g1 * n + idx1, gate32)
        if config.has_maxpd:
            cur = carry.used_vols.index_select(0, idx1)
            row = torch.where(bind, cur | st.vol_mask.index_select(0, g1),
                              cur)
            carry.used_vols.index_copy_(0, idx1, row)
        if config.has_interpod:
            _, k_count, d_count = carry.presence_dom.shape
            dom_at = st.topo_dom.index_select(1, idx1)[:, 0]           # [K]
            add = gate32
            if shard is not None:
                # every rank applies the owner's domain column
                dom_at = _ax_sum(torch.where(bind, dom_at, 0), shard)
                add = found.to(torch.int32).reshape(1)
            flat = (g1 * k_count + const.keys) * d_count + dom_at
            carry.presence_dom.view(-1).index_add_(
                0, flat, add.expand(k_count))
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

        hist = _ax_sum(_aca_histogram(aca_counts, const)
                       if aca_counts is not None
                       else _reason_histogram(reason_bits, const), shard)
        out.choices.index_copy_(0, t1, choice.reshape(1))
        out.counts.index_copy_(
            0, t1, torch.where(found, const.no_counts, hist)[None])
        out.advanced.index_copy_(0, t1, advanced.reshape(1))
        if lanes is not None:
            masked = torch.where(feasible, score, 2 * EXPLAIN_SENTINEL)
            top = _top_k_first(masked, lanes.top_idx.shape[1])
            lanes.top_idx.index_copy_(0, t1, top.to(torch.int32)[None])
            lanes.top_scores.index_copy_(0, t1,
                                         masked.index_select(0, top)[None])
            if parts:
                lanes.top_parts.index_copy_(
                    0, t1, torch.stack(parts).index_select(1, top).T[None])
        t1.add_(1)

    return step


# CUDA graphs the scans captured this process (_Steps), read by the
# analytics plane's count of built programs
_GRAPHS = {"captured": 0}
# one capture at a time in the process: torch.cuda.graph synchronizes the
# whole device and empties the allocator's cache before it captures, which
# another thread's capture in flight cannot survive. Captures run in
# "thread_local" mode, so a thread that is not capturing (a second twin's
# eager steps, allocations and event waits on the legacy stream, which
# never syncs with the non-blocking capture stream) goes on meanwhile
_CAPTURE_LOCK = threading.Lock()


def graphs_captured() -> int:
    return _GRAPHS["captured"]


class _Steps:
    """Runs a step over a batch of pods: t1 reset to 0, then `count` steps.
    With graph_steps > 0 on a CUDA device, blocks of graph_steps steps
    replay one CUDA graph, captured on the first run of at least
    graph_steps steps after one eager step that warms up every operation;
    the steps left over run eagerly. The graph reads and writes the step's
    buffers where they lie, so a later run over new contents of the same
    buffers replays it as it is."""

    def __init__(self, step, t1, graph_steps: int):
        self.step, self.t1 = step, t1
        self.graph_steps = graph_steps if t1.device.type == "cuda" else 0
        self.graph = None

    def run(self, count: int):
        step, g = self.step, self.graph_steps
        self.t1.zero_()
        done = 0
        if g > 0 and count >= g:
            if self.graph is None:
                step()
                done = 1
                graph = torch.cuda.CUDAGraph()
                with _CAPTURE_LOCK:
                    torch.cuda.synchronize(self.t1.device)
                    with torch.cuda.graph(graph,
                                          capture_error_mode="thread_local"):
                        for _ in range(g):
                            step()
                    _GRAPHS["captured"] += 1
                self.graph = graph
            blocks = (count - done) // g
            for _ in range(blocks):
                self.graph.replay()
            done += blocks * g
        for _ in range(count - done):
            step()


def schedule_scan(config: EngineConfig, carry: Carry, statics: Statics,
                  xs: PodX, graph_steps: int = 0,
                  shard: Optional[Shard] = None):
    """Every pod of `xs` in order: (final_carry, choices int32 [P], counts
    int32 [P, bits], advanced bool [P]), all on the statics' device, and
    with config.explain_k > 0 a fifth element, the ExplainLanes.
    `carry` is left as it was (the scan binds into a copy).

    graph_steps > 0 on a CUDA device captures that many steps in one CUDA
    graph and replays it over the batch (the steps left over, and the
    first, run eagerly): one launch a block instead of a few hundred a pod,
    the same operations in the same order. `shard` runs the node-sharded
    step (make_step; the carry and statics are this rank's block)."""
    carry = Carry(*(t.clone() for t in carry))
    num_pods = xs.req_cpu.shape[0]
    dev = statics.alloc_cpu.device
    out = _outputs((num_pods,), NUM_FIXED_BITS + statics.alloc_scalar.shape[-1],
                   dev)
    lanes = _explain_lanes(config, num_pods, statics.alloc_cpu.shape[0], dev)
    t1 = torch.zeros(1, dtype=I64, device=dev)
    step = make_step(config, statics, _pack_pods(xs), carry, out, t1, lanes,
                     shard)
    _Steps(step, t1, graph_steps).run(num_pods)
    if lanes is not None:
        return (carry,) + tuple(out) + (lanes,)
    return (carry,) + tuple(out)


# req_cpu of a pod row padded on: past any allocatable, so it fails
# PodFitsResources on every node, binds nothing and leaves rr as it was
GHOST_CPU = 1 << 61


def pad_infeasible_rows(xs: PodX, pad: int) -> PodX:
    """`xs` (host numpy columns) with `pad` rows appended that fit no node
    (req_cpu = GHOST_CPU, every other column 0): no bind, no rr advance.
    Under a policy without a resource predicate such a row can fit, so
    callers put them after every real pod."""
    if pad <= 0:
        return xs

    def pad_field(name, arr):
        arr = np.asarray(arr)
        fill = np.int64(GHOST_CPU) if name == "req_cpu" else 0
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, widths, constant_values=fill)

    return PodX(*(pad_field(name, arr)
                  for name, arr in zip(PodX._fields, xs)))


def schedule_scan_chunked(config: EngineConfig, carry: Carry,
                          statics: Statics, xs_host: PodX, chunk: int,
                          graph_steps: int = 0,
                          shard: Optional[Shard] = None):
    """The exact sequential scan over a pod batch in chunks of `chunk` pods,
    so that only one chunk of the pods' columns lies on the device at a
    time: (final_carry on the statics' device, choices [P], counts [P, bits]
    and advanced [P] as numpy arrays), bit-identical to schedule_scan.
    `carry` is left as it was.

    xs_host holds the pods' columns as host numpy arrays
    (pod_columns_to_host). The carry crosses chunk boundaries untouched. The
    last chunk is padded with rows that fit no node (pad_infeasible_rows),
    so every chunk runs one step over the same buffers, and on a CUDA
    device one captured graph (graph_steps) serves every chunk. There,
    while chunk t runs, chunk t+1's columns upload from pinned host memory
    on a side stream. `shard` runs the node-sharded step, as
    schedule_scan."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk}: need at least 1 pod a chunk")
    if config.explain_k > 0:
        raise ValueError("the chunked scan carries no explain lanes; run "
                         "schedule_scan")
    p = int(np.asarray(xs_host.req_cpu).shape[0])
    pad = (-p) % chunk
    host = _pack_pods(PodX(*(torch.from_numpy(np.asarray(col))
                             for col in pad_infeasible_rows(xs_host, pad))))
    num_chunks = host.shape[0] // chunk
    dev = statics.alloc_cpu.device
    cuda = dev.type == "cuda"
    carry = Carry(*(t.clone() for t in carry))
    num_bits = NUM_FIXED_BITS + statics.alloc_scalar.shape[-1]
    out = _outputs((chunk,), num_bits, dev)
    every = _outputs((p + pad,), num_bits, dev)
    pods = torch.empty((chunk, host.shape[1]), dtype=I64, device=dev)
    t1 = torch.zeros(1, dtype=I64, device=dev)
    steps = _Steps(make_step(config, statics, pods, carry, out, t1,
                             shard=shard), t1, graph_steps)
    if cuda:
        host = host.pin_memory()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        staging = torch.empty_like(pods)
        ready, consumed = torch.cuda.Event(), torch.cuda.Event()

    def upload(ci):
        # chunk ci's columns into the staging buffer, on the side stream,
        # once the previous chunk has left it
        with torch.cuda.stream(side):
            side.wait_event(consumed)
            staging.copy_(host[ci * chunk:(ci + 1) * chunk],
                          non_blocking=True)
            ready.record(side)

    if cuda:
        upload(0)
    for ci in range(num_chunks):
        if cuda:
            main.wait_event(ready)
            pods.copy_(staging)
            consumed.record(main)
            if ci + 1 < num_chunks:
                upload(ci + 1)
        else:
            pods.copy_(host[ci * chunk:(ci + 1) * chunk])
        steps.run(chunk)
        for dst, src in zip(every, out):
            dst[ci * chunk:(ci + 1) * chunk].copy_(src)
    choices, counts, advanced = (t[:p].cpu().numpy() for t in every)
    return carry, choices, counts, advanced


# ---------------------------------------------------------------------------
# The node-sharded route: the same step over a mesh's "node" axis. Each
# process holds a contiguous block of the node axis (padded to a multiple of
# the shard count, sharding.pad_node_axis) and every pod's columns; the
# reductions and the selection merge through the collectives threaded above,
# so the choices are the single-device scan's on every rank. The collectives
# are torch.distributed all_reduces, which a CUDA graph cannot capture under
# gloo (the one backend that runs several ranks on one card), so the sharded
# step always runs eagerly.


def node_partition_specs(axis: str = "node"):
    """(Statics, Carry, PodX) trees of partition-spec tuples for the
    node-sharded route, from the axis registries: a "node" axis maps to the
    mesh axis, every other axis (group tables, presence_dom, the pods'
    columns) is whole on every rank (None; () for a scalar)."""

    def tree(cls, registry):
        return cls(*(tuple(axis if a == "node" else None
                           for a in registry[f]) for f in cls._fields))

    # the pods' columns carry a leading pod axis ahead of their registry
    # axes; every rank holds them whole
    return (tree(Statics, STATICS_AXES), tree(Carry, CARRY_AXES),
            PodX(*(() for _ in PodX._fields)))


def shard_route_eligible(config: EngineConfig):
    """(ok, reason): the features the sharded route cannot serve.
    ServiceAffinity reads node columns at a global locked index, and the
    explain lanes take a per-node top-k with no merge across ranks; both
    take the single-device scan, counted under the reason."""
    ps = config.policy
    if ps is not None and (ps.sa_enabled or ps.sa_slots):
        return False, "service_affinity"
    if config.explain_k > 0:
        return False, "explain_lanes"
    return True, ""


def mesh_shard(mesh, n_local: int, axis: str = "node") -> Shard:
    """This process's Shard of a DeviceMesh's `axis`, whose blocks hold
    n_local nodes."""
    rank = mesh.get_local_rank(axis)
    return Shard(group=mesh.get_group(axis), rank=rank,
                 size=mesh.size(mesh.mesh_dim_names.index(axis)),
                 n_local=n_local, base=rank * n_local)


def sharded_scan_fn(config: EngineConfig, mesh, chunk: int = 0):
    """The node-sharded scan over a DeviceMesh's config.shard_axis:
    fn(carry, statics, xs) -> (final_carry, choices, counts, advanced) as
    schedule_scan gives them, with the carry and statics this rank's block
    (sharding.shard_for_mesh) and xs every pod, and the final carry this
    rank's block; choices, counts and advanced are the same on every rank.
    chunk > 0 runs schedule_scan_chunked over host columns in chunks of
    that many pods (its outputs numpy, as there). The step runs eagerly:
    gloo's collectives cannot be captured in a CUDA graph."""
    if config.shard_axis is None:
        raise ValueError("sharded_scan_fn requires config.shard_axis")
    ok, why = shard_route_eligible(config)
    if not ok:
        raise ValueError(f"sharded route cannot serve this config: {why}")

    def fn(carry: Carry, statics: Statics, xs: PodX):
        shard = mesh_shard(mesh, statics.alloc_cpu.shape[0],
                           config.shard_axis)
        if chunk > 0:
            return schedule_scan_chunked(config, carry, statics, xs, chunk,
                                         shard=shard)
        return schedule_scan(config, carry, statics, xs, shard=shard)

    return fn


# ---------------------------------------------------------------------------
# The batched exact scan: S scenarios stacked on a leading axis of every
# field, scheduled in lockstep, pod t of every scenario in step t. The
# filter, score and select of one step are one torch.func.vmap of _evaluate
# and _select over the scenario axis, and the bind scatters into flattened
# views at offsets s * N, so a step launches the same kernels whatever S is.

# the _Const fields that depend on a scenario's statics
_CONST_PER_SCENARIO = ("vol_type", "key_oh", "key_oh_p", "key_oh_a")


def _batched_const(config: EngineConfig, st_b: Statics) -> _Const:
    """_Const over stacked statics: the fields of _CONST_PER_SCENARIO carry
    the leading scenario axis, the rest are the scenarios' shared ones."""
    const = _Const(config, Statics(*(t[0] for t in st_b)))
    if config.has_maxpd:
        const.vol_type = st_b.vol_type.to(torch.float64)
    if config.has_interpod:
        k = st_b.topo_dom.shape[1]
        for name, key in (("key_oh", st_b.anti_key), ("key_oh_p", st_b.pref_key),
                          ("key_oh_a", st_b.aff_key)):
            setattr(const, name,
                    torch.nn.functional.one_hot(key, k).to(torch.float64))
    return const


class BatchedScan:
    """The batched exact scan as a built program: device buffers for S
    scenarios' statics, initial carries and pod columns (a leading scenario
    axis on every field, the scenarios unified to one shape), the step over
    all of them, and, on a CUDA device with graph_steps > 0, its captured
    graph. load() copies another batch of the same shapes into the buffers;
    run() schedules the loaded batch from its initial carries. The graph is
    bound to the buffers' addresses, so loading copies and never rebinds.

    rr, the tie pick and the bind are each scenario's own; every scenario
    gives what schedule_scan gives it alone.

    With `shard` (the what-if's ("snap", "node") route on a node axis of
    several ranks) the node columns are this rank's block, every reduction
    of the vmapped evaluate and select is one all_reduce for all S
    scenarios (Shard.vmapped), and the bind is make_step's: the owner of a
    global choice binds it, presence_dom takes the owner's domain through
    a sum, sa_lock holds the global index. gloo's collectives cannot be
    captured, so such a step always runs eagerly."""

    def __init__(self, config: EngineConfig, carries: Carry,
                 statics_b: Statics, xs_b: PodX, graph_steps: int = 0,
                 shard: Optional[Shard] = None):
        self.config = config
        self.shard = shard
        if shard is not None:
            graph_steps = 0
        self.statics = Statics(*(torch.empty_like(t) for t in statics_b))
        self.carry0 = Carry(*(torch.empty_like(t) for t in carries))
        self.carry = Carry(*(torch.empty_like(t) for t in carries))
        s, p = xs_b.req_cpu.shape
        dev = self.statics.alloc_cpu.device
        n_scal = statics_b.alloc_scalar.shape[-1]
        self.pods = torch.empty((s, p, _pod_layout(n_scal)[1]), dtype=I64,
                                device=dev)
        self.out = _outputs((s, p), NUM_FIXED_BITS + n_scal, dev)
        self.const = None
        self.load(carries, statics_b, xs_b)
        t1 = torch.zeros(1, dtype=I64, device=dev)
        self._steps = _Steps(self._make_step(t1), t1, graph_steps)

    def load(self, carries: Carry, statics_b: Statics, xs_b: PodX):
        """Copy a batch of the program's shapes into its buffers."""
        for dst, src in zip(self.statics, statics_b):
            dst.copy_(src)
        for dst, src in zip(self.carry0, carries):
            dst.copy_(src)
        self.pods.copy_(_pack_pods(xs_b))
        fresh = _batched_const(self.config, self.statics)
        if self.const is None:
            self.const = fresh
        else:
            for name in _CONST_PER_SCENARIO:
                if hasattr(fresh, name):
                    getattr(self.const, name).copy_(getattr(fresh, name))

    def run(self):
        """Schedule the loaded batch: (choices int32 [S, P], counts int32
        [S, P, bits]), the program's own output buffers on its device (the
        next run overwrites them)."""
        for dst, src in zip(self.carry, self.carry0):
            dst.copy_(src)
        self._steps.run(self.pods.shape[1])
        return self.out.choices, self.out.counts

    def _make_step(self, t1):
        config, st, carry, out = self.config, self.statics, self.carry, self.out
        const = self.const
        unpack = _unpacker(st.alloc_scalar.shape[-1])
        per_names = [n for n in _CONST_PER_SCENARIO if hasattr(const, n)]
        shared = {k: v for k, v in vars(const).items() if k not in per_names}
        shard = self.shard
        vshard = shard._replace(vmapped=True) if shard is not None else None

        def one(carry_s, st_s, x, per):
            view = SimpleNamespace(**shared, **per)
            g1 = x.group_id.reshape(1)
            feasible, reason_bits, score, n_feasible, aca_counts = _evaluate(
                config, carry_s, st_s, x, g1, view, shard=vshard)
            choice, found = _select(feasible, score, n_feasible, carry_s.rr,
                                    vshard)
            hist = _ax_sum(_aca_histogram(aca_counts, view)
                           if aca_counts is not None
                           else _reason_histogram(reason_bits, view), vshard)
            return (choice, found, n_feasible > 1,
                    torch.where(found, view.no_counts, hist))

        evaluate = torch.func.vmap(one)
        s, n = st.alloc_cpu.shape
        g_count = carry.presence.shape[1]
        n_scal = st.alloc_scalar.shape[-1]
        dev = st.alloc_cpu.device
        s_ids = torch.arange(s, device=dev)
        keys = torch.arange(carry.presence_dom.shape[2], device=dev)
        group_bound = (config.has_ports or config.has_services
                       or config.has_interpod or config.has_disk_conflict)
        sa_on = config.policy is not None and config.policy.sa_enabled

        def step():
            x = unpack(self.pods.index_select(1, t1)[:, 0])      # [S] each
            per = {name: getattr(const, name) for name in per_names}
            choice, found, advanced, counts = evaluate(carry, st, x, per)
            g = x.group_id
            if shard is None:
                bind = found
                idx = choice.clamp(min=0).to(I64)
            else:
                # a global choice: its owner binds it at its local row
                local = choice.to(I64) - shard.base
                bind = found & (local >= 0) & (local < n)
                idx = local.clamp(0, n - 1)
            node = s_ids * n + idx          # rows of the [S * N, ...] views
            gate = bind.to(I64)
            gate32 = bind.to(torch.int32)
            if group_bound:
                carry.presence.view(-1).index_add_(
                    0, (s_ids * g_count + g) * n + idx, gate32)
            if config.has_maxpd:
                v = carry.used_vols.shape[-1]
                used = carry.used_vols.view(s * n, v)
                cur = used.index_select(0, node)
                mask = st.vol_mask.view(s * g_count, v).index_select(
                    0, s_ids * g_count + g)
                used.index_copy_(0, node, torch.where(bind[:, None],
                                                      cur | mask, cur))
            if config.has_interpod:
                _, _, k_count, d_count = carry.presence_dom.shape
                dom_at = st.topo_dom.gather(
                    2, idx.view(s, 1, 1).expand(s, k_count, 1))[:, :, 0]
                add = gate32
                if shard is not None:
                    # every rank applies the owner's domain column (one
                    # all_reduce for the S scenarios)
                    dom_at = _ax_sum(torch.where(bind[:, None], dom_at, 0),
                                     shard)
                    add = found.to(torch.int32)
                flat = (((s_ids * g_count + g)[:, None] * k_count
                         + keys[None, :]) * d_count + dom_at)
                carry.presence_dom.view(-1).index_add_(
                    0, flat.reshape(-1),
                    add[:, None].expand(s, k_count).reshape(-1))
            if sa_on:
                f_count = st.saa_rows.shape[1]
                match_f = st.saa_rows.gather(
                    2, g.view(s, 1, 1).expand(s, f_count, 1))[:, :, 0]
                # the global index, on every rank
                carry.sa_lock.copy_(torch.where(
                    (carry.sa_lock == -1) & match_f & found[:, None],
                    choice.clamp(min=0).to(torch.int32)[:, None],
                    carry.sa_lock))
            for name, req in (("used_cpu", x.req_cpu),
                              ("used_mem", x.req_mem),
                              ("used_gpu", x.req_gpu),
                              ("used_eph", x.req_eph),
                              ("nonzero_cpu", x.nz_cpu),
                              ("nonzero_mem", x.nz_mem), ("pod_count", 1)):
                getattr(carry, name).view(-1).index_add_(0, node, gate * req)
            carry.used_scalar.view(s * n, n_scal).index_add_(
                0, node, gate[:, None] * x.req_scalar)
            carry.rr.add_(advanced.to(I64))
            out.choices.index_copy_(1, t1, choice[:, None])
            out.counts.index_copy_(1, t1, counts[:, None])
            out.advanced.index_copy_(1, t1, advanced[:, None])
            t1.add_(1)

        return step


def schedule_scan_batched(config: EngineConfig, carries: Carry,
                          statics_b: Statics, xs_b: PodX,
                          graph_steps: int = 0):
    """S scenarios stacked on a leading axis, each scanned over its pods as
    schedule_scan would: (choices int32 [S, P], counts int32 [S, P, bits])
    on the statics' device. The scenarios share one shape (whatif unifies
    them) and one EngineConfig."""
    return BatchedScan(config, carries, statics_b, xs_b, graph_steps).run()


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


# ---------------------------------------------------------------------------
# The streaming twin's device programs (stream.runtime): the resident scan
# and the O(delta) commits that patch its tensors in place between cycles.
#
# The host (delta.IncrementalCluster) stays the source of truth: after
# folding a cycle's watch events it gathers the authoritative post-event
# values of every touched node row and presence cell, and the commit SETS
# them into the resident carry. Setting authoritative values (not adding a
# delta) makes a commit idempotent: the device cannot drift from the host
# columns it syncs. presence_dom and used_vols have no commit path; the
# twin restages whenever a config that reads them (inter-pod terms, MaxPD)
# sees presence or volume churn.


def _on(a, like: torch.Tensor) -> torch.Tensor:
    """`a` (a numpy array or a tensor) on `like`'s device, in its dtype."""
    return torch.as_tensor(a, device=like.device).to(like.dtype)


class DeltaRows(NamedTuple):
    """Authoritative post-event dynamic values of the committed node rows,
    gathered from the host columns: [U] each, used_scalar [U, S]."""

    used_cpu: object
    used_mem: object
    used_gpu: object
    used_eph: object
    used_scalar: object
    nonzero_cpu: object
    nonzero_mem: object
    pod_count: object


def _in_block(shard: Optional[Shard], node_idx):
    """(keep, local): which entries of the global node indices `node_idx`
    (host numpy) fall in this rank's block of the node axis, and those
    entries shifted by the block's base; with no shard every entry, as it
    is (keep None)."""
    idx = np.asarray(node_idx)
    if shard is None:
        return None, idx
    keep = (idx >= shard.base) & (idx < shard.base + shard.n_local)
    return keep, idx[keep] - shard.base


def _kept(a, keep, axis: int = 0):
    """The `keep` entries of host array `a` along `axis` (all of it for
    keep None)."""
    return a if keep is None else np.compress(keep, np.asarray(a), axis=axis)


def _set_rows_(carry: Carry, node_idx, rows: DeltaRows, pres_gid, pres_nid,
               pres_val, shard: Optional[Shard] = None) -> None:
    # "set" semantics, no accumulation: the bucket padding repeats a real
    # row (or cell) with the same authoritative value, so whichever copy of
    # a duplicate index lands last writes the same bytes. On a rank of the
    # node-sharded twin only the rows and cells of its block are set
    keep, local = _in_block(shard, node_idx)
    idx = _on(local, carry.rr)
    for name in DeltaRows._fields:
        dst = getattr(carry, name)
        dst.index_copy_(0, idx, _on(_kept(getattr(rows, name), keep), dst))
    keep, nid = _in_block(shard, pres_nid)
    carry.presence.index_put_(
        (_on(_kept(pres_gid, keep), carry.rr), _on(nid, carry.rr)),
        _on(_kept(pres_val, keep), carry.presence))


def apply_delta_(carry: Carry, node_idx, rows: DeltaRows, pres_gid,
                 pres_nid, pres_val, sa_lock_init,
                 shard: Optional[Shard] = None) -> None:
    """Commit a cycle's delta into the resident `carry` in place: set the
    rows `node_idx` and the presence cells (pres_gid, pres_nid), then re-arm
    the per-batch lanes as carry_init_host arms a restage's carry (sa_lock to
    `sa_lock_init`: all unlocked for a provider, the live first-matching-pod
    pins under a ServiceAffinity policy; rr to 0), so that a stream cycle
    and a restage cycle scan from equal carries. The indices are global
    node indices; with `shard` (a rank of the node-sharded twin, whose
    carry holds its block) only the rows and cells in the block are set,
    and the replicated lanes the same way on every rank."""
    _set_rows_(carry, node_idx, rows, pres_gid, pres_nid, pres_val, shard)
    carry.sa_lock.copy_(_on(sa_lock_init, carry.sa_lock))
    carry.rr.zero_()


def overlay_restore_(carry: Carry, node_idx, rows: DeltaRows, pres_gid,
                     pres_nid, pres_val, sa_lock_save, rr_save,
                     shard: Optional[Shard] = None) -> None:
    """Roll an overlay query back in place: the same authoritative set over
    the nodes the query bound, and the per-batch lanes restored from the
    copies taken before the query (not re-armed), so the carry after it is
    bit-equal to the carry before. `shard` as apply_delta_'s."""
    _set_rows_(carry, node_idx, rows, pres_gid, pres_nid, pres_val, shard)
    carry.sa_lock.copy_(_on(sa_lock_save, carry.sa_lock))
    carry.rr.copy_(_on(rr_save, carry.rr))


class StaticsDelta(NamedTuple):
    """Authoritative post-churn statics columns of the churned nodes: one
    column slice a table whose cells depend on node labels or taints. The
    leading (signature or policy row) axes are the resident tables'; the
    last is the padded churn bucket U (label_prio is [U])."""

    selector_ok: object
    taint_ok: object
    taint_ok_noexec: object
    intolerable: object
    affinity_count: object
    avoid_score: object
    host_ok: object
    label_ok: object
    label_prio: object
    image_score: object
    saa_dom: object
    sa_val: object


def apply_statics_delta_(statics: Statics, node_idx, d: StaticsDelta,
                         shard: Optional[Shard] = None) -> None:
    """Set the churned nodes' columns of the resident statics in place.
    Label and taint churn moves only per-(signature, node) and per-(policy
    row, node) cells; every other table is node-structural or group-derived
    and restages instead. Duplicate padded indices carry equal columns.
    `shard` as apply_delta_'s: only the columns of the block are set."""
    keep, local = _in_block(shard, node_idx)
    idx = _on(local, statics.alloc_cpu)
    for name in StaticsDelta._fields:
        dst = getattr(statics, name)
        axis = 0 if name == "label_prio" else 1
        dst.index_copy_(axis, idx, _on(_kept(getattr(d, name), keep, axis),
                                       dst))


# the buckets the resident scans ran on the fused route this process, and
# the kernel launches they made: one a step, so the buckets' steps
# (ResidentScan.run), beside graphs_captured
_FUSED = {"buckets": 0, "launches": 0}


def fused_buckets() -> int:
    return _FUSED["buckets"]


def fused_launches() -> int:
    return _FUSED["launches"]


def fused_step_eligible(config: EngineConfig, shard: Optional[Shard],
                        device, n_nodes: int, n_scalars: int) -> bool:
    """Whether a resident scan takes the fused step (one launch of
    csrc/resident_step.cu a step) in place of make_step: on a CUDA device,
    unsharded, without a policy and without any pod-group feature (the
    v1.10 DefaultProvider's group-free step), within the kernel's node axis
    and scalar resources. Every other configuration runs make_step."""
    return (torch.device(device).type == "cuda" and shard is None
            and config.policy is None
            and not (config.has_ports or config.has_services
                     or config.has_interpod or config.has_disk_conflict
                     or config.has_maxpd or config.has_vol_zone)
            and n_nodes <= MAX_NODES and n_scalars <= MAX_SCALARS)


class ResidentScan:
    """The exact scan over the streaming twin's resident tensors, as a
    built program for one pod bucket: the step bound to the resident
    `carry` and `statics` and to buffers of its own for the bucket's packed
    pod columns and outputs.

    The step is one of two routes, chosen when the program is built
    (`route`): "fused_step", one launch of the hand-written kernel a step
    (kernels/resident_step.py), where fused_step_eligible admits the
    configuration; "torch_step", make_step's torch operations, everywhere
    else. Both decide every pod alike, bit for bit.

    run() copies a bucket of pods in and scans them (_Steps: on a CUDA
    device with graph_steps > 0 its graph is captured on the first run and
    replayed from then on; the fused route captures the whole bucket in
    one graph), binding into the resident carry in place. The graph reads
    and writes the tensors where they lie, so the commits between cycles
    must patch them in place (apply_delta_, apply_statics_delta_,
    overlay_restore_): a rebinding such as carry = Carry(...) would leave
    the graph reading stale buffers.

    With `shard` the carry and statics are this rank's block of the
    node-sharded twin and the step is the sharded one (make_step's, as
    sharded_scan_fn runs it), always eager."""

    def __init__(self, config: EngineConfig, carry: Carry, statics: Statics,
                 bucket: int, graph_steps: int = 0,
                 shard: Optional[Shard] = None):
        dev = statics.alloc_cpu.device
        n_scal = statics.alloc_scalar.shape[-1]
        self.pods = torch.empty((bucket, _pod_layout(n_scal)[1]), dtype=I64,
                                device=dev)
        self.out = _outputs((bucket,), NUM_FIXED_BITS + n_scal, dev)
        t1 = torch.zeros(1, dtype=I64, device=dev)
        if fused_step_eligible(config, shard, dev, statics.alloc_cpu.shape[0],
                               n_scal):
            self.route = "fused_step"
            step = make_fused_step(config, statics, self.pods, carry,
                                   self.out, t1)
            # one launch a step: the bucket is one graph
            graph_steps = bucket if graph_steps > 0 else 0
        else:
            self.route = "torch_step"
            step = make_step(config, statics, self.pods, carry, self.out, t1,
                             shard=shard)
            # the node-sharded step (the one sharded_scan_fn runs) is
            # eager: gloo's collectives cannot be captured in a CUDA graph
            if shard is not None:
                graph_steps = 0
        self._steps = _Steps(step, t1, graph_steps)

    @property
    def graph_captured(self) -> bool:
        return self._steps.graph is not None

    def run(self, xs_host: PodX) -> ScanOutputs:
        """Scan a bucket of pods (host numpy columns, exactly the bucket's
        rows; pad_infeasible_rows pads): the outputs are the program's own
        buffers, which the next run overwrites."""
        self.pods.copy_(_pack_pods(PodX(*(torch.from_numpy(np.asarray(c))
                                          for c in xs_host))))
        self._steps.run(self.pods.shape[0])
        if self.route == "fused_step":
            _FUSED["buckets"] += 1
            _FUSED["launches"] += self.pods.shape[0]
        return self.out


# ---------------------------------------------------------------------------
# Gang admission (gang.driver): every member's feasibility and score lanes
# against one carry, and the joint packing solve over them.


class GangIn(NamedTuple):
    """The per-node columns the packing solve reads ([N] each, int64; the
    domain ids 0 = no domain)."""

    alloc_cpu: torch.Tensor
    alloc_mem: torch.Tensor
    alloc_gpu: torch.Tensor
    alloc_eph: torch.Tensor
    allowed_pods: torch.Tensor
    used_cpu: torch.Tensor
    used_mem: torch.Tensor
    used_gpu: torch.Tensor
    used_eph: torch.Tensor
    pod_count: torch.Tensor
    zone_dom: torch.Tensor
    rack_dom: torch.Tensor


def gang_columns(statics: Statics, carry: Carry, zone_dom,
                 rack_dom) -> GangIn:
    """A GangIn of the engine's statics and carry and the packing domains
    (gang.oracle.packing_domains) on their device."""
    return GangIn(
        alloc_cpu=statics.alloc_cpu, alloc_mem=statics.alloc_mem,
        alloc_gpu=statics.alloc_gpu, alloc_eph=statics.alloc_eph,
        allowed_pods=statics.allowed_pods,
        used_cpu=carry.used_cpu, used_mem=carry.used_mem,
        used_gpu=carry.used_gpu, used_eph=carry.used_eph,
        pod_count=carry.pod_count,
        zone_dom=_on(zone_dom, carry.rr), rack_dom=_on(rack_dom, carry.rr))


def gang_lanes(config: EngineConfig, carry: Carry, statics: Statics,
               xs: PodX):
    """(feasible [M, N] bool, score [M, N] int64): the scan's filter and
    score for each of the M members against the SAME carry, one
    torch.func.vmap of _evaluate over the member axis (no loop over the
    members). Only the two lanes the packing solve reads come back: a
    rejected gang's text is the driver's shared FitError, not a per-member
    reason histogram."""
    const = _Const(config, statics)

    def lanes(x: PodX):
        feasible, _bits, score, _n, _aca = _evaluate(
            config, carry, statics, x, x.group_id.reshape(1), const)
        return feasible, score

    return torch.func.vmap(lanes)(xs)


def gang_lanes_sharded(config: EngineConfig, mesh, carry: Carry,
                       statics: Statics, xs: PodX):
    """gang_lanes over a node-sharded carry and statics (this rank's block,
    sharding.shard_for_mesh): each member's filter and score run over the
    block with the step's collectives (a loop over the members: a vmap
    cannot carry an all_reduce), then the (member, node) lanes of every
    rank are put together by one all_reduce into zeros. Every rank gets
    the whole padded [M, Npad] feasible and score, equal to gang_lanes on
    the unsharded columns (a padded node is never feasible)."""
    if config.shard_axis is None:
        raise ValueError("gang_lanes_sharded requires config.shard_axis")
    shard = mesh_shard(mesh, statics.alloc_cpu.shape[0], config.shard_axis)
    const = _Const(config, statics)
    feas, scores = [], []
    for i in range(xs.req_cpu.shape[0]):
        x = PodX(*(col[i] for col in xs))
        feasible, _bits, score, _n, _aca = _evaluate(
            config, carry, statics, x, x.group_id.reshape(1), const,
            shard=shard)
        feas.append(feasible)
        scores.append(score)
    lanes = torch.stack([torch.stack(feas).to(I64), torch.stack(scores)])
    lanes = gather_nodes(shard, lanes, dim=2)          # [2, M, Npad]
    return lanes[0] != 0, lanes[1]


def gang_select(feasible, score, req_cpu, req_mem, req_gpu, req_eph,
                zero_request, gi: GangIn, n_zone: int, n_rack: int):
    """The joint greedy packing over the (member, node) lanes, on their
    device: choices [M] int32, a node index or -1. Members go in feed
    order; each placement feeds the next member's domain bonuses and
    capacity stack. The rank key is packing.encode_gang_rank and the pick
    a first-occurrence argmax, as in gang.oracle.select_oracle. The loop
    reads nothing back from the device: every member's ops queue at once."""

    m, n = feasible.shape
    dev = feasible.device
    gang = [torch.zeros(n, dtype=I64, device=dev) for _ in range(5)]
    gang_cpu, gang_mem, gang_gpu, gang_eph, gang_pods = gang
    zone_cnt = torch.zeros(n_zone, dtype=I64, device=dev)
    rack_cnt = torch.zeros(n_rack, dtype=I64, device=dev)
    zone_dom, rack_dom = gi.zone_dom.to(I64), gi.rack_dom.to(I64)
    zone_on, rack_on = zone_dom > 0, rack_dom > 0
    members = torch.arange(m, device=dev)
    choices = torch.full((m,), -1, dtype=torch.int32, device=dev)
    for i in range(m):
        check = ~zero_request[i]
        fits = (gi.pod_count + gang_pods + 1) <= gi.allowed_pods
        for alloc, used, stacked, req in (
                (gi.alloc_cpu, gi.used_cpu, gang_cpu, req_cpu[i]),
                (gi.alloc_mem, gi.used_mem, gang_mem, req_mem[i]),
                (gi.alloc_gpu, gi.used_gpu, gang_gpu, req_gpu[i]),
                (gi.alloc_eph, gi.used_eph, gang_eph, req_eph[i])):
            fits = fits & (~check | (alloc >= used + stacked + req))
        ok = feasible[i] & fits
        zone_bonus = torch.where(zone_on, zone_cnt.index_select(0, zone_dom),
                                 0)
        rack_bonus = torch.where(rack_on, rack_cnt.index_select(0, rack_dom),
                                 0)
        rank = encode_gang_rank(zone_bonus, rack_bonus, score[i], ok)
        idx1 = torch.argmax(rank).reshape(1)   # the first of the maxima
        found = rank.index_select(0, idx1) >= 0                      # [1]
        gate = found.to(I64)
        for stacked, req in ((gang_cpu, req_cpu[i]), (gang_mem, req_mem[i]),
                             (gang_gpu, req_gpu[i]), (gang_eph, req_eph[i])):
            stacked.index_add_(0, idx1, gate * req)
        gang_pods.index_add_(0, idx1, gate)
        # domain slot 0 is the "no domain" bucket: counting into it is
        # harmless, as the bonuses read it only where the domain is > 0
        zone_cnt.index_add_(0, zone_dom.index_select(0, idx1), gate)
        rack_cnt.index_add_(0, rack_dom.index_select(0, idx1), gate)
        choices.index_copy_(0, members[i:i + 1],
                            torch.where(found, idx1, -1).to(torch.int32))
    return choices


# ---------------------------------------------------------------------------
# The analytics plane's reduction (obs.analytics): integer aggregates of a
# (Statics, Carry) pair, one O(N) pass after a scan over tensors the scan
# already holds. Ratios are derived at decode on the host; the numpy mirror
# obs.analytics.host_reduce repeats these integer operations, so the two
# are compared for equality.

ANALYTICS_RESOURCES = ("cpu", "memory", "gpu", "ephemeral", "pods")
ANALYTICS_UTIL_SCALE = 1_000_000  # utilization in ppm (floor division)


class AnalyticsIn(NamedTuple):
    """The [N] node columns the reduction folds: allocatables from the
    statics, requested totals from a carry."""
    alloc_cpu: torch.Tensor
    alloc_mem: torch.Tensor
    alloc_gpu: torch.Tensor
    alloc_eph: torch.Tensor
    allowed_pods: torch.Tensor
    used_cpu: torch.Tensor
    used_mem: torch.Tensor
    used_gpu: torch.Tensor
    used_eph: torch.Tensor
    pod_count: torch.Tensor


class AnalyticsStats(NamedTuple):
    """Integer aggregates, the resource axis in ANALYTICS_RESOURCES order.
    hot_keys and cold_keys are packing.encode_topk_keys of the dominant
    cpu/memory utilization in ppm (clipped to [0, 1e6]) and of its
    complement, over the node index: unique, so their descending top-k is
    exact; a node past n_valid keys -1 and is dropped at decode."""
    alloc: torch.Tensor           # [R] allocatable totals
    used: torch.Tensor            # [R] requested totals
    free_sum: torch.Tensor        # [R] sums of per-node free (>= 0)
    free_max: torch.Tensor        # [R] the largest free slot
    headroom_nodes: torch.Tensor  # [R] nodes with free > 0
    feasible_nodes: torch.Tensor  # nodes with free cpu, memory and pods
    valid_nodes: torch.Tensor     # nodes inside n_valid
    hot_keys: torch.Tensor        # [k] hottest first
    cold_keys: torch.Tensor       # [k] coldest first


def analytics_in(statics: Statics, carry: Carry) -> AnalyticsIn:
    """The ten analytics columns of a (Statics, Carry) pair, by reference."""
    return AnalyticsIn(
        alloc_cpu=statics.alloc_cpu, alloc_mem=statics.alloc_mem,
        alloc_gpu=statics.alloc_gpu, alloc_eph=statics.alloc_eph,
        allowed_pods=statics.allowed_pods,
        used_cpu=carry.used_cpu, used_mem=carry.used_mem,
        used_gpu=carry.used_gpu, used_eph=carry.used_eph,
        pod_count=carry.pod_count)


def analytics_reduce(inp: AnalyticsIn, n_valid: int, k: int
                     ) -> AnalyticsStats:
    """The aggregates of the first n_valid nodes of `inp` (the rest are
    padding), on the columns' device, in int64: launched on the current
    stream, read nothing back. k <= the node count."""
    n = inp.alloc_cpu.shape[0]
    idx = torch.arange(n, dtype=I64, device=inp.alloc_cpu.device)
    mask = idx < n_valid
    alloc = torch.stack([inp.alloc_cpu, inp.alloc_mem, inp.alloc_gpu,
                         inp.alloc_eph, inp.allowed_pods]).to(I64)
    used = torch.stack([inp.used_cpu, inp.used_mem, inp.used_gpu,
                        inp.used_eph, inp.pod_count]).to(I64)
    alloc = torch.where(mask[None, :], alloc, 0)                    # [R, N]
    used = torch.where(mask[None, :], used, 0)
    free = (alloc - used).clamp(min=0)
    # dominant-share hotness in ppm; the operands are nonnegative, so the
    # floor division is exact
    util = torch.where(alloc[:2] > 0,
                       (used[:2] * ANALYTICS_UTIL_SCALE)
                       // alloc[:2].clamp(min=1), 0)
    score = torch.maximum(util[0], util[1]).clamp(0, ANALYTICS_UTIL_SCALE)
    hot = encode_topk_keys(score, idx, mask)
    cold = encode_topk_keys(ANALYTICS_UTIL_SCALE - score, idx, mask)
    return AnalyticsStats(
        alloc=alloc.sum(dim=1),
        used=used.sum(dim=1),
        free_sum=free.sum(dim=1),
        free_max=free.max(dim=1).values,
        headroom_nodes=(free > 0).sum(dim=1),
        feasible_nodes=((free[0] > 0) & (free[1] > 0) & (free[4] > 0)).sum(),
        valid_nodes=mask.sum(),
        hot_keys=torch.topk(hot, k).values,
        cold_keys=torch.topk(cold, k).values)


def analytics_reduce_sharded(mesh, inp: AnalyticsIn, n_valid: int, k: int,
                             axis: str = "node") -> AnalyticsStats:
    """analytics_reduce over node-sharded columns (this rank's block of a
    DeviceMesh's `axis`): each rank folds its block, its top-k keys
    carrying global node indices, then the sums and counts merge in one
    all_reduce, the maxima in another, and every rank's [k] key slots in a
    third (into zeros of [S, k]), from which the top k are taken again. The
    keys are unique (the node index breaks ties), so a key of the global
    top k is in its own rank's top k: the result equals analytics_reduce on
    the unsharded columns, on every rank. k <= the whole node count."""
    n = inp.alloc_cpu.shape[0]
    shard = mesh_shard(mesh, n, axis)
    dev = inp.alloc_cpu.device
    idx = shard.base + torch.arange(n, dtype=I64, device=dev)
    mask = idx < n_valid
    alloc = torch.stack([inp.alloc_cpu, inp.alloc_mem, inp.alloc_gpu,
                         inp.alloc_eph, inp.allowed_pods]).to(I64)
    used = torch.stack([inp.used_cpu, inp.used_mem, inp.used_gpu,
                        inp.used_eph, inp.pod_count]).to(I64)
    alloc = torch.where(mask[None, :], alloc, 0)                    # [R, N]
    used = torch.where(mask[None, :], used, 0)
    free = (alloc - used).clamp(min=0)
    util = torch.where(alloc[:2] > 0,
                       (used[:2] * ANALYTICS_UTIL_SCALE)
                       // alloc[:2].clamp(min=1), 0)
    score = torch.maximum(util[0], util[1]).clamp(0, ANALYTICS_UTIL_SCALE)
    kl = min(k, n)
    keys = torch.stack([
        torch.topk(encode_topk_keys(score, idx, mask), kl).values,
        torch.topk(encode_topk_keys(ANALYTICS_UTIL_SCALE - score, idx, mask),
                   kl).values])                                     # [2, kl]
    slots = torch.zeros((2, shard.size, kl), dtype=I64, device=dev)
    slots[:, shard.rank].copy_(keys)
    slots = _ax_sum(slots, shard).reshape(2, -1)
    r = len(ANALYTICS_RESOURCES)
    sums = _ax_sum(torch.cat([
        alloc.sum(dim=1), used.sum(dim=1), free.sum(dim=1),
        (free > 0).sum(dim=1),
        ((free[0] > 0) & (free[1] > 0) & (free[4] > 0)).sum().reshape(1),
        mask.sum().reshape(1)]), shard)
    return AnalyticsStats(
        alloc=sums[:r], used=sums[r:2 * r], free_sum=sums[2 * r:3 * r],
        free_max=_ax_max(free.max(dim=1).values, shard),
        headroom_nodes=sums[3 * r:4 * r],
        feasible_nodes=sums[4 * r], valid_nodes=sums[4 * r + 1],
        hot_keys=torch.topk(slots[0], k).values,
        cold_keys=torch.topk(slots[1], k).values)
