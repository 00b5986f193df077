"""The int32 plan of the fused fast scan: node axis padded, every resource
quantity reduced exactly to int32.

Eligibility (checked by `plan_fast`, reasons returned): the group-free
kernel variant only — no host ports, services, inter-pod (anti)affinity or
volumes, at most 6 scalar resource kinds (their failure bits ride the int32
reason word at NUM_FIXED_BITS + s), and every quantity divides by its
per-axis gcd to a value under 2^29 with the BalancedResourceAllocation
product bound 10*max_cpu*max_mem < 2^31 (the kernel is int32 throughout;
the reduced arithmetic never overflows, so the exact rational semantics of
the reference hold).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np

from tpusim_torch.config import AVOID_PODS_WEIGHT, EngineConfig
from tpusim_torch.engine.priorities import MAX_PRIORITY
from tpusim_torch.state import NUM_FIXED_BITS, CompiledCluster, PodColumns

INT_LIMIT = 1 << 29          # per-value bound after gcd reduction
GHOST_REQ = 1 << 30          # > any reduced allocatable: never feasible
PAD_SENTINEL_BIT = 30        # cond bit for padded nodes; >= last scalar bit
LANES = 128                  # node-axis padding and the misc carry row width
SCALAR_ROW_PAD = 8           # scalar carry rows are padded to a multiple of this


@dataclass
class FastPlan:
    """int32 device-ready arrays; node axis padded to a multiple of 128."""

    num_nodes: int           # real nodes (pad rows follow)
    num_pods: int
    most_requested: bool
    num_scalars: int         # scalar-resource kinds (0 = no scalar args)
    # statics [1, Npad]
    alloc_cpu: np.ndarray
    alloc_mem: np.ndarray
    alloc_gpu: np.ndarray
    alloc_eph: np.ndarray
    allowed: np.ndarray
    cond_bits: np.ndarray
    mem_pressure: np.ndarray
    disk_pressure: np.ndarray
    # signature tables [S, Npad]
    selector_ok: np.ndarray
    taint_ok: np.ndarray
    intolerable: np.ndarray
    aff_count: np.ndarray
    avoid_score: np.ndarray
    host_ok: np.ndarray
    # initial carry [1, Npad]
    used_cpu: np.ndarray
    used_mem: np.ndarray
    used_gpu: np.ndarray
    used_eph: np.ndarray
    nonzero_cpu: np.ndarray
    nonzero_mem: np.ndarray
    pod_count: np.ndarray
    # pod columns [P]
    req_cpu: np.ndarray
    req_mem: np.ndarray
    req_gpu: np.ndarray
    req_eph: np.ndarray
    nz_cpu: np.ndarray
    nz_mem: np.ndarray
    zero_request: np.ndarray
    best_effort: np.ndarray
    sel_id: np.ndarray
    tol_id: np.ndarray
    aff_id: np.ndarray
    avoid_id: np.ndarray
    host_id: np.ndarray
    # scalar resources (present when num_scalars > 0)
    alloc_scalar: Optional[np.ndarray] = None   # [Srows, Npad]
    used_scalar: Optional[np.ndarray] = None    # [Srows, Npad] init carry
    req_scalar: Optional[np.ndarray] = None     # [P, S]
    # per-axis gcds the int32 reduction divided by
    gcds: Tuple[int, int, int, int] = (1, 1, 1, 1)   # cpu, mem, gpu, eph
    scalar_gcds: Tuple[int, ...] = ()


@dataclass
class FastCarry:
    """The carry threaded through fast_scan calls: the seven [1, Npad] node
    rows, the rr misc row and the optional scalar rows. Arrays may be numpy
    (the plan's initial state) or torch tensors (a previous call's carry)."""

    rows: list               # [used_c, used_m, used_g, used_e, nz_c, nz_m, pc]
    misc: object             # [1, LANES] int32; rr at [0, 0]
    scal: Optional[object] = None    # [Srows, Npad] int32


def init_carry(plan: FastPlan, rr: int = 0) -> FastCarry:
    """The carry at the plan's initial cluster state."""
    misc = np.zeros((1, LANES), dtype=np.int32)
    misc[0, 0] = rr
    return FastCarry(
        rows=[plan.used_cpu, plan.used_mem, plan.used_gpu, plan.used_eph,
              plan.nonzero_cpu, plan.nonzero_mem, plan.pod_count],
        misc=misc,
        scal=plan.used_scalar if plan.num_scalars else None)


def _gcd_reduce(arrays) -> Tuple[int, list]:
    """gcd over every value in `arrays`; returns (g, arrays // g)."""
    g = 0
    for a in arrays:
        for v in np.unique(np.asarray(a, dtype=np.int64)):
            g = math.gcd(g, int(v))
    if g <= 1:
        return max(g, 1), [np.asarray(a, dtype=np.int64) for a in arrays]
    return g, [np.asarray(a, dtype=np.int64) // g for a in arrays]


_GROUP_FEATURES = (("has_ports", "host ports"),
                   ("has_services", "services (SelectorSpreadPriority)"),
                   ("has_interpod", "inter-pod (anti)affinity"),
                   ("has_volumes", "pod volumes"))


def plan_fast(config: EngineConfig, compiled: CompiledCluster,
              cols: PodColumns) -> Tuple[Optional[FastPlan], str]:
    """Build the int32 plan, or (None, reason) when ineligible."""
    for flag, name in _GROUP_FEATURES:
        if getattr(config, flag):
            return None, (f"pod-group feature {name} needs a kernel variant "
                          "the port does not carry yet")
    n_scal = len(compiled.scalar_names)
    if NUM_FIXED_BITS + n_scal > PAD_SENTINEL_BIT:
        return None, (f"{n_scal} scalar resource kinds exceed the int32 "
                      f"reason-bit budget "
                      f"({PAD_SENTINEL_BIT - NUM_FIXED_BITS})")
    s, t, d = compiled.statics, compiled.tables, compiled.dynamic

    g_cpu, (ac, rc, nzc, uc, nzuc) = _gcd_reduce(
        [s.alloc_cpu, cols.req_cpu, cols.nz_cpu, d.used_cpu, d.nonzero_cpu])
    g_mem, (am, rm, nzm, um, nzum) = _gcd_reduce(
        [s.alloc_mem, cols.req_mem, cols.nz_mem, d.used_mem, d.nonzero_mem])
    g_gpu, (ag, rg, ug) = _gcd_reduce([s.alloc_gpu, cols.req_gpu, d.used_gpu])
    g_eph, (ae, re_, ue) = _gcd_reduce([s.alloc_eph, cols.req_eph, d.used_eph])
    # each scalar axis reduces independently (fit comparisons never mix axes)
    scal_cols = []
    scal_gcds = []
    if n_scal:
        ascal = np.asarray(s.alloc_scalar, dtype=np.int64).reshape(-1, n_scal)
        rscal = np.asarray(cols.req_scalar, dtype=np.int64).reshape(-1, n_scal)
        uscal = np.asarray(d.used_scalar, dtype=np.int64).reshape(-1, n_scal)
        for si in range(n_scal):
            g_s, (a_s, r_s, u_s) = _gcd_reduce(
                [ascal[:, si], rscal[:, si], uscal[:, si]])
            scal_cols.append((a_s, r_s, u_s))
            scal_gcds.append(g_s)

    checks = [("cpu", (ac, rc, nzc, uc, nzuc)),
              ("memory", (am, rm, nzm, um, nzum)),
              ("gpu", (ag, rg, ug)), ("ephemeral", (ae, re_, ue))]
    checks += [(compiled.scalar_names[si], scal_cols[si])
               for si in range(n_scal)]
    for name, arrs in checks:
        for a in arrs:
            if a.size and int(a.max(initial=0)) >= INT_LIMIT:
                return None, f"{name} values exceed int32 after gcd reduction"
    # BalancedResourceAllocation products must fit int32 including the
    # nonzero totals (which can exceed allocatable; bounded by allowed_pods
    # extra defaulted requests per node)
    allowed_max = int(np.max(s.allowed_pods, initial=0))
    bound_c = int(ac.max(initial=0)) + allowed_max * int(
        max(nzc.max(initial=0), nzuc.max(initial=0), 0))
    bound_m = int(am.max(initial=0)) + allowed_max * int(
        max(nzm.max(initial=0), nzum.max(initial=0), 0))
    if 10 * bound_c * bound_m >= (1 << 31):
        return None, "balanced-allocation product exceeds int32"
    for name, table in (("affinity", t.affinity_count),
                        ("intolerable", t.intolerable),
                        ("avoid", t.avoid_score)):
        weight = AVOID_PODS_WEIGHT if name == "avoid" else 1
        if table.size and MAX_PRIORITY * int(np.max(np.abs(table))) \
                * weight >= (1 << 31):
            return None, f"{name} table exceeds int32"

    n = len(np.asarray(s.alloc_cpu))
    npad = -(-max(n, 1) // LANES) * LANES

    def node_row(a):
        out = np.zeros((1, npad), dtype=np.int32)
        out[0, :n] = np.asarray(a, dtype=np.int64).astype(np.int32)
        return out

    def table_rows(a):
        a = np.asarray(a)
        out = np.zeros((max(a.shape[0], 1), npad), dtype=np.int32)
        if a.size:
            out[:a.shape[0], :n] = a.astype(np.int32)
        return out

    def pods(a):
        return np.asarray(a, dtype=np.int64).astype(np.int32)

    cond = node_row(s.cond_fail_bits)
    cond[0, n:] = np.int32(1 << PAD_SENTINEL_BIT)

    alloc_scalar = used_scalar = req_scalar = None
    if n_scal:
        srows = -(-n_scal // SCALAR_ROW_PAD) * SCALAR_ROW_PAD
        alloc_scalar = np.zeros((srows, npad), dtype=np.int32)
        used_scalar = np.zeros((srows, npad), dtype=np.int32)
        req_scalar = np.zeros((rscal.shape[0], n_scal), dtype=np.int32)
        for si, (a_s, r_s, u_s) in enumerate(scal_cols):
            alloc_scalar[si, :n] = a_s.astype(np.int32)
            used_scalar[si, :n] = u_s.astype(np.int32)
            req_scalar[:, si] = r_s.astype(np.int32)

    plan = FastPlan(
        num_nodes=n, num_pods=len(np.asarray(cols.req_cpu)),
        most_requested=config.most_requested, num_scalars=n_scal,
        alloc_scalar=alloc_scalar, used_scalar=used_scalar,
        req_scalar=req_scalar,
        alloc_cpu=node_row(ac), alloc_mem=node_row(am),
        alloc_gpu=node_row(ag), alloc_eph=node_row(ae),
        allowed=node_row(s.allowed_pods), cond_bits=cond,
        mem_pressure=node_row(s.mem_pressure),
        disk_pressure=node_row(s.disk_pressure),
        selector_ok=table_rows(t.selector_ok),
        taint_ok=table_rows(t.taint_ok),
        intolerable=table_rows(t.intolerable),
        aff_count=table_rows(t.affinity_count),
        avoid_score=table_rows(t.avoid_score),
        host_ok=table_rows(t.host_ok),
        used_cpu=node_row(uc), used_mem=node_row(um),
        used_gpu=node_row(ug), used_eph=node_row(ue),
        nonzero_cpu=node_row(nzuc), nonzero_mem=node_row(nzum),
        pod_count=node_row(d.pod_count),
        req_cpu=pods(rc), req_mem=pods(rm), req_gpu=pods(rg),
        req_eph=pods(re_), nz_cpu=pods(nzc), nz_mem=pods(nzm),
        zero_request=pods(cols.zero_request),
        best_effort=pods(cols.best_effort),
        sel_id=pods(cols.sel_id), tol_id=pods(cols.tol_id),
        aff_id=pods(cols.aff_id), avoid_id=pods(cols.avoid_id),
        host_id=pods(cols.host_id),
        gcds=(g_cpu, g_mem, g_gpu, g_eph), scalar_gcds=tuple(scal_gcds),
    )
    return plan, ""


# fields of a plan dict that must hold their group-free value for the plan
# to fit this kernel variant
_GROUP_FREE = {"num_groups": 0, "has_interpod": False, "has_maxpd": False,
               "has_vol_zone": False, "policy": None}


def plan_from_numpy(fields_: dict) -> FastPlan:
    """A FastPlan from a dict of numpy arrays and scalars holding at least
    this plan's fields (for instance another implementation's plan in dict
    form). Extra keys are ignored when they carry their group-free value;
    a plan that needs a group, inter-pod, MaxPD or policy variant raises."""
    for key, free in _GROUP_FREE.items():
        if key in fields_ and fields_[key] != free:
            raise ValueError(f"plan field {key}={fields_[key]!r}: the port "
                             "carries the group-free kernel variant only")
    kw = {}
    for f in fields(FastPlan):
        v = fields_[f.name]
        if isinstance(v, np.ndarray):
            v = np.ascontiguousarray(v, dtype=np.int32)
        elif isinstance(v, (list, tuple)):
            v = tuple(int(x) for x in v)
        kw[f.name] = v
    return FastPlan(**kw)
