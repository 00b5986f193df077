"""The int32 plan of the fused fast scan: node axis padded, every resource
quantity reduced exactly to int32.

Eligibility (checked by `plan_fast`, reasons returned):
  * pod-group features run through a [Gpad, Npad] presence carry: host
    ports, NoDiskConflict, services (SelectorSpreadPriority with its zone
    blend) and NoVolumeZoneConflict, within TPUSIM_FAST_MAX_GROUPS (32)
    merged groups, TPUSIM_FAST_MAX_ZONES (16) zone domains and the blend's
    int32 product bound; MaxPD volume counts run through a [Vpad, Npad]
    used-volume carry within TPUSIM_FAST_MAX_VOLS (32) volume ids;
  * inter-pod (anti)affinity is refused: its kernel variant is not ported;
  * at most 6 scalar resource kinds (their failure bits ride the int32
    reason word at NUM_FIXED_BITS + s);
  * every quantity divides by its per-axis gcd to a value under 2^29 with
    the BalancedResourceAllocation product bound 10*max_cpu*max_mem < 2^31
    (the kernel is int32 throughout; the reduced arithmetic never
    overflows, so the exact rational semantics of the reference hold).
"""

from __future__ import annotations

import math
import os
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
ROW_PAD = 8                  # scalar, group, zone and volume rows pad to this


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
    # pod-group features (num_groups == 0: no presence carry). presence is
    # the [Gpad, Npad] count of pods per merged group and node; a pod's
    # port / disk / spread rows flag the groups it conflicts with or counts
    num_groups: int = 0          # Gpad (ROW_PAD-padded merged group count)
    has_ports: bool = False
    has_disk: bool = False
    has_spread: bool = False
    has_vol_zone: bool = False
    presence: Optional[np.ndarray] = None    # [Gpad, Npad] init carry
    gid: Optional[np.ndarray] = None         # [P] merged group id
    port_row: Optional[np.ndarray] = None    # [P, Gpad] 0/1 port conflicts
    disk_row: Optional[np.ndarray] = None    # [P, Gpad] 0/1 disk conflicts
    ss_row: Optional[np.ndarray] = None      # [P, Gpad] 0/1 spread set
    zone_ok_tbl: Optional[np.ndarray] = None  # [G, Npad] 0/1 by gid
    zone_onehot: Optional[np.ndarray] = None  # [Zpad, Npad]; row 0 = no zone
    n_zone_doms: int = 0         # Zpad (ROW_PAD-padded)
    # Max{EBS,GCEPD,AzureDisk}VolumeCount: the per-node used-volume union as
    # a [Vpad, Npad] 0/1 carry, per-pod volume masks by group id
    has_maxpd: bool = False
    maxpd_enabled: Tuple[bool, bool, bool] = (True, True, True)
    n_vols: int = 0                          # V real volume ids
    used_vols: Optional[np.ndarray] = None   # [Vpad, Npad] init carry
    vol_tbl: Optional[np.ndarray] = None     # [G, Vw] mask by gid (Vw = 128k)
    vol_type3: Tuple[int, ...] = ()          # [V*3] type flags (EBS,GCE,AZ)
    maxpd_limits: Tuple[int, int, int] = (0, 0, 0)


@dataclass
class FastCarry:
    """The carry threaded through fast_scan calls: the seven [1, Npad] node
    rows, the rr misc row and the optional scalar, presence and used-volume
    rows. Arrays may be numpy (the plan's initial state) or torch tensors (a
    previous call's carry)."""

    rows: list               # [used_c, used_m, used_g, used_e, nz_c, nz_m, pc]
    misc: object             # [1, LANES] int32; rr at [0, 0]
    scal: Optional[object] = None    # [Srows, Npad] int32
    pres: Optional[object] = None    # [Gpad, Npad] int32
    uv: Optional[object] = None      # [Vpad, Npad] 0/1 int32


def init_carry(plan: FastPlan, rr: int = 0) -> FastCarry:
    """The carry at the plan's initial cluster state."""
    misc = np.zeros((1, LANES), dtype=np.int32)
    misc[0, 0] = rr
    return FastCarry(
        rows=[plan.used_cpu, plan.used_mem, plan.used_gpu, plan.used_eph,
              plan.nonzero_cpu, plan.nonzero_mem, plan.pod_count],
        misc=misc,
        scal=plan.used_scalar if plan.num_scalars else None,
        pres=plan.presence if plan.num_groups else None,
        uv=plan.used_vols if plan.has_maxpd else None)


def _gcd_reduce(arrays) -> Tuple[int, list]:
    """gcd over every value in `arrays`; returns (g, arrays // g)."""
    g = 0
    for a in arrays:
        for v in np.unique(np.asarray(a, dtype=np.int64)):
            g = math.gcd(g, int(v))
    if g <= 1:
        return max(g, 1), [np.asarray(a, dtype=np.int64) for a in arrays]
    return g, [np.asarray(a, dtype=np.int64) // g for a in arrays]


def _budget(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def plan_fast(config: EngineConfig, compiled: CompiledCluster,
              cols: PodColumns) -> Tuple[Optional[FastPlan], str]:
    """Build the int32 plan, or (None, reason) when ineligible. The budget
    refusals are word for word the JAX package's."""
    if config.has_interpod:
        return None, ("pod-group feature inter-pod (anti)affinity needs a "
                      "kernel variant the port does not carry yet")
    gt = compiled.groups
    if config.has_maxpd:
        n_vols_real = int(gt.vol_mask.shape[1])
        max_v = _budget("TPUSIM_FAST_MAX_VOLS", 32)
        if n_vols_real > max_v:
            return None, (f"{n_vols_real} MaxPD volume ids exceed the "
                          f"fast-path budget ({max_v}; "
                          "TPUSIM_FAST_MAX_VOLS)")
    group_bound = (config.has_ports or config.has_services
                   or config.has_disk_conflict or config.has_vol_zone
                   or config.has_maxpd)
    # presence is read by ports, disk conflicts and spreading only; a
    # vol-zone- or MaxPD-only plan still has group ids but no presence carry
    needs_presence = (config.has_ports or config.has_services
                      or config.has_disk_conflict)
    num_g = int(gt.presence.shape[0]) if group_bound else 0
    if needs_presence:
        max_g = _budget("TPUSIM_FAST_MAX_GROUPS", 32)
        if num_g > max_g:
            return None, (f"{num_g} pod groups exceed the fast-path "
                          f"unrolled-loop budget ({max_g}; "
                          "TPUSIM_FAST_MAX_GROUPS)")
        if config.has_services:
            max_z = _budget("TPUSIM_FAST_MAX_ZONES", 16)
            if config.n_zone_doms > max_z:
                return None, (f"{config.n_zone_doms} zone domains exceed "
                              f"the fast-path budget ({max_z})")
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

    gpad = zpad = 0
    if needs_presence:
        gpad = max(-(-num_g // ROW_PAD) * ROW_PAD, ROW_PAD)
    if config.has_services:
        # SelectorSpreadPriority's zone blend multiplies per-node by
        # per-zone counts: bound both from the seeded presence plus the
        # worst case every remaining slot fills with matched pods, and
        # require the blend products to fit int32 (exactness contract)
        col_tot = gt.presence.sum(axis=0).astype(np.int64)  # [N]
        allowed_pods_max = int(np.max(s.allowed_pods, initial=0))
        bound_node = int(col_tot.max(initial=0)) + allowed_pods_max
        zd = np.asarray(gt.zone_dom, dtype=np.int64)
        bound_zone = 1
        for dom in np.unique(zd):
            if dom == 0:
                # the no-zone bucket never enters a zone product
                continue
            in_dom = zd == dom
            bound_zone = max(bound_zone,
                             int(col_tot[in_dom].sum())
                             + int(in_dom.sum()) * allowed_pods_max)
        if 3 * MAX_PRIORITY * bound_node * bound_zone >= (1 << 31):
            return None, ("spread zone-blend products exceed int32 "
                          f"(node bound {bound_node} x zone bound "
                          f"{bound_zone})")
        zpad = max(-(-config.n_zone_doms // ROW_PAD) * ROW_PAD, ROW_PAD)

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
        srows = -(-n_scal // ROW_PAD) * ROW_PAD
        alloc_scalar = np.zeros((srows, npad), dtype=np.int32)
        used_scalar = np.zeros((srows, npad), dtype=np.int32)
        req_scalar = np.zeros((rscal.shape[0], n_scal), dtype=np.int32)
        for si, (a_s, r_s, u_s) in enumerate(scal_cols):
            alloc_scalar[si, :n] = a_s.astype(np.int32)
            used_scalar[si, :n] = u_s.astype(np.int32)
            req_scalar[:, si] = r_s.astype(np.int32)

    presence = gid = port_row = disk_row = ss_row = None
    zone_ok_tbl = zone_onehot = None
    if group_bound:
        gid = pods(cols.group_id)
    if needs_presence:
        presence = np.zeros((gpad, npad), dtype=np.int32)
        presence[:num_g, :n] = gt.presence.astype(np.int32)

        def per_pod(row_of_group):
            # row_of_group [G, G] -> per-pod [P, Gpad] 0/1
            out = np.zeros((len(gid), gpad), dtype=np.int32)
            out[:, :num_g] = row_of_group[gid]
            return out

        if config.has_ports:
            # conflict of MY port set vs each group's port set
            port_row = per_pod(gt.port_conflict[gt.port_sig][:, gt.port_sig]
                               .astype(np.int32))
        if config.has_disk_conflict:
            disk_row = per_pod(gt.disk_conflict[gt.disk_sig][:, gt.disk_sig]
                               .astype(np.int32))
        if config.has_services:
            ss_row = per_pod(gt.ss_rows[gt.ss_sig].astype(np.int32))
            zone_onehot = np.zeros((zpad, npad), dtype=np.int32)
            zd = np.asarray(gt.zone_dom, dtype=np.int64)
            for z in range(config.n_zone_doms):
                zone_onehot[z, :n] = (zd == z).astype(np.int32)
    if config.has_vol_zone:
        zone_ok_tbl = table_rows(gt.zone_ok)

    used_vols = vol_tbl = None
    n_vols = 0
    vol_type3 = ()
    mp_limits = (0, 0, 0)
    if config.has_maxpd:
        n_vols = n_vols_real
        vpad = max(-(-n_vols // ROW_PAD) * ROW_PAD, ROW_PAD)
        vpad_l = max(-(-n_vols // LANES) * LANES, LANES)
        used_vols = np.zeros((vpad, npad), dtype=np.int32)
        used_vols[:n_vols, :n] = gt.used_vols_init.T.astype(np.int32)
        vol_tbl = np.zeros((max(num_g, 1), vpad_l), dtype=np.int32)
        vol_tbl[:num_g, :n_vols] = gt.vol_mask.astype(np.int32)
        vol_type3 = tuple(int(v) for v in
                          np.asarray(gt.vol_type, dtype=np.int64).flatten())
        mp_limits = tuple(int(x) for x in config.maxpd_limits)

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
        num_groups=gpad, has_ports=config.has_ports,
        has_disk=config.has_disk_conflict, has_spread=config.has_services,
        has_vol_zone=config.has_vol_zone, presence=presence, gid=gid,
        port_row=port_row, disk_row=disk_row, ss_row=ss_row,
        zone_ok_tbl=zone_ok_tbl, zone_onehot=zone_onehot,
        n_zone_doms=zpad if config.has_services else 0,
        has_maxpd=config.has_maxpd, n_vols=n_vols, used_vols=used_vols,
        vol_tbl=vol_tbl, vol_type3=vol_type3, maxpd_limits=mp_limits,
    )
    return plan, ""


# fields of a plan dict that must hold these values for the plan to fit
# the kernel variants the port carries
_PORTED = {"has_interpod": False, "policy": None,
           "maxpd_enabled": (True, True, True)}


def plan_from_numpy(fields_: dict) -> FastPlan:
    """A FastPlan from a dict of numpy arrays and scalars holding at least
    this plan's fields (for instance another implementation's plan in dict
    form). Extra keys are ignored when they hold the value above; a plan
    that needs the inter-pod or policy variant raises."""
    for key, want in _PORTED.items():
        if key in fields_ and fields_[key] != want:
            raise ValueError(f"plan field {key}={fields_[key]!r}: the port "
                             "does not carry that kernel variant yet")
    kw = {}
    for f in fields(FastPlan):
        v = fields_[f.name]
        if isinstance(v, np.ndarray):
            v = np.ascontiguousarray(v, dtype=np.int32)
        elif isinstance(v, (list, tuple)):
            v = tuple(x if isinstance(x, bool) else int(x) for x in v)
        kw[f.name] = v
    return FastPlan(**kw)
