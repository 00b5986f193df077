"""The int32 plan of the fused fast scan: node axis padded, every resource
quantity reduced exactly to int32.

Eligibility (checked by `plan_fast`, reasons returned):
  * pod-group features run through a [Gpad, Npad] presence carry: host
    ports, NoDiskConflict, services (SelectorSpreadPriority with its zone
    blend) and NoVolumeZoneConflict, within TPUSIM_FAST_MAX_GROUPS (32)
    merged groups, TPUSIM_FAST_MAX_ZONES (16) zone domains and the blend's
    int32 product bound; MaxPD volume counts run through a [Vpad, Npad]
    used-volume carry within TPUSIM_FAST_MAX_VOLS (32) volume ids;
  * inter-pod (anti)affinity runs through the presence carry and a
    [Gpad*K, Dpad] presence_dom carry (pods per group, topology key and
    domain) within TPUSIM_FAST_MAX_TOPO_KEYS (4) keys,
    TPUSIM_FAST_MAX_TOPO_DOMS (64) domains, TPUSIM_FAST_MAX_TERMS (4)
    terms of a kind, integral preferred weights and the int32 bound on the
    InterPodAffinityPriority counts;
  * a scheduler policy (EngineConfig.policy) gates the stages and weights
    the score; its residue runs through tables built by
    policyc.build_policy_tables: label-presence rows, the NodeLabel priority
    row, ImageLocality scores by pod image set, the NoExecute taint table,
    ServiceAntiAffinity label domains within TPUSIM_FAST_MAX_ZONES (16), and
    the ServiceAffinity pins, label values and first-matching-pod locks
    within TPUSIM_FAST_MAX_SA_SEGS (16) lock slots and entry labels, under
    the policy's int32 score-mass bound;
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

from tpusim_torch.config import AVOID_PODS_WEIGHT, EngineConfig, PolicySpec
from tpusim_torch.engine.predicates import (
    MAX_AZURE_DISK_VOLUME_COUNT_PRED,
    MAX_EBS_VOLUME_COUNT_PRED,
    MAX_GCE_PD_VOLUME_COUNT_PRED,
)
from tpusim_torch.engine.priorities import MAX_PRIORITY
from tpusim_torch.engine.resources import (
    get_nonzero_pod_request,
    get_resource_request,
)
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
    # inter-pod (anti)affinity: own terms are per-domain sums of matched
    # presence; the existing pods' terms against a pod read the
    # [Gpad*K, Dpad] presence_dom carry (row g*K + k: pods of group g per
    # domain of topology key k). Every per-pod operand is a function of the
    # pod's group, so it rides the [Gpad, Wip] ipod table (IpLayout) by
    # group id; the exist_* tuples are the other groups' term keys, masks
    # and weights, [Gpad*T] each.
    has_interpod: bool = False
    n_topo_keys: int = 0           # K
    n_topo_doms_ip: int = 0        # D, real domains incl. the invalid 0
    ta: int = 0                    # own required-affinity term slots
    tb: int = 0                    # own required-anti-affinity term slots
    tp: int = 0                    # own preferred term slots
    hard_weight: int = 10
    topo_rows: Optional[np.ndarray] = None       # [Kpad, Npad] domain ids
    presence_dom: Optional[np.ndarray] = None    # [Gpad*K, Dpad] init carry
    ipod: Optional[np.ndarray] = None            # [Gpad, Wip] by group id
    exist_anti_key: Tuple[int, ...] = ()     # [G*Tb] topology key per term
    exist_anti_mask: Tuple[int, ...] = ()    # [G*Tb] valid & ~empty
    exist_anti_empty: Tuple[int, ...] = ()   # [G*Tb] valid & empty
    exist_pref_key: Tuple[int, ...] = ()     # [G*Tp]
    exist_pref_w: Tuple[int, ...] = ()       # [G*Tp] signed int weights
    exist_aff_key: Tuple[int, ...] = ()      # [G*Ta]
    exist_aff_mask: Tuple[int, ...] = ()     # [G*Ta] valid & ~empty
    # a scheduler policy's gating and weights (None: the provider's) and its
    # residue tables, node axis padded to Npad. ServiceAffinity locks ride
    # the misc carry lanes 1..Fd (the first matching pod's node index, -1
    # unlocked, -2 never pinned).
    policy: Optional[PolicySpec] = None
    label_tbl: Optional[np.ndarray] = None      # [Lpad, Npad] 0/1 pass
    label_prio_row: Optional[np.ndarray] = None  # [1, Npad] pre-weighted
    image_tbl: Optional[np.ndarray] = None      # [Si, Npad] by img_id
    img_id: Optional[np.ndarray] = None         # [P]
    noexec_tbl: Optional[np.ndarray] = None     # [Ctol, Npad] by tol_id
    saa_row: Optional[np.ndarray] = None        # [P, Gpad] first-service set
    saa_dom_tbl: Optional[np.ndarray] = None    # [Epad, Npad] label domains
    n_saa_doms: int = 0                         # domains incl. the absent 0
    sa_sig: Optional[np.ndarray] = None         # [P] first-service sig id
    sa_pin_row: Optional[np.ndarray] = None     # [P, La8] own selector pins
    sa_match_row: Optional[np.ndarray] = None   # [P, Fd8] bind match bits
    sa_val_tbl: Optional[np.ndarray] = None     # [Lapad, Npad] label values
    sa_lock_init: Optional[np.ndarray] = None   # [Fd] lock seeds
    sa_la: int = 0                              # concatenated SA labels


@dataclass
class FastCarry:
    """The carry threaded through fast_scan calls: the seven [1, Npad] node
    rows, the rr misc row and the optional scalar, presence, presence_dom
    and used-volume rows. Arrays may be numpy (the plan's initial state) or torch tensors (a
    previous call's carry)."""

    rows: list               # [used_c, used_m, used_g, used_e, nz_c, nz_m, pc]
    misc: object             # [1, LANES] int32; rr at [0, 0]
    scal: Optional[object] = None    # [Srows, Npad] int32
    pres: Optional[object] = None    # [Gpad, Npad] int32
    pd: Optional[object] = None      # [Gpad*K, Dpad] int32 (inter-pod)
    uv: Optional[object] = None      # [Vpad, Npad] 0/1 int32


def init_carry(plan: FastPlan, rr: int = 0) -> FastCarry:
    """The carry at the plan's initial cluster state."""
    misc = np.zeros((1, LANES), dtype=np.int32)
    misc[0, 0] = rr
    if plan.sa_lock_init is not None:
        misc[0, 1:1 + len(plan.sa_lock_init)] = plan.sa_lock_init
    return FastCarry(
        rows=[plan.used_cpu, plan.used_mem, plan.used_gpu, plan.used_eph,
              plan.nonzero_cpu, plan.nonzero_mem, plan.pod_count],
        misc=misc,
        scal=plan.used_scalar if plan.num_scalars else None,
        pres=plan.presence if plan.num_groups else None,
        pd=plan.presence_dom if plan.has_interpod else None,
        uv=plan.used_vols if plan.has_maxpd else None)


class IpLayout:
    """Offsets into a group's packed inter-pod row (int32 lanes).

    Own-term data (the group's required affinity, anti-affinity and
    preferred terms): 0/1 match lanes against every group, topology-key ids
    and flags. Exist-side data (the other groups' terms evaluated against
    this group): 0/1 match lanes only; their keys, weights and masks are the
    plan's exist_* tuples."""

    def __init__(self, ta: int, tb: int, tp: int, gpad: int):
        off = 0

        def take(n):
            nonlocal off
            at = off
            off += n
            return at

        self.aff_match = take(ta * gpad)    # [t*gpad+g]
        self.aff_key = take(ta)
        self.aff_valid = take(ta)
        self.aff_empty = take(ta)
        self.aff_host = take(ta)
        self.aff_self = take(ta)
        self.aff_unpl = take(ta)
        self.aff_err = take(1)
        self.anti_match = take(tb * gpad)
        self.anti_key = take(tb)
        self.anti_valid = take(tb)
        self.anti_host = take(tb)
        self.anti_err = take(1)
        self.pref_match = take(tp * gpad)
        self.pref_key = take(tp)
        self.pref_w = take(tp)              # signed int weights
        self.ex_anti = take(gpad * tb)      # [g*tb+t] term matches ME
        self.ex_pref = take(gpad * tp)
        self.ex_aff = take(gpad * ta)
        self.width = max(-(-off // LANES) * LANES, LANES)


def presence_dom_init(presence: np.ndarray, topo_dom: np.ndarray,
                      n_doms: int) -> np.ndarray:
    """presence_dom[g, k, d] = sum of presence[g, n] over nodes in domain d."""
    g, _ = presence.shape
    k = topo_dom.shape[0]
    pd = np.zeros((g, k, n_doms), dtype=np.int32)
    for ki in range(k):
        np.add.at(pd[:, ki, :], (slice(None), topo_dom[ki]), presence)
    return pd


def embed_presence_dom(presence, topo_dom, d_doms: int, gpad: int,
                       dpad: int) -> np.ndarray:
    """[G, K, D] presence_dom -> the kernel's [Gpad*K, Dpad] carry layout
    (row g*K + k)."""
    pd3 = presence_dom_init(presence, topo_dom, d_doms)
    g, k_keys, _ = pd3.shape
    out = np.zeros((gpad * k_keys, dpad), dtype=np.int32)
    out[:g * k_keys, :d_doms] = pd3.reshape(g * k_keys, d_doms)
    return out


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


def rearm_carry(plan: FastPlan, compiled: CompiledCluster,
                rr: int) -> Optional[FastCarry]:
    """The carry rebuilt from a refreshed CompiledCluster's original-unit
    dynamic aggregates (IncrementalCluster.refresh_dynamic after the
    preemption hybrid's churn: binds as ADDED, victims as DELETED), in plan
    units. Every value must divide exactly by the plan's per-axis gcd and
    stay inside the int32 budget, which plan_fast's fold of the placed
    pods' requests into the gcds guarantees and this checks anyway. Returns
    None where the refreshed state cannot be expressed in plan units."""
    if plan.sa_lock_init is not None:
        # ServiceAffinity locks are pod-assignment history the refreshed
        # tables cannot reproduce (a policy never reaches the hybrid)
        return None
    d = compiled.dynamic
    n = plan.num_nodes
    npad = plan.alloc_cpu.shape[1]

    def reduced(agg, g):
        a = np.asarray(agg, dtype=np.int64)
        if g > 1:
            if (a % g).any():
                return None
            a = a // g
        if a.size and int(a.max(initial=0)) >= INT_LIMIT:
            return None
        return a.astype(np.int32)

    def reduce_row(agg, g):
        a = reduced(agg, g)
        if a is None:
            return None
        out = np.zeros((1, npad), dtype=np.int32)
        out[0, :n] = a
        return out

    gc, gm, gg, ge = plan.gcds
    rows = [reduce_row(d.used_cpu, gc), reduce_row(d.used_mem, gm),
            reduce_row(d.used_gpu, gg), reduce_row(d.used_eph, ge),
            reduce_row(d.nonzero_cpu, gc), reduce_row(d.nonzero_mem, gm),
            reduce_row(d.pod_count, 1)]
    if any(r is None for r in rows):
        return None
    scal = None
    if plan.num_scalars:
        scal = np.zeros((plan.used_scalar.shape[0], npad), dtype=np.int32)
        us = np.asarray(d.used_scalar, dtype=np.int64)
        for si, g in enumerate(plan.scalar_gcds):
            col = reduced(us[:, si], g)
            if col is None:
                return None
            scal[si, :n] = col
    pres = pd = None
    gt = compiled.groups
    if plan.num_groups:
        if gt.presence.shape[0] > plan.num_groups:
            return None  # the group universe grew: the plan's rows are stale
        pres = np.zeros((plan.num_groups, npad), dtype=np.int32)
        pres[:gt.presence.shape[0], :n] = gt.presence.astype(np.int32)
        if plan.has_interpod:
            if gt.topo_dom.shape[0] != plan.n_topo_keys:
                return None  # the topology-key universe changed
            pd = embed_presence_dom(gt.presence, gt.topo_dom,
                                    plan.n_topo_doms_ip, plan.num_groups,
                                    plan.presence_dom.shape[1])
    uv = None
    if plan.has_maxpd:
        if gt.vol_mask.shape[1] != plan.n_vols:
            return None  # the volume-id universe changed
        # refresh_dynamic succeeds only with clean group tables (a bind or
        # victim with volumes dirties them), so used_vols_init is current
        uv = np.zeros_like(plan.used_vols)
        uv[:plan.n_vols, :n] = gt.used_vols_init.T.astype(np.int32)
    misc = np.zeros((1, LANES), dtype=np.int32)
    misc[0, 0] = rr
    return FastCarry(rows=rows, misc=misc, scal=scal, pres=pres, pd=pd,
                     uv=uv)


def placed_pod_values(placed_pods, scalar_names) -> dict:
    """Per-pod request values of already-placed pods, by axis, for
    plan_fast's gcds: with them folded in, a preemption victim's deletion
    keeps every refreshed aggregate an exact multiple of the plan's unit."""
    vals = {"cpu": [], "mem": [], "gpu": [], "eph": [],
            "scalar": [[] for _ in scalar_names]}
    idx = {name: i for i, name in enumerate(scalar_names)}
    for pod in placed_pods:
        req = get_resource_request(pod)
        nz = get_nonzero_pod_request(pod)
        vals["cpu"] += [req.milli_cpu, nz.milli_cpu]
        vals["mem"] += [req.memory, nz.memory]
        vals["gpu"].append(req.nvidia_gpu)
        vals["eph"].append(req.ephemeral_storage)
        for name, v in (req.scalar or {}).items():
            if name in idx:
                vals["scalar"][idx[name]].append(v)
    out = {key: np.asarray(vals[key], dtype=np.int64)
           for key in ("cpu", "mem", "gpu", "eph")}
    out["scalar"] = [np.asarray(col, dtype=np.int64)
                     for col in vals["scalar"]]
    return out


def plan_fast(config: EngineConfig, compiled: CompiledCluster,
              cols: PodColumns, ptabs=None, placed_pods=None
              ) -> Tuple[Optional[FastPlan], str]:
    """Build the int32 plan, or (None, reason) when ineligible. The budget
    refusals are word for word the JAX package's.

    ptabs: the policyc.PolicyTables of config.policy, needed when the policy
    uses any residue table (label rows, label priorities, image scores,
    NoExecute taints, ServiceAntiAffinity, ServiceAffinity).

    placed_pods: pods already bound (the preemption hybrid): their request
    and nonzero values join the gcd reduction, so that a victim's deletion
    leaves the refreshed aggregates expressible in plan units
    (rearm_carry)."""
    ps = config.policy
    pol_label = ps is not None and bool(ps.label_rows)
    pol_prio = ps is not None and ps.has_label_prio
    pol_image = ps is not None and bool(ps.w_image)
    pol_saa = ps is not None and bool(ps.saa_weights)
    pol_sa = ps is not None and (ps.sa_enabled or bool(ps.sa_slots))
    pol_noexec = ps is not None and ps.has_noexec
    pol_any = (pol_label or pol_prio or pol_image or pol_saa or pol_sa
               or pol_noexec)
    if pol_any:
        if ptabs is None:
            return None, ("policy static tables unavailable (caller did "
                          "not supply them)")
        if pol_noexec and not compiled.has_noexec_table:
            return None, "NoExecute taint table not compiled"
        if (pol_sa or pol_saa) and not compiled.has_saa_table:
            return None, "ServiceAffinity signature tables not compiled"
        if pol_sa:
            fd_real = int(compiled.groups.saa_rows.shape[0])
            la_real = int(sum(ps.sa_segs))
            max_sa = _budget("TPUSIM_FAST_MAX_SA_SEGS", 16)
            # lock slots ride misc carry lanes 1..Fd (lane 0 is rr)
            if fd_real > min(max_sa, LANES - 1):
                return None, (f"{fd_real} ServiceAffinity lock segments "
                              f"exceed the fast-path budget "
                              f"({min(max_sa, LANES - 1)}; "
                              "TPUSIM_FAST_MAX_SA_SEGS)")
            if la_real > max_sa:
                return None, (f"{la_real} ServiceAffinity entry labels "
                              f"exceed the fast-path budget ({max_sa}; "
                              "TPUSIM_FAST_MAX_SA_SEGS)")
        if pol_saa:
            max_sz = _budget("TPUSIM_FAST_MAX_ZONES", 16)
            if config.n_saa_doms > max_sz:
                return None, (f"{config.n_saa_doms} ServiceAntiAffinity "
                              f"label domains exceed the fast-path budget "
                              f"({max_sz}; TPUSIM_FAST_MAX_ZONES)")
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
                   or config.has_interpod or config.has_maxpd or pol_saa)
    # presence is read by ports, disk conflicts, spreading, inter-pod terms
    # and ServiceAntiAffinity only; a vol-zone- or MaxPD-only plan still has
    # group ids but no presence carry
    needs_presence = (config.has_ports or config.has_services
                      or config.has_disk_conflict or config.has_interpod
                      or pol_saa)
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
    ip_dims = None
    if config.has_interpod:
        k_keys = int(gt.topo_dom.shape[0])
        d_doms = int(config.n_topo_doms)
        ta = int(gt.aff_valid.shape[1])
        tb = int(gt.anti_valid.shape[1])
        tp = int(gt.pref_w.shape[1])
        max_k = _budget("TPUSIM_FAST_MAX_TOPO_KEYS", 4)
        max_d = _budget("TPUSIM_FAST_MAX_TOPO_DOMS", 64)
        max_t = _budget("TPUSIM_FAST_MAX_TERMS", 4)
        if k_keys > max_k:
            return None, (f"{k_keys} topology keys exceed the fast-path "
                          f"budget ({max_k}; TPUSIM_FAST_MAX_TOPO_KEYS)")
        if d_doms > max_d:
            return None, (f"{d_doms} topology domains exceed the fast-path "
                          f"budget ({max_d}; TPUSIM_FAST_MAX_TOPO_DOMS)")
        if max(ta, tb, tp) > max_t:
            return None, (f"{max(ta, tb, tp)} inter-pod terms exceed the "
                          f"fast-path budget ({max_t}; "
                          "TPUSIM_FAST_MAX_TERMS)")
        if not np.all(gt.pref_w == np.round(gt.pref_w)):
            return None, "non-integral preferred inter-pod weights"
        # InterPodAffinityPriority counts stay int32: bound |counts| by the
        # total weight mass times the largest possible pod population
        total_pods = int(gt.presence.sum()) + len(np.asarray(cols.req_cpu))
        w_own = int(np.abs(gt.pref_w).sum(axis=1).max(initial=0))
        w_exist = int(np.abs(gt.pref_w).sum()) + config.hard_weight * int(
            (gt.aff_valid & ~gt.aff_empty).sum())
        bound_counts = (w_own + w_exist) * max(total_pods, 1)
        w_ip_eff = 1 if ps is None else max(ps.w_interpod, 1)
        if MAX_PRIORITY * 2 * w_ip_eff * bound_counts >= (1 << 31):
            return None, ("inter-pod priority counts exceed int32 "
                          f"(weight mass {w_own + w_exist} x "
                          f"{total_pods} pods)")
        ip_dims = (k_keys, d_doms, ta, tb, tp)
    n_scal = len(compiled.scalar_names)
    if NUM_FIXED_BITS + n_scal > PAD_SENTINEL_BIT:
        return None, (f"{n_scal} scalar resource kinds exceed the int32 "
                      f"reason-bit budget "
                      f"({PAD_SENTINEL_BIT - NUM_FIXED_BITS})")
    s, t, d = compiled.statics, compiled.tables, compiled.dynamic

    placed = (placed_pod_values(placed_pods, compiled.scalar_names)
              if placed_pods else None)

    def axis(key):
        # the placed pods' values join the gcd and are dropped after
        return [placed[key]] if placed is not None else []

    g_cpu, (ac, rc, nzc, uc, nzuc, *_) = _gcd_reduce(
        [s.alloc_cpu, cols.req_cpu, cols.nz_cpu, d.used_cpu, d.nonzero_cpu]
        + axis("cpu"))
    g_mem, (am, rm, nzm, um, nzum, *_) = _gcd_reduce(
        [s.alloc_mem, cols.req_mem, cols.nz_mem, d.used_mem, d.nonzero_mem]
        + axis("mem"))
    g_gpu, (ag, rg, ug, *_) = _gcd_reduce(
        [s.alloc_gpu, cols.req_gpu, d.used_gpu] + axis("gpu"))
    g_eph, (ae, re_, ue, *_) = _gcd_reduce(
        [s.alloc_eph, cols.req_eph, d.used_eph] + axis("eph"))
    # each scalar axis reduces independently (fit comparisons never mix axes)
    scal_cols = []
    scal_gcds = []
    if n_scal:
        ascal = np.asarray(s.alloc_scalar, dtype=np.int64).reshape(-1, n_scal)
        rscal = np.asarray(cols.req_scalar, dtype=np.int64).reshape(-1, n_scal)
        uscal = np.asarray(d.used_scalar, dtype=np.int64).reshape(-1, n_scal)
        for si in range(n_scal):
            extra = [placed["scalar"][si]] if placed is not None else []
            g_s, (a_s, r_s, u_s, *_) = _gcd_reduce(
                [ascal[:, si], rscal[:, si], uscal[:, si]] + extra)
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
    if ps is not None:
        why = _policy_mass_refusal(ps, ptabs, pol_prio, pol_image, pol_saa,
                                   gt, cols, bound_c * bound_m)
        if why:
            return None, why
    w_avoid = AVOID_PODS_WEIGHT if ps is None else ps.w_avoid
    for name, table in (("affinity", t.affinity_count),
                        ("intolerable", t.intolerable),
                        ("avoid", t.avoid_score)):
        weight = max(w_avoid if name == "avoid" else 1, 1)
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
        w_spread_eff = 1 if ps is None else max(ps.w_spread, 1)
        if 3 * MAX_PRIORITY * w_spread_eff * bound_node * bound_zone \
                >= (1 << 31):
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

    topo_rows = presence_dom = ip_tbl = None
    ip_exist = {}
    k_keys = d_doms = ta = tb = tp = 0
    if config.has_interpod:
        k_keys, d_doms, ta, tb, tp = ip_dims
        topo_rows = np.zeros((-(-k_keys // ROW_PAD) * ROW_PAD, npad),
                             dtype=np.int32)
        topo_rows[:k_keys, :n] = gt.topo_dom.astype(np.int32)
        # pad rows and pad nodes keep domain 0 (label missing: never matches)
        presence_dom = embed_presence_dom(
            gt.presence, gt.topo_dom, d_doms, gpad,
            max(-(-d_doms // LANES) * LANES, LANES))
        ip_tbl = ipod_table(gt, IpLayout(ta, tb, tp, gpad), num_g, gpad)

        def exist(a, t_):
            out = np.zeros((gpad, t_), dtype=np.int64)
            out[:num_g] = a
            return tuple(int(v) for v in out.flatten())

        ip_exist = dict(
            exist_anti_key=exist(gt.anti_key, tb),
            exist_anti_mask=exist(gt.anti_valid & ~gt.anti_empty, tb),
            exist_anti_empty=exist(gt.anti_valid & gt.anti_empty, tb),
            exist_pref_key=exist(gt.pref_key, tp),
            exist_pref_w=exist(np.round(gt.pref_w).astype(np.int64), tp),
            exist_aff_key=exist(gt.aff_key, ta),
            exist_aff_mask=exist(gt.aff_valid & ~gt.aff_empty, ta))

    used_vols = vol_tbl = None
    n_vols = 0
    vol_type3 = ()
    mp_limits = (0, 0, 0)
    # a policy may leave MaxPD types out: those never fail
    mp_enabled = (True, True, True)
    if config.has_maxpd and ps is not None and ps.pred_keys is not None:
        mp_enabled = (MAX_EBS_VOLUME_COUNT_PRED in ps.pred_keys,
                      MAX_GCE_PD_VOLUME_COUNT_PRED in ps.pred_keys,
                      MAX_AZURE_DISK_VOLUME_COUNT_PRED in ps.pred_keys)
    if config.has_maxpd and any(mp_enabled):
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
        has_maxpd=config.has_maxpd and any(mp_enabled),
        maxpd_enabled=mp_enabled, n_vols=n_vols, used_vols=used_vols,
        vol_tbl=vol_tbl, vol_type3=vol_type3, maxpd_limits=mp_limits,
        has_interpod=config.has_interpod, n_topo_keys=k_keys,
        n_topo_doms_ip=d_doms, ta=ta, tb=tb, tp=tp,
        hard_weight=config.hard_weight, topo_rows=topo_rows,
        presence_dom=presence_dom, ipod=ip_tbl, **ip_exist, policy=ps,
        **(policy_tables(config, compiled, cols, ptabs, gpad, npad)
           if pol_any else {}))
    return plan, ""


def _policy_mass_refusal(ps: PolicySpec, ptabs, pol_prio: bool,
                         pol_image: bool, pol_saa: bool, gt, cols,
                         bal_product: int) -> str:
    """Why a policy's weighted score could leave int32, or "": every
    component is 0..MAX_PRIORITY after its normalization, the label
    priority and image rows add their own mass, and a ServiceAntiAffinity
    entry adds one more component."""
    w_total = (ps.w_least + ps.w_most + ps.w_balanced + ps.w_node_aff
               + ps.w_taint + ps.w_spread + ps.w_interpod
               + sum(ps.saa_weights))
    pol_mass = 0
    if pol_prio:
        lp64 = np.asarray(ptabs.label_prio, dtype=np.int64)
        if lp64.size and int(lp64.min(initial=0)) < 0:
            # the argmax takes -1 as the infeasible sentinel
            return ("negative label priority scores exceed the "
                    "fast-path score model")
        pol_mass += int(lp64.max(initial=0))
    if pol_image:
        im64 = np.asarray(ptabs.image_score, dtype=np.int64)
        if ps.w_image < 0 or (im64.size and int(im64.min(initial=0)) < 0):
            return ("negative image-locality scores exceed the "
                    "fast-path score model")
        pol_mass += ps.w_image * int(im64.max(initial=0))
    if pol_saa and min(ps.saa_weights) < 0:
        return ("negative ServiceAntiAffinity weights exceed "
                "the fast-path score model")
    if pol_saa:
        # the normalization multiplies MAX_PRIORITY by the feasible
        # matched-pod total before it divides
        total_pods = int(gt.presence.sum()) + len(np.asarray(cols.req_cpu))
        if MAX_PRIORITY * max(total_pods, 1) >= (1 << 31):
            return ("ServiceAntiAffinity spread counts exceed "
                    f"int32 ({total_pods} pods)")
    if w_total * MAX_PRIORITY + pol_mass >= (1 << 30):
        return "policy priority weights exceed the int32 budget"
    if ps.w_balanced and 10 * ps.w_balanced * bal_product >= (1 << 31):
        return "weighted balanced-allocation exceeds int32"
    return ""


def _rows8(n: int) -> int:
    """n rows padded to a multiple of ROW_PAD, at least ROW_PAD."""
    return max(-(-n // ROW_PAD) * ROW_PAD, ROW_PAD)


def policy_tables(config: EngineConfig, compiled: CompiledCluster,
                  cols: PodColumns, ptabs, gpad: int, npad: int) -> dict:
    """The plan fields of a policy's residue tables (FastPlan.label_tbl
    to sa_la), int32, node axis padded to Npad."""
    ps, gt = config.policy, compiled.groups
    n = len(compiled.node_index)
    num_g = int(gt.presence.shape[0])
    gid = np.asarray(cols.group_id, dtype=np.int64)
    out = {}

    def rows(a, nrows):
        a = np.asarray(a)
        t = np.zeros((nrows, npad), dtype=np.int32)
        t[:a.shape[0], :n] = a.astype(np.int32)
        return t

    if ps.label_rows:
        lr = np.asarray(ptabs.label_ok)[:len(ps.label_rows)]
        out["label_tbl"] = rows(lr, _rows8(lr.shape[0]))
    if ps.has_label_prio:
        out["label_prio_row"] = rows(np.asarray(ptabs.label_prio)[None], 1)
    if ps.w_image:
        out["image_tbl"] = rows(ptabs.image_score,
                                max(ptabs.image_score.shape[0], 1))
        out["img_id"] = np.asarray(cols.img_id, dtype=np.int32)
    if ps.has_noexec:
        noexec = compiled.tables.taint_ok_noexec
        out["noexec_tbl"] = rows(noexec, max(noexec.shape[0], 1))
    if ps.saa_weights:
        saa_row = np.zeros((len(gid), gpad), dtype=np.int32)
        saa_row[:, :num_g] = gt.saa_rows[gt.saa_sig[gid]].astype(np.int32)
        ne = len(ps.saa_weights)
        out.update(saa_row=saa_row, n_saa_doms=int(config.n_saa_doms),
                   saa_dom_tbl=rows(np.asarray(ptabs.saa_dom)[:ne],
                                    _rows8(ne)))
    if ps.sa_enabled or ps.sa_slots:
        la = int(sum(ps.sa_segs))
        fd = int(gt.saa_rows.shape[0])
        pin = np.asarray(ptabs.sa_pin)[np.asarray(cols.sa_self_id)][:, :la]
        sa_pin_row = np.zeros((len(gid), _rows8(max(la, 1))), dtype=np.int32)
        sa_pin_row[:, :la] = pin.astype(np.int32)
        sa_match_row = np.zeros((len(gid), _rows8(fd)), dtype=np.int32)
        sa_match_row[:, :fd] = gt.saa_rows[:, gid].T.astype(np.int32)
        out.update(
            sa_la=la, sa_sig=gt.saa_sig[gid].astype(np.int32),
            sa_pin_row=sa_pin_row, sa_match_row=sa_match_row,
            sa_val_tbl=rows(np.asarray(ptabs.sa_val)[:la], _rows8(max(la, 1))),
            sa_lock_init=np.asarray(ptabs.sa_lock_init,
                                    dtype=np.int32)[:fd])
    return out


def ipod_table(gt, lay: IpLayout, num_g: int, gpad: int) -> np.ndarray:
    """The [Gpad, Wip] packed inter-pod rows of the merged groups."""
    tbl = np.zeros((gpad, lay.width), dtype=np.int32)
    gi = np.arange(num_g)
    tm = gt.term_match.astype(np.int32)            # [Td, G]

    def put(offset, arr):
        a = np.asarray(arr).reshape(num_g, -1).astype(np.int32)
        tbl[:num_g, offset:offset + a.shape[1]] = a

    def pad_groups(a3):
        # [G, T, G] match lanes -> [G, T, Gpad]
        out = np.zeros((num_g, a3.shape[1], gpad), np.int32)
        out[:, :, :num_g] = a3
        return out

    def exist_bits(term_ids, t_):
        # [G_me, Gpad, T]: lane (g2, t) = term t of group g2 matches me
        out = np.zeros((num_g, gpad, t_), np.int32)
        out[:, :num_g] = tm[term_ids][:, :, gi].transpose(2, 0, 1)
        return out

    put(lay.aff_match, pad_groups(tm[gt.aff_term]))
    put(lay.aff_key, gt.aff_key)
    put(lay.aff_valid, gt.aff_valid)
    put(lay.aff_empty, gt.aff_empty)
    put(lay.aff_host, gt.aff_hostname)
    put(lay.aff_self, gt.aff_self)
    put(lay.aff_unpl, gt.aff_unplaced)
    put(lay.aff_err, gt.aff_err)
    put(lay.anti_match, pad_groups(tm[gt.anti_term]))
    put(lay.anti_key, gt.anti_key)
    put(lay.anti_valid, gt.anti_valid)
    put(lay.anti_host, gt.anti_hostname)
    put(lay.anti_err, gt.anti_err)
    put(lay.pref_match, pad_groups(tm[gt.pref_term]))
    put(lay.pref_key, gt.pref_key)
    put(lay.pref_w, np.round(gt.pref_w).astype(np.int64))
    put(lay.ex_anti, exist_bits(gt.anti_term, gt.anti_term.shape[1]))
    put(lay.ex_pref, exist_bits(gt.pref_term, gt.pref_term.shape[1]))
    put(lay.ex_aff, exist_bits(gt.aff_term, gt.aff_term.shape[1]))
    return tbl


def plan_from_numpy(fields_: dict) -> FastPlan:
    """A FastPlan from a dict of numpy arrays and scalars holding at least
    this plan's fields (for instance another implementation's plan in dict
    form, its policy a dict of PolicySpec's fields). Extra keys are
    ignored."""
    kw = {}
    for f in fields(FastPlan):
        v = fields_[f.name]
        if f.name == "policy" and v is not None:
            v = v if isinstance(v, PolicySpec) else PolicySpec(**v)
        elif isinstance(v, np.ndarray):
            v = np.ascontiguousarray(v, dtype=np.int32)
        elif isinstance(v, (list, tuple)):
            v = tuple(x if isinstance(x, bool) else int(x) for x in v)
        kw[f.name] = v
    return FastPlan(**kw)
