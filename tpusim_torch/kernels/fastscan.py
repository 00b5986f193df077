"""The fused fast-scan chunk: the CUDA kernel's wrapper and its plain
PyTorch version.

One call schedules a chunk of pods in order against the node state and
updates the carry in place (the carry tensor is the running cluster state;
updating it in place keeps one copy on the device). Tensor layout, all int32
and contiguous, node axis padded to Npad:

  pods     [k, 13 + S + 1 + 3W]  POD_FIELDS, the S scalar requests, the
                        merged group id, then the pod's port-conflict, disk-
                        conflict and spread group sets as W = ceil(Gpad/32)
                        bit words each (bit g of word w = group 32w + g)
  statics  [8, Npad]    STATIC_ROWS
  tables   six [S_x, Npad] signature tables, TABLES order
  carry    [7 + Srows + Gpad + Vpad, Npad]  CARRY_ROWS, the scalar rows, the
                        presence rows (pods per merged group and node), the
                        MaxPD used-volume rows (0/1)
  misc     [128]        rr at [0]
  alloc_scalar [Srows, Npad] (an empty [0, Npad] tensor when S == 0)
  groups   GroupArgs: the static pod-group operands (Variants 2 and 4)
  ip       IpArgs: the static inter-pod operands (Variant 3), or None
  pd       [Gpad*K, Dpad]  the presence_dom carry (inter-pod only): row
                        g*K + k counts the pods of group g per domain of
                        topology key k; updated in place like the carry
  pol      PolicyArgs: a scheduler policy's stage program, weights and
                        residue tables (Variant 5), or None. A policy plan's
                        pod rows go on with POLICY_COLUMNS: the pod's
                        ServiceAntiAffinity group set as W bit words, its
                        image-set id, its ServiceAffinity signature, its La
                        ServiceAffinity pins and its Fd lock match flags;
                        misc lanes 1..Fd hold the ServiceAffinity locks

Returns (choices [k], counts [k, num_bits], advanced [k]). A CPU tensor runs
the plain version; a CUDA tensor launches the kernel of csrc/fastscan.cu.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tpusim_torch.config import PolicySpec, policy_weights
from tpusim_torch.engine import predicates as preds
from tpusim_torch.engine.priorities import MAX_PRIORITY
from tpusim_torch.fastplan import PAD_SENTINEL_BIT, IpLayout
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
)

POD_FIELDS = ("req_cpu", "req_mem", "req_gpu", "req_eph", "nz_cpu", "nz_mem",
              "zero_request", "best_effort", "sel_id", "tol_id", "aff_id",
              "avoid_id", "host_id")
STATIC_ROWS = ("alloc_cpu", "alloc_mem", "alloc_gpu", "alloc_eph", "allowed",
               "cond_bits", "mem_pressure", "disk_pressure")
TABLES = ("selector_ok", "taint_ok", "intolerable", "aff_count",
          "avoid_score", "host_ok")
CARRY_ROWS = 7
MISC_WIDTH = 128
MAX_ZONES = 16       # zone domains the kernel's shared zone sums hold
# the kernel's launch geometry (csrc/fastscan.cu kMaxThreads, kMaxCluster,
# kScratchRows): one thread-block cluster of CLUSTER_SIZES CTAs, each on its
# own SM, at most MAX_THREADS threads a CTA, SCRATCH_ROWS per-node scratch
# rows held in dynamic shared memory where they fit beside the kernel's
# static shared memory (under STATIC_SMEM_RESERVE) in the SMEM_LIMIT bytes
# an H100 CTA can use
MAX_THREADS = 512
CLUSTER_SIZES = (16, 8, 4, 2, 1)
SCRATCH_ROWS = 5
SMEM_LIMIT = 232_448
STATIC_SMEM_RESERVE = 32_768
# the kernel's instantiations, by the variant id its C entry takes
VARIANTS = ("group_free", "groups", "interpod", "policy", "policy_interpod")
# flag bits of the kernel's group features
F_PORTS, F_DISK, F_SPREAD, F_VOL_ZONE = 1, 2, 4, 8


def group_words(gpad: int) -> int:
    """Bit words a pod's group set takes in its pod row."""
    return -(-gpad // 32)


@dataclass(frozen=True)
class GroupArgs:
    """The static pod-group operands of one plan on one device. The default
    is the group-free plan (Variant 1)."""

    gpad: int = 0                 # presence carry rows (0: none)
    has_ports: bool = False
    has_disk: bool = False
    has_spread: bool = False
    has_vol_zone: bool = False
    zone_id: Optional[torch.Tensor] = None   # [Npad] zone domain, 0 = none
    n_zones: int = 0                          # zone ids are < n_zones
    zone_ok: Optional[torch.Tensor] = None   # [G, Npad] 0/1 by gid
    n_vols: int = 0                           # MaxPD volume ids (0: off)
    vpad: int = 0                             # used-volume carry rows
    vol_tbl: Optional[torch.Tensor] = None   # [G, Vw] 0/1 by gid
    vol_type: Optional[torch.Tensor] = None  # [V, 3] (EBS, GCE, AzureDisk)
    limits: Tuple[int, int, int] = (0, 0, 0)
    maxpd_types: int = 7                      # counted types, bit t = type t

    @property
    def words(self) -> int:
        return group_words(self.gpad)

    @property
    def flags(self) -> int:
        return (F_PORTS * self.has_ports | F_DISK * self.has_disk
                | F_SPREAD * self.has_spread | F_VOL_ZONE * self.has_vol_zone)

    @property
    def variant(self) -> str:
        """The kernel variant a plan with these operands runs."""
        return "groups" if (self.gpad or self.flags or self.n_vols) \
            else "group_free"


NO_GROUPS = GroupArgs()


@dataclass(frozen=True)
class Geometry:
    """One launch of the kernel: one cluster of `cluster` CTAs of `threads`
    threads. CTA r owns the node slab `slabs[r]`, none wider than `slab`;
    its threads own contiguous runs of `nodes_per_thread` nodes, so node
    order is (rank, thread) order. `smem` dynamic shared bytes hold the
    per-node scratch where `scratch_in_smem` (else it lives in device
    memory), then each CTA's replica of an inter-pod plan's presence_dom
    carry."""

    cluster: int
    threads: int
    slab: int
    slabs: Tuple[Tuple[int, int], ...]
    smem: int
    scratch_in_smem: bool

    @property
    def nodes_per_thread(self) -> int:
        return -(-self.slab // self.threads)


def slab_bounds(npad: int, cluster: int) -> Tuple[Tuple[int, int], ...]:
    """The node slab of each CTA: the u = npad / 32 lane groups split in
    rank order as evenly as floors allow, so no slab is empty while
    cluster <= u."""
    units = npad // 32
    return tuple((32 * (r * units // cluster), 32 * ((r + 1) * units // cluster))
                 for r in range(cluster))


def launch_geometry(npad: int, cluster: Optional[int] = None,
                    pd_words: int = 0) -> Geometry:
    """The kernel's geometry on an Npad-node axis: `cluster` CTAs (default
    the largest of CLUSTER_SIZES with a lane group of 32 nodes a CTA at
    least), one node a thread up to MAX_THREADS threads; a replica of the
    `pd_words` presence_dom cells of an inter-pod plan (at most 128 KB
    within the plan's budgets) and, where it fits beside, the scratch in
    shared memory."""
    if npad <= 0 or npad % 32:
        raise ValueError(f"Npad {npad}: the kernel takes a positive multiple "
                         "of 32")
    units = npad // 32
    if cluster is None:
        cluster = next(c for c in CLUSTER_SIZES if c <= units)
    elif cluster not in CLUSTER_SIZES or cluster > units:
        raise ValueError(f"a cluster of {cluster} CTAs on Npad {npad}: the "
                         f"kernel takes one of {CLUSTER_SIZES} up to "
                         f"{units} (Npad / 32)")
    slab = 32 * -(-units // cluster)
    room = SMEM_LIMIT - STATIC_SMEM_RESERVE - 4 * pd_words
    if room < 0:
        raise ValueError(f"{pd_words} presence_dom cells: the kernel holds "
                         f"{(SMEM_LIMIT - STATIC_SMEM_RESERVE) // 4}")
    scratch = SCRATCH_ROWS * slab * 4
    in_smem = scratch <= room
    return Geometry(cluster, min(MAX_THREADS, slab), slab,
                    slab_bounds(npad, cluster),
                    4 * pd_words + scratch * in_smem, in_smem)

# the kernel's compile-time maxima for Variant 3 (the plan's default budgets)
MAX_TOPO_KEYS, MAX_TOPO_DOMS, MAX_TERMS, MAX_IP_GROUPS = 4, 64, 4, 128
# the exist-side tables of a plan, concatenated in this order into
# IpArgs.exist: (name, term kind) with lengths Gpad * T of that kind
EXIST_TABLES = (("exist_anti_key", "tb"), ("exist_anti_mask", "tb"),
                ("exist_anti_empty", "tb"), ("exist_pref_key", "tp"),
                ("exist_pref_w", "tp"), ("exist_aff_key", "ta"),
                ("exist_aff_mask", "ta"))


@dataclass(frozen=True)
class IpArgs:
    """The static inter-pod operands of one plan on one device (Variant 3):
    the dimensions, the hard weight, the [Kpad, Npad] domain rows, the
    [Gpad, Wip] packed rows by group id (fastplan.IpLayout), and the
    exist-side tables (the other groups' term keys, masks and weights) as
    one int32 vector in EXIST_TABLES order, on the device (`exist`) and on
    the host (`exist_host`)."""

    k_keys: int
    d_doms: int
    ta: int
    tb: int
    tp: int
    hard_weight: int
    topo: torch.Tensor
    ipod: torch.Tensor
    exist: torch.Tensor
    exist_host: Tuple[int, ...]

    def exist_table(self, name: str, gpad: int) -> Tuple[int, ...]:
        at = 0
        for table, kind in EXIST_TABLES:
            size = gpad * getattr(self, kind)
            if table == name:
                return self.exist_host[at:at + size]
            at += size
        raise KeyError(name)


# stage opcodes of a stage program (csrc/fastscan.cu OP_*): each stage is an
# (opcode, operand) pair, the operand a label row for OP_LABEL, the counted
# MaxPD types for OP_MAXPD and (first label | labels << 16) of a
# ServiceAffinity entry for OP_SA
(OP_COND, OP_UNSCHED, OP_GENERAL, OP_HOST, OP_PORTS, OP_SEL, OP_RES, OP_DISK,
 OP_TAINT, OP_NOEXEC, OP_MAXPD, OP_VOL_ZONE, OP_MEM_PRESSURE,
 OP_DISK_PRESSURE, OP_INTERPOD, OP_LABEL, OP_SA) = range(17)
NUM_OPS = 17
# the kernel's compile-time maxima for Variant 5
MAX_STAGES, MAX_SAA = 64, 8
# the policy header (PolicyArgs.header), int32: the stage count, the eight
# component weights (config.policy_weights order), the image weight, the
# ServiceAntiAffinity entry and domain counts, count mode, whether binds
# lock ServiceAffinity signatures, the lock slots Fd, the labels La, the
# ServiceAntiAffinity weights, then the program's pairs
(H_STAGES, H_WEIGHTS, H_W_IMAGE, H_N_SAA, H_SAA_DOMS, H_COUNT_MODE,
 H_SA_LOCKS, H_FD, H_LA, H_SAA_W) = (0, 1, 9, 10, 11, 12, 13, 14, 15, 16)
H_PROGRAM = H_SAA_W + MAX_SAA
POL_WORDS = H_PROGRAM + 2 * MAX_STAGES


def stage_program(ps: Optional[PolicySpec], groups: GroupArgs,
                  has_interpod: bool) -> Tuple[Tuple[int, int], ...]:
    """The filter stages of a plan as (opcode, operand) pairs, in
    predicatesOrdering with a policy's gating (ps None: the provider's
    pipeline): label-presence rows, ServiceAffinity entries and the 1.0
    PodFitsPorts alias at the ordering slot they were registered under,
    "tail:<k>" slots last in k order, and in count mode
    CheckNodeUnschedulable once more beside the condition stage."""
    en = None if ps is None else ps.pred_keys

    def on(name):
        return en is None or name in en

    def part(name):
        return en is not None and name in en

    prog = []
    label_at, sa_at = {}, {}
    if ps is not None:
        for i, slot in enumerate(ps.label_rows):
            label_at.setdefault(slot, []).append(i)
        first = 0
        for slot, seg in zip(ps.sa_slots, ps.sa_segs):
            sa_at.setdefault(slot, []).append(first | seg << 16)
            first += seg

    def stage(op, operand=0):
        prog.append((op, operand))

    def emit(slot):
        if ps is None:
            return
        for row in label_at.get(slot, ()):
            stage(OP_LABEL, row)
        for entry in sa_at.get(slot, ()):
            stage(OP_SA, entry)
        if slot in ps.ports_slots and groups.has_ports:
            stage(OP_PORTS)

    stage(OP_COND)
    if ps is not None and ps.always_check_all \
            and part(preds.CHECK_NODE_UNSCHEDULABLE_PRED):
        stage(OP_UNSCHED)
    emit(preds.CHECK_NODE_UNSCHEDULABLE_PRED)
    if on(preds.GENERAL_PRED):
        stage(OP_GENERAL)
    emit(preds.GENERAL_PRED)
    for name, op in ((preds.HOSTNAME_PRED, OP_HOST),
                     (preds.POD_FITS_HOST_PORTS_PRED, OP_PORTS),
                     (preds.MATCH_NODE_SELECTOR_PRED, OP_SEL),
                     (preds.POD_FITS_RESOURCES_PRED, OP_RES)):
        if part(name) and (op != OP_PORTS or groups.has_ports):
            stage(op)
        emit(name)
    if groups.has_disk and on(preds.NO_DISK_CONFLICT_PRED):
        stage(OP_DISK)
    emit(preds.NO_DISK_CONFLICT_PRED)
    if on(preds.POD_TOLERATES_NODE_TAINTS_PRED):
        stage(OP_TAINT)
    emit(preds.POD_TOLERATES_NODE_TAINTS_PRED)
    if ps is not None and ps.has_noexec:
        stage(OP_NOEXEC)
    for name in (preds.POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
                 preds.CHECK_NODE_LABEL_PRESENCE_PRED,
                 preds.CHECK_SERVICE_AFFINITY_PRED):
        emit(name)
    if groups.n_vols:
        stage(OP_MAXPD, groups.maxpd_types)
    for name in (preds.MAX_EBS_VOLUME_COUNT_PRED,
                 preds.MAX_GCE_PD_VOLUME_COUNT_PRED,
                 preds.MAX_AZURE_DISK_VOLUME_COUNT_PRED,
                 preds.CHECK_VOLUME_BINDING_PRED):
        emit(name)
    for name, op, want in (
            (preds.NO_VOLUME_ZONE_CONFLICT_PRED, OP_VOL_ZONE,
             groups.has_vol_zone),
            (preds.CHECK_NODE_MEMORY_PRESSURE_PRED, OP_MEM_PRESSURE, True),
            (preds.CHECK_NODE_DISK_PRESSURE_PRED, OP_DISK_PRESSURE, True),
            (preds.MATCH_INTERPOD_AFFINITY_PRED, OP_INTERPOD, has_interpod)):
        if want and on(name):
            stage(op)
        emit(name)
    if ps is not None:
        tails = {slot for slot in (*ps.label_rows, *ps.sa_slots,
                                   *ps.ports_slots) if slot.startswith("tail:")}
        for k in sorted(int(slot.split(":", 1)[1]) for slot in tails):
            emit(f"tail:{k}")
    return tuple(prog)


@dataclass(frozen=True)
class PolicyArgs:
    """A scheduler policy's operands on one device (Variant 5): the spec,
    its stage program, the header the kernel reads (H_* layout) on the
    device, the residue tables (None where the policy does not use one) and
    their dimensions."""

    spec: PolicySpec
    program: Tuple[Tuple[int, int], ...]
    header: torch.Tensor
    la: int = 0                   # ServiceAffinity labels (pod pin columns)
    fd: int = 0                   # ServiceAffinity lock slots
    n_saa_doms: int = 0           # ServiceAntiAffinity domains incl. 0
    label_tbl: Optional[torch.Tensor] = None    # [Lpad, Npad]
    label_prio: Optional[torch.Tensor] = None   # [1, Npad]
    image_tbl: Optional[torch.Tensor] = None    # [Si, Npad] by img_id
    noexec_tbl: Optional[torch.Tensor] = None   # [Ctol, Npad] by tol_id
    saa_dom: Optional[torch.Tensor] = None      # [Epad, Npad]
    sa_val: Optional[torch.Tensor] = None       # [Lapad, Npad]


def policy_header(ps: PolicySpec, program, la: int, fd: int,
                  n_saa_doms: int) -> list:
    """The H_* header of a policy plan as a list of POL_WORDS ints."""
    if len(program) > MAX_STAGES or len(ps.saa_weights) > MAX_SAA:
        raise ValueError(f"{len(program)} stages and "
                         f"{len(ps.saa_weights)} ServiceAntiAffinity "
                         f"entries: the kernel holds {MAX_STAGES} and "
                         f"{MAX_SAA}")
    h = [0] * POL_WORDS
    h[H_STAGES] = len(program)
    h[H_WEIGHTS:H_WEIGHTS + 8] = policy_weights(ps, False)
    h[H_W_IMAGE] = ps.w_image
    h[H_N_SAA] = len(ps.saa_weights)
    h[H_SAA_DOMS] = n_saa_doms
    h[H_COUNT_MODE] = int(ps.always_check_all)
    h[H_SA_LOCKS] = int(ps.sa_enabled)
    h[H_FD] = fd
    h[H_LA] = la
    h[H_SAA_W:H_SAA_W + len(ps.saa_weights)] = ps.saa_weights
    for t, (op, operand) in enumerate(program):
        h[H_PROGRAM + 2 * t:H_PROGRAM + 2 * t + 2] = (op, operand)
    return h


def pod_width(num_scalars: int, groups: GroupArgs,
              pol: Optional[PolicyArgs] = None) -> int:
    policy = 0 if pol is None else groups.words + 2 + pol.la + pol.fd
    return len(POD_FIELDS) + num_scalars + 1 + 3 * groups.words + policy


def _bit(mask, b):
    return mask.to(torch.int32) << b


def _set_groups(words) -> list:
    """The group ids whose bits are set in a pod's bit words."""
    return [32 * w + b for w, word in enumerate(words) for b in range(32)
            if (word >> b) & 1]


class _PodGroups:
    """One pod's group operands, read from its pod row."""

    def __init__(self, row, num_scalars: int, groups: GroupArgs):
        at = len(POD_FIELDS) + num_scalars
        w = groups.words
        self.gid = row[at]
        self.ports = _set_groups(row[at + 1:at + 1 + w])
        self.disk = _set_groups(row[at + 1 + w:at + 1 + 2 * w])
        self.spread = _set_groups(row[at + 1 + 2 * w:at + 1 + 3 * w])
        self.vols = []
        if groups.n_vols:
            mask = groups.vol_tbl[self.gid, :groups.n_vols].tolist()
            self.vols = [v for v, m in enumerate(mask) if m]


def _present(pres, gs, like):
    """Nodes where any pod of the groups `gs` sits."""
    if not gs:
        return torch.zeros_like(like, dtype=torch.bool)
    return (pres[gs] > 0).any(dim=0)


def _maxpd_fail(pg: _PodGroups, groups: GroupArgs, uv, like, counted: int):
    """Max{EBS,GCEPD,AzureDisk}VolumeCount (predicates.go:422-460): the
    unique relevant volume ids on the node, mine included, against each
    counted type's limit; a pod adding no volume of a type passes that
    type."""
    fail = torch.zeros_like(like, dtype=torch.bool)
    if not pg.vols:
        return fail
    types = groups.vol_type[:groups.n_vols].tolist()
    mine = set(pg.vols)
    for t in range(3):
        if not (counted >> t) & 1:
            continue
        typed = [v for v in range(groups.n_vols) if types[v][t]]
        if not any(v in mine for v in typed):
            continue
        cnt = torch.zeros_like(like)
        for v in typed:
            cnt = cnt + (1 if v in mine else uv[v])
        fail = fail | (cnt > groups.limits[t])
    return fail


class PodInterpod:
    """One pod's inter-pod operands (its group's packed row) and the sums
    its stage and score read, from the presence and presence_dom carries."""

    def __init__(self, gid: int, ip: IpArgs, gpad: int, pres, pd):
        self.ip, self.gpad, self.pres, self.pd = ip, gpad, pres, pd
        self.lay = IpLayout(ip.ta, ip.tb, ip.tp, gpad)
        self.row = ip.ipod[gid].tolist()
        self.topo = ip.topo[:ip.k_keys].long()      # [K, Npad] domain ids

    def own_term(self, match_off: int, key_off: int, t: int):
        """One own term: (matched presence per node, the per-domain sum of
        it at each node's domain, each node's domain). Pad nodes lie in
        domain 0 with no presence, so they add to no real domain."""
        gs = [g for g in range(self.gpad)
              if self.row[match_off + t * self.gpad + g]]
        like = self.topo[0]
        mcount = (self.pres[gs].sum(dim=0, dtype=torch.int32) if gs
                  else torch.zeros_like(like, dtype=torch.int32))
        domsel = self.topo[self.row[key_off + t]]
        seg = torch.zeros(self.ip.d_doms, dtype=torch.int32,
                          device=like.device)
        seg.index_add_(0, domsel, mcount)
        return mcount, seg[domsel], domsel

    def _exist_rows(self, name: str, kind: str):
        """(group, topology key, table value) of every other-group term of
        this exist table whose term matches me and whose value is set."""
        t_n = getattr(self.ip, kind)
        values = self.ip.exist_table(name, self.gpad)
        keys = self.ip.exist_table(name.rsplit("_", 1)[0] + "_key", self.gpad)
        bits_at = {"tb": self.lay.ex_anti, "tp": self.lay.ex_pref,
                   "ta": self.lay.ex_aff}[kind]
        return [(idx // t_n, keys[idx], v) for idx, v in enumerate(values)
                if v and self.row[bits_at + idx]]

    def _dom_lookup(self, per_key):
        """Per node the sum over keys k of per_key[k] at the node's domain
        of key k, domains >= 1 only."""
        out = torch.zeros_like(self.topo[0], dtype=torch.int32)
        for k, vals in per_key.items():
            dom = self.topo[k]
            out = out + torch.where(dom >= 1, vals[dom], 0)
        return out

    def stage(self, like):
        """MatchInterPodAffinity (predicates.go:1125-1450): (fail mask,
        reason bits): the umbrella bit plus existing-anti, affinity or
        anti-affinity, in that order."""
        ip, lay, row = self.ip, self.lay, self.row
        no = torch.zeros_like(like, dtype=torch.bool)
        aff_fail = no | bool(row[lay.aff_err])
        for t in range(ip.ta):
            if not row[lay.aff_valid + t]:
                continue
            mcount, dc_at, domsel = self.own_term(lay.aff_match, lay.aff_key, t)
            on_node = mcount > 0
            if row[lay.aff_host + t]:
                matches, exists = (domsel > 0) & on_node, on_node
            else:
                # "a matching pod exists" is global, unplaced pods included
                matches = (domsel > 0) & (dc_at > 0)
                exists = no | (int(mcount.sum()) > 0 or bool(
                    row[lay.aff_unpl + t]))
            ok = matches | (~exists & bool(row[lay.aff_self + t]))
            aff_fail = aff_fail | ~ok
        anti_fail = no | bool(row[lay.anti_err])
        for t in range(ip.tb):
            if not row[lay.anti_valid + t]:
                continue
            mcount, dc_at, domsel = self.own_term(lay.anti_match, lay.anti_key,
                                                  t)
            hit = mcount > 0 if row[lay.anti_host + t] else dc_at > 0
            anti_fail = anti_fail | ((domsel > 0) & hit)
        # existing pods' required anti-affinity against me
        d, k_n = ip.d_doms, ip.k_keys
        bk = {}
        for g, k, _ in self._exist_rows("exist_anti_mask", "tb"):
            bk[k] = bk.get(k, 0) + self.pd[g * k_n + k, :d]
        exist_fail = self._dom_lookup(bk) > 0
        for g, _, _ in self._exist_rows("exist_anti_empty", "tb"):
            if int(self.pres[g].sum()) > 0:
                exist_fail = exist_fail | True
        fail = exist_fail | aff_fail | anti_fail
        bits = (1 << BIT_AFFINITY_NOT_MATCH) | torch.where(
            exist_fail, 1 << BIT_EXISTING_ANTI_AFFINITY,
            torch.where(aff_fail, 1 << BIT_AFFINITY_RULES,
                        1 << BIT_ANTI_AFFINITY_RULES))
        return fail, bits.to(torch.int32)

    def counts(self):
        """InterPodAffinityPriority's counts per node
        (interpod_affinity.go): my preferred terms over the pods present,
        the existing pods' preferred terms and required affinity terms (x
        the hard weight) over me; int32, products wrap."""
        ip, lay, row = self.ip, self.lay, self.row
        out = torch.zeros_like(self.topo[0], dtype=torch.int32)
        for t in range(ip.tp):
            w_t = row[lay.pref_w + t]
            if not w_t:
                continue
            _, dc_at, domsel = self.own_term(lay.pref_match, lay.pref_key, t)
            out = out + torch.where(domsel > 0, dc_at, 0) * w_t
        d, k_n = ip.d_doms, ip.k_keys
        wk = {}
        for g, k, w in self._exist_rows("exist_pref_w", "tp"):
            wk[k] = wk.get(k, 0) + self.pd[g * k_n + k, :d] * w
        for g, k, _ in self._exist_rows("exist_aff_mask", "ta"):
            wk[k] = wk.get(k, 0) + self.pd[g * k_n + k, :d] * ip.hard_weight
        return out + self._dom_lookup(wk)

    def bind(self, gid: int, choice: int):
        for k in range(self.ip.k_keys):
            self.pd[gid * self.ip.k_keys + k, int(self.topo[k, choice])] += 1


def pod_interpod(row, num_scalars: int, groups: GroupArgs,
                 ip: Optional[IpArgs], carry, alloc_scalar, pd):
    """The inter-pod operands of one pod (`row`, a list of its pod
    columns) against the current carries, or None for a plan without
    inter-pod terms."""
    if ip is None:
        return None
    pres0 = CARRY_ROWS + alloc_scalar.shape[0]
    gid = row[len(POD_FIELDS) + num_scalars]
    return PodInterpod(gid, ip, groups.gpad,
                       carry[pres0:pres0 + groups.gpad], pd)


def interpod_score(counts, feasible):
    """The normalized InterPodAffinityPriority: min and max over the
    feasible nodes, both clamped at 0, and a floored ratio."""
    fc = counts[feasible]
    maxc = max(int(fc.max()), 0)
    minc = min(int(fc.min()), 0)
    rng = maxc - minc
    if rng <= 0:
        return torch.zeros_like(counts)
    return (MAX_PRIORITY * (counts - minc)) // rng


class PodPolicy:
    """One pod's policy operands, read from its pod row, and its
    ServiceAffinity lock from the misc carry."""

    def __init__(self, row, num_scalars: int, groups: GroupArgs,
                 pol: PolicyArgs, misc):
        at = len(POD_FIELDS) + num_scalars + 1 + 3 * groups.words
        w = groups.words
        self.saa = _set_groups(row[at:at + w])
        self.img_id = row[at + w]
        sig = row[at + w + 1]
        self.pins = row[at + w + 2:at + w + 2 + pol.la]
        self.match = row[at + w + 2 + pol.la:at + w + 2 + pol.la + pol.fd]
        self.lock = int(misc[1 + sig]) if pol.fd else -1

    def sa_fail(self, pol: PolicyArgs, operand: int, like):
        """CheckServiceAffinity for one entry (predicates.go:853-944): my
        own nodeSelector pins, else the first matching pod's node's values
        (lock >= 0; a label the locked node lacks pins nothing)."""
        first, count = operand & 0xFFFF, operand >> 16
        ok_own = torch.ones_like(like, dtype=torch.bool)
        ok_lock = torch.ones_like(like, dtype=torch.bool)
        for l_ in range(first, first + count):
            val, pin = pol.sa_val[l_], self.pins[l_]
            if pin != 0:
                ok_own = ok_own & (val == pin)
            elif self.lock >= 0:
                locked = int(val[self.lock])
                if locked > 0:
                    ok_lock = ok_lock & (val == locked)
        return ~(ok_own & (ok_lock | (self.lock < 0)))


def pod_stages(row, statics, tables, carry, alloc_scalar, num_scalars: int,
               groups: GroupArgs = NO_GROUPS,
               ipp: Optional[PodInterpod] = None,
               pol: Optional[PolicyArgs] = None,
               pp: Optional[PodPolicy] = None):
    """The filter stages of one pod (`row`, a list of its pod columns)
    against the current carry, as [(fail mask, reason bits)] in stage
    program order: the policy's program, or the provider's pipeline
    (with MatchInterPodAffinity when `ipp`, the pod's inter-pod operands,
    is given)."""
    rc, rm, rg, re_, _, _, zero, best_effort, sel, tol, _, _, host = row[:13]
    rs = row[13:13 + num_scalars]
    acpu, amem, agpu, aeph, allowed, cond, mpr, dpr = statics
    sel_t, tol_t, _, _, _, host_t = tables
    used_c, used_m, used_g, used_e, _, _, pc = carry[:CARRY_ROWS]
    pres0 = CARRY_ROWS + alloc_scalar.shape[0]
    pres = carry[pres0:pres0 + groups.gpad]
    uv = carry[pres0 + groups.gpad:pres0 + groups.gpad + groups.vpad]
    pg = _PodGroups(row, num_scalars, groups)
    insuff_pods = (pc + 1) > allowed
    bits_res = _bit(insuff_pods, BIT_INSUFFICIENT_PODS)
    fail_res = insuff_pods
    if zero == 0:
        for b, (alloc, used, req) in zip(
                (BIT_INSUFFICIENT_CPU, BIT_INSUFFICIENT_MEMORY,
                 BIT_INSUFFICIENT_GPU, BIT_INSUFFICIENT_EPHEMERAL),
                ((acpu, used_c, rc), (amem, used_m, rm),
                 (agpu, used_g, rg), (aeph, used_e, re_))):
            ins = alloc < used + req
            fail_res = fail_res | ins
            bits_res = bits_res | _bit(ins, b)
        for si in range(num_scalars):
            ins = alloc_scalar[si] < carry[CARRY_ROWS + si] + rs[si]
            fail_res = fail_res | ins
            bits_res = bits_res | _bit(ins, NUM_FIXED_BITS + si)
    host_bad = host_t[host] == 0
    sel_bad = sel_t[sel] == 0
    # PodFitsHostPorts, inside GeneralPredicates (predicates.go:1019-1039)
    port_bad = _present(pres, pg.ports, cond)

    def stage(op, operand):
        if op == OP_COND:
            return cond != 0, cond
        if op == OP_UNSCHED:
            return ((cond >> BIT_NODE_UNSCHEDULABLE) & 1) != 0, \
                1 << BIT_NODE_UNSCHEDULABLE
        if op == OP_GENERAL:
            return (fail_res | host_bad | sel_bad | port_bad,
                    bits_res | _bit(host_bad, BIT_HOSTNAME_MISMATCH)
                    | _bit(sel_bad, BIT_NODE_SELECTOR_MISMATCH)
                    | _bit(port_bad, BIT_HOST_PORTS))
        if op == OP_HOST:
            return host_bad, 1 << BIT_HOSTNAME_MISMATCH
        if op == OP_PORTS:
            return port_bad, 1 << BIT_HOST_PORTS
        if op == OP_SEL:
            return sel_bad, 1 << BIT_NODE_SELECTOR_MISMATCH
        if op == OP_RES:
            return fail_res, bits_res
        if op == OP_DISK:
            # NoDiskConflict (predicates.go:266-276)
            return _present(pres, pg.disk, cond), 1 << BIT_DISK_CONFLICT
        if op == OP_TAINT:
            return tol_t[tol] == 0, 1 << BIT_TAINTS_NOT_TOLERATED
        if op == OP_NOEXEC:
            # PodToleratesNodeNoExecuteTaints shares the taint reason
            return pol.noexec_tbl[tol] == 0, 1 << BIT_TAINTS_NOT_TOLERATED
        if op == OP_MAXPD:
            return (_maxpd_fail(pg, groups, uv, cond, operand),
                    1 << BIT_MAX_VOLUME_COUNT)
        if op == OP_VOL_ZONE:
            # NoVolumeZoneConflict (predicates.go:510-533)
            return groups.zone_ok[pg.gid] == 0, 1 << BIT_VOLUME_ZONE_CONFLICT
        if op == OP_MEM_PRESSURE:
            return (mpr != 0) & (best_effort != 0), 1 << BIT_MEMORY_PRESSURE
        if op == OP_DISK_PRESSURE:
            return dpr != 0, 1 << BIT_DISK_PRESSURE
        if op == OP_INTERPOD:
            return ipp.stage(cond)
        if op == OP_LABEL:
            return pol.label_tbl[operand] == 0, 1 << BIT_NODE_LABEL_PRESENCE
        if op == OP_SA:
            return pp.sa_fail(pol, operand, cond), 1 << BIT_SERVICE_AFFINITY
        raise ValueError(f"stage opcode {op}")

    program = (pol.program if pol is not None
               else stage_program(None, groups, ipp is not None))
    return [stage(op, operand) for op, operand in program]


def filter_pod(row, statics, tables, carry, alloc_scalar, num_scalars: int,
               groups: GroupArgs = NO_GROUPS,
               ipp: Optional[PodInterpod] = None,
               pol: Optional[PolicyArgs] = None,
               pp: Optional[PodPolicy] = None):
    """The filter stages for one pod (pod_stages): (feasible mask, reason
    word of the first failing stage) over the node axis."""
    stages = pod_stages(row, statics, tables, carry, alloc_scalar,
                        num_scalars, groups, ipp, pol, pp)
    return first_failure(stages, statics[5])


def first_failure(stages, like):
    """(feasible, the first failing stage's bits per node)."""
    feasible = torch.ones_like(like, dtype=torch.bool)
    reason = torch.zeros_like(like)
    for fail, bits in reversed(stages):
        feasible = feasible & ~fail
        reason = torch.where(fail, bits, reason)
    return feasible, reason


def spread_score(pres, pg: _PodGroups, groups: GroupArgs, feasible):
    """SelectorSpreadPriority (selector_spreading.go:66-175): per node the
    count of pods my services select, normalized over the feasible nodes and
    blended 1:2 with the count of the node's zone when any feasible node has
    a zone. int32 like the kernel; the plan bounds the blend's products."""
    i32 = torch.int32
    cnt = torch.zeros_like(feasible, dtype=i32)
    for g in pg.spread:
        cnt = cnt + pres[g]
    fcnt = torch.where(feasible, cnt, 0)
    max_node = int(fcnt.max())
    zid = groups.zone_id
    zvalid = zid != 0
    zsum = torch.zeros(groups.n_zones, dtype=i32, device=cnt.device)
    zsum.index_add_(0, zid.long(), fcnt)
    zsum[0] = 0
    max_zone = int(zsum.max())
    zper = torch.where(zvalid, zsum[zid.long()], 0)
    have_zones = bool((feasible & zvalid).any())
    node_num = max_node - cnt if max_node > 0 else torch.ones_like(cnt)
    node_den = max(max_node, 1)
    zone_num = max_zone - zper if max_zone > 0 else torch.ones_like(cnt)
    zone_den = max(max_zone, 1)
    plain = (MAX_PRIORITY * node_num) // node_den
    blend = (MAX_PRIORITY * (node_num * zone_den + 2 * zone_num * node_den)
             ) // (3 * node_den * zone_den)
    return torch.where(zvalid & have_zones, blend, plain)


def saa_score(pres, pp: PodPolicy, pol: PolicyArgs, feasible):
    """The ServiceAntiAffinity priorities (selector_spreading.go:176-280),
    weighted and summed: per entry, the feasible nodes' count of pods in my
    first service, normalized per label domain; a node without the label
    scores 0."""
    cnt = torch.zeros_like(feasible, dtype=torch.int32)
    for g in pp.saa:
        cnt = cnt + pres[g]
    fcnt = torch.where(feasible, cnt, 0)
    total = int(fcnt.sum())
    out = torch.zeros_like(cnt)
    for e, w in enumerate(pol.spec.saa_weights):
        dom = pol.saa_dom[e].long()
        seg = torch.zeros(pol.n_saa_doms, dtype=torch.int32,
                          device=cnt.device)
        seg.index_add_(0, dom, fcnt)
        at = seg[dom]
        score = ((MAX_PRIORITY * (total - at)) // max(total, 1) if total > 0
                 else torch.full_like(cnt, MAX_PRIORITY))
        out = out + torch.where(dom > 0, score, 0) * w
    return out


def count_mode_hist(stages, cond, shifts):
    """alwaysCheckAllPredicates' histogram: every failing stage adds its
    reasons on every real node (pad nodes carry only the sentinel bit)."""
    live = ((cond >> PAD_SENTINEL_BIT) & 1) == 0
    total = torch.zeros(shifts.shape[0], dtype=torch.int32,
                        device=cond.device)
    for fail, bits in stages:
        word = torch.where(fail & live, bits, 0)
        total = total + ((word[None, :] >> shifts) & 1).sum(dim=1).to(
            torch.int32)
    return total


def fastscan_chunk_plain(pods, statics, tables, carry, misc, alloc_scalar,
                         num_scalars: int, num_bits: int,
                         most_requested: bool,
                         groups: GroupArgs = NO_GROUPS,
                         ip: Optional[IpArgs] = None, pd=None,
                         pol: Optional[PolicyArgs] = None):
    """The chunk as int32 tensor ops and a Python loop over pods, on the
    inputs' device. The same arithmetic as the kernel: int32 products wrap,
    integer division floors."""
    dev = pods.device
    i32 = torch.int32
    k = pods.shape[0]
    choices = torch.full((k,), -1, dtype=i32, device=dev)
    counts = torch.zeros((k, num_bits), dtype=i32, device=dev)
    adv = torch.zeros((k,), dtype=i32, device=dev)
    acpu, amem = statics[0], statics[1]
    _, tol_t, intol_t, aff_t, avoid_t, _ = tables
    ps = None if pol is None else pol.spec
    (w_least, w_most, w_balanced, w_aff, w_taint, w_avoid, w_spread,
     w_interpod) = policy_weights(ps, most_requested)
    count_mode = ps is not None and ps.always_check_all
    # the bind updates presence only where a stage reads what it binds
    pres_update = groups.gpad and (groups.has_ports or groups.has_disk
                                   or groups.has_spread or ip is not None)
    shifts = torch.arange(num_bits, dtype=i32, device=dev)[:, None]
    pres0 = CARRY_ROWS + alloc_scalar.shape[0]
    uv0 = pres0 + groups.gpad
    rr = int(misc[0])
    rows = pods.cpu().tolist()

    def ratio(req, cap, most):
        valid = (cap > 0) & (req <= cap)
        expr = ((req if most else cap - req) * MAX_PRIORITY) \
            // torch.clamp(cap, min=1)
        return torch.where(valid, expr, 0)

    for j, row in enumerate(rows):
        rc, rm, rg, re_, nzc, nzm, _, _, _, tol, aff, avoid, _ = row[:13]
        rs = row[13:13 + num_scalars]
        nz_c, nz_m = carry[4], carry[5]
        pg = _PodGroups(row, num_scalars, groups)
        ipp = pod_interpod(row, num_scalars, groups, ip, carry, alloc_scalar,
                           pd)
        pp = (None if pol is None
              else PodPolicy(row, num_scalars, groups, pol, misc))
        stages = pod_stages(row, statics, tables, carry, alloc_scalar,
                            num_scalars, groups, ipp, pol, pp)
        feasible, reason = first_failure(stages, statics[5])
        n_feasible = int(feasible.sum())

        if n_feasible == 0:
            if count_mode:
                counts[j] = count_mode_hist(stages, statics[5], shifts)
            else:
                counts[j] = ((reason[None, :] >> shifts) & 1).sum(
                    dim=1).to(i32)
            continue

        # ---- weighted score (generic_scheduler.go:631-639) ----
        total_c = nz_c + nzc
        total_m = nz_m + nzm
        score = torch.zeros_like(acpu)
        if w_least:
            score = score + w_least * ((ratio(total_c, acpu, False)
                                        + ratio(total_m, amem, False)) // 2)
        if w_most:
            score = score + w_most * ((ratio(total_c, acpu, True)
                                       + ratio(total_m, amem, True)) // 2)
        num = (total_c * amem - total_m * acpu).abs()
        den = acpu * amem
        bal = (MAX_PRIORITY * (den - num)) // torch.clamp(den, min=1)
        bal_zero = ((acpu == 0) | (total_c >= acpu) | (amem == 0)
                    | (total_m >= amem))
        score = score + w_balanced * torch.where(bal_zero, 0, bal)
        aff_row = aff_t[aff]
        aff_max = int(torch.where(feasible, aff_row, 0).max())
        if aff_max > 0:
            score = score + w_aff * (MAX_PRIORITY * aff_row // aff_max)
        intol_row = intol_t[tol]
        intol_max = int(torch.where(feasible, intol_row, 0).max())
        if intol_max > 0:
            score = score + w_taint * (
                MAX_PRIORITY - MAX_PRIORITY * intol_row // intol_max)
        else:
            score = score + w_taint * MAX_PRIORITY
        score = score + avoid_t[avoid] * w_avoid
        if pol is not None:
            if pol.label_prio is not None:
                # NodeLabel priorities, weighted on the host
                score = score + pol.label_prio[0]
            if pol.image_tbl is not None:
                score = score + pol.image_tbl[pp.img_id] * ps.w_image
            if pol.saa_dom is not None:
                score = score + saa_score(carry[pres0:uv0], pp, pol, feasible)
        if groups.has_spread:
            score = score + w_spread * spread_score(
                carry[pres0:uv0], pg, groups, feasible)
        if ipp is not None and w_interpod:
            score = score + w_interpod * interpod_score(ipp.counts(), feasible)

        # ---- selectHost: max score, round-robin pick among the ties ----
        masked = torch.where(feasible, score, -1)
        tie = feasible & (masked == masked.max())
        ties = max(int(tie.sum()), 1)
        pick = rr % ties if n_feasible > 1 else 0
        choice = int(torch.nonzero(tie).flatten()[pick])
        choices[j] = choice
        adv[j] = int(n_feasible > 1)
        rr += int(n_feasible > 1)

        # ---- bind: resources, my group's presence, my volume ids ----
        add = torch.tensor([rc, rm, rg, re_, nzc, nzm, 1] + rs, dtype=i32,
                           device=dev)
        carry[:CARRY_ROWS + num_scalars, choice] += add
        if pres_update:
            carry[pres0 + pg.gid, choice] += 1
        for v in pg.vols:
            carry[uv0 + v, choice] = 1
        if ipp is not None:
            ipp.bind(pg.gid, choice)
        if ps is not None and ps.sa_enabled:
            # the first matching bind locks each unlocked signature
            for f in range(pol.fd):
                if int(misc[1 + f]) == -1 and pp.match[f]:
                    misc[1 + f] = choice
    misc[0] = rr
    return choices, counts, adv


def _check(name, t, device, rows=None, cols=None):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if rows is not None and t.shape[0] < rows:
        raise ValueError(f"{name}: {t.shape[0]} rows, need {rows}")
    if cols is not None and (t.dim() != 2 or t.shape[1] != cols):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, need [*, {cols}]")


def _check_groups(groups: GroupArgs, device, npad: int):
    """The group operands the kernel reads; returns their pointers."""
    if groups.has_spread:
        _check("zone_id", groups.zone_id, device)
        if groups.zone_id.numel() != npad:
            raise ValueError(f"zone_id: {groups.zone_id.numel()} values, "
                             f"need {npad}")
        if not 0 < groups.n_zones <= MAX_ZONES:
            raise ValueError(f"{groups.n_zones} zone domains: the kernel "
                             f"holds 1 to {MAX_ZONES}")
    if groups.has_vol_zone:
        _check("zone_ok", groups.zone_ok, device, cols=npad)
    if groups.n_vols:
        _check("vol_tbl", groups.vol_tbl, device)
        _check("vol_type", groups.vol_type, device, rows=groups.n_vols,
               cols=3)
        if groups.vol_tbl.dim() != 2 \
                or groups.vol_tbl.shape[1] < groups.n_vols:
            raise ValueError(f"vol_tbl: shape {tuple(groups.vol_tbl.shape)}, "
                             f"need [*, >= {groups.n_vols}]")
    if groups.vpad < groups.n_vols:
        raise ValueError(f"{groups.vpad} used-volume rows for "
                         f"{groups.n_vols} volume ids")

    def ptr(t, on):
        return t.data_ptr() if on else None

    return (ptr(groups.zone_id, groups.has_spread),
            ptr(groups.zone_ok, groups.has_vol_zone),
            ptr(groups.vol_tbl, groups.n_vols),
            ptr(groups.vol_type, groups.n_vols))


def _check_interpod(ip: IpArgs, pd, groups: GroupArgs, device, npad: int):
    """The inter-pod operands the kernel reads, against its compile-time
    maxima."""
    if not 1 <= groups.gpad <= MAX_IP_GROUPS:
        raise ValueError(f"{groups.gpad} presence rows: the inter-pod kernel "
                         f"holds 1 to {MAX_IP_GROUPS}")
    for name, n, most in (("topology keys", ip.k_keys, MAX_TOPO_KEYS),
                          ("topology domains", ip.d_doms, MAX_TOPO_DOMS),
                          ("affinity terms", ip.ta, MAX_TERMS),
                          ("anti-affinity terms", ip.tb, MAX_TERMS),
                          ("preferred terms", ip.tp, MAX_TERMS)):
        if not 1 <= n <= most:
            raise ValueError(f"{n} {name}: the kernel holds 1 to {most}")
    _check("topo", ip.topo, device, rows=ip.k_keys, cols=npad)
    width = IpLayout(ip.ta, ip.tb, ip.tp, groups.gpad).width
    _check("ipod", ip.ipod, device, rows=groups.gpad, cols=width)
    _check("exist", ip.exist, device)
    want = sum(groups.gpad * getattr(ip, kind) for _, kind in EXIST_TABLES)
    if ip.exist.numel() != want:
        raise ValueError(f"exist: {ip.exist.numel()} values, need {want}")
    _check("pd", pd, device, rows=groups.gpad * ip.k_keys)
    if pd.dim() != 2 or pd.shape[1] < ip.d_doms:
        raise ValueError(f"pd: shape {tuple(pd.shape)}, need "
                         f"[{groups.gpad * ip.k_keys}, >= {ip.d_doms}]")


def _check_policy(pol: PolicyArgs, groups: GroupArgs, device, npad: int):
    """The policy operands the kernel reads; returns their pointers."""
    _check("header", pol.header, device)
    if pol.header.numel() != POL_WORDS:
        raise ValueError(f"header: {pol.header.numel()} values, need "
                         f"{POL_WORDS}")
    if pol.saa_dom is not None and not (
            groups.gpad and 0 < pol.n_saa_doms <= MAX_ZONES):
        raise ValueError(f"{pol.n_saa_doms} ServiceAntiAffinity domains on "
                         f"{groups.gpad} presence rows: the kernel holds 1 "
                         f"to {MAX_ZONES} domains over presence rows")
    if pol.fd >= MISC_WIDTH:
        raise ValueError(f"{pol.fd} ServiceAffinity locks: the misc row "
                         f"holds {MISC_WIDTH - 1}")
    ptrs = []
    for name in ("label_tbl", "label_prio", "image_tbl", "noexec_tbl",
                 "saa_dom", "sa_val"):
        t = getattr(pol, name)
        if t is not None:
            _check(name, t, device, cols=npad)
        ptrs.append(None if t is None else t.data_ptr())
    return ptrs


def _variant(groups: GroupArgs, ip: Optional[IpArgs],
             pol: Optional[PolicyArgs]) -> str:
    """The kernel instantiation a plan's operands run (VARIANTS)."""
    if pol is not None:
        return "policy_interpod" if ip is not None else "policy"
    return "interpod" if ip is not None else groups.variant


_GEOMETRY = {}


def kernel_geometry(npad: int, variant: str, device,
                    cluster: Optional[int] = None,
                    pd_words: int = 0) -> Geometry:
    """The geometry the kernel launches with on `device`: the largest
    cluster of CLUSTER_SIZES (or the forced `cluster`) that the card can
    schedule, by cudaOccupancyMaxActiveClusters. Raises when a forced
    cluster, or none, can be scheduled."""
    device = torch.device(device)
    key = (npad, variant, device.index, cluster, pd_words)
    geom = _GEOMETRY.get(key)
    if geom is not None:
        return geom
    from tpusim_torch.kernels import build

    lib = build.load("fastscan.cu")
    sizes = ((cluster,) if cluster is not None
             else tuple(c for c in CLUSTER_SIZES if c <= npad // 32))
    for c in sizes:
        g = launch_geometry(npad, c, pd_words)
        with torch.cuda.device(device):
            held = lib.tpusim_fastscan_max_clusters(
                VARIANTS.index(variant), g.cluster, g.threads, g.smem)
        if held < 0:
            raise RuntimeError(f"fastscan cluster query failed: CUDA error "
                               f"{-held}")
        if held > 0:
            _GEOMETRY[key] = g
            return g
    raise RuntimeError(f"no cluster of {sizes} CTAs of the {variant} kernel "
                       f"can be scheduled on {device} at Npad {npad}")


def fastscan_chunk(pods, statics, tables, carry, misc, alloc_scalar,
                   num_scalars: int, num_bits: int, most_requested: bool,
                   groups: GroupArgs = NO_GROUPS, ip: Optional[IpArgs] = None,
                   pd=None, pol: Optional[PolicyArgs] = None,
                   cluster: Optional[int] = None):
    """Schedule one chunk of pods: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    The kernel is one thread-block cluster that splits the node axis into
    slabs, one a CTA and SM (launch_geometry; `cluster` forces the number
    of CTAs, which otherwise is the largest the card can schedule). A CTA
    reads and writes only its own nodes' carry cells; per pod the CTAs meet
    at two cluster barriers, exchanging their partial counts, maxima and
    sums and then each warp's score max and ties through distributed
    shared memory, and at a third only where another CTA reads what the
    bind wrote (presence_dom, a new ServiceAffinity lock). A geometry the
    card refuses raises; there is no fallback."""
    device = pods.device
    if device.type == "cpu":
        return fastscan_chunk_plain(pods, statics, tables, carry, misc,
                                    alloc_scalar, num_scalars, num_bits,
                                    most_requested, groups, ip, pd, pol)
    if device.type != "cuda":
        raise ValueError(f"fastscan_chunk runs on cuda or cpu, not {device}")
    npad = statics.shape[1]
    k = pods.shape[0]
    srows = alloc_scalar.shape[0]
    pres_row = CARRY_ROWS + srows
    uv_row = pres_row + groups.gpad
    _check("pods", pods, device, cols=pod_width(num_scalars, groups, pol))
    _check("statics", statics, device, rows=len(STATIC_ROWS), cols=npad)
    for name, t in zip(TABLES, tables):
        _check(name, t, device, cols=npad)
    _check("carry", carry, device, rows=uv_row + groups.vpad, cols=npad)
    _check("misc", misc, device)
    _check("alloc_scalar", alloc_scalar, device, rows=num_scalars, cols=npad)
    if NUM_FIXED_BITS + num_scalars > PAD_SENTINEL_BIT \
            or num_bits > PAD_SENTINEL_BIT:
        raise ValueError(f"{num_scalars} scalar axes / {num_bits} reason "
                         "bits exceed the kernel's int32 reason word")
    zone_id, zone_ok, vol_tbl, vol_type = _check_groups(groups, device, npad)
    if ip is not None:
        _check_interpod(ip, pd, groups, device, npad)
        ip_args = (ip.k_keys, ip.d_doms, ip.ta, ip.tb, ip.tp, ip.hard_weight,
                   ip.topo.data_ptr(), ip.ipod.data_ptr(), ip.ipod.shape[1],
                   ip.exist.data_ptr(), pd.data_ptr(), pd.shape[1])
    else:
        ip_args = (0, 0, 0, 0, 0, 0, None, None, 0, None, None, 0)
    if pol is not None:
        pol_args = (pol.header.data_ptr(),
                    *_check_policy(pol, groups, device, npad))
    else:
        pol_args = (None,) * 7
    from tpusim_torch.kernels import build

    lib = build.load("fastscan.cu")
    variant = _variant(groups, ip, pol)
    pd_words = groups.gpad * ip.k_keys * pd.shape[1] if ip is not None else 0
    geom = kernel_geometry(npad, variant, device, cluster, pd_words)
    i32 = torch.int32
    choices = torch.empty((k,), dtype=i32, device=device)
    counts = torch.empty((k, num_bits), dtype=i32, device=device)
    adv = torch.empty((k,), dtype=i32, device=device)
    scratch = (None if geom.scratch_in_smem else torch.empty(
        (geom.cluster, SCRATCH_ROWS, geom.slab), dtype=i32, device=device))
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.tpusim_fastscan_chunk(
        pods.data_ptr(), k, pods.shape[1], statics.data_ptr(),
        *(t.data_ptr() for t in tables), carry.data_ptr(), misc.data_ptr(),
        alloc_scalar.data_ptr() if num_scalars else None, num_scalars,
        choices.data_ptr(), counts.data_ptr(), adv.data_ptr(),
        None if scratch is None else scratch.data_ptr(), num_bits, npad,
        int(bool(most_requested)),
        groups.gpad, pres_row, groups.flags, zone_id, groups.n_zones,
        zone_ok, vol_tbl,
        groups.vol_tbl.shape[1] if groups.n_vols else 0, vol_type,
        groups.n_vols, uv_row, *groups.limits,
        *ip_args, *pol_args, geom.cluster, geom.threads, geom.smem,
        int(geom.scratch_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"fastscan kernel launch failed: CUDA error {rc}")
    fastscan_chunk.launches += 1
    fastscan_chunk.launches_by_variant[
        "policy" if pol is not None else variant] += 1
    fastscan_chunk.last_geometry = geom
    return choices, counts, adv


# launches of the CUDA kernel, in all and per variant (the plain version
# does not count; both policy instantiations count as "policy"), and the
# geometry of the last launch
fastscan_chunk.launches = 0
fastscan_chunk.launches_by_variant = {"group_free": 0, "groups": 0,
                                      "interpod": 0, "policy": 0}
fastscan_chunk.last_geometry = None
