"""The fused fast scan: pods of a FastPlan through the chunk kernel.

The plan is uploaded once per call; pods run in chunks of CHUNK (512) pods
with the carry (resource rows, presence and used-volume rows, the
presence_dom rows of an inter-pod plan, and rr and a policy's ServiceAffinity
locks in the misc row) chained device to device (the kernel updates it in
place, so consecutive launches on one stream see each other's binds with no
host round trip). Per-chunk outputs
stay on the device until more than TPUSIM_FAST_SYNC_EVERY chunks (default
64) are in flight; then the oldest is copied to the host, so device memory
for outputs stays O(sync_every * chunk) while the host keeps launching ahead
of the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpusim_torch.device import resolve_device
from tpusim_torch.fastplan import GHOST_REQ, FastCarry, FastPlan, init_carry
from tpusim_torch.kernels.fastscan import (
    CARRY_ROWS,
    EXIST_TABLES,
    MISC_WIDTH,
    NO_GROUPS,
    POD_FIELDS,
    STATIC_ROWS,
    TABLES,
    GroupArgs,
    IpArgs,
    PolicyArgs,
    fastscan_chunk,
    group_words,
    policy_header,
    stage_program,
)
from tpusim_torch.state import NUM_FIXED_BITS, env_int

# pods per kernel launch
CHUNK = 512

def pack_groups(rows01: np.ndarray, words: int) -> np.ndarray:
    """[P, Gpad] 0/1 group rows -> [P, words] int32 bit words (bit g of word
    w = group 32w + g)."""
    bits = np.zeros((rows01.shape[0], words * 32), dtype=np.uint64)
    bits[:, :rows01.shape[1]] = rows01 != 0
    shifted = bits.reshape(-1, words, 32) << np.arange(32, dtype=np.uint64)
    return shifted.sum(axis=2).astype(np.uint32).view(np.int32)


def policy_dims(plan: FastPlan):
    """(La, Fd): a policy plan's ServiceAffinity labels and lock slots."""
    fd = 0 if plan.sa_lock_init is None else len(plan.sa_lock_init)
    return plan.sa_la, fd


def pod_matrix(plan: FastPlan, start: int, stop: int, rows: int) -> np.ndarray:
    """Pods [start, stop) as the kernel's [rows, 13 + S + 1 + 3W (+ W + 2 +
    La + Fd)] int32 columns; rows past the span are ghost pods (req_cpu =
    GHOST_REQ: infeasible on every node, so they bind nothing and leave rr
    and the locks untouched; their group id 0 and empty group sets are
    never read for a bind)."""
    w = group_words(plan.num_groups)
    at = len(POD_FIELDS) + plan.num_scalars
    pol_w = 0
    if plan.policy is not None:
        la, fd = policy_dims(plan)
        pol_w = w + 2 + la + fd
    out = np.zeros((rows, at + 1 + 3 * w + pol_w), dtype=np.int32)
    out[:, 0] = GHOST_REQ
    span = stop - start
    for c, name in enumerate(POD_FIELDS):
        out[:span, c] = getattr(plan, name)[start:stop]
    if plan.num_scalars:
        out[:span, len(POD_FIELDS):at] = plan.req_scalar[start:stop]
    if plan.gid is not None:
        out[:span, at] = plan.gid[start:stop]
    for i, name in enumerate(("port_row", "disk_row", "ss_row")):
        sets = getattr(plan, name)
        if sets is not None:
            c0 = at + 1 + i * w
            out[:span, c0:c0 + w] = pack_groups(sets[start:stop], w)
    if plan.policy is not None:
        # the policy columns (kernels/fastscan.py PodPolicy)
        c0 = at + 1 + 3 * w
        if plan.saa_row is not None:
            out[:span, c0:c0 + w] = pack_groups(plan.saa_row[start:stop], w)
        if plan.img_id is not None:
            out[:span, c0 + w] = plan.img_id[start:stop]
        if plan.sa_sig is not None:
            out[:span, c0 + w + 1] = plan.sa_sig[start:stop]
            out[:span, c0 + w + 2:c0 + w + 2 + la] = \
                plan.sa_pin_row[start:stop, :la]
            out[:span, c0 + w + 2 + la:c0 + w + 2 + la + fd] = \
                plan.sa_match_row[start:stop, :fd]
    return out


class DevicePlan:
    """The plan's arrays on one device, in the kernel's layout: the
    node-side statics and tables, and the pod matrix of every pod of the
    plan. A caller that runs the plan in many spans (the preemption hybrid)
    stages it once and hands it to each fast_scan call."""

    def __init__(self, plan: FastPlan, device: torch.device):
        self.plan = plan
        self.device = device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                    ).to(device)

        self.statics = put(np.concatenate(
            [getattr(plan, name) for name in STATIC_ROWS], axis=0))
        self.tables = tuple(put(getattr(plan, name)) for name in TABLES)
        npad = plan.alloc_cpu.shape[1]
        self.alloc_scalar = (put(plan.alloc_scalar) if plan.num_scalars
                             else torch.zeros((0, npad), dtype=torch.int32,
                                              device=device))
        self.groups = group_args(plan, device)
        self.ip = interpod_args(plan, device)
        self.pol = policy_args(plan, self.groups, device)
        # no ghost rows: a policy without a resource predicate would place
        # them
        self.pods = torch.from_numpy(
            pod_matrix(plan, 0, plan.num_pods, plan.num_pods)).to(device)


def policy_args(plan: FastPlan, groups: GroupArgs,
                device: torch.device) -> Optional[PolicyArgs]:
    """The plan's policy operands on `device`, uploaded once: the stage
    program and weights as the kernel's header, and the residue tables."""
    if plan.policy is None:
        return None

    def put(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)

    la, fd = policy_dims(plan)
    program = stage_program(plan.policy, groups, plan.has_interpod)
    header = policy_header(plan.policy, program, la, fd, plan.n_saa_doms)
    return PolicyArgs(
        spec=plan.policy, program=program, header=put(np.asarray(header)),
        la=la, fd=fd, n_saa_doms=plan.n_saa_doms,
        label_tbl=put(plan.label_tbl), label_prio=put(plan.label_prio_row),
        image_tbl=put(plan.image_tbl), noexec_tbl=put(plan.noexec_tbl),
        saa_dom=put(plan.saa_dom_tbl), sa_val=put(plan.sa_val_tbl))


def interpod_args(plan: FastPlan, device: torch.device) -> Optional[IpArgs]:
    """The plan's inter-pod operands on `device`, uploaded once: the domain
    rows, the per-group packed rows (the kernel reads a pod's row by its
    group id, so nothing per pod is built on the host) and the exist-side
    tables."""
    if not plan.has_interpod:
        return None
    exist = tuple(v for name, _ in EXIST_TABLES for v in getattr(plan, name))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                ).to(device)

    return IpArgs(k_keys=plan.n_topo_keys, d_doms=plan.n_topo_doms_ip,
                  ta=plan.ta, tb=plan.tb, tp=plan.tp,
                  hard_weight=plan.hard_weight, topo=put(plan.topo_rows),
                  ipod=put(plan.ipod), exist=put(np.asarray(exist)),
                  exist_host=exist)


def pd_tensor(carry: FastCarry, device: torch.device):
    """A fresh copy of the carry's presence_dom rows on `device`, or None
    for a plan without inter-pod terms."""
    if carry.pd is None:
        return None
    pd = carry.pd
    if not isinstance(pd, torch.Tensor):
        pd = torch.from_numpy(np.ascontiguousarray(pd, dtype=np.int32))
    return pd.to(device=device, dtype=torch.int32).clone().contiguous()


def group_args(plan: FastPlan, device: torch.device) -> GroupArgs:
    """The plan's pod-group operands on `device`: the zone one-hot rows
    become one zone-id row, the per-group tables stay indexed by group id."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                ).to(device)

    if not (plan.num_groups or plan.has_vol_zone or plan.has_maxpd):
        return NO_GROUPS
    kw = {}
    if plan.has_spread:
        zpad = plan.zone_onehot.shape[0]
        kw.update(zone_id=put((np.arange(zpad)[:, None]
                               * plan.zone_onehot).sum(axis=0)),
                  n_zones=plan.n_zone_doms)
    if plan.has_vol_zone:
        kw["zone_ok"] = put(plan.zone_ok_tbl)
    if plan.has_maxpd:
        kw.update(n_vols=plan.n_vols, vpad=plan.used_vols.shape[0],
                  vol_tbl=put(plan.vol_tbl),
                  vol_type=put(np.asarray(plan.vol_type3).reshape(-1, 3)),
                  limits=tuple(plan.maxpd_limits),
                  maxpd_types=sum(1 << t for t, on
                                  in enumerate(plan.maxpd_enabled) if on))
    return GroupArgs(gpad=plan.num_groups, has_ports=plan.has_ports,
                     has_disk=plan.has_disk, has_spread=plan.has_spread,
                     has_vol_zone=plan.has_vol_zone, **kw)


def carry_tensors(carry: FastCarry, device: torch.device):
    """A fresh [7 + Srows + Gpad + Vpad, Npad] carry tensor and [128] misc
    row on `device` (copies: the caller's carry is never updated in place).
    A carry already on `device` (a previous call's) stays there."""
    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32))
        return t.to(device=device, dtype=torch.int32)

    parts = [put(r).reshape(1, -1) for r in carry.rows]
    for extra in (carry.scal, carry.pres, carry.uv):
        if extra is not None:
            parts.append(put(extra))
    rows = torch.cat(parts, dim=0).contiguous()
    misc = put(carry.misc).reshape(-1)[:MISC_WIDTH].clone()
    return rows, misc


def fast_scan(plan: FastPlan, chunk: int = CHUNK, start: int = 0,
              stop: Optional[int] = None, carry_in: Optional[FastCarry] = None,
              return_carry: bool = False, device="cuda",
              staged: Optional[DevicePlan] = None):
    """Run pods [start, stop) of the plan in launches of `chunk` pods (the
    last one shorter); returns (choices, counts, advanced) over that
    span as numpy arrays, plus the FastCarry out (torch tensors on the
    device) when return_carry.

    carry_in: resume from an explicit carry instead of the plan's initial
    state; a previous call's carry out passes in without leaving the device.
    device: "cuda" (the default) launches the CUDA kernel, "cpu" runs its
    plain version. staged: the plan already staged on the device
    (DevicePlan), instead of an upload each call."""
    if staged is not None:
        if staged.plan is not plan:
            raise ValueError("staged holds another plan")
        device = staged.device
    device = resolve_device(device)
    if stop is None:
        stop = plan.num_pods
    span = stop - start
    num_bits = NUM_FIXED_BITS + plan.num_scalars
    k = min(max(chunk, 1), max(span, 1))
    num_chunks = -(-span // k) if span > 0 else 0

    dp = staged if staged is not None else DevicePlan(plan, device)
    carry_in = carry_in or init_carry(plan)
    carry, misc = carry_tensors(carry_in, device)
    pd = pd_tensor(carry_in, device)
    pods = dp.pods[start:max(start, stop)]
    # clamp to >= 1: 0 would keep every chunk's outputs on the device
    sync_every = max(1, env_int("TPUSIM_FAST_SYNC_EVERY", 64))
    results = []   # host triples (choices[n], counts[n, B], adv[n])
    pending = []   # FIFO of (choices_dev, counts_dev, adv_dev, n_real)

    def drain_one():
        och, ocnt, oadv, n_real = pending.pop(0)
        results.append((och[:n_real].cpu().numpy(),
                        ocnt[:n_real].cpu().numpy(),
                        oadv[:n_real].cpu().numpy() != 0))

    for ci in range(num_chunks):
        out = fastscan_chunk(pods[ci * k:(ci + 1) * k], dp.statics, dp.tables,
                             carry, misc, dp.alloc_scalar, plan.num_scalars,
                             num_bits, plan.most_requested, dp.groups, dp.ip,
                             pd, dp.pol)
        pending.append(out + (min(k, span - ci * k),))
        if len(pending) > sync_every:
            drain_one()
    while pending:
        drain_one()
    if not results:
        out3 = (np.zeros(0, np.int32), np.zeros((0, num_bits), np.int32),
                np.zeros(0, bool))
    else:
        out3 = tuple(np.concatenate([r[i] for r in results])
                     for i in range(3))
    if not return_carry:
        return out3
    srows = dp.alloc_scalar.shape[0]
    g0 = CARRY_ROWS + srows
    v0 = g0 + plan.num_groups
    carry_out = FastCarry(
        rows=[carry[i:i + 1] for i in range(CARRY_ROWS)],
        misc=misc.reshape(1, MISC_WIDTH),
        scal=carry[CARRY_ROWS:g0] if plan.num_scalars else None,
        pres=carry[g0:v0] if plan.num_groups else None,
        pd=pd, uv=carry[v0:] if plan.has_maxpd else None)
    return out3 + (carry_out,)
