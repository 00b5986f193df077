#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build every CUDA kernel from the sources in the checkout (nvcc);
  3. each kernel against its plain PyTorch version on the card, on random
     group-free plans (~512 pods x ~1000 nodes, both providers, scalar axes,
     infeasible pods): choices, counts, advanced, final carry and rr must be
     bit-equal (tolerance 0: all values are integers);
  4. the main path at full size, config 3 (100k Zipf pods on 5k
     heterogeneous nodes), through TorchBackend on the card: the placement
     golden, the scheduled count, and launches > 0 of every kernel;
  5. config 4's CPU shape (100k pods on 2k nodes, half the pods zone-pinned)
     the same way;
  6. on the first chunk of each of those two workloads (the main path's
     shapes), the kernel against its plain version again, bit-equal, and
     the kernel's time (CUDA events) beside its bound, its plain version's
     time and the library yardstick;
  7. the kernel's pod-group variant (Variants 2 and 4: host ports,
     NoDiskConflict, NoVolumeZoneConflict, MaxPD, SelectorSpread) against its
     plain version on random group plans (~512 pods x ~1000 nodes, both
     providers, one case with a MaxPD limit of 1), bit-equal;
  8. the groups workload at full size (config 3 with 8 Services, host-port
     pods and disk pods: 100k pods on 5k nodes) through TorchBackend on the
     card: the placement golden, the scheduled count, launches > 0 of the
     group variant, cold and warm wall, the kernel time over the whole scan;
     then its first chunk kernel against plain, bit-equal, with the
     kernel's time beside its bound and its plain version's time;
  9. the kernel's inter-pod variant (Variant 3: MatchInterPodAffinity,
     InterPodAffinityPriority, the presence_dom carry) against its plain
     version on random inter-pod plans (~512 pods x ~60 nodes, so that
     hostname terms fit the 64-domain budget; both providers, hard weight 1,
     10 and 100, Services and host ports in the same launch), bit-equal;
 10. the inter-pod workload at full size (config 3 with Deployment, stateful
     store, web tier and worker terms on zone and rack keys: 100k pods on 5k
     nodes) through TorchBackend on the card: the placement golden, the
     scheduled count, launches > 0 of the inter-pod variant, cold and warm
     wall, the kernel time over the whole scan; then its first chunk kernel
     against plain, bit-equal, with the kernel's time beside its bound and
     its plain version's time.
Then a JSON line of the kernels and, last, the device line.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# placement goldens: sha256 of the int32 choice vector, first 16 hex digits,
# and the scheduled count (the JAX package's XLA scan on the same workloads;
# tools/port_golden.py records them)
GOLDENS = {
    "config3": ("build_workload", dict(num_pods=100_000, num_nodes=5_000),
                "920ace51731ade22", 98_474),
    "config4_cpu_shape": ("build_workload",
                          dict(num_pods=100_000, num_nodes=2_000,
                               affinity=True),
                          "91acfe80f43b3b5a", 44_535),
    "groups": ("groups_workload", dict(num_pods=100_000, num_nodes=5_000),
               "49516d158991e079", 98_296),
    "interpod": ("interpod_workload", dict(num_pods=100_000, num_nodes=5_000),
                 "2d26e7d7c37f001d", 97_931),
}
# the phase that drives each main-path workload, and the kernel variant it
# must launch
PHASE = {"config3": 4, "config4_cpu_shape": 5, "groups": 8, "interpod": 10}
VARIANT = {"config3": "group_free", "config4_cpu_shape": "group_free",
           "groups": "groups", "interpod": "interpod"}
# H100 SXM peaks from the published datasheet: device memory rate, and the
# float32 rate outside the tensor cores. The datasheet gives no int32 rate;
# Hopper has half as many int32 lanes as float32 lanes per SM, so 67e12 is
# an upper bound on the int32 rate and the bound below a lower bound on time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# int32 operations in fastscan.cu, counted from its source (the bit ORs and
# loads are left out, so these are lower counts). The filter, per pod and
# real node: the condition test, the pod-count add and compare, four
# capacity adds and compares, hostname, selector and taint lookups and two
# pressure tests (16), plus an add and a compare per scalar axis. A pad
# node fails at its condition test (1). The score runs only on feasible
# nodes: two ratios with their guards, the balanced products and divide,
# two normalizations, the avoid product, the sums, the max and tie tests
# (30).
FILTER_OPS, FILTER_OPS_PER_SCALAR, PAD_OPS, SCORE_OPS = 16, 2, 1, 30
# The group variant, per (pod, real node): a presence load and test for each
# group in the pod's port and disk sets (2 each), the vol-zone row test
# (1), and for a pod that mounts counted volumes a load, select and three
# typed adds per volume id (5 each). Per feasible pair: a presence load and
# add per group of the spread set (2 each), the zone-sum accumulation and
# the blend's products, divide and selects (24).
PRESENCE_OPS, VOL_ZONE_OPS, MAXPD_OPS_PER_VOL = 2, 1, 5
SPREAD_OPS_PER_GROUP, SPREAD_BLEND_OPS = 2, 24
# The inter-pod variant. Per pod, its phase: a load and an add per (matched
# group, domain) of each own term's domain sums, and of each other group's
# term that matches the pod (a multiply more when weighted) (2 each). Per
# (pod, real node) that reaches the stage: a domain load, a test, a sum
# lookup and a test per valid own required term, and per topology key for
# the existing pods' anti-affinity sums (4 each). Per feasible pair: a
# domain load, a test, a multiply and an add per weighted own preferred
# term, a domain load, a test and an add per key (4 and 3), and the
# normalization's subtract, multiply, divide and the min and max (5).
IP_SUM_OPS, IP_NODE_OPS, IP_PREF_OPS, IP_KEY_OPS, IP_NORM_OPS = 2, 4, 4, 3, 5


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def choices_golden(choices):
    return hashlib.sha256(np.asarray(choices).astype(np.int32).tobytes()
                          ).hexdigest()[:16]


def make_plan(snapshot, pods, most_requested):
    from tpusim_torch.config import config_for
    from tpusim_torch.fastplan import plan_fast
    from tpusim_torch.state import compile_cluster

    compiled, cols = compile_cluster(snapshot, pods)
    config = config_for(compiled, most_requested)
    plan, why = plan_fast(config, compiled, cols)
    if plan is None:
        raise RuntimeError(f"plan ineligible: {why}")
    return plan


class ChunkInputs:
    """The first chunk of `plan` at its initial state, on `device`: the
    device plan, the carry, misc and presence_dom tensors and the pods."""

    def __init__(self, plan, k, device):
        import torch

        from tpusim_torch.fastplan import init_carry
        from tpusim_torch.fastscan import (
            DevicePlan,
            carry_tensors,
            pd_tensor,
            pod_matrix,
        )

        self.dp = DevicePlan(plan, device)
        init = init_carry(plan)
        self.carry, self.misc = carry_tensors(init, device)
        self.pd = pd_tensor(init, device)
        span = min(k, plan.num_pods)
        self.pods = torch.from_numpy(pod_matrix(plan, 0, span, k)).to(device)

    def state(self):
        """The carry tensors the chunk updates in place."""
        return (self.carry, self.misc) + (
            (self.pd,) if self.pd is not None else ())


def run_chunk(fn, plan, ci, pods=None):
    from tpusim_torch.state import NUM_FIXED_BITS

    dp = ci.dp
    return fn(ci.pods if pods is None else pods, dp.statics, dp.tables,
              ci.carry, ci.misc, dp.alloc_scalar, plan.num_scalars,
              NUM_FIXED_BITS + plan.num_scalars, plan.most_requested,
              dp.groups, dp.ip, ci.pd)


def kernel_and_plain(plan, cuda):
    """The whole plan as one chunk through the kernel and through its plain
    version, each from a fresh initial state on the card: [outputs, final
    carry, misc and presence_dom as int64 arrays] for each."""
    from tpusim_torch.kernels.fastscan import fastscan_chunk, fastscan_chunk_plain

    results = []
    for fn in (fastscan_chunk, fastscan_chunk_plain):
        ci = ChunkInputs(plan, plan.num_pods, cuda)
        out = run_chunk(fn, plan, ci)
        results.append([t.cpu().numpy().astype(np.int64)
                        for t in (*out, *ci.state())])
    return results


def compare_kernel_with_plain(cuda):
    """Phase 3: returns the largest absolute difference seen (must be 0)."""
    from tpusim_torch.workloads import random_workload

    cases = [dict(seed=0, most_requested=False, num_scalars=0, infeasible=True),
             dict(seed=1, most_requested=True, num_scalars=2, infeasible=False),
             dict(seed=2, most_requested=False, num_scalars=2, infeasible=True),
             dict(seed=3, most_requested=True, num_scalars=1, infeasible=True)]
    worst = 0
    for case in cases:
        snapshot, pods = random_workload(case["seed"], 512, 1000,
                                         num_scalars=case["num_scalars"],
                                         infeasible=case["infeasible"])
        plan = make_plan(snapshot, pods, case["most_requested"])
        results = kernel_and_plain(plan, cuda)
        diff = max(int(np.abs(a - b).max(initial=0))
                   for a, b in zip(*results))
        placed = int((results[0][0] >= 0).sum())
        print(f"phase 3: kernel vs plain {case}: {placed}/512 placed, "
              f"max |diff| {diff}")
        if diff != 0:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"on {case}: max |diff| {diff}")
        if not 0 < placed < 512:
            raise AssertionError(f"case {case} does not exercise both outcomes")
        worst = max(worst, diff)
    return worst


def compare_group_kernel_with_plain(cuda):
    """Phase 7: the group variant on random group plans; returns the largest
    absolute difference seen (must be 0)."""
    from tpusim_torch.state import (
        BIT_DISK_CONFLICT,
        BIT_HOST_PORTS,
        BIT_MAX_VOLUME_COUNT,
        BIT_VOLUME_ZONE_CONFLICT,
    )
    from tpusim_torch.workloads import random_group_workload

    every = dict(ports=True, services=True, disk=True, vol_zone=True,
                 maxpd=True)
    cases = [dict(seed=20, most_requested=False, features=every),
             dict(seed=21, most_requested=True, features=every),
             dict(seed=22, most_requested=False, maxpd_limit="1",
                  features=dict(maxpd=True, disk=True)),
             dict(seed=23, most_requested=True,
                  features=dict(vol_zone=True, ports=True)),
             dict(seed=24, most_requested=True,
                  features=dict(services=True, maxpd=True))]
    bits = {"ports": BIT_HOST_PORTS, "disk": BIT_DISK_CONFLICT,
            "maxpd": BIT_MAX_VOLUME_COUNT, "vol_zone": BIT_VOLUME_ZONE_CONFLICT}
    worst = 0
    for case in cases:
        limit = case.get("maxpd_limit")
        if limit:
            os.environ["KUBE_MAX_PD_VOLS"] = limit
        try:
            snapshot, pods = random_group_workload(
                case["seed"], 512, 1000, **case["features"])
            plan = make_plan(snapshot, pods, case["most_requested"])
        finally:
            os.environ.pop("KUBE_MAX_PD_VOLS", None)
        results = kernel_and_plain(plan, cuda)
        diff = max(int(np.abs(a - b).max(initial=0))
                   for a, b in zip(*results))
        placed = int((results[0][0] >= 0).sum())
        counts = results[0][1]
        reasons = {k: int(counts[:, b].sum()) for k, b in bits.items()}
        shown = {k: v for k, v in case.items() if k != "features"}
        print(f"phase 7: group kernel vs plain {shown} "
              f"{sorted(case['features'])}: Gpad {plan.num_groups}, "
              f"{plan.n_vols} volume ids, limits {plan.maxpd_limits}; "
              f"{placed}/512 placed, failed-node reasons {reasons}, "
              f"max |diff| {diff}")
        if diff != 0:
            raise AssertionError(f"group kernel disagrees with its plain "
                                 f"version on {shown}: max |diff| {diff}")
        if not 0 < placed < 512:
            raise AssertionError(f"case {shown} does not exercise both "
                                 "outcomes")
        if limit and reasons["maxpd"] == 0:
            raise AssertionError(f"case {shown} never fails MaxPD")
        worst = max(worst, diff)
    return worst


def drive_main_path(name, card, cuda):
    """Phases 4, 5, 8 and 10: one workload through TorchBackend, checked
    against its golden; returns the kernel launches of the first run and
    the plan."""
    from tpusim_torch import workloads
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    workload, params, golden, want_scheduled = GOLDENS[name]
    phase, variant = PHASE[name], VARIANT[name]
    t0 = time.perf_counter()
    snapshot, pods = getattr(workloads, workload)(**params)
    build_s = time.perf_counter() - t0
    backend = TorchBackend(device="cuda")
    fastscan_chunk.launches = 0
    for key in fastscan_chunk.launches_by_variant:
        fastscan_chunk.launches_by_variant[key] = 0
    t0 = time.perf_counter()
    placements = backend.schedule(pods, snapshot)
    cold_s = time.perf_counter() - t0
    launches = fastscan_chunk.launches_by_variant[variant]
    all_launches = fastscan_chunk.launches
    got = choices_golden(backend.last_choices)
    scheduled = sum(1 for p in placements if p.scheduled)
    t0 = time.perf_counter()
    backend.schedule(pods, snapshot)
    warm_s = time.perf_counter() - t0
    if choices_golden(backend.last_choices) != got:
        raise AssertionError(f"{name}: warm run placed differently")
    n = params["num_pods"]
    print(f"phase {phase}: {name} "
          f"({n} pods, {params['num_nodes']} nodes): golden {got} "
          f"(want {golden}), {scheduled} scheduled (want {want_scheduled}), "
          f"{launches} kernel launches ({variant} variant); workload build "
          f"{build_s:.2f}s, cold {cold_s:.3f}s, warm {warm_s:.3f}s = "
          f"{n / warm_s:.0f} pods/s end to end on {card}")
    if got != golden or scheduled != want_scheduled:
        raise AssertionError(f"{name}: placement golden {got}/{scheduled} != "
                             f"{golden}/{want_scheduled}")
    if launches <= 0 or launches != all_launches:
        raise AssertionError(f"{name}: the {variant} kernel variant was "
                             f"launched {launches} of {all_launches} times")
    # the scan alone, device time of every chunk launch in sequence
    plan = make_plan(snapshot, pods, False)
    if plan.has_interpod:
        print(f"phase {phase}: {name} plan: Gpad {plan.num_groups}, K "
              f"{plan.n_topo_keys}, D {plan.n_topo_doms_ip}, terms "
              f"{plan.ta}/{plan.tb}/{plan.tp}")
    scan_ms = time_full_scan(plan, cuda)
    print(f"phase {phase}: {name} kernel time over "
          f"the whole scan {scan_ms:.3f} ms ({-(-n // CHUNK)} launches of "
          f"{CHUNK} pods, CUDA events) on {card}")
    return launches, plan


def time_full_scan(plan, cuda):
    import torch

    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    k = CHUNK
    chunks = -(-plan.num_pods // k)
    ci = ChunkInputs(plan, chunks * k, cuda)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for c in range(chunks):
        run_chunk(fastscan_chunk, plan, ci, ci.pods[c * k:(c + 1) * k])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def chunk_run(fn, plan, cuda, repeats):
    """Mean device time of `fn` on the main path's first chunk, each call
    from a fresh copy of the initial state, and the last call's outputs,
    final carry, rr and presence_dom as int64 arrays."""
    import torch

    from tpusim_torch.fastscan import CHUNK

    total = 0.0
    for _ in range(repeats):
        ci = ChunkInputs(plan, CHUNK, cuda)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(fn, plan, ci)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / repeats, [t.cpu().numpy().astype(np.int64)
                             for t in (*out, *ci.state())]


def feasible_pairs(plan, cuda):
    """Per pod of the main path's first chunk, replayed pod by pod through
    the plain version: the nodes that pass the filter, the nodes that reach
    the inter-pod stage (pass every earlier stage), and the spread-group
    reads over the feasible nodes."""
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import (
        fastscan_chunk_plain,
        filter_pod,
        pod_interpod,
    )

    ci = ChunkInputs(plan, CHUNK, cuda)
    dp = ci.dp
    feasible, reach, spread_reads = [], [], 0
    for j in range(min(CHUNK, plan.num_pods)):
        row = ci.pods[j].tolist()
        before, _ = filter_pod(row, dp.statics, dp.tables, ci.carry,
                               dp.alloc_scalar, plan.num_scalars, dp.groups)
        ipp = pod_interpod(row, plan.num_scalars, dp.groups, dp.ip, ci.carry,
                           dp.alloc_scalar, ci.pd)
        passed = before
        if ipp is not None:
            passed, _ = filter_pod(row, dp.statics, dp.tables, ci.carry,
                                   dp.alloc_scalar, plan.num_scalars,
                                   dp.groups, ipp)
        nf = int(passed.sum())
        feasible.append(nf)
        reach.append(int(before.sum()))
        if plan.has_spread:
            spread_reads += nf * int(plan.ss_row[j].sum())
        run_chunk(fastscan_chunk_plain, plan, ci, ci.pods[j:j + 1])
    return feasible, reach, spread_reads


def interpod_ops(plan, feasible, reach):
    """The inter-pod operations of the main path's first chunk, counted from
    the kernel's source per pod (its group's terms) as IP_* above."""
    from tpusim_torch.fastplan import IpLayout
    from tpusim_torch.kernels.fastscan import EXIST_TABLES

    gpad, ta, tb, tp = plan.num_groups, plan.ta, plan.tb, plan.tp
    k_keys, d_doms = plan.n_topo_keys, plan.n_topo_doms_ip
    lay = IpLayout(ta, tb, tp, gpad)
    exist = {name: np.asarray(getattr(plan, name)) for name, _ in EXIST_TABLES}
    ops = 0
    for j, (nf, nr) in enumerate(zip(feasible, reach)):
        r = plan.ipod[plan.gid[j]]
        matched = int(r[lay.aff_match:lay.aff_key].sum()
                      + r[lay.anti_match:lay.anti_key].sum()
                      + r[lay.pref_match:lay.pref_key].sum())
        exist_pairs = int(
            (r[lay.ex_anti:lay.ex_pref] * exist["exist_anti_mask"]).sum()
            + (r[lay.ex_pref:lay.ex_aff] * (exist["exist_pref_w"] != 0)).sum()
            + (r[lay.ex_aff:lay.ex_aff + gpad * ta]
               * exist["exist_aff_mask"]).sum())
        own_required = int(r[lay.aff_valid:lay.aff_valid + ta].sum()
                           + r[lay.anti_valid:lay.anti_valid + tb].sum())
        weighted = int((r[lay.pref_w:lay.pref_w + tp] != 0).sum())
        ops += ((matched + exist_pairs) * d_doms * IP_SUM_OPS
                + nr * (own_required + k_keys) * IP_NODE_OPS
                + nf * (weighted * IP_PREF_OPS + k_keys * IP_KEY_OPS
                        + IP_NORM_OPS))
    return ops


def chunk_bound_ms(plan, feasible, reach, spread_reads=0):
    """The least time for the main path's first chunk: inputs read once,
    outputs written once, over the memory rate; the operations this chunk's
    data needs over the 32-bit peak."""
    from tpusim_torch.fastscan import CHUNK, pod_matrix

    k = CHUNK
    real = min(k, plan.num_pods)
    npad = plan.alloc_cpu.shape[1]
    n = plan.num_nodes
    nb = 24 + plan.num_scalars
    pairs_feasible = sum(feasible)
    srows = plan.alloc_scalar.shape[0] if plan.num_scalars else 0
    vrows = plan.used_vols.shape[0] if plan.has_maxpd else 0
    tables = sum(getattr(plan, t).size for t in (
        "selector_ok", "taint_ok", "intolerable", "aff_count", "avoid_score",
        "host_ok"))
    # the group operands: the zone-id row, the vol-zone and volume tables,
    # the inter-pod domain rows, packed rows and exist-side tables
    groups = ((npad if plan.has_spread else 0)
              + (plan.zone_ok_tbl.size if plan.has_vol_zone else 0)
              + (plan.vol_tbl.size + 3 * plan.n_vols if plan.has_maxpd
                 else 0))
    carry = (7 + srows + plan.num_groups + vrows) * npad + 128
    if plan.has_interpod:
        groups += (plan.topo_rows.size + plan.ipod.size
                   + 3 * plan.num_groups * (plan.ta + plan.tb + plan.tp))
        carry += plan.presence_dom.size
    pod_w = pod_matrix(plan, 0, 0, 1).shape[1]
    inputs = k * pod_w + (8 + srows) * npad + tables + groups + carry
    outputs = carry + k * (2 + nb)
    bytes_ = 4 * (inputs + outputs)
    ops = (real * n * (FILTER_OPS + FILTER_OPS_PER_SCALAR * plan.num_scalars)
           + real * (npad - n) * PAD_OPS
           + pairs_feasible * SCORE_OPS)
    if plan.num_groups:
        sets = sum(int(getattr(plan, name)[:real].sum())
                   for name in ("port_row", "disk_row")
                   if getattr(plan, name) is not None)
        ops += sets * n * PRESENCE_OPS
    if plan.has_vol_zone:
        ops += real * n * VOL_ZONE_OPS
    if plan.has_maxpd:
        counted = plan.vol_tbl[plan.gid[:real], :plan.n_vols].any(axis=1)
        ops += int(counted.sum()) * n * plan.n_vols * MAXPD_OPS_PER_VOL
    if plan.has_spread:
        ops += (spread_reads * SPREAD_OPS_PER_GROUP
                + pairs_feasible * SPREAD_BLEND_OPS)
    if plan.has_interpod:
        ops += interpod_ops(plan, feasible, reach)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_first_chunk(name, plan, card, cuda, phase):
    """The kernel against its plain version on the main path's first chunk,
    bit-equal, with the kernel's time beside its bound and its plain
    version's time; returns (max |diff|, ms, plain_ms, bound_ms, bound_by)."""
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import fastscan_chunk, fastscan_chunk_plain

    ms, got = chunk_run(fastscan_chunk, plan, cuda, repeats=20)
    plain_ms, want = chunk_run(fastscan_chunk_plain, plan, cuda, repeats=2)
    diff = max(int(np.abs(a - b).max(initial=0)) for a, b in zip(got, want))
    feasible, reach, spread_reads = feasible_pairs(plan, cuda)
    bound_ms, bound_by = chunk_bound_ms(plan, feasible, reach, spread_reads)
    placed = int((got[0] >= 0).sum())
    print(f"phase {phase}: {name} first chunk ({CHUNK} pods x "
          f"{plan.num_nodes} nodes, Npad {plan.alloc_cpu.shape[1]}): "
          f"kernel vs plain max |diff| {diff} ({placed} placed, "
          f"{sum(feasible)} feasible pairs); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({bound_by}) "
          f"on {card}")
    if diff != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version on the first chunk: max |diff| "
                             f"{diff}")
    return diff, ms, plain_ms, bound_ms, bound_by


def compare_interpod_kernel_with_plain(cuda):
    """Phase 9: the inter-pod variant on random inter-pod plans; returns the
    largest absolute difference seen (must be 0)."""
    from tpusim_torch.config import config_for
    from tpusim_torch.fastplan import plan_fast
    from tpusim_torch.state import (
        BIT_AFFINITY_NOT_MATCH,
        BIT_AFFINITY_RULES,
        BIT_ANTI_AFFINITY_RULES,
        BIT_EXISTING_ANTI_AFFINITY,
        compile_cluster,
    )
    from tpusim_torch.workloads import random_interpod_workload

    cases = [dict(seed=30, most_requested=False, hard_weight=10),
             dict(seed=31, most_requested=True, hard_weight=1, services=True),
             dict(seed=32, most_requested=False, hard_weight=100,
                  services=True, ports=True),
             dict(seed=33, most_requested=True, hard_weight=100, ports=True),
             dict(seed=34, most_requested=False, hard_weight=1,
                  services=True, ports=True)]
    bits = {"any": BIT_AFFINITY_NOT_MATCH,
            "existing_anti": BIT_EXISTING_ANTI_AFFINITY,
            "affinity": BIT_AFFINITY_RULES,
            "anti_affinity": BIT_ANTI_AFFINITY_RULES}
    worst = 0
    seen = dict.fromkeys(bits, 0)
    for case in cases:
        snapshot, pods = random_interpod_workload(
            case["seed"], 512, 60, services=case.get("services", False),
            ports=case.get("ports", False))
        compiled, cols = compile_cluster(snapshot, pods)
        plan, why = plan_fast(config_for(compiled, case["most_requested"],
                                         case["hard_weight"]), compiled, cols)
        if plan is None:
            raise RuntimeError(f"plan ineligible: {why}")
        results = kernel_and_plain(plan, cuda)
        diff = max(int(np.abs(a - b).max(initial=0))
                   for a, b in zip(*results))
        placed = int((results[0][0] >= 0).sum())
        counts = results[0][1]
        reasons = {k: int(counts[:, b].sum()) for k, b in bits.items()}
        for key, v in reasons.items():
            seen[key] += v
        print(f"phase 9: inter-pod kernel vs plain {case}: Gpad "
              f"{plan.num_groups}, K {plan.n_topo_keys}, D "
              f"{plan.n_topo_doms_ip}, terms {plan.ta}/{plan.tb}/{plan.tp}; "
              f"{placed}/512 placed, failed-node reasons {reasons}, "
              f"max |diff| {diff}")
        if diff != 0:
            raise AssertionError(f"inter-pod kernel disagrees with its plain "
                                 f"version on {case}: max |diff| {diff}")
        if not 0 < placed < 512:
            raise AssertionError(f"case {case} does not exercise both "
                                 "outcomes")
        worst = max(worst, diff)
    if not all(seen.values()):
        raise AssertionError(f"phase 9 never reached every inter-pod reason: "
                             f"{seen}")
    return worst


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tpusim_torch.kernels import build

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cuda = torch.device("cuda")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    build.load("fastscan.cu")
    print(f"phase 2: built {len(build.SOURCES)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f}s")

    max_err = compare_kernel_with_plain(cuda)

    launches, plan3 = drive_main_path("config3", card, cuda)
    _, plan4 = drive_main_path("config4_cpu_shape", card, cuda)

    # phase 6: the kernel against its plain version at the main path's
    # shapes (several nodes a thread), then its time on config 3's chunk
    timed = {}
    for name, plan in (("config3", plan3), ("config4_cpu_shape", plan4)):
        diff, *timed[name] = time_first_chunk(name, plan, card, cuda, 6)
        max_err = max(max_err, diff)

    # phases 7-8: the pod-group variant (Variants 2 and 4)
    group_err = compare_group_kernel_with_plain(cuda)
    group_launches, plan_g = drive_main_path("groups", card, cuda)
    diff, *timed["groups"] = time_first_chunk("groups", plan_g, card, cuda, 8)
    group_err = max(group_err, diff)

    # phases 9-10: the inter-pod variant (Variant 3)
    ip_err = compare_interpod_kernel_with_plain(cuda)
    ip_launches, plan_ip = drive_main_path("interpod", card, cuda)
    diff, *timed["interpod"] = time_first_chunk("interpod", plan_ip, card,
                                                cuda, 10)
    ip_err = max(ip_err, diff)

    kernels = []
    for name, variant, replaces, n_launch, err in (
            ("config3", "group_free", "tpusim/jaxe/fastscan.py:1164",
             launches, max_err),
            ("groups", "groups", "tpusim/jaxe/fastscan.py:1386",
             group_launches, group_err),
            ("interpod", "interpod", "tpusim/jaxe/fastscan.py:1389",
             ip_launches, ip_err)):
        ms, plain_ms, bound_ms, bound_by = timed[name]
        kernels.append({
            "name": f"fastscan_chunk[{variant}]", "route": "cuda",
            "source": "tpusim_torch/csrc/fastscan.cu", "replaces": replaces,
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
