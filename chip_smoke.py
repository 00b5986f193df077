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
     its plain version's time;
 11. the kernel's policy variant (Variant 5: a scheduler Policy's stage
     program and weights, label rows, NoExecute taints, NodeLabel,
     ImageLocality and ServiceAntiAffinity scores, ServiceAffinity and its
     locks, count mode) against its plain version on random policy plans
     (~512 pods x ~1000 nodes with every pod-group feature, and an inter-pod
     plan under the upstream 1.9 policy on 60 nodes), bit-equal; between
     them the plans must run every opcode of the stage program, count mode,
     the PodFitsPorts alias, NoExecute, a disabled MaxPD type and two
     ServiceAffinity entries;
 12. the policy workload at full size (the groups workload under the
     upstream 1.2 policy: 100k pods on 5k nodes) through TorchBackend on the
     card: the placement golden, the scheduled count, launches of the policy
     variant only, cold and warm wall, the kernel time over the whole scan;
     then its first chunk kernel against plain, bit-equal, with the kernel's
     time beside its bound and its plain version's time;
 13. the kernel's thread-block cluster (one cluster of CTAs splitting the
     node axis) at forced sizes of 2, 4 and 16 CTAs against the plain
     version on workloads.cluster_hazard_cases, bit-equal, for all five
     instantiations: ties across slabs, picks in the last CTA, slabs of pad
     nodes only, CTAs without a feasible node beside CTAs with some, the
     histogram in count mode too, binds read by another CTA's next
     inter-pod phase or ServiceAffinity lock, and a plan too narrow for 16
     CTAs refused; one CTA on 10,000 nodes, whose scratch lives in device
     memory (a group-free and an inter-pod plan); then the first-chunk time
     of config 3 and of the policy cell at 1, 2, 4, 8 and 16 CTAs;
 14. the two routes against each other on the card: config 3's first 2,048
     pods on its 5,000 nodes through the fused kernel (route "kernel") and
     through the exact sequential scan (route "scan"): choices, reason
     counts and advanced flags must be equal (max |diff| 0), and the scan's
     final rr the count of advanced pods;
 15. the scan route at full width: the hostname workload (config 3's nodes
     with the documentation's two-tier hostname terms; 20,000 pods on 5,000
     nodes, a plan the kernel refuses) through TorchBackend(route="auto")
     on the card: it must take the scan, and place by the golden the JAX
     package records; cold and warm wall; then the scan alone, eagerly on
     its first 2,000 pods and as the backend runs it (blocks of steps
     replayed as CUDA graphs) on all of them, each with its device span
     (CUDA events) and microseconds a pod; then the reference
     quickstart (byte-granular memory) through run_simulation on the card,
     with the host route made to raise, whose split must digest as the JAX
     package's does;
 16. the host route on the card's machine, each part with its wall (host
     time): (a) the quickstart through run_simulation with backend
     "reference" and "auto" (which must pick the host for 20 pods on 4
     nodes), both with the quickstart's digest; (b) config 3's first 200
     pods on its 5,000 nodes, and config 4's node-affinity shape cut to
     300 pods on 8 nodes (a third of them fail, with two dozen distinct
     FitError texts), each through backend "reference" and through
     backend "torch" on the card (the kernel route, and for the second
     the scan route too): equal splits, FitError text included, and the
     JAX package's host digest; (c) config 6's priority-banded feed with
     PodPriority on backend "reference", cut to 3,000 pods on 150 nodes:
     the JAX package's digest and preempted count; (d) a policy with one
     filter extender, served in process, through TorchBackend on the
     card: it must take the host route and place as ReferenceBackend
     does, and raise with fallback="error". Phase 16 fails past its
     150 s budget;
 17. the preemption hybrid on the card (PodPriority through
     run_simulation(backend="torch")): (a) config 6 cut to 3,000 pods on
     150 nodes on route "kernel" with victims "auto" (picked on the
     device), then "host" (the host pipeline), then on route "scan": each
     the JAX package's digest and preempted count (those of 16c), victims
     picked on the device more than 0 times, the kernel launched on route
     "kernel" and never on route "scan"; (b) config 6 at bench.py's
     accelerator shape, 20,000 pods on 1,000 nodes, on route "kernel": the
     JAX package's hybrid's digest and its scheduled, failed and preempted
     counts, with the wall, pods/s, fast_scan calls, kernel launches,
     re-arms and recompiles, victim picks by arm, preempt_select's
     CUDA-event span a call (the host's launch pace included) and the
     host's share of the wall (1 - the CUDA-event spans of the speculation
     chunks and the victim selections over the wall); (c) preempt_select
     on the card against the same call on the CPU, on every set of lanes
     (b) produced, equal (tolerance 0), then those calls replayed under
     torch.profiler for the card's busy time a call;
 18. the chunked scan: config 3's first 8,192 pods on its 5,000 nodes
     through TorchBackend(route="scan") whole and with TPUSIM_SCAN_CHUNK
     2,048: choices, counts, advanced and the final carry bit-equal, with
     the walls and µs a pod of each;
 19. BASELINE config 5: (a) 16 of its 50 scenarios (a cut of depth for the
     script's time) of 20,000 pods on 1,000 nodes (build_workload, seeds
     1000-1015) through run_what_if on route
     "auto": one fast_scan a scenario on the kernel, with the wall, pods/s,
     kernel time (CUDA events) and host share; (b) the first 8 again on the
     batched scan (route "scan"), every scenario's placement hash equal to
     (a)'s, with its µs a step; (c) bench.py's CPU shape (8 x 5,000 x 500)
     on both routes, the JAX package's combined digest; then the batched
     step's kernels and device busy time at S = 1 and S = 8 under
     torch.profiler;
 20. bench.py's config 8 through the serve fleet (ScenarioFleet, buckets of
     8): 64 requests of the first 1,001-2,000 pods of a 2,000-pod pool on
     200 nodes, a cold and a warm pass, each the JAX package's combined
     digest; the warm pass builds no program and hits the program cache on
     every response. Phases 18-20 fail past their 300 s budget;
 21. bench config 9 through the streaming twin (run_stream_simulation on
     the card, the resident scan replaying its captured graphs, each run's
     CUDA-event span): the stream arm at 16,000 nodes (40 cycles of 64
     arrivals, 25% evicted, seed 9), which must restage only at its cold
     start and launch no fused kernel; the stream and restage arms at 4,000
     nodes, equal chains; a verified run at 4,000 nodes (10 cycles, every
     cycle held against a fresh TorchBackend.schedule); bench.py's CPU
     shape (800 nodes, 24 cycles), the JAX package's placement and fold
     chains;
 22. bench config 10, its policy at 4,000 nodes with label and taint churn,
     synchronous and pipelined: equal chains, no restage after the cold
     start; the CPU shape against the JAX package's chains;
 23. bench config 13, gangs on the stream: 2,000 racked nodes, 30 cycles of
     32 arrivals and 2 gangs of 8, verified, with the host route made to
     raise; every gang_select call of the run against select_oracle on the
     same inputs (max |diff| 0) and the fused kernel's launches for the
     ungrouped segments; the CPU shape against the JAX package's chains;
     then a one-shot gang feed through run_simulation on the card, the
     solve on the card and on the oracle (TPUSIM_GANG_KERNEL=0), each
     the JAX package's split: a gang no node can hold rejected whole with
     its one shared FitError, a gang admitted at its min-available with
     its overflow members' text; and its ungrouped segments on route
     "kernel";
 24. bench config 16: a warm twin of 20,000 nodes answers an 8-pod what-if
     overlay as run_what_if does on the live snapshot, the resident carry
     bit-equal after the queries and the timed queries building and
     capturing nothing, with the overlay's ms beside the staged
     run_what_if's. Phases 21-24 fail past their 240 s budget.
Phases 4-15 run TorchBackend with fallback="error", and phases 15, 16b and
17 run run_simulation on the card with the host route made to raise, so a
workload that started to reroute to the host fails them; phases 4-12 run
it with route "kernel", so a plan that stopped reaching the kernel fails
them, and print the cluster geometry each workload launched with beside
its times (every full-size cell must launch more than one CTA). Then the
whole script's wall, the card line, a JSON line of the kernels and, last,
the device line.
"""

import contextlib
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
    "policy": ("policy_workload", dict(num_pods=100_000, num_nodes=5_000),
               "e06b439fd663eb85", 44_216),
}
# phase 15: the scan route's workload and golden (tools/port_golden.py
# hostname 20000 5000), and the reference quickstart with the digest of the
# JAX package's run_simulation split (tools/port_golden.py quickstart)
SCAN_GOLDEN = ("hostname_workload", dict(num_pods=20_000, num_nodes=5_000),
               "31d659393aad448d", 19_603)
QUICKSTART_JSON = json.dumps([
    {"name": name, "num": 10, "pod": {"spec": {"containers": [{"resources": {
        "requests": {"cpu": cpu, "memory": memory}}}]}}}
    for name, cpu, memory in (("A", "1", "1"), ("B", "100", "1000"))])
QUICKSTART_DIGEST = "f00595f62c75d722"
# phase 16: the host route's workloads, and the split digest (and the
# preempted count) of the JAX package's run_simulation(backend="reference")
# on each (tools/port_golden.py config3_host 200 5000, config4_host 300 8,
# config6 3000 150)
HOST_CONFIG3 = (dict(num_pods=200, num_nodes=5_000), "3457639aca7e71a8")
HOST_CONFIG4 = (dict(num_pods=300, num_nodes=8, affinity=True),
                "da38c454da519992")
HOST_CONFIG6 = (dict(num_pods=3_000, num_nodes=150, affinity=True,
                     priorities=True, seed=777), "0be871220d60a22c", 12)
HOST_BUDGET_S = 150
# phase 17: config 6 at bench.py's accelerator shape through the preemption
# hybrid, with the split digest and the scheduled, failed and preempted
# counts of the JAX package's hybrid (tools/port_golden.py config6_hybrid
# 20000 1000)
HYBRID_CONFIG6 = (dict(num_pods=20_000, num_nodes=1_000, affinity=True,
                       priorities=True, seed=777),
                  "35a42fdde29dd2aa", (19_731, 155, 114))
# phase 18: config 3's first pods on its nodes through the scan route,
# whole and in chunks of TPUSIM_SCAN_CHUNK pods
CHUNKED_SCAN = (dict(num_pods=8_192, num_nodes=5_000), 2_048)
# phase 19: BASELINE config 5, scenarios of build_workload(pods, nodes,
# seed=1000 + s): at full shape, the first BATCHED_SCENARIOS of them again on
# the batched scan, and at bench.py's CPU shape with the combined digest of
# the JAX package's run_what_if (tools/port_golden.py config5). Config 5 has
# 50 scenarios; 16 run here, at full width: with all 50, phases 18-20 took
# 260-273 s of their 300 s budget on an H100's machine (its host time alone,
# about 3 s a scenario, varies by 10-30% between runs), and with 32 the
# whole script took 764 s once phases 21-24 came, where it aims at half of
# its 1,200 s limit
CONFIG5_SCENARIOS = 50
WHATIF_CONFIG5 = dict(scenarios=16, num_pods=20_000, num_nodes=1_000)
BATCHED_SCENARIOS = 8
WHATIF_CPU_SHAPE = (dict(scenarios=8, num_pods=5_000, num_nodes=500),
                    "ea6b76450d7828a9")
# phase 20: bench.py's config 8 through the serve fleet: the workload the
# requests draw from, the bucket size, and the combined digest of the JAX
# package's ScenarioFleet (tools/port_golden.py config8)
SERVE_CONFIG8 = (dict(num_pods=2_000, num_nodes=200, seed=4242), 8,
                 "d1c855554bfecaa6")
SERVE_REQUESTS = 64
# phases 18-20 together, seconds
WHATIF_BUDGET_S = 300
# phases 21-24: the streaming twin at bench.py's stream cells. Each golden is
# the placement_chain and fold_chain of the JAX package's
# run_stream_simulation at bench.py's CPU shape (tools/port_golden.py
# config9, config10, config13); "racked" is config 13's cluster
# (workloads.racked_cluster), "policy" config 10's (workloads.STREAM_POLICY).
STREAM_GOLDENS = {
    "config9": (dict(num_nodes=800, cycles=24, arrivals=64,
                     evict_fraction=0.25, seed=9),
        "462bdd7773d7ba18a3bd5ba43c3b2ce3d3f17e8761be7dc6a5d4ac987c6400d1",
        "a9c5450856090575565b111960db995ac4cc11d1b6cb639ac321abcc3b26cdde"),
    "config10": (dict(num_nodes=800, cycles=24, arrivals=64,
                      evict_fraction=0.25, seed=9, policy=True,
                      label_churn=2, taint_churn=1),
        "3e704ea87d2f32480528625f315f673e1ad529736ffb60a239b10b305a5d3e49",
        "016b6ea5a24ffcb4dcb6aa8d346d2d6e18b06281527275a929815ee97ede5bfc"),
    "config13": (dict(racked=400, cycles=16, arrivals=16,
                      evict_fraction=0.25, gang_size=8, gang_count=2,
                      seed=13),
        "8e5ca527beb3a96ee14973fe05f715e35a8c43c795630767bd7ec2c80c0309fd",
        "504396bf5653ddbdcdb3cc97bfdee3644105b54d5006684a882d0d79d5675c9c"),
}
# bench.py's accelerator shapes of configs 9 and 10: the sizes, the churn
# curves at the middle size, the cycles of a verified config 9 run
STREAM_SIZES = (1_000, 4_000, 16_000)
STREAM_CONFIG9 = dict(cycles=40, arrivals=64, evict_fraction=0.25, seed=9)
STREAM_EVICT_CURVE = (0.05, 0.25, 0.5)
STREAM_VERIFY_CYCLES = 10
STREAM_CONFIG10 = dict(cycles=40, arrivals=64, evict_fraction=0.25, seed=9,
                       policy=True)
STREAM_CHURN_CURVE = ((0, 0), (2, 1), (8, 4))
# config 13, and config 16's twins
STREAM_CONFIG13 = dict(racked=2_000, cycles=30, arrivals=32,
                       evict_fraction=0.25, gang_size=8, gang_count=2,
                       seed=13, verify=True)
# the split digest of the JAX package's run_simulation(backend="jax") on
# phase 23's one-shot gang feed (tools/port_golden.py gang_feed)
GANG_FEED_DIGEST = "f3049f3df5ac0745"
LIVE_WHATIF = dict(sizes=(200, 800, 3_200, 20_000), warm_cycles=4,
                   arrivals=32, query_pods=8, repeats=5)
# phases 21-24 together, seconds
STREAM_BUDGET_S = 240
# phase 14: the pods of config 3 run through both routes
ROUTES_PODS = 2_048
# phase 15: the pods of the scan timed eagerly, beside the graph replay
SCAN_EAGER_PODS = 2_000
# the phase that drives each main-path workload, the kernel variant it must
# launch, and the scheduler policy it runs under (workloads.COMPAT_POLICIES)
PHASE = {"config3": 4, "config4_cpu_shape": 5, "groups": 8, "interpod": 10,
         "policy": 12}
VARIANT = {"config3": "group_free", "config4_cpu_shape": "group_free",
           "groups": "groups", "interpod": "interpod", "policy": "policy"}
POLICY = {"policy": "1.2"}
# H100 SXM peaks from the published datasheet: device memory rate, and the
# float32 rate outside the tensor cores. The datasheet gives no int32 rate;
# Hopper has half as many int32 lanes as float32 lanes per SM, so 67e12 is
# an upper bound on the int32 rate and the bound below a lower bound on time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# int32 operations in fastscan.cu, counted from its source (the bit ORs and
# loads are left out, so these are lower counts). The filter, per pod and
# real node, by stage of the plan's stage program (kernels/fastscan.py
# stage_program; the provider's program for a plan without a policy): the
# condition test (1); the pod-count add and compare, four capacity adds and
# compares, the hostname and selector lookups (12, General) or their parts
# alone (10, 1, 1); the taint, NoExecute and label-row lookups (1 each); the
# vol-zone row test and the two pressure tests (1 each); an add and a
# compare per scalar axis where the resources are checked; two compares per
# ServiceAffinity label. The port, disk, MaxPD and inter-pod stages are
# counted per group, volume and term below. The provider's program makes
# this 16. A pad node fails at its condition test (1).
STAGE_OPS = {"OP_COND": 1, "OP_UNSCHED": 1, "OP_GENERAL": 12, "OP_HOST": 1,
             "OP_SEL": 1, "OP_RES": 10, "OP_TAINT": 1, "OP_NOEXEC": 1,
             "OP_VOL_ZONE": 1, "OP_MEM_PRESSURE": 1, "OP_DISK_PRESSURE": 1,
             "OP_LABEL": 1}
STAGE_OPS_PER_SCALAR, SA_OPS_PER_LABEL, PAD_OPS = 2, 2, 1
# The score, per feasible pair, by component in config.policy_weights order
# (least, most, balanced, node affinity, taint, avoid): the ratios with
# their guards and mean (9 each), the balanced products and divide (7), the
# two normalizations (3 each), avoid (0: its work is its weight's
# multiply). Only a component whose weight is nonzero runs: it adds an add,
# and a multiply where its weight is not 1. Then the max and tie tests (2).
# The provider's weights make this 30.
SCORE_COMPONENT_OPS, SCORE_SELECT_OPS = (9, 9, 7, 3, 3, 0), 2
# The group variant, per (pod, real node): a presence load and test for each
# group in the pod's port and disk sets (2 each), and for a pod that mounts
# counted volumes a load, select and three typed adds per volume id (5
# each). Per feasible pair: a presence load and add per group of the spread
# set (2 each), the zone-sum accumulation and the blend's products, divide
# and selects (24).
PRESENCE_OPS, MAXPD_OPS_PER_VOL = 2, 5
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
# The policy's score terms, per feasible pair: the NodeLabel priority row's
# add (1); per ServiceAntiAffinity group a presence load and add (2); per
# entry the per-domain accumulation, the domain test, subtract, multiply,
# divide, weight multiply and add (7). ImageLocality, spread and inter-pod
# scores count as a score component (an add, and a multiply where the
# weight is not 1) on top of their own work.
LABEL_PRIO_OPS, SAA_OPS_PER_GROUP, SAA_OPS_PER_ENTRY = 1, 2, 7


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def reset_launches():
    """Set the fused kernel's launch counts to 0."""
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    fastscan_chunk.launches = 0
    for key in fastscan_chunk.launches_by_variant:
        fastscan_chunk.launches_by_variant[key] = 0


def choices_golden(choices):
    return hashlib.sha256(np.asarray(choices).astype(np.int32).tobytes()
                          ).hexdigest()[:16]


def split_digest(status):
    """sha256 of a simulation Status's split (the scheduled pods and their
    nodes, then the failed pods and their FitError text), first 16 hex
    digits."""
    split = [(p.name, p.spec.node_name) for p in status.successful_pods]
    split += [(p.name, p.status.conditions[-1].message)
              for p in status.failed_pods]
    return hashlib.sha256(repr(split).encode()).hexdigest()[:16]


def combined_digest(hashes):
    """sha256 of placement hashes in order, one a line, first 16 hex
    digits: the digest of a what-if study or a serve load."""
    return hashlib.sha256("\n".join(hashes).encode()).hexdigest()[:16]


def serve_load(workload, request_cls):
    """bench.py's config 8 load over `workload` (snapshot, pod pool): each
    request the pool's first n pods, n in (pool/2, pool] from
    RandomState(8), against the snapshot registered as "base", with a
    cache key. Returns (snapshot, pool, load), load() making the requests
    with `request_cls` (either package's WhatIfRequest)."""
    snapshot, pool = workload
    rng = np.random.RandomState(8)
    sizes = [int(rng.randint(len(pool) // 2 + 1, len(pool) + 1))
             for _ in range(SERVE_REQUESTS)]

    def load():
        return [request_cls(pods=pool[:n], snapshot_ref="base",
                            cache_key=f"bench8-{i}-{n}")
                for i, n in enumerate(sizes)]

    return snapshot, pool, load


def stream_arguments(params, api, decode_policy):
    """run_stream_simulation's keyword arguments for a STREAM_GOLDENS or
    STREAM_CONFIG* cell, built with either package's snapshot module and
    policy decoder: "racked" becomes config 13's cluster, "policy" config
    10's policy."""
    from tpusim_torch import workloads

    kw = dict(params)
    if "racked" in kw:
        kw["snapshot"] = workloads.racked_cluster(kw.pop("racked"), api=api)
    if kw.pop("policy", False):
        kw["policy"] = decode_policy(workloads.STREAM_POLICY)
    return kw


@contextlib.contextmanager
def device_routes_only():
    """Make the port's host route raise while the block runs, so that a run
    meant for the card fails if run_simulation or TorchBackend rerouted it
    to the host, whose placements match the JAX package's by construction.
    The host orchestrator's loop (ClusterCapacity.run) raises, not the class:
    the preemption hybrid keeps a ClusterCapacity as its host mirror."""
    import tpusim_torch.backend as backend_module
    from tpusim_torch.simulator import ClusterCapacity

    def refuse(*args, **kwargs):
        raise AssertionError("a run meant for the card was rerouted to the "
                             "host route")

    saved = backend_module.ReferenceBackend, ClusterCapacity.run
    backend_module.ReferenceBackend = ClusterCapacity.run = refuse
    try:
        yield
    finally:
        backend_module.ReferenceBackend, ClusterCapacity.run = saved


def make_plan(snapshot, pods, most_requested, policy=None, hard_weight=10):
    """The plan TorchBackend builds, under `policy` (a Policy dict) if
    given."""
    from tpusim_torch.backend import build_plan
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.policyc import compile_policy

    cp = compile_policy(decode_policy(policy)) if policy is not None else None
    return build_plan(snapshot, pods, most_requested, hard_weight, cp)[0]


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


def run_chunk(fn, plan, ci, pods=None, cluster=None):
    """One chunk through `fn`; `cluster` forces the kernel's CTAs."""
    from tpusim_torch.state import NUM_FIXED_BITS

    dp = ci.dp
    kw = {} if cluster is None else {"cluster": cluster}
    return fn(ci.pods if pods is None else pods, dp.statics, dp.tables,
              ci.carry, ci.misc, dp.alloc_scalar, plan.num_scalars,
              NUM_FIXED_BITS + plan.num_scalars, plan.most_requested,
              dp.groups, dp.ip, ci.pd, dp.pol, **kw)


def geometry_text(g):
    where = "shared memory" if g.scratch_in_smem else "device memory"
    return (f"cluster of {g.cluster} CTAs x {g.threads} threads, "
            f"{g.nodes_per_thread} node(s) a thread, scratch in {where} "
            f"({g.smem} B dynamic shared memory)")


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
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    workload, params, golden, want_scheduled = GOLDENS[name]
    phase, variant = PHASE[name], VARIANT[name]
    policy = (workloads.COMPAT_POLICIES[POLICY[name]] if name in POLICY
              else None)
    t0 = time.perf_counter()
    snapshot, pods = getattr(workloads, workload)(**params)
    build_s = time.perf_counter() - t0
    backend = TorchBackend(device="cuda", route="kernel", fallback="error",
                           policy=policy and decode_policy(policy))
    reset_launches()
    t0 = time.perf_counter()
    placements = backend.schedule(pods, snapshot)
    cold_s = time.perf_counter() - t0
    launches = fastscan_chunk.launches_by_variant[variant]
    all_launches = fastscan_chunk.launches
    geom = fastscan_chunk.last_geometry
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
          f"{n / warm_s:.0f} pods/s end to end on {card}; "
          f"{geometry_text(geom)}")
    if geom.cluster <= 1:
        raise AssertionError(f"{name}: the kernel launched a single CTA")
    if got != golden or scheduled != want_scheduled:
        raise AssertionError(f"{name}: placement golden {got}/{scheduled} != "
                             f"{golden}/{want_scheduled}")
    if launches <= 0 or launches != all_launches:
        raise AssertionError(f"{name}: the {variant} kernel variant was "
                             f"launched {launches} of {all_launches} times")
    # the scan alone, device time of every chunk launch in sequence
    plan = make_plan(snapshot, pods, False, policy)
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


def chunk_run(fn, plan, cuda, repeats, cluster=None, k=None):
    """Mean device time of `fn` on the main path's first chunk (of `k`
    pods, default a full chunk), each call from a fresh copy of the initial
    state, and the last call's outputs, final carry, rr and presence_dom as
    int64 arrays."""
    import torch

    from tpusim_torch.fastscan import CHUNK

    total = 0.0
    for _ in range(repeats):
        ci = ChunkInputs(plan, k or CHUNK, cuda)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(fn, plan, ci, cluster=cluster)
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
        PodPolicy,
        fastscan_chunk_plain,
        filter_pod,
        pod_interpod,
    )

    ci = ChunkInputs(plan, CHUNK, cuda)
    dp = ci.dp
    feasible, reach, spread_reads = [], [], 0
    for j in range(min(CHUNK, plan.num_pods)):
        row = ci.pods[j].tolist()
        ipp = pod_interpod(row, plan.num_scalars, dp.groups, dp.ip, ci.carry,
                           dp.alloc_scalar, ci.pd)
        if dp.pol is not None:
            # a policy plan's program holds its own inter-pod stage
            pp = PodPolicy(row, plan.num_scalars, dp.groups, dp.pol, ci.misc)
            before, _ = filter_pod(row, dp.statics, dp.tables, ci.carry,
                                   dp.alloc_scalar, plan.num_scalars,
                                   dp.groups, ipp, dp.pol, pp)
            ipp = None
        else:
            before, _ = filter_pod(row, dp.statics, dp.tables, ci.carry,
                                   dp.alloc_scalar, plan.num_scalars,
                                   dp.groups)
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


def interpod_ops(plan, feasible, reach, filter_on, weight):
    """The inter-pod operations of the main path's first chunk, counted from
    the kernel's source per pod (its group's terms) as IP_* above: the
    filter's only when the stage runs (`filter_on`), the score's only when
    the priority's `weight` is nonzero."""
    from tpusim_torch.fastplan import IpLayout
    from tpusim_torch.kernels.fastscan import EXIST_TABLES

    gpad, ta, tb, tp = plan.num_groups, plan.ta, plan.tb, plan.tp
    k_keys, d_doms = plan.n_topo_keys, plan.n_topo_doms_ip
    lay = IpLayout(ta, tb, tp, gpad)
    exist = {name: np.asarray(getattr(plan, name)) for name, _ in EXIST_TABLES}
    score = (IP_NORM_OPS + (weight != 1)) if weight else 0
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
        ops += (matched + exist_pairs) * d_doms * IP_SUM_OPS
        if filter_on:
            ops += nr * (own_required + k_keys) * IP_NODE_OPS
        if score:
            ops += nf * (weighted * IP_PREF_OPS + k_keys * IP_KEY_OPS + score)
    return ops


def chunk_bound_ms(plan, feasible, reach, spread_reads=0):
    """The least time for the main path's first chunk: inputs read once,
    outputs written once, over the memory rate; the operations this chunk's
    data needs over the 32-bit peak: the stages of the plan's stage program
    and the score components its weights turn on."""
    from tpusim_torch.config import policy_weights
    from tpusim_torch.fastscan import CHUNK, DevicePlan, pod_matrix
    from tpusim_torch.kernels import fastscan as kfs

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
    # the inter-pod domain rows, packed rows and exist-side tables, the
    # policy's residue tables
    groups = ((npad if plan.has_spread else 0)
              + (plan.zone_ok_tbl.size if plan.has_vol_zone else 0)
              + (plan.vol_tbl.size + 3 * plan.n_vols if plan.has_maxpd
                 else 0))
    carry = (7 + srows + plan.num_groups + vrows) * npad + 128
    if plan.has_interpod:
        groups += (plan.topo_rows.size + plan.ipod.size
                   + 3 * plan.num_groups * (plan.ta + plan.tb + plan.tp))
        carry += plan.presence_dom.size
    ps = plan.policy
    if ps is not None:
        groups += sum(getattr(plan, name).size for name in (
            "label_tbl", "label_prio_row", "image_tbl", "noexec_tbl",
            "saa_dom_tbl", "sa_val_tbl") if getattr(plan, name) is not None)
    pod_w = pod_matrix(plan, 0, 0, 1).shape[1]
    inputs = k * pod_w + (8 + srows) * npad + tables + groups + carry
    outputs = carry + k * (2 + nb)
    bytes_ = 4 * (inputs + outputs)

    dp = DevicePlan(plan, "cpu")
    program = (dp.pol.program if dp.pol is not None
               else kfs.stage_program(None, dp.groups, plan.has_interpod))
    ops_run = {op for op, _ in program}
    costs = {getattr(kfs, name): c for name, c in STAGE_OPS.items()}
    per_node = 0
    for op, operand in program:
        per_node += costs.get(op, 0)
        if op in (kfs.OP_GENERAL, kfs.OP_RES):
            per_node += STAGE_OPS_PER_SCALAR * plan.num_scalars
        if op == kfs.OP_SA:
            per_node += SA_OPS_PER_LABEL * (operand >> 16)
    w = policy_weights(ps, plan.most_requested)
    per_pair = SCORE_SELECT_OPS + sum(
        c + 1 + (wc != 1) for c, wc in zip(SCORE_COMPONENT_OPS, w) if wc)
    ops = (real * n * per_node + real * (npad - n) * PAD_OPS
           + pairs_feasible * per_pair)
    if plan.num_groups:
        stages = (("port_row", {kfs.OP_GENERAL, kfs.OP_PORTS}),
                  ("disk_row", {kfs.OP_DISK}))
        sets = sum(int(getattr(plan, name)[:real].sum())
                   for name, ops_of in stages
                   if getattr(plan, name) is not None and ops_of & ops_run)
        ops += sets * n * PRESENCE_OPS
    if plan.has_maxpd and kfs.OP_MAXPD in ops_run:
        counted = plan.vol_tbl[plan.gid[:real], :plan.n_vols].any(axis=1)
        ops += int(counted.sum()) * n * plan.n_vols * MAXPD_OPS_PER_VOL
    w_spread, w_interpod = w[6], w[7]
    if plan.has_spread and w_spread:
        ops += (spread_reads * SPREAD_OPS_PER_GROUP
                + pairs_feasible * (SPREAD_BLEND_OPS + (w_spread != 1)))
    if plan.has_interpod:
        ops += interpod_ops(plan, feasible, reach,
                            kfs.OP_INTERPOD in ops_run, w_interpod)
    if ps is not None:
        if plan.label_prio_row is not None:
            ops += pairs_feasible * LABEL_PRIO_OPS
        if ps.w_image and plan.image_tbl is not None:
            ops += pairs_feasible * (1 + (ps.w_image != 1))
        if plan.saa_row is not None:
            for j, nf in enumerate(feasible):
                ops += nf * (int(plan.saa_row[j].sum()) * SAA_OPS_PER_GROUP
                             + sum(map(bool, ps.saa_weights))
                             * SAA_OPS_PER_ENTRY)
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
    geom = fastscan_chunk.last_geometry
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
          f"on {card}; {geometry_text(geom)}")
    if diff != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version on the first chunk: max |diff| "
                             f"{diff}")
    return diff, ms, plain_ms, bound_ms, bound_by


def compare_interpod_kernel_with_plain(cuda):
    """Phase 9: the inter-pod variant on random inter-pod plans; returns the
    largest absolute difference seen (must be 0)."""
    from tpusim_torch.state import (
        BIT_AFFINITY_NOT_MATCH,
        BIT_AFFINITY_RULES,
        BIT_ANTI_AFFINITY_RULES,
        BIT_EXISTING_ANTI_AFFINITY,
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
        plan = make_plan(snapshot, pods, case["most_requested"],
                         hard_weight=case["hard_weight"])
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


def compare_policy_kernel_with_plain(cuda):
    """Phase 11: the policy variant on random policy plans; returns the
    largest absolute difference seen (must be 0)."""
    from tpusim_torch.fastscan import DevicePlan
    from tpusim_torch.kernels.fastscan import NUM_OPS
    from tpusim_torch.state import (
        BIT_NODE_LABEL_PRESENCE,
        BIT_SERVICE_AFFINITY,
        BIT_TAINTS_NOT_TOLERATED,
    )
    from tpusim_torch.workloads import (
        COMPAT_POLICIES,
        random_policy,
        random_policy_workload,
    )

    cases = [dict(seed=40, count_mode=True, noexec=True, ports_alias=True),
             dict(seed=41, sa_entries=2, maxpd_off=(0,)),
             dict(seed=42, general=False, count_mode=True),
             dict(seed=43, sa_entries=2, noexec=True, general=False),
             dict(seed=44, ports_alias=True, maxpd_off=(1, 2)),
             dict(seed=45, policy="1.9", interpod=True)]
    bits = {"label": BIT_NODE_LABEL_PRESENCE, "sa": BIT_SERVICE_AFFINITY,
            "taint": BIT_TAINTS_NOT_TOLERATED}
    worst = 0
    ops, seen = set(), set()
    for case in cases:
        knobs = {k: v for k, v in case.items()
                 if k not in ("policy", "interpod")}
        policy = (COMPAT_POLICIES[case["policy"]] if "policy" in case
                  else random_policy(**knobs))
        interpod = case.get("interpod", False)
        snapshot, pods = random_policy_workload(
            case["seed"], 512, 60 if interpod else 1000, interpod=interpod)
        plan = make_plan(snapshot, pods, False, policy)
        results = kernel_and_plain(plan, cuda)
        diff = max(int(np.abs(a - b).max(initial=0))
                   for a, b in zip(*results))
        placed = int((results[0][0] >= 0).sum())
        counts = results[0][1]
        reasons = {k: int(counts[:, b].sum()) for k, b in bits.items()}
        ps = plan.policy
        program = DevicePlan(plan, "cpu").pol.program
        ops |= {op for op, _ in program}
        seen |= {name for name, on in (
            ("count_mode", ps.always_check_all),
            ("ports_alias", bool(ps.ports_slots)),
            ("noexec", plan.noexec_tbl is not None),
            ("maxpd_off", not all(plan.maxpd_enabled)),
            ("two_sa", len(ps.sa_slots) >= 2),
            ("interpod_1.9", plan.has_interpod)) if on}
        print(f"phase 11: policy kernel vs plain {case}: Gpad "
              f"{plan.num_groups}, {len(program)} stages, "
              f"{len(ps.label_rows)} label rows, {len(ps.sa_slots)} SA "
              f"entries over {plan.sa_la} labels, {len(ps.saa_weights)} SAA "
              f"entries, count mode {ps.always_check_all}; {placed}/512 "
              f"placed, failed-node reasons {reasons}, max |diff| {diff}")
        if diff != 0:
            raise AssertionError(f"policy kernel disagrees with its plain "
                                 f"version on {case}: max |diff| {diff}")
        if placed == 0:
            raise AssertionError(f"case {case} places no pod")
        worst = max(worst, diff)
    want = {"count_mode", "ports_alias", "noexec", "maxpd_off", "two_sa",
            "interpod_1.9"}
    if ops != set(range(NUM_OPS)) or seen != want:
        raise AssertionError(f"phase 11 missed stage opcodes "
                             f"{sorted(set(range(NUM_OPS)) - ops)} or "
                             f"features {sorted(want - seen)}")
    return worst


def compare_cluster_hazards(cuda):
    """Phase 13: the kernel at forced cluster sizes against its plain
    version on workloads.cluster_hazard_cases; returns the largest absolute
    difference per kernels-line variant (must be 0)."""
    from tpusim_torch import workloads
    from tpusim_torch.kernels.fastscan import fastscan_chunk, fastscan_chunk_plain

    worst = {}
    for name, (build, policy, most_requested, hard_weight, variant) in \
            workloads.cluster_hazard_cases().items():
        snapshot, pods = build()
        plan = make_plan(snapshot, pods, most_requested, policy, hard_weight)
        npad = plan.alloc_cpu.shape[1]
        k = min(plan.num_pods, 512)
        _, want = chunk_run(fastscan_chunk_plain, plan, cuda, 1, k=k)
        placed = int((want[0] >= 0).sum())
        count_mode = plan.policy is not None and plan.policy.always_check_all
        key = "policy" if variant.startswith("policy") else variant
        for cluster in (2, 4, 16):
            if cluster > npad // 32:
                try:
                    chunk_run(fastscan_chunk, plan, cuda, 1, cluster, k)
                except ValueError as e:
                    print(f"phase 13: {name} ({variant}, Npad {npad}) "
                          f"{cluster} CTAs refused: {e}")
                    continue
                raise AssertionError(f"{name}: {cluster} CTAs on Npad {npad} "
                                     "were not refused")
            _, got = chunk_run(fastscan_chunk, plan, cuda, 1, cluster, k)
            g = fastscan_chunk.last_geometry
            diff = max(int(np.abs(a - b).max(initial=0))
                       for a, b in zip(got, want))
            last = max(lo for lo, _ in g.slabs if lo < plan.num_nodes)
            in_last = int((got[0] >= last).sum())
            pad_only = sum(lo >= plan.num_nodes for lo, _ in g.slabs)
            print(f"phase 13: {name} ({variant}, {plan.num_nodes} nodes, "
                  f"Npad {npad}) {g.cluster} CTAs of {g.threads} threads: "
                  f"{placed}/{k} placed ({k - placed} through the histogram"
                  f"{', count mode' if count_mode else ''}), {in_last} in "
                  f"the last CTA with real nodes, {pad_only} CTA(s) of pad "
                  f"nodes only; max |diff| {diff}")
            if g.cluster != cluster or diff != 0 or in_last == 0 \
                    or placed == 0:
                raise AssertionError(f"{name} at {cluster} CTAs: geometry "
                                     f"{g.cluster}, max |diff| {diff}, "
                                     f"{in_last} picks in the last CTA")
            worst[key] = max(worst.get(key, 0), diff)
    # one CTA on a slab too wide for its scratch in shared memory
    for key, (workload, args) in (
            ("group_free", ("random_workload", (11, 64, 10_000))),
            ("interpod", ("interpod_workload", (64, 10_000)))):
        snapshot, pods = getattr(workloads, workload)(*args)
        plan = make_plan(snapshot, pods, False)
        _, want = chunk_run(fastscan_chunk_plain, plan, cuda, 1, k=64)
        _, got = chunk_run(fastscan_chunk, plan, cuda, 1, 1, 64)
        g = fastscan_chunk.last_geometry
        diff = max(int(np.abs(a - b).max(initial=0)) for a, b in zip(got, want))
        print(f"phase 13: {workload}{args} ({key}, Npad "
              f"{plan.alloc_cpu.shape[1]}) at 1 CTA: {geometry_text(g)}; "
              f"{int((got[0] >= 0).sum())}/64 placed, max |diff| {diff}")
        if g.scratch_in_smem or diff != 0:
            raise AssertionError(f"{workload}{args} at 1 CTA: max |diff| "
                                 f"{diff}, scratch in shared memory "
                                 f"{g.scratch_in_smem}")
        worst[key] = max(worst[key], diff)
    return worst


def cluster_sweep(name, plan, card, cuda):
    """Phase 13: the kernel's time on the main path's first chunk at every
    cluster size."""
    from tpusim_torch.kernels.fastscan import CLUSTER_SIZES, fastscan_chunk

    times = {}
    for cluster in sorted(CLUSTER_SIZES):
        times[cluster], _ = chunk_run(fastscan_chunk, plan, cuda, 5, cluster)
        g = fastscan_chunk.last_geometry
        print(f"phase 13: {name} first chunk at {cluster} CTA(s) "
              f"({g.threads} threads, {g.nodes_per_thread} node(s) a "
              f"thread): kernel {times[cluster]:.4f} ms on {card}")
    return times


def compare_routes(card, cuda):
    """Phase 14: config 3's first ROUTES_PODS pods through the kernel and
    through the scan on the card, bit-equal."""
    import torch

    from tpusim_torch import workloads
    from tpusim_torch.backend import compile_inputs
    from tpusim_torch.fastplan import plan_fast
    from tpusim_torch.fastscan import fast_scan
    from tpusim_torch.scan import GRAPH_STEPS, scan_inputs, schedule_scan

    snapshot, pods = workloads.build_workload(ROUTES_PODS, 5_000)
    config, compiled, cols, ptabs = compile_inputs(snapshot, pods)
    plan, why = plan_fast(config, compiled, cols, ptabs)
    if plan is None:
        raise AssertionError(f"phase 14: the kernel refused config 3: {why}")
    kernel = fast_scan(plan, device=cuda)
    carry, statics, xs = scan_inputs(config, compiled, cols, ptabs, cuda)
    t0 = time.perf_counter()
    final, *scan = schedule_scan(config, carry, statics, xs,
                                 graph_steps=GRAPH_STEPS)
    scan = [t.cpu().numpy() for t in scan]
    scan_s = time.perf_counter() - t0
    diff = max(int(np.abs(np.asarray(a).astype(np.int64)
                          - b.astype(np.int64)).max(initial=0))
               for a, b in zip(kernel, scan))
    rr, advanced = int(final.rr), int(scan[2].sum())
    placed = int((scan[0] >= 0).sum())
    print(f"phase 14: config3 first {ROUTES_PODS} pods x 5000 nodes, "
          f"kernel vs scan on the card: {placed} placed, {advanced} "
          f"advanced, scan rr {rr}; choices, counts and advanced max |diff| "
          f"{diff}; scan {scan_s:.2f}s on {card}")
    if diff != 0 or rr != advanced or placed == 0:
        raise AssertionError(f"phase 14: the routes disagree: max |diff| "
                             f"{diff}, rr {rr} vs {advanced} advanced")


def drive_scan_route(card, cuda):
    """Phase 15: the hostname workload through TorchBackend on the card,
    which must take the scan and place by the golden; then the scan alone,
    timed; then the reference quickstart through run_simulation."""
    import torch

    from tpusim_torch import workloads
    from tpusim_torch.api.podspec import (
        expand_simulation_pods,
        parse_simulation_pods,
    )
    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backend import TorchBackend, compile_inputs
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.scan import GRAPH_STEPS, scan_inputs, schedule_scan
    from tpusim_torch.simulator import run_simulation

    workload, params, golden, want_scheduled = SCAN_GOLDEN
    n, nodes = params["num_pods"], params["num_nodes"]
    snapshot, pods = getattr(workloads, workload)(**params)
    backend = TorchBackend(device="cuda", fallback="error")
    launches = fastscan_chunk.launches
    t0 = time.perf_counter()
    placements = backend.schedule(pods, snapshot)
    cold_s = time.perf_counter() - t0
    got = choices_golden(backend.last_choices)
    scheduled = sum(1 for p in placements if p.scheduled)
    t0 = time.perf_counter()
    backend.schedule(pods, snapshot)
    warm_s = time.perf_counter() - t0
    if choices_golden(backend.last_choices) != got:
        raise AssertionError(f"{workload}: warm run placed differently")
    print(f"phase 15: {workload} ({n} pods, {nodes} nodes): route "
          f"{backend.last_route} ({backend.last_route_reason}); golden {got} "
          f"(want {golden}), {scheduled} scheduled (want {want_scheduled}); "
          f"cold {cold_s:.3f}s, warm {warm_s:.3f}s = {n / warm_s:.0f} pods/s "
          f"end to end on {card}")
    if backend.last_route != "scan" or fastscan_chunk.launches != launches:
        raise AssertionError(f"{workload}: took route "
                             f"{backend.last_route!r}, not the scan")
    if got != golden or scheduled != want_scheduled:
        raise AssertionError(f"{workload}: placement golden {got}/"
                             f"{scheduled} != {golden}/{want_scheduled}")

    # the scan alone: eagerly (one launch an operation) on the first
    # SCAN_EAGER_PODS pods, and as the backend runs it (blocks of
    # GRAPH_STEPS steps replayed as CUDA graphs) on every pod
    config, compiled, cols, ptabs = compile_inputs(snapshot, pods)
    carry, statics, xs = scan_inputs(config, compiled, cols, ptabs, cuda)
    for graph_steps, count in ((0, SCAN_EAGER_PODS), (GRAPH_STEPS, n)):
        part = type(xs)(*(col[:count] for col in xs))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _, choices, _, _ = schedule_scan(config, carry, statics, part,
                                         graph_steps=graph_steps)
        end.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        span_ms = start.elapsed_time(end)
        if not np.array_equal(choices.cpu().numpy(),
                              backend.last_choices[:count]):
            raise AssertionError(f"{workload}: the timed scan (graph_steps "
                                 f"{graph_steps}) placed differently")
        how = (f"{graph_steps} steps a CUDA graph" if graph_steps
               else "eager")
        print(f"phase 15: {workload} scan alone, {how}, first {count} pods: "
              f"{scan_s:.3f}s wall ({queued_s:.3f}s to queue every step), "
              f"device span {span_ms:.1f} ms (CUDA events), "
              f"{1e6 * scan_s / count:.0f} us a pod on {card}; groups "
              f"{compiled.groups.presence.shape[0]}, topology domains "
              f"{config.n_topo_doms}")

    sim_pods = expand_simulation_pods(parse_simulation_pods(QUICKSTART_JSON),
                                      deterministic_ids=True)
    with device_routes_only():
        status = run_simulation(list(reversed(sim_pods)), synthetic_cluster(
            4, milli_cpu=4000, memory=16 * 1024**3), device="cuda")
    digest = split_digest(status)
    print(f"phase 15: quickstart through run_simulation on the card: "
          f"{len(status.successful_pods)} scheduled, "
          f"{len(status.failed_pods)} failed; digest {digest} (want "
          f"{QUICKSTART_DIGEST})")
    if digest != QUICKSTART_DIGEST:
        raise AssertionError("quickstart placed differently from the JAX "
                             "package")


def drive_host_route(card):
    """Phase 16: the host route on the card's machine, parts (a)-(d)."""
    from tpusim_torch import workloads
    from tpusim_torch.api.podspec import (
        expand_simulation_pods,
        parse_simulation_pods,
    )
    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.backends import ReferenceBackend, placement_hash
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.simulator import auto_routes_to_host, run_simulation

    def walled(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    start = time.perf_counter()
    # (a) the quickstart on the host, asked for and picked by "auto"
    quick = expand_simulation_pods(parse_simulation_pods(QUICKSTART_JSON),
                                   deterministic_ids=True)
    if not auto_routes_to_host(len(quick), 4):
        raise AssertionError("phase 16: auto would not pick the host for "
                             "the quickstart")
    for backend in ("reference", "auto"):
        launches = fastscan_chunk.launches
        status, wall = walled(lambda: run_simulation(
            [p.copy() for p in reversed(quick)], synthetic_cluster(
                4, milli_cpu=4000, memory=16 * 1024**3), backend=backend))
        digest = split_digest(status)
        print(f"phase 16a: quickstart, backend {backend}: digest {digest} "
              f"(want {QUICKSTART_DIGEST}), {wall:.3f}s host wall")
        if digest != QUICKSTART_DIGEST or fastscan_chunk.launches != launches:
            raise AssertionError(f"phase 16a: quickstart on {backend}")

    # (b) the host route against the device routes: config 3's first pods,
    # which all fit, and config 4's node-affinity shape on 8 nodes, where a
    # third fail, so FitError.error() is held against format_fit_error
    for part, (params, want), routes in (
            ("config3", HOST_CONFIG3, ("kernel",)),
            ("config4", HOST_CONFIG4, ("kernel", "scan"))):
        snapshot, pods = workloads.build_workload(**params)
        host, host_s = walled(lambda: run_simulation(
            [p.copy() for p in pods], snapshot, backend="reference"))
        host_digest = split_digest(host)
        print(f"phase 16b: {part} {params['num_pods']} pods x "
              f"{params['num_nodes']} nodes: reference {host_digest} (want "
              f"{want}) in {host_s:.3f}s host wall "
              f"({params['num_pods'] / host_s:.1f} pods/s); "
              f"{len(host.successful_pods)} scheduled, "
              f"{len(host.failed_pods)} failed")
        if host_digest != want:
            raise AssertionError(f"phase 16b: {part} on the host route "
                                 "misses the JAX package's digest")
        if part == "config4" and not host.failed_pods:
            raise AssertionError("phase 16b: config4 holds no FitError text")
        for route in routes:
            launches = fastscan_chunk.launches
            with device_routes_only():
                card_status, card_s = walled(lambda: run_simulation(
                    [p.copy() for p in pods], snapshot, backend="torch",
                    route=route))
            kernel_launches = fastscan_chunk.launches - launches
            card_digest = split_digest(card_status)
            print(f"phase 16b: {part} torch {route} route {card_digest} in "
                  f"{card_s:.3f}s ({kernel_launches} kernel launches)")
            if card_digest != host_digest or \
                    (kernel_launches > 0) != (route == "kernel"):
                raise AssertionError(f"phase 16b: {part}'s {route} route "
                                     "and the host route differ")

    # (c) config 6's priority-banded feed with preemption on the host
    params, want, want_preempted = HOST_CONFIG6
    snapshot, pods = workloads.build_workload(**params)
    status, wall = walled(lambda: run_simulation(
        pods, snapshot, backend="reference", enable_pod_priority=True))
    digest, preempted = split_digest(status), len(status.preempted_pods)
    print(f"phase 16c: config6 {params['num_pods']} pods x "
          f"{params['num_nodes']} nodes, PodPriority, backend reference: "
          f"digest {digest} (want {want}), {preempted} preempted (want "
          f"{want_preempted}), {len(status.successful_pods)} scheduled; "
          f"{wall:.3f}s host wall ({params['num_pods'] / wall:.1f} pods/s)")
    if digest != want or preempted != want_preempted:
        raise AssertionError("phase 16c: config 6 differs from the JAX "
                             "package")

    # (d) a filter extender, served in process, dropping one node
    snapshot, pods = workloads.build_workload(300, 40)
    dropped = snapshot.nodes[0].name

    def transport(verb, args):
        items = [n for n in args["nodes"]["items"]
                 if n["metadata"]["name"] != dropped]
        return {"nodes": {"items": items},
                "failedNodes": {dropped: "dropped by the extender"}}

    policy = decode_policy({
        "kind": "Policy", "predicates": [{"name": "GeneralPredicates"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
        "extenders": [{"urlPrefix": "http://extender.invalid",
                       "filterVerb": "filter"}]})
    backend = TorchBackend(device="cuda", policy=policy,
                           extender_transport=transport)
    got, wall = walled(lambda: backend.schedule(pods, snapshot))
    ref = ReferenceBackend(policy=policy, extender_transport=transport
                           ).schedule(pods, snapshot)
    same = placement_hash(got) == placement_hash(ref) and \
        [p.message for p in got] == [p.message for p in ref]
    print(f"phase 16d: extender policy through TorchBackend on the card: "
          f"route {backend.last_route} ({backend.last_route_reason}), "
          f"{sum(p.scheduled for p in got)} scheduled, none on {dropped}: "
          f"{all(p.node_name != dropped for p in got)}; equal to "
          f"ReferenceBackend: {same}; {wall:.3f}s host wall")
    if backend.last_route != "reference" or not same \
            or any(p.node_name == dropped for p in got):
        raise AssertionError("phase 16d: the extender policy did not run "
                             "on the host route as ReferenceBackend does")
    try:
        TorchBackend(device="cuda", policy=policy, fallback="error",
                     extender_transport=transport).schedule(pods, snapshot)
    except NotImplementedError as exc:
        print(f"phase 16d: fallback='error' raises: {exc}")
    else:
        raise AssertionError("phase 16d: fallback='error' did not raise")

    total = time.perf_counter() - start
    print(f"phase 16: host route {total:.1f}s wall in all, against its "
          f"{HOST_BUDGET_S} s budget, on the machine of {card}")
    if total > HOST_BUDGET_S:
        raise AssertionError(f"phase 16: {total:.1f}s is past its "
                             f"{HOST_BUDGET_S} s budget")


@contextlib.contextmanager
def timed_on_card(module, name, record):
    """Wrap module.name so each call appends (args, outputs, start event,
    end event) to `record`, the events around it on the current stream; the
    caller reads the times after the run, so timing adds no wait."""
    import torch

    real = getattr(module, name)

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        record.append((args, out, start, end))
        return out

    setattr(module, name, timed)
    try:
        yield real
    finally:
        setattr(module, name, real)


def profiled_device_us(event):
    """An averaged profiler event's device self time, µs, under either
    name torch has given it."""
    t = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if t is None else t


def drive_hybrid(card):
    """Phase 17: config 6 through the preemption hybrid on the card."""
    import torch

    from tpusim_torch import preempt, scan, workloads
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.simulator import run_simulation

    def reset_counts():
        reset_launches()
        preempt.reset_preempt_stats()

    # (a) the cut feed on every arm
    params, want, want_preempted = HOST_CONFIG6
    snapshot, pods = workloads.build_workload(**params)
    for route, victims in (("kernel", "auto"), ("kernel", "host"),
                           ("scan", "auto")):
        feed = [p.copy() for p in pods]
        reset_counts()
        t0 = time.perf_counter()
        with device_routes_only():
            if victims == "auto":
                status = run_simulation(feed, snapshot, backend="torch",
                                        enable_pod_priority=True, route=route)
            else:
                status = preempt.run_with_preemption(
                    feed, snapshot, route=route, victims=victims)
        wall = time.perf_counter() - t0
        digest, preempted = split_digest(status), len(status.preempted_pods)
        paths = dict(preempt.PREEMPT_CLASS_STATS)
        launches = fastscan_chunk.launches
        print(f"phase 17a: config6 {params['num_pods']} pods x "
              f"{params['num_nodes']} nodes, route {route}, victims "
              f"{victims}: digest {digest} (want {want}), {preempted} "
              f"preempted (want {want_preempted}); victim picks {paths}; "
              f"{launches} kernel launches; "
              f"{dict(preempt.HYBRID_STATS)}; {wall:.3f}s wall on {card}")
        if digest != want or preempted != want_preempted:
            raise AssertionError(f"phase 17a: route {route}, victims "
                                 f"{victims} differs from the JAX package")
        if (launches > 0) != (route == "kernel"):
            raise AssertionError(f"phase 17a: route {route} launched the "
                                 f"kernel {launches} times")
        if victims == "auto" and not paths.get("device"):
            raise AssertionError("phase 17a: no victims picked on the card")
        if victims == "host" and paths.get("device"):
            raise AssertionError("phase 17a: victims picked on the card")

    # (b) bench.py's accelerator shape on route "kernel"
    params, want, (want_ok, want_failed, want_preempted) = HYBRID_CONFIG6
    snapshot, pods = workloads.build_workload(**params)
    selects, chunks = [], []
    reset_counts()
    with device_routes_only(), \
            timed_on_card(scan, "preempt_select", selects) as real_select, \
            timed_on_card(preempt, "fast_scan", chunks):
        t0 = time.perf_counter()
        status = run_simulation(pods, snapshot, backend="torch",
                                enable_pod_priority=True, route="kernel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fastscan_chunk.launches
    stats, paths = dict(preempt.HYBRID_STATS), dict(preempt.PREEMPT_CLASS_STATS)
    select_ms = [start.elapsed_time(end) for _, _, start, end in selects]
    chunk_ms = [start.elapsed_time(end) for _, _, start, end in chunks]
    device_ms = sum(select_ms) + sum(chunk_ms)
    digest = split_digest(status)
    counts = (len(status.successful_pods), len(status.failed_pods),
              len(status.preempted_pods))
    n = params["num_pods"]
    print(f"phase 17b: config6 {n} pods x {params['num_nodes']} nodes, route "
          f"kernel: digest {digest} (want {want}), scheduled/failed/"
          f"preempted {counts} (want {(want_ok, want_failed, want_preempted)})"
          f"; wall {wall:.3f}s = {n / wall:.1f} pods/s on {card}")
    print(f"phase 17b: {stats.get('fast_scan_calls', 0)} fast_scan calls "
          f"over {stats.get('pods_scanned', 0)} pods, {launches} kernel "
          f"launches ({fastscan_chunk.launches_by_variant}), "
          f"{stats.get('rearms', 0)} re-arms, {stats.get('recompiles', 0)} "
          f"recompiles, {stats.get('compiles', 0)} compiles; victim picks "
          f"{paths} ({stats.get('no_candidates', 0)} with no candidate)")
    if select_ms:
        print(f"phase 17b: preempt_select {len(select_ms)} calls, CUDA-event "
              f"span a call (the host's launch pace included) mean "
              f"{1000 * sum(select_ms) / len(select_ms):.1f} us, median "
              f"{1000 * float(np.median(select_ms)):.1f} us, max "
              f"{1000 * max(select_ms):.1f} us; lanes x slots up to "
              f"{max(a[1].shape[0] for a, _, _, _ in selects)} x "
              f"{max(a[13].shape[1] for a, _, _, _ in selects)}")
    print(f"phase 17b: device spans {sum(chunk_ms):.3f} ms in fast_scan "
          f"calls + {sum(select_ms):.3f} ms in preempt_select = "
          f"{device_ms:.3f} ms of {1000 * wall:.3f} ms wall: host share "
          f">= {1 - device_ms / (1000 * wall):.4f}")
    if digest != want or counts != (want_ok, want_failed, want_preempted):
        raise AssertionError("phase 17b: config 6 differs from the JAX "
                             "package's hybrid")
    if launches <= 0 or not paths.get("device") \
            or stats.get("route_scan", 0):
        raise AssertionError("phase 17b: the hybrid did not run on the "
                             "kernel and the card's victim selection")

    # (c) preempt_select on the card against the CPU on (b)'s lanes
    worst = 0
    for args, out, _, _ in selects:
        zero_req, tensors = args[0], args[1:]
        plain = real_select(zero_req, *(t.cpu() for t in tensors))
        for got, ref in zip(out, plain):
            diff = (got.cpu().to(torch.int64) - ref.to(torch.int64)).abs()
            worst = max(worst, int(diff.max()) if diff.numel() else 0)
    print(f"phase 17c: preempt_select on the card vs the CPU on "
          f"{len(selects)} sets of lanes: max |diff| {worst}")
    if not selects or worst:
        raise AssertionError("phase 17c: preempt_select on the card differs "
                             "from the CPU")
    # the same calls replayed under torch.profiler: the card's busy time,
    # without the host's launch gaps the CUDA-event spans of (b) include
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args, _, _, _ in selects:
            real_select(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(profiled_device_us(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if busy_us > 0:
        print(f"phase 17c: preempt_select replayed under torch.profiler: "
              f"{busy_us / len(selects):.1f} us of device busy time and "
              f"{n_kernels / len(selects):.0f} kernels a call, over "
              f"{len(selects)} calls on {card}")
    else:
        print("phase 17c: preempt_select device busy time not measured "
              "(the profiler recorded no device time)")


def as_numpy(a):
    """A tensor on any device, or an array, as a numpy array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def drive_chunked_scan(card):
    """Phase 18: config 3's first pods through TorchBackend(route="scan")
    whole and with TPUSIM_SCAN_CHUNK set, the outputs of both scans (the
    choices, counts, advanced flags and final carry) bit-equal."""
    import torch

    import tpusim_torch.backend as backend_module
    from tpusim_torch import workloads
    from tpusim_torch.backend import TorchBackend

    params, chunk = CHUNKED_SCAN
    n, nodes = params["num_pods"], params["num_nodes"]
    snapshot, pods = workloads.build_workload(**params)
    saved = os.environ.pop("TPUSIM_SCAN_CHUNK", None)
    outs = {}
    try:
        for name in ("schedule_scan", "schedule_scan_chunked"):
            if name == "schedule_scan_chunked":
                os.environ["TPUSIM_SCAN_CHUNK"] = str(chunk)
            record = []
            backend = TorchBackend(device="cuda", route="scan",
                                   fallback="error")
            with timed_on_card(backend_module, name, record):
                t0 = time.perf_counter()
                backend.schedule(pods, snapshot)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if len(record) != 1 or backend.last_route != "scan":
                raise AssertionError(f"phase 18: {name} ran {len(record)} "
                                     f"times on route {backend.last_route}")
            _, (final, *rest), start, end = record[0]
            outs[name] = [as_numpy(t) for t in (*final, *rest)]
            how = (f"chunks of {chunk} pods" if name != "schedule_scan"
                   else "one dispatch")
            print(f"phase 18: config3 first {n} pods x {nodes} nodes, route "
                  f"scan, {how}: {wall:.3f}s wall, scan span "
                  f"{start.elapsed_time(end):.1f} ms (CUDA events), "
                  f"{1e6 * wall / n:.0f} us a pod end to end on {card}")
    finally:
        os.environ.pop("TPUSIM_SCAN_CHUNK", None)
        if saved is not None:
            os.environ["TPUSIM_SCAN_CHUNK"] = saved
    whole, chunked = outs["schedule_scan"], outs["schedule_scan_chunked"]
    worst = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                if a.size else 0 for a, b in zip(whole, chunked))
    placed = int((whole[-3] >= 0).sum())
    print(f"phase 18: chunked vs whole: choices, counts, advanced and "
          f"{len(whole) - 3} carry fields max |diff| {worst}; {placed} of "
          f"{n} placed")
    if worst or any(a.shape != b.shape for a, b in zip(whole, chunked)):
        raise AssertionError("phase 18: the chunked scan differs from the "
                             "whole one")


def placement_hashes(results):
    from tpusim_torch.backends import placement_hash

    return [placement_hash(r.placements) for r in results]


def batched_step_profile(config_scenarios, steps=10):
    """Kernels and device busy µs a step of the batched scan over the given
    scenarios, from `steps` eager steps under torch.profiler (after two
    warm-up steps)."""
    import torch

    from tpusim_torch import scan, whatif

    config, staged = whatif._prepare_host_batch(
        config_scenarios, "DefaultProvider", 10, None)
    per = whatif._unify_batch([(s.statics, s.carry, s.xs) for s in staged])
    program = scan.BatchedScan(config, *whatif.stage_batch(
        *whatif._stack_host(per), torch.device("cuda")))
    for dst, src in zip(program.carry, program.carry0):
        dst.copy_(src)
    program._steps.t1.zero_()
    for _ in range(2):
        program._steps.step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            program._steps.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in kernels) / steps,
            sum(profiled_device_us(e) for e in kernels) / steps)


def drive_what_if(card):
    """Phase 19: BASELINE config 5 through run_what_if on the card."""
    import torch

    import tpusim_torch.fastscan as fastscan_module
    from tpusim_torch import scan, whatif, workloads
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    p = WHATIF_CONFIG5
    n_scen, n_pods, n_nodes = p["scenarios"], p["num_pods"], p["num_nodes"]
    t0 = time.perf_counter()
    scenarios = [workloads.build_workload(n_pods, n_nodes, seed=1000 + s)
                 for s in range(n_scen)]
    print(f"phase 19: built {n_scen} scenarios of {n_pods} pods x {n_nodes} "
          f"nodes in {time.perf_counter() - t0:.1f}s (not part of the "
          f"what-if wall); config 5's {CONFIG5_SCENARIOS} scenarios cut to "
          f"{n_scen}, widths kept, for the script's time")

    # (a) the public entry point on route auto: the fast loop
    reset_launches()
    calls, chunks = [], []
    with timed_on_card(whatif, "fast_scan", calls), \
            timed_on_card(fastscan_module, "fastscan_chunk", chunks):
        t0 = time.perf_counter()
        results = whatif.run_what_if(scenarios)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fastscan_chunk.launches
    by_variant = dict(fastscan_chunk.launches_by_variant)
    kernel_ms = sum(start.elapsed_time(end) for _, _, start, end in chunks)
    fast_ms = sum(start.elapsed_time(end) for _, _, start, end in calls)
    hashes = placement_hashes(results)
    scheduled = sum(r.scheduled for r in results)
    total = n_scen * n_pods
    print(f"phase 19a: config5 {n_scen} x {n_pods} pods x {n_nodes} nodes "
          f"through run_what_if (route auto): {wall:.3f}s wall = "
          f"{total / wall:.0f} pods/s, {scheduled} scheduled, digest "
          f"{combined_digest(hashes)}; {len(calls)} fast_scan calls, "
          f"{launches} kernel launches ({by_variant}); kernel time "
          f"{kernel_ms:.1f} ms (CUDA events), fast_scan spans "
          f"{fast_ms:.1f} ms: host share >= {1 - fast_ms / (1000 * wall):.4f}"
          f" on {card}")
    if len(calls) != n_scen or by_variant["group_free"] <= 0:
        raise AssertionError("phase 19a: the fast loop did not run one "
                             "fast_scan a scenario on the kernel")

    # (b) the first scenarios on the batched scan
    k = BATCHED_SCENARIOS
    runs = []
    with timed_on_card(scan.BatchedScan, "run", runs):
        t0 = time.perf_counter()
        batched = whatif.run_what_if(scenarios[:k], route="scan")
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
    if len(runs) != 1:
        raise AssertionError(f"phase 19b: {len(runs)} batched runs")
    span_ms = runs[0][2].elapsed_time(runs[0][3])
    same = placement_hashes(batched) == hashes[:k]
    print(f"phase 19b: first {k} scenarios on the batched scan (route "
          f"scan): {wall_b:.3f}s wall, scan span {span_ms:.1f} ms (CUDA "
          f"events, one eager step and the graph capture included) = "
          f"{1000 * span_ms / n_pods:.0f} us a step at S = {k}; every "
          f"scenario's digest equal to 19a's: {same}")
    if not same:
        raise AssertionError("phase 19b: the batched scan differs from the "
                             "fast loop")

    # (c) bench.py's CPU shape on both routes against the JAX package
    params, want = WHATIF_CPU_SHAPE
    small = [workloads.build_workload(params["num_pods"],
                                      params["num_nodes"], seed=1000 + s)
             for s in range(params["scenarios"])]
    for route in ("auto", "scan"):
        runs = []
        with timed_on_card(scan.BatchedScan, "run", runs):
            t0 = time.perf_counter()
            got = combined_digest(placement_hashes(
                whatif.run_what_if(small, route=route)))
            wall_c = time.perf_counter() - t0
        spans = "".join(f", scan span {start.elapsed_time(end):.1f} ms"
                        for _, _, start, end in runs)
        print(f"phase 19c: config5 CPU shape {params['scenarios']} x "
              f"{params['num_pods']} x {params['num_nodes']}, route {route}:"
              f" digest {got} (want {want}), {wall_c:.3f}s wall{spans}")
        if got != want:
            raise AssertionError(f"phase 19c: route {route} differs from "
                                 "the JAX package's run_what_if")

    # last, as the profiler may slow what runs after it: the batched step's
    # kernels at S = 1 and S = BATCHED_SCENARIOS
    for s in (1, k):
        per_step, busy_us = batched_step_profile(scenarios[:s])
        print(f"phase 19b: batched scan at S = {s}: {per_step:.0f} kernels "
              f"and {busy_us:.0f} us of device busy time a step "
              f"(torch.profiler, 10 eager steps) on {card}")


def drive_serve(card):
    """Phase 20: bench.py's config 8 load through the serve fleet."""
    import torch

    from tpusim_torch import whatif, workloads
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    params, bucket, want = SERVE_CONFIG8
    snapshot, pool, load = serve_load(workloads.build_workload(**params),
                                      WhatIfRequest)
    fleet = ScenarioFleet(bucket_size=bucket, flush_after_s=0.05,
                          device="cuda")
    fleet.register_snapshot("base", snapshot)
    for label in ("cold", "warm"):
        before = whatif.compile_count()
        t0 = time.perf_counter()
        responses = fleet.run(load())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        builds = whatif.compile_count() - before
        bad = [r for r in responses if not r.ok]
        if bad:
            raise AssertionError(f"phase 20: {len(bad)} requests failed: "
                                 f"{bad[0].error}")
        got = combined_digest(r_hash for r_hash in placement_hashes(
            [r.result for r in responses]))
        hits = sum(1 for r in responses if r.compile_cache_hit)
        print(f"phase 20: config8 {label} pass: {len(responses)} requests "
              f"of {min(len(r.result.placements) for r in responses)}-"
              f"{max(len(r.result.placements) for r in responses)} pods x "
              f"{params['num_nodes']} nodes, bucket {bucket}: {wall:.3f}s = "
              f"{len(responses) / wall:.1f} scenarios/s; {builds} program "
              f"builds, compile_cache_hit {hits}/{len(responses)}; digest "
              f"{got} (want {want}) on {card}")
        if got != want:
            raise AssertionError(f"phase 20: the {label} pass differs from "
                                 "the JAX package's ScenarioFleet")
        if label == "warm" and (builds or hits != len(responses)):
            raise AssertionError("phase 20: the warm pass built a program")
    print(f"phase 20: fleet stats {fleet.executor.stats}, "
          f"{len(fleet.executor._programs)} programs held")


def percentile(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(round(q * (len(values) - 1))))]


def run_stream(params, label, phase, card):
    """run_stream_simulation on the card over a STREAM_GOLDENS or
    STREAM_CONFIG* cell, with each resident scan's CUDA-event span; prints
    a line and returns (summary, spans in ms, fused kernel launches)."""
    import torch

    import tpusim_torch.api.snapshot as api
    from tpusim_torch import scan
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.simulator import run_stream_simulation

    kw = stream_arguments(params, api, decode_policy)
    record = []
    reset_launches()
    with timed_on_card(scan.ResidentScan, "run", record):
        out = run_stream_simulation(device="cuda", **kw)
        torch.cuda.synchronize()
    spans = [start.elapsed_time(end) for _, _, start, end in record]
    launches = fastscan_chunk.launches
    scan_text = (f"resident scan {len(spans)} runs, CUDA-event span p50 "
                 f"{percentile(spans, 0.5):.3f} / p99 "
                 f"{percentile(spans, 0.99):.3f} / sum {sum(spans):.1f} ms"
                 if spans else "no resident scan")
    verified = (f"; verified {out['verified']}" if "verified" in out
                else "")
    print(f"phase {phase}: {label}: {out['cycles']} cycles x "
          f"{params['arrivals']} arrivals on {out['nodes']} nodes: "
          f"{out['elapsed_s']:.3f}s wall, {out['decisions_per_s']:.1f} "
          f"decisions/s, {out['scheduled']}/{out['decisions']} scheduled, "
          f"cycle p50/p99 {out['p50_cycle_ms']:.2f}/"
          f"{out['p99_cycle_ms']:.2f} ms; {scan_text}; fused kernel "
          f"launches {launches}; paths {out['paths']}, restages "
          f"{out['restages']}, commits {out['commits']}; chain "
          f"{out['placement_chain'][:16]}, fold {out['fold_chain'][:16]}"
          f"{verified} on {card}")
    return out, spans, launches


def check_stream_golden(name, phase, card):
    """A stream cell at bench.py's CPU shape on the card against the JAX
    package's chains."""
    params, want_chain, want_fold = STREAM_GOLDENS[name]
    out, _, _ = run_stream(params, f"{name} CPU shape", phase, card)
    if (out["placement_chain"], out["fold_chain"]) != (want_chain,
                                                       want_fold):
        raise AssertionError(f"phase {phase}: {name} differs from the JAX "
                             f"package's chains {want_chain[:16]}, "
                             f"{want_fold[:16]}")


def drive_stream_churn(card):
    """Phase 21: bench config 9, stream churn: the eviction curve at the
    middle size, the stream and restage arms at every size (equal chains),
    a verified run and the CPU shape."""
    big_mid = STREAM_SIZES[1]
    stream = {}
    for frac in STREAM_EVICT_CURVE:
        out, _, launches = run_stream(
            dict(STREAM_CONFIG9, num_nodes=big_mid, evict_fraction=frac),
            f"config9 stream arm, evict {frac}", 21, card)
        if out["restages"] != {"cold_start": 1} or launches:
            raise AssertionError("phase 21: the stream arm restaged past its "
                                 "cold start or launched the fused kernel")
        if frac == STREAM_CONFIG9["evict_fraction"]:
            stream[big_mid] = out
    for n in STREAM_SIZES:
        if n not in stream:
            stream[n], _, _ = run_stream(dict(STREAM_CONFIG9, num_nodes=n),
                                         "config9 stream arm", 21, card)
        restage, _, _ = run_stream(dict(STREAM_CONFIG9, num_nodes=n,
                                        always_restage=True),
                                   "config9 restage arm", 21, card)
        if restage["placement_chain"] != stream[n]["placement_chain"]:
            raise AssertionError(f"phase 21: the arms differ at {n} nodes")
    got, _, _ = run_stream(dict(STREAM_CONFIG9, num_nodes=big_mid,
                                cycles=STREAM_VERIFY_CYCLES, verify=True),
                           "config9 verified", 21, card)
    if not got["verified"]:
        raise AssertionError(f"phase 21: {got['mismatched_cycles']} cycles "
                             "differ from a fresh TorchBackend.schedule")
    check_stream_golden("config9", 21, card)


def drive_policy_stream(card):
    """Phase 22: bench config 10, the policy stream: the churn curve at the
    middle size (no restage after the cold start), the synchronous,
    pipelined and restage arms at every size (equal chains) and the CPU
    shape."""
    for label_churn, taint_churn in STREAM_CHURN_CURVE:
        out, _, _ = run_stream(
            dict(STREAM_CONFIG10, num_nodes=STREAM_SIZES[1],
                 label_churn=label_churn, taint_churn=taint_churn),
            f"config10 churn {label_churn}+{taint_churn}", 22, card)
        if out["restages"] != {"cold_start": 1}:
            raise AssertionError("phase 22: label and taint churn restaged")
    for n in STREAM_SIZES:
        chains = set()
        for arm, extra in (("synchronous", {}),
                           ("pipelined", {"pipeline": True}),
                           ("restage", {"always_restage": True})):
            out, _, _ = run_stream(
                dict(STREAM_CONFIG10, num_nodes=n, label_churn=2,
                     taint_churn=1, **extra), f"config10 {arm}", 22, card)
            chains.add((out["placement_chain"], out["fold_chain"]))
            if arm != "restage" and out["restages"] != {"cold_start": 1}:
                raise AssertionError("phase 22: label and taint churn "
                                     "restaged")
        if len(chains) != 1:
            raise AssertionError(f"phase 22: the arms differ at {n} nodes")
    check_stream_golden("config10", 22, card)


def gang_feed(api, grp):
    """A one-shot feed of config 13's shape: 8 gangs of 8 members of 500m
    between runs of 16 ungrouped pods, in podspec order, after two gangs
    that nodes of 4 CPUs cannot wholly hold: "huge" (8 members of 8 CPUs,
    rejected whole) and "part" (min-available 4, every other member of 8
    CPUs: admitted at 4/8)."""
    pods = [grp.mark_gang(api.make_pod(f"huge-{j}", milli_cpu=8000), "huge")
            for j in range(8)]
    pods += [grp.mark_gang(api.make_pod(f"part-{j}",
                                        milli_cpu=8000 if j % 2 else 500),
                           "part", min_available=4) for j in range(8)]
    for g in range(8):
        pods += [api.make_pod(f"solo-{g}-{j}", milli_cpu=250,
                              memory=512 << 20) for j in range(16)]
        pods += [grp.mark_gang(api.make_pod(f"g{g}-{j}", milli_cpu=500),
                               f"g{g}") for j in range(8)]
    return pods


def drive_gang_stream(card):
    """Phase 23: bench config 13, gang admission on the stream, and a
    one-shot gang feed through run_simulation on the card."""
    import os

    import torch

    import tpusim_torch.api.snapshot as api
    from tpusim_torch import gang, scan, workloads
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.delta import IncrementalCluster
    from tpusim_torch.gang.driver import schedule_with_gangs
    from tpusim_torch.gang.oracle import select_oracle
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.simulator import run_simulation

    calls = []
    with device_routes_only(), timed_on_card(scan, "gang_select", calls):
        out, _, launches = run_stream(STREAM_CONFIG13, "config13 gang stream",
                                      23, card)
    cycles = STREAM_CONFIG13["cycles"]
    if not out["verified"] or out["paths"] != {"gang": cycles} \
            or launches <= 0:
        raise AssertionError("phase 23: the gang stream was not verified, "
                             "not all gang cycles, or never launched the "
                             "fused kernel")
    solve_ms = [start.elapsed_time(end) for _, _, start, end in calls]
    diff = 0
    for args, choices, _, _ in calls:
        feasible, score, *members, gi, n_zone, n_rack = args
        host = [t.cpu().numpy() for t in (feasible, score, *members, *gi)]
        want = select_oracle(*host, n_zone, n_rack)
        diff = max(diff, int(np.abs(np.asarray(want)
                                    - choices.cpu().numpy()).max()))
    print(f"phase 23: gang_select on the card vs select_oracle on "
          f"{len(calls)} gangs (both the twin's and the verify arm's): max "
          f"|diff| {diff}; CUDA-event span a solve p50 "
          f"{percentile(solve_ms, 0.5):.3f} ms; {launches} fused kernel "
          f"launches for the ungrouped segments on {card}")
    if diff:
        raise AssertionError("phase 23: gang_select differs from its oracle")
    check_stream_golden("config13", 23, card)

    # a one-shot gang feed through run_simulation on the card, the solve on
    # the card and on the host oracle
    def racked():
        return workloads.racked_cluster(STREAM_CONFIG13["racked"])

    # the rejected gang's one shared FitError, the overflow members' own
    want_failed = {f"huge-{j}": (
        f"0/{len(racked().nodes)} nodes are available: pod group \"huge\" "
        f"requires 8/8 members, only 0 fit jointly.") for j in range(8)}
    want_failed.update({f"part-{j}": (
        "pod group \"part\" admitted at 4/8; this member did not fit.")
        for j in range(1, 8, 2)})
    splits = {}
    for solve in ("device", "host"):
        if solve == "host":
            os.environ["TPUSIM_GANG_KERNEL"] = "0"
        try:
            t0 = time.perf_counter()
            with device_routes_only():
                status = run_simulation(gang_feed(api, gang), racked())
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("TPUSIM_GANG_KERNEL", None)
        failed = {p.name: p.status.conditions[-1].message
                  for p in status.failed_pods}
        bound = {p.name for p in status.successful_pods}
        if failed != want_failed or len(bound) != len(gang_feed(api, gang)) \
                - len(want_failed):
            raise AssertionError(f"phase 23: solve on the {solve}: the "
                                 "rejected and overflow members differ from "
                                 "all or nothing at min-available")
        splits[solve] = split_digest(status)
        print(f"phase 23: one-shot gang feed through run_simulation, solve "
              f"on the {solve}: {len(status.successful_pods)} scheduled, "
              f"{len(status.failed_pods)} failed, digest {splits[solve]}, "
              f"{wall:.3f}s")
    if set(splits.values()) != {GANG_FEED_DIGEST}:
        raise AssertionError("phase 23: the one-shot feed's split differs "
                             f"from the JAX package's {GANG_FEED_DIGEST}")
    backend = TorchBackend(device="cuda")
    reset_launches()
    with device_routes_only():
        schedule_with_gangs(backend, IncrementalCluster(racked()),
                            list(reversed(gang_feed(api, gang))))
    torch.cuda.synchronize()
    print(f"phase 23: the feed's ungrouped segments: route "
          f"{backend.last_route}, {fastscan_chunk.launches} fused kernel "
          f"launches ({dict(fastscan_chunk.launches_by_variant)})")
    if backend.last_route != "kernel" or fastscan_chunk.launches <= 0:
        raise AssertionError("phase 23: the ungrouped segments did not run "
                             "the fused kernel")


def drive_live_whatif(card):
    """Phase 24: bench config 16, live what-if overlays on warm twins."""
    import torch

    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.stream import ChurnLoadGen, StreamSession
    from tpusim_torch.whatif import run_what_if

    p = LIVE_WHATIF
    rng = np.random.RandomState(16)
    qpods = [make_pod(f"bench16-q{i}", milli_cpu=int(rng.randint(100, 1500)),
                      memory=int(rng.randint(2 ** 20, 2 ** 30)))
             for i in range(p["query_pods"])]
    for n in p["sizes"]:
        t0 = time.perf_counter()
        session = StreamSession(synthetic_cluster(n))
        gen = ChurnLoadGen(synthetic_cluster(n), seed=16,
                           arrivals=p["arrivals"], evict_fraction=0.25)
        for c in range(p["warm_cycles"]):
            session.apply_events(gen.events(c))
            gen.note_bound(session.schedule(gen.batch()))
        warm = time.perf_counter() - t0
        # the first query builds its bucket's program and captures its
        # graph; the timed ones must replay it and build nothing
        if session.overlay_query(qpods) is None:
            raise AssertionError(f"phase 24: the warm twin of {n} nodes "
                                 "refused the overlay")
        programs = dict(session.device._programs)
        graphs = {b: prog._steps.graph for b, prog in programs.items()}
        before = [t.clone() for t in session.device.carry]
        times = []
        for _ in range(p["repeats"]):
            t0 = time.perf_counter()
            placements = session.overlay_query(qpods)
            torch.cuda.synchronize()
            times.append(1000 * (time.perf_counter() - t0))
        same = all(torch.equal(a, b)
                   for a, b in zip(before, session.device.carry))
        retraced = (session.device._programs != programs
                    or any(prog._steps.graph is not graphs[b]
                           for b, prog in programs.items()))
        live = session.inc.to_snapshot()
        run_what_if([(live, qpods)])
        t0 = time.perf_counter()
        [staged] = run_what_if([(live, qpods)])
        staged_ms = 1000 * (time.perf_counter() - t0)
        parity = (placement_hash(placements)
                  == placement_hash(staged.placements))
        print(f"phase 24: config16 warm twin of {n} nodes "
              f"({p['warm_cycles']} cycles, {warm:.1f}s), {p['query_pods']} "
              f"query pods: overlay {sum(times) / len(times):.3f} ms a query "
              f"(mean of {p['repeats']}: "
              f"{', '.join(f'{t:.3f}' for t in times)}), staged run_what_if "
              f"{staged_ms:.3f} ms; answers equal run_what_if on the live "
              f"snapshot: {parity}; carry bit-equal after the queries: "
              f"{same}; programs built or graphs captured by the timed "
              f"queries: {int(retraced)} on {card}")
        if not (parity and same) or retraced:
            raise AssertionError("phase 24: the overlay differs from "
                                 "run_what_if, left the carry changed or "
                                 "built or captured again while timed")


def drive_stream_phases(card):
    """Phases 21-24 inside STREAM_BUDGET_S."""
    t0 = time.perf_counter()
    drive_stream_churn(card)
    drive_policy_stream(card)
    drive_gang_stream(card)
    drive_live_whatif(card)
    wall = time.perf_counter() - t0
    print(f"phases 21-24: {wall:.1f}s wall in all, against their "
          f"{STREAM_BUDGET_S} s budget")
    if wall > STREAM_BUDGET_S:
        raise AssertionError(f"phases 21-24: {wall:.1f}s is past their "
                             f"{STREAM_BUDGET_S} s budget")


def main():
    t_start = time.perf_counter()
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

    # phases 11-12: the policy variant (Variant 5)
    pol_err = compare_policy_kernel_with_plain(cuda)
    pol_launches, plan_pol = drive_main_path("policy", card, cuda)
    diff, *timed["policy"] = time_first_chunk("policy", plan_pol, card, cuda,
                                              12)
    pol_err = max(pol_err, diff)

    # phase 13: the cluster at forced sizes on the hazard plans, folded into
    # each variant's error, then the cluster-size sweep
    hazard = compare_cluster_hazards(cuda)
    max_err = max(max_err, hazard["group_free"])
    group_err = max(group_err, hazard["groups"])
    ip_err = max(ip_err, hazard["interpod"])
    pol_err = max(pol_err, hazard["policy"])
    for name, plan in (("config3", plan3), ("policy", plan_pol)):
        cluster_sweep(name, plan, card, cuda)

    # phases 14-15: the exact sequential scan, against the kernel and alone
    compare_routes(card, cuda)
    drive_scan_route(card, cuda)

    # phase 16: the host route on this machine
    drive_host_route(card)

    # phase 17: the preemption hybrid
    drive_hybrid(card)

    # phases 18-20: the chunked scan, batched what-if and the serve fleet
    t_whatif = time.perf_counter()
    drive_chunked_scan(card)
    drive_what_if(card)
    drive_serve(card)
    whatif_s = time.perf_counter() - t_whatif
    print(f"phases 18-20: {whatif_s:.1f}s wall in all, against their "
          f"{WHATIF_BUDGET_S} s budget")
    if whatif_s > WHATIF_BUDGET_S:
        raise AssertionError(f"phases 18-20: {whatif_s:.1f}s is past their "
                             f"{WHATIF_BUDGET_S} s budget")

    # phases 21-24: the gang driver and the streaming twin
    drive_stream_phases(card)

    kernels = []
    for name, variant, replaces, n_launch, err in (
            ("config3", "group_free", "tpusim/jaxe/fastscan.py:1164",
             launches, max_err),
            ("groups", "groups", "tpusim/jaxe/fastscan.py:1386",
             group_launches, group_err),
            ("interpod", "interpod", "tpusim/jaxe/fastscan.py:1389",
             ip_launches, ip_err),
            ("policy", "policy", "tpusim/jaxe/fastscan.py:1436",
             pol_launches, pol_err)):
        ms, plain_ms, bound_ms, bound_by = timed[name]
        kernels.append({
            "name": f"fastscan_chunk[{variant}]", "route": "cuda",
            "source": "tpusim_torch/csrc/fastscan.cu", "replaces": replaces,
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s wall in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
