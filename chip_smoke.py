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
     golden, the scheduled count, and launches > 0 of every kernel, cold
     and warm;
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
     package records; cold and warm wall; then the scan alone, eagerly on its
     first 200 pods and as the backend runs it (blocks of steps replayed
     as CUDA graphs) on its first 2,000, each with its device span
     (CUDA events) and microseconds a pod; then the reference
     quickstart (byte-granular memory) through run_simulation on the card,
     with the host route made to raise, whose split must digest as the JAX
     package's does;
 16. the host route on the card's machine, each part with its wall (host
     time): (a) the quickstart through run_simulation with backend
     "reference" and "auto" (which must pick the host for 20 pods on 4
     nodes), both with the quickstart's digest; (b) config 3's first 40
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
     (b) produced, equal (tolerance 0), then the first PROFILED_SELECTS of
     those calls replayed under torch.profiler for the card's busy time a
     call;
 18. the chunked scan: config 3's first 4,096 pods on its 5,000 nodes
     through TorchBackend(route="scan") whole and with TPUSIM_SCAN_CHUNK
     2,048: choices, counts, advanced and the final carry bit-equal, with
     the walls and µs a pod of each;
 19. BASELINE config 5: (a) 2 of its 50 scenarios (a cut of depth for the
     script's time) of 20,000 pods on 1,000 nodes (build_workload, seeds
     1000-1001) through run_what_if on route
     "auto": one fast_scan a scenario on the kernel, with the wall, pods/s,
     kernel time (CUDA events) and host share; (b) the 2 again on the
     batched scan (route "scan"), every scenario's placement hash equal to
     (a)'s, with its µs a step; (c) bench.py's CPU shape (8 x 5,000 x 500)
     on both routes, the JAX package's combined digest; then the batched
     step's kernels and device busy time at S = 1 and S = 2 under
     torch.profiler;
 20. bench.py's config 8 through the serve fleet (ScenarioFleet, buckets of
     8): 64 requests of the first 1,001-2,000 pods of a 2,000-pod pool on
     200 nodes, a cold and a warm pass, each the JAX package's combined
     digest; the warm pass builds no program and hits the program cache on
     every response. Phases 18-20 fail past their 300 s budget;
 21. bench config 9 through the streaming twin (run_stream_simulation on
     the card, the resident scan replaying its captured graphs, each run's
     CUDA-event span): the stream arm at 16,000 nodes (20 cycles of 64
     arrivals, 25% evicted, seed 9), which must restage only at its cold
     start and launch no fused kernel; the stream and restage arms at 4,000
     nodes, equal chains; a verified run at 4,000 nodes (10 cycles, every
     cycle held against a fresh TorchBackend.schedule); bench.py's CPU
     shape (800 nodes, 24 cycles), the JAX package's placement and fold
     chains;
 22. bench config 10, its policy with label and taint churn: the churn
     curve at 4,000 nodes, and synchronous, pipelined and restage arms at
     1,000, 4,000 and 16,000 nodes: equal chains, no restage after the cold
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
     run_what_if's. Phases 21-24 fail past their 240 s budget;
 25. event-log replay at full width: config 3 (100k pods on 5k nodes) with
     a watch-event log of 2,200 events (workloads.event_log_workload: nodes
     added, deleted and grown, placed pods added and deleted) written as
     wire frames, read back through load_event_log and run through
     run_simulation(events=) on the card with the host route made to raise:
     the JAX package's split digest, the same split as a run on the folded
     snapshot, 196 fused launches, and the wall with the fold's and the
     compile's spans; (b) the preemption hybrid with such a log on config
     6's feed (20,000 pods on 1,000 nodes): the JAX package's digest and
     counts; (c) the CLI's --event-log once at a small shape;
 26. the flight recorder and the metrics registry on the main path: config
     3 through run_simulation once more, warm, with a recorder installed:
     phase 4's golden, and the trace, exported and read back as Chrome
     JSON, split into backend_schedule's layers (compile_cluster,
     device_dispatch's wall and CUDA-event time, decode_placements and the
     rest), its wall beside phase 4's; one config 9 stream at 4,000 nodes
     with the recorder, split into its cycles' commit, dispatch and decode
     spans; then the stream CLI's --metrics-out, whose scheduler_*,
     tpusim_backend_* and tpusim_stream_* families must count;
 27. serve's live twins: a config 16 twin (a StreamSession on 4,000 nodes
     after 4 churn cycles) attached to a ScenarioFleet answers 32 requests
     of 8 pods by overlay queries, each equal to a staged run_what_if on
     the twin's live snapshot, the carry bit-equal after them; a request
     under another policy goes the staged path, counted as a plan
     mismatch; the overlay's ms a query; then `serve --attach-stream` once.
     Phases 25-27 fail past their 120 s budget;
 28. decision provenance: (a) config 3 at full width on route "kernel"
     with a failures-only ProvenanceLog: phase 4's golden, 196 launches,
     a record a pod, each failure's message its Placement's, the schedule's
     wall beside phase 4's and the records' decode; (b) the explain lanes
     (top 3) on the scan route with graphs, on config 3's first 8,192 pods
     on its 5,000 nodes (also timed without the lanes) and on the policy
     workload's first 2,048 under the upstream 1.2 policy: the digest of
     the records (time stamps dropped) equal to the JAX package's, every
     row's parts summing to its score, µs a pod, and route "kernel" with
     top-k lanes raising;
 29. bench config 12 (bench.py:1712-1745): the config 9 stream at 4,000
     nodes (40 cycles of 64 arrivals, 25% evicted, seed 9) after a
     warm-up, with the analytics plane off and on, synchronous and
     pipelined: chains equal and the JAX package's, the cold start the only
     restage, overhead_fraction printed beside the JAX contract (< 2%, not
     gated); a run sampling every cycle with its inputs kept, every sample
     equal to host_reduce, with the reduction's CUDA-event span; the CPU
     shape's samples digest equal to the JAX package's; one config 8 serve
     bucket's pre-bind samples against host_reduce; the reduction's kernels
     and device time under torch.profiler. Phases 28-29 fail past their
     90 s budget;
 30. the live-cluster snapshot and the watch fabric: (a) a stdlib fake
     apiserver in this process (127.0.0.1, a port the OS picks) serves the
     interpod workload's 5,000 nodes and 2,000 Running pods with 500
     decoys in other phases, as JSON behind a bearer token; a JSON
     kubeconfig, snapshot_from_cluster (the decoys dropped by the
     status.phase=Running field selector), then the 100,000 pods through
     TorchBackend(route="kernel", fallback="error"): phase 10's golden,
     scheduled count and 196 launches of the interpod variant, with the
     fetch's wall and bytes beside phase 10's wall; (b) the main command
     with --kubeconfig against the same apiserver, as child processes on
     the card: with --scheduler-policy-configmap (upstream's 1.2 policy)
     and with the default provider, each report's digest the JAX
     package's, and a ConfigMap without policy.cfg giving the JAX
     package's error and rc 2; (c) config 9's churn (4,000 nodes, 40
     cycles of 64 arrivals, 25% evicted, seed 9) fed to a StreamSession
     only through a FakeRESTClient's node and pod Reflectors, the node
     watch swapped for a two-slot buffer at cycle 20 and an empty node's
     cordon flapped three times: the JAX package's chains, one relist,
     one overflow counted, the cold start and watch_expired the only
     restages, the cycle p50 and the resident scan's span beside phase
     21's; and the CPU shape's chains;
 31. the live telemetry plane: (a) the config 9 stream at 4,000 nodes
     unarmed, then synchronous and pipelined with start_server, the
     recorder, the analytics plane (inputs kept) and the SLO tracker
     armed, every path scraped each 50 ms from a thread: every scrape 200
     (404 for an unknown path) and parsed, /healthz "ok" with role
     "none", every served /analytics sample equal to host_reduce of its
     inputs (samples read during pipelined cycles among them), `top
     --once` naming the 4,000 valid nodes, the SLO's verdicts summing to
     the cycles, the chains the JAX package's (phase 29's), the scrapes'
     latency and the cycle p50s beside the unarmed run's; (b) the stream
     unarmed, then traced: one trace id on each cycle's spans (its
     device_dispatch included), exemplars on
     tpusim_stream_cycle_latency, tools/trace_lint.py clean, the chain
     as untraced; then traced again with the SLO target at the traced
     run's cycle p50: each verdict the judged latency against the target,
     both verdicts and a slo:burn_start instant (a run that drift put
     wholly on one side of the target is judged again at its own p50, up
     to SLO_RUNS runs); phase
     27's twin behind a fleet answering 8 traced requests by overlays,
     each one connected trace, the serve SLO path counting 8; (c) `stream --listen 127.0.0.1:0 --slo-target-ms 30
     --metrics-out` on 4,000 nodes as a child process (run beside 30b's):
     the listening line and tpusim_slo_* counting. Phases 30-31 fail past
     their 120 s budget;
 32. chaos on the card (bench config 11): (a) config 3 through
     run_simulation(backend="torch", chaos_plan=...) with the host route
     made to raise, behind an armed breaker whose faults lie past its one
     dispatch, verify "probe": phase 4's golden, 196 launches, the breaker
     unmoved, the wall beside phase 4's warm wall; (b) six dispatches of
     uniform_workload(1,000, 100) through TorchBackend(route="kernel") under
     verify "all" and faults exception, corrupt_invalid and corrupt_silent
     with one closed -> open -> half-open -> closed cycle: every answer the
     host's placement hash, the JAX package's breaker trail, kernel
     launches only on the dispatches the breaker let through and no fault
     stopped first, the host answers counted; (c) config 11's stream shape
     (2,000 nodes, 32 cycles of 64 arrivals, 25% evicted, seed 11) under
     faults at dispatches 4 and 12, threshold 1, cooldown 1, verify
     "probe": the fault-free fold chain, the JAX package's restages, paths
     and breaker trail, one graph captured; (d) config 11's serve load (48
     requests on 64 nodes, bucket 4) clean and under a permanent fault
     storm: every future answered, every storm response degraded with the
     clean answer, the JAX package's digest, the scenarios/s ratio;
 33. the stream's durability at config 11's shape: a crash right after
     cycle 24's emit record, recovered, at checkpoint cadences 1, 5 and 20
     (replay ms, the recomputed cycles and the recovery's wall each), a
     pipelined crash after cycle 24's bind record at cadence 5, and the
     `stream` command crashed by --chaos-plan (rc 3) and recovered with
     --recover as child processes: every recovered fold chain the
     uninterrupted golden. Phases 32-33 fail past their 120 s budget;
 34. the chain audit at config 11's stream shape: the journal written on
     the card (checkpoint_every=0), a copy with cycle 16's first bind
     flipped; audit_wal_pair on the card: the identical pair "identical",
     the flipped pair divergent at cycle 16, kind "bind", the one-row bind
     diff, the forensic re-run (explain lanes, top 3) agreeing with "a",
     the report's digest the JAX package's, and the `audit --json` child
     the same report; the bisect's and the replay's walls;
 35. multi-tenant residency: (a) bench config 16's tenancy curve (two
     tenants of 200 nodes after 4 warm cycles of 32, seed 16), each evicted
     and restored, evict and restore ms, every chain intact; (b) four
     tenants of 4,000 nodes under a budget of 2.5 times one twin's bytes,
     each driven in turn for 8 cycles of 64, twice over: the JAX package's
     evictions, restores and chains, no touch over the budget, every
     eviction freeing at least its twin's bytes of memory_allocated, the
     restores' ms p50 and max;
 36. bench config 15 at its accelerator shape (config 11's stream): the
     RTO curve at checkpoint cadences 1, 5 and 20 with the leader killed
     after kill_leader_campaign(seed=11)'s emit record, each promoted onto
     the crash-free golden with a tail-only replay (RTO ms, traced and
     split into the promotion's spans, replayed and total records, graphs
     each side captured); the lag curve at 32, 64
     and 128 arrivals at cadence 5, drained, the follower's chain the
     leader's and the JAX package's, the same graphs on both sides; a
     fleet answering 8 requests from a follower's twin
     (ScenarioFleet.attach_replica) as its staged answers; the CLI pair, a
     `follow --watch-leader` child promoting itself when a `stream
     --replicate-to --listen` child dies by a process-crash plan, onto the
     golden chain at the crash cycle; no fused kernel launch over the
     phase. Phases 34-36 fail past their 120 s budget;
 37. the node-sharded scan route, bench config 14 (bench.py:1848):
     uniform_workload's first 512 pods on its 8,192 nodes through
     TorchBackend(route="scan") with an analytics plane and a recorder, at
     k = 1 (no process group) and at k = 2 and 4 ranks (TPUSIM_SHARDS=k,
     each rank a spawned process on the one card under a gloo group, every
     spawn and group bounded by a timeout): on every rank the JAX
     package's single-device golden and k = 1's placement hash, the
     shard:stage, shard:scan and shard:topk_collective spans, the
     tpusim_shard_* gauges, an analytics sample equal to k = 1's and to
     host_reduce, a gang feed's split equal to k = 1's with its lanes
     sharded, and a ServiceAffinity policy plan counted as a fallback;
     pods/s, the stage and scan spans and the all_reduces a pod at each k
     (no speed claim: the ranks share one card). Phase 37 fails past its
     90 s budget.
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
# on each (tools/port_golden.py config3_host 40 5000, config4_host 300 8,
# config6 3000 150). Config 3's host slice was 200 pods (3457639aca7e71a8)
# until phases 32-33 came, then 100 (1fabcef2c795bc4b: 15.2-18.8 s of host
# wall) until phases 34-36 came, for the script's wall
HOST_CONFIG3 = (dict(num_pods=40, num_nodes=5_000), "28cee1283857cba2")
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
# phase 17c: the preempt_select calls replayed under torch.profiler (all 114
# of them until the warm reruns of phases 5-15 came back, 16 until phase 37
# came)
PROFILED_SELECTS = 8
# phase 18: config 3's first pods on its nodes through the scan route,
# whole and in chunks of TPUSIM_SCAN_CHUNK pods (8,192 pods until phase 37
# came)
CHUNKED_SCAN = (dict(num_pods=4_096, num_nodes=5_000), 2_048)
# phase 19: BASELINE config 5, scenarios of build_workload(pods, nodes,
# seed=1000 + s): at full shape, the first BATCHED_SCENARIOS of them again on
# the batched scan, and at bench.py's CPU shape with the combined digest of
# the JAX package's run_what_if (tools/port_golden.py config5). Config 5 has
# 50 scenarios; 2 run here, at full width: with all 50, phases 18-20 took
# 260-273 s of their 300 s budget on an H100's machine (its host time alone,
# about 3 s a scenario, varies by 10-30% between runs), with 32 the whole
# script took 764 s once phases 21-24 came, and with 16 it took 989.5 s once
# phases 32-33 came, against the 1,000 s it must stay under; 4 when phases
# 34-36 came (8 until then: 15.4 s of 19a's wall and 25.0 s of 19b's, the
# batched scan taking all 8, on an H100's machine), and 2 since the warm
# reruns of phases 5-15 came back (4: 13.5 s of 19a and 16.3 s of 19b)
CONFIG5_SCENARIOS = 50
WHATIF_CONFIG5 = dict(scenarios=2, num_pods=20_000, num_nodes=1_000)
BATCHED_SCENARIOS = 2
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
# curves at the middle size, the cycles of a verified config 9 run. Each
# arm runs 20 cycles (bench.py's 40 until phase 37 came, a cut of depth
# for the script's time)
STREAM_SIZES = (1_000, 4_000, 16_000)
STREAM_CONFIG9 = dict(cycles=20, arrivals=64, evict_fraction=0.25, seed=9)
STREAM_EVICT_CURVE = (0.05, 0.25, 0.5)
STREAM_VERIFY_CYCLES = 10
STREAM_CONFIG10 = dict(cycles=20, arrivals=64, evict_fraction=0.25, seed=9,
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
# phase 25: config 3 with a watch-event log (workloads.event_log_workload),
# the split digest and scheduled count of the JAX package's
# run_simulation(backend="jax", events=) (tools/port_golden.py event_replay
# 100000 5000), and config 6's feed with such a log through the preemption
# hybrid, with the scheduled, failed and preempted counts
# (tools/port_golden.py event_hybrid 20000 1000)
EVENT_REPLAY = (dict(num_pods=100_000, num_nodes=5_000), "d4be11e33a69c71d",
                99_364)
EVENT_HYBRID = (dict(num_pods=20_000, num_nodes=1_000, affinity=True,
                     priorities=True, seed=777), "7c9ada4b349ce599",
                (19_825, 107, 68))
# phase 26: the stream cell traced with the recorder (config 9 at 4,000
# nodes); phase 27: config 16's twin, its requests and their pods
TRACED_STREAM_NODES = 4_000
LIVE_TWIN = dict(nodes=4_000, warm_cycles=4, arrivals=32, requests=32,
                 query_pods=8)
# phases 25-27 together, seconds
OBS_BUDGET_S = 120
# phase 28b: the explain lanes' depth and cells (workload, its arguments, the
# upstream policy it runs under, and the digest of the JAX package's records
# on it: tools/port_golden.py explain NAME)
EXPLAIN_TOP_K = 3
EXPLAIN_CELLS = {
    "config3": ("build_workload", dict(num_pods=8_192, num_nodes=5_000),
                None, "9fc8f134e8e8e601"),
    "policy": ("policy_workload", dict(num_pods=2_048, num_nodes=5_000),
               "1.2", "f1d0b68fc0222ab1"),
}
# phase 29: bench config 12 (bench.py:1712-1745), the config 9 stream at
# 4,000 nodes with the analytics plane off and on: the JAX package's chain
# there, and the digest of its analytics samples (one a cycle) at bench.py's
# CPU shape, STREAM_GOLDENS["config9"] (tools/port_golden.py config12)
CONFIG12 = (dict(num_nodes=4_000, cycles=40, arrivals=64,
                 evict_fraction=0.25, seed=9),
            "1f485925753c53714f8fcf6e28d8a25bc29c743c7374b7901970cb72788e24e7",
            "65a1a49c73446f2c")
# phases 28-29 together, seconds
ANALYTICS_BUDGET_S = 90
# phases 30a-30b: the live cluster a stdlib fake apiserver serves: the
# interpod workload's nodes and Running pods, and LIVE_DECOYS pods in other
# phases that the Running field selector must drop; the bearer token of its
# kubeconfig; the podspec of the main command run against it, and the
# ConfigMap holding upstream's 1.2 policy; the digest of the JAX package's
# reports on them (tools/port_golden.py live_cli)
LIVE_DECOYS = 500
LIVE_TOKEN = "chip-smoke-token"
LIVE_PODSPEC = [
    {"name": "web", "num": 300, "pod": {
        "metadata": {"labels": {"app": "a0"}},
        "spec": {"containers": [{"resources": {"requests": {
            "cpu": "500m", "memory": "1Gi"}}}]}}},
    {"name": "batch", "num": 400, "pod": {"spec": {"containers": [
        {"resources": {"requests": {"cpu": "2", "memory": "4Gi"}}}]}}},
    {"name": "store", "num": 300, "pod": {
        "metadata": {"labels": {"app": "a4"}},
        "spec": {"containers": [{"resources": {"requests": {
            "cpu": "1", "memory": "2Gi"}}}]}}},
]
LIVE_POLICY = ("kube-system", "scheduler-policy", "1.2")
# the report digests: under that ConfigMap's policy (whose TestLabelsPresence
# wants a node label "foo" that no node of the workload carries, so every
# pod fails), and under the default provider, which places them
LIVE_CLI = {"policy": "6db5fc9c967a56df", "provider": "afb6fee58c0716a3"}
# phase 30c: config 9 fed only by the watch fabric (watch_stream), at 4,000
# nodes and at bench.py's CPU shape, with the placement and fold chains of
# the JAX package's driver (tools/port_golden.py config9_watch)
WATCH_STREAM = {
    "card": (dict(num_nodes=4_000, cycles=40, arrivals=64,
                  evict_fraction=0.25, seed=9, tear_at=20),
        "e3e2a4d0ec2c469b68c51daed61096da4d95b44be1b5d863714cef5edb9dcb6a",
        "6c950f0806a6caecc5164e9c79faabd00fc8ed0542a201ba4af17220ffdd7d30"),
    "cpu": (dict(num_nodes=800, cycles=24, arrivals=64, evict_fraction=0.25,
                 seed=9, tear_at=12),
        "8bb3dbd94daae25bca01b645b9dbca5d4561941e0a6c779719a89fe7eb99ac96",
        "cc28fe9e098d39790ef62930f03d7ea86d473e309cac94a6c447ca42aa380a0f"),
}
# phase 31: the telemetry plane's paths (the last one unknown: 404), the
# scraper's period, and the requests of phase 27's twin behind a fleet
TELEMETRY_PATHS = ("/metrics", "/healthz", "/debug/provenance",
                   "/debug/trace", "/analytics", "/no-such-path")
SCRAPE_PERIOD_S = 0.05
TRACED_REQUESTS = 8
# phase 31b: the judged runs at most. The card's steady cycle time drifts
# between back-to-back runs by about as much as one run's spread, so a
# target taken from one run can sit below or above every cycle of the next
SLO_RUNS = 3
# phases 30-31 together, seconds
LIVE_BUDGET_S = 120
# phase 14: the pods of config 3 run through both routes
# phases 32-33 (bench config 11, bench.py:1558): chaos on the card and the
# stream's durability. 32a: config 3 behind an armed breaker whose faults
# lie past its one dispatch (verify "probe": no host answer at full width);
# 32b: a scripted dispatch sequence on uniform_workload(1,000, 100) with
# verify "all" (exception, corrupt_invalid, an open -> half-open -> close
# cycle, corrupt_silent), JAX golden: the host's placement hash and the
# breaker's trail; 32c: config 11's stream shape under device faults, JAX
# goldens: the fault-free fold chain, the restages and the breaker's trail;
# 32d: config 11's serve storm, JAX golden: the clean answers' digest;
# 33: the recovery curve (crash at cycle 24 after its emit record), a
# pipelined crash after a bind record, and the CLI. Recorded by
# `tools/port_golden.py config11` (~2 min on a CPU)
CHAOS_FULL = dict(faults={1: "exception", 2: "corrupt_invalid"},
                  failure_threshold=1, cooldown=1, verify="probe")
CHAOS_SCRIPT = (dict(num_pods=1_000, num_nodes=100),
                dict(faults={0: "exception", 1: "corrupt_invalid",
                             3: "corrupt_silent"},
                     failure_threshold=2, cooldown=1, verify="all"), 6)
CONFIG11_STREAM = dict(num_nodes=2_000, cycles=32, arrivals=64,
                       evict_fraction=0.25, seed=11)
CONFIG11_FAULTS = dict(faults={4: "exception", 12: "corrupt_invalid"},
                       failure_threshold=1, cooldown=1, verify="probe")
CONFIG11_SERVE = dict(num_nodes=64, requests=48, bucket=4)
CONFIG11_CRASH = dict(at=24, point="emit", cadences=(1, 5, 20),
                      pipelined=("bind", 5))
CONFIG11_GOLDEN = {
    "script": {
        "hash": "b595bf5922feb68c1ce4566491b5986651f3074b2eae6716853d3bcccf450eed",
        "transitions": [
            ["open", "DeviceOutputError: device choice out of range "
                     "[-1, 100)"],
            ["half_open", "after 1 denied"], ["close", "probe passed"]]},
    "stream": {
        "fold_chain": "d95d54674bf369b859cec24a5a4838f9b0ed67133b8c9684948ac7c2aaf0f1b7",
        "paths": {"host": 4, "restage_scan": 3, "stream_scan": 25},
        "restages": {"breaker_open": 2, "cold_start": 3, "device_fault": 2},
        "transitions": [
            ["open", "InjectedDeviceError: chaos: injected device fault at "
                     "dispatch 4"],
            ["half_open", "after 1 denied"], ["close", "probe passed"],
            ["open", "DeviceOutputError: device choice out of range "
                     "[-1, 2000)"],
            ["half_open", "after 1 denied"], ["close", "probe passed"]]},
    "serve_digest": "3946c6e2f3b996ed",
}
# phases 32-33 together, seconds
CHAOS_BUDGET_S = 120
# phases 34-36: the audit at config 11's stream shape with cycle
# AUDIT_FLIP_CYCLE's first bind flipped in a copy of the journal; bench
# config 16's tenancy curve at its accelerator shape (bench.py:2130-2160)
# and a pressure arm of TENANCY_PRESSURE tenants at config 9's width under
# a budget of budget_twins twins, driven in turn, `rounds` times; bench
# config 15 (bench.py:1925-2033) at its accelerator shape (config 11's
# stream): the RTO curve by checkpoint cadence with the leader killed at
# kill_leader_campaign(seed=11)'s emit point, the lag curve by arrivals at
# cadence 5, the CLI pair and REPLICA_REQUESTS fleet requests answered by
# a follower's twin. Goldens recorded by `tools/port_golden.py config15`
AUDIT_FLIP_CYCLE = 16
TENANCY_CURVE = dict(nodes=200, warm_cycles=4, arrivals=32, seed=16)
TENANCY_PRESSURE = dict(tenants=4, nodes=4_000, cycles=8, arrivals=64,
                        rounds=2, budget_twins=2.5, seed=9)
CONFIG15 = dict(cadences=(1, 5, 20), lag_arrivals=(32, 64, 128),
                lag_cadence=5, seed=11)
REPLICA_REQUESTS = 8
CONFIG15_GOLDEN = {
    "audit": "2582af373b81cc9b",
    "tenancy": {
        "evictions": [[t, "pressure"]
                      for t in ("t0", "t1", "t2", "t3", "t0", "t1")],
        "restores": ["t0", "t1", "t2", "t3"],
        "chains": {
            "t0": "ba084f6e14041da60d9ce7189e0d926ec30e4d5279c27e33e44d6a673f5d8456",
            "t1": "96ddc85516136ee5edea89d6cd2fea93520f9d56be25fa15ef963984c2644ef0",
            "t2": "eca6af4850a57233a3c7f9f0f5d83837733901f4ad6a6d45e66ca5a2a9a8dd20",
            "t3": "fd7731b90541e337c89abd1f147146d13217e00650bb8ecea1e778c7f194554c"}},
    "replication": {
        "cli_head": "96f9ab4950370746c2e74703b5fdc084b9e8d347172cae92a4a3662b63f4516f",
        "rto": {"1": "d95d54674bf369b859cec24a5a4838f9b0ed67133b8c9684948ac7c2aaf0f1b7",
                "5": "d95d54674bf369b859cec24a5a4838f9b0ed67133b8c9684948ac7c2aaf0f1b7",
                "20": "d95d54674bf369b859cec24a5a4838f9b0ed67133b8c9684948ac7c2aaf0f1b7"},
        "lag": {"32": "28ab48e115cb3f9598f0d122dd283c3b22dac406e0752cfb80bdeb8108e87e6d",
                "64": "d95d54674bf369b859cec24a5a4838f9b0ed67133b8c9684948ac7c2aaf0f1b7",
                "128": "41ea5fcb3de36521cc169551c0f0bdbade59b4305bd7c27472bfe6fdd00204bb"}},
}
# phases 34-36 together, seconds
REPLICATION_BUDGET_S = 120
# phase 37: bench config 14 (bench.py:1848, measure_shard_scaling): the
# node-sharded scan route on uniform_workload at its 8,192 nodes, route
# "scan", at k = 1 (no process group) and at k = 2 and 4 ranks, each a
# process on the one card under a gloo group. Config 14 feeds 32,768 pods;
# the sharded step runs eagerly (gloo's collectives are not captured in
# CUDA graphs), minutes a shard count at that depth, so the phase runs the
# first SHARD_CONFIG14's pods. The golden is the JAX package's
# single-device route on them (tools/port_golden.py config14 512 8192). The
# gang feed: that prefix's first 24 pods and a gang of 8 on the same nodes
SHARD_CONFIG14 = dict(num_pods=512, num_nodes=8_192)
SHARD_GOLDEN = ("9a91f80d92d326c2", 512)
SHARD_COUNTS = (2, 4)
SHARD_ANALYTICS_TOP_K = 8
SHARD_GANG = dict(solo=24, members=8, milli_cpu=3_000)
# a spawn of k ranks, seconds (every rank and its gloo group bounded by it)
SHARD_TIMEOUT_S = 240
SHARD_BUDGET_S = 90

ROUTES_PODS = 2_048
# phase 15: the pods of the scan timed eagerly, and from its graphs (200 and
# 2,000 since phase 37 came; 400 and 4,000 since phases 34-36 came; 2,000
# and all 20,000 until then, 11.5 s and 13.4 s of wall on an H100's
# machine)
SCAN_EAGER_PODS = 200
SCAN_GRAPH_PODS = 2_000
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


def records_digest(records):
    """sha256 of provenance records or analytics samples without their
    time stamps (JSON with sorted keys, one a line), first 16 hex digits."""
    return hashlib.sha256("\n".join(
        json.dumps({k: v for k, v in r.items() if k != "ts"},
                   sort_keys=True) for r in records).encode()).hexdigest()[:16]


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


class FakeApiServer:
    """A kube-apiserver stand-in on the standard library, bound to
    127.0.0.1 on a port the OS picks and served from a thread of this
    process: GET /api/v1/nodes, /api/v1/pods and /api/v1/namespaces/NS/pods
    (the fieldSelector status.phase=Running honoured) and
    /api/v1/namespaces/NS/configmaps/NAME, as JSON bodies serialized once.
    A request without the bearer token gets 401, an unknown path 404. It
    counts the requests and the body bytes it served."""

    def __init__(self, nodes, pods, configmaps, token):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        import threading
        from urllib.parse import parse_qsl, urlparse

        self.requests = 0
        self.bytes = 0
        count_lock = threading.Lock()  # handlers run on threads of their own
        outer = self
        pod_objs = [p.to_obj() for p in pods]

        def pod_list(items):
            return json.dumps({"kind": "PodList", "apiVersion": "v1",
                               "items": items}).encode()

        running = [o for o in pod_objs
                   if o.get("status", {}).get("phase") == "Running"]
        bodies = {
            ("/api/v1/nodes", ""): json.dumps({
                "kind": "NodeList", "apiVersion": "v1",
                "items": [n.to_obj() for n in nodes]}).encode(),
            ("/api/v1/pods", ""): pod_list(pod_objs),
            ("/api/v1/pods", "status.phase=Running"): pod_list(running),
        }
        for (ns, name), obj in configmaps.items():
            bodies[(f"/api/v1/namespaces/{ns}/configmaps/{name}", "")] = \
                json.dumps(obj).encode()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                parsed = urlparse(self.path)
                selector = dict(parse_qsl(parsed.query)).get(
                    "fieldSelector", "")
                with count_lock:
                    outer.requests += 1
                if self.headers.get("Authorization") != f"Bearer {token}":
                    self.send_error(401)
                    return
                body = bodies.get((parsed.path, selector))
                parts = parsed.path.split("/")
                if body is None and len(parts) == 6 and parts[5] == "pods":
                    ns = parts[4]
                    body = pod_list([
                        o for o in (running if selector else pod_objs)
                        if o["metadata"].get("namespace") == ns])
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                with count_lock:
                    outer.bytes += len(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self):
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def live_cluster(api, num_pods=100_000, num_nodes=5_000):
    """The live cluster of phases 30a-30b, with either package's
    api.snapshot: (nodes, pods the apiserver serves, pods to schedule). The
    served pods are the interpod workload's Running pods with LIVE_DECOYS
    Pending, Succeeded and Failed pods among them, which a snapshot must
    not take."""
    from tpusim_torch import workloads

    snapshot, pods = workloads.interpod_workload(num_pods, num_nodes,
                                                 api=api)
    rng = np.random.RandomState(30)
    served = list(snapshot.pods)
    for i in range(LIVE_DECOYS):
        decoy = api.make_pod(
            f"decoy-{i}", milli_cpu=int(rng.randint(100, 4000)),
            memory=int(rng.randint(2 ** 20, 2 ** 32)),
            node_name=f"node-{int(rng.randint(num_nodes))}",
            phase=("Pending", "Succeeded", "Failed")[i % 3])
        served.insert(int(rng.randint(len(served) + 1)), decoy)
    return snapshot.nodes, served, pods


def live_configmaps():
    """The apiserver's ConfigMaps: LIVE_POLICY's, holding an upstream
    policy under policy.cfg, and one without that key."""
    from tpusim_torch import workloads

    ns, name, version = LIVE_POLICY

    def configmap(cm_name, data):
        return {"kind": "ConfigMap", "apiVersion": "v1",
                "metadata": {"name": cm_name, "namespace": ns},
                "data": data}

    return {(ns, name): configmap(name, {"policy.cfg": json.dumps(
                workloads.COMPAT_POLICIES[version])}),
            (ns, "no-key"): configmap("no-key", {"other": "x"})}


def write_live_files(directory, server_url):
    """A JSON kubeconfig with LIVE_TOKEN for `server_url`, and
    LIVE_PODSPEC as JSON (PyYAML may be missing): their paths."""
    kubeconfig = os.path.join(directory, "kubeconfig.json")
    with open(kubeconfig, "w") as f:
        json.dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "sim",
            "contexts": [{"name": "sim",
                          "context": {"cluster": "live", "user": "smoke"}}],
            "clusters": [{"name": "live",
                          "cluster": {"server": server_url}}],
            "users": [{"name": "smoke", "user": {"token": LIVE_TOKEN}}]}, f)
    podspec = os.path.join(directory, "pods.json")
    with open(podspec, "w") as f:
        json.dump(LIVE_PODSPEC, f)
    return kubeconfig, podspec


def report_digest(text):
    """sha256 of the main command's report with the summary line's bracket
    (the engine and the timing) dropped, first 16 hex digits."""
    import re

    lines = [re.sub(r" \[[^\]]*\]$", "", line)
             for line in text.splitlines()]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def port_watch_modules():
    """The port's modules the watch-fed stream driver reads (watch_stream's
    `mods`)."""
    import types

    import tpusim_torch.api.snapshot as api
    import tpusim_torch.api.types as api_types
    import tpusim_torch.backends as backends
    import tpusim_torch.framework.events as events
    import tpusim_torch.framework.restclient as restclient
    import tpusim_torch.framework.store as store
    import tpusim_torch.stream as stream

    return types.SimpleNamespace(api=api, types=api_types, store=store,
                                 events=events, restclient=restclient,
                                 stream=stream, backends=backends)


def watch_stream(mods, num_nodes, cycles, arrivals, evict_fraction, seed,
                 tear_at=None, **session_kw):
    """Config 9's churn fed to a StreamSession only through the watch
    fabric, with either package (`mods`: its api.snapshot, api.types,
    framework store, events and restclient modules, its stream package and
    its backends; port_watch_modules). The cluster lives in a ResourceStore;
    the session starts empty and attaches a node and a pod Reflector to a
    FakeRESTClient over it, so the node watch's replay builds its picture.
    Each cycle the loadgen's events go into the store, session.sync() drains
    the reflectors, the batch schedules, and its binds go back into the
    store as a scheduler's binds reach the apiserver (their echo arrives
    with the next cycle's events). At cycle `tear_at` the node watch is
    swapped for a two-slot buffer and an empty node's cordon flaps three
    times, so the stream overflows (the 410 Gone analog), the next sync
    relists, and the node stays cordoned.
    Returns the chains, the counts and each cycle's latency."""
    import hashlib

    rt = mods.types.ResourceType
    store_mod = mods.store
    snapshot = mods.api.synthetic_cluster(num_nodes)
    store = store_mod.ResourceStore()
    for node in snapshot.nodes:
        store.add(rt.NODES, node)
    client = mods.restclient.FakeRESTClient(store)
    session = mods.stream.StreamSession(**session_kw)
    nodes_r = session.watch(client, rt.NODES)
    session.watch(client, rt.PODS)
    gen = mods.stream.ChurnLoadGen(snapshot, seed=seed, arrivals=arrivals,
                                   evict_fraction=evict_fraction)
    write = {store_mod.ADDED: store.add, store_mod.MODIFIED: store.update,
             store_mod.DELETED: store.delete}
    chain, fold = hashlib.sha256(), ""
    latencies, decisions, scheduled = [], 0, 0
    for cycle in range(cycles):
        if cycle == tear_at:
            key = (rt.NODES.value, "", "")
            selector, _ = client._watchers[key]
            small = mods.events.WatchBuffer(maxsize=2,
                                            resource=rt.NODES.value)
            client._watchers[key] = (selector, small)
            nodes_r._buf = small
            # the first node no pod is bound to: it scores highest, so
            # its cordon moves the later picks
            occupied = {p.spec.node_name for p in store.list(rt.PODS)}
            name = next(n.name for n in snapshot.nodes
                        if n.name not in occupied)
            for unschedulable in (True, False, True):
                node, _ = store.get(rt.NODES, name)
                node = node.copy()
                node.spec.unschedulable = unschedulable
                store.update(rt.NODES, node)
        for event_type, obj in gen.events(cycle):
            write[event_type](rt.NODES if obj.kind == "Node" else rt.PODS,
                              obj)
        t0 = time.perf_counter()
        session.sync()
        placements = session.schedule(gen.batch())
        latencies.append(time.perf_counter() - t0)
        for pl in placements:
            if pl.node_name:
                store.add(rt.PODS, pl.pod)
        gen.note_bound(placements)
        h = mods.backends.placement_hash(placements)
        chain.update(h.encode())
        fold = mods.stream.chain_fold(fold, h)
        decisions += len(placements)
        scheduled += sum(1 for pl in placements if pl.node_name)
    client.close()
    return {"placement_chain": chain.hexdigest(), "fold_chain": fold,
            "decisions": decisions, "scheduled": scheduled,
            "relists": nodes_r.relists,
            "restages": dict(session.restage_counts),
            "paths": dict(session.path_counts), "latencies": latencies,
            "nodes": len(session.inc.nodes)}


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


# the warm wall of each main-path workload's second run (phase 26 prints
# config 3's beside its traced run)
WARM_WALL = {}
# config 3's snapshot and pods from phase 4, driven again by phase 32a
BUILT = {}


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
    if name == "config3":
        BUILT[name] = snapshot, pods
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
    WARM_WALL[name] = warm_s
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

    # 5 kernel runs and one of the plain version (20 and 2 until phase 37
    # came: each run stages the plan afresh, and the kernel's device time
    # stays within 1.5% between runs)
    ms, got = chunk_run(fastscan_chunk, plan, cuda, repeats=5)
    geom = fastscan_chunk.last_geometry
    plain_ms, want = chunk_run(fastscan_chunk_plain, plan, cuda, repeats=1)
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
        # 3 runs a size (5 until phase 37 came)
        times[cluster], _ = chunk_run(fastscan_chunk, plan, cuda, 3, cluster)
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
    # GRAPH_STEPS steps replayed as CUDA graphs) on the first
    # SCAN_GRAPH_PODS
    config, compiled, cols, ptabs = compile_inputs(snapshot, pods)
    carry, statics, xs = scan_inputs(config, compiled, cols, ptabs, cuda)
    for graph_steps, count in ((0, SCAN_EAGER_PODS),
                               (GRAPH_STEPS, SCAN_GRAPH_PODS)):
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
    # the first of those calls replayed under torch.profiler: the card's
    # busy time, without the host's launch gaps the CUDA-event spans of (b)
    # include
    profiled = selects[:PROFILED_SELECTS]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args, _, _, _ in profiled:
            real_select(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(profiled_device_us(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if busy_us > 0:
        print(f"phase 17c: preempt_select replayed under torch.profiler: "
              f"{busy_us / len(profiled):.1f} us of device busy time and "
              f"{n_kernels / len(profiled):.0f} kernels a call, over the "
              f"first {len(profiled)} of the {len(selects)} calls on {card}")
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


# phase 21's config 9 stream arm at 4,000 nodes: its cycle p50 and its
# resident scan's span p50, which phase 30c prints beside its own
PHASE21 = {}


def drive_stream_churn(card):
    """Phase 21: bench config 9, stream churn: the eviction curve at the
    middle size, the stream and restage arms at every size (equal chains),
    a verified run and the CPU shape."""
    big_mid = STREAM_SIZES[1]
    stream = {}
    for frac in STREAM_EVICT_CURVE:
        out, spans, launches = run_stream(
            dict(STREAM_CONFIG9, num_nodes=big_mid, evict_fraction=frac),
            f"config9 stream arm, evict {frac}", 21, card)
        if out["restages"] != {"cold_start": 1} or launches:
            raise AssertionError("phase 21: the stream arm restaged past its "
                                 "cold start or launched the fused kernel")
        if frac == STREAM_CONFIG9["evict_fraction"]:
            stream[big_mid] = out
            PHASE21["config9"] = {"p50": out["p50_cycle_ms"],
                                  "span": percentile(spans, 0.5)}
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


def span_totals(doc):
    """{span name: [count, wall ms, CUDA-event ms]} over a Chrome trace's
    complete events (the CUDA-event time where the span carries one)."""
    out = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        t = out.setdefault(ev["name"], [0, 0.0, 0.0])
        t[0] += 1
        t[1] += ev["dur"] / 1e3
        t[2] += (ev.get("args") or {}).get("device_us", 0.0) / 1e3
    return out


def traced(fn):
    """Run fn() with a flight recorder installed: (its value, the trace
    exported as Chrome JSON and read back)."""
    from tpusim_torch.obs import recorder as flight

    rec = flight.install(flight.FlightRecorder())
    try:
        value = fn()
    finally:
        flight.uninstall()
    return value, json.loads(rec.to_chrome_json())


def counts_line(text):
    """(scheduled, unschedulable) from the CLI's summary line."""
    import re

    m = re.search(r"(\d+) pod\(s\) scheduled, (\d+) unschedulable", text)
    return int(m.group(1)), int(m.group(2))


def drive_event_replay(card):
    """Phase 25: event-log replay at full width, the hybrid with a log, and
    the CLI's --event-log."""
    import io
    import tempfile

    from tpusim_torch import cli, delta, workloads
    from tpusim_torch.api.podspec import (
        expand_simulation_pods,
        load_simulation_pods,
    )
    from tpusim_torch.api.snapshot import ClusterSnapshot, make_pod
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.framework.events import WatchEvent, load_event_log
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.simulator import run_simulation

    params, golden, want_scheduled = EVENT_REPLAY
    want_launches = -(-params["num_pods"] // CHUNK)
    t0 = time.perf_counter()
    snapshot, pods, events = workloads.event_log_workload(**params)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "events.jsonl")
        t0 = time.perf_counter()
        with open(path, "w") as f:
            f.writelines(WatchEvent(t, o).to_frame() + "\n"
                         for t, o in events)
        loaded = load_event_log(path)
        log_s = time.perf_counter() - t0
    if [(t, o.to_obj()) for t, o in loaded] != \
            [(t, o.to_obj()) for t, o in events]:
        raise AssertionError("phase 25: the event log did not read back "
                             "as written")
    reset_launches()
    with device_routes_only():
        t0 = time.perf_counter()
        status, doc = traced(lambda: run_simulation(
            pods, snapshot, backend="torch", events=loaded))
        wall = time.perf_counter() - t0
    launches = fastscan_chunk.launches_by_variant["group_free"]
    all_launches = fastscan_chunk.launches
    digest = split_digest(status)
    spans = span_totals(doc)
    inc = delta.IncrementalCluster(snapshot)
    inc.apply_events(loaded)
    folded = inc.to_snapshot()
    with device_routes_only():
        fresh = run_simulation(pods, ClusterSnapshot(
            nodes=folded.nodes, pods=folded.pods, services=folded.services,
            pvs=folded.pvs, pvcs=folded.pvcs), backend="torch")
    same = split_digest(fresh) == digest
    scheduled = len(status.successful_pods)
    fold_ms, compile_ms = (spans["event_fold"][1],
                           spans["compile_cluster"][1])
    sched = spans["backend_schedule"]
    print(f"phase 25: event replay, config 3 ({params['num_pods']} pods, "
          f"{params['num_nodes']} nodes) + {len(events)} events "
          f"({len(folded.nodes)} nodes and {len(folded.pods)} placed pods "
          f"after the fold): digest {digest} (want {golden}), {scheduled} "
          f"scheduled (want {want_scheduled}); equal to the run on the "
          f"folded snapshot: {same}; {launches} fused launches (group_free "
          f"variant, want {want_launches}); workload build {build_s:.2f}s, log write and "
          f"read {log_s:.2f}s; wall {wall:.3f}s = event_fold "
          f"{fold_ms:.1f} ms + compile_cluster {compile_ms:.1f} ms + "
          f"backend_schedule {sched[1]:.1f} ms (device_dispatch "
          f"{spans['device_dispatch'][1]:.1f} ms wall, "
          f"{spans['device_dispatch'][2]:.1f} ms CUDA events; "
          f"decode_placements {spans['decode_placements'][1]:.1f} ms) on "
          f"{card}")
    if (digest, scheduled) != (golden, want_scheduled) or not same:
        raise AssertionError("phase 25: the replay differs from the JAX "
                             "package's or from the folded-snapshot run")
    if launches != want_launches or all_launches != want_launches:
        raise AssertionError(f"phase 25: {launches} group_free launches of "
                             f"{all_launches}, want {want_launches}")

    # (b) the preemption hybrid fed by the replay's IncrementalCluster
    params, golden, want_counts = EVENT_HYBRID
    snapshot, pods, events = workloads.event_log_workload(**params)
    reset_launches()
    with device_routes_only():
        t0 = time.perf_counter()
        status = run_simulation(pods, snapshot, backend="torch",
                                events=events, enable_pod_priority=True)
        wall = time.perf_counter() - t0
    counts = (len(status.successful_pods), len(status.failed_pods),
              len(status.preempted_pods))
    digest = split_digest(status)
    print(f"phase 25b: event replay into the preemption hybrid, config 6 "
          f"({params['num_pods']} pods, {params['num_nodes']} nodes) + "
          f"{len(events)} events: digest {digest} (want {golden}), "
          f"scheduled/failed/preempted {counts} (want {want_counts}), "
          f"{fastscan_chunk.launches} fused launches, {wall:.3f}s wall on "
          f"{card}")
    if (digest, counts) != (golden, want_counts) \
            or fastscan_chunk.launches <= 0:
        raise AssertionError("phase 25b: the hybrid's replay differs from "
                             "the JAX package's or launched no kernel")

    # (c) the CLI's --event-log, against run_simulation on the same input
    snapshot, _, events = workloads.event_log_workload(2_000, 200)
    with tempfile.TemporaryDirectory() as tmp:
        snap_path = os.path.join(tmp, "snapshot.json")
        log_path = os.path.join(tmp, "events.jsonl")
        spec_path = os.path.join(tmp, "pods.json")
        snapshot.save(snap_path)
        with open(log_path, "w") as f:
            f.writelines(WatchEvent(t, o).to_frame() + "\n"
                         for t, o in events)
        with open(spec_path, "w") as f:
            json.dump([{"name": "w", "num": 1_200, "pod": make_pod(
                "w", milli_cpu=1_500, memory=2 * 1024 ** 3).to_obj()}], f)
        out = io.StringIO()
        with device_routes_only(), contextlib.redirect_stdout(out):
            rc = cli.main(["--podspec", spec_path, "--snapshot", snap_path,
                           "--event-log", log_path, "--quiet"])
        cli_pods = expand_simulation_pods(load_simulation_pods(spec_path))
    with device_routes_only():
        want = run_simulation(cli_pods, snapshot, events=events)
    got = counts_line(out.getvalue())
    want = (len(want.successful_pods), len(want.failed_pods))
    print(f"phase 25c: the CLI's --event-log ({len(events)} events on 200 "
          f"nodes, 1,200 pods): rc {rc}, scheduled/unschedulable {got}, "
          f"run_simulation {want}")
    if rc != 0 or got != want:
        raise AssertionError("phase 25c: the CLI's --event-log run differs "
                             "from run_simulation's")


def drive_recorder(card):
    """Phase 26: the recorder's per-layer split of the main path and of a
    stream cycle, and the registry's families through --metrics-out."""
    import io
    import tempfile

    from tpusim_torch import cli, workloads
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.simulator import run_simulation, run_stream_simulation

    _, params, golden, want_scheduled = GOLDENS["config3"]
    snapshot, pods = workloads.build_workload(**params)
    feed = list(reversed(pods))  # run_simulation feeds LIFO: pods in order
    with device_routes_only():
        t0 = time.perf_counter()
        status, doc = traced(lambda: run_simulation(
            feed, snapshot, backend="torch", route="kernel"))
        wall = time.perf_counter() - t0
    index = {n.name: i for i, n in enumerate(snapshot.nodes)}
    placed = {p.name: index[p.spec.node_name] for p in status.successful_pods}
    got = choices_golden([placed.get(p.name, -1) for p in pods])
    layers = span_totals(doc)
    sched = layers["backend_schedule"][1]
    comp, disp, dec = (layers[k] for k in ("compile_cluster",
                                           "device_dispatch",
                                           "decode_placements"))
    rest = sched - comp[1] - disp[1] - dec[1]
    print(f"phase 26: config 3 traced ({params['num_pods']} pods, "
          f"{params['num_nodes']} nodes, warm): golden {got} (want "
          f"{golden}), {len(status.successful_pods)} scheduled; "
          f"{wall:.3f}s wall traced against phase 4's {WARM_WALL['config3']:.3f}"
          f"s untraced; backend_schedule {sched:.1f} ms = compile_cluster "
          f"{comp[1]:.1f} ms ({100 * comp[1] / sched:.1f}%) + "
          f"device_dispatch {disp[1]:.1f} ms ({100 * disp[1] / sched:.1f}%; "
          f"{disp[2]:.1f} ms CUDA events) + decode_placements {dec[1]:.1f} "
          f"ms ({100 * dec[1] / sched:.1f}%) + plan and input finishing "
          f"{rest:.1f} ms ({100 * rest / sched:.1f}%); "
          f"{len(doc['traceEvents'])} trace events on {card}")
    if (got, len(status.successful_pods)) != (golden, want_scheduled):
        raise AssertionError("phase 26: the traced run placed differently")
    if not 0 < disp[2] <= disp[1]:
        raise AssertionError("phase 26: device_dispatch's CUDA-event time "
                             f"{disp[2]:.3f} ms is not inside its wall")

    out, doc = traced(lambda: run_stream_simulation(
        device="cuda", num_nodes=TRACED_STREAM_NODES, **STREAM_CONFIG9))
    t = span_totals(doc)
    cycles = out["cycles"]

    def per_cycle(name, i=1):
        return t.get(name, [0, 0.0, 0.0])[i] / cycles

    print(f"phase 26: config 9 stream traced ({TRACED_STREAM_NODES} nodes, "
          f"{cycles} cycles, paths {out['paths']}): a cycle's mean "
          f"{1000 * out['elapsed_s'] / cycles:.2f} ms wall = stream_commit "
          f"{per_cycle('stream_commit'):.3f} ms ("
          f"{per_cycle('stream_commit', 2):.3f} ms CUDA events) + "
          f"device_dispatch {per_cycle('device_dispatch'):.3f} ms ("
          f"{per_cycle('device_dispatch', 2):.3f} ms CUDA events) + decode "
          f"{per_cycle('decode_placements') + per_cycle('stream_decode'):.3f}"
          f" ms + compile_cluster {per_cycle('compile_cluster'):.3f} ms "
          f"(restages) + the rest; chain {out['placement_chain'][:16]} on "
          f"{card}")

    register().reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.prom")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["stream", "--synthetic-nodes", "400", "--cycles",
                           "6", "--arrivals", "32", "--metrics-out", path])
        with open(path) as f:
            text = f.read()
    counted = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        for family in ("scheduler_", "tpusim_backend_", "tpusim_stream_"):
            if name.startswith(family) and float(value) > 0:
                counted.setdefault(family, set()).add(name.split("{")[0])
    print(f"phase 26: the stream CLI's --metrics-out (rc {rc}): counting "
          + "; ".join(f"{k}* {len(v)} series" for k, v in
                      sorted(counted.items())))
    if rc != 0 or set(counted) != {"scheduler_", "tpusim_backend_",
                                   "tpusim_stream_"}:
        raise AssertionError("phase 26: --metrics-out lacks a counting "
                             "scheduler_*, tpusim_backend_* or "
                             "tpusim_stream_* family")


def drive_live_twin(card):
    """Phase 27: serve's live twins, a config 16 twin answering a fleet's
    requests by overlays."""
    import io
    import tempfile

    import torch

    from tpusim_torch import cli, workloads
    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
    from tpusim_torch.stream import ChurnLoadGen, StreamSession
    from tpusim_torch.whatif import run_what_if

    p = LIVE_TWIN
    n = p["nodes"]
    t0 = time.perf_counter()
    session = StreamSession(synthetic_cluster(n))
    gen = ChurnLoadGen(synthetic_cluster(n), seed=16, arrivals=p["arrivals"],
                       evict_fraction=0.25)
    for c in range(p["warm_cycles"]):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
    warm_s = time.perf_counter() - t0
    fleet = ScenarioFleet(bucket_size=8, flush_after_s=60.0)
    fleet.attach_stream(session, ref="live")
    rng = np.random.RandomState(27)
    queries = [[make_pod(f"twin-q{r}-{i}",
                         milli_cpu=int(rng.randint(100, 1500)),
                         memory=int(rng.randint(2 ** 20, 2 ** 30)))
                for i in range(p["query_pods"])]
               for r in range(p["requests"])]
    register().reset()
    before = [t.clone() for t in session.device.carry]
    times, answers = [], []
    for q in queries:
        t0 = time.perf_counter()
        fut = fleet.submit(WhatIfRequest(pods=q, snapshot_ref="live"))
        fleet.drain()
        resp = fut.result()
        times.append(1000 * (time.perf_counter() - t0))
        if not resp.ok:
            raise AssertionError(f"phase 27: a request failed: {resp.error}")
        answers.append(placement_hash(resp.result.placements))
    stats = dict(fleet.executor.stats)
    same = all(torch.equal(a, b) for a, b in zip(before,
                                                 session.device.carry))
    live = session.inc.to_snapshot()
    t0 = time.perf_counter()
    staged = run_what_if([(live, q) for q in queries])
    staged_s = time.perf_counter() - t0
    parity = answers == [placement_hash(r.placements) for r in staged]
    policy = decode_policy(workloads.COMPAT_POLICIES["1.2"])
    fut = fleet.submit(WhatIfRequest(pods=queries[0], snapshot_ref="live",
                                     policy=policy))
    fleet.drain()
    resp = fut.result()
    [want] = run_what_if([(live, queries[0])], policy=policy)
    mismatch = register().overlay_fallback.get("plan_mismatch")
    policy_ok = (resp.ok and placement_hash(resp.result.placements)
                 == placement_hash(want.placements))
    warm_ms = times[1:]
    print(f"phase 27: config 16 live twin of {n} nodes ({p['warm_cycles']} "
          f"churn cycles, {warm_s:.1f}s) behind a ScenarioFleet: "
          f"{stats['overlay_hits']}/{len(queries)} requests of "
          f"{p['query_pods']} pods answered by overlays, "
          f"{stats['overlay_fallbacks']} fallbacks; submit to answer "
          f"{times[0]:.3f} ms the first, then mean "
          f"{sum(warm_ms) / len(warm_ms):.3f} / p50 "
          f"{percentile(warm_ms, 0.5):.3f} / max {max(warm_ms):.3f} ms a "
          f"query; answers equal staged run_what_if on the live snapshot: "
          f"{parity} ({staged_s:.2f}s for the {len(queries)} staged); carry "
          f"bit-equal after them: {same}; a request under policy 1.2: "
          f"staged, equal to run_what_if {policy_ok}, "
          f"tpusim_overlay_fallback_total{{reason=\"plan_mismatch\"}} "
          f"{mismatch:g} on {card}")
    if (stats["overlay_hits"], stats["overlay_fallbacks"]) != \
            (len(queries), 0) or not (parity and same and policy_ok) \
            or mismatch != 1:
        raise AssertionError("phase 27: the live twin's overlays missed, "
                             "differed from run_what_if, changed the carry "
                             "or miscounted the plan mismatch")

    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "pods.json")
        with open(spec, "w") as f:
            json.dump([{"name": "q", "num": 8, "pod": make_pod(
                "q", milli_cpu=250, memory=256 * 2 ** 20).to_obj()}], f)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["serve", "--synthetic-nodes", "200", "--podspec",
                           spec, "--requests", "16", "--attach-stream",
                           "--stream-cycles", "3", "--quiet"])
    line = [x for x in out.getvalue().splitlines()
            if x.startswith("overlay:")]
    print(f"phase 27: serve --attach-stream on 200 nodes: rc {rc}, "
          f"{line[0] if line else 'no overlay line'}")
    if rc != 0 or line != ["overlay: 32 served from the resident twin, 0 "
                           "staged fallbacks"]:
        raise AssertionError("phase 27: serve --attach-stream did not "
                             "answer every request from the twin")


def drive_obs_phases(card):
    """Phases 25-27 inside OBS_BUDGET_S."""
    t0 = time.perf_counter()
    drive_event_replay(card)
    drive_recorder(card)
    drive_live_twin(card)
    wall = time.perf_counter() - t0
    print(f"phases 25-27: {wall:.1f}s wall in all, against their "
          f"{OBS_BUDGET_S} s budget")
    if wall > OBS_BUDGET_S:
        raise AssertionError(f"phases 25-27: {wall:.1f}s is past their "
                             f"{OBS_BUDGET_S} s budget")


def drive_provenance_kernel(card):
    """Phase 28a: config 3 at full width on the kernel route with a
    failures-only provenance log."""
    from tpusim_torch import workloads
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.obs import provenance

    _, params, golden, want_scheduled = GOLDENS["config3"]
    snapshot, pods = workloads.build_workload(**params)
    n = len(pods)
    backend = TorchBackend(device="cuda", route="kernel", fallback="error")
    log = provenance.install(provenance.ProvenanceLog(capacity=n))
    try:
        reset_launches()
        t0 = time.perf_counter()
        placements = backend.schedule(pods, snapshot)
        wall = time.perf_counter() - t0
        launches = fastscan_chunk.launches_by_variant["group_free"]
        all_launches = fastscan_chunk.launches
        t0 = time.perf_counter()
        records = log.tail(n)
        decode_s = time.perf_counter() - t0
    finally:
        provenance.uninstall()
    # the capture alone: what the schedule paid for the log
    spare = provenance.ProvenanceLog(capacity=n)
    t0 = time.perf_counter()
    spare.capture_batch(placements, "backend")
    capture_us = 1e6 * (time.perf_counter() - t0)
    got = choices_golden(backend.last_choices)
    scheduled = sum(1 for p in placements if p.scheduled)
    failed = [(r, pl) for r, pl in zip(records, placements)
              if not r["placed"]]
    wrong = sum(1 for r, pl in zip(records, placements)
                if r["pod"].split("/", 1)[1] != pl.pod.metadata.name
                or r["placed"] != bool(pl.node_name)
                or r.get("node") != (pl.node_name or None))
    wrong += sum(1 for r, pl in failed if r["message"] != pl.message)
    print(f"phase 28a: config3 ({n} pods, {params['num_nodes']} nodes) on "
          f"route kernel with a failures-only provenance log: golden {got} "
          f"(want {golden}), {scheduled} scheduled, {launches} kernel "
          f"launches ({all_launches} in all, want {-(-n // CHUNK)}); "
          f"{len(records)} records ({len(failed)} failures, {wrong} unlike "
          f"their Placement); schedule {wall:.3f}s with the log against "
          f"phase 4's {WARM_WALL['config3']:.3f}s without (the capture "
          f"itself {capture_us:.1f} us), the records' lazy decode "
          f"{decode_s:.3f}s on {card}")
    if (got, scheduled) != (golden, want_scheduled):
        raise AssertionError("phase 28a: config 3 placed differently with "
                             "a provenance log")
    if launches != -(-n // CHUNK) or launches != all_launches:
        raise AssertionError(f"phase 28a: {launches} group_free launches of "
                             f"{all_launches}, want {-(-n // CHUNK)}")
    if len(records) != n or wrong or not failed:
        raise AssertionError(f"phase 28a: {len(records)} records, {wrong} "
                             "unlike their Placement")


def drive_explain(card):
    """Phase 28b: the explain lanes on the scan route at full width: the
    JAX package's records on config 3's first pods and the policy cell,
    parts summing to scores, the lanes' cost against the same scan without
    them, and route "kernel" refusing them."""
    import torch

    import tpusim_torch.backend as backend_module
    from tpusim_torch import workloads
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.obs import provenance

    for name, (workload, params, version, digest) in EXPLAIN_CELLS.items():
        snapshot, pods = getattr(workloads, workload)(**params)
        n = len(pods)
        policy = (decode_policy(workloads.COMPAT_POLICIES[version])
                  if version else None)
        # config 3 in turns, without the lanes, with, with, without: the
        # lanes' cost is the least span with them less the least without
        spans = {}
        for top_k in ((0, EXPLAIN_TOP_K, EXPLAIN_TOP_K, 0)
                      if name == "config3" else (EXPLAIN_TOP_K,)):
            backend = TorchBackend(device="cuda", fallback="error",
                                   route="scan" if top_k == 0 else "auto",
                                   policy=policy)
            log = provenance.install(provenance.ProvenanceLog(
                capacity=n, top_k=top_k))
            record = []
            try:
                t0 = time.perf_counter()
                with timed_on_card(backend_module, "schedule_scan", record):
                    backend.schedule(pods, snapshot)
                wall = time.perf_counter() - t0
                records = log.tail(n)
            finally:
                provenance.uninstall()
            torch.cuda.synchronize()
            (_, _, start, end), = record
            span = start.elapsed_time(end)
            spans[top_k] = min(span, spans.get(top_k, span))
            print(f"phase 28b: {name} first {n} pods x {params['num_nodes']}"
                  f" nodes, top_k {top_k}: route {backend.last_route}, "
                  f"schedule {wall:.3f}s, scan span {span:.1f} ms "
                  f"(CUDA events, graphs of 8 steps) = "
                  f"{1000 * span / n:.0f} us a pod on {card}")
            if top_k:
                got = records_digest(records)
                rows = [row for r in records if r["placed"]
                        for row in r["top_k"]]
        bad = sum(1 for row in rows if sum(row["parts"].values())
                  != row["score"])
        cost = ""
        if 0 in spans:
            extra_us = 1000 * (spans[EXPLAIN_TOP_K] - spans[0]) / n
            cost = (f"; the lanes cost {extra_us:.0f} us a pod "
                    f"({spans[EXPLAIN_TOP_K] / spans[0]:.2f}x the scan "
                    "without them; phase 15's scan 666 us a pod)")
        parts = len(rows[0]["parts"]) if rows else 0
        print(f"phase 28b: {name}: records digest {got} (want {digest}), "
              f"{len(rows)} top-k rows of {parts} parts, {bad} not summing "
              f"to their score{cost}")
        if got != digest or bad or not rows:
            raise AssertionError(f"phase 28b: {name}'s records differ from "
                                 "the JAX package's")
    provenance.install(provenance.ProvenanceLog(top_k=EXPLAIN_TOP_K))
    try:
        TorchBackend(device="cuda", route="kernel").schedule(
            pods[:64], snapshot)
    except NotImplementedError as exc:
        print(f"phase 28b: route kernel with top_k {EXPLAIN_TOP_K} raises: "
              f"{exc}")
    else:
        raise AssertionError("phase 28b: route kernel took the explain "
                             "lanes")
    finally:
        provenance.uninstall()


def drive_config12(card):
    """Phase 29: bench config 12, the config 9 stream with the analytics
    plane off and on, synchronous and pipelined; every sample of a kept
    run against host_reduce; the CPU shape's samples against the JAX
    package's; one serve bucket's pre-bind samples; the reduction's
    kernels and device time."""
    import torch

    from tpusim_torch import scan, workloads
    from tpusim_torch.obs import analytics
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
    from tpusim_torch.simulator import run_stream_simulation

    params, want_chain, want_stats = CONFIG12
    run_stream_simulation(device="cuda", **dict(params, cycles=3))  # warm
    for pipeline in (False, True):
        # the arms in turns, off, on, on, off; each arm's best run, as
        # bench.py takes it
        runs = {False: [], True: []}
        for armed in (False, True, True, False):
            if armed:
                log = analytics.install(analytics.ClusterAnalytics(
                    capacity=512))
            try:
                out = run_stream_simulation(device="cuda",
                                            pipeline=pipeline, **params)
                if armed:
                    out["samples"] = len(log.samples())
            finally:
                analytics.uninstall()
            runs[armed].append(out)
        off, on = (max(runs[armed], key=lambda o: o["decisions_per_s"])
                   for armed in (False, True))
        a, b = off["decisions_per_s"], on["decisions_per_s"]
        chains = {o["placement_chain"] for arm in runs.values() for o in arm}
        print(f"phase 29: config 12 {'pipelined' if pipeline else 'sync'} "
              f"({params['num_nodes']} nodes, {params['cycles']} cycles x "
              f"{params['arrivals']} arrivals; best of 2 runs an arm, in "
              f"turns): analytics off {a:.1f} decisions/s (p50 "
              f"{off['p50_cycle_ms']:.2f} ms; the other run "
              f"{min(o['decisions_per_s'] for o in runs[False]):.1f}), on "
              f"{b:.1f} (p50 {on['p50_cycle_ms']:.2f} ms, {on['samples']} "
              f"samples at 4 Hz; the other run "
              f"{min(o['decisions_per_s'] for o in runs[True]):.1f}); "
              f"overhead_fraction {(a - b) / a:.4f} (the JAX contract: < "
              f"0.02; host walls spread 10-30%, not gated); chain "
              f"{on['placement_chain'][:16]} in all {len(chains)} distinct "
              f"(want {want_chain[:16]}); restages {on['restages']} on "
              f"{card}")
        if chains != {want_chain}:
            raise AssertionError("phase 29: the chains differ with the "
                                 "analytics plane on")
        if any(o["restages"] != {"cold_start": 1} for o in runs[True]):
            raise AssertionError("phase 29: the analytics plane restaged")

    record = []
    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0))
    try:
        with timed_on_card(scan, "analytics_reduce", record):
            out = run_stream_simulation(device="cuda", **params)
        problems = log.verify_against_host()
        kept = len(log.samples())
    finally:
        analytics.uninstall()
    torch.cuda.synchronize()
    spans = [start.elapsed_time(end) for _, _, start, end in record]
    print(f"phase 29: every cycle sampled, inputs kept: {kept} samples, "
          f"{len(problems)} unlike host_reduce; the reduction's CUDA-event "
          f"span p50 {1000 * percentile(spans, 0.5):.1f} us a cycle against "
          f"a cycle's p50 {out['p50_cycle_ms']:.2f} ms; chain "
          f"{out['placement_chain'][:16]} on {card}")
    if problems or kept != params["cycles"] or \
            out["placement_chain"] != want_chain:
        raise AssertionError(f"phase 29: {problems[:3]}")

    cpu_params, cpu_chain, _ = STREAM_GOLDENS["config9"]
    log = analytics.install(analytics.ClusterAnalytics(
        sample_interval_s=0.0))
    try:
        out = run_stream_simulation(device="cuda", **cpu_params)
        got = records_digest(log.series(limit=len(log.samples())))
    finally:
        analytics.uninstall()
    print(f"phase 29: the CPU shape ({cpu_params['num_nodes']} nodes, "
          f"{cpu_params['cycles']} cycles): samples digest {got} (want "
          f"{want_stats}), chain {out['placement_chain'][:16]} (want "
          f"{cpu_chain[:16]})")
    if got != want_stats or out["placement_chain"] != cpu_chain:
        raise AssertionError("phase 29: the CPU shape's samples differ from "
                             "the JAX package's")

    wparams, bucket, _ = SERVE_CONFIG8
    snapshot, _, load = serve_load(workloads.build_workload(**wparams),
                                   WhatIfRequest)
    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0))
    try:
        fleet = ScenarioFleet(bucket_size=bucket, flush_after_s=60.0)
        fleet.register_snapshot("base", snapshot)
        responses = fleet.run(load()[:bucket])
        problems = log.verify_against_host()
        sources = sorted({s.source for s in log.samples()})
        kept = len(log.samples())
    finally:
        analytics.uninstall()
    print(f"phase 29: one config 8 serve bucket ({bucket} requests on "
          f"{len(snapshot.nodes)} nodes): {kept} pre-bind samples "
          f"{sources}, {len(problems)} unlike host_reduce")
    if problems or kept != bucket or not all(r.ok for r in responses):
        raise AssertionError(f"phase 29: serve samples {problems[:3]}")

    # the reduction alone at the stream's width, under torch.profiler
    args = record[-1][0]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            scan.analytics_reduce(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(profiled_device_us(e) for e in kernels) / 10
    print(f"phase 29: analytics_reduce at {params['num_nodes']} nodes "
          f"under torch.profiler: {sum(e.count for e in kernels) / 10:.0f} "
          f"kernels and {busy_us:.1f} us of device busy time a call on "
          f"{card}")


def drive_analytics_phases(card):
    """Phases 28-29 inside ANALYTICS_BUDGET_S."""
    t0 = time.perf_counter()
    drive_provenance_kernel(card)
    drive_explain(card)
    drive_config12(card)
    wall = time.perf_counter() - t0
    print(f"phases 28-29: {wall:.1f}s wall in all, against their "
          f"{ANALYTICS_BUDGET_S} s budget")
    if wall > ANALYTICS_BUDGET_S:
        raise AssertionError(f"phases 28-29: {wall:.1f}s is past their "
                             f"{ANALYTICS_BUDGET_S} s budget")


def drive_live_snapshot(card):
    """Phase 30a: the interpod workload's live cluster fetched over HTTP by
    snapshot_from_cluster, then its 100,000 pods through the fused
    kernel."""
    import tempfile

    import tpusim_torch.api.snapshot as api
    from tpusim_torch.api.kubeclient import snapshot_from_cluster
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    _, params, golden, want_scheduled = GOLDENS["interpod"]
    nodes, served, pods = live_cluster(api, **params)
    server = FakeApiServer(nodes, served, live_configmaps(), LIVE_TOKEN)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig, _ = write_live_files(tmp, server.url)
            t0 = time.perf_counter()
            snapshot = snapshot_from_cluster(kubeconfig=kubeconfig)
            fetch_s = time.perf_counter() - t0
    finally:
        server.stop()
    running = sum(1 for p in served if p.status.phase == "Running")
    backend = TorchBackend(device="cuda", route="kernel", fallback="error")
    reset_launches()
    t0 = time.perf_counter()
    placements = backend.schedule(pods, snapshot)
    wall = time.perf_counter() - t0
    got = choices_golden(backend.last_choices)
    scheduled = sum(1 for p in placements if p.scheduled)
    launches = fastscan_chunk.launches_by_variant["interpod"]
    print(f"phase 30a: live snapshot over HTTP: {len(snapshot.nodes)} nodes "
          f"and {len(snapshot.pods)} Running pods of the {len(served)} "
          f"served ({len(served) - running} decoys dropped by the field "
          f"selector), {server.requests} requests, {server.bytes} bytes in "
          f"{fetch_s:.3f}s; then {len(pods)} pods on route kernel: golden "
          f"{got} (want {golden}), {scheduled} scheduled (want "
          f"{want_scheduled}), {launches} launches of the interpod variant "
          f"(of {fastscan_chunk.launches}); schedule {wall:.3f}s cold "
          f"against phase 10's {WARM_WALL['interpod']:.3f}s warm on {card}")
    if (len(snapshot.nodes), len(snapshot.pods)) != (len(nodes), running):
        raise AssertionError("phase 30a: the snapshot took the wrong objects")
    if (got, scheduled) != (golden, want_scheduled):
        raise AssertionError("phase 30a: the live snapshot placed otherwise")
    if launches != -(-len(pods) // CHUNK) or \
            launches != fastscan_chunk.launches:
        raise AssertionError(f"phase 30a: {launches} interpod launches of "
                             f"{fastscan_chunk.launches}")


def run_children(commands, timeout=300):
    """Run command lines at once as child processes in this checkout:
    [(rc, stdout, stderr, seconds)] in order. Every child is waited for
    (killed at the timeout)."""
    procs = []
    for cmd in commands:
        procs.append((subprocess.Popen(
            cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), time.perf_counter()))
    out = []
    for proc, t0 in procs:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out.append((proc.returncode, stdout, stderr,
                    time.perf_counter() - t0))
    return out


def drive_live_cli(card):
    """Phase 30b: the main command against the same apiserver, as child
    processes on the card: with the ConfigMap's policy, with the default
    provider, and with a ConfigMap that lacks policy.cfg. Phase 31c's child
    runs beside them; returns its (rc, stdout, stderr, seconds) and its
    metrics dump."""
    import tempfile

    import tpusim_torch.api.snapshot as api

    nodes, served, _ = live_cluster(api, **GOLDENS["interpod"][1])
    server = FakeApiServer(nodes, served, live_configmaps(), LIVE_TOKEN)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig, podspec = write_live_files(tmp, server.url)
            base = [sys.executable, "-m", "tpusim_torch.cli", "--kubeconfig",
                    kubeconfig, "--podspec", podspec]
            metrics = os.path.join(tmp, "m.prom")
            policy, provider, missing, telemetry = run_children([
                base + ["--scheduler-policy-configmap", LIVE_POLICY[1]],
                base,
                base + ["--scheduler-policy-configmap", "no-key"],
                [sys.executable, "-m", "tpusim_torch.cli", "stream",
                 "--synthetic-nodes", "4000", "--listen", "127.0.0.1:0",
                 "--slo-target-ms", "30", "--metrics-out", metrics]])
            text = (open(metrics).read() if os.path.exists(metrics)
                    else "")
    finally:
        server.stop()
    for name, (rc, stdout, stderr, secs) in (("policy", policy),
                                              ("provider", provider)):
        got = report_digest(stdout)
        lines = stdout.strip().splitlines()
        print(f"phase 30b: the CLI with --kubeconfig ({name}): rc {rc}, "
              f"report digest {got} (want {LIVE_CLI[name]}), "
              f"{lines[-2] if len(lines) > 1 else 'no report'}; "
              f"{secs:.1f}s in the child")
        if rc != 0 or got != LIVE_CLI[name]:
            raise AssertionError(f"phase 30b: the {name} report differs from "
                                 f"the JAX package's: {stderr[-2000:]}")
    rc, _, stderr, secs = missing
    want = ('error: invalid scheduler policy: missing policy config map '
            'value at key "policy.cfg"')
    last = stderr.strip().splitlines()[-1] if stderr.strip() else ""
    print(f"phase 30b: a ConfigMap without policy.cfg: rc {rc} (want 2), "
          f"{last!r}; {server.requests} requests served in all")
    if rc != 2 or last != want:
        raise AssertionError("phase 30b: the missing key's error differs "
                             "from the JAX package's")
    return telemetry, text


def drive_watch_stream(card):
    """Phase 30c: config 9 fed only by the watch fabric, the node watch torn
    at a cycle, at 4,000 nodes and at the CPU shape."""
    from tpusim_torch import scan
    from tpusim_torch.framework.metrics import register

    mods = port_watch_modules()
    for shape, (params, want_chain, want_fold) in WATCH_STREAM.items():
        register().reset()
        record = []
        graphs = scan.graphs_captured()
        with timed_on_card(scan.ResidentScan, "run", record):
            out = watch_stream(mods, device="cuda", **params)
        graphs = scan.graphs_captured() - graphs
        spans = [start.elapsed_time(end) for _, _, start, end in record]
        overflow = register().watch_overflow.get("nodes")
        lat = [1000 * x for x in out["latencies"]]
        seen = PHASE21.get("config9", {})
        print(f"phase 30c: config 9 through the watch fabric ({shape}: "
              f"{out['nodes']} nodes, {params['cycles']} cycles x "
              f"{params['arrivals']}, the node watch torn at cycle "
              f"{params['tear_at']}): relists {out['relists']}, "
              f"tpusim_watch_overflow_total{{resource=\"nodes\"}} "
              f"{overflow:g}, restages {out['restages']}, paths "
              f"{out['paths']}, {graphs} graph(s) captured; cycle p50 "
              f"{percentile(lat, 0.5):.2f} ms, "
              f"resident scan span p50 {percentile(spans, 0.5):.3f} ms"
              + (f" (phase 21: {seen['p50']:.2f}, {seen['span']:.3f} ms)"
                 if shape == "card" and seen else "")
              + f"; chain {out['placement_chain'][:16]} (want "
              f"{want_chain[:16]}), fold {out['fold_chain'][:16]} on {card}")
        if (out["placement_chain"], out["fold_chain"]) != (want_chain,
                                                           want_fold):
            raise AssertionError(f"phase 30c: the {shape} chains differ from "
                                 "the JAX package's")
        if out["relists"] != 1 or overflow != 1 or out["restages"] != {
                "cold_start": 1, "watch_expired": 1}:
            raise AssertionError("phase 30c: the torn watch was not relisted "
                                 "and restaged exactly once")
        if graphs != 1:
            # the relist's restage must copy into the resident tensors the
            # cold start's graph is bound to, not capture another
            raise AssertionError(f"phase 30c: {graphs} graphs captured")


def _http_get(url, timeout=10):
    """(status, body bytes, seconds) of a GET, an HTTP error status
    included."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read()
    return status, body, time.perf_counter() - t0


def parse_exposition(text):
    """{series: value} of a Prometheus text exposition; raises on a line
    that does not parse (an exemplar after '#' is allowed)."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample = line.split(" # ", 1)[0]
        name, value = sample.rsplit(" ", 1)
        series[name] = float(value)
    return series


class Scraper:
    """Polls every path of the telemetry plane each SCRAPE_PERIOD_S on a
    thread until stopped: [(time, path, status, body, seconds)]."""

    def __init__(self, base):
        import threading

        self.base = base
        self.results = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            for path in TELEMETRY_PATHS:
                status, body, secs = _http_get(self.base + path)
                self.results.append((time.perf_counter(), path, status, body,
                                     secs))
            self._stop.wait(SCRAPE_PERIOD_S)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)


def check_scrapes(results, n_nodes):
    """Every scrape answered and parsed: 200 with a body of its kind, 404
    for the unknown path. Returns the /analytics records read, with the
    time of their scrape."""
    records = []
    for when, path, status, body, _ in results:
        want = 404 if path == "/no-such-path" else 200
        if status != want:
            raise AssertionError(f"phase 31a: {path} answered {status}")
        if path == "/metrics":
            parse_exposition(body.decode())
        elif path == "/healthz":
            doc = json.loads(body)
            if (doc["status"], doc["role"]) != ("ok", "none"):
                raise AssertionError(f"phase 31a: /healthz {doc}")
        elif path == "/debug/provenance":
            if not isinstance(json.loads(body), list):
                raise AssertionError("phase 31a: /debug/provenance")
        elif path == "/debug/trace":
            if not json.loads(body)["enabled"]:
                raise AssertionError("phase 31a: /debug/trace disabled")
        elif path == "/analytics":
            doc = json.loads(body)
            if not doc["enabled"]:
                raise AssertionError("phase 31a: /analytics disabled")
            for rec in doc["series"]:
                if rec["nodes"]["valid"] != n_nodes:
                    raise AssertionError("phase 31a: a sample of the wrong "
                                         "cluster")
                records.append((when, rec))
    return records


def unlike_host_reduce(log, records):
    """The served samples unlike host_reduce of their kept inputs, decoded
    the same way."""
    from tpusim_torch.obs import analytics
    from tpusim_torch.scan import AnalyticsStats

    by_seq = {s.seq: s for s in log.samples()}
    bad = []
    for _, rec in records:
        sample = by_seq[rec["seq"]]
        want = json.loads(json.dumps(analytics.decode_stats(AnalyticsStats(
            **analytics.host_reduce(sample.inputs, sample.n_valid,
                                    sample.k)), sample.names)))
        got = {k: v for k, v in rec.items()
               if k not in ("seq", "ts", "source", "cycle")}
        if got != want:
            bad.append(rec["seq"])
    return bad


def drive_telemetry(card):
    """Phase 31a: the telemetry plane under the config 9 stream: an unarmed
    run, then synchronous and pipelined runs with the server, the
    recorder (with a counting id source), the analytics plane (inputs
    kept) and the SLO tracker armed and every path scraped each
    SCRAPE_PERIOD_S; `top` against the endpoint. Returns the unarmed run's
    summary."""
    import io
    import itertools

    from tpusim_torch import cli
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import analytics, slo, tracectx
    from tpusim_torch.obs import recorder as flight
    from tpusim_torch.obs.server import start_server
    from tpusim_torch.simulator import run_stream_simulation

    params, want_chain, _ = CONFIG12
    n_nodes = params["num_nodes"]
    register().reset()
    settle()
    unarmed = run_stream_simulation(device="cuda", **params)

    register().reset()
    counter = itertools.count(1)
    tracectx.set_id_source(lambda: f"{next(counter):016x}")
    flight.install(flight.FlightRecorder(process_name="chip-smoke"))
    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0))
    slo.install(slo.SloTracker(unarmed["p50_cycle_ms"] * 1000.0))
    server = start_server("127.0.0.1:0")
    scraper = Scraper(server.url)
    try:
        armed, windows = {}, {}
        for pipeline in (False, True):
            t0 = time.perf_counter()
            armed[pipeline] = run_stream_simulation(
                device="cuda", pipeline=pipeline, **params)
            windows[pipeline] = (t0, time.perf_counter())
        time.sleep(2 * SCRAPE_PERIOD_S)  # a scrape after the last cycle
        scraper.stop()
        frame = io.StringIO()
        with contextlib.redirect_stdout(frame):
            top_rc = cli.main(["top", server.url, "--once"])
        judged = sum(register().slo_cycles.get(v) for v in ("ok", "breach"))
        records = check_scrapes(scraper.results, n_nodes)
        bad = unlike_host_reduce(log, records)
    finally:
        scraper.stop()
        server.stop()
        slo.uninstall()
        analytics.uninstall()
        flight.uninstall()
        tracectx.set_id_source(None)
    lo, hi = windows[True]
    during = sum(1 for when, _ in records if lo <= when <= hi)
    scrape_ms = sorted(1000 * r[4] for r in scraper.results)
    chains = {o["placement_chain"] for o in (unarmed, *armed.values())}
    print(f"phase 31a: the telemetry plane on {server.url} under config 9 "
          f"({n_nodes} nodes, {params['cycles']} cycles, sync then "
          f"pipelined): {len(scraper.results)} scrapes of "
          f"{len(TELEMETRY_PATHS)} paths, all answered and parsed, latency "
          f"p50/p99 {percentile(scrape_ms, 0.5):.2f}/"
          f"{percentile(scrape_ms, 0.99):.2f} ms; {len(records)} served "
          f"samples ({during} read during pipelined cycles), {len(bad)} "
          f"unlike host_reduce; cycle p50 sync "
          f"{armed[False]['p50_cycle_ms']:.2f} ms, pipelined "
          f"{armed[True]['p50_cycle_ms']:.2f} ms, against "
          f"{unarmed['p50_cycle_ms']:.2f} ms unarmed; SLO verdicts "
          f"{judged:g} for {2 * params['cycles']} cycles; top rc {top_rc}; "
          f"chains {len(chains)} distinct (want {want_chain[:16]}) on "
          f"{card}")
    if bad or not during:
        raise AssertionError(f"phase 31a: served samples {bad[:5]} differ "
                             "from host_reduce (or none read mid-run)")
    if top_rc != 0 or f"nodes: {n_nodes} valid" not in frame.getvalue():
        raise AssertionError(f"phase 31a: top's frame {frame.getvalue()!r}")
    if chains != {want_chain}:
        raise AssertionError("phase 31a: the chains moved with the "
                             "telemetry plane armed")
    if judged != 2 * params["cycles"]:
        raise AssertionError(f"phase 31a: {judged:g} SLO verdicts for "
                             f"{2 * params['cycles']} cycles")
    return unarmed


def settle():
    """Collect the sessions and graphs earlier runs left, and let the card
    drain, so that back-to-back runs start from the same state."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()


def drive_traces(card, unarmed):
    """Phase 31b: the config 9 stream unarmed, then traced: one trace id a
    cycle on its spans, exemplars, trace_lint, the chain as untraced; then
    traced again with the SLO target at the traced run's cycle p50: both
    verdicts and a burn_start instant. (Tracing costs the stream cycle
    3-13% on the card, so every traced cycle can sit above the unarmed p50:
    the target comes from a run with the same instrumentation.) Each
    verdict must be the latency the tracker judged against the target; a
    judged run whose cycles all fell on one side of it is judged again with
    the target at its own p50, at most SLO_RUNS runs in all. Then phase
    27's twin behind a fleet with traced requests."""
    import itertools

    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import slo, tracectx
    from tpusim_torch.obs import recorder as flight
    from tpusim_torch.simulator import run_stream_simulation

    params, want_chain, _ = CONFIG12

    class KeptTracker(slo.SloTracker):
        """The SLO tracker, keeping each latency it judged."""

        def __init__(self, target_us):
            super().__init__(target_us)
            self.judged_us = []

        def observe(self, path, latency_us):
            self.judged_us.append(latency_us)
            super().observe(path, latency_us)

    def traced_run(target_ms=None):
        settle()
        register().reset()
        counter = itertools.count(1)
        tracectx.set_id_source(lambda: f"{next(counter):016x}")
        rec = flight.install(flight.FlightRecorder(process_name="chip-smoke"))
        tracker = None
        if target_ms is not None:
            tracker = slo.install(KeptTracker(target_ms * 1000.0))
        try:
            out = run_stream_simulation(device="cuda", **params)
            verdicts = {v: register().slo_cycles.get(v)
                        for v in ("ok", "breach")}
            exposition = register().expose()
        finally:
            slo.uninstall()
            flight.uninstall()
            tracectx.set_id_source(None)
        judged_us = tracker.judged_us if tracker is not None else []
        return (out, json.loads(rec.to_chrome_json()), verdicts, exposition,
                judged_us)

    settle()
    base = run_stream_simulation(device="cuda", **params)
    out, doc, _, exposition, _ = traced_run()
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_trace = {}
    for e in spans:
        tid = (e.get("args") or {}).get("trace_id")
        if tid is not None:
            by_trace.setdefault(tid, []).append(e["name"])
    cycle_traces = [names for names in by_trace.values()
                    if "stream_ingest" in names]
    whole = all(names.count("stream_ingest") == 1
                and names.count("device_dispatch") == 1
                for names in cycle_traces)
    unstamped = sum(1 for e in spans if e["name"] == "device_dispatch"
                    and "trace_id" not in (e.get("args") or {}))
    exemplars = sum(1 for line in exposition.splitlines()
                    if line.startswith("tpusim_stream_cycle_latency")
                    and 'trace_id="' in line)
    lint = load_tool("trace_lint")
    problems = lint.lint_trace(doc) + lint.lint_exemplars(doc, exposition)
    print(f"phase 31b: config 9 traced: {len(cycle_traces)} cycle traces, "
          f"each one stream_ingest and one device_dispatch: {whole}; "
          f"{unstamped} device_dispatch spans without a trace id; "
          f"{exemplars} tpusim_stream_cycle_latency series with an "
          f"exemplar; trace_lint {len(problems)} problems; cycle p50 "
          f"{out['p50_cycle_ms']:.2f} ms traced against "
          f"{base['p50_cycle_ms']:.2f} ms unarmed just before (31a's "
          f"{unarmed['p50_cycle_ms']:.2f}); chain "
          f"{out['placement_chain'][:16]} (untraced "
          f"{base['placement_chain'][:16]}) on {card}")
    if len(cycle_traces) != params["cycles"] or not whole or unstamped:
        raise AssertionError("phase 31b: a cycle's spans lack one trace id")
    if not exemplars or problems:
        raise AssertionError(f"phase 31b: exemplars {exemplars}, trace_lint "
                             f"{problems[:5]}")
    if {out["placement_chain"], base["placement_chain"]} != {want_chain}:
        raise AssertionError("phase 31b: the chain moved with tracing on")

    target_ms = out["p50_cycle_ms"]
    for run in range(1, SLO_RUNS + 1):
        judged, doc, verdicts, _, judged_us = traced_run(target_ms)
        burns = sum(1 for e in doc["traceEvents"]
                    if e.get("name") == "slo:burn_start")
        over = sum(1 for us in judged_us if us > target_ms * 1000.0)
        whose = "that" if run == 1 else "the last judged run's"
        print(f"phase 31b: traced again (judged run {run} of at most "
              f"{SLO_RUNS}) with the SLO target at {whose} p50, "
              f"{target_ms:.2f} ms: verdicts {verdicts}, {burns} "
              f"slo:burn_start instants; judged cycles "
              f"{min(judged_us, default=0) / 1e3:.2f}-"
              f"{max(judged_us, default=0) / 1e3:.2f} ms, {over} over the "
              f"target; cycle p50 {judged['p50_cycle_ms']:.2f} ms; chain "
              f"{judged['placement_chain'][:16]}")
        if (len(judged_us) != params["cycles"]
                or verdicts != {"ok": len(judged_us) - over, "breach": over}):
            raise AssertionError("phase 31b: the SLO's verdicts are not the "
                                 "judged latencies against its target")
        if judged["placement_chain"] != want_chain:
            raise AssertionError("phase 31b: the chain moved with the SLO on")
        if 0 < over < len(judged_us):
            break
        target_ms = judged["p50_cycle_ms"]
    if not (verdicts["ok"] and verdicts["breach"] and burns):
        raise AssertionError("phase 31b: the SLO did not judge both ways")
    drive_traced_fleet(card)


def load_tool(name):
    """A script of tools/ as a module, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive_traced_fleet(card):
    """Phase 31b, serve: phase 27's 4,000-node twin behind a ScenarioFleet
    answering TRACED_REQUESTS requests by overlays, traced and judged by the
    SLO tracker."""
    import itertools

    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import slo, tracectx
    from tpusim_torch.obs import recorder as flight
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
    from tpusim_torch.stream import ChurnLoadGen, StreamSession

    p = LIVE_TWIN
    n = p["nodes"]
    session = StreamSession(synthetic_cluster(n))
    gen = ChurnLoadGen(synthetic_cluster(n), seed=16, arrivals=p["arrivals"],
                       evict_fraction=0.25)
    for c in range(p["warm_cycles"]):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
    fleet = ScenarioFleet(bucket_size=8, flush_after_s=60.0)
    fleet.attach_stream(session, ref="live")
    rng = np.random.RandomState(31)
    register().reset()
    counter = itertools.count(1)
    tracectx.set_id_source(lambda: f"{next(counter):016x}")
    rec = flight.install(flight.FlightRecorder(process_name="chip-smoke"))
    slo.install(slo.SloTracker(60_000.0))
    requests = []
    try:
        for r in range(TRACED_REQUESTS):
            request = WhatIfRequest(pods=[
                make_pod(f"traced-q{r}-{i}",
                         milli_cpu=int(rng.randint(100, 1500)),
                         memory=int(rng.randint(2 ** 20, 2 ** 30)))
                for i in range(p["query_pods"])], snapshot_ref="live")
            fut = fleet.submit(request)
            fleet.drain()
            if not fut.result().ok:
                raise AssertionError("phase 31b: a traced request failed")
            requests.append(request)
        verdicts = {v: register().slo_cycles.get(v) for v in ("ok", "breach")}
        hits = fleet.executor.stats["overlay_hits"]
    finally:
        slo.uninstall()
        flight.uninstall()
        tracectx.set_id_source(None)
    events = list(rec.events)
    connected = 0
    for request in requests:
        tid = request.trace.trace_id
        mine = [e for e in events
                if (e.get("args") or {}).get("trace_id") == tid]
        names = {(e["name"], e["ph"]) for e in mine}
        flows = {e["ph"] for e in events if e.get("id") == f"{tid}:q"}
        if {("serve:admit", "X"), ("serve:overlay", "X"),
                ("serve:overlay_resolve", "i")} <= names \
                and flows == {"s", "f"}:
            connected += 1
    print(f"phase 31b: {TRACED_REQUESTS} requests to phase 27's {n}-node "
          f"twin, traced: {hits} overlay answers, {connected} of them one "
          f"connected trace (admit, enqueue flow, overlay, resolve); the "
          f"serve SLO path counted {sum(verdicts.values()):g} {verdicts} on "
          f"{card}")
    if hits != TRACED_REQUESTS or connected != TRACED_REQUESTS or \
            sum(verdicts.values()) != TRACED_REQUESTS:
        raise AssertionError("phase 31b: the fleet's traces or SLO counts "
                             "are incomplete")


def drive_telemetry_cli(card, child):
    """Phase 31c: `stream --listen --slo-target-ms --metrics-out` once, as a
    child process (run beside phase 30b's: drive_live_cli's result)."""
    (rc, stdout, stderr, secs), text = child
    series = parse_exposition(text)
    judged = sum(v for k, v in series.items()
                 if k.startswith("tpusim_slo_cycles_total"))
    listening = [x for x in stderr.splitlines()
                 if x.startswith("telemetry: listening on http://127.0.0.1:")]
    print(f"phase 31c: stream --listen --slo-target-ms 30 on 4,000 nodes: rc "
          f"{rc}, {listening[0] if listening else 'no listening line'}, "
          f"tpusim_slo_cycles_total {judged:g}; {secs:.1f}s in the child; "
          f"{stdout.strip().splitlines()[0] if stdout.strip() else ''}")
    if rc != 0 or not listening or judged <= 0:
        raise AssertionError(f"phase 31c: {stderr[-2000:]}")


def drive_live_phases(card):
    """Phases 30-31 inside LIVE_BUDGET_S."""
    t0 = time.perf_counter()
    drive_live_snapshot(card)
    telemetry_child = drive_live_cli(card)
    drive_watch_stream(card)
    drive_traces(card, drive_telemetry(card))
    drive_telemetry_cli(card, telemetry_child)
    wall = time.perf_counter() - t0
    print(f"phases 30-31: {wall:.1f}s wall in all, against their "
          f"{LIVE_BUDGET_S} s budget")
    if wall > LIVE_BUDGET_S:
        raise AssertionError(f"phases 30-31: {wall:.1f}s is past their "
                             f"{LIVE_BUDGET_S} s budget")


def chaos_plan_of(faults):
    from tpusim_torch.chaos.plan import DeviceFaultPlan, FaultPlan

    return FaultPlan(seed=11, device=DeviceFaultPlan(**faults))


def drive_chaos_full(card):
    """Phase 32a: config 3 through run_simulation on the card behind an
    armed breaker (faults past its one dispatch, verify "probe"), the host
    route made to raise: phase 4's golden, 196 launches, the breaker never
    moved."""
    from tpusim_torch import workloads
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.simulator import run_simulation

    workload, params, golden, want_scheduled = GOLDENS["config3"]
    snapshot, pods = (BUILT.pop("config3", None)
                      or getattr(workloads, workload)(**params))
    reset_launches()
    t0 = time.perf_counter()
    with device_routes_only():
        # run_simulation feeds the pods last first, as the reference does:
        # reversed, they reach the backend in phase 4's order
        status = run_simulation(list(reversed(pods)), snapshot,
                                backend="torch", device="cuda",
                                route="kernel",
                                chaos_plan=chaos_plan_of(CHAOS_FULL))
    wall = time.perf_counter() - t0
    launches = fastscan_chunk.launches
    index = {n.name: i for i, n in enumerate(snapshot.nodes)}
    placed = {p.key(): index[p.spec.node_name]
              for p in status.successful_pods}
    got = choices_golden([placed.get(p.key(), -1) for p in pods])
    trail = status.chaos_summary["breaker_transitions"]
    print(f"phase 32a: config3 behind the breaker (faults "
          f"{CHAOS_FULL['faults']} past its dispatch, verify probe): golden "
          f"{got} (want {golden}), {len(placed)} scheduled (want "
          f"{want_scheduled}), {launches} kernel launches, breaker "
          f"transitions {trail}; wall {wall:.3f}s against phase 4's warm "
          f"{WARM_WALL.get('config3', float('nan')):.3f}s on {card}")
    if (got, len(placed)) != (golden, want_scheduled):
        raise AssertionError("phase 32a: config 3 placed differently "
                             "behind the breaker")
    if launches != 196 or trail:
        raise AssertionError(f"phase 32a: {launches} launches, breaker "
                             f"{trail}")
    return launches


def drive_chaos_script(card):
    """Phase 32b: CHAOS_SCRIPT's dispatches through TorchBackend(route=
    "kernel") with verify "all": every answer the host's placement hash,
    the JAX package's breaker trail, and kernel launches only on the
    dispatches the breaker let through and no fault stopped before the
    launch."""
    from tpusim_torch import workloads
    from tpusim_torch.backend import (
        TorchBackend,
        install_chaos,
        uninstall_chaos,
    )
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.chaos.plan import DeviceFaultPlan
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    shape, plan, dispatches = CHAOS_SCRIPT
    want = CONFIG11_GOLDEN["script"]
    snapshot, pods = workloads.uniform_workload(**shape)
    routes = register().backend_route
    fallbacks0 = routes.values.get("breaker_fallback", 0)
    breaker = install_chaos(DeviceFaultPlan(**plan))
    rows = []
    t0 = time.perf_counter()
    try:
        backend = TorchBackend(device="cuda", route="kernel")
        for _ in range(dispatches):
            reset_launches()
            state = breaker.state.value
            t1 = time.perf_counter()
            h = placement_hash(backend.schedule(pods, snapshot))
            rows.append((state, fastscan_chunk.launches, h,
                         time.perf_counter() - t1))
    finally:
        uninstall_chaos()
    wall = time.perf_counter() - t0
    fallbacks = routes.values.get("breaker_fallback", 0) - fallbacks0
    trail = [list(t) for t in breaker.transitions]
    for i, (state, launches, h, sec) in enumerate(rows):
        print(f"phase 32b: dispatch {i}: breaker {state} before it, "
              f"{launches} kernel launches, answer {h[:16]} "
              f"({'the host' if h == want['hash'] else 'DIFFERS'}), "
              f"{sec:.3f}s")
    print(f"phase 32b: uniform {shape['num_pods']} x {shape['num_nodes']}, "
          f"faults {plan['faults']}: transitions {trail} (the JAX "
          f"package's: {trail == want['transitions']}), {int(fallbacks)} host "
          f"answers counted, {wall:.1f}s wall on {card}")
    if any(h != want["hash"] for _, _, h, _ in rows):
        raise AssertionError("phase 32b: an answer differs from the host's")
    if trail != want["transitions"]:
        raise AssertionError("phase 32b: the breaker's trail differs from "
                             "the JAX package's")
    # dispatch 0 dies before the launch, dispatch 2 is denied; the others
    # launch (1 and 3 then are answered by the host, counted)
    if [n > 0 for _, n, _, _ in rows] != [False, True, False, True, True,
                                          True] or fallbacks != 4:
        raise AssertionError(f"phase 32b: launches "
                             f"{[n for _, n, _, _ in rows]}, {fallbacks} "
                             "host answers")


def drive_chaos_stream(card):
    """Phase 32c: config 11's stream shape under CONFIG11_FAULTS: the
    fault-free fold chain, the JAX package's restages, paths and breaker
    trail, and one graph captured for the one pod bucket (every restage
    after a fault copies into the resident tensors)."""
    from tpusim_torch import scan
    from tpusim_torch.simulator import run_stream_simulation

    want = CONFIG11_GOLDEN["stream"]
    graphs0 = scan.graphs_captured()
    out = run_stream_simulation(device="cuda",
                                chaos_plan=chaos_plan_of(CONFIG11_FAULTS),
                                **CONFIG11_STREAM)
    graphs = scan.graphs_captured() - graphs0
    trail = [list(t) for t in out["breaker_transitions"]]
    print(f"phase 32c: config 11 stream ({CONFIG11_STREAM['num_nodes']} "
          f"nodes, {CONFIG11_STREAM['cycles']} cycles of "
          f"{CONFIG11_STREAM['arrivals']}) under faults "
          f"{CONFIG11_FAULTS['faults']}: {out['elapsed_s']:.3f}s wall, cycle "
          f"p50/p99 {out['p50_cycle_ms']:.2f}/{out['p99_cycle_ms']:.2f} ms; "
          f"paths {out['paths']}, restages {out['restages']}, {graphs} "
          f"graph(s) captured; fold {out['fold_chain'][:16]} (want "
          f"{want['fold_chain'][:16]}); breaker {len(trail)} transitions on "
          f"{card}")
    if out["fold_chain"] != want["fold_chain"]:
        raise AssertionError("phase 32c: the chain differs from the "
                             "fault-free golden")
    if (out["restages"], out["paths"], trail) != (
            want["restages"], want["paths"], want["transitions"]):
        raise AssertionError("phase 32c: restages, paths or the breaker's "
                             "trail differ from the JAX package's")
    if graphs != 1:
        raise AssertionError(f"phase 32c: {graphs} graphs captured")


def drive_chaos_serve(card):
    """Phase 32d: config 11's serve load clean and under a permanent fault
    storm (the breaker open, every bucket answered by the host): every
    future answered, every storm response degraded with the clean answer,
    the clean answers the JAX package's; the scenarios/s ratio."""
    import torch

    from tpusim_torch import workloads
    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backend import install_chaos, uninstall_chaos
    from tpusim_torch.chaos import ChaosClock, DeviceFaultPlan
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    n, count = CONFIG11_SERVE["num_nodes"], CONFIG11_SERVE["requests"]
    snapshot = synthetic_cluster(n)
    pool = workloads.build_workload(8, n)[1]

    def serve_pass():
        fleet = ScenarioFleet(bucket_size=CONFIG11_SERVE["bucket"],
                              clock=ChaosClock(), device="cuda")
        fleet.register_snapshot("base", snapshot)

        def load():
            return [WhatIfRequest(pods=pool[:1 + i % 4], snapshot_ref="base",
                                  cache_key=f"r{i}") for i in range(count)]

        fleet.run(load())  # warm: the builds before the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        responses = fleet.run(load())
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        fleet.stop()
        return responses, elapsed

    clean, clean_s = serve_pass()
    install_chaos(DeviceFaultPlan(faults={i: "exception"
                                          for i in range(10_000)},
                                  failure_threshold=1, cooldown=1_000_000))
    try:
        storm, storm_s = serve_pass()
    finally:
        uninstall_chaos()
    hashes = placement_hashes([r.result for r in clean if r.ok])
    digest = combined_digest(hashes)
    same = all(r.ok and s.ok and r.result and s.result
               and placement_hashes([s.result]) == placement_hashes(
                   [r.result]) for r, s in zip(clean, storm))
    degraded = sum(1 for r in storm if r.degraded)
    clean_rate, storm_rate = count / clean_s, count / storm_s
    print(f"phase 32d: config 11 serve ({count} requests on {n} nodes, "
          f"bucket {CONFIG11_SERVE['bucket']}): clean {clean_rate:.1f} "
          f"scenarios/s, digest {digest} (want "
          f"{CONFIG11_GOLDEN['serve_digest']}); storm {storm_rate:.1f} "
          f"scenarios/s, {degraded}/{len(storm)} degraded "
          f"({sorted({r.degraded for r in storm if r.degraded})}), answers "
          f"equal {same}; storm/clean {storm_rate / clean_rate:.3f} on "
          f"{card}")
    if len(clean) != count or len(storm) != count:
        raise AssertionError("phase 32d: a future went unanswered")
    if digest != CONFIG11_GOLDEN["serve_digest"] or not same \
            or degraded != count:
        raise AssertionError("phase 32d: the storm's answers differ")


def drive_recovery(card):
    """Phase 33: bench config 11's recovery curve at its accelerator shape
    (a crash right after cycle 24's emit record, recovered, at checkpoint
    cadences 1, 5 and 20), a pipelined crash after a bind record, and the
    `stream` command crashed (rc 3) and recovered as child processes; every
    recovered fold chain the uninterrupted golden."""
    import shutil
    import tempfile

    from tpusim_torch.chaos.engine import ProcessCrash
    from tpusim_torch.chaos.plan import ChurnEvent, FaultPlan
    from tpusim_torch.simulator import run_stream_simulation

    want = CONFIG11_GOLDEN["stream"]["fold_chain"]
    root = tempfile.mkdtemp(prefix="chip-smoke-ck-")

    def crash(point):
        return FaultPlan(seed=11, churn=[ChurnEvent(
            at=CONFIG11_CRASH["at"], action="process_crash", target=point)])

    def stream(ckdir, every, **kw):
        return run_stream_simulation(device="cuda", checkpoint_dir=ckdir,
                                     checkpoint_every=every,
                                     **CONFIG11_STREAM, **kw)

    try:
        # the CLI's crash child overlaps the in-process arms (8 cores)
        plan_path = os.path.join(root, "crash.json")
        with open(plan_path, "w") as f:
            f.write(crash("emit").to_json())
        cli = [sys.executable, "-m", "tpusim_torch.cli", "stream",
               "--synthetic-nodes", str(CONFIG11_STREAM["num_nodes"]),
               "--cycles", str(CONFIG11_STREAM["cycles"]),
               "--arrivals", str(CONFIG11_STREAM["arrivals"]),
               "--evict-fraction", str(CONFIG11_STREAM["evict_fraction"]),
               "--seed", str(CONFIG11_STREAM["seed"]),
               "--checkpoint-every", "5",
               "--checkpoint-dir", os.path.join(root, "cli")]
        child = subprocess.Popen(cli + ["--chaos-plan", plan_path],
                                 cwd=HERE, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        arms = [("sync", every, False, CONFIG11_CRASH["point"])
                for every in CONFIG11_CRASH["cadences"]]
        point, every = CONFIG11_CRASH["pipelined"]
        arms.append(("pipelined", every, True, point))
        for label, every, pipeline, point in arms:
            ckdir = os.path.join(root, f"{label}-{every}")
            t0 = time.perf_counter()
            try:
                stream(ckdir, every, pipeline=pipeline,
                       chaos_plan=crash(point))
                raise AssertionError("phase 33: the crash did not fire")
            except ProcessCrash:
                pass
            crashed_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = stream(ckdir, every, pipeline=pipeline, recover=True)
            recover_s = time.perf_counter() - t0
            print(f"phase 33: {label} crash after cycle "
                  f"{CONFIG11_CRASH['at']}'s {point} record, checkpoint "
                  f"every {every}: run to the crash {crashed_s:.3f}s; "
                  f"recovery: replay {out['replay_ms']:.1f} ms, "
                  f"{len(out['recomputed_cycles'])} cycle(s) recomputed "
                  f"{out['recomputed_cycles']}, resumed at cycle "
                  f"{out['resume_cycle']}, {recover_s:.3f}s to the end; "
                  f"{out['wal_records']} WAL records, restages "
                  f"{out['restages']}; fold {out['fold_chain'][:16]} (want "
                  f"{want[:16]}) on {card}")
            if out["fold_chain"] != want or out["recovery_violations"]:
                raise AssertionError(f"phase 33: the {label} recovery at "
                                     f"cadence {every} differs")
        _, err = child.communicate(timeout=300)
        if child.returncode != 3 or "recover with:" not in err:
            raise AssertionError(f"phase 33: the crashed CLI gave rc "
                                 f"{child.returncode}: {err[-500:]}")
        t0 = time.perf_counter()
        res = subprocess.run(cli + ["--recover", "--json"], cwd=HERE,
                             capture_output=True, text=True, timeout=300)
        out = json.loads(res.stdout) if res.returncode == 0 else {}
        print(f"phase 33: `stream --chaos-plan` rc {child.returncode} "
              f"({err.strip().splitlines()[0]}), then `--recover` rc "
              f"{res.returncode} in {time.perf_counter() - t0:.1f}s: "
              f"resumed at cycle {out.get('resume_cycle')}, fold "
              f"{out.get('fold_chain', '')[:16]} (want {want[:16]})")
        if out.get("fold_chain") != want:
            raise AssertionError(f"phase 33: the CLI's recovery differs: "
                                 f"{res.stderr[-500:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def drive_chaos_phases(card):
    """Phases 32-33 inside CHAOS_BUDGET_S; returns the fused kernel's
    launches of phase 32a."""
    t0 = time.perf_counter()
    launches = drive_chaos_full(card)
    drive_chaos_script(card)
    drive_chaos_stream(card)
    drive_chaos_serve(card)
    drive_recovery(card)
    wall = time.perf_counter() - t0
    print(f"phases 32-33: {wall:.1f}s wall in all, against their "
          f"{CHAOS_BUDGET_S} s budget")
    if wall > CHAOS_BUDGET_S:
        raise AssertionError(f"phases 32-33: {wall:.1f}s is past their "
                             f"{CHAOS_BUDGET_S} s budget")
    return launches


def audit_digest(report):
    """sha256 of an audit report without its wall times (the decision
    records' ts) and with its two directories named "a" and "b" (JSON with
    sorted keys), first 16 hex digits."""
    body = json.loads(json.dumps(report))
    body["a"], body["b"] = "a", "b"
    for rec in body.get("replay", {}).get("decisions", []):
        rec.pop("ts", None)
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()
                          ).hexdigest()[:16]


def flip_first_bind(directory, cycle):
    """Bind the first pod of `cycle`'s bind record in a journal to another
    node the journal binds to (tests/test_audit.py's recipe); returns
    (pod, node, the other node)."""
    path = os.path.join(directory, "wal.jsonl")
    with open(path, encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]
    nodes = sorted({n for r in records if r["k"] == "bind"
                    for _, n in r["b"]})
    target = next(r for r in records
                  if r["k"] == "bind" and r["c"] == cycle and r["b"])
    pod, node = target["b"][0]
    flipped = next(n for n in nodes if n != node)
    target["b"][0] = [pod, flipped]
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
    return pod, node, flipped


def journal_heads(directory):
    """The fold chain after each emit record of a journal, in order."""
    from tpusim_torch.stream.persist import chain_fold

    heads, chain = [], ""
    with open(os.path.join(directory, "wal.jsonl"), encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec["k"] == "emit":
                chain = chain_fold(chain, rec["h"])
                heads.append(chain)
    return heads


def tenancy_pressure(make_budget, cluster, gen_cls, register, root,
                     settle=None):
    """Phase 35b's drive, with either package's ResidencyBudget factory
    (a byte budget -> a ledger), synthetic_cluster, ChurnLoadGen and
    metrics register: the TENANCY_PRESSURE tenants admitted in turn, each
    driven for `cycles` cycles in turn, `rounds` times over; after the
    first tenant's cycles the budget becomes budget_twins times its twin's
    bytes. Everything is read from the ledger's own surface: a tenant that
    is not resident is restored by restore() (timed) before it is touched;
    the tenants resident before a touch (admit() or session()) and not
    after it were evicted by it, coldest first, each counted under reason
    "pressure" in tpusim_tenant_evictions_total. With settle (a callable
    giving the device's allocated bytes once settled), each touch that
    finds the ledger over its budget, and so evicts, is measured: (the
    tenants it evicted, the bytes it took off total_bytes(), the allocated
    bytes it gave back). Returns (record, ledger): the record holds the
    evictions ([tenant, reason] in order), the restores (tenants in order)
    and their ms, those measurements, each tenant's final chain, the first
    twin's bytes, and the session() touches that left the ledger over its
    budget."""
    import itertools

    p = TENANCY_PRESSURE
    names = [f"t{i}" for i in range(p["tenants"])]
    budget = make_budget(1 << 40)
    evictions = register().tenant_evictions
    out = {"evictions": [], "restores": [], "restore_ms": [], "freed": [],
           "touches": 0, "over_budget": 0}
    last_touch, clock = {}, itertools.count()

    def touch(name, call):
        resident = [n for n in budget.tenants() if budget.resident(n)]
        held = budget.total_bytes()
        measured = settle is not None and held > budget.budget_bytes
        if measured:
            allocated = settle()
        counted = evictions.get("pressure")
        last_touch[name] = next(clock)
        result = call()
        gone = sorted((n for n in resident if not budget.resident(n)),
                      key=last_touch.__getitem__)
        if evictions.get("pressure") - counted != len(gone):
            raise AssertionError(f"{name}'s touch evicted {gone}, not all "
                                 "of them counted under pressure")
        out["evictions"] += [[n, "pressure"] for n in gone]
        if measured and gone:
            out["freed"].append((gone, held - budget.total_bytes(),
                                 allocated - settle()))
        return result

    def session(name):
        if not budget.resident(name):
            t0 = time.perf_counter()
            budget.restore(name)
            out["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            out["restores"].append(name)
        live = touch(name, lambda: budget.session(name))
        out["touches"] += 1
        if budget.total_bytes() > budget.budget_bytes:
            out["over_budget"] += 1
        return live

    gens, done = {}, dict.fromkeys(names, 0)
    for rnd in range(p["rounds"]):
        for i, name in enumerate(names):
            if rnd == 0:
                touch(name, lambda: budget.admit(
                    name, cluster(p["nodes"]),
                    directory=os.path.join(root, name)))
                gens[name] = gen_cls(cluster(p["nodes"]), seed=p["seed"] + i,
                                     arrivals=p["arrivals"],
                                     evict_fraction=0.25)
            gen = gens[name]
            for c in range(done[name], done[name] + p["cycles"]):
                session(name).apply_events(gen.events(c))
                gen.note_bound(session(name).schedule(gen.batch()))
            done[name] += p["cycles"]
            if rnd == 0 and i == 0:
                out["per_twin"] = budget.total_bytes()
                budget.budget_bytes = int(p["budget_twins"] * out["per_twin"])
    out["chains"] = {n: budget.chain(n) for n in names}
    return out, budget


def free_port():
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drive_audit(card):
    """Phase 34: the audit at config 11's stream shape on the card: the
    journal written by run_stream_simulation, a copy with cycle
    AUDIT_FLIP_CYCLE's first bind flipped, the identical pair, the bisect
    alone and with the forensic re-run (explain lanes, top 3), and the
    `audit --json` command as a child; the report's digest the JAX
    package's."""
    import shutil
    import tempfile

    from tpusim_torch.obs.audit import audit_wal_pair
    from tpusim_torch.simulator import run_stream_simulation

    want = CONFIG15_GOLDEN["audit"]
    root = tempfile.mkdtemp(prefix="chip-smoke-audit-")
    try:
        a, b, same = (os.path.join(root, n) for n in ("a", "b", "same"))
        t0 = time.perf_counter()
        out = run_stream_simulation(device="cuda", checkpoint_dir=a,
                                    checkpoint_every=0, **CONFIG11_STREAM)
        journal_s = time.perf_counter() - t0
        if out["fold_chain"] != CONFIG11_GOLDEN["stream"]["fold_chain"]:
            raise AssertionError("phase 34: the journaled run's chain "
                                 "differs from config 11's golden")
        shutil.copytree(a, b)
        shutil.copytree(a, same)
        pod, node, flipped = flip_first_bind(b, AUDIT_FLIP_CYCLE)
        child = subprocess.Popen(
            [sys.executable, "-m", "tpusim_torch.cli", "audit", a, b,
             "--json"], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        ident = audit_wal_pair(a, same, device="cuda")
        ident_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        audit_wal_pair(a, b, replay=False, device="cuda")
        bisect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = audit_wal_pair(a, b, explain_k=3, device="cuda")
        full_s = time.perf_counter() - t0
        digest = audit_digest(report)
        try:
            cli_out, cli_err = child.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            child.kill()
            cli_out, cli_err = child.communicate()
        cli_digest = (audit_digest(json.loads(cli_out))
                      if child.returncode == 1 else None)
        decided = {d["pod"]: d for d in report.get("replay", {}).get(
            "decisions", [])}
        top = decided.get(pod, {}).get("top_k", [])
        print(f"phase 34: audit of config 11's journal "
              f"({CONFIG11_STREAM['num_nodes']} nodes, "
              f"{CONFIG11_STREAM['cycles']} cycles of "
              f"{CONFIG11_STREAM['arrivals']}; written in {journal_s:.3f}s): "
              f"identical pair {ident['verdict']} in {ident_s * 1e3:.1f} ms; "
              f"cycle {AUDIT_FLIP_CYCLE}'s first bind flipped ({pod}: {node} "
              f"-> {flipped}): divergent cycle {report['divergent_cycle']}, "
              f"kind {report.get('kind')}, bind diff "
              f"{len(report.get('bind_diff', []))} row(s), re-decision "
              f"agrees with {report.get('replay_agrees_with')}, {len(top)} "
              f"candidates with parts; bisect {bisect_s * 1e3:.1f} ms, "
              f"replay {(full_s - bisect_s) * 1e3:.1f} ms "
              f"(restages {report.get('replay', {}).get('restages')}); "
              f"digest {digest} (want {want}); `audit --json` child rc "
              f"{child.returncode}, digest {cli_digest} on {card}")
        if ident["verdict"] != "identical":
            raise AssertionError("phase 34: the identical pair diverged")
        if (report["divergent_cycle"], report.get("kind"),
                report.get("bind_diff"), report.get("replay_agrees_with")) \
                != (AUDIT_FLIP_CYCLE, "bind",
                    [{"pod": pod, "a": node, "b": flipped}], "a"):
            raise AssertionError(f"phase 34: the audit missed the flip: "
                                 f"{json.dumps(report)[:800]}")
        if "violations" in report["replay"] or not top:
            raise AssertionError("phase 34: the forensic re-run disagrees "
                                 "or carries no explain lanes")
        if digest != want:
            raise AssertionError("phase 34: the report differs from the "
                                 "JAX package's")
        if cli_digest != digest:
            raise AssertionError(f"phase 34: the CLI's report differs: "
                                 f"{cli_err[-500:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def drive_tenancy(card):
    """Phase 35: (a) config 16's tenancy curve (two tenants of 200 nodes
    after 4 warm cycles, each evicted and restored), every chain intact;
    (b) the pressure arm (tenancy_pressure on the card): the JAX package's
    evictions, restores and chains, no touch over the budget, and each
    touch that evicts giving back at least the bytes it took off the
    ledger's total_bytes() in memory_allocated."""
    import gc
    import shutil
    import tempfile

    import torch

    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.stream import ChurnLoadGen, ResidencyBudget

    root = tempfile.mkdtemp(prefix="chip-smoke-tenancy-")
    try:
        c = TENANCY_CURVE
        budget = ResidencyBudget(1 << 40, device="cuda")
        for name in ("a", "b"):
            session = budget.admit(name, synthetic_cluster(c["nodes"]),
                                   directory=os.path.join(root, "curve",
                                                          name))
            gen = ChurnLoadGen(synthetic_cluster(c["nodes"]), seed=c["seed"],
                               arrivals=c["arrivals"], evict_fraction=0.25)
            for cycle in range(c["warm_cycles"]):
                session.apply_events(gen.events(cycle))
                gen.note_bound(session.schedule(gen.batch()))
        for name in ("a", "b"):
            chain = budget.chain(name)
            t0 = time.perf_counter()
            budget.evict(name)
            evict_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            budget.restore(name)
            restore_ms = (time.perf_counter() - t0) * 1e3
            intact = budget.chain(name) == chain
            print(f"phase 35a: config 16 tenant {name} ({c['nodes']} nodes, "
                  f"{c['warm_cycles']} warm cycles of {c['arrivals']}): "
                  f"evict {evict_ms:.1f} ms, restore {restore_ms:.1f} ms, "
                  f"chain intact {intact} on {card}")
            if not intact:
                raise AssertionError(f"phase 35a: tenant {name}'s chain "
                                     "moved across the round trip")

        def settle():
            torch.cuda.synchronize()
            gc.collect()
            return torch.cuda.memory_allocated()

        p = TENANCY_PRESSURE
        want = CONFIG15_GOLDEN["tenancy"]
        t0 = time.perf_counter()
        out, _ = tenancy_pressure(
            lambda b: ResidencyBudget(b, device="cuda"), synthetic_cluster,
            ChurnLoadGen, register, os.path.join(root, "pressure"), settle)
        wall = time.perf_counter() - t0
        ms = sorted(out["restore_ms"])
        freed = out["freed"]
        print(f"phase 35b: {p['tenants']} tenants of {p['nodes']} nodes, "
              f"{p['rounds']} rounds of {p['cycles']} cycles of "
              f"{p['arrivals']} each in turn, budget {p['budget_twins']} x "
              f"{out['per_twin']} bytes: {wall:.3f}s wall; evictions "
              f"{out['evictions']}; restores {out['restores']}, ms p50 "
              f"{percentile(ms, 0.5):.1f} / max {ms[-1]:.1f}; "
              f"{out['over_budget']} of {out['touches']} touches over the "
              f"budget; memory_allocated freed per evicting touch "
              f"{[(g, f) for g, _, f in freed]} against the bytes it took "
              f"off the ledger {[b for _, b, _ in freed]}; chains equal the "
              f"JAX package's {out['chains'] == want['chains']} on {card}")
        if (out["evictions"], out["restores"], out["chains"]) != (
                want["evictions"], want["restores"], want["chains"]):
            raise AssertionError("phase 35b: the evictions, restores or "
                                 "chains differ from the JAX package's")
        if out["over_budget"]:
            raise AssertionError("phase 35b: a touch left the ledger over "
                                 "its budget")
        if sum(len(g) for g, _, _ in freed) != len(out["evictions"]) or any(
                nbytes <= 0 or got < nbytes for _, nbytes, got in freed):
            raise AssertionError("phase 35b: an eviction kept its twin's "
                                 "device memory")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def start_follow_child(ckdir, bind, listen):
    """The `follow --watch-leader` child of phase 36's CLI pair."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpusim_torch.cli", "follow", "--bind",
         f"127.0.0.1:{bind}", "--checkpoint-dir", ckdir, "--watch-leader",
         f"127.0.0.1:{listen}", "--watch-interval", "0.05",
         "--watch-timeout", "240", "--synthetic-nodes",
         str(CONFIG11_STREAM["num_nodes"]), "--checkpoint-every", "5",
         "--json"], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def wait_for_line(stream, text, timeout):
    """Read lines of a child's pipe until one holds `text` (True), EOF or
    the timeout (False)."""
    import select

    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        ready, _, _ = select.select([stream], [], [], remaining)
        if not ready:
            return False
        line = stream.readline()
        if not line:
            return False
        if text in line:
            return True


def promotion_split(trace):
    """A traced replicated run's promotion, ms by span: its tail replay,
    its settle pass, the span around both (replicate:promote) and its
    closing checkpoint (the first recover:checkpoint after that span)."""
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    took = {e["name"]: e["dur"] / 1e3 for e in spans if e["name"] in (
        "promote:tail_replay", "promote:settle", "replicate:promote")}
    end = max((e["ts"] + e["dur"] for e in spans
               if e["name"] == "replicate:promote"), default=None)
    closing = sorted((e["ts"], e["dur"] / 1e3) for e in spans
                     if e["name"] == "recover:checkpoint" and end is not None
                     and e["ts"] >= end)
    took["recover:checkpoint"] = closing[0][1] if closing else 0.0
    return took


def drive_replication(card):
    """Phase 36: bench config 15 at its accelerator shape (config 11's
    stream): the RTO curve by checkpoint cadence, the lag curve by
    arrivals, the CLI pair (a `follow --watch-leader` child promoting when
    a `stream --replicate-to --listen` child dies by a process-crash plan),
    and a fleet answering REPLICA_REQUESTS requests from a follower's
    twin; the fused kernel's launches over the phase."""
    import shutil
    import tempfile

    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.chaos.plan import CRASH_POINTS, kill_leader_campaign
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.kernels.fastscan import fastscan_chunk
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
    from tpusim_torch.simulator import run_replicated_stream
    from tpusim_torch.stream import (
        ChurnLoadGen,
        StreamPersistence,
        StreamSession,
    )
    from tpusim_torch.stream.replicate import FollowerTwin, WalShipper

    want = CONFIG11_GOLDEN["stream"]["fold_chain"]
    gold = CONFIG15_GOLDEN["replication"]
    plan = kill_leader_campaign(seed=CONFIG15["seed"],
                                cycles=CONFIG11_STREAM["cycles"])[
        CRASH_POINTS.index("emit")]
    at = plan.churn[0].at
    root = tempfile.mkdtemp(prefix="chip-smoke-repl-")
    children = []
    reset_launches()
    try:
        # the CLI pair's follower starts first: its start-up overlaps the
        # in-process arms (8 cores)
        ckdir = os.path.join(root, "cli")
        bind, listen = free_port(), free_port()
        follow = start_follow_child(ckdir, bind, listen)
        children.append(follow)
        for every in CONFIG15["cadences"]:
            # traced, for the promotion's own spans
            t0 = time.perf_counter()
            out, trace = traced(lambda: run_replicated_stream(
                device="cuda", chaos_plan=plan, checkpoint_every=every,
                checkpoint_dir=os.path.join(root, f"rto-{every}"),
                **CONFIG11_STREAM))
            wall = time.perf_counter() - t0
            took = promotion_split(trace)
            own = out["promote_s"] * 1e3
            rest = (own - took.get("replicate:promote", 0.0)
                    - took["recover:checkpoint"])
            print(f"phase 36: config 15 RTO, leader killed after cycle "
                  f"{at}'s emit record, checkpoint every {every}: promoted "
                  f"{out['promoted']}, RTO {out['rto_s'] * 1e3:.2f} ms = "
                  f"the promotion's own work {own:.2f} ms (tail replay "
                  f"{took.get('promote:tail_replay', 0.0):.2f} + settle "
                  f"{took.get('promote:settle', 0.0):.2f} + the closing "
                  f"checkpoint {took['recover:checkpoint']:.2f} + the "
                  f"journal's read and the rest {rest:.2f} ms) + the rest "
                  f"(lock wait, pump stop, detection) "
                  f"{(out['rto_s'] - out['promote_s']) * 1e3:.2f} ms, "
                  f"replayed {out['replayed_records']}/{out['wal_records']} "
                  f"records (lag at the crash {out['lag_at_crash']}), "
                  f"recomputed {out['recomputed_cycles']}, settled "
                  f"{out['settled_live_cycles']}, resumed at cycle "
                  f"{out['resume_cycle']}; graphs {out['graphs']}; "
                  f"{wall:.3f}s wall; fold {out['fold_chain'][:16]} (want "
                  f"{want[:16]}) on {card}")
            if not (out["crashed"] and out["promoted"]) \
                    or out["divergence"] is not None \
                    or out["promotion_violations"]:
                raise AssertionError(f"phase 36: the cadence {every} "
                                     "failover did not promote cleanly")
            if out["fold_chain"] != want \
                    or out["fold_chain"] != gold["rto"][str(every)]:
                raise AssertionError(f"phase 36: the cadence {every} chain "
                                     "differs from the crash-free golden")
            if out["replayed_records"] >= out["wal_records"]:
                raise AssertionError("phase 36: the promotion replayed the "
                                     "whole journal")
            if min(out["graphs"].values()) < 1:
                raise AssertionError(f"phase 36: a side captured no graph: "
                                     f"{out['graphs']}")
        if not wait_for_line(follow.stderr, "replication listener", 120.0):
            raise AssertionError("phase 36: the follow child never listened")
        plan_path = os.path.join(root, "crash.json")
        with open(plan_path, "w") as f:
            f.write(plan.to_json())
        leader = subprocess.Popen(
            [sys.executable, "-m", "tpusim_torch.cli", "stream",
             "--synthetic-nodes", str(CONFIG11_STREAM["num_nodes"]),
             "--cycles", str(CONFIG11_STREAM["cycles"]),
             "--arrivals", str(CONFIG11_STREAM["arrivals"]),
             "--evict-fraction", str(CONFIG11_STREAM["evict_fraction"]),
             "--seed", str(CONFIG11_STREAM["seed"]), "--checkpoint-every",
             "5", "--checkpoint-dir", ckdir, "--replicate-to",
             f"127.0.0.1:{bind}", "--listen", f"127.0.0.1:{listen}",
             "--chaos-plan", plan_path], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children.append(leader)
        t_cli = time.perf_counter()
        for arrivals in CONFIG15["lag_arrivals"]:
            t0 = time.perf_counter()
            out = run_replicated_stream(
                device="cuda", checkpoint_every=CONFIG15["lag_cadence"],
                checkpoint_dir=os.path.join(root, f"lag-{arrivals}"),
                **dict(CONFIG11_STREAM, arrivals=arrivals))
            wall = time.perf_counter() - t0
            print(f"phase 36: config 15 lag, {arrivals} arrivals a cycle, "
                  f"checkpoint every {CONFIG15['lag_cadence']}: "
                  f"{out['lag_at_loop_end']} of {out['wal_records']} records "
                  f"unacked at the loop's end, drained {out['drained']}, "
                  f"{out['wal_records'] / wall:.1f} records/s shipped, "
                  f"cycle p50 {out['p50_cycle_ms']:.2f} ms, graphs "
                  f"{out['graphs']}; follower chain matches "
                  f"{out['follower_chain_matches']}; {wall:.3f}s wall; fold "
                  f"{out['fold_chain'][:16]} (want "
                  f"{gold['lag'][str(arrivals)][:16]}) on {card}")
            if not (out["drained"] and out["follower_chain_matches"]) \
                    or out["applied_records"] != out["wal_records"]:
                raise AssertionError(f"phase 36: the {arrivals}-arrival run "
                                     "did not drain to one chain")
            if out["fold_chain"] != gold["lag"][str(arrivals)]:
                raise AssertionError(f"phase 36: the {arrivals}-arrival "
                                     "chain differs from the JAX package's")
            if out["graphs"]["leader"] != out["graphs"]["follower"] \
                    or out["graphs"]["leader"] < 1:
                raise AssertionError(f"phase 36: the sides captured "
                                     f"{out['graphs']} graphs")

        # a fleet reading a follower's twin
        n = CONFIG11_STREAM["num_nodes"]
        follower = FollowerTwin(synthetic_cluster(n), device="cuda")
        session = StreamSession(synthetic_cluster(n), device="cuda")
        persist = StreamPersistence(os.path.join(root, "replica"),
                                    checkpoint_every=5)
        shipper = WalShipper(persist, follower.address)
        session.attach_persistence(persist)
        fleets = []
        try:
            gen = ChurnLoadGen(synthetic_cluster(n), seed=CONFIG15["seed"],
                               arrivals=CONFIG11_STREAM["arrivals"],
                               evict_fraction=0.25)
            for cycle in range(4):
                session.apply_events(gen.events(cycle))
                gen.note_bound(session.schedule(gen.batch()))
            if not shipper.drain(60.0):
                raise AssertionError("phase 36: the replica never caught up")
            rng = np.random.RandomState(36)
            pods = [make_pod(f"replica-q{i}",
                             milli_cpu=int(rng.randint(100, 1500)),
                             memory=int(rng.randint(2 ** 20, 2 ** 30)))
                    for i in range(REPLICA_REQUESTS)]
            fleet = ScenarioFleet(bucket_size=4, device="cuda")
            staged = ScenarioFleet(bucket_size=4, device="cuda")
            fleets += [fleet, staged]
            fleet.attach_stream(session)
            fleet.attach_replica(follower)
            staged.register_snapshot("base",
                                     follower.session.inc.to_snapshot())
            before = register().overlay_queries.values.get("follower", 0)
            t0 = time.perf_counter()
            answers = fleet.run([WhatIfRequest(pods=pods[:1 + i],
                                               snapshot_ref="live")
                                 for i in range(REPLICA_REQUESTS)])
            replica_ms = (time.perf_counter() - t0) * 1e3
            from_replica = int(register().overlay_queries.values.get(
                "follower", 0) - before)
            want_hashes = [placement_hash(r.result.placements)
                           for r in staged.run([
                               WhatIfRequest(pods=pods[:1 + i],
                                             snapshot_ref="base")
                               for i in range(REPLICA_REQUESTS)])]
            got = [placement_hash(r.result.placements) if r.ok else None
                   for r in answers]
            print(f"phase 36: ScenarioFleet.attach_replica: "
                  f"{from_replica}/{REPLICA_REQUESTS} requests answered from "
                  f"the follower's twin in {replica_ms:.1f} ms, hashes equal "
                  f"the staged answers {got == want_hashes} on {card}")
            if from_replica != REPLICA_REQUESTS or got != want_hashes:
                raise AssertionError("phase 36: the replica's answers differ "
                                     "or came from elsewhere")
        finally:
            for fl in fleets:
                fl.stop()
            shipper.close(drain=False)
            persist.close()
            follower.stop()

        # the CLI pair's end
        _, leader_err = leader.communicate(timeout=300)
        follow_out, follow_err = follow.communicate(timeout=300)
        lines = [ln for ln in follow_out.splitlines() if ln.startswith("{")]
        body = json.loads(lines[-1]) if lines else {}
        crashed = next((ln for ln in leader_err.splitlines()
                        if ln.startswith("crashed:")), "")
        print(f"phase 36: the CLI pair: `stream --replicate-to --listen "
              f"--chaos-plan` rc {leader.returncode} "
              f"({crashed[:90]}), "
              f"`follow --watch-leader` rc {follow.returncode}: promoted "
              f"{body.get('promoted')}, RTO "
              f"{body.get('rto_s', 0) * 1e3:.2f} ms, replayed "
              f"{body.get('replayed_records')} tail records, resumed at "
              f"cycle {body.get('resume_cycle')}, chain "
              f"{body.get('chain', '')[:16]} (want "
              f"{gold['cli_head'][:16]}); "
              f"{time.perf_counter() - t_cli:.1f}s from the leader's start")
        if leader.returncode != 3 or follow.returncode != 0 \
                or not body.get("promoted") \
                or body.get("promotion_violations") \
                or body.get("resume_cycle") != at + 1 \
                or body.get("chain") != gold["cli_head"]:
            raise AssertionError(f"phase 36: the CLI pair failed: "
                                 f"{leader_err[-400:]} {follow_err[-400:]}")
        launches = fastscan_chunk.launches
        print(f"phase 36: fused kernel launches over the phase: {launches} "
              f"(stream cycles take the resident scan)")
        if launches:
            raise AssertionError("phase 36: a stream cycle launched the "
                                 "fused kernel")
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
        shutil.rmtree(root, ignore_errors=True)


def shard_workload(api, gang=False):
    """Phase 37's feed on bench config 14's nodes: SHARD_CONFIG14's pods,
    or with `gang` the gang feed."""
    from tpusim_torch.gang.group import mark_gang
    from tpusim_torch.workloads import uniform_workload

    snapshot, pods = uniform_workload(api=api, **SHARD_CONFIG14)
    if gang:
        g = SHARD_GANG
        pods = pods[:g["solo"]] + [
            mark_gang(api.make_pod(f"g-{j}", milli_cpu=g["milli_cpu"]), "g")
            for j in range(g["members"])]
    return snapshot, pods


def shard_run(label):
    """Phase 37's main path on this process (k ranks when TPUSIM_SHARDS
    and the group say so, else the single-device route): the backend on
    config 14's prefix with an analytics plane and a recorder installed,
    then the gang feed through run_simulation, then a policy plan the
    sharded route declines. Returns the hash, choices golden, walls, spans,
    the tpusim_shard_* observations, the all_reduce count and time, the
    analytics sample and the gang split."""
    import torch
    import torch.distributed as dist

    import tpusim_torch.api.snapshot as api
    from tpusim_torch import workloads
    from tpusim_torch.backend import TorchBackend, placement_hash
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import analytics
    from tpusim_torch.obs import recorder as flight
    from tpusim_torch.simulator import run_simulation

    calls = {"n": 0, "s": 0.0}
    real = dist.all_reduce

    def counted(*args, **kwargs):
        t = time.perf_counter()
        out = real(*args, **kwargs)
        calls["n"] += 1
        calls["s"] += time.perf_counter() - t
        return out

    dist.all_reduce = counted
    m = register()
    snapshot, pods = shard_workload(api)
    rec = flight.install(flight.FlightRecorder())
    plane = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0,
        top_k=SHARD_ANALYTICS_TOP_K))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend = TorchBackend(route="scan", fallback="error")
        placements = backend.schedule(pods, snapshot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sample = plane.latest()
        problems = plane.verify_against_host()
        observed = (m.shard_count.value, dict(m.shard_node_occupancy.values),
                    m.shard_collective_bytes.value)
    finally:
        flight.uninstall()
        analytics.uninstall()
        dist.all_reduce = real
    spans = {}
    for ev in list(rec.events):
        if ev.get("ph") == "X" and ev["name"].startswith("shard:"):
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    sample.pop("ts", None)
    sample.pop("seq", None)
    choices = backend.last_choices
    gsnap, gpods = shard_workload(api, gang=True)
    rec = flight.install(flight.FlightRecorder())
    try:
        status = run_simulation(gpods, gsnap, backend="torch", route="scan")
    finally:
        flight.uninstall()
    gang = split_digest(status)
    gang_spans = sum(ev["name"] == "shard:gang_lanes"
                     for ev in list(rec.events))
    fsnap, fpods = workloads.random_policy_workload(42, 24, 11, api=api)
    before = m.shard_fallback.get("service_affinity")
    TorchBackend(route="scan", policy=decode_policy(
        workloads.random_policy(42, sa_entries=1))).schedule(fpods, fsnap)
    return {
        "label": label, "hash": placement_hash(placements),
        "golden": choices_golden(choices),
        "scheduled": int((choices >= 0).sum()), "wall": wall,
        "route": backend.last_route, "spans": spans,
        "shard_count": observed[0], "occupancy": observed[1],
        "bytes": observed[2], "all_reduces": calls["n"], "all_reduce_s": calls["s"],
        "sample": sample, "problems": problems,
        "gang": gang, "gang_spans": gang_spans,
        "sa_fallback": m.shard_fallback.get("service_affinity") - before,
    }


def shard_rank(rank, world):
    """A rank of phase 37 (sharding.run_ranks spawns it by name)."""
    os.environ["TPUSIM_SHARDS"] = str(world)
    return shard_run(f"k={world} rank {rank}")


def drive_sharded(card):
    """Phase 37: bench config 14's prefix on the node-sharded scan route at
    k = 1, 2 and 4, every rank on the one card: one placement hash, the
    JAX package's single-device golden, the tpusim_shard_* observations, a
    counted ServiceAffinity fallback, and analytics samples and a gang
    split equal to k = 1's. No speed is claimed: the ranks share a card."""
    sys.path.insert(0, HERE)
    from tpusim_torch.sharding import run_ranks

    t0 = time.perf_counter()
    os.environ.pop("TPUSIM_SHARDS", None)
    one = shard_run("k=1")
    golden, scheduled = SHARD_GOLDEN
    if (one["golden"], one["scheduled"]) != (golden, scheduled):
        raise AssertionError(f"phase 37: k=1 golden {one['golden']} with "
                             f"{one['scheduled']} scheduled, want {golden} "
                             f"with {scheduled}")
    if one["spans"] or one["all_reduces"] or one["problems"]:
        raise AssertionError(f"phase 37: the single-device route ran the "
                             f"sharded path: {one['spans']}, "
                             f"{one['all_reduces']} all_reduces, "
                             f"{one['problems']}")
    pods, nodes = SHARD_CONFIG14["num_pods"], SHARD_CONFIG14["num_nodes"]
    rows = [(1, [one])]
    for k in SHARD_COUNTS:
        t = time.perf_counter()
        ranks = run_ranks(shard_rank, k, timeout=SHARD_TIMEOUT_S)
        spawn_s = time.perf_counter() - t
        per = -(-nodes // k)
        for got in ranks:
            want_occ = {str(r): float(min(per, nodes - r * per))
                        for r in range(k)}
            checks = {
                "hash": got["hash"] == one["hash"],
                "golden": got["golden"] == golden,
                "route": got["route"] == "scan",
                "spans": set(got["spans"]) == {
                    "shard:stage", "shard:scan", "shard:topk_collective"},
                "shard_count": got["shard_count"] == k,
                "occupancy": got["occupancy"] == want_occ,
                "bytes": got["bytes"] == float(pods * (12 + k) * 8 * k),
                "analytics": got["sample"] == one["sample"]
                and got["problems"] == [],
                "gang": got["gang"] == one["gang"] and got["gang_spans"] >= 1,
                "sa_fallback": got["sa_fallback"] == 1,
            }
            bad = [name for name, ok in checks.items() if not ok]
            if bad:
                raise AssertionError(f"phase 37: {got['label']} differs "
                                     f"from k=1 in {bad}")
        rows.append((k, ranks))
        print(f"phase 37: k={k}: {k} ranks on the card under gloo, spawned "
              f"and joined in {spawn_s:.1f}s")
    for k, ranks in rows:
        r0 = ranks[0]
        calls = r0["all_reduces"]
        per_call = (r0["all_reduce_s"] / calls * 1e6) if calls else 0.0
        print(f"phase 37: config 14 prefix ({pods} pods x {nodes} nodes, "
              f"route scan) k={k}: golden {r0['golden']} "
              f"({r0['scheduled']} scheduled), hash {r0['hash'][:16]}, "
              f"wall {r0['wall']:.3f}s ({pods / r0['wall']:.1f} pods/s), "
              f"shard:stage {r0['spans'].get('shard:stage', 0.0):.1f} ms, "
              f"shard:scan {r0['spans'].get('shard:scan', 0.0):.1f} ms, "
              f"{calls} all_reduces ({calls / pods:.2f} a pod, "
              f"{per_call:.1f} us a call, "
              f"{r0['all_reduce_s'] / pods * 1e6:.1f} us a pod in them), "
              f"on {card}")
    print(f"phase 37: every rank at k={', '.join(map(str, SHARD_COUNTS))}: "
          f"k=1's hash and the JAX golden, the shard:stage, shard:scan and "
          f"shard:topk_collective spans, the tpusim_shard_* gauges, an "
          f"analytics sample equal to k=1's and to host_reduce, the gang "
          f"split {one['gang']} with its lanes sharded, a service_affinity "
          f"fallback counted")
    wall = time.perf_counter() - t0
    print(f"phase 37: {wall:.1f}s wall, against its {SHARD_BUDGET_S} s "
          f"budget")
    if wall > SHARD_BUDGET_S:
        raise AssertionError(f"phase 37: {wall:.1f}s is past its "
                             f"{SHARD_BUDGET_S} s budget")


def drive_replication_phases(card):
    """Phases 34-36 inside REPLICATION_BUDGET_S."""
    t0 = time.perf_counter()
    drive_audit(card)
    drive_tenancy(card)
    drive_replication(card)
    wall = time.perf_counter() - t0
    print(f"phases 34-36: {wall:.1f}s wall in all, against their "
          f"{REPLICATION_BUDGET_S} s budget")
    if wall > REPLICATION_BUDGET_S:
        raise AssertionError(f"phases 34-36: {wall:.1f}s is past their "
                             f"{REPLICATION_BUDGET_S} s budget")


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
    t_lap = [t_start]

    def lap(label):
        # the wall of the phases that print none of their own
        now = time.perf_counter()
        print(f"{label}: {now - t_lap[0]:.1f}s wall")
        t_lap[0] = now

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    build.load("fastscan.cu")
    print(f"phase 2: built {len(build.SOURCES)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f}s")

    max_err = compare_kernel_with_plain(cuda)
    lap("phases 1-3")

    launches, plan3 = drive_main_path("config3", card, cuda)
    _, plan4 = drive_main_path("config4_cpu_shape", card, cuda)

    # phase 6: the kernel against its plain version at the main path's
    # shapes (several nodes a thread), then its time on config 3's chunk
    timed = {}
    for name, plan in (("config3", plan3), ("config4_cpu_shape", plan4)):
        diff, *timed[name] = time_first_chunk(name, plan, card, cuda, 6)
        max_err = max(max_err, diff)
    lap("phases 4-6")

    # phases 7-8: the pod-group variant (Variants 2 and 4)
    group_err = compare_group_kernel_with_plain(cuda)
    group_launches, plan_g = drive_main_path("groups", card, cuda)
    diff, *timed["groups"] = time_first_chunk("groups", plan_g, card, cuda, 8)
    group_err = max(group_err, diff)
    lap("phases 7-8")

    # phases 9-10: the inter-pod variant (Variant 3)
    ip_err = compare_interpod_kernel_with_plain(cuda)
    ip_launches, plan_ip = drive_main_path("interpod", card, cuda)
    diff, *timed["interpod"] = time_first_chunk("interpod", plan_ip, card,
                                                cuda, 10)
    ip_err = max(ip_err, diff)
    lap("phases 9-10")

    # phases 11-12: the policy variant (Variant 5)
    pol_err = compare_policy_kernel_with_plain(cuda)
    pol_launches, plan_pol = drive_main_path("policy", card, cuda)
    diff, *timed["policy"] = time_first_chunk("policy", plan_pol, card, cuda,
                                              12)
    pol_err = max(pol_err, diff)
    lap("phases 11-12")

    # phase 13: the cluster at forced sizes on the hazard plans, folded into
    # each variant's error, then the cluster-size sweep
    hazard = compare_cluster_hazards(cuda)
    max_err = max(max_err, hazard["group_free"])
    group_err = max(group_err, hazard["groups"])
    ip_err = max(ip_err, hazard["interpod"])
    pol_err = max(pol_err, hazard["policy"])
    for name, plan in (("config3", plan3), ("policy", plan_pol)):
        cluster_sweep(name, plan, card, cuda)
    lap("phase 13")

    # phases 14-15: the exact sequential scan, against the kernel and alone
    compare_routes(card, cuda)
    drive_scan_route(card, cuda)
    lap("phases 14-15")

    # phase 16: the host route on this machine
    drive_host_route(card)
    lap("phase 16")

    # phase 17: the preemption hybrid
    drive_hybrid(card)
    lap("phase 17")

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

    # phases 25-27: event-log replay, the recorder and registry, serve's
    # live twins
    drive_obs_phases(card)

    # phases 28-29: decision provenance, the explain lanes and the
    # analytics plane
    drive_analytics_phases(card)

    # phases 30-31: the live-cluster snapshot, the watch fabric and the
    # live telemetry plane
    drive_live_phases(card)

    # phases 32-33: chaos on the card (the breaker in front of the kernel,
    # the stream and serve under faults) and the stream's durability
    drive_chaos_phases(card)

    # phases 34-36: the chain audit, multi-tenant residency and the hot
    # standby with leader failover
    drive_replication_phases(card)

    # phase 37: the node-sharded scan route, k ranks sharing the card
    drive_sharded(card)

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
