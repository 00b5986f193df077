#!/usr/bin/env python3
"""Record a placement golden of the PyTorch port's workloads with the JAX
package: the workload is built through tpusim.api.snapshot and scheduled by
JaxBackend(fallback="error") (its XLA scan on a CPU), under the scheduler
policy chip_smoke.py's POLICY names for it (the policy workload runs under
the upstream 1.2 policy), and the golden is sha256(choices as int32)[:16]
with the scheduled count, the form chip_smoke.py's GOLDENS hold.

    JAX_PLATFORMS=cpu python tools/port_golden.py groups 100000 5000

`quickstart` instead prints the digest of the JAX package's run_simulation
split of the reference quickstart on 4 synthetic nodes (chip_smoke.py
QUICKSTART_DIGEST):

    JAX_PLATFORMS=cpu python tools/port_golden.py quickstart

`config3_host N M` prints the split digest of the JAX package's
run_simulation(backend="reference") on config 3's first N pods on M nodes,
`config4_host N M` that of config 4's node-affinity shape
(build_workload(N, M, affinity=True)), and `config6 N M` that of config 6's
priority-banded feed (build_workload(N, M, affinity=True, priorities=True,
seed=777)) with PodPriority on, and its preempted count (chip_smoke.py
HOST_CONFIG3, HOST_CONFIG4, HOST_CONFIG6):

    JAX_PLATFORMS=cpu python tools/port_golden.py config3_host 200 5000
    JAX_PLATFORMS=cpu python tools/port_golden.py config4_host 300 8
    JAX_PLATFORMS=cpu python tools/port_golden.py config6 3000 150

`config6_hybrid N M` prints the same for the JAX package's preemption hybrid,
run_simulation(backend="jax", enable_pod_priority=True) on its XLA scan
(chip_smoke.py HYBRID_CONFIG6; about 25 s on a CPU at 20,000 x 1,000):

    JAX_PLATFORMS=cpu python tools/port_golden.py config6_hybrid 20000 1000

`config5 S N M` prints the combined digest (chip_smoke.combined_digest) of
the JAX package's run_what_if over S scenarios of build_workload(N, M,
seed=1000 + s), BASELINE config 5 at bench.py's CPU shape by default (8 x
5,000 x 500), and `config8` that of its ScenarioFleet over bench.py's config
8 load (64 requests of the first 1,001-2,000 pods of build_workload(2000,
200, seed=4242), buckets of 8), one placement hash a request in submission
order (chip_smoke.py WHATIF_CONFIG5, SERVE_CONFIG8):

    JAX_PLATFORMS=cpu python tools/port_golden.py config5
    JAX_PLATFORMS=cpu python tools/port_golden.py config8

`config9`, `config10` and `config13` print the placement_chain and the
fold_chain of the JAX package's run_stream_simulation at bench.py's CPU
shape of each stream cell (chip_smoke.py STREAM_GOLDENS: config 9's churn,
config 10's policy stream, config 13's gang stream on racked nodes):

    JAX_PLATFORMS=cpu python tools/port_golden.py config9

`gang_feed` prints the split digest of the JAX package's
run_simulation(backend="jax") on phase 23's one-shot gang feed
(chip_smoke.gang_feed on config 13's 2,000 racked nodes; chip_smoke.py
GANG_FEED_DIGEST):

    JAX_PLATFORMS=cpu python tools/port_golden.py gang_feed

`event_replay N M` prints the split digest of the JAX package's
run_simulation(backend="jax", events=...) on workloads.event_log_workload(N,
M) (config 3 with a watch-event log folded on top), and `event_hybrid N M`
that of its preemption hybrid on config 6's priority-banded feed with the
same kind of log, and its preempted count (chip_smoke.py EVENT_REPLAY,
EVENT_HYBRID):

    JAX_PLATFORMS=cpu python tools/port_golden.py event_replay 100000 5000
    JAX_PLATFORMS=cpu python tools/port_golden.py event_hybrid 20000 1000
"""

import hashlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.engine.policy import decode_policy  # noqa: E402
from tpusim.jaxe.backend import JaxBackend  # noqa: E402
from tpusim_torch import workloads  # noqa: E402

WORKLOADS = {"groups": workloads.groups_workload,
             "interpod": workloads.interpod_workload,
             "config3": workloads.build_workload,
             "policy": workloads.policy_workload,
             "hostname": workloads.hostname_workload}
POLICIES = {"policy": workloads.COMPAT_POLICIES["1.2"]}


def quickstart_digest():
    from chip_smoke import QUICKSTART_JSON, split_digest
    from tpusim.api.podspec import (
        expand_simulation_pods,
        parse_simulation_pods,
    )
    from tpusim.simulator import run_simulation

    pods = expand_simulation_pods(parse_simulation_pods(QUICKSTART_JSON),
                                  deterministic_ids=True)
    status = run_simulation(list(reversed(pods)), jax_api.synthetic_cluster(
        4, milli_cpu=4000, memory=16 * 1024**3), backend="jax")
    print(f"quickstart: digest {split_digest(status)}, "
          f"{len(status.successful_pods)} scheduled")
    return 0


def host_digest(name, num_pods, num_nodes):
    from chip_smoke import split_digest
    from tpusim.simulator import run_simulation

    t0 = time.perf_counter()
    priority = name.startswith("config6")
    kwargs = (dict(affinity=True, priorities=True, seed=777) if priority
              else {"config3_host": {}, "config4_host": dict(affinity=True)
                    }[name])
    snapshot, pods = workloads.build_workload(num_pods, num_nodes,
                                              api=jax_api, **kwargs)
    status = run_simulation(
        pods, snapshot, backend="jax" if name == "config6_hybrid"
        else "reference", enable_pod_priority=priority)
    print(f"{name}({num_pods}, {num_nodes}): digest {split_digest(status)}, "
          f"{len(status.successful_pods)} scheduled, "
          f"{len(status.failed_pods)} failed, "
          f"{len(status.preempted_pods)} preempted, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def config5_digest(num_scenarios=8, num_pods=5_000, num_nodes=500):
    from chip_smoke import combined_digest
    from tpusim.backends import placement_hash
    from tpusim.jaxe.whatif import run_what_if

    t0 = time.perf_counter()
    scenarios = [workloads.build_workload(num_pods, num_nodes,
                                          seed=1000 + s, api=jax_api)
                 for s in range(num_scenarios)]
    results = run_what_if(scenarios)
    digest = combined_digest(placement_hash(r.placements) for r in results)
    print(f"config5({num_scenarios} x {num_pods} x {num_nodes}): digest "
          f"{digest}, {sum(r.scheduled for r in results)} scheduled, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def config8_digest():
    from chip_smoke import SERVE_CONFIG8, combined_digest, serve_load
    from tpusim.backends import placement_hash
    from tpusim.serve import ScenarioFleet, WhatIfRequest

    t0 = time.perf_counter()
    params, bucket, _ = SERVE_CONFIG8
    snapshot, pool, load = serve_load(
        workloads.build_workload(api=jax_api, **params), WhatIfRequest)
    fleet = ScenarioFleet(bucket_size=bucket, flush_after_s=0.05)
    fleet.register_snapshot("base", snapshot)
    responses = fleet.run(load())
    bad = [r for r in responses if not r.ok]
    if bad:
        raise RuntimeError(f"config 8: {len(bad)} requests failed: "
                           f"{bad[0].error}")
    digest = combined_digest(placement_hash(r.result.placements)
                             for r in responses)
    print(f"config8({len(responses)} requests, bucket {bucket}): digest "
          f"{digest}, {sum(r.result.scheduled for r in responses)} "
          f"scheduled, {time.perf_counter() - t0:.1f} s")
    return 0


def stream_chains(name):
    from chip_smoke import STREAM_GOLDENS, stream_arguments
    from tpusim.simulator import run_stream_simulation

    t0 = time.perf_counter()
    params, _, _ = STREAM_GOLDENS[name]
    out = run_stream_simulation(
        **stream_arguments(params, jax_api, decode_policy))
    print(f"{name}({params}): placement_chain {out['placement_chain']}, "
          f"fold_chain {out['fold_chain']}, {out['scheduled']}/"
          f"{out['decisions']} scheduled, paths {out['paths']}, restages "
          f"{out['restages']}, {time.perf_counter() - t0:.1f} s")
    return 0


def gang_feed_digest():
    from chip_smoke import STREAM_CONFIG13, gang_feed, split_digest
    from tpusim.gang import group
    from tpusim.simulator import run_simulation

    t0 = time.perf_counter()
    status = run_simulation(
        gang_feed(jax_api, group),
        workloads.racked_cluster(STREAM_CONFIG13["racked"], api=jax_api),
        backend="jax")
    print(f"gang_feed: digest {split_digest(status)}, "
          f"{len(status.successful_pods)} scheduled, "
          f"{len(status.failed_pods)} failed, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def event_digest(name, num_pods, num_nodes):
    from chip_smoke import split_digest
    from tpusim.simulator import run_simulation

    t0 = time.perf_counter()
    hybrid = name == "event_hybrid"
    kwargs = dict(affinity=True, priorities=True, seed=777) if hybrid else {}
    snapshot, pods, events = workloads.event_log_workload(
        num_pods, num_nodes, api=jax_api, **kwargs)
    status = run_simulation(pods, snapshot, backend="jax", events=events,
                            enable_pod_priority=hybrid)
    print(f"{name}({num_pods}, {num_nodes}, {len(events)} events): digest "
          f"{split_digest(status)}, {len(status.successful_pods)} scheduled, "
          f"{len(status.failed_pods)} failed, "
          f"{len(status.preempted_pods)} preempted, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def main(argv):
    if argv[0] in ("event_replay", "event_hybrid"):
        return event_digest(argv[0], int(argv[1]), int(argv[2]))
    if argv[0] == "gang_feed":
        return gang_feed_digest()
    if argv[0] in ("config9", "config10", "config13"):
        return stream_chains(argv[0])
    if argv[0] == "quickstart":
        return quickstart_digest()
    if argv[0] == "config5":
        return config5_digest(*(int(a) for a in argv[1:]))
    if argv[0] == "config8":
        return config8_digest()
    if argv[0] in ("config3_host", "config4_host", "config6",
                   "config6_hybrid"):
        return host_digest(argv[0], int(argv[1]), int(argv[2]))
    name, num_pods, num_nodes = argv[0], int(argv[1]), int(argv[2])
    t0 = time.perf_counter()
    snapshot, pods = WORKLOADS[name](num_pods, num_nodes, api=jax_api)
    policy = POLICIES.get(name)
    placements = JaxBackend(
        fallback="error", policy=policy and decode_policy(policy)
    ).schedule(pods, snapshot)
    index = {n.name: i for i, n in enumerate(snapshot.nodes)}
    choices = np.array([index[p.node_name] if p.node_name else -1
                        for p in placements], dtype=np.int32)
    golden = hashlib.sha256(choices.tobytes()).hexdigest()[:16]
    print(f"{name}({num_pods}, {num_nodes}): golden {golden}, "
          f"{int((choices >= 0).sum())} scheduled, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
