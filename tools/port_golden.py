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

    JAX_PLATFORMS=cpu python tools/port_golden.py config3_host 100 5000
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
order (chip_smoke.py WHATIF_CONFIG5, SERVE_CONFIG8); `config8 N` that of
the load's first N requests (chip_smoke.py MESH_SERVE):

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

`explain NAME` prints the digest (chip_smoke.records_digest: the records
without their time stamps) of the decision-provenance records the JAX
package's JaxBackend writes with a ProvenanceLog of chip_smoke.EXPLAIN_TOP_K
lanes installed, on chip_smoke.EXPLAIN_CELLS[NAME] (config3: config 3's
first 8,192 pods on its 5,000 nodes; policy: the policy workload's first
2,048 under the upstream 1.2 policy; ~1-2 min each). `config12` prints
bench config 12's goldens (chip_smoke.CONFIG12): the placement chain of
the config 9 stream at 4,000 nodes (40 cycles of 64 arrivals), and at
bench.py's CPU shape (800 nodes, 24 cycles) the chain and the digest of the
analytics samples, one a cycle, decoded without their time stamps:

    JAX_PLATFORMS=cpu python tools/port_golden.py explain config3
    JAX_PLATFORMS=cpu python tools/port_golden.py config12

`config9_watch` prints the placement and fold chains of config 9's churn
fed to the JAX package's StreamSession only through its watch fabric, with
the node watch torn mid-run (chip_smoke.watch_stream), at each shape of
chip_smoke.WATCH_STREAM (~40 s). `live_cli` prints the digests
(chip_smoke.report_digest) of the JAX package's main command on
chip_smoke.LIVE_PODSPEC against chip_smoke.FakeApiServer serving
chip_smoke.live_cluster, through --kubeconfig, with the ConfigMap policy
(--scheduler-policy-configmap) and without it (chip_smoke.LIVE_CLI; ~2 min):

    JAX_PLATFORMS=cpu python tools/port_golden.py config9_watch
    JAX_PLATFORMS=cpu python tools/port_golden.py live_cli

`config11` prints bench config 11's goldens (chip_smoke.CONFIG11_GOLDEN):
the JAX package's answer to chip_smoke.CHAOS_SCRIPT's dispatch sequence
(the host's placement hash of every dispatch and the breaker's transitions,
JaxBackend behind install_chaos), its run_stream_simulation at
chip_smoke.CONFIG11_STREAM without faults (the fold chain) and under
chip_smoke.CONFIG11_FAULTS (fold chain, restages, breaker transitions), and
the digest (chip_smoke.combined_digest) of its ScenarioFleet's answers to
config 11's serve load without faults (~2-3 min):

    JAX_PLATFORMS=cpu python tools/port_golden.py config11

`config14 N M` records phase 37's golden the same way on bench config 14's
uniform workload (workloads.uniform_workload(N, M): identical pods on
identical nodes, so every step's selection is a round-robin over ties
across the whole node axis) with JaxBackend's single-device XLA scan
(TPUSIM_FAST=0, TPUSIM_SHARDS unset; chip_smoke.py SHARD_GOLDEN):

    JAX_PLATFORMS=cpu python tools/port_golden.py config14 512 8192

`config9_sharded` prints the placement_chain and the fold_chain of the JAX
package's single-device run_stream_simulation on phase 38's feed
(chip_smoke.SHARD_STREAM: bench config 9's stream at 4,000 nodes, 8 cycles
of 32 arrivals; TPUSIM_SHARDS unset; chip_smoke.py SHARD_STREAM_GOLDEN,
~10 s):

    JAX_PLATFORMS=cpu python tools/port_golden.py config9_sharded

`config15` prints the goldens of phases 34-36 (chip_smoke.CONFIG15_GOLDEN):
the digest (chip_smoke.audit_digest) of the JAX package's audit_wal_pair
(explain_k=3) of config 11's journal (checkpoint_every=0) against a copy
with cycle chip_smoke.AUDIT_FLIP_CYCLE's first bind flipped
(chip_smoke.flip_first_bind); chip_smoke.tenancy_pressure's evictions,
restores and final chains with the JAX package's ResidencyBudget; bench
config 15's fold chain at each checkpoint cadence of its RTO curve
(run_replicated_stream with the leader killed at
kill_leader_campaign(seed=11)'s emit point), the crash-free chain at each
arrival rate of its lag curve, and the chain head after the CLI pair's
crash cycle (~4-6 min):

    JAX_PLATFORMS=cpu python tools/port_golden.py config15
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
             "hostname": workloads.hostname_workload,
             "config14": workloads.uniform_workload}
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


def config8_digest(num_requests=None):
    from chip_smoke import (
        SERVE_CONFIG8,
        SERVE_REQUESTS,
        combined_digest,
        serve_load,
    )
    from tpusim.backends import placement_hash
    from tpusim.serve import ScenarioFleet, WhatIfRequest

    t0 = time.perf_counter()
    params, bucket, _ = SERVE_CONFIG8
    snapshot, pool, load = serve_load(
        workloads.build_workload(api=jax_api, **params), WhatIfRequest,
        num_requests or SERVE_REQUESTS)
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


def explain_digest(name):
    from chip_smoke import EXPLAIN_CELLS, EXPLAIN_TOP_K, records_digest
    from tpusim.obs import provenance

    t0 = time.perf_counter()
    workload, params, version, _ = EXPLAIN_CELLS[name]
    snapshot, pods = getattr(workloads, workload)(api=jax_api, **params)
    policy = workloads.COMPAT_POLICIES[version] if version else None
    log = provenance.install(provenance.ProvenanceLog(
        capacity=len(pods), top_k=EXPLAIN_TOP_K))
    try:
        JaxBackend(fallback="error", policy=policy and decode_policy(policy)
                   ).schedule(pods, snapshot)
        records = log.tail(len(pods))
    finally:
        provenance.uninstall()
    print(f"explain {name}({params}, top_k {EXPLAIN_TOP_K}): digest "
          f"{records_digest(records)}, {len(records)} records, "
          f"{sum(1 for r in records if r['placed'])} placed, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def config12_goldens():
    from chip_smoke import CONFIG12, STREAM_GOLDENS, records_digest
    from tpusim.obs import analytics
    from tpusim.simulator import run_stream_simulation

    t0 = time.perf_counter()
    params, _, _ = CONFIG12
    out = run_stream_simulation(**params)
    print(f"config12({params}): placement_chain {out['placement_chain']}, "
          f"{time.perf_counter() - t0:.1f} s")
    cpu_params = STREAM_GOLDENS["config9"][0]
    log = analytics.install(analytics.ClusterAnalytics(
        sample_interval_s=0.0))
    try:
        out = run_stream_simulation(**cpu_params)
        samples = log.series(limit=len(log.samples()))
    finally:
        analytics.uninstall()
    print(f"config12 CPU shape({cpu_params}): placement_chain "
          f"{out['placement_chain']}, {len(samples)} analytics samples, "
          f"digest {records_digest(samples)}, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def jax_watch_modules():
    """The JAX package's modules chip_smoke.watch_stream reads."""
    import types

    import tpusim.api.types as api_types
    import tpusim.backends as backends
    import tpusim.framework.events as events
    import tpusim.framework.restclient as restclient
    import tpusim.framework.store as store
    import tpusim.stream as stream

    return types.SimpleNamespace(api=jax_api, types=api_types, store=store,
                                 events=events, restclient=restclient,
                                 stream=stream, backends=backends)


def config9_watch_chains():
    from chip_smoke import WATCH_STREAM, watch_stream

    for shape, (params, _, _) in WATCH_STREAM.items():
        t0 = time.perf_counter()
        out = watch_stream(jax_watch_modules(), **params)
        print(f"config9_watch {shape}({params}): placement_chain "
              f"{out['placement_chain']}, fold_chain {out['fold_chain']}, "
              f"{out['scheduled']}/{out['decisions']} scheduled, relists "
              f"{out['relists']}, restages {out['restages']}, "
              f"{time.perf_counter() - t0:.1f} s")
    return 0


def live_cli_digests():
    import contextlib
    import io
    import tempfile

    from chip_smoke import (
        LIVE_POLICY,
        LIVE_TOKEN,
        FakeApiServer,
        live_cluster,
        live_configmaps,
        report_digest,
        write_live_files,
    )
    from tpusim.cli import main as cli_main

    nodes, served, _ = live_cluster(jax_api)
    server = FakeApiServer(nodes, served, live_configmaps(), LIVE_TOKEN)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig, podspec = write_live_files(tmp, server.url)
            for name, extra in (
                    ("policy", ["--scheduler-policy-configmap",
                                LIVE_POLICY[1]]),
                    ("provider", [])):
                t0 = time.perf_counter()
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli_main(["--kubeconfig", kubeconfig, "--podspec",
                                   podspec, "--backend", "jax", *extra])
                summary = out.getvalue().strip().splitlines()[-2]
                print(f"live_cli {name}: rc {rc}, digest "
                      f"{report_digest(out.getvalue())}, {summary}, "
                      f"{time.perf_counter() - t0:.1f} s")
    finally:
        server.stop()
    return 0


def config11_goldens():
    import json

    from chip_smoke import (
        CHAOS_SCRIPT,
        CONFIG11_FAULTS,
        CONFIG11_SERVE,
        CONFIG11_STREAM,
        combined_digest,
    )
    from tpusim.backends import placement_hash
    from tpusim.chaos import ChaosClock, DeviceFaultPlan, FaultPlan
    from tpusim.jaxe.backend import install_chaos, uninstall_chaos
    from tpusim.serve import ScenarioFleet, WhatIfRequest
    from tpusim.simulator import run_stream_simulation

    t0 = time.perf_counter()
    shape, plan, dispatches = CHAOS_SCRIPT
    snapshot, pods = workloads.uniform_workload(api=jax_api, **shape)
    breaker = install_chaos(DeviceFaultPlan(**plan))
    try:
        backend = JaxBackend()
        hashes = {placement_hash(backend.schedule(pods, snapshot))
                  for _ in range(dispatches)}
    finally:
        uninstall_chaos()
    assert len(hashes) == 1, hashes
    out = {"script": {"hash": hashes.pop(),
                      "transitions": [list(t) for t in breaker.transitions]}}
    clean = run_stream_simulation(**CONFIG11_STREAM)
    faulted = run_stream_simulation(
        chaos_plan=FaultPlan(seed=11, device=DeviceFaultPlan(
            **CONFIG11_FAULTS)), **CONFIG11_STREAM)
    out["stream"] = {"fold_chain": clean["fold_chain"],
                     "faulted_fold_chain": faulted["fold_chain"],
                     "restages": faulted["restages"],
                     "paths": faulted["paths"],
                     "transitions": [list(t) for t in
                                     faulted["breaker_transitions"]]}
    serve_snapshot = jax_api.synthetic_cluster(CONFIG11_SERVE["num_nodes"])
    pool = workloads.build_workload(8, CONFIG11_SERVE["num_nodes"],
                                    api=jax_api)[1]
    fleet = ScenarioFleet(bucket_size=CONFIG11_SERVE["bucket"],
                          clock=ChaosClock())
    fleet.register_snapshot("base", serve_snapshot)
    responses = fleet.run([
        WhatIfRequest(pods=pool[:1 + i % 4], snapshot_ref="base",
                      cache_key=f"r{i}")
        for i in range(CONFIG11_SERVE["requests"])])
    fleet.stop()
    out["serve_digest"] = combined_digest(
        [placement_hash(r.result.placements) for r in responses])
    print(json.dumps(out, sort_keys=True))
    print(f"config11: {time.perf_counter() - t0:.1f} s")
    return 0


def config15_goldens():
    import json
    import shutil
    import tempfile

    from chip_smoke import (
        AUDIT_FLIP_CYCLE,
        CONFIG11_STREAM,
        CONFIG15,
        audit_digest,
        flip_first_bind,
        journal_heads,
        tenancy_pressure,
    )
    from tpusim.chaos.plan import CRASH_POINTS, kill_leader_campaign
    from tpusim.framework.metrics import register
    from tpusim.obs.audit import audit_wal_pair
    from tpusim.simulator import run_replicated_stream, run_stream_simulation
    from tpusim.stream import ChurnLoadGen, ResidencyBudget

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="port-golden-config15-")
    try:
        a, b = os.path.join(root, "a"), os.path.join(root, "b")
        run_stream_simulation(**CONFIG11_STREAM, checkpoint_dir=a,
                              checkpoint_every=0)
        shutil.copytree(a, b)
        flip_first_bind(b, AUDIT_FLIP_CYCLE)
        out = {"audit": audit_digest(audit_wal_pair(a, b, explain_k=3))}
        plan = kill_leader_campaign(seed=CONFIG15["seed"],
                                    cycles=CONFIG11_STREAM["cycles"])[
            CRASH_POINTS.index("emit")]
        repl = {"cli_head": journal_heads(a)[plan.churn[0].at],
                "rto": {}, "lag": {}}
        tenancy, _ = tenancy_pressure(ResidencyBudget,
                                      jax_api.synthetic_cluster,
                                      ChurnLoadGen, register,
                                      os.path.join(root, "tenancy"))
        out["tenancy"] = {k: tenancy[k] for k in ("evictions", "restores",
                                                  "chains")}
        for every in CONFIG15["cadences"]:
            repl["rto"][str(every)] = run_replicated_stream(
                **CONFIG11_STREAM, chaos_plan=plan, checkpoint_every=every,
                checkpoint_dir=os.path.join(root, f"rto-{every}")
            )["fold_chain"]
        for arrivals in CONFIG15["lag_arrivals"]:
            repl["lag"][str(arrivals)] = run_stream_simulation(
                **dict(CONFIG11_STREAM, arrivals=arrivals))["fold_chain"]
        out["replication"] = repl
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out, sort_keys=True))
    print(f"config15: {time.perf_counter() - t0:.1f} s")
    return 0


def config9_sharded_chains():
    from chip_smoke import SHARD_STREAM
    from tpusim.simulator import run_stream_simulation

    os.environ.pop("TPUSIM_SHARDS", None)
    t0 = time.perf_counter()
    out = run_stream_simulation(**SHARD_STREAM)
    print(f"config9_sharded({SHARD_STREAM}): placement_chain "
          f"{out['placement_chain']}, fold_chain {out['fold_chain']}, "
          f"{out['scheduled']}/{out['decisions']} scheduled, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def main(argv):
    if argv[0] == "config9_sharded":
        return config9_sharded_chains()
    if argv[0] == "config15":
        return config15_goldens()
    if argv[0] == "config11":
        return config11_goldens()
    if argv[0] == "config9_watch":
        return config9_watch_chains()
    if argv[0] == "live_cli":
        return live_cli_digests()
    if argv[0] == "explain":
        return explain_digest(argv[1])
    if argv[0] == "config12":
        return config12_goldens()
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
        return config8_digest(*(int(a) for a in argv[1:]))
    if argv[0] in ("config3_host", "config4_host", "config6",
                   "config6_hybrid"):
        return host_digest(argv[0], int(argv[1]), int(argv[2]))
    name, num_pods, num_nodes = argv[0], int(argv[1]), int(argv[2])
    if name == "config14":
        # the single-device XLA scan: never the fused kernel, never a mesh
        os.environ["TPUSIM_FAST"] = "0"
        os.environ.pop("TPUSIM_SHARDS", None)
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
