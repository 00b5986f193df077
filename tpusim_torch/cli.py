"""Command-line entry of the PyTorch port.

    python -m tpusim_torch.cli --podspec pods.yaml --synthetic-nodes 4 \
        [--scheduler-policy-file policy.json] [--device cpu] \
        [--backend torch|reference|auto] [--enable-pod-priority]
    python -m tpusim_torch.cli --what-if manifest.json [--device cpu]
    python -m tpusim_torch.cli serve --synthetic-nodes 16 \
        --podspec pods.yaml [--requests 32] [--device cpu]
    python -m tpusim_torch.cli stream --synthetic-nodes 64 --cycles 50 \
        [--pipeline] [--verify] [--gang-size 3 --gang-count 1] [--device cpu]

prints the Successful/Failed pods report of the reference simulator
(cmd/app/server.go). --backend torch (the default) schedules on
TorchBackend: the CUDA kernels, or their plain PyTorch versions with
--device cpu; with --enable-pod-priority it runs the preemption hybrid
(preempt.run_with_preemption) there. --backend reference runs the host
orchestrator on the CPU, which also carries preemption, delayed volume
binding (--enable-volume-scheduling) and the feature gates
(--feature-gates); --backend auto picks the host for small workloads. The
cluster comes from a saved ClusterSnapshot (--snapshot), from nodes.json and
pods.json checkpoints (--nodes, --pods) or from synthetic nodes. A scheduler
Policy from a file (--scheduler-policy-file) or from a ConfigMap object
saved to a file (--scheduler-policy-configmap-file) replaces the algorithm
provider.

--what-if runs a manifest of scenarios (a JSON list of {snapshot, podspec}
file pairs) through whatif.run_what_if and prints a line a scenario. The
serve subcommand stands up a serve.ScenarioFleet over one snapshot and
drives it with a synthetic load drawn from the podspec's pods (in process,
no network listener), printing a line a pass. The stream subcommand drives
the streaming twin (stream.StreamSession) with seeded churn through
simulator.run_stream_simulation and prints its summary.
"""

from __future__ import annotations

import argparse
import sys
import time

from tpusim_torch.api.podspec import expand_simulation_pods, load_simulation_pods
from tpusim_torch.api.snapshot import (
    ClusterSnapshot,
    load_nodes_checkpoint,
    load_pods_checkpoint,
    synthetic_cluster,
)
from tpusim_torch.engine.policy import (
    PolicyError,
    load_policy_configmap_file,
    load_policy_file,
)
from tpusim_torch.framework.report import (
    cluster_capacity_review_print,
    get_report,
    spec_print,
)
from tpusim_torch.engine.providers import parse_feature_gates
from tpusim_torch.simulator import BACKENDS, run_simulation


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch",
        description="Cluster-capacity schedule simulation on the PyTorch/CUDA engine")
    parser.add_argument("--podspec", default="",
                        help="YAML/JSON file with [{name, pod, num}] entries")
    parser.add_argument("--algorithmprovider", default="DefaultProvider",
                        help="DefaultProvider | ClusterAutoscalerProvider | "
                             "TalkintDataProvider")
    # AlgorithmSource.Policy (simulator.go:383-424): a policy from a
    # serialized file, or from a ConfigMap object saved as JSON/YAML
    parser.add_argument("--scheduler-policy-file", default="",
                        help="schedulerapi/v1 Policy file (kind: Policy) "
                             "overriding the algorithm provider")
    parser.add_argument("--scheduler-policy-configmap-file", default="",
                        help="ConfigMap object (JSON/YAML) carrying the policy "
                             "under data['policy.cfg']")
    parser.add_argument("--namespace", default="default",
                        help="Namespace stamped onto simulated pods")
    parser.add_argument("--backend", default="torch", choices=BACKENDS,
                        help="Scheduling engine: torch (default: the device "
                             "routes on --device), reference (the host "
                             "orchestrator on the CPU) or auto (workloads "
                             "under TPUSIM_AUTO_THRESHOLD pods x nodes "
                             "[100k] on the host, larger ones on torch)")
    parser.add_argument("--enable-pod-priority", action="store_true",
                        help="Enable the PodPriority feature gate "
                             "(preemption): the preemption hybrid on "
                             "torch, the host orchestrator on reference")
    parser.add_argument("--enable-volume-scheduling", action="store_true",
                        help="Enable the VolumeScheduling feature gate "
                             "(CheckVolumeBinding + delayed PV binding); "
                             "reference backend only")
    parser.add_argument("--feature-gates", default="",
                        help="Comma-separated key=bool feature gates "
                             "(kube --feature-gates format): "
                             "TaintNodesByCondition, "
                             "ResourceLimitsPriorityFunction (registry "
                             "surgery, defaults.go:181-205), plus "
                             "PodPriority / VolumeScheduling as aliases "
                             "for the dedicated flags")
    # snapshot sources
    parser.add_argument("--snapshot", default="",
                        help="Combined ClusterSnapshot JSON ({nodes, pods, services})")
    parser.add_argument("--nodes", default="", help="nodes.json checkpoint")
    parser.add_argument("--pods", default="", help="pods.json checkpoint (Running pods)")
    parser.add_argument("--synthetic-nodes", type=int, default=0,
                        help="Generate N homogeneous synthetic nodes")
    parser.add_argument("--synthetic-milli-cpu", type=int, default=4000)
    parser.add_argument("--synthetic-memory", type=int, default=16 * 1024**3)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the CUDA kernels) or cpu (their "
                             "plain PyTorch versions)")
    parser.add_argument("--what-if", default="",
                        help="Batched multi-snapshot mode: a JSON manifest "
                             "[{snapshot, podspec}, ...], one scenario an "
                             "entry (whatif.run_what_if)")
    parser.add_argument("--print-requirements", action="store_true",
                        help="Also print per-pod requirement spec")
    parser.add_argument("--quiet", action="store_true",
                        help="Only print the summary counts and timing")
    return parser


def load_snapshot(args) -> ClusterSnapshot:
    if args.snapshot:
        return ClusterSnapshot.load(args.snapshot)
    snapshot = ClusterSnapshot()
    if args.nodes:
        snapshot.nodes = load_nodes_checkpoint(args.nodes)
    elif args.synthetic_nodes:
        snapshot.nodes = synthetic_cluster(
            args.synthetic_nodes, milli_cpu=args.synthetic_milli_cpu,
            memory=args.synthetic_memory).nodes
    if args.pods:
        snapshot.pods = load_pods_checkpoint(args.pods)
    return snapshot


def load_policy_from_args(args):
    """(policy or None, error text or None) from the policy flags."""
    try:
        if args.scheduler_policy_file:
            return load_policy_file(args.scheduler_policy_file), None
        if args.scheduler_policy_configmap_file:
            return load_policy_configmap_file(
                args.scheduler_policy_configmap_file), None
    except (OSError, PolicyError) as exc:
        return None, f"invalid scheduler policy: {exc}"
    return None, None


def run_what_if_cli(args) -> int:
    """--what-if: the manifest's scenarios through run_what_if."""
    import json

    from tpusim_torch.whatif import run_what_if

    try:
        with open(args.what_if) as f:
            manifest = json.load(f)
        if not isinstance(manifest, list) or not manifest:
            raise ValueError("manifest must be a non-empty JSON list")
        scenarios = []
        for entry in manifest:
            snapshot = ClusterSnapshot.load(entry["snapshot"])
            sim_pods = load_simulation_pods(entry["podspec"])
            pods = expand_simulation_pods(sim_pods, namespace=args.namespace)
            # run_simulation's LIFO feed order
            scenarios.append((snapshot, list(reversed(pods))))
    except (OSError, KeyError, TypeError, ValueError) as exc:
        print(f"error: invalid what-if manifest: {exc}", file=sys.stderr)
        return 2
    policy, policy_err = load_policy_from_args(args)
    if policy_err:
        print(f"error: {policy_err}", file=sys.stderr)
        return 2
    start = time.perf_counter()
    try:
        results = run_what_if(scenarios, provider=args.algorithmprovider,
                              policy=policy, device=args.device)
    except (KeyError, ValueError, RuntimeError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - start
    total = sum(r.total for r in results)
    for i, result in enumerate(results):
        print(f"scenario {i}: {result.scheduled} scheduled, "
              f"{result.unschedulable} unschedulable")
    rate = total / elapsed if elapsed > 0 else 0.0
    print(f"\n{len(results)} scenarios, {total} pods in one batched dispatch "
          f"[{elapsed:.3f}s, {rate:.0f} pods/s]")
    return 0


def build_serve_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch serve",
        description="Scenario fleet: run the what-if capacity service over "
                    "a snapshot and drive it with a synthetic request load "
                    "(in process, no network listener)")
    parser.add_argument("--snapshot", default="",
                        help="Combined ClusterSnapshot JSON ({nodes, pods})")
    parser.add_argument("--nodes", default="", help="nodes.json checkpoint")
    parser.add_argument("--synthetic-nodes", type=int, default=0,
                        help="Generate N homogeneous synthetic nodes")
    parser.add_argument("--synthetic-milli-cpu", type=int, default=4000)
    parser.add_argument("--synthetic-memory", type=int, default=16 * 1024**3)
    parser.add_argument("--podspec", required=True,
                        help="YAML/JSON [{name, pod, num}] entries: the pod "
                             "pool the load draws request workloads from")
    parser.add_argument("--algorithmprovider", default="DefaultProvider")
    parser.add_argument("--scheduler-policy-file", default="",
                        help="schedulerapi/v1 Policy file applied to every "
                             "request")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--requests", type=int, default=32,
                        help="Synthetic what-if requests to generate")
    parser.add_argument("--seed", type=int, default=0,
                        help="Load-generator seed (request sizes)")
    parser.add_argument("--bucket-size", type=int, default=4,
                        help="Scenarios a dispatched batched program")
    parser.add_argument("--flush-after-ms", type=float, default=50.0,
                        help="Deadline before a partial bucket dispatches "
                             "ghost-padded")
    parser.add_argument("--deadline-ms", type=float, default=0.0,
                        help="Fleet-wide request deadline: a request older "
                             "than this at staging or bucket time is "
                             "rejected instead of run (0: no deadline)")
    parser.add_argument("--max-queue", type=int, default=256,
                        help="Admission queue bound (backpressure)")
    parser.add_argument("--warm-repeats", type=int, default=1,
                        help="Extra passes over the same request set: repeat "
                             "traffic must ride the built programs and the "
                             "device-batch cache")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--quiet", action="store_true",
                        help="Only print the summary lines")
    return parser


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def serve_cli(argv) -> int:
    """`serve`: stand up a ScenarioFleet and drive it with a synthetic
    load."""
    import random

    args = build_serve_parser().parse_args(argv)
    try:
        if args.snapshot:
            snapshot = ClusterSnapshot.load(args.snapshot)
        elif args.nodes:
            snapshot = ClusterSnapshot(nodes=load_nodes_checkpoint(args.nodes))
        elif args.synthetic_nodes:
            snapshot = synthetic_cluster(
                args.synthetic_nodes, milli_cpu=args.synthetic_milli_cpu,
                memory=args.synthetic_memory)
        else:
            print("error: no cluster nodes; pass --snapshot, --nodes, or "
                  "--synthetic-nodes", file=sys.stderr)
            return 2
        sim_pods = load_simulation_pods(args.podspec)
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    pool = expand_simulation_pods(sim_pods, namespace=args.namespace)
    if not pool:
        print("error: podspec expands to zero pods", file=sys.stderr)
        return 2
    policy = None
    if args.scheduler_policy_file:
        try:
            policy = load_policy_file(args.scheduler_policy_file)
        except (OSError, PolicyError) as exc:
            print(f"error: invalid scheduler policy: {exc}", file=sys.stderr)
            return 2

    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    try:
        fleet = ScenarioFleet(provider=args.algorithmprovider,
                              bucket_size=args.bucket_size,
                              flush_after_s=args.flush_after_ms / 1000.0,
                              max_queue=args.max_queue,
                              deadline_s=(args.deadline_ms / 1000.0
                                          if args.deadline_ms > 0 else None),
                              device=args.device)
    except (KeyError, ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    fleet.register_snapshot("base", snapshot)

    # the load: random-size queries drawn from the pod pool, each
    # cache-keyed, so that the warm repeats ride the caches
    rng = random.Random(args.seed)
    sizes = [rng.randint(1, len(pool)) for _ in range(args.requests)]
    make_load = lambda: [  # noqa: E731
        WhatIfRequest(pods=pool[:n], snapshot_ref="base", policy=policy,
                      cache_key=f"load-{i}-{n}")
        for i, n in enumerate(sizes)]

    fleet.start()
    try:
        passes = []  # (label, elapsed, responses)
        for rep in range(1 + max(0, args.warm_repeats)):
            label = "cold" if rep == 0 else f"warm {rep}"
            start = time.perf_counter()
            futures = [fleet.submit(r) for r in make_load()]
            responses = [f.result(timeout=600) for f in futures]
            passes.append((label, time.perf_counter() - start, responses))
    finally:
        fleet.stop()

    stats = fleet.executor.stats
    exit_code = 0
    for label, elapsed, responses in passes:
        ok = [r for r in responses if r.ok]
        rejected = [r for r in responses if r.rejected is not None]
        errors = [r for r in responses if r.error and r.rejected is None]
        lat = sorted(r.latency_s for r in ok)
        rate = len(responses) / elapsed if elapsed > 0 else 0.0
        hits = sum(1 for r in ok if r.compile_cache_hit)
        print(f"{label}: {len(ok)}/{len(responses)} ok "
              f"({len(rejected)} rejected, {len(errors)} failed), "
              f"{rate:.1f} scenarios/s, latency p50/p90/max "
              f"{_percentile(lat, 0.5) * 1e3:.1f}/"
              f"{_percentile(lat, 0.9) * 1e3:.1f}/"
              f"{(lat[-1] if lat else 0.0) * 1e3:.1f} ms, "
              f"compile_cache_hit {hits}/{len(ok)}")
        if not args.quiet:
            for r in rejected[:5]:
                print(f"  rejected {r.request_id}: [{r.rejected}] {r.error}",
                      file=sys.stderr)
            for r in errors[:5]:
                print(f"  failed {r.request_id}: {r.error}", file=sys.stderr)
        if errors:
            exit_code = 1
    print(f"fleet: {stats['dispatches']} dispatches "
          f"({stats['warm_hits']} warm, {stats['device_batch_hits']} "
          f"device-resident), {stats['traces']} program builds, "
          f"{stats['staged_hits']} staged-cache hits")
    return exit_code


def build_stream_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch stream",
        description="The streaming twin: hold the compiled cluster resident "
                    "on the device and drive it with seeded churn "
                    "(arrivals, evictions, node flaps, label and taint "
                    "churn, gangs). Warm cycles commit the watch delta "
                    "instead of staging the cluster again")
    parser.add_argument("--snapshot", default="",
                        help="Combined ClusterSnapshot JSON ({nodes, pods})")
    parser.add_argument("--synthetic-nodes", type=int, default=64,
                        help="Generate N homogeneous synthetic nodes "
                             "(ignored with --snapshot)")
    # taken for the JAX package's command line, which reads neither: the
    # synthetic nodes are synthetic_cluster's defaults, and another value
    # is refused rather than ignored
    parser.add_argument("--synthetic-milli-cpu", type=int, default=4000,
                        help="Only the default, 4000, is accepted")
    parser.add_argument("--synthetic-memory", type=int, default=16 * 1024**3,
                        help="Only the default, 16 GiB, is accepted")
    parser.add_argument("--cycles", type=int, default=50,
                        help="Scheduling cycles to run")
    parser.add_argument("--arrivals", type=int, default=32,
                        help="Fresh pod arrivals per cycle")
    parser.add_argument("--evict-fraction", type=float, default=0.25,
                        help="Fraction of the arrival batch size evicted "
                             "from the bound pods per cycle")
    parser.add_argument("--flap-every", type=int, default=0,
                        help="Cordon and restore a random node every k-th "
                             "cycle (structural: classified restages; "
                             "0 = never)")
    parser.add_argument("--label-churn", type=int, default=0,
                        help="Rewrite N random nodes' labels per cycle "
                             "(absorbed by the statics commit)")
    parser.add_argument("--taint-churn", type=int, default=0,
                        help="Toggle a NoSchedule taint on N random nodes "
                             "per cycle (absorbed by the statics commit)")
    parser.add_argument("--gang-size", type=int, default=0,
                        help="Members per generated pod group (all-or-"
                             "nothing admission with rank-aware packing; "
                             "0 = no gangs)")
    parser.add_argument("--gang-count", type=int, default=0,
                        help="Pod groups appended to each cycle's arrivals "
                             "(with --gang-size)")
    parser.add_argument("--seed", type=int, default=0,
                        help="Load-generator seed")
    parser.add_argument("--algorithmprovider", default="DefaultProvider")
    parser.add_argument("--policy-file", default="",
                        help="Scheduler policy JSON (kube-scheduler "
                             "--policy-config-file shape), resident with "
                             "the twin")
    parser.add_argument("--pipeline", action="store_true",
                        help="Pipelined cycles: launch cycle N on the "
                             "device, decode cycle N-1 while it runs "
                             "(identical placements)")
    parser.add_argument("--always-restage", action="store_true",
                        help="No resident path: full compile and staging "
                             "every cycle (the comparison arm)")
    parser.add_argument("--verify", action="store_true",
                        help="Hold every cycle against a fresh "
                             "TorchBackend.schedule (placement_hash)")
    parser.add_argument("--whatif-every", type=int, default=0,
                        help="Answer a live what-if query on the resident "
                             "twin every N cycles (an overlay rolled back "
                             "after it; the chains are unchanged); 0 = none")
    parser.add_argument("--whatif-pods", type=int, default=4,
                        help="Pods per live what-if query")
    parser.add_argument("--json", action="store_true",
                        help="Print the whole summary as JSON")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def stream_cli(argv) -> int:
    """`stream`: seeded churn against the streaming twin."""
    args = build_stream_parser().parse_args(argv)
    if (args.synthetic_milli_cpu, args.synthetic_memory) != (4000,
                                                             16 * 1024**3):
        print("error: stream builds its synthetic nodes at 4000m and 16 GiB; "
              "--synthetic-milli-cpu and --synthetic-memory take no other "
              "value (give other nodes with --snapshot)", file=sys.stderr)
        return 2
    snapshot = policy = None
    try:
        if args.snapshot:
            snapshot = ClusterSnapshot.load(args.snapshot)
        if args.policy_file:
            policy = load_policy_file(args.policy_file)
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    from tpusim_torch.simulator import run_stream_simulation

    try:
        out = run_stream_simulation(
            snapshot, num_nodes=args.synthetic_nodes, cycles=args.cycles,
            arrivals=args.arrivals, evict_fraction=args.evict_fraction,
            node_flap_every=args.flap_every, seed=args.seed,
            label_churn=args.label_churn, taint_churn=args.taint_churn,
            gang_size=args.gang_size, gang_count=args.gang_count,
            provider=args.algorithmprovider, policy=policy,
            pipeline=args.pipeline, always_restage=args.always_restage,
            verify=args.verify, whatif_every=args.whatif_every,
            whatif_pods=args.whatif_pods, device=args.device)
    except (KeyError, ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.json:
        import json

        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        paths = ", ".join(f"{k} x{v}" for k, v in sorted(out["paths"].items()))
        restages = ", ".join(f"{k} x{v}"
                             for k, v in sorted(out["restages"].items()))
        print(f"{out['cycles']} cycles over {out['nodes']} nodes: "
              f"{out['scheduled']}/{out['decisions']} scheduled, "
              f"{out['decisions_per_s']:.0f} decisions/s, cycle p50/p99 "
              f"{out['p50_cycle_ms']:.1f}/{out['p99_cycle_ms']:.1f} ms")
        print(f"paths: {paths or 'none'}; restages: {restages or 'none'}; "
              f"{out['commits']} scatter commits")
        print(f"load: {out['load']['arrivals']} arrivals, "
              f"{out['load']['evictions']} evictions, "
              f"{out['load']['flaps']} flaps; "
              f"placement chain {out['placement_chain'][:16]}")
        if "overlay" in out:
            ov = out["overlay"]
            print(f"live what-if: {ov['answered']}/{ov['queries']} overlay "
                  f"queries answered ({ov['fallbacks']} fell back), query "
                  f"p50/p99 {ov['p50_query_ms']:.1f}/"
                  f"{ov['p99_query_ms']:.1f} ms")
    if args.verify:
        if out["verified"]:
            print("verify: every cycle placement_hash-identical to the "
                  "full-restage backend")
        else:
            print(f"verify: FAILED — {out['mismatched_cycles']} cycles "
                  "diverged from the full-restage backend", file=sys.stderr)
            return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        return serve_cli(argv[1:])
    if argv and argv[0] == "stream":
        return stream_cli(argv[1:])
    args = build_parser().parse_args(argv)
    if args.what_if:
        return run_what_if_cli(args)
    feature_gates = None
    if args.feature_gates:
        try:
            feature_gates = parse_feature_gates(args.feature_gates)
        except ValueError as exc:
            print(f"error: --feature-gates: {exc}", file=sys.stderr)
            return 2
        # PodPriority / VolumeScheduling gate the same behavior as the
        # dedicated flags (scheduler.go:175,210-213), before --backend auto
        # sizes the run
        if feature_gates.pop("PodPriority", False):
            args.enable_pod_priority = True
        if feature_gates.pop("VolumeScheduling", False):
            args.enable_volume_scheduling = True
    if not args.podspec:
        print("error: --podspec is required (or use --what-if)",
              file=sys.stderr)
        return 2
    try:
        snapshot = load_snapshot(args)
    except (OSError, ValueError) as exc:
        print(f"error: failed to load cluster snapshot: {exc}", file=sys.stderr)
        return 2
    if not snapshot.nodes:
        print("error: no cluster nodes; pass --snapshot, --nodes, or "
              "--synthetic-nodes", file=sys.stderr)
        return 2
    try:
        sim_pods = load_simulation_pods(args.podspec)
    except (OSError, ValueError) as exc:
        print(f"error: failed to parse podspec: {exc}", file=sys.stderr)
        return 2
    pods = expand_simulation_pods(sim_pods, namespace=args.namespace)
    policy, policy_err = load_policy_from_args(args)
    if policy_err:
        print(f"error: {policy_err}", file=sys.stderr)
        return 2

    start = time.perf_counter()
    try:
        status = run_simulation(
            pods, snapshot, provider=args.algorithmprovider,
            backend=args.backend,
            enable_pod_priority=args.enable_pod_priority,
            enable_volume_scheduling=args.enable_volume_scheduling,
            policy=policy, feature_gates=feature_gates, device=args.device)
    except (ValueError, KeyError, RuntimeError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - start

    report = get_report(status)
    if args.print_requirements and not args.quiet:
        spec_print(report.review["success"].spec)
        spec_print(report.review["failed"].spec)
    if not args.quiet:
        cluster_capacity_review_print(report)
    n_ok = len(status.successful_pods)
    n_fail = len(status.failed_pods)
    rate = (n_ok + n_fail) / elapsed if elapsed > 0 else 0.0
    engine = (f"torch backend on {args.device}" if args.backend == "torch"
              else f"{args.backend} backend")
    print(f"\n{n_ok} pod(s) scheduled, {n_fail} unschedulable, "
          f"{len(status.scheduled_pods)} pre-scheduled "
          f"[{engine}, {elapsed:.3f}s, {rate:.0f} pods/s]")
    print(f"StopReason: {status.stop_reason.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
