"""Command-line entry of the PyTorch port.

    python -m tpusim_torch.cli --podspec pods.yaml --synthetic-nodes 4 \
        [--scheduler-policy-file policy.json] [--device cpu] \
        [--backend torch|reference|auto] [--enable-pod-priority] \
        [--event-log events.jsonl] [--v 5] \
        [--trace-out trace.json] [--metrics-out metrics.prom]
    python -m tpusim_torch.cli --what-if manifest.json [--device cpu]
    python -m tpusim_torch.cli serve --synthetic-nodes 16 \
        --podspec pods.yaml [--requests 32] [--device cpu] \
        [--attach-stream [--stream-cycles 4 --stream-arrivals 16]]
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
provider. --event-log replays a watch-event log (JSON lines of wire
frames) on top of the snapshot before scheduling. --v sets the log
verbosity (2: INFO, 5: DEBUG with the host engine's per-node score dump).
--trace-out writes the flight recorder's timeline (Chrome trace JSON, or
JSON lines with a .jsonl name) and --metrics-out the metrics registry in
Prometheus text format after the run; serve and stream take both.
--explain-out appends a decision-provenance record a pod decision (JSON
lines; --explain-top-k K adds each placed pod's top K nodes with their
score parts, on the scan route), --analytics-out the cluster analytics
plane's samples; serve and stream take both. The explain subcommand
queries an --explain-out file:

    python -m tpusim_torch.cli explain explain.jsonl [--failed] [--summary]

--what-if runs a manifest of scenarios (a JSON list of {snapshot, podspec}
file pairs) through whatif.run_what_if and prints a line a scenario. The
serve subcommand stands up a serve.ScenarioFleet over one snapshot and
drives it with a synthetic load drawn from the podspec's pods (in process,
no network listener), printing a line a pass; --attach-stream answers the
load from a live streaming twin warmed by a few churn cycles. The stream subcommand drives
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
    parser.add_argument("--event-log", default="",
                        help="Watch-event log (JSON lines, the watch wire "
                             "frames: {type: Added|Modified|Deleted, "
                             "object: {kind: Pod|Node|Service|"
                             "PersistentVolume|PersistentVolumeClaim, ...}}) "
                             "replayed on top of the snapshot before "
                             "scheduling; on torch the replay drives the "
                             "incremental compile")
    parser.add_argument("--print-requirements", action="store_true",
                        help="Also print per-pod requirement spec")
    parser.add_argument("--quiet", action="store_true",
                        help="Only print the summary counts and timing")
    parser.add_argument("--v", type=int, default=0, dest="verbosity",
                        help="Log verbosity (glog analog): >=2 surfaces the "
                             "tpusim_torch loggers on stderr (slow-schedule "
                             "traces, backend routing); >=5 enables DEBUG "
                             "and the host engine's per-node score dump "
                             "(generic_scheduler.go:618-622,670-674)")
    add_obs_flags(parser, "the flight-recorder timeline")
    return parser


def add_obs_flags(parser, timeline: str) -> None:
    """The observability flags of the main command, serve and stream."""
    parser.add_argument("--trace-out", default="",
                        help=f"Write {timeline} after the run: Chrome "
                             "trace_event JSON (Perfetto-loadable), or a "
                             "raw span stream with a .jsonl extension")
    parser.add_argument("--metrics-out", default="",
                        help="Write the metrics registry in Prometheus text "
                             "exposition format after the run")
    add_explain_flags(parser)
    parser.add_argument("--analytics-out", default="",
                        help="Append cluster-analytics samples (one JSON "
                             "object a sample: per-resource utilization and "
                             "fragmentation, feasible nodes, the hottest "
                             "and coldest nodes, reduced on the device) to "
                             "this JSONL file")


def add_explain_flags(parser: argparse.ArgumentParser) -> None:
    """The decision-provenance flag pair."""
    parser.add_argument("--explain-out", default="",
                        help="Append decision-provenance records (one JSON "
                             "object a pod decision: why placed, or why "
                             "not, with the failure text byte-identical to "
                             "the host FitError) to this JSONL file; query "
                             "it with `explain FILE`")
    parser.add_argument("--explain-top-k", type=int, default=0,
                        help="Also record the top K candidate nodes of each "
                             "placed pod with each one's score by priority "
                             "(one-shot runs on the torch backend; routes "
                             "through the scan). 0 records failures and "
                             "placements only")


def _arm_observability(args):
    """Install the provenance log and the analytics plane the flags ask
    for; returns the teardown, which flushes their files and folds the last
    analytics sample into the tpusim_cluster_* gauges, so that a
    --metrics-out written after it carries them."""
    from tpusim_torch.obs import analytics, provenance

    explain_top_k = max(0, args.explain_top_k)
    if args.explain_out or explain_top_k:
        provenance.install(provenance.ProvenanceLog(
            top_k=explain_top_k, path=args.explain_out or None))
    if args.analytics_out:
        analytics.install(analytics.ClusterAnalytics(
            path=args.analytics_out))

    def teardown() -> None:
        if provenance.get_log() is not None:
            provenance.uninstall()   # close() flushes --explain-out
        if analytics.get() is not None:
            analytics.refresh_gauges()
            analytics.uninstall()    # close() flushes --analytics-out

    return teardown


def _write_metrics(path: str) -> None:
    from tpusim_torch.framework.metrics import register

    with open(path, "w") as f:
        f.write(register().expose())


def _start_trace(args, process_name: str = "tpusim"):
    """Install a flight recorder when --trace-out asks for one."""
    if not args.trace_out:
        return None
    from tpusim_torch.obs import recorder as flight

    return flight.install(flight.FlightRecorder(process_name=process_name))


def _drop_trace(recorder) -> None:
    """Uninstall the recorder of a run that failed, writing nothing."""
    if recorder is not None:
        from tpusim_torch.obs import recorder as flight

        flight.uninstall()


def _finish_obs(args, recorder) -> int:
    """Uninstall and write the recorder, then the metrics: 0, or 2 when a
    file cannot be written."""
    if recorder is not None:
        from tpusim_torch.obs import recorder as flight

        flight.uninstall()
        try:
            recorder.write(args.trace_out)
        except OSError as exc:
            print(f"error: failed to write trace: {exc}", file=sys.stderr)
            return 2
        if not getattr(args, "quiet", False):
            print(f"trace: {args.trace_out} "
                  f"({len(recorder.events)} events)", file=sys.stderr)
    if args.metrics_out:
        try:
            _write_metrics(args.metrics_out)
        except OSError as exc:
            print(f"error: failed to write metrics: {exc}", file=sys.stderr)
            return 2
    return 0


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
    parser.add_argument("--attach-stream", action="store_true",
                        help="Live-twin serving: hold the cluster resident "
                             "in a StreamSession, warm it with a few churn "
                             "cycles, and answer requests by overlay "
                             "queries on the resident carry (no per-request "
                             "staging; the staged path stays armed as the "
                             "fallback)")
    parser.add_argument("--stream-cycles", type=int, default=4,
                        help="Churn warm-up cycles for --attach-stream")
    parser.add_argument("--stream-arrivals", type=int, default=16,
                        help="Arrivals per --attach-stream warm-up cycle")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--quiet", action="store_true",
                        help="Only print the summary lines")
    add_obs_flags(parser, "the serve: span timeline")
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

    recorder = _start_trace(args, "tpusim-serve")
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
    ref = "base"
    if args.attach_stream:
        # live-twin serving: the fleet answers by overlay queries on a
        # resident StreamSession's carry. The twin and the churn generator
        # get object graphs of their own, shared with nothing else
        from tpusim_torch.stream import ChurnLoadGen, StreamSession

        twin_snap = ClusterSnapshot.from_obj(snapshot.to_obj())
        try:
            session = StreamSession(twin_snap,
                                    provider=args.algorithmprovider,
                                    policy=policy, device=args.device)
        except (KeyError, ValueError, RuntimeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        sgen = ChurnLoadGen(ClusterSnapshot.from_obj(snapshot.to_obj()),
                            seed=args.seed, arrivals=args.stream_arrivals,
                            evict_fraction=0.25)
        for c in range(max(1, args.stream_cycles)):
            session.apply_events(sgen.events(c))
            sgen.note_bound(session.schedule(sgen.batch()))
        fleet.attach_stream(session, ref="live")
        ref = "live"
        if not args.quiet:
            print(f"live twin: {max(1, args.stream_cycles)} warm-up churn "
                  f"cycles over {len(twin_snap.nodes)} nodes; overlay path "
                  "armed (staged fallback behind it)", file=sys.stderr)
    else:
        fleet.register_snapshot("base", snapshot)

    # the load: random-size queries drawn from the pod pool, each
    # cache-keyed, so that the warm repeats ride the caches
    rng = random.Random(args.seed)
    sizes = [rng.randint(1, len(pool)) for _ in range(args.requests)]
    make_load = lambda: [  # noqa: E731
        WhatIfRequest(pods=pool[:n], snapshot_ref=ref, policy=policy,
                      cache_key=f"load-{i}-{n}")
        for i, n in enumerate(sizes)]

    obs_teardown = _arm_observability(args)
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
        obs_teardown()

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
    if args.attach_stream:
        print(f"overlay: {stats['overlay_hits']} served from the resident "
              f"twin, {stats['overlay_fallbacks']} staged fallbacks")
    return _finish_obs(args, recorder) or exit_code


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
    add_obs_flags(parser, "the stream span timeline")
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

    recorder = _start_trace(args, "tpusim-stream")
    obs_teardown = _arm_observability(args)
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
        _drop_trace(recorder)
        print(f"error: {exc}", file=sys.stderr)
        return 2
    finally:
        obs_teardown()
    rc = _finish_obs(args, recorder)
    if rc:
        return rc

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


def _device_bound(args, pods, snapshot, events) -> bool:
    """Whether this invocation runs on the device routes: backend torch, or
    auto routing away from the host, sized after the event-log fold (node
    adds and deletes count)."""
    from tpusim_torch.api.types import Node
    from tpusim_torch.framework.store import ADDED, DELETED
    from tpusim_torch.simulator import auto_routes_to_host

    n_nodes = len(snapshot.nodes)
    for etype, obj in events or []:
        if isinstance(obj, Node):
            n_nodes += 1 if etype == ADDED else -1 if etype == DELETED else 0
    return (args.backend == "torch"
            or (args.backend == "auto" and not auto_routes_to_host(
                len(pods), n_nodes, args.enable_volume_scheduling)))


def build_explain_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim explain",
        description="Query a decision-provenance file (--explain-out "
                    "JSONL): why each pod placed where it did, or the "
                    "exact per-predicate failure text when it didn't")
    parser.add_argument("file", help="JSONL file written by --explain-out")
    parser.add_argument("--pod", default="",
                        help="Only records whose pod name contains this "
                             "substring ('ns/name' matches exactly)")
    parser.add_argument("--source", default="",
                        help="Only records from this capture source "
                             "(backend, stream, serve, ...)")
    parser.add_argument("--failed", action="store_true",
                        help="Only unschedulable decisions")
    parser.add_argument("--placed", action="store_true",
                        help="Only placed decisions")
    parser.add_argument("--limit", type=int, default=0,
                        help="Print at most the LAST N matching records "
                             "(0: all)")
    parser.add_argument("--summary", action="store_true",
                        help="Aggregate counts instead of per-record lines: "
                             "placed/failed by source, failure messages by "
                             "frequency")
    parser.add_argument("--json", action="store_true",
                        help="Emit matching records as JSON lines instead "
                             "of the human-readable rendering")
    return parser


def _format_explain_record(rec: dict) -> str:
    where = rec.get("source", "?")
    if rec.get("cycle") is not None:
        where += f" c{rec['cycle']}"
    head = f"#{rec.get('seq', '?')} [{where}] {rec.get('pod', '?')}"
    if rec.get("placed"):
        line = f"{head} -> {rec.get('node')}"
        top = rec.get("top_k") or []
        if top:
            best = top[0]
            parts = best.get("parts") or {}
            breakdown = ", ".join(f"{k}={v}" for k, v in parts.items() if v)
            line += (f"  (score {best.get('score')}"
                     + (f": {breakdown}" if breakdown else "") + ")")
            for alt in top[1:]:
                line += f"\n    runner-up {alt['node']} score {alt['score']}"
        return line
    return (f"{head} UNSCHEDULABLE [{rec.get('reason', '?')}]\n"
            f"    {rec.get('message', '')}")


def explain_cli(argv) -> int:
    """`explain`: offline queries over an --explain-out file."""
    import json
    from collections import Counter

    from tpusim_torch.obs.provenance import read_jsonl

    args = build_explain_parser().parse_args(argv)
    if args.failed and args.placed:
        print("error: --failed and --placed are mutually exclusive",
              file=sys.stderr)
        return 2

    def matches(rec: dict) -> bool:
        if args.pod:
            pod = rec.get("pod", "")
            if args.pod != pod and args.pod not in pod:
                return False
        if args.source and rec.get("source") != args.source:
            return False
        if args.failed and rec.get("placed"):
            return False
        if args.placed and not rec.get("placed"):
            return False
        return True

    try:
        records = [r for r in read_jsonl(args.file) if matches(r)]
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.summary:
        by_source: Counter = Counter()
        placed = failed = 0
        messages: Counter = Counter()
        nodes: Counter = Counter()
        for rec in records:
            by_source[rec.get("source", "?")] += 1
            if rec.get("placed"):
                placed += 1
                nodes[rec.get("node", "?")] += 1
            else:
                failed += 1
                messages[rec.get("message", "")] += 1
        print(f"{len(records)} decision(s): {placed} placed, "
              f"{failed} unschedulable")
        for source, n in by_source.most_common():
            print(f"  source {source}: {n}")
        if nodes:
            print("top nodes:")
            for node, n in nodes.most_common(10):
                print(f"  {n:6d}  {node}")
        if messages:
            print("failure messages:")
            for message, n in messages.most_common(10):
                print(f"  {n:6d}  {message}")
        return 0

    if args.limit > 0:
        records = records[-args.limit:]
    for rec in records:
        print(json.dumps(rec, sort_keys=True) if args.json
              else _format_explain_record(rec))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        return serve_cli(argv[1:])
    if argv and argv[0] == "stream":
        return stream_cli(argv[1:])
    if argv and argv[0] == "explain":
        return explain_cli(argv[1:])
    args = build_parser().parse_args(argv)
    if args.verbosity >= 2:
        # glog -v analog: the tpusim_torch loggers (slow-schedule traces,
        # backend routing) print on stderr from V(2); V(5) turns on DEBUG,
        # which includes the host engine's per-node score dump
        import logging

        logging.basicConfig(stream=sys.stderr, format="%(message)s")
        logging.getLogger("tpusim_torch").setLevel(
            logging.DEBUG if args.verbosity >= 5 else logging.INFO)
    if args.what_if:
        if args.event_log:
            print("error: --event-log cannot be combined with --what-if "
                  "(what-if scenarios carry their own snapshots)",
                  file=sys.stderr)
            return 2
        if args.trace_out:
            print("error: --trace-out cannot be combined with --what-if "
                  "(scenario runs share one process; their spans would "
                  "interleave on a single timeline)", file=sys.stderr)
            return 2
        rc = run_what_if_cli(args)
        if rc == 0 and args.metrics_out:
            rc = _finish_obs(args, None)
        return rc
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

    events = None
    if args.event_log:
        from tpusim_torch.framework.events import load_event_log

        try:
            events = load_event_log(args.event_log)
        except (OSError, ValueError) as exc:
            print(f"error: invalid event log: {exc}", file=sys.stderr)
            return 2

    if args.verbosity >= 5 and _device_bound(args, pods, snapshot, events):
        # the per-node score dump is a host-engine trace; the device routes
        # have no per-node observation point
        print("note: the per-node score dump (--v 5) is produced by "
              "the host engine; this run uses the device routes. Use "
              "--backend reference to see the dump.", file=sys.stderr)

    recorder = _start_trace(args)
    obs_teardown = _arm_observability(args)
    start = time.perf_counter()
    try:
        status = run_simulation(
            pods, snapshot, provider=args.algorithmprovider,
            backend=args.backend,
            enable_pod_priority=args.enable_pod_priority,
            enable_volume_scheduling=args.enable_volume_scheduling,
            policy=policy, events=events, feature_gates=feature_gates,
            device=args.device)
    except (ValueError, KeyError, RuntimeError, NotImplementedError) as exc:
        _drop_trace(recorder)
        print(f"error: {exc}", file=sys.stderr)
        return 2
    finally:
        obs_teardown()
    elapsed = time.perf_counter() - start
    rc = _finish_obs(args, recorder)
    if rc:
        return rc

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
