"""Command-line entry of the PyTorch port.

    python -m tpusim_torch.cli --podspec pods.yaml --synthetic-nodes 4 \
        [--scheduler-policy-file policy.json] [--device cpu] \
        [--backend torch|reference|auto] [--enable-pod-priority] \
        [--event-log events.jsonl] [--v 5] \
        [--trace-out trace.json] [--metrics-out metrics.prom] \
        [--chaos-plan plan.json | --chaos-seed N]
    python -m tpusim_torch.cli --what-if manifest.json [--device cpu] \
        [--mesh SNAPxNODE]
    python -m tpusim_torch.cli serve --synthetic-nodes 16 \
        --podspec pods.yaml [--requests 32] [--device cpu] \
        [--attach-stream [--stream-cycles 4 --stream-arrivals 16]] \
        [--mesh SCENARIOxNODE]
    python -m tpusim_torch.cli stream --synthetic-nodes 64 --cycles 50 \
        [--pipeline] [--verify] [--gang-size 3 --gang-count 1] [--device cpu] \
        [--listen 127.0.0.1:9100] [--slo-target-ms 30] \
        [--checkpoint-dir ck [--checkpoint-every 10] [--fsync-every N] \
         [--chaos-plan crash.json | --recover] [--replicate-to HOST:PORT]]
    python -m tpusim_torch.cli follow --synthetic-nodes 64 \
        [--bind 127.0.0.1:0] [--bootstrap] [--device cpu] \
        [--checkpoint-dir ck --watch-leader http://127.0.0.1:9100]
    python -m tpusim_torch.cli promote --checkpoint-dir ck \
        --synthetic-nodes 64 [--device cpu]
    python -m tpusim_torch.cli audit wal_dir_a wal_dir_b [--explain-k 3] \
        [--no-replay] [--json] [--out report.json] [--device cpu]
    python -m tpusim_torch.cli top 127.0.0.1:9100 [--once]
    python -m tpusim_torch.cli --kubeconfig kubeconfig.json --podspec pods.json \
        [--scheduler-policy-configmap NAME]

prints the Successful/Failed pods report of the reference simulator
(cmd/app/server.go). --backend torch (the default) schedules on
TorchBackend: the CUDA kernels, or their plain PyTorch versions with
--device cpu; with --enable-pod-priority it runs the preemption hybrid
(preempt.run_with_preemption) there. --backend reference runs the host
orchestrator on the CPU, which also carries preemption, delayed volume
binding (--enable-volume-scheduling) and the feature gates
(--feature-gates); --backend auto picks the host for small workloads. The
cluster comes from a saved ClusterSnapshot (--snapshot), from nodes.json and
pods.json checkpoints (--nodes, --pods), from synthetic nodes, or from a
live cluster's apiserver (--kubeconfig, or the in-cluster service account
under CC_INCLUSTER: its Running pods and all its nodes). A scheduler Policy
from a file (--scheduler-policy-file), from a ConfigMap object saved to a
file (--scheduler-policy-configmap-file) or from a live ConfigMap
(--scheduler-policy-configmap) replaces the algorithm provider.
--event-log replays a watch-event log (JSON lines of wire frames) on top
of the snapshot before scheduling. --v sets the log
verbosity (2: INFO, 5: DEBUG with the host engine's per-node score dump).
--trace-out writes the flight recorder's timeline (Chrome trace JSON, or
JSON lines with a .jsonl name) and --metrics-out the metrics registry in
Prometheus text format after the run; serve and stream take both.
--explain-out appends a decision-provenance record a pod decision (JSON
lines; --explain-top-k K adds each placed pod's top K nodes with their
score parts, on the scan route), --analytics-out the cluster analytics
plane's samples; serve and stream take both. The explain subcommand
queries an --explain-out file. serve and stream take --listen HOST:PORT,
which serves the live telemetry plane over HTTP (/metrics, /healthz,
/debug/provenance, /debug/trace, /analytics; obs/server.py), and
--slo-target-ms, which judges every cycle against a latency target; top
renders an endpoint's /analytics. explain:

    python -m tpusim_torch.cli explain explain.jsonl [--failed] [--summary]

--what-if runs a manifest of scenarios (a JSON list of {snapshot, podspec}
file pairs) through whatif.run_what_if and prints a line a scenario. The
serve subcommand stands up a serve.ScenarioFleet over one snapshot and
drives it with a synthetic load drawn from the podspec's pods (in
process), printing a line a pass; --attach-stream answers the
load from a live streaming twin warmed by a few churn cycles. The stream subcommand drives
the streaming twin (stream.StreamSession) with seeded churn through
simulator.run_stream_simulation and prints its summary.

Chaos: --chaos-plan (a fault-plan JSON) or --chaos-seed (a seeded plan
against the loaded workload) on the main command injects churn and fabric
faults into the host orchestrator and device faults behind the breaker,
prints a Chaos line and exits 1 on an invariant violation; serve
--chaos-plan arms the device section behind the fleet's retries and host
answers (a "degraded" count in the pass line); stream --chaos-plan takes
the device section and process_crash events, which need --checkpoint-dir:
the stream's WAL and checkpoints (stream.persist), from which --recover
resumes a crashed run (the crash exits 3 and prints the recover hint).

Replication (stream.replicate): stream --replicate-to ships the WAL to a
`follow` standby, which decides every shipped cycle again on its own twin
and, with --watch-leader, promotes itself when the leader's /healthz dies
(resume the run on the promoted directory with stream --recover); promote
does the promotion from a dead leader's directory alone. audit bisects two
WAL directories to their first divergent cycle and decides it again with
explain lanes (obs.audit); it exits 1 on a divergence.

Node sharding: the main command, serve, stream, follow, promote and audit
run as k ranks when a launcher starts them so (WORLD_SIZE > 1):

    TPUSIM_SHARDS=2 torchrun --nproc-per-node 2 -m tpusim_torch.cli \
        stream --synthetic-nodes 4000 --cycles 8

Each rank joins the launcher's process group over gloo (the ranks may
share one card) and runs the same command; TPUSIM_SHARDS=k shards the
scan route and the streaming twin's node axis over them. Rank 0 alone
prints the report, writes --trace-out, --metrics-out, --explain-out,
--analytics-out and audit's --out, and serves --listen. Rank r journals
to <dir>.rank<r> where rank 0 journals to the --checkpoint-dir named,
and its replication link takes the named port + r. Without a launcher
nothing joins a group, and TPUSIM_SHARDS=k counts the device_count
fallback.

The scenario mesh: --what-if --mesh SNAPxNODE splits the scenarios over
SNAP rows of ranks and each scenario's node columns over NODE ranks
(whatif.run_what_if's mesh); serve --mesh SCENARIOxNODE (or SCENARIO)
splits each bucket's scenarios over SCENARIO ranks, rank 0 cutting the
buckets (serve.ScenarioFleet's mesh). The mesh takes SNAP x NODE ranks of
the launcher's group; without a launcher a mesh of one rank (1x1) runs on
a group of one rank that the command makes and leaves.
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
    policy_from_configmap,
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
    # the reference's flags (options.go:67-71)
    parser.add_argument("--kubeconfig", default="",
                        help="Path to kubeconfig for a live-cluster snapshot "
                             "(Running pods across all namespaces + all nodes, "
                             "server.go:104-118); CC_INCLUSTER=1 uses the "
                             "in-cluster service-account config instead. "
                             "JSON, or YAML where PyYAML is installed")
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
    parser.add_argument("--scheduler-policy-configmap", default="",
                        help="Name of a ConfigMap to fetch the policy from the "
                             "live cluster API (simulator.go:402-415); needs "
                             "--kubeconfig or CC_INCLUSTER")
    parser.add_argument("--scheduler-policy-configmap-namespace",
                        default="kube-system",
                        help="Namespace of --scheduler-policy-configmap")
    parser.add_argument("--namespace", default="default",
                        help="Namespace stamped onto simulated pods")
    parser.add_argument("--backend", default="torch", choices=BACKENDS,
                        help="Scheduling engine: torch (default: the device "
                             "routes on --device), reference (the host "
                             "orchestrator on the CPU) or auto (workloads "
                             "under TPUSIM_AUTO_THRESHOLD pods x nodes "
                             "[100k] on the host, larger ones on torch)")
    parser.add_argument("--chaos-plan", default="",
                        help="Fault-plan JSON (tpusim_torch.chaos schema: "
                             "churn/fabric/device sections) injected into "
                             "the run; the summary line reports invariant "
                             "violations and a non-empty audit exits 1")
    parser.add_argument("--chaos-seed", type=int, default=None,
                        help="Generate a seeded adversarial fault plan "
                             "against the loaded workload instead of (or "
                             "overriding the seed of) --chaos-plan; "
                             "deterministic per seed")
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
    parser.add_argument("--mesh", default="",
                        help="What-if mesh 'SNAPxNODE' (e.g. 2x2): "
                             "scenarios split over SNAP rows of ranks, node "
                             "columns over NODE ranks with all_reduces "
                             "(sharding.make_mesh). Needs SNAP*NODE ranks "
                             "of a launcher's group; default single-device")
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


def add_obs_flags(parser, timeline: str, live: bool = False) -> None:
    """The observability flags of the main command, serve and stream; live
    adds the telemetry plane's pair (serve and stream)."""
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
    if not live:
        return
    parser.add_argument("--listen", default="",
                        help="Serve the live telemetry plane on HOST:PORT "
                             "(also ':PORT' or 'PORT'): GET /metrics "
                             "(Prometheus/OpenMetrics text), /healthz "
                             "(JSON liveness; 503 while the dispatch "
                             "breaker is open), /debug/provenance (recent "
                             "decision records), /debug/trace, /analytics")
    parser.add_argument("--slo-target-ms", type=float, default=0.0,
                        help="Arm the per-cycle latency SLO at this target: "
                             "publishes tpusim_slo_cycles_total{verdict} "
                             "and tpusim_slo_burn_rate, and drops "
                             "slo:burn_start/_end instants on the flight "
                             "recorder at burn-rate crossings (0: off)")


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
    """Install the provenance log, the analytics plane, the SLO tracker and
    the telemetry endpoint the flags ask for; returns the teardown, which
    stops the endpoint, flushes the files and folds the last analytics
    sample into the tpusim_cluster_* gauges, so that a --metrics-out
    written after it carries them."""
    from tpusim_torch.obs import analytics, provenance, slo

    server = None
    listen = getattr(args, "listen", "")
    slo_target_ms = getattr(args, "slo_target_ms", 0.0)
    explain_top_k = max(0, args.explain_top_k)
    # on rank r > 0 of a process group the planes are armed as on rank 0
    # (they choose routes and make collectives), but write no file and
    # serve no endpoint
    primary = _primary()
    # --listen alone arms an in-memory ring, so /debug/provenance serves
    # the recent decisions
    if args.explain_out or explain_top_k or listen:
        provenance.install(provenance.ProvenanceLog(
            top_k=explain_top_k,
            path=(args.explain_out or None) if primary else None))
    # and the analytics ring, so /analytics (and `top` against this
    # endpoint) serves live samples
    if args.analytics_out or listen:
        analytics.install(analytics.ClusterAnalytics(
            path=(args.analytics_out or None) if primary else None))
    if slo_target_ms > 0:
        slo.install(slo.SloTracker(slo_target_ms * 1000.0))
    if listen and primary:
        from tpusim_torch.obs.server import start_server

        server = start_server(listen)
        host, port = server.address
        print(f"telemetry: listening on http://{host}:{port} "
              "(/metrics /healthz /debug/provenance /analytics)",
              file=sys.stderr)

    def teardown() -> None:
        if provenance.get_log() is not None:
            provenance.uninstall()   # close() flushes --explain-out
        if analytics.get() is not None:
            analytics.refresh_gauges()
            analytics.uninstall()    # close() flushes --analytics-out
        if slo.get_tracker() is not None:
            slo.uninstall()
        if server is not None:
            server.stop()

    return teardown


def _write_metrics(path: str) -> None:
    from tpusim_torch.framework.metrics import register

    with open(path, "w") as f:
        f.write(register().expose())


def _start_trace(args, process_name: str = "tpusim"):
    """Install a flight recorder when --trace-out asks for one (on rank 0
    of a process group only)."""
    if not args.trace_out or not _primary():
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
    if args.metrics_out and _primary():
        try:
            _write_metrics(args.metrics_out)
        except OSError as exc:
            print(f"error: failed to write metrics: {exc}", file=sys.stderr)
            return 2
    return 0


def load_snapshot(args) -> ClusterSnapshot:
    if args.kubeconfig or os.environ.get("CC_INCLUSTER"):
        if args.snapshot or args.nodes or args.pods or args.synthetic_nodes:
            raise ValueError(
                "--kubeconfig/CC_INCLUSTER conflicts with "
                "--snapshot/--nodes/--pods/--synthetic-nodes; pick one "
                "snapshot source")
        # the reference's only network I/O: the initial checkpoint
        # (server.go:75-118); its Namespace field is never flag-bound, so
        # the pod list spans all namespaces, and --namespace only stamps
        # the simulated pods
        from tpusim_torch.api.kubeclient import snapshot_from_cluster

        return snapshot_from_cluster(kubeconfig=args.kubeconfig)
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
    """(policy or None, error text or None) from the three policy sources:
    a serialized Policy file, a ConfigMap object's file, or a live
    ConfigMap fetched from the cluster API (simulator.go:383-424)."""
    live_name = args.scheduler_policy_configmap
    try:
        if args.scheduler_policy_file:
            return load_policy_file(args.scheduler_policy_file), None
        if args.scheduler_policy_configmap_file:
            return load_policy_configmap_file(
                args.scheduler_policy_configmap_file), None
        if not live_name:
            return None, None
        # the live source: ConfigMaps(ns).Get(name) through the kube
        # client (simulator.go:402-406)
        if not (args.kubeconfig or os.environ.get("CC_INCLUSTER")):
            return None, ("--scheduler-policy-configmap needs a cluster "
                          "connection (--kubeconfig or CC_INCLUSTER)")
        from tpusim_torch.api.kubeclient import (
            KubeClient,
            in_cluster_config,
            load_kubeconfig,
        )
        config = (load_kubeconfig(args.kubeconfig) if args.kubeconfig
                  else in_cluster_config())
        try:
            client = KubeClient(config)
        finally:
            config.cleanup()
        ns = args.scheduler_policy_configmap_namespace
        try:
            obj = client.get_configmap(ns, live_name)
        except OSError as exc:
            return None, (f"couldn't get policy config map "
                          f"{ns}/{live_name}: {exc}")
        return policy_from_configmap(obj), None
    except (OSError, PolicyError) as exc:
        return None, f"invalid scheduler policy: {exc}"


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
    grid = None
    if args.mesh:
        grid = _mesh_grid(args.mesh, "SNAPxNODE", "e.g. 2x4",
                          node_default=None)
        if grid is None:
            return 2
    with _mesh_group(grid is not None):
        mesh = None
        if grid is not None:
            from tpusim_torch.sharding import make_mesh

            mesh = make_mesh(grid[0] * grid[1], snap=grid[0],
                             device_type=_mesh_device_type(args.device))
        start = time.perf_counter()
        try:
            results = run_what_if(scenarios, provider=args.algorithmprovider,
                                  policy=policy, device=args.device,
                                  mesh=mesh)
        except (KeyError, ValueError, RuntimeError,
                NotImplementedError) as exc:
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
    parser.add_argument("--chaos-plan", default="",
                        help="Fault-plan JSON, device section only: scripted "
                             "dispatch faults behind the serve retry + "
                             "circuit-breaker + host-fallback path")
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
    parser.add_argument("--mesh", default="",
                        help="Scenario mesh 'SCENARIOxNODE' (e.g. 2x1) or "
                             "just 'SCENARIO': split each bucket over the "
                             "mesh's scenario axis of ranks, rank 0 cutting "
                             "the buckets (sharding.make_scenario_mesh); "
                             "the bucket size must divide over it")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--quiet", action="store_true",
                        help="Only print the summary lines")
    add_obs_flags(parser, "the serve: span timeline", live=True)
    return parser


def _ranks_visible() -> int:
    """The ranks a mesh can take: the default group's, or 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _mesh_grid(spec: str, form: str, example: str, node_default):
    """(rows, nodes) of a --mesh spec, or None once the error is printed: a
    spec that does not parse, or more ranks than are visible."""
    try:
        rows_s, _, node_s = spec.lower().partition("x")
        rows = int(rows_s)
        node = int(node_s) if node_s or node_default is None \
            else node_default
        if rows < 1 or node < 1:
            raise ValueError
    except ValueError:
        want = (f"want '{form}' ({example}) or 'SCENARIO'"
                if node_default is not None else f"want '{form}', {example}")
        print(f"error: --mesh {spec!r}: {want}", file=sys.stderr)
        return None
    have = _ranks_visible()
    if rows * node > have:
        print(f"error: --mesh {spec} needs {rows * node} ranks, {have} "
              "visible", file=sys.stderr)
        return None
    return rows, node


def _mesh_device_type(device: str) -> str:
    from tpusim_torch.device import resolve_device

    return resolve_device(device).type


@contextlib.contextmanager
def _mesh_group(wanted: bool):
    """A default process group for a mesh: the launcher's where there is
    one, else a gloo group of this one rank, made here and left on exit
    (with the meshes built over it)."""
    import torch.distributed as dist

    if not wanted or dist.is_initialized():
        yield
        return
    import shutil
    import tempfile

    from tpusim_torch import sharding

    store = tempfile.mkdtemp(prefix="tpusim-mesh-")
    dist.init_process_group("gloo", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        sharding.forget_meshes()
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def serve_cli(argv) -> int:
    """`serve`: stand up a ScenarioFleet and drive it with a synthetic
    load."""
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

    grid = None
    if args.mesh:
        grid = _mesh_grid(args.mesh, "SCENARIOxNODE", "e.g. 8x1",
                          node_default=1)
        if grid is None:
            return 2
    breaker = None
    if args.chaos_plan:
        from tpusim_torch.backend import install_chaos
        from tpusim_torch.chaos import load_plan
        from tpusim_torch.chaos.plan import PlanError

        try:
            chaos_plan = load_plan(args.chaos_plan)
        except (OSError, PlanError, ValueError) as exc:
            print(f"error: --chaos-plan: {exc}", file=sys.stderr)
            return 2
        breaker = install_chaos(chaos_plan.device)
    try:
        with _mesh_group(grid is not None):
            mesh = None
            if grid is not None:
                from tpusim_torch.sharding import make_scenario_mesh

                mesh = make_scenario_mesh(
                    grid[0] * grid[1], scenario=grid[0],
                    device_type=_mesh_device_type(args.device))
            return _serve(args, snapshot, pool, policy, mesh)
    finally:
        if breaker is not None:
            from tpusim_torch.backend import uninstall_chaos

            uninstall_chaos()


def _serve(args, snapshot, pool, policy, mesh=None) -> int:
    import random

    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    recorder = _start_trace(args, "tpusim-serve")
    try:
        fleet = ScenarioFleet(provider=args.algorithmprovider,
                              bucket_size=args.bucket_size,
                              flush_after_s=args.flush_after_ms / 1000.0,
                              max_queue=args.max_queue,
                              deadline_s=(args.deadline_ms / 1000.0
                                          if args.deadline_ms > 0 else None),
                              device=args.device, mesh=mesh)
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
    passes = []  # (label, elapsed, responses)
    try:
        # on a mesh only rank 0 takes the load; the other ranks dispatch
        # its buckets until it stops the fleet
        for rep in range(1 + max(0, args.warm_repeats)
                         if fleet.controller else 0):
            label = "cold" if rep == 0 else f"warm {rep}"
            start = time.perf_counter()
            futures = [fleet.submit(r) for r in make_load()]
            responses = [f.result(timeout=600) for f in futures]
            passes.append((label, time.perf_counter() - start, responses))
    finally:
        fleet.stop()
        obs_teardown()
    if not fleet.controller:
        return 0

    stats = fleet.executor.stats
    exit_code = 0
    for label, elapsed, responses in passes:
        ok = [r for r in responses if r.ok]
        rejected = [r for r in responses if r.rejected is not None]
        errors = [r for r in responses if r.error and r.rejected is None]
        lat = sorted(r.latency_s for r in ok)
        rate = len(responses) / elapsed if elapsed > 0 else 0.0
        hits = sum(1 for r in ok if r.compile_cache_hit)
        degraded = sum(1 for r in ok if r.degraded)
        print(f"{label}: {len(ok)}/{len(responses)} ok "
              f"({len(rejected)} rejected, {len(errors)} failed"
              + (f", {degraded} degraded" if degraded else "") + "), "
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
          f"{stats['staged_hits']} staged-cache hits"
          + (f", mesh {mesh.size(0)}x{mesh.size(1)}"
             if mesh is not None else ""))
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
    parser.add_argument("--chaos-plan", default="",
                        help="Fault-plan JSON: device section plus "
                             "process_crash churn events (other churn/"
                             "fabric faults are the load generator's job)")
    parser.add_argument("--checkpoint-dir", default="",
                        help="Durability directory: every committed watch "
                             "delta and placement appends to a WAL here, "
                             "with periodic device-state checkpoints "
                             "(stream.persist)")
    parser.add_argument("--checkpoint-every", type=int, default=10,
                        help="Cycles between checkpoints (0: genesis "
                             "checkpoint only, WAL replay covers the rest)")
    parser.add_argument("--recover", action="store_true",
                        help="Recover from --checkpoint-dir (checkpoint + "
                             "WAL tail replay) and resume the interrupted "
                             "run; the fold chain proves placement parity "
                             "with the uninterrupted run")
    parser.add_argument("--fsync-every", type=int, default=0,
                        help="fsync the WAL every N appends (0: flush-only "
                             "durability); the mode is stamped into every "
                             "checkpoint manifest")
    parser.add_argument("--replicate-to", default="",
                        help="HOST:PORT of a listening `follow` standby: "
                             "ship every WAL record and checkpoint manifest "
                             "over the replication protocol "
                             "(stream.replicate) and drain the acks before "
                             "exiting; requires --checkpoint-dir")
    parser.add_argument("--json", action="store_true",
                        help="Print the whole summary as JSON")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    add_obs_flags(parser, "the stream span timeline", live=True)
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
    snapshot = policy = chaos_plan = None
    try:
        if args.snapshot:
            snapshot = ClusterSnapshot.load(args.snapshot)
        if args.policy_file:
            policy = load_policy_file(args.policy_file)
        if args.chaos_plan:
            from tpusim_torch.chaos import load_plan
            from tpusim_torch.chaos.plan import PlanError

            try:
                chaos_plan = load_plan(args.chaos_plan)
            except PlanError as exc:
                print(f"error: --chaos-plan: {exc}", file=sys.stderr)
                return 2
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    replicate_to = None
    if args.replicate_to:
        from tpusim_torch.obs.server import parse_listen

        if not args.checkpoint_dir:
            print("error: --replicate-to ships the WAL; pass "
                  "--checkpoint-dir", file=sys.stderr)
            return 2
        try:
            replicate_to = _rank_address(parse_listen(args.replicate_to))
        except ValueError:
            print(f"error: --replicate-to {args.replicate_to!r}: want "
                  "HOST:PORT", file=sys.stderr)
            return 2

    from tpusim_torch.chaos.engine import ProcessCrash
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
            verify=args.verify, chaos_plan=chaos_plan,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_every=args.checkpoint_every,
            fsync_every=args.fsync_every, replicate_to=replicate_to,
            recover=args.recover, whatif_every=args.whatif_every,
            whatif_pods=args.whatif_pods, device=args.device)
    except ProcessCrash as exc:
        # the scripted kill: the state up to the crash is durable in the
        # WAL; run again with --recover to resume from it
        _drop_trace(recorder)
        print(f"crashed: {exc}", file=sys.stderr)
        print(f"recover with: tpusim_torch stream --checkpoint-dir "
              f"{args.checkpoint_dir} --recover ...", file=sys.stderr)
        return 3
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
        if out.get("recovered"):
            print(f"recovered: resumed at cycle {out['resume_cycle']} "
                  f"({len(out['recomputed_cycles'])} cycles recomputed, "
                  f"replay {out['replay_ms']:.1f} ms); fold chain "
                  f"{out['fold_chain'][:16]}")
        elif "wal_records" in out:
            print(f"durability: {out['wal_records']} WAL records, "
                  f"{out['checkpoints']} checkpoints; fold chain "
                  f"{out['fold_chain'][:16]}")
        if "replication_acked_seq" in out:
            parity = (out["replication_acked_chain"] == out["fold_chain"])
            print(f"replication: acked through seq "
                  f"{out['replication_acked_seq']}, lag "
                  f"{out['replication_lag_at_close']} record(s) at close; "
                  f"follower chain "
                  f"{'matches' if parity else 'DIVERGED from'} the leader")
    if args.verify:
        if out["verified"]:
            print("verify: every cycle placement_hash-identical to the "
                  "full-restage backend")
        else:
            print(f"verify: FAILED — {out['mismatched_cycles']} cycles "
                  "diverged from the full-restage backend", file=sys.stderr)
            return 1
    return 0


def _add_follow_snapshot_flags(parser: argparse.ArgumentParser) -> None:
    """The twin's snapshot source: it MUST reproduce the leader's cycle-0
    picture (the same --snapshot file or the same synthetic parameters),
    as the shipper replays the journal from its first record."""
    parser.add_argument("--snapshot", default="",
                        help="Combined ClusterSnapshot JSON: the leader's "
                             "cycle-0 snapshot source")
    parser.add_argument("--synthetic-nodes", type=int, default=64,
                        help="Generate N homogeneous synthetic nodes "
                             "(must match the leader's)")
    parser.add_argument("--synthetic-milli-cpu", type=int, default=4000)
    parser.add_argument("--synthetic-memory", type=int, default=16 * 1024**3)
    parser.add_argument("--seed-label-universe", action="store_true",
                        help="Seed the churn label universe across the "
                             "synthetic nodes (needed when the leader runs "
                             "--policy-file or label or taint churn)")
    parser.add_argument("--algorithmprovider", default="DefaultProvider")
    parser.add_argument("--policy-file", default="",
                        help="Scheduler policy JSON: must match the "
                             "leader's (the twin decides every cycle again)")
    parser.add_argument("--always-restage", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--json", action="store_true",
                        help="Print the summary as JSON")


def _load_follow_snapshot(args):
    policy = None
    if args.snapshot:
        snapshot = ClusterSnapshot.load(args.snapshot)
    else:
        snapshot = synthetic_cluster(
            args.synthetic_nodes, milli_cpu=args.synthetic_milli_cpu,
            memory=args.synthetic_memory)
    if args.policy_file:
        policy = load_policy_file(args.policy_file)
    if not args.snapshot and (policy is not None
                              or args.seed_label_universe):
        from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE

        # the leader's run_stream_simulation seeds synthetic nodes the same
        # way: both twins' cold starts must intern the same label domains
        for i, node in enumerate(snapshot.nodes):
            node.metadata.labels.update(
                {k: vals[i % len(vals)]
                 for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
    return snapshot, policy


def build_follow_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch follow",
        description="Hot standby: listen for a leader's WAL-shipping stream "
                    "(stream --replicate-to) and decide every shipped cycle "
                    "again on a live scheduler twin, checking the placement "
                    "chain cycle by cycle (stream.replicate). With "
                    "--watch-leader, promote when the leader's /healthz "
                    "dies")
    parser.add_argument("--bind", default="127.0.0.1:0",
                        help="HOST:PORT the replication listener binds "
                             "(':0' picks a free port, printed at start)")
    parser.add_argument("--checkpoint-dir", default="",
                        help="The LEADER's durability directory (shared "
                             "storage): promotion replays its WAL tail and "
                             "journals on into it; required with "
                             "--watch-leader")
    parser.add_argument("--watch-leader", default="",
                        help="The leader's /healthz URL (http://HOST:PORT): "
                             "probe it and promote this twin when it misses "
                             "--misses probes in a row")
    parser.add_argument("--watch-interval", type=float, default=0.25,
                        help="Seconds between the leader's probes")
    parser.add_argument("--misses", type=int, default=2,
                        help="Probe misses in a row that declare death")
    parser.add_argument("--watch-timeout", type=float, default=0.0,
                        help="Give up watching after this many seconds "
                             "(0: watch forever)")
    parser.add_argument("--checkpoint-every", type=int, default=10,
                        help="The checkpoint cadence after promotion")
    parser.add_argument("--fsync-every", type=int, default=0,
                        help="The WAL's fsync cadence after promotion")
    parser.add_argument("--bootstrap", action="store_true",
                        help="Late join: ask for the leader's latest "
                             "checkpoint manifest and WAL offset in the "
                             "hello exchange and rebuild the twin from it, "
                             "instead of replaying from a cycle-0 snapshot "
                             "(--snapshot/--synthetic-nodes are then "
                             "ignored)")
    _add_follow_snapshot_flags(parser)
    add_obs_flags(parser, "the follower's span timeline (replay spans "
                          "carry the leader's trace ids)", live=True)
    return parser


def follow_cli(argv) -> int:
    """`follow`: a live standby twin."""
    import json

    args = build_follow_parser().parse_args(argv)
    if args.watch_leader and not args.checkpoint_dir:
        print("error: --watch-leader promotes from the leader's WAL; pass "
              "--checkpoint-dir (the shared durability directory)",
              file=sys.stderr)
        return 2

    from tpusim_torch.obs.server import parse_listen

    try:
        bind = _rank_address(parse_listen(args.bind))
        snapshot, policy = _load_follow_snapshot(args)
        if args.bootstrap:
            snapshot = None   # the shipped manifest is the twin's source
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    from tpusim_torch.sharding import rank_directory
    from tpusim_torch.stream.replicate import (
        FailoverController,
        FollowerTwin,
        PromotionRefused,
        http_probe,
    )

    recorder = _start_trace(args, "tpusim-follow")
    obs_teardown = _arm_observability(args)
    try:
        try:
            follower = FollowerTwin(snapshot,
                                    provider=args.algorithmprovider,
                                    policy=policy,
                                    always_restage=args.always_restage,
                                    listen=bind, bootstrap=args.bootstrap,
                                    device=args.device)
        except (KeyError, ValueError, OSError, RuntimeError) as exc:
            _drop_trace(recorder)
            recorder = None
            print(f"error: {exc}", file=sys.stderr)
            return 2
        host, port = follower.address
        print(f"follower: replication listener on {host}:{port} (leader "
              f"side: tpusim_torch stream --replicate-to {host}:{port})",
              file=sys.stderr, flush=True)

        def summary(extra=None) -> dict:
            body = {"applied_records": follower.wal_records_applied,
                    "cycles_emitted": follower.cycles_emitted,
                    "chain": follower.chain,
                    "scheduled": follower.scheduled,
                    "decisions": follower.decisions,
                    "divergence": follower.diverged}
            body.update(extra or {})
            return body

        if args.watch_leader:
            url = args.watch_leader.rstrip("/")
            if "://" not in url:   # a bare HOST:PORT (the --listen form)
                url = "http://" + url
            if not url.endswith("/healthz"):
                url += "/healthz"
            controller = FailoverController(
                http_probe(url), [follower],
                rank_directory(args.checkpoint_dir),
                interval_s=max(0.01, args.watch_interval),
                misses=max(1, args.misses),
                checkpoint_every=args.checkpoint_every,
                fsync_every=args.fsync_every)
            timeout = args.watch_timeout if args.watch_timeout > 0 else 1e9
            try:
                _, report = controller.run(timeout=timeout)
            except TimeoutError as exc:
                print(f"{exc}; exiting without promotion", file=sys.stderr)
                follower.stop()
                out = summary({"promoted": False})
                print(json.dumps(out, sort_keys=True) if args.json
                      else f"follower: applied {out['applied_records']} "
                           f"records, chain {out['chain'][:16]}")
                return 0
            except PromotionRefused as exc:
                follower.stop()
                print(f"error: promotion refused: {exc}", file=sys.stderr)
                return 1
            out = summary({
                "promoted": True, "rto_s": report.rto_s,
                "resume_cycle": report.resume_cycle,
                "replayed_records": report.tail_records,
                "recomputed_cycles": list(report.recomputed),
                "settled_live_cycles": list(report.settled_live),
                "promotion_violations": list(report.violations)})
            follower.persist.close()
            if args.json:
                print(json.dumps(out, sort_keys=True))
            else:
                print(f"promoted: resumed at cycle {out['resume_cycle']} "
                      f"(replayed {out['replayed_records']} tail records, "
                      f"RTO {out['rto_s'] * 1e3:.1f} ms); chain "
                      f"{out['chain'][:16]}")
                print(f"resume the churn load with: tpusim_torch stream "
                      f"--checkpoint-dir {args.checkpoint_dir} --recover "
                      "...")
            return 1 if out["promotion_violations"] else 0

        try:
            while follower.error is None:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        follower.stop()
        if follower.error is not None:
            print(f"error: the follower twin failed: {follower.error}",
                  file=sys.stderr)
            return 1
        out = summary()
        print(json.dumps(out, sort_keys=True) if args.json
              else f"follower: applied {out['applied_records']} records "
                   f"over {out['cycles_emitted']} cycles, chain "
                   f"{out['chain'][:16]}"
                   + (f"; DIVERGED: {out['divergence']}"
                      if out["divergence"] else ""))
        return 1 if out["divergence"] else 0
    finally:
        obs_teardown()
        _finish_obs(args, recorder)


def build_promote_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch promote",
        description="Promotion from durable state: replay a dead leader's "
                    "whole WAL (its checkpoint directory) through a fresh "
                    "twin by the promotion path: the chain checked against "
                    "the durable checkpoint manifest, the crash tail's "
                    "cycles decided again, a fresh checkpoint written. "
                    "Resume the run afterwards with `stream --recover`")
    parser.add_argument("--checkpoint-dir", required=True,
                        help="The dead leader's durability directory")
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument("--fsync-every", type=int, default=0)
    parser.add_argument("--metrics-out", default="",
                        help="Write the metric families (tpusim_replication_* "
                             "among them) after the promotion")
    _add_follow_snapshot_flags(parser)
    return parser


def promote_cli(argv) -> int:
    """`promote`: a one-shot promotion from durable state."""
    import json

    args = build_promote_parser().parse_args(argv)
    try:
        snapshot, policy = _load_follow_snapshot(args)
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    from tpusim_torch.stream.replicate import FollowerTwin, PromotionRefused

    try:
        follower = FollowerTwin(snapshot, provider=args.algorithmprovider,
                                policy=policy,
                                always_restage=args.always_restage,
                                device=args.device)
    except (KeyError, ValueError, OSError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    from tpusim_torch.sharding import rank_directory

    try:
        report = follower.promote(rank_directory(args.checkpoint_dir),
                                  checkpoint_every=args.checkpoint_every,
                                  fsync_every=args.fsync_every)
    except PromotionRefused as exc:
        follower.stop()
        print(f"error: promotion refused: {exc}", file=sys.stderr)
        return 1
    except (OSError, ValueError, KeyError) as exc:
        follower.stop()
        print(f"error: {exc}", file=sys.stderr)
        return 2
    follower.persist.close()
    out = {"promoted": True, "chain": report.chain,
           "resume_cycle": report.resume_cycle,
           "replayed_records": report.tail_records,
           "recomputed_cycles": list(report.recomputed),
           "wal_records": report.wal_records,
           "replay_s": report.replay_s,
           "violations": list(report.violations)}
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        print(f"promoted: {out['replayed_records']} WAL records replayed "
              f"({len(out['recomputed_cycles'])} cycles re-decided) in "
              f"{out['replay_s'] * 1e3:.1f} ms; chain {out['chain'][:16]}")
        print(f"resume with: tpusim_torch stream --checkpoint-dir "
              f"{args.checkpoint_dir} --recover ...")
        for violation in out["violations"]:
            print(f"promotion violation: {violation}", file=sys.stderr)
    if args.metrics_out and _primary():
        try:
            _write_metrics(args.metrics_out)
        except OSError as exc:
            print(f"error: failed to write metrics: {exc}", file=sys.stderr)
            return 2
    return 1 if out["violations"] else 0


def build_audit_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch audit",
        description="Chain-divergence forensics: bisect two WAL directories "
                    "(checkpoint.json and wal.jsonl pairs, e.g. a leader's "
                    "and a follower's, or two same-seed runs) to the FIRST "
                    "divergent cycle through the sha256 digest chain, then "
                    "decide that cycle again with explain lanes on and "
                    "print a per-decision forensic diff: score parts, top-k "
                    "candidate order, restage classification")
    parser.add_argument("wal_a", help="First WAL directory")
    parser.add_argument("wal_b", help="Second WAL directory")
    parser.add_argument("--algorithmprovider", default="DefaultProvider",
                        help="The provider the audited runs used (the replay "
                             "decides under the same policy surface)")
    parser.add_argument("--explain-k", type=int, default=3,
                        help="Top-k score-breakdown depth of the forensic "
                             "re-run (default 3; 0 turns the score-parts "
                             "lanes off)")
    parser.add_argument("--no-replay", action="store_true",
                        help="Record-level diff only: do not rebuild the "
                             "shared prefix and decide the divergent cycle "
                             "again")
    parser.add_argument("--json", action="store_true",
                        help="Print the whole report as one JSON object")
    parser.add_argument("--out", default="",
                        help="Also write the JSON report here")
    parser.add_argument("--device", default="cuda",
                        help="Where the replay runs: cuda (default) or cpu")
    return parser


def audit_cli(argv) -> int:
    """`audit`: first-divergence forensics over two WALs."""
    import json

    args = build_audit_parser().parse_args(argv)
    from tpusim_torch.obs.audit import audit_wal_pair, render_report
    from tpusim_torch.stream.persist import StreamPersistence

    for d in (args.wal_a, args.wal_b):
        if not os.path.exists(os.path.join(d, StreamPersistence.WAL)):
            print(f"error: no {StreamPersistence.WAL} in {d}",
                  file=sys.stderr)
            return 2
    try:
        report = audit_wal_pair(args.wal_a, args.wal_b,
                                provider=args.algorithmprovider,
                                explain_k=args.explain_k,
                                replay=not args.no_replay,
                                device=args.device)
    except (OSError, ValueError, KeyError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.out and _primary():
        try:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(report, f, sort_keys=True, indent=2)
                f.write("\n")
        except OSError as exc:
            print(f"error: failed to write report: {exc}", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(render_report(report), end="")
    return 1 if report.get("verdict") == "diverged" else 0


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


def build_top_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusim_torch top",
        description="Live cluster view against a running --listen "
                    "endpoint: per-resource utilization/fragmentation, "
                    "feasible nodes, hottest/coldest nodes, HBM residency "
                    "and compile cost (rendered from GET /analytics)")
    parser.add_argument("endpoint",
                        help="A --listen endpoint: http://HOST:PORT, "
                             "HOST:PORT, ':PORT', or 'PORT'")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="Seconds between refreshes (default 2)")
    parser.add_argument("--iterations", type=int, default=0,
                        help="Render this many frames then exit "
                             "(0: until interrupted)")
    parser.add_argument("--once", action="store_true",
                        help="Render a single frame without clearing the "
                             "screen and exit")
    parser.add_argument("--json", action="store_true",
                        help="Print one raw /analytics JSON body and exit")
    return parser


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _render_top(body: dict, url: str) -> str:
    """One `top` frame from a /analytics body (the JAX package's frame,
    byte for byte)."""
    lines = [f"tpusim top — {url}   samples={body.get('samples', 0)}"]
    latest = body.get("latest")
    if not body.get("enabled"):
        lines.append("analytics plane not armed on this endpoint "
                     "(start the session with --listen or --analytics-out)")
    elif latest is None:
        lines.append("no samples yet (waiting for the first cycle)")
    else:
        where = latest.get("source", "?")
        if latest.get("cycle") is not None:
            where += f" c{latest['cycle']}"
        nodes = latest.get("nodes", {})
        lines.append(f"nodes: {nodes.get('valid', '?')} valid, "
                     f"{nodes.get('feasible', '?')} feasible "
                     f"(cpu+mem+pod headroom)   [latest: {where}]")
        lines.append(f"{'RESOURCE':<10} {'UTIL':>7} {'FRAG':>7} "
                     f"{'REQUESTED':>14} {'ALLOCATABLE':>14} "
                     f"{'LARGEST-FREE':>13}")
        for name, row in latest.get("resources", {}).items():
            util = row.get("utilization")
            util_s = f"{util * 100:.1f}%" if util is not None else "-"
            frag_s = f"{row.get('fragmentation', 0.0) * 100:.1f}%"
            lines.append(f"{name:<10} {util_s:>7} {frag_s:>7} "
                         f"{row.get('requested', 0):>14} "
                         f"{row.get('allocatable', 0):>14} "
                         f"{row.get('largest_free', 0):>13}")
        for label, key in (("hottest", "hot_nodes"),
                           ("coldest", "cold_nodes")):
            entries = latest.get(key) or []
            if entries:
                lines.append(f"{label}: " + "  ".join(
                    f"{e['node']} {e['utilization_ppm'] / 10_000:.1f}%"
                    for e in entries[:5]))
    hbm = body.get("hbm") or {}
    if hbm:
        lines.append("hbm: " + "  ".join(
            f"{comp} {_fmt_bytes(slot.get('bytes', 0))}"
            f"/{slot.get('entries', 0)} entries"
            for comp, slot in sorted(hbm.items())))
    comp = body.get("compile") or {}
    if comp:
        lines.append("compile: " + "  ".join(
            f"{site} {slot.get('traces', 0)} traces "
            f"{slot.get('total_us', 0.0) / 1e6:.2f}s"
            for site, slot in sorted(comp.items())))
    return "\n".join(lines)


def top_cli(argv) -> int:
    """`top`: the live analytics view against a --listen endpoint. An
    endpoint that cannot be reached returns 2."""
    import json
    import time as _time
    from urllib.error import URLError
    from urllib.request import urlopen

    args = build_top_parser().parse_args(argv)
    endpoint = args.endpoint.strip()
    if endpoint.startswith("http://") or endpoint.startswith("https://"):
        url = endpoint.rstrip("/")
    else:
        from tpusim_torch.obs.server import parse_listen

        try:
            host, port = parse_listen(endpoint)
        except ValueError:
            print(f"error: bad endpoint {endpoint!r}", file=sys.stderr)
            return 2
        url = f"http://{host}:{port}"

    def fetch() -> dict:
        with urlopen(f"{url}/analytics?limit=1", timeout=5) as resp:
            return json.loads(resp.read().decode())

    frames = 0
    try:
        while True:
            try:
                body = fetch()
            except (URLError, OSError, ValueError) as exc:
                if frames:
                    print(f"endpoint gone ({exc}); exiting", file=sys.stderr)
                    return 0
                print(f"error: cannot reach {url}/analytics: {exc}",
                      file=sys.stderr)
                return 2
            if args.json:
                print(json.dumps(body, sort_keys=True))
                return 0
            frame = _render_top(body, url)
            if not args.once and sys.stdout.isatty():
                print("\x1b[2J\x1b[H" + frame, flush=True)
            else:
                print(frame, flush=True)
            frames += 1
            if args.once or (args.iterations and frames >= args.iterations):
                return 0
            _time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


# the commands that run as one of k ranks when a launcher such as torchrun
# (python -m torch.distributed.run --nproc-per-node k) starts them with
# WORLD_SIZE > 1: "" is the main command
RANKED_COMMANDS = ("", "serve", "stream", "follow", "promote", "audit")
SUBCOMMANDS = ("serve", "stream", "follow", "promote", "audit", "explain",
               "top")
# how long a rank waits on the others in a collective, seconds
RANK_TIMEOUT_S = 600


def _world_size() -> int:
    try:
        return int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return 1


def _primary() -> bool:
    """Whether this process prints the report and writes the outputs the
    user named: always, but on rank r > 0 of a process group of several
    ranks."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() > 0)


def _rank_address(addr):
    """(host, port) of this rank's replication link: port + rank on rank
    r of a process group (each rank runs a pair of its own); port 0 (any
    free port) as it is."""
    import torch.distributed as dist

    host, port = addr
    if port and dist.is_available() and dist.is_initialized():
        port += dist.get_rank()
    return host, port


def _run_ranked(argv) -> int:
    """Run a command as one of the ranks a launcher started: join the
    default process group from the launcher's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) over gloo, which lets k ranks share one
    card, put this rank on its card (LOCAL_RANK mod the card count), run
    the command with the standard output of every rank but 0 discarded,
    and leave the group. TPUSIM_SHARDS=k then shards the scan route and the
    streaming twin over the k ranks."""
    import contextlib
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        if torch.cuda.is_available():
            from tpusim_torch.sharding import shard_device

            torch.cuda.set_device(shard_device("cuda"))
        if dist.get_rank() == 0:
            return _dispatch(argv)
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            return _dispatch(argv)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    command = argv[0] if argv and argv[0] in SUBCOMMANDS else ""
    if command in RANKED_COMMANDS and _world_size() > 1:
        return _run_ranked(argv)
    return _dispatch(argv)


def _dispatch(argv) -> int:
    if argv and argv[0] == "serve":
        return serve_cli(argv[1:])
    if argv and argv[0] == "stream":
        return stream_cli(argv[1:])
    if argv and argv[0] == "follow":
        return follow_cli(argv[1:])
    if argv and argv[0] == "promote":
        return promote_cli(argv[1:])
    if argv and argv[0] == "audit":
        return audit_cli(argv[1:])
    if argv and argv[0] == "explain":
        return explain_cli(argv[1:])
    if argv and argv[0] == "top":
        return top_cli(argv[1:])
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
    if args.mesh:
        print("error: --mesh applies only to --what-if (the single-run scan "
              "is sequential; scale it via more nodes per snapshot)",
              file=sys.stderr)
        return 2
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

    chaos_plan = None
    if args.chaos_plan or args.chaos_seed is not None:
        from tpusim_torch.chaos import load_plan, random_plan
        from tpusim_torch.chaos.plan import PlanError

        try:
            if args.chaos_plan:
                chaos_plan = load_plan(args.chaos_plan)
                if args.chaos_seed is not None:
                    chaos_plan.seed = args.chaos_seed
            else:
                # seed only: an adversarial plan against the loaded
                # workload, deterministic per seed
                chaos_plan = random_plan(
                    args.chaos_seed,
                    node_names=[n.name for n in snapshot.nodes],
                    pod_keys=[p.key() for p in pods],
                    attempts=max(len(pods), 1))
        except (OSError, PlanError) as exc:
            print(f"error: invalid chaos plan: {exc}", file=sys.stderr)
            return 2

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
            device=args.device, chaos_plan=chaos_plan)
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
    if chaos_plan is not None:
        summary = getattr(status, "chaos_summary", None) or {}
        violations = getattr(status, "chaos_violations", None) or []
        fired = summary.get("churn_fired", 0)
        fabric = len(summary.get("fabric_injected", []))
        device = (len(summary.get("device_injected", []))
                  or len(summary.get("breaker_transitions", [])))
        print(f"Chaos: {fired} churn event(s), {fabric} fabric fault(s), "
              f"{device} device fault/transition(s), "
              f"{len(violations)} invariant violation(s) [seed "
              f"{chaos_plan.seed}]")
        if violations:
            for violation in violations:
                print(f"chaos violation: {violation}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
