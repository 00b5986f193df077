"""Command-line entry of the PyTorch port.

    python -m tpusim_torch.cli --podspec pods.yaml --synthetic-nodes 4 \
        [--scheduler-policy-file policy.json] [--device cpu] \
        [--backend torch|reference|auto] [--enable-pod-priority]

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


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
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
        print("error: --podspec is required", file=sys.stderr)
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
