"""TorchBackend: Schedule(pod_batch, cluster_state) -> placements, on the
fused fast-scan kernel or on the exact sequential scan.

The host compiles the cluster (numpy) and, under a policy, its tables; that
one compile feeds both routes. `plan_fast` builds the kernel's int32 plan,
and `fast_scan` runs the pods through the chunk kernel (CUDA on the card,
its plain version on the CPU). A plan the int32 plan cannot hold (byte-sized
memory, a group, zone or topology-domain budget, products past int32) runs
on `scan.schedule_scan` instead: the same pipeline in int64 tensor code, on
the same device; a batch past TPUSIM_SCAN_CHUNK pods (default 131072) runs
there in chunks (`scan.schedule_scan_chunked`), so that only one chunk of
its pod columns lies on the device at a time. `decode_placements` turns choices and reason counts into
Placements and FitError text byte-identical to kube-scheduler's.

route="auto" takes the kernel when it accepts the plan and the scan
otherwise, "kernel" raises NotImplementedError with plan_fast's reason where
the kernel refuses, "scan" always takes the scan. A workload that the host
compile classifies as unsupported by both routes (a claim the reference
resolves per pod, a group budget of the compile, a policy's extenders) runs
on the host route, backends.ReferenceBackend, with fallback="reference" (the
default), as the JAX package's JaxBackend does; fallback="error" raises
NotImplementedError with the reason. That classification is known before any
device work, and it is the only reroute: a fault of a kernel build, a launch
or the scan propagates.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import List, Optional

import numpy as np

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod
from tpusim_torch.backends import (  # noqa: F401 (re-exported)
    Placement,
    ReferenceBackend,
    bind_pod,
    mark_unschedulable,
    placement_hash,
)
from tpusim_torch.config import config_for
from tpusim_torch.device import resolve_device
from tpusim_torch.fastplan import plan_fast
from tpusim_torch.fastscan import fast_scan
from tpusim_torch.scan import (
    GRAPH_STEPS,
    scan_inputs,
    schedule_scan,
    schedule_scan_chunked,
)
from tpusim_torch.state import compile_cluster, env_int, reason_strings

DEFAULT_PROVIDER = "DefaultProvider"
CLUSTER_AUTOSCALER_PROVIDER = "ClusterAutoscalerProvider"
TD_PROVIDER = "TalkintDataProvider"
_MOST_REQUESTED_PROVIDERS = {CLUSTER_AUTOSCALER_PROVIDER, TD_PROVIDER}
_KNOWN_PROVIDERS = {DEFAULT_PROVIDER} | _MOST_REQUESTED_PROVIDERS

# generic_scheduler.go:48 (FitError.Error's header)
NO_NODE_AVAILABLE_MSG = "0/{} nodes are available"
UNSUPPORTED_MSG = "torch backend does not yet carry state for: "
FALLBACKS = ("reference", "error")

log = logging.getLogger(__name__)


def format_fit_error(num_nodes: int, counts: np.ndarray, strings: List[str]) -> str:
    """Byte-identical FitError.Error() (generic_scheduler.go:71-90)."""
    reason_strs = sorted(f"{int(c)} {strings[i]}"
                         for i, c in enumerate(counts) if c > 0)
    return (NO_NODE_AVAILABLE_MSG.format(num_nodes)
            + ": " + ", ".join(reason_strs) + ".")


def decode_placements(pods: List[Pod], choices: np.ndarray, counts: np.ndarray,
                      names: List[str], strings: List[str],
                      prebound: Optional[List[Placement]] = None
                      ) -> List[Placement]:
    """Device results -> Placements, in pod order. prebound: Placements
    already made for the scheduled pods, in pod order (the streaming twin's
    pipelined fold-back binds each placed pod once and hands them in here,
    so no pod is copied twice)."""
    placements: List[Placement] = []
    bound_iter = iter(prebound) if prebound is not None else None
    for j, pod in enumerate(pods):
        c = int(choices[j])
        if c >= 0:
            placements.append(next(bound_iter) if bound_iter is not None
                              else Placement(pod=bind_pod(pod, names[c]),
                                             node_name=names[c]))
        else:
            msg = format_fit_error(len(names), counts[j], strings)
            placements.append(Placement(pod=mark_unschedulable(pod, msg),
                                        reason="Unschedulable", message=msg))
    return placements


def compile_host(snapshot: ClusterSnapshot, pods: List[Pod],
                 compiled_policy=None):
    """The host compile of the cluster: (compiled, cols, detail). detail is
    "" when both device routes carry the workload, else the reasons the
    compile and the policy classify it unsupported, as the JAX package's
    backend joins them."""
    cp = compiled_policy
    ps = cp.spec if cp is not None else None
    compiled, cols = compile_cluster(
        snapshot, pods, need_noexec=ps is not None and ps.has_noexec,
        need_saa=ps is not None and ps.has_services)
    return compiled, cols, unsupported_detail(compiled, cp)


def unsupported_detail(compiled, compiled_policy=None) -> str:
    """The reasons the compile and the policy classify a workload
    unsupported by both device routes, joined as the JAX package's backend
    joins them; "" when both routes carry it."""
    unsupported = list(compiled.unsupported)
    if compiled_policy is not None:
        unsupported.extend(compiled_policy.unsupported)
    return "; ".join(sorted(set(unsupported))[:5])


def finish_inputs(snapshot: ClusterSnapshot, pods: List[Pod], compiled, cols,
                  most_requested: bool = False, hard_weight: int = 10,
                  compiled_policy=None):
    """The device inputs of a supported host compile: (config, compiled,
    cols, ptabs), as compile_inputs."""
    cp = compiled_policy
    if cp is not None and cp.hard_weight is not None:
        hard_weight = cp.hard_weight
    config = config_for(compiled, most_requested=most_requested,
                        hard_weight=hard_weight)
    ptabs = None
    if cp is not None:
        from tpusim_torch.policyc import build_policy_tables

        # fills cols.img_id and cols.sa_self_id in place
        ptabs = build_policy_tables(cp, snapshot, pods, compiled, cols)
        config = replace(config, policy=cp.spec)
        if cp.saa_entries:
            config = replace(config, n_saa_doms=ptabs.n_saa_doms)
    return config, compiled, cols, ptabs


def compile_inputs(snapshot: ClusterSnapshot, pods: List[Pod],
                   most_requested: bool = False, hard_weight: int = 10,
                   compiled_policy=None):
    """The host compile both routes share: (config, compiled, cols, ptabs).
    compiled_policy (policyc.compile_policy) replaces the provider's
    predicates and priorities, and its hardPodAffinitySymmetricWeight, if
    set, `hard_weight`; ptabs are its policyc.PolicyTables (None without a
    policy). Raises NotImplementedError with the reason for a workload
    neither route carries."""
    compiled, cols, detail = compile_host(snapshot, pods, compiled_policy)
    if detail:
        raise NotImplementedError(UNSUPPORTED_MSG + detail)
    return finish_inputs(snapshot, pods, compiled, cols, most_requested,
                         hard_weight, compiled_policy)


def build_plan(snapshot: ClusterSnapshot, pods: List[Pod],
               most_requested: bool = False, hard_weight: int = 10,
               compiled_policy=None):
    """The fast-scan plan of `pods` on `snapshot` and the compiled cluster:
    (plan, compiled), as compile_inputs takes its arguments. Raises
    NotImplementedError with the reason for a workload the kernel does not
    carry."""
    config, compiled, cols, ptabs = compile_inputs(
        snapshot, pods, most_requested, hard_weight, compiled_policy)
    plan, why = plan_fast(config, compiled, cols, ptabs)
    if plan is None:
        raise NotImplementedError(f"torch backend: {why}")
    return plan, compiled


ROUTES = ("auto", "kernel", "scan")


class TorchBackend:
    def __init__(self, provider: str = DEFAULT_PROVIDER, device="cuda",
                 hard_pod_affinity_symmetric_weight: int = 10, policy=None,
                 route: str = "auto", fallback: str = "reference",
                 extender_transport=None):
        """policy: an engine.policy.Policy, compiled (and validated) here to
        the kernel's stage gating, weights and residue tables; it replaces
        the provider's predicate and priority sets like factory.go
        CreateFromConfig. route: "auto" (the kernel where plan_fast accepts
        the plan, the scan otherwise), "kernel" (raise where it refuses) or
        "scan". fallback: "reference" runs a workload the compile classifies
        unsupported on the host route, "error" raises. extender_transport:
        the in-process extender seam handed to the host route (a policy's
        extenders are host-bound)."""
        if provider not in _KNOWN_PROVIDERS:
            raise KeyError(f"plugin {provider!r} has not been registered")
        if fallback not in FALLBACKS:
            raise ValueError("fallback must be 'reference' or 'error'")
        if not 1 <= hard_pod_affinity_symmetric_weight <= 100:
            # factory.go:1024-1026
            raise ValueError("invalid hardPodAffinitySymmetricWeight: "
                             f"{hard_pod_affinity_symmetric_weight}, must be "
                             "in the range 1-100")
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r} (expected one of "
                             f"{', '.join(ROUTES)})")
        self.provider = provider
        self.hard_pod_affinity_symmetric_weight = \
            hard_pod_affinity_symmetric_weight
        self.device = resolve_device(device)
        self.route = route
        self.fallback = fallback
        self.extender_transport = extender_transport
        self.policy = policy
        self._compiled_policy = None
        if policy is not None:
            from tpusim_torch.policyc import compile_policy

            self._compiled_policy = compile_policy(policy)
        # the last batch's raw device results, in pod order, and the route
        # it took ("kernel", "scan" or "reference", "" before any) with
        # plan_fast's reason where the scan ran, the compile's where the
        # host route ran
        self.last_choices = np.zeros(0, np.int32)
        self.last_route = ""
        self.last_route_reason = ""

    def _reference(self, pods: List[Pod],
                   snapshot: ClusterSnapshot) -> List[Placement]:
        """The host route, built as the JAX package's JaxBackend builds its
        fallback: the same provider, policy, transport and hard weight."""
        placements = ReferenceBackend(
            provider=self.provider, policy=self.policy,
            extender_transport=self.extender_transport,
            hard_pod_affinity_symmetric_weight=self.hard_pod_affinity_symmetric_weight,
        ).schedule(pods, snapshot)
        index = {n.name: i for i, n in enumerate(snapshot.nodes)}
        self.last_choices = np.array(
            [index.get(p.node_name, -1) for p in placements], np.int32)
        return placements

    def schedule(self, pods: List[Pod], snapshot: ClusterSnapshot,
                 precompiled=None) -> List[Placement]:
        """precompiled: a (CompiledCluster, PodColumns) pair of `pods` on
        `snapshot` made already (delta.IncrementalCluster.compile, the gang
        driver's ungrouped segments), used in place of a compile of its
        own; one built without the NoExecute or ServiceAffinity tables the
        policy reads is compiled afresh."""
        self.last_choices = np.zeros(0, np.int32)
        self.last_route = self.last_route_reason = ""
        if not pods:
            return []
        if not snapshot.nodes:
            msg = "no nodes available to schedule pods"
            self.last_choices = np.full(len(pods), -1, np.int32)
            return [Placement(pod=mark_unschedulable(p, msg),
                              reason="Unschedulable", message=msg)
                    for p in pods]
        cp = self._compiled_policy
        ps = cp.spec if cp is not None else None
        if precompiled is not None and ps is not None and (
                (ps.has_noexec and not precompiled[0].has_noexec_table)
                or (ps.has_services and not precompiled[0].has_saa_table)):
            precompiled = None
        if precompiled is None:
            compiled, cols, detail = compile_host(snapshot, pods, cp)
        else:
            compiled, cols = precompiled
            detail = unsupported_detail(compiled, cp)
        if detail:
            if self.fallback == "error":
                raise NotImplementedError(UNSUPPORTED_MSG + detail)
            log.warning("torch backend falling back to reference for: %s",
                        detail)
            self.last_route, self.last_route_reason = "reference", detail
            return self._reference(pods, snapshot)
        config, compiled, cols, ptabs = finish_inputs(
            snapshot, pods, compiled, cols,
            most_requested=self.provider in _MOST_REQUESTED_PROVIDERS,
            hard_weight=self.hard_pod_affinity_symmetric_weight,
            compiled_policy=cp)
        plan, why = None, "route='scan' asked for"
        if self.route != "scan":
            plan, why = plan_fast(config, compiled, cols, ptabs)
            if plan is None and self.route == "kernel":
                raise NotImplementedError(f"torch backend: {why}")
        if plan is not None:
            choices, counts, _adv = fast_scan(plan, device=self.device)
            self.last_route = "kernel"
        else:
            # a batch past TPUSIM_SCAN_CHUNK pods streams its pod columns
            # to the device chunk by chunk (the JAX package's setting and
            # default)
            scan_chunk = env_int("TPUSIM_SCAN_CHUNK", 131072)
            chunked = 0 < scan_chunk < len(pods)
            carry, statics, xs = scan_inputs(config, compiled, cols, ptabs,
                                             self.device, host_pods=chunked)
            if chunked:
                _, choices, counts, _adv = schedule_scan_chunked(
                    config, carry, statics, xs, scan_chunk,
                    graph_steps=GRAPH_STEPS)
            else:
                _, choices, counts, _adv = schedule_scan(
                    config, carry, statics, xs, graph_steps=GRAPH_STEPS)
                choices, counts = choices.cpu().numpy(), counts.cpu().numpy()
            self.last_route, self.last_route_reason = "scan", why
        self.last_choices = choices
        return decode_placements(pods, choices, counts, compiled.statics.names,
                                 reason_strings(compiled.scalar_names))
