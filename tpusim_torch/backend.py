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

An installed provenance log (obs.provenance) gets every decoded batch,
source "backend" (or "reference" on the host route). One that asks for
top-k score breakdowns builds the explain lanes into the scan
(EngineConfig.explain_k), and an installed analytics plane (obs.analytics)
reduces the scan's final carry: both read what only the scan writes, so
route "auto" takes the scan for them, counted in
tpusim_fast_fallback_total as the JAX package counts it, and route
"kernel" raises. A failures-only log rides the kernel route.

With a flight recorder installed (obs.recorder), schedule records the JAX
package's spans: compile_cluster, device_dispatch (a device span, with its
CUDA-event time on the card), the route instant and decode_placements; the
metrics registry gets the compile, dispatch, algorithm and e2e latencies and
the plan_fast refusals by blocker class.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from time import perf_counter
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
from tpusim_torch.config import EXPLAIN_SENTINEL, config_for, explain_part_names
from tpusim_torch.device import resolve_device
from tpusim_torch.fastplan import plan_fast
from tpusim_torch.fastscan import fast_scan
from tpusim_torch.framework.metrics import register, since_in_microseconds
from tpusim_torch.obs import analytics, provenance
from tpusim_torch.obs import recorder as flight
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

# plan_fast's refusal reasons, classified into low-cardinality counter keys
# (the raw strings embed counts and budgets); the first substring match wins
_FALLBACK_KEYS = (
    ("policy static tables unavailable", "policy_tables_missing"),
    ("not compiled", "tables_not_compiled"),
    ("ServiceAffinity lock segments", "sa_segs_budget"),
    ("ServiceAffinity entry labels", "sa_segs_budget"),
    ("ServiceAntiAffinity label domains", "saa_doms_budget"),
    ("ServiceAntiAffinity spread counts", "saa_int32"),
    ("negative", "negative_scores"),
    ("pod groups exceed", "groups_budget"),
    ("zone domains exceed", "zones_budget"),
    ("topology keys exceed", "interpod_budget"),
    ("topology domains exceed", "interpod_budget"),
    ("inter-pod terms exceed", "interpod_budget"),
    ("inter-pod priority counts", "interpod_int32"),
    ("non-integral preferred inter-pod", "interpod_weights"),
    ("MaxPD volume ids", "maxpd_budget"),
    ("scalar resource kinds", "reason_bits_budget"),
    ("priority weights exceed", "score_int32"),
    ("int32", "int32_overflow"),
    ("explain lanes", "explain"),
)


def fast_fallback_key(why: str) -> str:
    for marker, key in _FALLBACK_KEYS:
        if marker in why:
            return key
    return "other"


def note_fast_fallback(why: str) -> None:
    """A plan_fast refusal the scan route absorbs: counted by blocker class
    in tpusim_fast_fallback_total, with the full reason on the trace."""
    key = fast_fallback_key(why)
    register().fast_fallback.inc(key)
    flight.note_fast_fallback(key, why)


# the reasons a batch takes the scan whatever plan_fast would say (the JAX
# package's texts, so the same fallback keys): the explain lanes and the
# analytics plane read what only the scan writes, its score parts and its
# final carry
EXPLAIN_ON_SCAN = ("explain lanes (top-k score breakdown) route through the "
                   "XLA scan")
ANALYTICS_ON_SCAN = "cluster analytics rides the XLA scan's final carry"
EXPLAIN_WHOLE_SCAN = ("explain lanes (top-k score breakdown) take the whole "
                      "scan, not the chunked one")


def scan_only_reason(config) -> Optional[str]:
    """Why a batch under `config` must run on the scan route, given the
    installed provenance log and analytics plane, or None."""
    if config.explain_k > 0:
        return EXPLAIN_ON_SCAN
    if analytics.get() is not None:
        return ANALYTICS_ON_SCAN
    return None


def plan_signature(plan) -> tuple:
    """The kernel-variant key of a plan: node width, the feature flags and
    the scalar and group widths."""
    return (plan.alloc_cpu.shape[1], plan.most_requested, plan.num_scalars,
            plan.num_groups, plan.n_zone_doms, plan.has_ports, plan.has_disk,
            plan.has_spread, plan.has_vol_zone, plan.has_interpod,
            plan.has_maxpd, plan.policy is not None)


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
        # the host route's decisions carry provenance too: failures and
        # placements only, as it computes no score parts
        provenance.capture(placements, "reference")
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
            placements = [Placement(pod=mark_unschedulable(p, msg),
                                    reason="Unschedulable", message=msg)
                          for p in pods]
            provenance.capture(placements, "backend")
            return placements
        metrics = register()
        cp = self._compiled_policy
        ps = cp.spec if cp is not None else None
        if precompiled is not None and ps is not None and (
                (ps.has_noexec and not precompiled[0].has_noexec_table)
                or (ps.has_services and not precompiled[0].has_saa_table)):
            precompiled = None
        if precompiled is None:
            compile_start = perf_counter()
            with flight.span("compile_cluster") as csp:
                compiled, cols, detail = compile_host(snapshot, pods, cp)
                if csp:
                    csp.set("pods", len(pods))
                    csp.set("nodes", len(snapshot.nodes))
            compile_us = since_in_microseconds(compile_start)
            metrics.backend_compile_latency.observe(compile_us)
            analytics.note_compile(
                "backend", f"nodes={len(snapshot.nodes)}", compile_us)
        else:
            compiled, cols = precompiled
            detail = unsupported_detail(compiled, cp)
        if detail:
            if self.fallback == "error":
                raise NotImplementedError(UNSUPPORTED_MSG + detail)
            log.warning("torch backend falling back to reference for: %s",
                        detail)
            flight.note_route("reference", len(pods))
            self.last_route, self.last_route_reason = "reference", detail
            return self._reference(pods, snapshot)
        config, compiled, cols, ptabs = finish_inputs(
            snapshot, pods, compiled, cols,
            most_requested=self.provider in _MOST_REQUESTED_PROVIDERS,
            hard_weight=self.hard_pod_affinity_symmetric_weight,
            compiled_policy=cp)
        # an installed provenance log that asks for a score breakdown
        # builds the explain lanes into the scan (explain_k 0 leaves every
        # program as it is)
        explain_k = provenance.requested_top_k()
        if explain_k > 0:
            config = replace(config, explain_k=min(
                explain_k, len(compiled.statics.names)))
        plan, why = None, "route='scan' asked for"
        if self.route != "scan":
            why = scan_only_reason(config)
            if why is None:
                plan, why = plan_fast(config, compiled, cols, ptabs)
            if plan is None:
                if self.route == "kernel":
                    raise NotImplementedError(f"torch backend: {why}")
                note_fast_fallback(why)
        if plan is None:
            # a batch past TPUSIM_SCAN_CHUNK pods streams its pod columns
            # to the device chunk by chunk (the JAX package's setting and
            # default); the chunked scan carries no explain lanes, so they
            # take the whole scan, counted
            scan_chunk = env_int("TPUSIM_SCAN_CHUNK", 131072)
            chunked = 0 < scan_chunk < len(pods)
            if chunked and config.explain_k > 0:
                note_fast_fallback(EXPLAIN_WHOLE_SCAN)
                chunked = False
            carry, statics, xs = scan_inputs(config, compiled, cols, ptabs,
                                             self.device, host_pods=chunked)
        # the dispatch span runs from the plan (or the staged scan inputs)
        # to the choices on the host; its CUDA-event time is read at export
        dispatch_start = perf_counter()
        dsp = flight.span("device_dispatch", "device", self.device)
        lanes = final_carry = None
        if plan is not None:
            with flight.profiled("tpusim:fast_scan"):
                choices, counts, _adv = fast_scan(plan, device=self.device)
            self.last_route = "kernel"
        else:
            with flight.profiled("tpusim:schedule_scan"):
                if chunked:
                    final_carry, choices, counts, _adv = \
                        schedule_scan_chunked(config, carry, statics, xs,
                                              scan_chunk,
                                              graph_steps=GRAPH_STEPS)
                else:
                    final_carry, choices, counts, _adv, *rest = \
                        schedule_scan(config, carry, statics, xs,
                                      graph_steps=GRAPH_STEPS)
                    lanes = rest[0] if rest else None
                    choices = choices.cpu().numpy()
                    counts = counts.cpu().numpy()
            self.last_route, self.last_route_reason = "scan", why
        flight.note_route(self.last_route, len(pods))
        if dsp:
            dsp.set("route", self.last_route)
            dsp.set("pods", len(pods))
            if plan is not None:
                dsp.set("sig", str(plan_signature(plan)))
            dsp.end()
        metrics.backend_dispatch_latency.observe(
            since_in_microseconds(dispatch_start))
        metrics.scheduling_algorithm_latency.observe(
            since_in_microseconds(dispatch_start))
        self.last_choices = choices
        with flight.span("decode_placements"):
            placements = decode_placements(
                pods, choices, counts, compiled.statics.names,
                reason_strings(compiled.scalar_names))
        prov = provenance.get_log()
        if prov is not None:
            topk = None
            if lanes is not None:
                topk = {"idx": lanes.top_idx.cpu().numpy(),
                        "scores": lanes.top_scores.cpu().numpy(),
                        "parts": lanes.top_parts.cpu().numpy(),
                        "names": compiled.statics.names,
                        "part_names": explain_part_names(config),
                        "sentinel": EXPLAIN_SENTINEL}
            prov.capture_batch(placements, "backend", topk=topk)
        if final_carry is not None:
            # the batch's post-bind carry against its statics; a
            # None-check without an installed analytics plane
            analytics.capture(statics, final_carry,
                              len(compiled.statics.names), "backend",
                              names=compiled.statics.names)
        # e2e also covers the host's decode of the results
        metrics.e2e_scheduling_latency.observe(
            since_in_microseconds(dispatch_start))
        return placements
