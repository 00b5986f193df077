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

With a chaos plan's device section installed (install_chaos), schedule runs
behind a circuit breaker: an injected fault or a corrupted output the
structural checks catch, a divergence from the host pipeline under
verification, and every dispatch the open breaker denies are answered by the
host pipeline, each counted (route "breaker_fallback", the breaker's
transitions). These are the only host answers of the device path, and they
exist only while a plan is installed.
"""

from __future__ import annotations

import hashlib
import logging
import os
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
from tpusim_torch.obs import analytics, provenance, tracectx
from tpusim_torch.obs import recorder as flight
from tpusim_torch.scan import (
    GRAPH_STEPS,
    PodX,
    scan_inputs,
    scan_inputs_host,
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
# the process-wide chaos seam: while installed (install_chaos), every
# TorchBackend dispatch goes through the circuit breaker (closed -> open on
# repeated device faults -> half-open re-probe -> closed) and the
# DeviceInjector scripts per-dispatch exceptions and corruptions. A denied
# or faulted dispatch is answered by the host pipeline, counted in
# tpusim_backend_route_total{route="breaker_fallback"} and the breaker's
# transitions; under chaos no placement is emitted unverified
# (verify="all") or un-re-probed (half-open). Only chaos.engine.DeviceFault
# reaches the breaker: any other error of a kernel or the scan raises.
_CHAOS = {"injector": None, "breaker": None, "verify": "all"}


def install_chaos(device_plan):
    """Arm the device-fault layer of a chaos plan
    (chaos.plan.DeviceFaultPlan). Returns the CircuitBreaker, so callers can
    read its transition audit trail."""
    from tpusim_torch.chaos.breaker import CircuitBreaker
    from tpusim_torch.chaos.engine import DeviceInjector

    device_plan.validate()
    breaker = CircuitBreaker("device", device_plan.failure_threshold,
                             device_plan.cooldown)
    _CHAOS.update(injector=DeviceInjector(device_plan.faults),
                  breaker=breaker, verify=device_plan.verify)
    return breaker


def uninstall_chaos() -> None:
    _CHAOS.update(injector=None, breaker=None, verify="all")


def check_device_output(choices: np.ndarray, counts, n_nodes: int) -> None:
    """The structural checks of a dispatch's host outputs under chaos:
    out-of-range choices and NaN counts raise chaos.engine.DeviceOutputError
    and never reach decode_placements."""
    from tpusim_torch.chaos.engine import DeviceOutputError

    if choices.size and (int(choices.max()) >= n_nodes
                         or int(choices.min()) < -1):
        raise DeviceOutputError(f"device choice out of range [-1, {n_nodes})")
    if np.isnan(np.asarray(counts, dtype=np.float64)).any():
        raise DeviceOutputError("NaN in device reason counts")


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


def _shard_count() -> int:
    """TPUSIM_SHARDS=k (k > 1) puts the scan route on the node-sharded scan
    over a k-rank mesh. Unset, 1, 0 or garbage mean the single-device
    route, which builds no mesh and touches no process group."""
    try:
        k = int(os.environ.get("TPUSIM_SHARDS", "1"))
    except ValueError:
        return 1
    return k if k > 1 else 1


def shard_mesh_for(config, n_shards: int, device, note: str = "",
                   tag: str = ""):
    """The node mesh for a TPUSIM_SHARDS=n_shards batch on the scan route,
    or None where the batch takes the single-device scan: a config the
    sharded route cannot serve (scan.shard_route_eligible's reason), or no
    default process group of n_shards ranks ("device_count"). Either is
    counted in tpusim_shard_fallback_total{reason} with a trace instant
    (`note` its text; the batch's by default). `tag` names the mesh's own
    process groups (sharding.make_mesh)."""
    import torch.distributed as dist

    from tpusim_torch.scan import shard_route_eligible
    from tpusim_torch.sharding import make_mesh

    ok, why = shard_route_eligible(config)
    if ok and not (dist.is_available() and dist.is_initialized()
                   and dist.get_world_size() == n_shards):
        ok, why = False, "device_count"
    if not ok:
        register().shard_fallback.inc(why)
        flight.note_fast_fallback(
            "shard_" + why,
            note or f"TPUSIM_SHARDS={n_shards} batch routed single-device")
        log.info("%s (%s)", note or "sharded route ineligible; using the "
                 "single-device scan", why)
        return None
    return make_mesh(n_shards, snap=1, device_type=device.type, tag=tag)


def host_digest(*trees) -> int:
    """A 63-bit digest of host numpy trees: every field's dtype, shape and
    bytes, in field order."""
    h = hashlib.blake2b(digest_size=8)
    for tree in trees:
        for arr in tree:
            arr = np.ascontiguousarray(arr)
            h.update(f"{arr.dtype.str}{arr.shape}".encode())
            h.update(arr.tobytes())
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def check_ranks_agree(mesh, device, *trees, axes=("node",),
                      route: str = "sharded route") -> None:
    """Raise unless every rank of the mesh's `axes` holds the same host
    picture (host_digest of `trees`): each rank compiles and decodes on
    its own, and an order that leaked from a process's string hashing
    would split the ranks' node order or group ids without a sound. One
    all_reduce an axis (MAX of the digest and of its negation, carried
    from one axis to the next, so every rank of a grid sees the whole
    range); `route` names the caller in the error."""
    import torch
    import torch.distributed as dist

    d = host_digest(*trees)
    t = torch.tensor([d, -d], dtype=torch.int64, device=device)
    names = tuple(mesh.mesh_dim_names)
    for ax in axes:
        if mesh.size(names.index(ax)) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(ax))
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(
            f"{route}: the ranks' host pictures differ (digest "
            f"{d:016x} here, from {lo:016x} to {hi:016x} across the "
            "ranks); every rank must compile the same snapshot and pods")


def _dispatch_sharded(config, mesh, n_shards, statics, carry, xs, chunked,
                      scan_chunk, metrics, device):
    """One node-sharded dispatch: check that the ranks agree on the host
    picture, pad the node axis to the shard multiple and stage this rank's
    block (span shard:stage), run the sharded scan whole or in chunks
    (span shard:scan), and set the tpusim_shard_* gauges. Returns
    (final_carry, choices, counts, statics): the carry and statics this
    rank's padded block, for the analytics reduction to fold."""
    from tpusim_torch.scan import sharded_scan_fn
    from tpusim_torch.sharding import shard_device, shard_for_mesh

    dev = shard_device(device)
    sconfig = replace(config, shard_axis="node")
    check_ranks_agree(mesh, dev, statics, carry, xs)
    with flight.span("shard:stage") as ssp:
        n_real = int(np.asarray(statics.alloc_cpu).shape[0])
        # a chunked scan uploads the pods' columns chunk by chunk
        st, ca, xs_d = shard_for_mesh(
            mesh, statics, carry,
            PodX(*(np.asarray(c)[:0] for c in xs)) if chunked else xs, dev)
        if ssp:
            ssp.set("shards", n_shards)
            ssp.set("nodes", n_real)
    per = st.alloc_cpu.shape[0]
    metrics.shard_count.set(n_shards)
    for r in range(n_shards):
        metrics.shard_node_occupancy.set(
            str(r), max(0, min(n_real - r * per, per)))
    # the estimated collective payload, the JAX package's formula: about
    # 12 reduced scalars and an n_shards-wide tie vector a pod step, 8
    # bytes each, on every shard (analytics and gang lanes are apart)
    n_pods = int(np.asarray(xs.req_cpu).shape[0])
    metrics.shard_collective_bytes.set(
        float(n_pods) * (12 + n_shards) * 8 * n_shards)
    with flight.span("shard:scan", "device", dev) as sp:
        if chunked:
            final_carry, choices, counts, _adv = sharded_scan_fn(
                sconfig, mesh, chunk=scan_chunk)(ca, st, xs)
        else:
            final_carry, choices, counts, _adv = sharded_scan_fn(
                sconfig, mesh)(ca, st, xs_d)
            choices = choices.cpu().numpy()
            counts = counts.cpu().numpy()
        if sp:
            sp.set("shards", n_shards)
            sp.set("pods", n_pods)
    return final_carry, choices, counts, st


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
                 extender_transport=None, mesh_tag: str = ""):
        """policy: an engine.policy.Policy, compiled (and validated) here to
        the kernel's stage gating, weights and residue tables; it replaces
        the provider's predicate and priority sets like factory.go
        CreateFromConfig. route: "auto" (the kernel where plan_fast accepts
        the plan, the scan otherwise), "kernel" (raise where it refuses) or
        "scan". fallback: "reference" runs a workload the compile classifies
        unsupported on the host route, "error" raises. extender_transport:
        the in-process extender seam handed to the host route (a policy's
        extenders are host-bound). mesh_tag: the process groups of a
        TPUSIM_SHARDS mesh (sharding.make_mesh's tag; a streaming twin's
        gang cycles use their twin's)."""
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
        self.mesh_tag = mesh_tag
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
        """The device dispatch behind the chaos circuit breaker (armed by
        install_chaos; without it a plain call). Under chaos a denied or
        faulted dispatch is answered by the host pipeline (the same
        placements), counted as route "breaker_fallback"; a half-open probe,
        and every dispatch under verify="all", is checked against the host
        pipeline before its placements are emitted. A dispatch the breaker
        denies launches nothing on the device.

        precompiled: a (CompiledCluster, PodColumns) pair of `pods` on
        `snapshot` made already (delta.IncrementalCluster.compile, the gang
        driver's ungrouped segments), used in place of a compile of its
        own; one built without the NoExecute or ServiceAffinity tables the
        policy reads is compiled afresh."""
        breaker = _CHAOS["breaker"]
        if breaker is None:
            return self._schedule_on_device(pods, snapshot, precompiled)
        if not pods:
            return []
        from tpusim_torch.chaos.engine import DeviceFault

        if not breaker.allow():
            flight.note_route("breaker_fallback", len(pods))
            return self._reference(pods, snapshot)
        probing = breaker.probing
        try:
            placements = self._schedule_on_device(pods, snapshot, precompiled)
        except DeviceFault as exc:
            breaker.record_failure(f"{type(exc).__name__}: {exc}")
            flight.note_route("breaker_fallback", len(pods))
            return self._reference(pods, snapshot)
        if probing or _CHAOS["verify"] == "all":
            expected = self._reference(pods, snapshot)
            if placement_hash(placements) != placement_hash(expected):
                # silent corruption: in range but wrong; only the host's
                # placement hash catches it
                breaker.record_failure("device/host placement divergence")
                flight.note_route("breaker_fallback", len(pods))
                return expected
        breaker.record_success()
        return placements

    def _schedule_on_device(self, pods: List[Pod], snapshot: ClusterSnapshot,
                            precompiled=None) -> List[Placement]:
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
        shard_mesh = None
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
            # TPUSIM_SHARDS=k > 1: the node-sharded scan over k ranks, or
            # the single-device scan with the reason counted
            n_shards = _shard_count()
            if n_shards > 1:
                shard_mesh = shard_mesh_for(config, n_shards, self.device,
                                            tag=self.mesh_tag)
            if shard_mesh is not None:
                carry, statics, xs = scan_inputs_host(config, compiled, cols,
                                                      ptabs)
            else:
                carry, statics, xs = scan_inputs(config, compiled, cols,
                                                 ptabs, self.device,
                                                 host_pods=chunked)
        # the chaos seam: a scripted dispatch fault raises here, before any
        # launch; a scripted corruption applies to the host outputs below
        injector = _CHAOS["injector"]
        corrupt_kind = (injector.begin_dispatch() if injector is not None
                        else None)
        # the dispatch span runs from the plan (or the staged scan inputs)
        # to the choices on the host; its CUDA-event time is read at export
        dispatch_start = perf_counter()
        dsp = flight.span("device_dispatch", "device", self.device)
        lanes = final_carry = None
        if plan is not None:
            choices, counts, _adv = fast_scan(plan, device=self.device)
            self.last_route = "kernel"
        else:
            if shard_mesh is not None:
                final_carry, choices, counts, statics = \
                    _dispatch_sharded(config, shard_mesh, n_shards,
                                      statics, carry, xs, chunked,
                                      scan_chunk, metrics, self.device)
            elif chunked:
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
        if injector is not None:
            # both routes: the corruption touches the host copies of the
            # real pods' outputs only, and the structural checks run
            # whatever the verify mode
            if corrupt_kind is not None:
                from tpusim_torch.chaos.engine import DeviceInjector

                choices, counts = DeviceInjector.corrupt(corrupt_kind,
                                                         choices, counts)
            check_device_output(choices, counts, len(compiled.statics.names))
        route = "scan_sharded" if shard_mesh is not None else self.last_route
        flight.note_route(route, len(pods))
        if dsp:
            dsp.set("route", route)
            dsp.set("pods", len(pods))
            if shard_mesh is not None:
                dsp.set("shards", n_shards)
            if plan is not None:
                dsp.set("sig", str(plan_signature(plan)))
            dsp.end()
        # the trace id as an exemplar: a dispatch-latency spike on a
        # dashboard names the trace of its device dispatch
        ctx = tracectx.current()
        metrics.backend_dispatch_latency.observe(
            since_in_microseconds(dispatch_start),
            exemplar=ctx.trace_id if ctx is not None else None)
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
            # the batch's post-bind carry against its statics (on the
            # sharded route this rank's padded blocks: the reduction merges
            # across the ranks); a None-check without an installed
            # analytics plane
            analytics.capture(statics, final_carry,
                              len(compiled.statics.names), "backend",
                              names=compiled.statics.names,
                              mesh=shard_mesh)
        # e2e also covers the host's decode of the results
        metrics.e2e_scheduling_latency.observe(
            since_in_microseconds(dispatch_start))
        return placements
