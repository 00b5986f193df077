"""The simulation entry: run_simulation routes a pod batch to the host
orchestrator (ClusterCapacity) or to TorchBackend on the card, and returns
the Status the report prints; run_stream_simulation drives the streaming
twin (stream.StreamSession) through seeded churn.

ClusterCapacity is the host route. Reference: pkg/scheduler/simulator.go.
The control-flow inversion of the reference is kept in-process and
synchronous: pods are pushed into the store, store events drive the
scheduler, and the engine calls back up through the two injected seams,
Bind (GetBinder) and Update (PodConditionUpdater) (simulator.go:247-255), so
placements mutate only the in-memory store. The LIFO pod feed
(store.go:223-233) and the stop-reason strings are reproduced exactly.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from time import perf_counter
from typing import Callable, Dict, List, Optional

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Node, Pod, PodCondition, ResourceType
from tpusim_torch.engine import predicates as preds
from tpusim_torch.engine.cache import CacheError, SchedulerCache
from tpusim_torch.engine.equivalence import EquivalenceCache
from tpusim_torch.engine.generic_scheduler import (
    FitError,
    GenericScheduler,
    SchedulingError,
)
from tpusim_torch.engine.policy import Policy
from tpusim_torch.engine.providers import (
    DEFAULT_PROVIDER,
    PluginFactoryArgs,
    apply_feature_gates,
    create_from_config,
    create_from_provider,
    default_registry,
)
from tpusim_torch.engine.queue import new_scheduling_queue
from tpusim_torch.engine.resources import NodeInfo
from tpusim_torch.engine.util import PodBackoff
from tpusim_torch.engine.volume import VolumeBinder
from tpusim_torch.framework.events import Recorder
from tpusim_torch.framework.metrics import (
    register as register_metrics,
    since_in_microseconds,
)
from tpusim_torch.framework.report import GeneralReview, Status, get_report
from tpusim_torch.framework.store import (
    ADDED,
    DELETED,
    MODIFIED,
    PodQueue,
    ResourceStore,
)
from tpusim_torch.framework.strategy import PredictiveStrategy
from tpusim_torch.gang import (
    PodGroup,
    gang_fit_message,
    gang_name,
    has_gangs,
)
from tpusim_torch.obs import analytics, tracectx
from tpusim_torch.obs import recorder as flight

DEFAULT_SCHEDULER_NAME = "TD-Scheduler"  # options.go:49
BACKENDS = ("torch", "reference", "auto")
# run_simulation's two registry-surgery gates: the device routes have no
# compiled shape for the gated predicate and priority sets
HOST_BOUND_GATES = ("TaintNodesByCondition", "ResourceLimitsPriorityFunction")

log = logging.getLogger(__name__)


@dataclass
class SchedulerServerConfig:
    """The slice of componentconfig.KubeSchedulerConfiguration the simulator
    reads (options.go:47-61), plus the two feature gates the engine consults:
    PodPriority (preemption; off by default like the reference's 1.10 gates,
    scheduler.go:210-213) and EnableEquivalenceClassCache (simulator.go:369)."""

    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    algorithm_provider: str = DEFAULT_PROVIDER
    # AlgorithmSource.Policy analog (simulator.go:383-424): when set, the
    # scheduler is built from the policy instead of the named provider
    policy: Optional[Policy] = None
    extender_transport: Optional[object] = None  # in-process extender seam
    hard_pod_affinity_symmetric_weight: int = 10
    enable_pod_priority: bool = False
    enable_equivalence_cache: bool = False
    # VolumeScheduling feature gate (scheduler.go:175; off in the reference's
    # 1.10 defaults): enables CheckVolumeBinding + delayed-binding semantics
    enable_volume_scheduling: bool = False
    # registry-surgery gates (ApplyFeatureGates, defaults.go:181-205):
    # TaintNodesByCondition / ResourceLimitsPriorityFunction — both default
    # off in this k8s vintage; applied before provider/policy assembly
    feature_gates: Optional[Dict[str, bool]] = None


class ClusterCapacity:
    """Reference: simulator.go:63-342."""

    def __init__(self, config: SchedulerServerConfig, new_pods: List[Pod],
                 scheduled_pods: List[Pod], nodes: List[Node],
                 services: Optional[list] = None,
                 pvs: Optional[list] = None, pvcs: Optional[list] = None,
                 storage_classes: Optional[list] = None,
                 chaos: Optional[object] = None,
                 backoff_clock: Optional[Callable[[], float]] = None):
        self.config = config
        self.status = Status()
        # chaos engine (chaos.ChaosEngine): fires scripted churn at
        # pod-attempt boundaries and audits end-state invariants; its
        # deterministic clock drives the backoff below, so the retry order
        # is a pure function of the fault plan
        self.chaos = chaos.attach(self) if chaos is not None else None
        self.report: Optional[GeneralReview] = None
        self.closed = False

        # --- store + queue + strategy + recorder (simulator.go:286-342) ---
        self.resource_store = ResourceStore()
        self.strategy = PredictiveStrategy(self.resource_store)
        self.pod_queue = PodQueue(new_pods)
        self.recorder = Recorder(10)

        # --- the scheduler cache, maintained by store event handlers exactly
        # like factory.go's informer handlers (factory.go:139-299); carries
        # the assumed-pod lifecycle + generation-based snapshots
        # (schedulercache/cache.go, engine/cache.py) ---
        self.cache = SchedulerCache()
        self._cached_node_infos: Dict[str, NodeInfo] = {}
        self.resource_store.register_event_handler(ResourceType.PODS, self._on_pod_event)
        self.resource_store.register_event_handler(ResourceType.NODES, self._on_node_event)

        # --- seed cluster state (simulator.go:315-322) ---
        for node in nodes:
            self.resource_store.add(ResourceType.NODES, node)
        for pod in scheduled_pods:
            self.resource_store.add(ResourceType.PODS, pod)
            self.status.scheduled_pods.append(pod)
        for svc in services or []:
            self.resource_store.add(ResourceType.SERVICES, svc)
        for pv in pvs or []:
            self.resource_store.add(ResourceType.PERSISTENT_VOLUMES, pv)
        for pvc in pvcs or []:
            self.resource_store.add(ResourceType.PERSISTENT_VOLUME_CLAIMS, pvc)
        self.nodes = nodes

        # --- volume binder over the seeded PV/PVC/StorageClass state
        # (simulator SchedulerConfigLocal wires PV/PVC informers,
        # simulator.go:355-366; the binder itself is factory.go:252-259) ---
        self.volume_binder = VolumeBinder(
            self.resource_store.list(ResourceType.PERSISTENT_VOLUMES),
            self.resource_store.list(ResourceType.PERSISTENT_VOLUME_CLAIMS),
            storage_classes or [],
            enabled=config.enable_volume_scheduling)

        # --- build the engine with store-backed listers (SchedulerConfigLocal,
        # simulator.go:345-428: fake empty RC/RS/StatefulSet listers, simulated
        # pod/node/service listers) ---
        args = PluginFactoryArgs(
            # the plugin pod lister is the SCHEDULER CACHE, not the store
            # (factory.go:166 podLister: schedulerCache): assigned pods only,
            # in cache insertion order (seed order then bind order) — the
            # deterministic stand-in for Go's random map iteration
            pod_lister=lambda: [state.pod for state
                                in self.cache.pod_states.values()],
            service_lister=lambda: self.resource_store.list(ResourceType.SERVICES),
            node_info_getter=lambda name: self.node_info_map.get(name),
            pvc_getter=self.volume_binder.get_pvc,
            pv_getter=self.volume_binder.get_pv,
            storage_class_getter=self.volume_binder.get_class,
            volume_binder=self.volume_binder,
            volume_scheduling_enabled=config.enable_volume_scheduling,
            hard_pod_affinity_symmetric_weight=config.hard_pod_affinity_symmetric_weight,
        )
        # ServiceAffinity predicates (policy-registered, arbitrary names)
        # judge OTHER nodes by where service pods sit, so any pod add/delete
        # invalidates them on ALL nodes (factory.go's onPodAdd/Delete
        # invalidation set includes CheckServiceAffinity)
        self._service_affinity_pred_names = [
            pp.name for pp in (config.policy.predicates or [])
            if pp.argument is not None
            and pp.argument.service_affinity is not None
        ] if config.policy is not None else []
        self.scheduling_queue = new_scheduling_queue(config.enable_pod_priority)
        # MakeDefaultErrorFunc's backoff state; the clock is injectable
        # (chaos > explicit > wall monotonic), so backoff expiry is testable
        # and a chaos replay is byte-stable. Outside chaos the loop records
        # backoff and never waits on it
        if self.chaos is not None:
            backoff_clock = self.chaos.clock
        self.pod_backoff = (PodBackoff(clock=backoff_clock)
                            if backoff_clock is not None else PodBackoff())
        registry = None
        if config.feature_gates:
            # ApplyFeatureGates runs before provider/policy assembly, like
            # the scheduler app (defaults.go:181-205)
            registry = default_registry()
            apply_feature_gates(registry, config.feature_gates)
        if config.policy is not None:
            # AlgorithmSource.Policy path (simulator.go:383-424 →
            # factory.go CreateFromConfig)
            self.scheduler: GenericScheduler = create_from_config(
                config.policy, args, registry=registry,
                extender_transport=config.extender_transport)
        else:
            self.scheduler = create_from_provider(
                config.algorithm_provider, args, registry=registry)
        self.scheduler.scheduling_queue = self.scheduling_queue
        if config.enable_equivalence_cache:
            self.scheduler.equivalence_cache = EquivalenceCache(
                pvc_getter=self.volume_binder.get_pvc)
        # PDBs come from the fake informer in the reference (empty,
        # simulator.go:352-366) but can be injected for preemption studies
        self.pdbs: list = []
        self.scheduler.pdb_lister = lambda: list(self.pdbs)
        self.metrics = register_metrics()

    # --- cache event handlers ---

    @property
    def node_info_map(self) -> Dict[str, NodeInfo]:
        """The cache's live per-node view (schedulerCache.nodes)."""
        return self.cache.nodes

    def refresh_node_info_snapshot(self) -> Dict[str, NodeInfo]:
        """Expire overdue assumed pods, then refresh the generation-checked
        snapshot the algorithm runs against (generic_scheduler.go:129 →
        cache.go UpdateNodeNameToInfoMap:83-97)."""
        self.cache.cleanup_assumed_pods()
        return self.cache.update_node_name_to_info_map(self._cached_node_infos)

    def _on_pod_event(self, event: str, pod: Pod) -> None:
        if event in (ADDED, MODIFIED) and pod.spec.node_name:
            # a bound pod confirms its assumed entry; re-delivered Modified
            # events for an already-confirmed pod are ignored by the cache
            if self.cache.is_assumed_pod(pod) \
                    or pod.key() not in self.cache.pod_states:
                self.cache.add_pod(pod)
                self._invalidate_ecache_for_node(pod.spec.node_name)
            # factory.go:607-615 wires assigned-pod informer events to the
            # queue's affinity-triggered moves: a bound pod may make parked
            # pods with matching required pod-affinity terms schedulable
            queue = getattr(self, "scheduling_queue", None)
            if queue is not None:
                if event == ADDED:
                    queue.assigned_pod_added(pod)
                else:
                    queue.assigned_pod_updated(pod)
        elif event == DELETED and pod.key() in self.cache.pod_states:
            self.cache.remove_pod(pod)
            self._invalidate_ecache_for_node(pod.spec.node_name)
            # factory.go:624-631: a deleted pod may free anti-affinity or
            # resources anywhere — move everything back to active
            queue = getattr(self, "scheduling_queue", None)
            if queue is not None:
                queue.move_all_to_active_queue()

    def _invalidate_ecache_for_node(self, node_name: str) -> None:
        """The factory event handlers invalidate cached predicate results when
        a node's pod set changes (factory.go:596-631 + ecache hooks); the
        conservative whole-node invalidation keeps the cache correct. A
        ServiceAffinity verdict on EVERY node can change when a service pod
        binds or leaves anywhere, so those predicate keys invalidate
        cluster-wide (factory.go's CheckServiceAffinity invalidation)."""
        # handlers also fire during __init__ seeding, before the engine exists
        scheduler = getattr(self, "scheduler", None)
        if scheduler is not None and scheduler.equivalence_cache is not None:
            scheduler.equivalence_cache.invalidate_all_on_node(node_name)
            if self._service_affinity_pred_names:
                scheduler.equivalence_cache \
                    .invalidate_cached_predicate_item_of_all_nodes(
                        self._service_affinity_pred_names)

    def _on_node_event(self, event: str, node: Node) -> None:
        if event == DELETED:
            self.cache.remove_node(node)
        else:
            self.cache.add_node(node)
        self._invalidate_ecache_for_node(node.name)

    # --- the two seams (simulator.go:108-185) ---

    def bind(self, pod: Pod, node_name: str) -> None:
        """SEAM 1 — Bind intercept (simulator.go:108-145)."""
        stored, exists = self.resource_store.get(ResourceType.PODS, pod.key())
        if not exists:
            raise SchedulingError(f"Unable to bind, pod {pod.key()} not found")
        if self.chaos is not None and node_name in self.chaos.deleted_nodes:
            # churn fires only at attempt boundaries, so the algorithm can
            # never rightly pick a node deleted before its snapshot:
            # reaching here means stale state leaked through a seam
            self.chaos.record_violation(
                f"bind of {pod.key()} to deleted node {node_name}")
        updated = stored.copy()
        updated.spec.node_name = node_name
        updated.status.phase = "Running"
        if self.chaos is not None:
            # a chaos retry can bind a pod that parked as unschedulable in
            # an earlier attempt; the terminal buckets must stay disjoint
            # (the reference never retries, so only the chaos arm hits this)
            self.status.failed_pods = [
                p for p in self.status.failed_pods if p.key() != pod.key()]
        self.strategy.add(updated)  # -> store.update -> Modified -> cache AddPod
        self.scheduling_queue.delete(updated)
        self.pod_backoff.clear_pod_backoff(updated.key())
        self.status.successful_pods.append(updated)
        self.recorder.eventf(updated, "Normal", "Scheduled",
                             "Successfully assigned %s to %s", pod.name, node_name)
        self.recorder.drain_one()  # simulator.go:130-132

    def update(self, pod: Pod, condition: PodCondition) -> None:
        """SEAM 2 — unschedulable intercept (simulator.go:163-185)."""
        stop = (condition.type == "PodScheduled" and condition.status == "False"
                and condition.reason == "Unschedulable")
        if stop:
            pod.status.phase = "Pending"
            pod.status.conditions.append(condition)
            pod.status.reason = condition.reason
            # MakeDefaultErrorFunc (factory.go:1259-1341): record backoff and
            # park the pod in the unschedulable queue — its nominated-node
            # state stays visible to later pods' feasibility double-pass
            self.pod_backoff.get_backoff_time(pod.key())
            self.scheduling_queue.add_unschedulable_if_not_present(pod)
            self.status.failed_pods.append(pod)
            self.recorder.eventf(pod, "Warning", "FailedScheduling", condition.message)
            self.recorder.drain_one()

    # --- the loop (simulator.go:187-223 + scheduler.go:431-497) ---

    def _next_pod(self) -> Optional[Pod]:
        pod = self.pod_queue.pop()
        if pod is None:
            return None
        # scheduling_queue.Pop's receivedMoveRequest reset marks the start of
        # a scheduling cycle (scheduling_queue.go:295-312); the simulator
        # feeds from the LIFO pod queue instead of popping the scheduling
        # queue, so the reset is mirrored here — a move request then flips
        # parking to re-activation only when it arrived while THIS pod was
        # in flight (e.g. a preemption's victim deletions), like upstream
        if hasattr(self.scheduling_queue, "received_move_request"):
            self.scheduling_queue.received_move_request = False
        self.resource_store.add(ResourceType.PODS, pod)
        return pod

    def _fail(self, pod: Pod, message: str) -> str:
        self.update(pod, PodCondition(type="PodScheduled", status="False",
                                      reason="Unschedulable", message=message))
        return "failed"

    def _schedule_one(self, pod: Pod, preempt_budget: int = 1) -> str:
        """Returns 'bound' or 'failed' — the seam whose deferred nextPod sets
        the stop-reason string when the queue drains (simulator.go:136, :171).

        With the PodPriority gate on, a FitError triggers the preemption
        pipeline (scheduler.go:449-455): victims are deleted from the store
        (mutating the cache through the DELETED event) and the pod retries —
        synchronously here, since the one-pod-in-flight feed would pop it right
        back anyway. Deviation from the reference, documented: the transient
        Unschedulable condition the Go scheduler sets before a successful
        preemption is not recorded in FailedPods."""
        sp = flight.span("pod_attempt")
        if not sp:
            return self._schedule_one_inner(pod, preempt_budget)
        sp.set("pod", pod.key())
        sp.set("preempt_budget", preempt_budget)
        try:
            outcome = self._schedule_one_inner(pod, preempt_budget)
            sp.set("outcome", outcome)
            return outcome
        finally:
            sp.end()

    def _schedule_one_inner(self, pod: Pod, preempt_budget: int) -> str:
        metrics = self.metrics
        e2e_start = algo_start = perf_counter()
        # the algorithm runs against the cache's generation-checked snapshot,
        # not the live view (generic_scheduler.go:129)
        node_infos = self.refresh_node_info_snapshot()
        try:
            with flight.span("schedule"):
                host = self.scheduler.schedule(pod, self.nodes, node_infos)
            metrics.scheduling_algorithm_latency.observe(
                since_in_microseconds(algo_start))
        except FitError as fit_err:
            if self.config.enable_pod_priority and preempt_budget > 0:
                node, _victims = self.attempt_preemption(pod, fit_err)
                if node is not None:
                    return self._schedule_one(pod, preempt_budget - 1)
            # scheduler.go:190-201 error arm -> PodConditionUpdater.Update
            return self._fail(pod, fit_err.error())
        except SchedulingError as sched_err:
            return self._fail(pod, str(sched_err))
        # assumeAndBindVolumes (scheduler.go:367-398): with the gate on, the
        # matched PVs are consumed before the pod binds
        if self.config.enable_volume_scheduling:
            self.volume_binder.assume_pod_volumes(pod, host)
            if self.scheduler.equivalence_cache is not None:
                # PV claimRef changes invalidate volume predicates everywhere,
                # like the factory's PV/PVC event hooks (factory.go
                # invalidatePredicatesForPv/Pvc)
                self.scheduler.equivalence_cache \
                    .invalidate_cached_predicate_item_of_all_nodes([
                        preds.MAX_EBS_VOLUME_COUNT_PRED,
                        preds.MAX_GCE_PD_VOLUME_COUNT_PRED,
                        preds.MAX_AZURE_DISK_VOLUME_COUNT_PRED,
                        preds.NO_VOLUME_ZONE_CONFLICT_PRED,
                        preds.CHECK_VOLUME_BINDING_PRED,
                    ])
        # assume (scheduler.go:366-398 → cache.AssumePod): later pods see the
        # placement immediately; the synchronous Bind's store event confirms it
        assumed = pod.copy()
        assumed.spec.node_name = host
        try:
            with flight.span("assume"):
                self.cache.assume_pod(assumed)
        except CacheError as cache_err:
            # assume error arm (scheduler.go:377-380 → config.Error): the pod
            # is reported failed, the run continues — e.g. a fed pod whose
            # namespace/name collides with an already-cached pod
            return self._fail(pod, str(cache_err))
        # binding latency + e2e (scheduler.go:425,492)
        binding_start = perf_counter()
        try:
            with flight.span("bind") as bsp:
                if bsp:
                    bsp.set("host", host)
                self.bind(pod, host)
        except SchedulingError:
            # bind error arm (scheduler.go:484-496): forget the assumed pod
            # so its resources are returned, then surface the error
            self.cache.forget_pod(assumed)
            raise
        self.cache.finish_binding(assumed)  # no-op once confirmed
        metrics.binding_latency.observe(since_in_microseconds(binding_start))
        metrics.e2e_scheduling_latency.observe(since_in_microseconds(e2e_start))
        return "bound"

    # --- gang admission: all-or-nothing group scheduling ---

    def _schedule_or_admit(self, pod: Pod) -> str:
        """Per-pod dispatch: a pod carrying a group annotation routes its
        whole gang through all-or-nothing admission; everything else takes
        the unchanged scheduleOne path."""
        if gang_name(pod):
            return self._admit_gang(pod)
        return self._schedule_one(pod)

    def _gather_gang(self, pod: Pod) -> PodGroup:
        """Pull `pod`'s mates forward — from the LIFO feed and, on retries,
        from the scheduling queue — so the group decides as one unit at the
        first member's feed position."""
        name = gang_name(pod)
        members = [pod]
        seen = {pod.key()}
        for mate in (self.pod_queue.take_matching(
                lambda p: gang_name(p) == name)
                + self.scheduling_queue.take_matching(
                    lambda p: gang_name(p) == name)):
            if mate.key() not in seen:
                seen.add(mate.key())
                members.append(mate)
        return PodGroup(name=name, pods=members)

    def _trial_member(self, pod: Pod) -> Optional[str]:
        """One member's trial: schedule + assume + bind (so the next member
        sees the placement), WITHOUT the unschedulable intercept — failure
        attribution belongs to the group decision, not the member. Returns
        the host or None."""
        node_infos = self.refresh_node_info_snapshot()
        try:
            host = self.scheduler.schedule(pod, self.nodes, node_infos)
        except SchedulingError:
            return None
        assumed = pod.copy()
        assumed.spec.node_name = host
        try:
            self.cache.assume_pod(assumed)
        except CacheError:
            return None
        try:
            self.bind(pod, host)
        except SchedulingError:
            self.cache.forget_pod(assumed)
            return None
        self.cache.finish_binding(assumed)
        return host

    def _admit_gang(self, pod: Pod) -> str:
        """All-or-nothing admission of `pod`'s group: gather the mates,
        trial-bind members sequentially (intra-gang binds visible), then
        either keep the binds (>= min-available placed) or roll every one
        back through the store — the cache sees the deletes — and park the
        whole gang with ONE shared FitError. Gang admission does not
        attempt preemption."""
        group = self._gather_gang(pod)
        m = self.metrics
        m.gang_size.observe(len(group.pods))
        bound: List[Pod] = []
        overflow: List[Pod] = []
        with flight.span("gang:admit") as sp:
            if sp:
                sp.set("group", group.name)
                sp.set("members", len(group.pods))
            for member in group.pods:
                _stored, exists = self.resource_store.get(
                    ResourceType.PODS, member.key())
                if not exists:
                    self.resource_store.add(ResourceType.PODS, member)
                if self.chaos is not None:
                    # mates pulled forward never went through _next_pod:
                    # they are fed HERE, so the no-pod-lost audit and the
                    # eviction re-feed cover them too
                    self.chaos.note_fed(member)
                if self._trial_member(member) is not None:
                    bound.append(member)
                else:
                    overflow.append(member)

        if len(bound) >= group.min_available:
            # admitted: the gang stands; overflow members failed
            # individually, not the gang
            keys = {p.key() for p in bound}
            self.status.failed_pods = [
                p for p in self.status.failed_pods if p.key() not in keys]
            for member in overflow:
                self._fail(member, f"pod group \"{group.name}\" admitted at "
                                   f"{len(bound)}/{len(group.pods)}; this "
                                   "member did not fit.")
            m.gang_admitted.inc()
            flight.note_gang("admit", {"group": group.name,
                                       "placed": len(bound),
                                       "members": len(group.pods)})
            return "bound"

        # rejected: roll back every trial bind so no partial gang survives
        msg = gang_fit_message(group, len(self.nodes), len(bound))
        for member in bound:
            current, exists = self.resource_store.get(
                ResourceType.PODS, member.key())
            if exists and current.spec.node_name:
                self.resource_store.delete(ResourceType.PODS, current)
            key = member.key()
            self.status.successful_pods = [
                p for p in self.status.successful_pods if p.key() != key]
            # the pristine pending member goes back to the store, exactly
            # like a pod that never trial-bound
            self.resource_store.add(ResourceType.PODS, member)
        if bound:
            m.gang_partial_rollback.inc()
            flight.note_gang("rollback", {"group": group.name,
                                          "unbound": len(bound)})
        m.gang_rejected.inc("min_available" if self.nodes else "no_nodes")
        flight.note_gang("reject", {"group": group.name,
                                    "placed": len(bound)})
        for member in group.pods:
            self._fail(member, msg)
        return "failed"

    def _release_gangs(self, names, preemptor: Pod, node) -> None:
        """A preempted member releases its whole gang: every still-bound
        mate is deleted from the store (the cache sees the deletes), moved
        to the preempted bucket, and the group's queued nominations are
        cleared so parked members re-attempt as a unit."""
        for mate in list(self.resource_store.list(ResourceType.PODS)):
            if gang_name(mate) not in names or not mate.spec.node_name:
                continue
            self.resource_store.delete(ResourceType.PODS, mate)
            key = mate.key()
            self.status.successful_pods = [
                p for p in self.status.successful_pods if p.key() != key]
            self.status.scheduled_pods = [
                p for p in self.status.scheduled_pods if p.key() != key]
            self.status.preempted_pods.append(mate)
            self.recorder.eventf(mate, "Normal", "Preempted",
                                 "gang released by %s on node %s",
                                 preemptor.name, node.name)
            self.metrics.gang_partial_rollback.inc()
        for p in self.scheduling_queue.clear_nominations_for_gangs(names):
            p.status.nominated_node_name = ""
        flight.note_gang("release", {"groups": sorted(names)})

    def attempt_preemption(self, pod: Pod, fit_err: FitError,
                           candidate_filter=None):
        """The preemption arm of scheduleOne (scheduler.go:449-455 → the full
        Preempt pipeline, core/generic_scheduler.go:205-262): pick a node +
        victims, delete the victims from the store (mutating the cache through
        the DELETED events), and nominate the pod. Returns (node, victims) —
        node is None when preemption found nothing. Shared by the host loop
        (_schedule_one retry) and the preemption hybrid (preempt.py), which
        may prefilter the candidate nodes (GenericScheduler.preempt)."""
        metrics = self.metrics
        preemption_start = perf_counter()
        metrics.preemption_attempts.inc()
        psp = flight.span("preempt")
        try:
            # Preempt runs against the same cached snapshot the failed
            # Schedule used (g.cachedNodeInfoMap, generic_scheduler.go:205)
            node, victims, to_clear = self.scheduler.preempt(
                pod, self.nodes, self._cached_node_infos, fit_err,
                candidate_filter=candidate_filter)
        except SchedulingError:
            # a failed preemption attempt (e.g. extender error) is
            # logged-and-dropped in the reference (scheduler.go:
            # 449-451); the pod still gets its Unschedulable condition
            node, victims, to_clear = None, [], []
        if psp:
            psp.set("pod", pod.key())
            psp.set("node", node.name if node is not None else "")
            psp.set("victims", len(victims))
            psp.end()
        metrics.preemption_evaluation.observe(
            since_in_microseconds(preemption_start))
        return self.commit_preemption(pod, node, victims, to_clear)

    def commit_preemption(self, pod: Pod, node, victims, to_clear):
        """The side-effect half of attempt_preemption (preempt.go:45-75):
        clear losing nominations, nominate the pod, delete the victims from
        the store (mutating the cache through the DELETED events) and emit
        the Preempted events. The hybrid's device victim arm commits a
        kernel-picked (node, victims) through this same sequence."""
        self.metrics.preemption_victims.set(len(victims))
        for p in to_clear:
            p.status.nominated_node_name = ""
        if node is None:
            return None, []
        pod.status.nominated_node_name = node.name
        for victim in victims:
            self.resource_store.delete(ResourceType.PODS, victim)
            self.status.preempted_pods.append(victim)
            # an evicted pod is no longer placed: drop it from the
            # success/pre-scheduled buckets so the report balances
            key = victim.key()
            self.status.successful_pods = [
                p for p in self.status.successful_pods if p.key() != key]
            self.status.scheduled_pods = [
                p for p in self.status.scheduled_pods if p.key() != key]
            self.recorder.eventf(victim, "Normal", "Preempted",
                                 "by %s on node %s", pod.name, node.name)
        gang_names = {gang_name(v) for v in victims if gang_name(v)}
        if gang_names:
            # preempting one member releases the whole gang — an
            # all-or-nothing admission cannot survive partially
            self._release_gangs(gang_names, pod, node)
        return node, victims

    STOP_REASONS = {
        # Bind's deferred nextPod uses lowercase "fail", Update's uses "Fail"
        "run": "fail to get next pod: No pods left\n",      # simulator.go:204
        "bound": "fail to get next pod: No pods left\n",    # simulator.go:136
        "failed": "Fail to get next pod: No pods left\n",   # simulator.go:171
    }

    def run(self) -> None:
        """Reference: simulator.go:187-213 — feed one pod at a time until the
        queue drains; the stop-reason strings match the Go format verbatim.
        With a recorder installed, the time each pod sat in the feed since
        the scheduler last went idle lands as a queue_wait span."""
        if self.chaos is not None:
            return self._run_chaos()
        rec = flight.get_recorder()
        idle_since = rec.clock() if rec is not None else 0.0
        outcome = "run"
        pod = self._next_pod()
        while pod is not None:
            if rec is not None:
                rec.add_span("queue_wait", "host", idle_since, rec.clock(),
                             {"pod": pod.key()})
            outcome = self._schedule_or_admit(pod)
            if rec is not None:
                idle_since = rec.clock()
            pod = self._next_pod()
        self.status.stop_reason = self.STOP_REASONS[outcome]
        self.close()

    def _run_chaos(self) -> None:
        """The chaos arm of run(): the same seams and scheduling path, but
        every attempt boundary fires due churn first, and after the LIFO
        feed drains, churn-reactivated pods (evicted and requeued, or parked
        pods a returning node released) get bounded re-attempts out of the
        scheduling queue, gated per pod by the plan's max_retries and by
        PodBackoff under the chaos clock. A global attempt budget
        guarantees termination for any plan."""
        chaos = self.chaos
        outcome = "run"
        max_at = max([ev.at for ev in chaos.plan.churn] +
                     [ev.at + ev.restore_after for ev in chaos.plan.churn],
                     default=0)
        budget = ((len(self.pod_queue) + len(self.status.scheduled_pods)
                   + len(chaos.plan.churn) + 8)
                  * (chaos.plan.max_retries + 2) + max_at + 64)
        spent = 0
        while spent < budget:
            spent += 1
            chaos.fire_boundary()
            pod = self._next_pod()
            if pod is not None:
                chaos.note_fed(pod)
                outcome = self._schedule_or_admit(pod)
                continue
            if chaos.has_pending_churn():
                # churn past the attempt horizon may still evict and
                # requeue: keep ticking boundaries until it lands
                continue
            retry = self.scheduling_queue.pop()
            if retry is None:
                break
            if chaos.allow_retry(retry):
                outcome = self._schedule_or_admit(retry)
        if spent >= budget:
            chaos.record_violation(
                f"attempt budget exhausted ({budget}): the run did not "
                "quiesce")
        chaos.flush()
        self.status.stop_reason = self.STOP_REASONS.get(
            outcome, self.STOP_REASONS["run"])
        self.close()

    def close(self) -> None:
        self.closed = True

    def get_report(self) -> GeneralReview:
        if self.report is None:
            self.report = get_report(self.status)
        return self.report


def new_cluster_capacity(config: SchedulerServerConfig, new_pods: List[Pod],
                         scheduled_pods: List[Pod], nodes: List[Node],
                         services: Optional[list] = None) -> ClusterCapacity:
    """Reference: scheduler.New (simulator.go:286-342)."""
    return ClusterCapacity(config, new_pods, scheduled_pods, nodes, services)


def auto_routes_to_host(num_pods: int, num_nodes: int,
                        enable_volume_scheduling: bool = False) -> bool:
    """The backend="auto" rule: a workload under TPUSIM_AUTO_THRESHOLD
    (100,000) pod × node pairs runs on the host route, where a device
    dispatch would cost more than it saves. Volume scheduling is host-bound
    and wins over everything. Callers size num_nodes after any event-log
    fold, since a log that adds nodes counts toward the threshold."""
    if enable_volume_scheduling:
        return True
    threshold = int(os.environ.get("TPUSIM_AUTO_THRESHOLD", 100_000))
    return num_pods * max(num_nodes, 1) < threshold


def _status_from_placements(placements, snapshot: ClusterSnapshot) -> Status:
    status = Status(scheduled_pods=list(snapshot.pods))
    for placement in placements:
        if placement.scheduled:
            status.successful_pods.append(placement.pod)
        else:
            status.failed_pods.append(placement.pod)
    last_failed = placements and not placements[-1].scheduled
    status.stop_reason = ("Fail to get next pod: No pods left\n" if last_failed
                          else "fail to get next pod: No pods left\n")
    return status


def run_simulation(pods: List[Pod], snapshot: ClusterSnapshot,
                   provider: str = DEFAULT_PROVIDER, backend: str = "torch",
                   scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                   enable_pod_priority: bool = False,
                   enable_volume_scheduling: bool = False,
                   policy: Optional[Policy] = None,
                   events: Optional[list] = None,
                   feature_gates: Optional[Dict[str, bool]] = None,
                   device="cuda", route: str = "auto",
                   hard_pod_affinity_symmetric_weight: int = 10,
                   extender_transport=None,
                   chaos_plan: Optional[object] = None) -> Status:
    """Run `pods` (in podspec order; the LIFO feed reversal happens inside,
    as in the reference) against `snapshot` and return the final Status.

    backend: "torch" (TorchBackend on `device`, route `route`: the default,
    so the port runs on the card unless asked otherwise), "reference" (the
    host orchestrator, ClusterCapacity) or "auto" (the host below
    TPUSIM_AUTO_THRESHOLD pod × node pairs, torch above). The routing
    follows the JAX package's run_simulation rule by rule: the
    registry-surgery feature gates, a policy the compile classifies
    unsupported and a policy with PodPriority run on the host with a
    warning; VolumeScheduling on torch raises ValueError; PodPriority with
    pod groups runs on the host; PodPriority alone runs the preemption
    hybrid (preempt.run_with_preemption) on `device` and `route`; pod
    groups alone run the gang driver (gang.driver.schedule_with_gangs) on
    `device` and `route`, each gang admitted all or nothing. policy: an
    engine.policy.Policy replacing the provider's predicates and priorities (AlgorithmSource.Policy,
    simulator.go:383-424). feature_gates: kube --feature-gates as a dict
    (engine.providers.parse_feature_gates). extender_transport: the
    in-process seam a policy's extenders are called through, on whichever
    route runs them (None makes real HTTP calls). scheduler_name is taken
    for the JAX package's signature; as there, nothing reads it.

    events: an optional [(ADDED|MODIFIED|DELETED, Pod|Node|Service|
    PersistentVolume|PersistentVolumeClaim), ...] watch-event log
    (framework.events.load_event_log) folded into `snapshot` before
    scheduling through delta.IncrementalCluster. backend "auto" is sized
    after the fold. On torch the fold's IncrementalCluster feeds the device
    route its compile (TorchBackend.schedule(precompiled=)), the gang
    driver its live cluster and the preemption hybrid its incremental
    state, so compiled state is patched, not rebuilt. With a flight
    recorder installed the fold runs under an event_fold span and the
    replay's compile under compile_cluster.

    chaos_plan: an optional chaos.FaultPlan. Churn and fabric sections drive
    the host orchestrator (a torch request with those sections runs there,
    with a warning, like the other host-bound features); the device section
    arms the dispatch circuit breaker and fault injector around the torch
    backend (backend.install_chaos), whose host answers are counted. The
    returned Status gains `chaos_summary` (fired faults and retries, or the
    breaker's transitions) and `chaos_violations` (the end-state invariant
    audit; empty = degraded gracefully). As in the JAX package, PodPriority
    on torch runs the preemption hybrid before the device seam is armed, so
    a device plan does not reach it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    incremental = None
    if events:
        from tpusim_torch.delta import IncrementalCluster

        with flight.span("event_fold") as fsp:
            incremental = IncrementalCluster(snapshot)
            incremental.apply_events(events)
            folded = incremental.to_snapshot()
            if fsp:
                fsp.set("events", len(events))
                fsp.set("nodes", len(folded.nodes))
        # the folded PV and PVC state includes applied PersistentVolume
        # (Claim) events; StorageClass objects are not watch events and
        # pass through from the seed snapshot
        snapshot = ClusterSnapshot(
            nodes=folded.nodes, pods=folded.pods, services=folded.services,
            pvs=folded.pvs, pvcs=folded.pvcs,
            storage_classes=snapshot.storage_classes)
    if backend == "auto":
        # sized AFTER the fold, so a log that adds nodes counts
        backend = ("reference"
                   if auto_routes_to_host(len(pods), len(snapshot.nodes),
                                          enable_volume_scheduling)
                   else "torch")
    if feature_gates:
        # PodPriority / VolumeScheduling gate the same behavior as the
        # dedicated parameters (scheduler.go:175,210-213); the
        # registry-surgery gates pass through to apply_feature_gates
        feature_gates = dict(feature_gates)
        if feature_gates.pop("PodPriority", False):
            enable_pod_priority = True
        if feature_gates.pop("VolumeScheduling", False):
            enable_volume_scheduling = True
    if chaos_plan is not None:
        chaos_plan.validate()
        if backend == "torch" and not chaos_plan.host_sections_empty():
            # churn fires at per-pod attempt boundaries and fabric faults
            # hit watch streams: both exist only in the host orchestrator;
            # device faults alone stay on the device path, behind the breaker
            log.warning(
                "chaos churn/fabric sections are host-bound: running the "
                "reference orchestrator instead of the torch backend")
            backend = "reference"
    if feature_gates and any(feature_gates.get(g) for g in HOST_BOUND_GATES) \
            and backend == "torch":
        log.warning(
            "feature gates %s are host-bound: running the reference "
            "orchestrator instead of the torch backend",
            sorted(k for k, v in feature_gates.items() if v))
        backend = "reference"
    if policy is not None and backend == "torch":
        # compile (and validate) the policy for the device routes; a
        # host-bound feature (extenders) runs on the host orchestrator,
        # which has the full plugin registry and the in-process extender seam
        from tpusim_torch.policyc import compile_policy

        compiled_policy = compile_policy(policy)
        if compiled_policy.unsupported or enable_pod_priority:
            reason = ("preemption with a policy scheduler"
                      if not compiled_policy.unsupported else
                      "; ".join(sorted(set(compiled_policy.unsupported))[:5]))
            log.warning("policy is host-bound (%s): running the reference "
                        "orchestrator instead of the torch backend", reason)
            backend = "reference"
    if backend == "torch":
        if enable_volume_scheduling:
            raise ValueError("--enable-volume-scheduling requires --backend "
                             "reference (delayed PV binding is stateful "
                             "host-side matching)")
        if enable_pod_priority and has_gangs(pods):
            # preemption interplay (gang release, nomination cleanup) lives
            # in the host orchestrator's queue and store machinery
            log.warning("pod groups with PodPriority are host-bound: running "
                        "the reference orchestrator instead of the torch "
                        "backend")
            backend = "reference"
    if backend == "reference":
        chaos_engine = None
        if chaos_plan is not None:
            from tpusim_torch.chaos import ChaosEngine

            chaos_engine = ChaosEngine(chaos_plan)
        cc = ClusterCapacity(
            SchedulerServerConfig(
                scheduler_name=scheduler_name, algorithm_provider=provider,
                policy=policy, extender_transport=extender_transport,
                hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
                enable_pod_priority=enable_pod_priority,
                enable_volume_scheduling=enable_volume_scheduling,
                feature_gates=feature_gates),
            new_pods=pods, scheduled_pods=snapshot.pods, nodes=snapshot.nodes,
            services=snapshot.services, pvs=snapshot.pvs, pvcs=snapshot.pvcs,
            storage_classes=snapshot.storage_classes, chaos=chaos_engine)
        cc.run()
        if chaos_engine is not None:
            from tpusim_torch.chaos import check_invariants

            cc.status.chaos_violations = check_invariants(cc, chaos_engine)
            cc.status.chaos_summary = chaos_engine.summary()
        return cc.status
    if enable_pod_priority:
        # the host-device hybrid: the device scan places, victim selection
        # runs on the device or the exact host pipeline (preempt.py)
        from tpusim_torch.preempt import run_with_preemption

        return run_with_preemption(
            pods, snapshot, provider=provider,
            hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
            incremental=incremental, device=device, route=route)
    from tpusim_torch.backend import TorchBackend

    torch_backend = TorchBackend(
        provider=provider, device=device,
        hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
        policy=policy, route=route, extender_transport=extender_transport)
    feed = list(reversed(pods))  # the LIFO queue pops the last element first
    gangs = has_gangs(feed)
    precompiled = None
    if incremental is not None and feed and snapshot.nodes and not gangs:
        # the replay's incremental compile stands in for the backend's own
        with flight.span("compile_cluster") as csp:
            precompiled = incremental.compile(feed)
            if csp:
                csp.set("pods", len(feed))
                csp.set("nodes", len(snapshot.nodes))
    breaker = None
    if chaos_plan is not None and not chaos_plan.device.empty():
        from tpusim_torch.backend import install_chaos

        breaker = install_chaos(chaos_plan.device)
    try:
        with flight.span("backend_schedule") as bsp:
            if bsp:
                bsp.set("backend", "torch")
                bsp.set("pods", len(feed))
            if gangs:
                # the gang driver: ungrouped runs take the per-pod path
                # against the live incremental cluster (behind the same
                # breaker), gangs are admitted all or nothing
                from tpusim_torch.delta import IncrementalCluster
                from tpusim_torch.gang.driver import schedule_with_gangs

                inc = incremental or IncrementalCluster(snapshot)
                placements = schedule_with_gangs(torch_backend, inc, feed)
            else:
                placements = torch_backend.schedule(feed, snapshot,
                                                    precompiled=precompiled)
    finally:
        if breaker is not None:
            from tpusim_torch.backend import uninstall_chaos

            uninstall_chaos()
    status = _status_from_placements(placements, snapshot)
    if breaker is not None:
        status.chaos_summary = {
            "breaker_transitions": list(breaker.transitions)}
        status.chaos_violations = []
    return status


def run_stream_simulation(snapshot: Optional[ClusterSnapshot] = None, *,
                          num_nodes: int = 64, cycles: int = 50,
                          arrivals: int = 32, evict_fraction: float = 0.25,
                          node_flap_every: int = 0,
                          label_churn: int = 0, taint_churn: int = 0,
                          gang_size: int = 0, gang_count: int = 0,
                          seed: int = 0,
                          provider: str = DEFAULT_PROVIDER,
                          policy=None, pipeline: bool = False,
                          always_restage: bool = False, verify: bool = False,
                          chaos_plan: Optional[object] = None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 0,
                          fsync_every: int = 0,
                          replicate_to: Optional[tuple] = None,
                          recover: bool = False,
                          whatif_every: int = 0, whatif_pods: int = 4,
                          device="cuda") -> dict:
    """Drive a stream.StreamSession through seeded churn
    (stream.ChurnLoadGen) and return a summary dict: the `stream` CLI's
    loop. Each cycle, watch events fold into the host picture, the delta
    commits onto the device-resident carry, and a fresh arrival batch
    schedules against it: O(delta) a warm cycle instead of O(cluster).

    snapshot: the cluster (None: synthetic_cluster(num_nodes), whose node
        labels are seeded from the churn universe when a policy or label or
        taint churn is on, so the cold start interns every label value).
    always_restage: no resident path (the restage comparison arm).
    policy: an engine.policy.Policy, resident with the twin.
    pipeline: decode cycle N-1 while cycle N runs on the device
        (StreamSession.schedule_pipelined); the placements and the chains
        equal the synchronous path's.
    label_churn / taint_churn: label rewrites / taint toggles a cycle.
    gang_size / gang_count: pod groups a cycle, each cycle with gangs a gang
        cycle (the gang driver, all or nothing).
    verify: also run every cycle through a fresh TorchBackend.schedule (or
        the gang driver) on a second IncrementalCluster fed the same events,
        and count the cycles whose placement hash differs
        ("mismatched_cycles"; pipelined cycles compare when their
        placements emerge).
    whatif_every: every N cycles, answer a live what-if query of
        whatif_pods pods (from a separate seeded stream) on the resident
        twin (StreamSession.overlay_query); the chains are unchanged by the
        queries. The summary gains an "overlay" block.
    chaos_plan: device-fault and process_crash sections only (churn and
        fabric faults are what the load generator makes already, as
        events). The device section arms the breaker and the injector
        around every cycle's dispatch (backend.install_chaos); the summary
        gains "breaker_transitions". A process_crash event arms the WAL
        writer (it needs checkpoint_dir), and the run dies with
        chaos.engine.ProcessCrash right after the targeted record; a second
        call with recover=True and the SAME workload arguments resumes it.
    checkpoint_dir / checkpoint_every: journal every cycle to a WAL and
        checkpoint the host and device picture every that-many emitted
        cycles (stream.persist); 0 = the genesis checkpoint only. The
        summary gains "wal_records", "checkpoints" and "wal_chain".
    fsync_every: fsync the WAL every N appends (0: flush only); the mode is
        stamped into every checkpoint.
    replicate_to: (host, port) of a listening stream.replicate.FollowerTwin
        (or the `follow` command): a WalShipper ships the journal (it needs
        checkpoint_dir) and is drained before the return; the summary gains
        "replication_acked_seq", "replication_acked_chain" and
        "replication_lag_at_close". A crash does not drain: the unshipped
        tail lives in the durable WAL only.
    recover: load checkpoint_dir, replay the WAL tail, fast-forward the
        load generator over the committed prefix, and run the REMAINING
        cycles. The summary's fold_chain then equals an uninterrupted
        run's; it gains "recovered", "resume_cycle", "replay_ms",
        "recomputed_cycles" and "recovery_violations".
    device: "cuda" (the default) or "cpu".

    Under TPUSIM_SHARDS=k every rank of a default process group of k
    ranks makes this same call (the twin's node axis sharded over them);
    each journals to a directory of its own, checkpoint_dir on rank 0 and
    <checkpoint_dir>.rank<r> on rank r (sharding.rank_directory), and
    recovers from it."""
    import hashlib
    from time import perf_counter

    from numpy.random import RandomState

    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.delta import IncrementalCluster
    from tpusim_torch.gang.driver import schedule_with_gangs
    from tpusim_torch.backends import Placement, bind_pod
    from tpusim_torch.stream import ChurnLoadGen, StreamSession, chain_fold
    from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE
    from tpusim_torch.sharding import rank_directory
    from tpusim_torch.stream.persist import (
        StreamPersistence,
        recover_stream_session,
    )

    checkpoint_dir = rank_directory(checkpoint_dir)
    if snapshot is None:
        snapshot = synthetic_cluster(num_nodes)
        if policy is not None or label_churn or taint_churn:
            for i, node in enumerate(snapshot.nodes):
                node.metadata.labels.update(
                    {k: vals[i % len(vals)]
                     for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
    crash_events = []
    if chaos_plan is not None:
        chaos_plan.validate()
        if not chaos_plan.host_sections_empty():
            raise ValueError(
                "run_stream_simulation takes device fault and process_crash "
                "sections only: churn/fabric faults arrive through the load "
                "generator as watch events")
        crash_events = chaos_plan.crash_events()
        if crash_events and checkpoint_dir is None:
            raise ValueError(
                "process_crash faults fire from the WAL writer: pass "
                "checkpoint_dir (--checkpoint-dir)")
    if recover and checkpoint_dir is None:
        raise ValueError("recover=True needs checkpoint_dir")
    if replicate_to is not None and checkpoint_dir is None:
        raise ValueError("replicate_to ships the WAL: pass checkpoint_dir "
                         "(--checkpoint-dir)")
    if replicate_to is not None and recover:
        raise ValueError("replicate_to cannot resume a recovery replay; "
                         "recover first, then re-attach the shipper")
    if recover and verify:
        raise ValueError(
            "verify and recover are mutually exclusive: the verify arm "
            "replays the reference picture from cycle 0")
    breaker = None
    if chaos_plan is not None and not chaos_plan.device.empty():
        from tpusim_torch.backend import install_chaos

        breaker = install_chaos(chaos_plan.device)
    persist = report = shipper = None
    start_cycle = 0
    try:
        if recover:
            session, report, persist = recover_stream_session(
                checkpoint_dir, provider=provider, policy=policy,
                always_restage=always_restage,
                checkpoint_every=checkpoint_every, device=device)
            start_cycle = report.resume_cycle
        else:
            session = StreamSession(snapshot, provider=provider,
                                    policy=policy,
                                    always_restage=always_restage,
                                    device=device)
            if checkpoint_dir is not None:
                persist = StreamPersistence(checkpoint_dir,
                                            checkpoint_every=checkpoint_every,
                                            fsync_every=fsync_every)
                if replicate_to is not None:
                    # hooked BEFORE attach, so the genesis checkpoint's
                    # manifest is the first frame shipped
                    from tpusim_torch.stream.replicate import WalShipper

                    shipper = WalShipper(persist, tuple(replicate_to))
                session.attach_persistence(persist)
    except BaseException:
        if shipper is not None:
            shipper.close(drain=False)
        if persist is not None:
            persist.close()
        if breaker is not None:
            from tpusim_torch.backend import uninstall_chaos

            uninstall_chaos()
        raise
    if crash_events and persist is not None:
        ev = crash_events[0]
        persist.arm_crash(ev.at, ev.target)

    def load_gen():
        return ChurnLoadGen(snapshot, seed=seed, arrivals=arrivals,
                            evict_fraction=evict_fraction,
                            node_flap_every=node_flap_every,
                            label_churn=label_churn, taint_churn=taint_churn,
                            gang_size=gang_size, gang_count=gang_count)

    gen = load_gen()
    skip_events = 0
    if recover:
        # a deterministic fast-forward: the generator draws NO random number
        # in batch() or note_bound(), so replaying events()/batch() over the
        # committed prefix, with the binds fed back from the WAL, leaves its
        # state and the bound population where the crashed run had them
        for c in range(start_cycle):
            gen.events(c)
            by_key = {p.key(): p for p in gen.batch()}
            gen.note_bound([
                Placement(pod=bind_pod(by_key[k], node), node_name=node)
                for k, node in report.bound_by_cycle.get(c, [])
                if k in by_key])
        # a crash among a cycle's events left it partly applied: the
        # replayed picture holds its first events_applied deltas already
        skip_events = report.events_applied.get(start_cycle, 0)
    ref_inc = ref_backend = ref_gen = None
    if verify:
        ref_inc = IncrementalCluster(snapshot)
        ref_backend = TorchBackend(provider=provider, policy=policy,
                                   device=device)
        ref_gen = load_gen()
    chain = hashlib.sha256()
    # the resumable fold over the cycles' placement hashes (persist.chain's
    # twin): seeded from the recovered prefix, so a recovered run's final
    # fold compares byte for byte with an uninterrupted run's
    fold = report.chain if recover else ""
    latencies: List[float] = []
    expected: List[str] = []       # the verify arm's hashes, in order
    counts = {"decisions": 0, "scheduled": 0, "mismatches": 0}

    def account(placements) -> None:
        nonlocal fold
        counts["decisions"] += len(placements)
        counts["scheduled"] += sum(1 for p in placements if p.node_name)
        h = placement_hash(placements)
        chain.update(h.encode())
        fold = chain_fold(fold, h)
        if persist is None:
            # with persistence attached log_emit publishes the WAL's chain
            # head instead
            register_metrics().stream_chain_head.set_info(
                head=fold, cycle=str(session.cycles))
        if verify and expected.pop(0) != h:
            counts["mismatches"] += 1

    # the live what-if queries draw from a stream of their own, so they
    # never move the churn draws
    whatif_rng = RandomState(seed + 9173) if whatif_every else None
    whatif_lat: List[float] = []
    whatif_stats = {"queries": 0, "answered": 0, "fallbacks": 0}

    def live_query(cycle: int) -> None:
        qpods = [make_pod(f"whatif-c{cycle}-p{i}",
                          milli_cpu=int(whatif_rng.randint(100, 1500)),
                          memory=int(whatif_rng.randint(2 ** 20, 2 ** 30)))
                 for i in range(whatif_pods)]
        whatif_stats["queries"] += 1
        tq = perf_counter()
        if session.overlay_query(qpods) is None:
            whatif_stats["fallbacks"] += 1
        else:
            whatif_stats["answered"] += 1
            whatif_lat.append(perf_counter() - tq)

    t_start = perf_counter()
    clean_exit = False
    try:
        for cycle in range(start_cycle, cycles):
            if pipeline:
                # fold cycle N-1's binds BEFORE drawing cycle N's events: the
                # host picture evolves in the synchronous order
                gen.note_bound(session.poll_placed())
            evs = gen.events(cycle)
            if skip_events:
                evs = evs[skip_events:]
                skip_events = 0
            # one trace context a driver cycle: the ingest span and the
            # session's own cycle context (a child, the same trace id) tell
            # one causal story, ingest -> commit -> scan -> fold. start() is
            # None, and all of this a no-op, unless a recorder is installed
            with tracectx.activate(tracectx.start()):
                with flight.span("stream_ingest") as isp:
                    if isp:
                        isp.set("events", len(evs))
                    session.apply_events(evs)
                batch = gen.batch()
                t0 = perf_counter()
                prev = (session.schedule_pipelined(batch) if pipeline
                        else session.schedule(batch))
            latencies.append(perf_counter() - t0)
            if verify:
                # the reference picture advances at dispatch time; the
                # comparison happens when the placements emerge
                ref_inc.apply_events(ref_gen.events(cycle))
                ref_batch = ref_gen.batch()
                if has_gangs(ref_batch):
                    # the gang driver applies its binds to ref_inc itself
                    want = schedule_with_gangs(ref_backend, ref_inc,
                                               ref_batch)
                else:
                    want = ref_backend.schedule(ref_batch,
                                                ref_inc.to_snapshot())
                    for pl in want:
                        if pl.node_name:
                            ref_inc.apply(MODIFIED, pl.pod)
                ref_gen.note_bound(want)
                expected.append(placement_hash(want))
            if pipeline:
                if prev is not None:
                    account(prev)
            else:
                gen.note_bound(prev)
                account(prev)
            if whatif_every and (cycle + 1) % whatif_every == 0:
                live_query(cycle)
        if pipeline:
            tail = session.flush()
            if tail:
                account(tail)
        clean_exit = True
    finally:
        if shipper is not None:
            # a clean end waits for the follower's cumulative ack; a crash
            # passing through here does not (the death model: the unshipped
            # tail lives only in the durable WAL)
            shipper.close(drain=clean_exit, timeout=30.0)
        if persist is not None:
            persist.close()
        if breaker is not None:
            from tpusim_torch.backend import uninstall_chaos

            uninstall_chaos()
    elapsed = perf_counter() - t_start

    def pct(values: List[float], q: float) -> float:
        if not values:
            return 0.0
        values = sorted(values)
        return values[min(len(values) - 1,
                          int(round(q * (len(values) - 1))))]

    decisions = counts["decisions"]
    out = {
        "cycles": cycles, "nodes": len(session.inc.nodes),
        "decisions": decisions, "scheduled": counts["scheduled"],
        "unschedulable": decisions - counts["scheduled"],
        "elapsed_s": elapsed,
        "decisions_per_s": decisions / elapsed if elapsed > 0 else 0.0,
        "p50_cycle_ms": pct(latencies, 0.5) * 1e3,
        "p99_cycle_ms": pct(latencies, 0.99) * 1e3,
        "paths": dict(session.path_counts),
        "restages": dict(session.restage_counts),
        "commits": session.device.commits,
        "placement_chain": chain.hexdigest(),
        "fold_chain": fold,
        "load": dict(gen.stats),
    }
    if whatif_every:
        out["overlay"] = {
            **whatif_stats,
            "p50_query_ms": pct(whatif_lat, 0.5) * 1e3,
            "p99_query_ms": pct(whatif_lat, 0.99) * 1e3,
        }
    if verify:
        out["verified"] = counts["mismatches"] == 0
        out["mismatched_cycles"] = counts["mismatches"]
    if breaker is not None:
        out["breaker_transitions"] = list(breaker.transitions)
    if persist is not None:
        out["wal_records"] = persist.wal_records
        out["checkpoints"] = persist.checkpoints
        out["wal_chain"] = persist.chain
    if shipper is not None:
        out["replication_acked_seq"] = shipper.acked_seq
        out["replication_acked_chain"] = shipper.acked_chain
        out["replication_lag_at_close"] = shipper.lag_records()
    if recover:
        out["recovered"] = True
        out["resume_cycle"] = start_cycle
        out["replay_ms"] = report.replay_s * 1e3
        out["recomputed_cycles"] = list(report.recomputed)
        out["recovery_violations"] = list(report.violations)
    # with the analytics plane installed, the run's snapshot of it (a
    # None-check otherwise)
    alog = analytics.get()
    if alog is not None:
        alog.flush()
        out["analytics"] = alog.snapshot()
    return out


# the mesh tags of an in-process replicated pair's twins (sharding.make_mesh)
LEADER_MESH = ""
FOLLOWER_MESH = "follower"


def _twin_meshes(device, tags) -> None:
    """Under TPUSIM_SHARDS=k in a default process group of k ranks, build
    the node mesh of each tag now, on this thread and in this order on
    every rank (building one is a collective of the default group); the
    twins' restages then find them built. Nothing happens otherwise."""
    import torch.distributed as dist

    from tpusim_torch.backend import _shard_count
    from tpusim_torch.device import resolve_device
    from tpusim_torch.sharding import make_mesh

    n_shards = _shard_count()
    if n_shards <= 1 or not (dist.is_available() and dist.is_initialized()
                             and dist.get_world_size() == n_shards):
        return
    for tag in tags:
        make_mesh(n_shards, snap=1, device_type=resolve_device(device).type,
                  tag=tag)


def run_replicated_stream(snapshot: Optional[ClusterSnapshot] = None, *,
                          num_nodes: int = 64, cycles: int = 50,
                          arrivals: int = 32, evict_fraction: float = 0.25,
                          node_flap_every: int = 0,
                          label_churn: int = 0, taint_churn: int = 0,
                          gang_size: int = 0, gang_count: int = 0,
                          seed: int = 0,
                          provider: str = DEFAULT_PROVIDER,
                          policy=None, pipeline: bool = False,
                          always_restage: bool = False,
                          chaos_plan: Optional[object] = None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 1,
                          fsync_every: int = 0,
                          drain_timeout: float = 30.0,
                          device="cuda") -> dict:
    """Drive a LEADER stream.StreamSession with a live FollowerTwin attached
    over the WAL-shipping socket protocol (stream.replicate).

    Without a chaos plan this is a replicated steady-state run: the summary
    gives the follower's chain head beside the leader's (byte-identical
    after a drain) and the shipping lag the run sustained.

    With a process_crash plan (chaos.plan.kill_leader_campaign) the leader
    dies at the targeted WAL record; a FailoverController detects the death
    and promotes the follower (the byte-identical chain head is the
    promotion's invariant, and it replays ONLY the unshipped WAL tail), and
    the churn load generator resumes from the WAL position on the promoted
    twin for the remaining cycles. The summary's fold_chain then equals an
    uninterrupted run's, and rto_s measures the death's detection to the
    promotion, end to end; promote_s is the part of it the promotion's own
    work took under the twin's lock (the tail replay, the cycles settled
    or decided again and the closing checkpoint).

    The leader runs on the caller's thread and the follower on its pump
    thread, both on `device` ("cuda" by default, or "cpu"), each capturing
    its own CUDA graphs (scan._Steps serializes the captures). An error in
    the follower's twin raises here; only a chaos DeviceFault reaches a
    breaker. The summary's "graphs" counts the CUDA graphs each side's twin
    captured (0 on the CPU).

    Under TPUSIM_SHARDS=k every rank of a default process group of k ranks
    makes this same call and runs a pair of its own, journaling to
    checkpoint_dir on rank 0 and <checkpoint_dir>.rank<r> on rank r; the
    leader's twin and the follower's take node meshes on process groups of
    their own, built here on the caller's thread before the follower's
    pump starts."""
    from time import monotonic

    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backends import Placement, bind_pod
    from tpusim_torch.chaos.engine import ProcessCrash
    from tpusim_torch.stream import ChurnLoadGen, StreamPersistence, \
        StreamSession
    from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE
    from tpusim_torch.stream.replicate import (
        FailoverController,
        FollowerTwin,
        WalShipper,
    )

    if checkpoint_dir is None:
        raise ValueError("run_replicated_stream needs checkpoint_dir: the "
                         "WAL is the replication substrate")
    from tpusim_torch.sharding import rank_directory

    checkpoint_dir = rank_directory(checkpoint_dir)
    _twin_meshes(device, (LEADER_MESH, FOLLOWER_MESH))

    def make_snap():
        # fresh object graphs for each consumer: the leader, the follower
        # and each load generator never share mutable node or pod objects
        if snapshot is not None:
            return snapshot
        snap = synthetic_cluster(num_nodes)
        if policy is not None or label_churn or taint_churn:
            for i, node in enumerate(snap.nodes):
                node.metadata.labels.update(
                    {k: vals[i % len(vals)]
                     for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
        return snap

    crash_events = []
    if chaos_plan is not None:
        chaos_plan.validate()
        if not chaos_plan.host_sections_empty() \
                or not chaos_plan.device.empty():
            raise ValueError(
                "run_replicated_stream takes process_crash sections only "
                "(kill-the-leader campaigns); churn arrives through the "
                "load generator and device faults through the breaker arm")
        crash_events = chaos_plan.crash_events()

    def load_gen():
        return ChurnLoadGen(make_snap(), seed=seed, arrivals=arrivals,
                            evict_fraction=evict_fraction,
                            node_flap_every=node_flap_every,
                            label_churn=label_churn, taint_churn=taint_churn,
                            gang_size=gang_size, gang_count=gang_count)

    follower = FollowerTwin(make_snap(), provider=provider, policy=policy,
                            always_restage=always_restage, device=device,
                            mesh_tag=FOLLOWER_MESH)
    leader = StreamSession(make_snap(), provider=provider, policy=policy,
                           always_restage=always_restage, device=device,
                           mesh_tag=LEADER_MESH)
    persist = StreamPersistence(checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                fsync_every=fsync_every)
    shipper = WalShipper(persist, follower.address)
    leader.attach_persistence(persist)
    if crash_events:
        ev = crash_events[0]
        persist.arm_crash(ev.at, ev.target)
    gen = load_gen()

    latencies: List[float] = []
    crashed: Optional[str] = None
    lag_at_crash = 0
    leader_alive = [True]

    def run_cycles(session, g, start: int, skip_events: int) -> None:
        skip = skip_events
        for cycle in range(start, cycles):
            if pipeline:
                g.note_bound(session.poll_placed())
            evs = g.events(cycle)
            if skip:
                evs = evs[skip:]
                skip = 0
            session.apply_events(evs)
            batch = g.batch()
            t0 = perf_counter()
            prev = (session.schedule_pipelined(batch) if pipeline
                    else session.schedule(batch))
            latencies.append(perf_counter() - t0)
            if not pipeline:
                g.note_bound(prev)
        if pipeline:
            session.flush()

    def drain() -> bool:
        # in short waits, so that a follower whose twin failed raises now
        # instead of timing the drain out
        deadline = monotonic() + drain_timeout
        while True:
            if follower.error is not None:
                raise RuntimeError(f"the follower twin failed applying a "
                                   f"record: {follower.error}"
                                   ) from follower.error
            remaining = deadline - monotonic()
            if remaining <= 0:
                return False
            if shipper.drain(min(0.5, remaining)):
                return True

    t_start = perf_counter()
    try:
        try:
            run_cycles(leader, gen, 0, 0)
        except ProcessCrash as exc:
            crashed = str(exc)
            leader_alive[0] = False
            lag_at_crash = shipper.lag_records()
            # the leader's death: nothing drains; the wire keeps only what
            # it carried already, the durable WAL everything
            shipper.close(drain=False)
            persist.close()

        out: dict = {
            "cycles": cycles, "pipeline": pipeline,
            "crashed": crashed is not None, "crash_detail": crashed,
            "promoted": False, "divergence": None,
        }
        if crashed is None:
            # the steady-state shipping backlog: records appended and not
            # acked the instant the producer stops (a drain clears it)
            lag_at_loop_end = shipper.lag_records()
            drained = drain()
            shipper.close(drain=False)
            out.update({
                "drained": drained,
                "lag_at_loop_end": lag_at_loop_end,
                "fold_chain": persist.chain,
                "follower_chain": follower.chain,
                "follower_chain_matches": follower.chain == persist.chain,
                "wal_records": persist.wal_records,
                "checkpoints": persist.checkpoints,
                "decisions": persist.decisions,
                "scheduled": persist.scheduled,
                "applied_records": follower.wal_records_applied,
                "divergence": follower.diverged,
                "restages": dict(leader.restage_counts),
                "follower_restages": dict(follower.session.restage_counts),
                "graphs": {"leader": leader.device.graphs(),
                           "follower": follower.session.device.graphs()},
            })
            persist.close()
            follower.stop()
        else:
            controller = FailoverController(
                lambda: leader_alive[0], [follower], checkpoint_dir,
                interval_s=0.005, misses=2,
                checkpoint_every=checkpoint_every, fsync_every=fsync_every,
                leader_was_alive=True)
            promoted, preport = controller.run(timeout=30.0)
            resume_cycle = preport.resume_cycle
            # resume the load generator from the WAL position: batch() and
            # note_bound() draw no random number, so replaying the
            # committed prefix with the binds fed back from the replicated
            # and replayed bind maps leaves it where the dead leader had it
            gen2 = load_gen()
            for c in range(resume_cycle):
                gen2.events(c)
                by_key = {p.key(): p for p in gen2.batch()}
                gen2.note_bound([
                    Placement(pod=bind_pod(by_key[k], node), node_name=node)
                    for k, node in promoted.bound_by_cycle.get(c, [])
                    if k in by_key])
            skip_events = promoted.events_applied.get(resume_cycle, 0)
            final_persist = promoted.persist
            try:
                run_cycles(promoted.session, gen2, resume_cycle, skip_events)
            finally:
                final_persist.close()
            out.update({
                "promoted": True,
                "rto_s": preport.rto_s,
                "promote_s": preport.replay_s,
                "resume_cycle": resume_cycle,
                "replayed_records": preport.tail_records,
                "applied_records": preport.applied_records,
                "recomputed_cycles": list(preport.recomputed),
                "settled_live_cycles": list(preport.settled_live),
                "promotion_violations": list(preport.violations),
                "lag_at_crash": lag_at_crash,
                "fold_chain": final_persist.chain,
                "wal_records": final_persist.wal_records,
                "checkpoints": final_persist.checkpoints,
                "decisions": final_persist.decisions,
                "scheduled": final_persist.scheduled,
                "divergence": promoted.diverged,
                "restages": dict(leader.restage_counts),
                "follower_restages": dict(promoted.session.restage_counts),
                "graphs": {"leader": leader.device.graphs(),
                           "follower": promoted.session.device.graphs()},
            })
    finally:
        # nothing of the pair outlives the call, whatever raised
        shipper.close(drain=False, timeout=0.0)
        persist.close()
        follower.stop()
    elapsed = perf_counter() - t_start
    latencies.sort()
    out["elapsed_s"] = elapsed
    out["nodes"] = num_nodes
    out["p50_cycle_ms"] = (latencies[len(latencies) // 2] * 1e3
                           if latencies else 0.0)
    return out
