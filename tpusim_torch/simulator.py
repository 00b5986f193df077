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
from typing import Dict, List, Optional

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
                 storage_classes: Optional[list] = None):
        self.config = config
        self.status = Status()
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
        # MakeDefaultErrorFunc's backoff state: the loop records backoff and
        # never waits on it
        self.pod_backoff = PodBackoff()
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
        updated = stored.copy()
        updated.spec.node_name = node_name
        updated.status.phase = "Running"
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
        # the algorithm runs against the cache's generation-checked snapshot,
        # not the live view (generic_scheduler.go:129)
        node_infos = self.refresh_node_info_snapshot()
        try:
            host = self.scheduler.schedule(pod, self.nodes, node_infos)
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
            self.cache.assume_pod(assumed)
        except CacheError as cache_err:
            # assume error arm (scheduler.go:377-380 → config.Error): the pod
            # is reported failed, the run continues — e.g. a fed pod whose
            # namespace/name collides with an already-cached pod
            return self._fail(pod, str(cache_err))
        try:
            self.bind(pod, host)
        except SchedulingError:
            # bind error arm (scheduler.go:484-496): forget the assumed pod
            # so its resources are returned, then surface the error
            self.cache.forget_pod(assumed)
            raise
        self.cache.finish_binding(assumed)  # no-op once confirmed
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
        bound: List[Pod] = []
        overflow: List[Pod] = []
        for member in group.pods:
            _stored, exists = self.resource_store.get(
                ResourceType.PODS, member.key())
            if not exists:
                self.resource_store.add(ResourceType.PODS, member)
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
        for p in self.scheduling_queue.clear_nominations_for_gangs(names):
            p.status.nominated_node_name = ""

    def attempt_preemption(self, pod: Pod, fit_err: FitError,
                           candidate_filter=None):
        """The preemption arm of scheduleOne (scheduler.go:449-455 → the full
        Preempt pipeline, core/generic_scheduler.go:205-262): pick a node +
        victims, delete the victims from the store (mutating the cache through
        the DELETED events), and nominate the pod. Returns (node, victims) —
        node is None when preemption found nothing. Shared by the host loop
        (_schedule_one retry) and the preemption hybrid (preempt.py), which
        may prefilter the candidate nodes (GenericScheduler.preempt)."""
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
        return self.commit_preemption(pod, node, victims, to_clear)

    def commit_preemption(self, pod: Pod, node, victims, to_clear):
        """The side-effect half of attempt_preemption (preempt.go:45-75):
        clear losing nominations, nominate the pod, delete the victims from
        the store (mutating the cache through the DELETED events) and emit
        the Preempted events. The hybrid's device victim arm commits a
        kernel-picked (node, victims) through this same sequence."""
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
        queue drains; the stop-reason strings match the Go format verbatim."""
        outcome = "run"
        pod = self._next_pod()
        while pod is not None:
            outcome = self._schedule_or_admit(pod)
            pod = self._next_pod()
        self.status.stop_reason = self.STOP_REASONS[outcome]
        self.close()

    def close(self) -> None:
        self.closed = True

    def get_report(self) -> GeneralReview:
        if self.report is None:
            self.report = get_report(self.status)
        return self.report


def auto_routes_to_host(num_pods: int, num_nodes: int,
                        enable_volume_scheduling: bool = False) -> bool:
    """The backend="auto" rule: a workload under TPUSIM_AUTO_THRESHOLD
    (100,000) pod × node pairs runs on the host route, where a device
    dispatch would cost more than it saves. Volume scheduling is host-bound
    and wins over everything."""
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
                   feature_gates: Optional[Dict[str, bool]] = None,
                   device="cuda", route: str = "auto",
                   hard_pod_affinity_symmetric_weight: int = 10,
                   extender_transport=None) -> Status:
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
    for the JAX package's signature; as there, nothing reads it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
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
            storage_classes=snapshot.storage_classes)
        cc.run()
        return cc.status
    if enable_pod_priority:
        # the host-device hybrid: the device scan places, victim selection
        # runs on the device or the exact host pipeline (preempt.py)
        from tpusim_torch.preempt import run_with_preemption

        return run_with_preemption(
            pods, snapshot, provider=provider,
            hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
            device=device, route=route)
    from tpusim_torch.backend import TorchBackend

    torch_backend = TorchBackend(
        provider=provider, device=device,
        hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
        policy=policy, route=route, extender_transport=extender_transport)
    feed = list(reversed(pods))  # the LIFO queue pops the last element first
    if has_gangs(feed):
        # the gang driver: ungrouped runs take the per-pod path against the
        # live incremental cluster, gangs are admitted all or nothing
        from tpusim_torch.delta import IncrementalCluster
        from tpusim_torch.gang.driver import schedule_with_gangs

        placements = schedule_with_gangs(torch_backend,
                                         IncrementalCluster(snapshot), feed)
    else:
        placements = torch_backend.schedule(feed, snapshot)
    return _status_from_placements(placements, snapshot)


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
    device: "cuda" (the default) or "cpu".

    The JAX package's chaos_plan, checkpoint_dir, checkpoint_every,
    fsync_every, replicate_to and recover are not taken: their modules are
    not ported yet."""
    import hashlib
    from time import perf_counter

    from numpy.random import RandomState

    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.delta import IncrementalCluster
    from tpusim_torch.gang.driver import schedule_with_gangs
    from tpusim_torch.stream import ChurnLoadGen, StreamSession, chain_fold
    from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE

    if snapshot is None:
        snapshot = synthetic_cluster(num_nodes)
        if policy is not None or label_churn or taint_churn:
            for i, node in enumerate(snapshot.nodes):
                node.metadata.labels.update(
                    {k: vals[i % len(vals)]
                     for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
    session = StreamSession(snapshot, provider=provider, policy=policy,
                            always_restage=always_restage, device=device)

    def load_gen():
        return ChurnLoadGen(snapshot, seed=seed, arrivals=arrivals,
                            evict_fraction=evict_fraction,
                            node_flap_every=node_flap_every,
                            label_churn=label_churn, taint_churn=taint_churn,
                            gang_size=gang_size, gang_count=gang_count)

    gen = load_gen()
    ref_inc = ref_backend = ref_gen = None
    if verify:
        ref_inc = IncrementalCluster(snapshot)
        ref_backend = TorchBackend(provider=provider, policy=policy,
                                   device=device)
        ref_gen = load_gen()
    chain = hashlib.sha256()
    fold = ""
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
    for cycle in range(cycles):
        if pipeline:
            # fold cycle N-1's binds BEFORE drawing cycle N's events: the
            # host picture evolves in the synchronous order
            gen.note_bound(session.poll_placed())
        session.apply_events(gen.events(cycle))
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
                want = schedule_with_gangs(ref_backend, ref_inc, ref_batch)
            else:
                want = ref_backend.schedule(ref_batch, ref_inc.to_snapshot())
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
    return out
