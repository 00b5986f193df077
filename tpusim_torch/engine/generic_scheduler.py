"""The core scheduling algorithm: findNodesThatFit → PrioritizeNodes → selectHost.

Reference: core/generic_scheduler.go. The 16-way goroutine fan-out over nodes
(:348, :607) is replaced here by plain loops (the host route is the
semantics oracle; the device routes own performance).

Tie-break parity note (SURVEY.md §7 hard part 2): the Go selectHost does
``sort.Sort(sort.Reverse(priorityList))`` — an UNSTABLE sort keyed on score
only — then round-robins over the maximal-score prefix with a persistent
``lastNodeIndex`` counter (:183-198). Go's unstable tie order is an artifact of
its introsort; we define the parity semantics as a STABLE descending sort (ties
keep node-list order), which both backends implement identically.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from time import perf_counter as _now
from typing import Callable, Dict, List, Optional

from tpusim_torch.api.types import Node, Pod
from tpusim_torch.engine import errors as err
from tpusim_torch.engine.errors import (
    FailureReason,
    PredicateError,
    PredicateFailureReason,
)
from tpusim_torch.engine.predicates import (
    CHECK_NODE_CONDITION_PRED,
    CHECK_NODE_DISK_PRESSURE_PRED,
    CHECK_NODE_LABEL_PRESENCE_PRED,
    CHECK_NODE_MEMORY_PRESSURE_PRED,
    CHECK_NODE_UNSCHEDULABLE_PRED,
    CHECK_VOLUME_BINDING_PRED,
    HOSTNAME_PRED,
    MATCH_NODE_SELECTOR_PRED,
    NO_VOLUME_ZONE_CONFLICT_PRED,
    POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
    POD_TOLERATES_NODE_TAINTS_PRED,
    PREDICATES_ORDERING,
    PredicateMetadata,
    get_predicate_metadata,
)
from tpusim_torch.engine.priorities import HostPriority, PriorityConfig
from tpusim_torch.engine.resources import NodeInfo, get_resource_request
from tpusim_torch.engine.trace import Trace
from tpusim_torch.framework.metrics import (
    register as register_metrics,
    since_in_microseconds,
)
from tpusim_torch.obs import recorder as flight
from tpusim_torch.engine.util import (
    MAX_INT32,
    get_pod_priority as util_get_pod_priority,
    sort_by_priority_desc,
)

NO_NODE_AVAILABLE_MSG = "0/{} nodes are available"

log = logging.getLogger(__name__)

# Predicates whose outcome is a function of (pod, node statics) only — they
# never read node_info.pods / used_ports / meta's matching terms, so once they
# pass on the fully-stripped node (selectVictimsOnNode's first fit) they pass
# for every victim subset and the reprieve loop may skip them. Unknown or
# policy-registered predicate names are conservatively treated as dependent.
_POD_SET_INDEPENDENT_PREDS = frozenset({
    CHECK_NODE_CONDITION_PRED, CHECK_NODE_UNSCHEDULABLE_PRED, HOSTNAME_PRED,
    MATCH_NODE_SELECTOR_PRED, POD_TOLERATES_NODE_TAINTS_PRED,
    POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED, CHECK_NODE_LABEL_PRESENCE_PRED,
    CHECK_VOLUME_BINDING_PRED, NO_VOLUME_ZONE_CONFLICT_PRED,
    CHECK_NODE_MEMORY_PRESSURE_PRED, CHECK_NODE_DISK_PRESSURE_PRED,
})
_REPRIEVE_ORDERING = [k for k in PREDICATES_ORDERING
                      if k not in _POD_SET_INDEPENDENT_PREDS]


class SchedulingError(Exception):
    pass


class FitError(SchedulingError):
    """Reference: generic_scheduler.go:51-90 — aggregates per-node predicate
    failures into the sorted reason-histogram message."""

    def __init__(self, pod: Pod, num_all_nodes: int,
                 failed_predicates: Dict[str, List[PredicateFailureReason]]):
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.failed_predicates = failed_predicates
        super().__init__(self.error())

    def reason_histogram(self) -> Dict[str, int]:
        """Per-pod attribution: failure reason -> number of nodes rejected
        for it (the aggregation behind error(), exposed for telemetry)."""
        reasons: Dict[str, int] = {}
        for preds in self.failed_predicates.values():
            for reason in preds:
                key = reason.get_reason()
                reasons[key] = reasons.get(key, 0) + 1
        return reasons

    def error(self) -> str:
        reasons = self.reason_histogram()
        reason_strings = sorted(f"{v} {k}" for k, v in reasons.items())
        return (NO_NODE_AVAILABLE_MSG.format(self.num_all_nodes)
                + ": " + ", ".join(reason_strings) + ".")


ERR_NO_NODES_AVAILABLE = SchedulingError("no nodes available to schedule pods")


@dataclass
class ScheduleResult:
    suggested_host: str
    evaluated_nodes: int = 0
    feasible_nodes: int = 0


class GenericScheduler:
    """Reference: generic_scheduler.go:93-200 (genericScheduler struct + Schedule)."""

    def __init__(
        self,
        predicates: Dict[str, Callable],
        prioritizers: List[PriorityConfig],
        predicate_meta_producer: Callable = get_predicate_metadata,
        priority_meta_producer: Optional[Callable] = None,
        extenders: Optional[list] = None,
        always_check_all_predicates: bool = False,
        equivalence_cache=None,
        scheduling_queue=None,
        pdb_lister: Optional[Callable[[], list]] = None,
    ):
        self.predicates = predicates
        self.prioritizers = prioritizers
        self.predicate_meta_producer = predicate_meta_producer
        self.priority_meta_producer = priority_meta_producer
        self.extenders = extenders or []
        self.always_check_all_predicates = always_check_all_predicates
        self.equivalence_cache = equivalence_cache
        self.scheduling_queue = scheduling_queue
        self.pdb_lister = pdb_lister or (lambda: [])
        self.last_node_index = 0  # persistent round-robin counter (:97)
        # Ordered keys first; then custom (policy-registered) keys that are not
        # in the fixed ordering, alphabetically. DELIBERATE DEVIATION: the
        # reference vintage iterates only predicates.Ordering()
        # (generic_scheduler.go:467), silently skipping custom policy
        # predicates — a known kube bug fixed in 1.11 by evaluating the extra
        # keys; reproducing it would make PredicateArgument configs dead weight.
        self._predicate_key_order = list(PREDICATES_ORDERING) + sorted(
            k for k in self.predicates if k not in PREDICATES_ORDERING)
        self._metrics = register_metrics()

    # --- filter phase ---

    def _add_nominated_pods(self, pod_priority: int,
                            meta: Optional[PredicateMetadata],
                            node_info: NodeInfo):
        """generic_scheduler.go addNominatedPods: clone state with the node's
        nominated pods of >= priority added; returns (added, meta', info')."""
        if self.scheduling_queue is None or node_info.node is None:
            return False, meta, node_info
        nominated = self.scheduling_queue.waiting_pods_for_node(node_info.node.name)
        nominated = [p for p in nominated
                     if util_get_pod_priority(p) >= pod_priority]
        if not nominated:
            return False, meta, node_info
        meta_copy = meta.shallow_copy() if meta is not None else None
        info_copy = node_info.clone()
        for p in nominated:
            info_copy.add_pod(p)
            if meta_copy is not None:
                meta_copy.add_pod(p, info_copy.node)
        return True, meta_copy, info_copy

    def pod_fits_on_node(self, pod: Pod, meta: Optional[PredicateMetadata],
                         node_info: NodeInfo) -> tuple[bool, List[PredicateFailureReason]]:
        """Reference: generic_scheduler.go:420-534 — predicates run in
        PREDICATES_ORDERING with short-circuit; when nominated pods exist the
        loop runs twice (once with them added, once without) and the
        equivalence cache is consulted only on the clean pass."""
        fails: List[PredicateFailureReason] = []
        pods_added = False
        ecache = self.equivalence_cache
        equiv_hash = (ecache.get_equivalence_class_hash(pod)
                      if ecache is not None else None)
        for i in range(2):
            meta_to_use, info_to_use = meta, node_info
            if i == 0:
                pods_added, meta_to_use, info_to_use = self._add_nominated_pods(
                    util_get_pod_priority(pod), meta, node_info)
            elif not pods_added or fails:
                break
            ecache_available = ecache is not None and not pods_added
            for pred_key in self._predicate_key_order:
                predicate = self.predicates.get(pred_key)
                if predicate is None:
                    continue
                if ecache_available:
                    fit, reasons = ecache.run_predicate(
                        predicate, pred_key, pod, meta_to_use, info_to_use,
                        equiv_hash)
                else:
                    fit, reasons = predicate(pod, meta_to_use, info_to_use)
                if not fit:
                    fails.extend(reasons)
                    if not self.always_check_all_predicates:
                        break
        return (not fails), fails

    def find_nodes_that_fit(self, pod: Pod, nodes: List[Node],
                            node_info_map: Dict[str, NodeInfo]
                            ) -> tuple[List[Node], Dict[str, List[PredicateFailureReason]]]:
        """Reference: generic_scheduler.go:289-377."""
        if not self.predicates:
            filtered = list(nodes)
            failed: Dict[str, List[PredicateFailureReason]] = {}
        else:
            meta = self.predicate_meta_producer(pod, node_info_map)
            filtered = []
            failed = {}
            errs: Dict[str, int] = {}
            for node in nodes:
                try:
                    fits, fails = self.pod_fits_on_node(
                        pod, meta, node_info_map[node.name])
                except PredicateError as exc:
                    # checkNode error arm: the message is counted, the node is
                    # neither fit nor failed (generic_scheduler.go:330-340)
                    errs[str(exc)] = errs.get(str(exc), 0) + 1
                    continue
                if fits:
                    filtered.append(node)
                else:
                    failed[node.name] = fails
            if errs:
                # CreateAggregateFromMessageCountMap: scheduling of the pod
                # aborts with the aggregated message (generic_scheduler.go:341-343)
                messages = [m if c == 1 else f"{m} (repeated {c} times)"
                            for m, c in errs.items()]
                raise SchedulingError(
                    messages[0] if len(messages) == 1
                    else "[" + ", ".join(messages) + "]")
        if filtered and self.extenders:
            # extender filters run after the built-in predicates; failures are
            # appended as plain-message reasons (generic_scheduler.go:355-376)
            for extender in self.extenders:
                if not extender.is_interested(pod):
                    continue
                try:
                    filtered, failed_map = extender.filter(pod, filtered,
                                                           node_info_map)
                except SchedulingError:
                    raise
                except Exception as exc:
                    # a filter transport/result error fails this pod's
                    # scheduling attempt, never the whole simulation
                    # (generic_scheduler.go:360-363 → scheduleOne error arm)
                    raise SchedulingError(f"extender filter failed: {exc}")
                for name, msg in failed_map.items():
                    failed.setdefault(name, []).append(FailureReason(msg))
                if not filtered:
                    break
        return filtered, failed

    # --- score phase ---

    def prioritize_nodes(self, pod: Pod, node_info_map: Dict[str, NodeInfo],
                         nodes: List[Node]) -> List[HostPriority]:
        """Reference: generic_scheduler.go:542-680."""
        # If no priority configs and no extenders: all nodes score 1 (:556-571).
        if not self.prioritizers and not self.extenders:
            return [HostPriority(n.name, 1) for n in nodes]

        meta = self.priority_meta_producer(pod) if self.priority_meta_producer else None

        # map phase per config (nodes × maps), then per-config reduce
        results: List[List[HostPriority]] = []
        for config in self.prioritizers:
            if config.function is not None:
                results.append(config.function(pod, node_info_map, nodes))
            else:
                per_node = [config.map_fn(pod, meta, node_info_map[n.name]) for n in nodes]
                results.append(per_node)
        for i, config in enumerate(self.prioritizers):
            if config.reduce_fn is not None:
                config.reduce_fn(pod, meta, node_info_map, results[i])

        # per-priority score dump at high verbosity (the reference's V(10)
        # "%v -> %v: %v, Score: (%d)" lines, generic_scheduler.go:618-622);
        # answers "why did node X win" when a placement surprises
        dump = log.isEnabledFor(logging.DEBUG)
        if dump:
            for j, config in enumerate(self.prioritizers):
                for hp in results[j]:
                    log.debug("%s/%s -> %s: %s, Score: (%d)", pod.namespace,
                              pod.name, hp.host, config.name, hp.score)

        # weighted sum (:631-639)
        result = []
        for i, node in enumerate(nodes):
            total = 0
            for j, config in enumerate(self.prioritizers):
                total += results[j][i].score * config.weight
            result.append(HostPriority(node.name, total))

        if self.extenders:
            # extender prioritize errors are ignored — k8s/other extenders
            # determine the priorities (generic_scheduler.go:649-653)
            combined = {hp.host: hp.score for hp in result}
            for extender in self.extenders:
                if not extender.is_interested(pod):
                    continue
                try:
                    prioritized_list, weight = extender.prioritize(pod, nodes)
                except Exception:
                    continue
                for hp in prioritized_list:
                    # hosts outside the candidate list are harmless, matching
                    # the Go map semantics (combinedScores auto-zeroes and is
                    # only read back for candidate hosts)
                    if hp.host in combined:
                        combined[hp.host] += hp.score * weight
            result = [HostPriority(n.name, combined[n.name]) for n in nodes]
        if dump:
            # aggregate dump, post-extender like the reference
            # (generic_scheduler.go:670-674)
            for hp in result:
                log.debug("Host %s => Score %d", hp.host, hp.score)
        return result

    # --- select phase ---

    def select_host(self, priority_list: List[HostPriority]) -> str:
        """Reference: generic_scheduler.go:183-198 — stable sort desc by score,
        round-robin among the top-score ties via the persistent counter."""
        if not priority_list:
            raise SchedulingError("empty priorityList")
        ordered = sorted(priority_list, key=lambda hp: -hp.score)
        max_score = ordered[0].score
        first_after_max = 1
        while first_after_max < len(ordered) and ordered[first_after_max].score == max_score:
            first_after_max += 1
        ix = self.last_node_index % first_after_max
        self.last_node_index += 1
        return ordered[ix].host

    # --- the pipeline ---

    def schedule(self, pod: Pod, nodes: List[Node],
                 node_info_map: Dict[str, NodeInfo]) -> str:
        """Reference: generic_scheduler.go:112-180 — incl. the per-pod
        utiltrace ("Scheduling ns/name", logged >100ms, :113-114) and the
        predicate/priority evaluation histograms (:148,154,163)."""
        trace = Trace(f"Scheduling {pod.namespace}/{pod.name}")
        metrics = self._metrics
        try:
            if not nodes:
                raise ERR_NO_NODES_AVAILABLE
            start = _now()
            with flight.span("predicates") as fsp:
                filtered, failed_predicate_map = self.find_nodes_that_fit(
                    pod, nodes, node_info_map)
                if fsp:
                    fsp.set("nodes", len(nodes))
                    fsp.set("feasible", len(filtered))
            metrics.predicate_evaluation.observe(since_in_microseconds(start))
            trace.step("Computing predicates")
            if not filtered:
                fit_err = FitError(pod, len(nodes), failed_predicate_map)
                if flight.get_recorder() is not None:
                    flight.instant("fit_error", "host", {
                        "pod": f"{pod.namespace}/{pod.name}",
                        "nodes": len(nodes),
                        "reasons": fit_err.reason_histogram(),
                    })
                raise fit_err
            start = _now()
            if len(filtered) == 1:
                metrics.priority_evaluation.observe(since_in_microseconds(start))
                return filtered[0].name
            with flight.span("priorities"):
                priority_list = self.prioritize_nodes(pod, node_info_map,
                                                      filtered)
            metrics.priority_evaluation.observe(since_in_microseconds(start))
            trace.step("Prioritizing")
            with flight.span("select_host"):
                host = self.select_host(priority_list)
            trace.step("Selecting host")
            return host
        finally:
            trace.log_if_long()

    # --- preemption (generic_scheduler.go:205-1000) ---
    # Dormant by default: pod priority is feature-gated off at the reference's
    # defaults (scheduler.go:210-213 via util.PodPriorityEnabled); the
    # simulator enables it through SchedulerServerConfig.enable_pod_priority.

    # predicate failures that removing pods can never fix
    # (nodesWherePreemptionMightHelp)
    _UNRESOLVABLE = {
        err.ERR_NODE_SELECTOR_NOT_MATCH, err.ERR_POD_NOT_MATCH_HOST_NAME,
        err.ERR_TAINTS_TOLERATIONS_NOT_MATCH, err.ERR_NODE_LABEL_PRESENCE_VIOLATED,
        err.ERR_NODE_NOT_READY, err.ERR_NODE_NETWORK_UNAVAILABLE,
        err.ERR_NODE_UNSCHEDULABLE, err.ERR_NODE_UNKNOWN_CONDITION,
        err.ERR_VOLUME_ZONE_CONFLICT, err.ERR_VOLUME_NODE_CONFLICT,
        err.ERR_VOLUME_BIND_CONFLICT,
    }

    def preempt(self, pod: Pod, nodes: List[Node],
                node_info_map: Dict[str, NodeInfo], schedule_err: Exception,
                candidate_filter=None):
        """Returns (node, victims, nominated_pods_to_clear).

        candidate_filter: optional `name -> bool` prefilter over potential
        nodes; callers may pass one ONLY when it provably excludes just nodes
        where _select_victims_on_node would return fits=False (e.g. the
        vectorized lower-priority resource bound of the preemption hybrid),
        so the outcome is identical to the unfiltered pipeline."""
        if not isinstance(schedule_err, FitError):
            return None, [], []
        if not self._pod_eligible_to_preempt_others(pod, node_info_map):
            return None, [], []
        if not nodes:
            raise ERR_NO_NODES_AVAILABLE
        potential = self._nodes_where_preemption_might_help(
            nodes, schedule_err.failed_predicates)
        if not potential:
            # clean up any existing nominated node name of the pod (:231-234)
            return None, [], [pod]
        if candidate_filter is not None:
            # an emptied list matches the all-candidates-unfit path below
            # (empty node_to_victims -> None without clearing nominations),
            # NOT the no-potential-nodes arm above
            potential = [n for n in potential if candidate_filter(n.name)]
            if not potential:
                return None, [], []
        pdbs = self.pdb_lister()
        node_to_victims = self._select_nodes_for_preemption(
            pod, node_info_map, potential, pdbs)
        by_name = {n.name: n for n in nodes}
        while node_to_victims:
            name = self._pick_one_node_for_preemption(node_to_victims)
            if name is None:
                return None, [], []
            victims, _ = node_to_victims[name]
            if self._node_passes_extenders_for_preemption(pod, name, victims,
                                                          node_info_map):
                nominated = self._get_lower_priority_nominated_pods(pod, name)
                return by_name[name], victims, nominated
            del node_to_victims[name]
        return None, [], []

    def _pod_eligible_to_preempt_others(self, pod: Pod,
                                        node_info_map: Dict[str, NodeInfo]) -> bool:
        """podEligibleToPreemptOthers: don't preempt again while a prior
        preemption's victims are still terminating on the nominated node.
        The offline simulator deletes victims synchronously, so the terminating
        state never materializes and this returns True (matching the reference
        when no DeletionTimestamp is set)."""
        nom = pod.status.nominated_node_name
        if nom and nom in node_info_map:
            for p in node_info_map[nom].pods:
                if (getattr(p.metadata, "deletion_timestamp", None) is not None
                        and util_get_pod_priority(p) < util_get_pod_priority(pod)):
                    return False
        return True

    def _nodes_where_preemption_might_help(self, nodes: List[Node],
                                           failed_predicates) -> List[Node]:
        potential = []
        for node in nodes:
            fails = failed_predicates.get(node.name, [])
            if any(f in self._UNRESOLVABLE for f in fails):
                continue
            potential.append(node)
        return potential

    def _select_nodes_for_preemption(self, pod: Pod, node_info_map, potential,
                                     pdbs) -> Dict[str, tuple]:
        """selectNodesForPreemption: node name -> (victims, num_pdb_violations).
        Keyed by name with insertion in node-list order for deterministic
        pick-one tie-breaking (Go iterates a map in random order)."""
        meta = self.predicate_meta_producer(pod, node_info_map)
        result: Dict[str, tuple] = {}
        with flight.span("preempt_candidates") as csp:
            for node in potential:
                meta_copy = meta.shallow_copy() if meta is not None else None
                victims, violations, fits = self._select_victims_on_node(
                    pod, meta_copy, node_info_map[node.name], pdbs)
                if fits:
                    result[node.name] = (victims, violations)
            if csp:
                csp.set("candidates", len(potential))
                csp.set("fitting", len(result))
        return result

    def _select_victims_on_node(self, pod: Pod, meta, node_info: NodeInfo,
                                pdbs) -> tuple:
        """selectVictimsOnNode: remove all lower-priority pods, check fit, then
        reprieve as many as possible (PDB-violating victims first, each group
        highest-priority first)."""
        pod_priority = util_get_pod_priority(pod)
        potential_victims = [p for p in node_info.pods
                             if util_get_pod_priority(p) < pod_priority]
        # one rebuilt-from-survivors clone instead of clone + per-pod strip
        info_copy = node_info.clone_without(potential_victims)

        def remove_pod(p):
            info_copy.remove_pod(p)
            if meta is not None:
                meta.remove_pod(p)

        def add_pod(p):
            info_copy.add_pod(p)
            if meta is not None:
                meta.add_pod(p, info_copy.node)

        if meta is not None:
            for p in potential_victims:
                meta.remove_pod(p)
        potential_victims = sort_by_priority_desc(potential_victims)

        fits, _ = self._fits_sans_nominated(pod, meta, info_copy)
        if not fits:
            return None, 0, False

        victims: List[Pod] = []
        num_violating = 0
        violating, non_violating = self._filter_pods_with_pdb_violation(
            potential_victims, pdbs)

        reprieve = self._make_arithmetic_reprieve(pod, meta, info_copy,
                                                 victims)
        if reprieve is None:
            chain = self._reprieve_chain()

            def reprieve(p) -> bool:
                add_pod(p)
                # the full-ordering fit above already passed on the
                # stripped node; fit is an order-independent AND over the
                # predicate set, so the boolean-only chain (pod-set
                # -dependent predicates, cheapest first) gives the
                # identical outcome
                fits = True
                for predicate in chain:
                    ok, _ = predicate(pod, meta, info_copy)
                    if not ok:
                        fits = False
                        break
                if not fits:
                    remove_pod(p)
                    victims.append(p)
                return fits

        for p in violating:
            if not reprieve(p):
                num_violating += 1
        for p in non_violating:
            reprieve(p)
        return victims, num_violating, True

    # workload feature hints, settable by the device-engine preemption
    # hybrid, which statically knows whether ANY pod in the run —
    # new or placed — carries host ports / conflictable volumes / MaxPD
    # volumes / inter-pod terms. A reprieve-chain predicate for an absent
    # feature is constant-true over every (pod, victim set) of the run, so
    # eliding it cannot change any outcome; when the elided chain is
    # exactly PodFitsResources, reprieve decisions reduce to pure integer
    # arithmetic with no NodeInfo/metadata mutation at all.
    reprieve_feature_hints = None

    def preemption_reprieve_class(self) -> str:
        """The class-dispatch seam for device-side victim selection
        (the preemption hybrid): "arithmetic" when the workload feature hints
        elide every pod-set-dependent predicate except PodFitsResources
        from the reprieve chain — victim search is then pure integer
        arithmetic over resource aggregates, the shape the device victim
        program (the JAX package's preempt_select) reproduces bit-for-bit.
        "general" keeps the host clone/add reprieve pipeline (inter-pod
        -affinity-sensitive victims, port/volume interactions)."""
        hints = self.reprieve_feature_hints
        if hints is None:
            return "general"
        from tpusim_torch.engine.predicates import (
            no_disk_conflict,
            pod_fits_host_ports,
            pod_fits_resources,
        )
        from tpusim_torch.engine.predicates import (
            MAX_AZURE_DISK_VOLUME_COUNT_PRED,
            MAX_EBS_VOLUME_COUNT_PRED,
            MAX_GCE_PD_VOLUME_COUNT_PRED,
            MATCH_INTERPOD_AFFINITY_PRED,
        )

        maxpd = {self.predicates.get(k)
                 for k in (MAX_EBS_VOLUME_COUNT_PRED,
                           MAX_GCE_PD_VOLUME_COUNT_PRED,
                           MAX_AZURE_DISK_VOLUME_COUNT_PRED)}
        interpod = self.predicates.get(MATCH_INTERPOD_AFFINITY_PRED)
        chain = self._reprieve_chain()
        if pod_fits_resources not in chain:
            # a set with neither GeneralPredicates nor PodFitsResources
            # must not have resource checks imposed on it (the chain-based
            # reprieve would never apply them)
            return "general"
        for fn in chain:
            if fn is pod_fits_resources:
                continue
            if fn is pod_fits_host_ports and not hints.get("has_ports"):
                continue
            if fn is no_disk_conflict and not hints.get("has_disk_conflict"):
                continue
            if fn in maxpd and not hints.get("has_maxpd"):
                continue
            if fn is interpod and not hints.get("has_interpod"):
                continue
            return "general"  # a live pod-set-dependent predicate remains
        return "arithmetic"

    def _make_arithmetic_reprieve(self, pod, meta, info_copy, victims):
        """Returns the integer-arithmetic reprieve closure, or None when
        preemption_reprieve_class() is "general" (the generic clone/add
        path then runs)."""
        if self.preemption_reprieve_class() != "arithmetic":
            return None

        # mirror pod_fits_resources (predicates.go:706-776) exactly: pod
        # count always; resource axes only for a nonzero-request pod;
        # extender-ignored extended resources skipped
        preq = meta.pod_request if meta is not None \
            else get_resource_request(pod)
        zero_req = (preq.milli_cpu == 0 and preq.memory == 0
                    and preq.nvidia_gpu == 0
                    and preq.ephemeral_storage == 0 and not preq.scalar)
        alloc = info_copy.allocatable_resource
        allowed = info_copy.allowed_pod_number()
        used = info_copy.requested_resource
        ignored = getattr(meta, "ignored_extended_resources", None) or set()
        scal_names = [name for name in preq.scalar
                      if not ("/" in name and name in ignored)]
        state = {
            "n": len(info_copy.pods),
            "cpu": used.milli_cpu + preq.milli_cpu,
            "mem": used.memory + preq.memory,
            "gpu": used.nvidia_gpu + preq.nvidia_gpu,
            "eph": used.ephemeral_storage + preq.ephemeral_storage,
            "scal": {name: used.scalar.get(name, 0) + preq.scalar[name]
                     for name in scal_names},
        }

        def reprieve_math(v) -> bool:
            vr = get_resource_request(v)
            fits = state["n"] + 2 <= allowed  # +v +the incoming pod
            if fits and not zero_req:
                fits = (alloc.milli_cpu >= state["cpu"] + vr.milli_cpu
                        and alloc.memory >= state["mem"] + vr.memory
                        and alloc.nvidia_gpu >= state["gpu"] + vr.nvidia_gpu
                        and alloc.ephemeral_storage
                        >= state["eph"] + vr.ephemeral_storage)
                if fits and scal_names:
                    for name in scal_names:
                        if alloc.scalar.get(name, 0) < state["scal"][name] \
                                + vr.scalar.get(name, 0):
                            fits = False
                            break
            if fits:
                state["n"] += 1
                state["cpu"] += vr.milli_cpu
                state["mem"] += vr.memory
                state["gpu"] += vr.nvidia_gpu
                state["eph"] += vr.ephemeral_storage
                for name in scal_names:
                    state["scal"][name] += vr.scalar.get(name, 0)
            else:
                victims.append(v)
            return fits

        return reprieve_math

    def _fits_sans_nominated(self, pod, meta, node_info):
        """podFitsOnNode with queue=nil and no ecache (the preemption calls)."""
        fails: List[PredicateFailureReason] = []
        for pred_key in PREDICATES_ORDERING:
            predicate = self.predicates.get(pred_key)
            if predicate is None:
                continue
            fit, reasons = predicate(pod, meta, node_info)
            if not fit:
                fails.extend(reasons)
                break
        return (not fails), fails

    def _reprieve_chain(self) -> list:
        """The boolean-only predicate chain for reprieve re-checks in
        _select_victims_on_node: pod-set-dependent predicates only (node-
        static ones passed on the stripped node and cannot change when only
        the pod set changes), with GeneralPredicates decomposed into its
        dependent halves — PodFitsResources + PodFitsHostPorts; PodFitsHost
        and PodMatchNodeSelector are node-static (predicates.go:1059-1123) —
        and resources hoisted first as the dominant reprieve failure."""
        chain = getattr(self, "_reprieve_chain_cache", None)
        if chain is None:
            from tpusim_torch.engine.predicates import (
                GENERAL_PRED,
                POD_FITS_HOST_PORTS_PRED,
                POD_FITS_RESOURCES_PRED,
                pod_fits_host_ports,
                pod_fits_resources,
            )
            decomposed = (GENERAL_PRED, POD_FITS_RESOURCES_PRED,
                          POD_FITS_HOST_PORTS_PRED)
            chain = []
            if (GENERAL_PRED in self.predicates
                    or POD_FITS_RESOURCES_PRED in self.predicates):
                chain.append(pod_fits_resources)
            if (GENERAL_PRED in self.predicates
                    or POD_FITS_HOST_PORTS_PRED in self.predicates):
                chain.append(pod_fits_host_ports)
            for key in _REPRIEVE_ORDERING:
                if key in decomposed:
                    continue
                fn = self.predicates.get(key)
                if fn is not None:
                    chain.append(fn)
            self._reprieve_chain_cache = chain
        return chain

    @staticmethod
    def _filter_pods_with_pdb_violation(pods, pdbs):
        """filterPodsWithPDBViolation — order within each bucket preserved."""
        violating, non_violating = [], []
        for pod in pods:
            violated = False
            if pod.metadata.labels:
                for pdb in pdbs:
                    if pdb.namespace != pod.namespace or pdb.selector is None:
                        continue
                    if (not pdb.selector.match_labels
                            and not pdb.selector.match_expressions):
                        continue  # empty selector matches nothing here
                    if not pdb.selector.matches(pod.metadata.labels):
                        continue
                    if pdb.disruptions_allowed <= 0:
                        violated = True
                        break
            (violating if violated else non_violating).append(pod)
        return violating, non_violating

    def _pick_one_node_for_preemption(self, node_to_victims: Dict[str, tuple]
                                      ) -> Optional[str]:
        """pickOneNodeForPreemption's 5 criteria: fewest PDB violations, lowest
        highest-priority victim, smallest priority sum, fewest victims, first.
        Returns the chosen node name (Go returns the map key's node; map order
        is random there — we use node-list insertion order deterministically)."""
        if not node_to_victims:
            return None
        names = list(node_to_victims.keys())
        for name in names:
            victims, _ = node_to_victims[name]
            if not victims:
                return name
        min_violations = min(v[1] for v in node_to_victims.values())
        names = [n for n in names if node_to_victims[n][1] == min_violations]
        if len(names) > 1:
            highest = {n: util_get_pod_priority(node_to_victims[n][0][0])
                       for n in names}
            min_highest = min(highest.values())
            names = [n for n in names if highest[n] == min_highest]
        if len(names) > 1:
            sums = {n: sum(util_get_pod_priority(p) + MAX_INT32 + 1
                           for p in node_to_victims[n][0]) for n in names}
            min_sum = min(sums.values())
            names = [n for n in names if sums[n] == min_sum]
        if len(names) > 1:
            counts = {n: len(node_to_victims[n][0]) for n in names}
            min_count = min(counts.values())
            names = [n for n in names if counts[n] == min_count]
        return names[0]

    def _node_passes_extenders_for_preemption(self, pod, node_name, victims,
                                              node_info_map) -> bool:
        """nodePassesExtendersForPreemption (generic_scheduler.go:842-874):
        re-run each extender's Filter on the node with the victims removed."""
        if not self.extenders:
            return True
        original = node_info_map[node_name]
        info_copy = original.clone()
        for victim in victims:
            info_copy.remove_pod(victim)
        node_info_map[node_name] = info_copy
        try:
            filtered = [info_copy.node]
            for extender in self.extenders:
                if not extender.is_interested(pod):
                    continue
                try:
                    filtered, failed_map = extender.filter(pod, filtered,
                                                           node_info_map)
                except Exception as exc:
                    # same per-pod containment as the filter phase: an
                    # extender error fails this preemption attempt, not the
                    # whole simulation
                    raise SchedulingError(
                        f"extender filter failed during preemption: {exc}")
                if node_name in failed_map or not filtered:
                    return False
            return True
        finally:
            node_info_map[node_name] = original

    def _get_lower_priority_nominated_pods(self, pod: Pod,
                                           node_name: str) -> List[Pod]:
        if self.scheduling_queue is None:
            return []
        pods = self.scheduling_queue.waiting_pods_for_node(node_name)
        priority = util_get_pod_priority(pod)
        return [p for p in pods if util_get_pod_priority(p) < priority]
