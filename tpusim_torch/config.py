"""Static engine configuration: the provider's score weights, a scheduler
policy's compiled image, and the pod-group feature flags of a compiled
cluster."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tpusim_torch.engine.predicates import (
    DEFAULT_MAXPD_LIMITS,
    POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
)

AVOID_PODS_WEIGHT = 10000    # NodePreferAvoidPodsPriority weight (defaults.go)


@dataclass(frozen=True)
class PolicySpec:
    """The compiled image of a scheduler Policy (api/types.go:52-77): which
    standard predicates run and each score component's weight. Built by
    tpusim_torch.policyc.compile_policy; None on the provider paths (the
    provider's defaults).

    pred_keys: frozenset of the PREDICATES_ORDERING names the policy enables
    (custom predicates ride label_rows, sa_slots and ports_slots), or None
    for the provider's set. CheckNodeCondition runs regardless: it is
    mandatory."""

    pred_keys: Optional[frozenset]
    w_least: int = 0
    w_most: int = 0
    w_balanced: int = 0
    w_node_aff: int = 0
    w_taint: int = 0
    w_avoid: int = 0           # NodePreferAvoidPodsPriority policy weight
    w_spread: int = 0
    w_interpod: int = 0
    w_image: int = 0           # ImageLocalityPriority (table-driven)
    # ServiceAntiAffinity priorities: one weight per entry, parallel to the
    # plan's ServiceAntiAffinity domain rows (selector_spreading.go:176-280)
    saa_weights: tuple = ()
    # ServiceAffinity predicates: one slot per entry, a PREDICATES_ORDERING
    # name or "tail:<k>" (the k-th custom in alphabetical name order, after
    # the fixed ordering); sa_segs holds each entry's label count over the
    # concatenated label rows. sa_enabled gates the lock updates at bind.
    sa_enabled: bool = False
    sa_slots: tuple = ()
    sa_segs: tuple = ()
    # the 1.0 PodFitsPorts alias: tail slots where the port-conflict stage
    # runs again
    ports_slots: tuple = ()
    # alwaysCheckAllPredicates: every failing predicate reports, not only
    # the first (generic_scheduler.go)
    always_check_all: bool = False
    # one slot per label-presence row: a PREDICATES_ORDERING name or
    # "tail:<k>"
    label_rows: tuple = ()
    has_label_prio: bool = False

    @property
    def has_noexec(self) -> bool:
        """Whether PodToleratesNodeNoExecuteTaints runs: the cluster
        compiles its NoExecute taint table (compile_cluster need_noexec)."""
        return (self.pred_keys is not None
                and POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED in self.pred_keys)

    @property
    def has_services(self) -> bool:
        """Whether ServiceAntiAffinity or ServiceAffinity runs: the cluster
        interns first-service signatures (compile_cluster need_saa)."""
        return bool(self.saa_weights) or self.sa_enabled


@dataclass(frozen=True)
class EngineConfig:
    """Static (compile-time) provider configuration."""

    most_requested: bool = False  # LeastRequested -> MostRequested swap (TD/autoscaler)
    # pod-group features, compiled in only when the workload needs them
    has_ports: bool = False
    has_services: bool = False
    has_interpod: bool = False
    has_disk_conflict: bool = False
    has_maxpd: bool = False
    has_vol_zone: bool = False
    maxpd_limits: tuple = DEFAULT_MAXPD_LIMITS  # (EBS, GCE PD, AzureDisk)
    hard_weight: int = 10         # HardPodAffinitySymmetricWeight
    n_topo_doms: int = 1          # topology domains incl. the invalid 0 bucket
    n_zone_doms: int = 1          # zone domains incl. the no-zone 0 bucket
    # a policy's predicate gating and weights (None: the provider's)
    policy: Optional[PolicySpec] = None
    # ServiceAntiAffinity label domains incl. the label-missing 0 bucket
    n_saa_doms: int = 1
    # the explain lanes: with k > 0 the scan also writes, a pod, the top k
    # nodes by final score with each node's score parts
    # (explain_part_names order); 0 builds the programs without them
    explain_k: int = 0


def config_for(compiled, most_requested: bool,
               hard_weight: int = 10) -> EngineConfig:
    """The EngineConfig of one CompiledCluster, or the union over a list of
    them (a what-if batch shares one program: a feature any scenario has is
    compiled in for all, the domain counts are the largest, and the MaxPD
    limits are the first scenario's that has MaxPD)."""
    compiled_list = (list(compiled) if isinstance(compiled, (list, tuple))
                     else [compiled])
    limits = [c.maxpd_limits for c in compiled_list if c.has_maxpd]
    return EngineConfig(
        most_requested=most_requested,
        has_ports=any(c.has_ports for c in compiled_list),
        has_services=any(c.has_services for c in compiled_list),
        has_interpod=any(c.has_interpod for c in compiled_list),
        has_disk_conflict=any(c.has_disk_conflict for c in compiled_list),
        has_maxpd=any(c.has_maxpd for c in compiled_list),
        has_vol_zone=any(c.has_vol_zone for c in compiled_list),
        maxpd_limits=limits[0] if limits else DEFAULT_MAXPD_LIMITS,
        hard_weight=hard_weight,
        n_topo_doms=max(c.n_topo_doms for c in compiled_list),
        n_zone_doms=max(c.n_zone_doms for c in compiled_list))


def policy_weights(ps: Optional[PolicySpec], most_requested: bool) -> tuple:
    """The score-component weights (generic_scheduler.go:631-639): the
    provider's without a policy, the policy's with one: (least, most,
    balanced, node_aff, taint, avoid, spread, interpod)."""
    if ps is None:
        w_least, w_most = (0, 1) if most_requested else (1, 0)
        return (w_least, w_most, 1, 1, 1, AVOID_PODS_WEIGHT, 1, 1)
    return (ps.w_least, ps.w_most, ps.w_balanced, ps.w_node_aff,
            ps.w_taint, ps.w_avoid, ps.w_spread, ps.w_interpod)


# Any real node score is a small weighted sum of components of 0..10 times
# their weights. The explain lanes mask an infeasible node to
# 2 * EXPLAIN_SENTINEL before their top-k, so a row scoring at or below the
# sentinel is padding (fewer than k nodes feasible), not a candidate.
EXPLAIN_SENTINEL = -(1 << 61)


def explain_part_names(config: EngineConfig) -> list:
    """The score parts of the explain lanes, named after their priorities,
    in the order scan._evaluate adds them to the score: the same gating,
    so the parts of a row sum to its score."""
    ps = config.policy
    (w_least, w_most, w_balanced, w_node_aff, w_taint, w_avoid, w_spread,
     w_interpod) = policy_weights(ps, config.most_requested)
    names = []
    if w_least:
        names.append("LeastRequestedPriority")
    if w_most:
        names.append("MostRequestedPriority")
    if w_balanced:
        names.append("BalancedResourceAllocation")
    if w_node_aff:
        names.append("NodeAffinityPriority")
    if w_taint:
        names.append("TaintTolerationPriority")
    if w_avoid:
        names.append("NodePreferAvoidPodsPriority")
    if ps is not None and ps.has_label_prio:
        names.append("NodeLabelPriority")
    if ps is not None and ps.w_image:
        names.append("ImageLocalityPriority")
    if ps is not None and ps.saa_weights:
        names.append("ServiceAntiAffinityPriority")
    if config.has_services and w_spread:
        names.append("SelectorSpreadPriority")
    if config.has_interpod and w_interpod:
        names.append("InterPodAffinityPriority")
    return names
