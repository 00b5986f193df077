"""Compile a scheduler Policy (api/types.go:52-77) for the fused scan.

Mirrors factory.go CreateFromConfig:933-1000 + plugins.go
RegisterCustomFitPredicate:197-240 / RegisterCustomPriorityFunction:302-348,
but instead of assembling host predicate and priority closures it produces:

  * a config.PolicySpec: the predicate gating and score-component weights
    the kernel reads (EngineConfig.policy), and
  * per-node tables for the policy's custom plugins: label-presence rows,
    the NodeLabel priority row, ImageLocality scores per pod image set,
    ServiceAntiAffinity label domains and the ServiceAffinity pins, label
    values and first-matching-pod locks (build_policy_tables).

The one host-bound feature is extenders (HTTP round trips mid-filter): they
land in CompiledPolicy.unsupported, and the backend refuses them. Several
ServiceAffinity predicates in one policy each evaluate their own label
segment as a separate stage at their own ordering or tail slot, against the
shared first-matching-pod lock; the 1.0 PodFitsPorts alias re-runs the
port-conflict stage at its alphabetical tail slot; alwaysCheckAllPredicates
switches the reason histogram to count mode. Unknown names raise the host
registry's KeyError byte for byte.

classify_preemption_class sorts a predicate set for the preemption hybrid's
victim selection: "arithmetic" (the device victim program reproduces the
host's reprieve) or "general" (the host pipeline). Left out here:
CompiledPolicy's compile-time preemption class (the hybrid classifies at
run time and a policy does not reach it).

The streaming twin (stream.runtime) keeps a policy's tables resident:
policy_plan_key names the plan they serve, PolicyResidency records the
interning they were built with, remap_policy_columns maps a new batch's
per-pod columns onto it and policy_delta_columns recomputes the churned
nodes' columns against it; a value outside the resident interning restages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpusim_torch.config import AVOID_PODS_WEIGHT, PolicySpec
from tpusim_torch.engine import predicates as preds
from tpusim_torch.engine.generic_scheduler import _POD_SET_INDEPENDENT_PREDS
from tpusim_torch.engine.policy import Policy, validate_policy
from tpusim_torch.engine.priorities import (
    MAX_PRIORITY,
    image_locality_priority_map,
)

# standard predicates the kernel evaluates natively, by registry name
COMPILABLE_PREDS = frozenset({
    preds.CHECK_NODE_CONDITION_PRED, preds.CHECK_NODE_UNSCHEDULABLE_PRED,
    preds.GENERAL_PRED, preds.HOSTNAME_PRED, preds.POD_FITS_HOST_PORTS_PRED,
    preds.MATCH_NODE_SELECTOR_PRED, preds.POD_FITS_RESOURCES_PRED,
    preds.NO_DISK_CONFLICT_PRED, preds.POD_TOLERATES_NODE_TAINTS_PRED,
    preds.MAX_EBS_VOLUME_COUNT_PRED, preds.MAX_GCE_PD_VOLUME_COUNT_PRED,
    preds.MAX_AZURE_DISK_VOLUME_COUNT_PRED,
    # CheckVolumeBinding passes with the VolumeScheduling gate off
    # (predicates.go:1586), the only mode here
    preds.CHECK_VOLUME_BINDING_PRED,
    preds.NO_VOLUME_ZONE_CONFLICT_PRED,
    preds.CHECK_NODE_MEMORY_PRESSURE_PRED, preds.CHECK_NODE_DISK_PRESSURE_PRED,
    preds.MATCH_INTERPOD_AFFINITY_PRED,
    # the NoExecute-only taint variant (policy-registered): its own table
    preds.POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
})

# 1.0 backward-compat alias (defaults.go:63-65). The host evaluates registry
# keys outside predicates.Ordering() at the alphabetical TAIL slot, so
# "PodFitsPorts" short-circuits in another position than "PodFitsHostPorts":
# the port-conflict stage runs again at the alias's tail slot
# (PolicySpec.ports_slots).
_TAIL_PORTS_ALIAS = "PodFitsPorts"

# priority name -> PolicySpec weight field (EqualPriority adds the same
# constant to every node, so it cannot change the argmax or the tie set).
# ServiceSpreadingPriority (the 1.0 alias) shares w_spread: spread
# signatures are service-derived only, so the alias scores like
# SelectorSpreadPriority and a policy naming BOTH sums their weights.
_WEIGHT_FIELDS: Dict[str, str] = {
    "LeastRequestedPriority": "w_least",
    "MostRequestedPriority": "w_most",
    "BalancedResourceAllocation": "w_balanced",
    "NodeAffinityPriority": "w_node_aff",
    "TaintTolerationPriority": "w_taint",
    "NodePreferAvoidPodsPriority": "w_avoid",
    "SelectorSpreadPriority": "w_spread",
    "ServiceSpreadingPriority": "w_spread",
    "InterPodAffinityPriority": "w_interpod",
}
COMPILABLE_PRIOS = frozenset(_WEIGHT_FIELDS) | {"EqualPriority",
                                                "ImageLocalityPriority"}

# the DefaultProvider weight set (defaults.go:219-259); policies that omit
# `priorities` inherit it (CreateFromConfig -> DefaultProvider keys)
_DEFAULT_WEIGHTS = dict(w_least=1, w_most=0, w_balanced=1, w_node_aff=1,
                        w_taint=1, w_avoid=AVOID_PODS_WEIGHT, w_spread=1,
                        w_interpod=1)


# Preemption victim-selection class. "arithmetic": every registered
# predicate is PodFitsResources (or GeneralPredicates without host ports) or
# does not depend on which pods remain on the node
# (generic_scheduler._POD_SET_INDEPENDENT_PREDS), so the victim search is
# integer arithmetic over resource aggregates, which the preemption hybrid
# runs on the device (scan.preempt_select). Everything else keeps the host
# clone/add reprieve pipeline. A pod-set-dependent predicate whose feature is
# absent from the whole workload (no host ports anywhere, no conflictable or
# MaxPD volumes, no inter-pod terms) is constant-true for every victim set
# of the run, so the run-time feature flags can elide it, the same rule
# GenericScheduler.preemption_reprieve_class applies to the reprieve chain.

# pod-set-dependent predicate key -> workload feature flag that elides it
_FEATURE_GATED_PREDS: Dict[str, str] = {
    preds.POD_FITS_HOST_PORTS_PRED: "has_ports",
    preds.NO_DISK_CONFLICT_PRED: "has_disk_conflict",
    preds.MAX_EBS_VOLUME_COUNT_PRED: "has_maxpd",
    preds.MAX_GCE_PD_VOLUME_COUNT_PRED: "has_maxpd",
    preds.MAX_AZURE_DISK_VOLUME_COUNT_PRED: "has_maxpd",
    preds.MATCH_INTERPOD_AFFINITY_PRED: "has_interpod",
}


def classify_preemption_class(pred_keys, feature_flags=None,
                              has_extenders: bool = False):
    """Classify a predicate key set for preemption victim selection.

    Returns ("arithmetic" | "general", reason). pred_keys None means the
    provider-default set (a policy that omits `predicates`). feature_flags
    maps has_ports/has_disk_conflict/has_maxpd/has_interpod to whether the
    feature occurs anywhere in the workload (new AND placed pods); None (the
    policy-compile-time call, before any workload is known) treats every
    feature as present, so "arithmetic" at compile time means arithmetic for
    EVERY workload."""
    if has_extenders:
        return "general", "extenders re-filter preemption candidates"
    if pred_keys is None:
        from tpusim_torch.engine.providers import DEFAULT_PREDICATE_KEYS
        pred_keys = DEFAULT_PREDICATE_KEYS
    keys = set(pred_keys)
    flags = feature_flags or {}
    if (preds.GENERAL_PRED not in keys
            and preds.POD_FITS_RESOURCES_PRED not in keys):
        return "general", "no resource predicate registered"
    for key in sorted(keys):
        if key == preds.POD_FITS_RESOURCES_PRED:
            continue
        if key == preds.GENERAL_PRED:
            # GeneralPredicates bundles PodFitsHostPorts (pod-set-dependent)
            if flags.get("has_ports", True):
                return "general", "GeneralPredicates with host ports in the workload"
            continue
        if key in _POD_SET_INDEPENDENT_PREDS:
            continue
        flag = _FEATURE_GATED_PREDS.get(
            "PodFitsHostPorts" if key == _TAIL_PORTS_ALIAS else key)
        if flag is not None and not flags.get(flag, True):
            continue
        return "general", f"pod-set-dependent predicate {key}"
    return "arithmetic", ""


@dataclass
class CompiledPolicy:
    spec: PolicySpec
    # policy HardPodAffinitySymmetricWeight override; None = keep the
    # backend's value (CreateFromConfig treats 0 as unset)
    hard_weight: int = None
    # label-presence predicate rows, parallel to spec.label_rows: (slot,
    # [(labels, presence), ...] folded into that row)
    label_rows: List[Tuple[str, list]] = field(default_factory=list)
    # label priorities: (label, presence, weight)
    label_prios: List[Tuple[str, bool, int]] = field(default_factory=list)
    # ServiceAntiAffinity entries: (node label, weight), parallel to
    # spec.saa_weights
    saa_entries: List[Tuple[str, int]] = field(default_factory=list)
    # ServiceAffinity predicates: one label tuple per entry, in the order of
    # spec.sa_slots / sa_segs
    sa_entries: tuple = ()
    # host-bound features the port does not carry (empty = compilable)
    unsupported: List[str] = field(default_factory=list)


def compile_policy(policy: Policy) -> CompiledPolicy:
    """Raises PolicyError/KeyError exactly like the host assembly; returns a
    CompiledPolicy whose `unsupported` lists any host-bound feature."""
    validate_policy(policy)
    unsupported: List[str] = []
    if policy.extender_configs:
        unsupported.append("policy extenders (HTTP round-trips mid-filter)")

    # Both registries key plugins by NAME and a later registration under the
    # same name overwrites the earlier one, while the key set dedups
    # (plugins.go RegisterCustomFitPredicate/RegisterCustomPriorityFunction)
    # — so duplicates resolve last-wins here too.
    label_rows: List[Tuple[str, list]] = []
    sa_entries: List[tuple] = []
    sa_slots: List[str] = []
    ports_slots: List[str] = []
    if policy.predicates is None:
        pred_keys = None
    else:
        pred_by_name: Dict[str, tuple] = {}
        for pp in policy.predicates:
            arg = pp.argument
            if arg is not None and arg.service_affinity is not None:
                pred_by_name[pp.name] = (
                    "sa", tuple(arg.service_affinity.labels))
            elif arg is not None and arg.labels_presence is not None:
                pred_by_name[pp.name] = (
                    "label", (tuple(arg.labels_presence.labels),
                              bool(arg.labels_presence.presence)))
            elif pp.name in COMPILABLE_PREDS:
                pred_by_name[pp.name] = ("standard",)
            elif pp.name == _TAIL_PORTS_ALIAS:
                pred_by_name[pp.name] = ("ports",)
            else:
                # plugins.go RegisterCustomFitPredicate's failure, byte-matched
                raise KeyError("Invalid configuration: Predicate type not "
                               f"found for {pp.name}")
        pred_keys = set()
        slotted: Dict[str, list] = {}
        tail_entries: list = []
        sa_found: List[Tuple[str, tuple]] = []
        tail_ports: List[str] = []
        for name, entry in pred_by_name.items():
            if entry[0] == "standard":
                pred_keys.add(name)
            elif entry[0] == "ports":
                tail_ports.append(name)
            elif entry[0] == "sa":
                if name == preds.CHECK_NODE_CONDITION_PRED:
                    unsupported.append("ServiceAffinity predicate replacing "
                                       "the mandatory CheckNodeCondition")
                else:
                    sa_found.append((name, entry[1]))
            elif entry[0] == "label":
                # the host registers the custom under the policy's name: a
                # name in PREDICATES_ORDERING evaluates at that slot, any
                # other name runs after the fixed ordering
                if name == preds.CHECK_NODE_CONDITION_PRED:
                    # would REPLACE the mandatory condition predicate
                    unsupported.append(
                        "label predicate replacing the mandatory "
                        "CheckNodeCondition")
                elif name in preds.PREDICATES_ORDERING:
                    slotted[name] = [entry[1]]
                else:
                    tail_entries.append((name, entry[1]))
            else:
                unsupported.append(entry[1])
        for name in preds.PREDICATES_ORDERING:
            if name in slotted:
                label_rows.append((name, slotted[name]))
        # ServiceAffinity entries under a PREDICATES_ORDERING name evaluate
        # at that slot; every other custom (label-presence row, SA entry or
        # ports alias) runs after the fixed ordering in the host's
        # alphabetical name order, its sorted position giving slot
        # "tail:<k>". One row per label predicate (not folded): in count
        # mode each failing predicate reports its own occurrence.
        sa_found.sort(key=lambda pair: pair[0])
        for name, labels in sa_found:
            if name in preds.PREDICATES_ORDERING:
                sa_entries.append(tuple(labels))
                sa_slots.append(name)
        tail_customs = sorted(
            [(n, "label", e) for n, e in tail_entries]
            + [(n, "sa", tuple(labels)) for n, labels in sa_found
               if n not in preds.PREDICATES_ORDERING]
            + [(n, "ports", None) for n in tail_ports])
        for k, (_n, kind, payload) in enumerate(tail_customs):
            if kind == "label":
                label_rows.append((f"tail:{k}", [payload]))
            elif kind == "ports":
                ports_slots.append(f"tail:{k}")
            else:
                sa_entries.append(payload)
                sa_slots.append(f"tail:{k}")

    weights = dict(_DEFAULT_WEIGHTS)
    label_prios: List[Tuple[str, bool, int]] = []
    saa_entries: List[Tuple[str, int]] = []
    image_weight = 0
    if policy.priorities is not None:
        weights = dict.fromkeys(weights, 0)
        prio_by_name: Dict[str, tuple] = {}
        for pr in policy.priorities:
            arg = pr.argument
            if arg is not None and arg.service_anti_affinity is not None:
                prio_by_name[pr.name] = (
                    "saa", (arg.service_anti_affinity.label, pr.weight))
            elif arg is not None and arg.label_preference is not None:
                prio_by_name[pr.name] = (
                    "label", (arg.label_preference.label,
                              bool(arg.label_preference.presence), pr.weight))
            elif pr.name in _WEIGHT_FIELDS:
                # referencing a pre-registered priority takes the POLICY's
                # weight (plugins.go:302-348)
                prio_by_name[pr.name] = ("weight", _WEIGHT_FIELDS[pr.name],
                                         pr.weight)
            elif pr.name == "ImageLocalityPriority":
                prio_by_name[pr.name] = ("image", pr.weight)
            elif pr.name == "EqualPriority":
                prio_by_name[pr.name] = ("equal",)
            else:
                raise KeyError("Invalid configuration: Priority type not "
                               f"found for {pr.name}")
        for entry in prio_by_name.values():
            if entry[0] == "weight":
                # += not =: two NAMES sharing a field (the spread aliases)
                # sum like two host instances
                weights[entry[1]] += entry[2]
            elif entry[0] == "label":
                label_prios.append(entry[1])
            elif entry[0] == "image":
                image_weight = entry[1]
            elif entry[0] == "saa":
                saa_entries.append(entry[1])
            # "equal": constant shift; no effect on selection or ties

    spec = PolicySpec(
        pred_keys=frozenset(pred_keys) if pred_keys is not None else None,
        label_rows=tuple(slot for slot, _ in label_rows),
        has_label_prio=bool(label_prios),
        w_image=image_weight,
        saa_weights=tuple(w for _, w in saa_entries),
        sa_enabled=bool(sa_entries), sa_slots=tuple(sa_slots),
        sa_segs=tuple(len(e) for e in sa_entries),
        ports_slots=tuple(ports_slots),
        always_check_all=bool(policy.always_check_all_predicates),
        **weights)
    hard = (policy.hard_pod_affinity_symmetric_weight
            if policy.hard_pod_affinity_symmetric_weight != 0 else None)
    if hard is not None and (hard < 1 or hard > 100):
        # the [1, 100] range factory.go:1024-1026 enforces
        raise ValueError(f"invalid hardPodAffinitySymmetricWeight: {hard}, "
                         "must be in the range 1-100")
    return CompiledPolicy(spec=spec, hard_weight=hard, label_rows=label_rows,
                          label_prios=label_prios, saa_entries=saa_entries,
                          sa_entries=tuple(sa_entries),
                          unsupported=unsupported)


def _label_pred_row(nodes_by_idx: list, entries) -> np.ndarray:
    """Folded per-node pass mask for a list of label-presence predicates
    (predicates.go NewNodeLabelPredicate: every label's existence must equal
    `presence`)."""
    row = np.ones(len(nodes_by_idx), dtype=bool)
    for labels, presence in entries:
        for i, node in enumerate(nodes_by_idx):
            node_labels = node.metadata.labels
            for label in labels:
                if (label in node_labels) != presence:
                    row[i] = False
                    break
    return row


def _nodes_by_index(nodes, node_index: Dict[str, int]) -> list:
    by_idx: list = [None] * len(node_index)
    for node in nodes:
        i = node_index.get(node.name)
        if i is not None:
            by_idx[i] = node
    return by_idx


def image_locality_columns(pods, nodes, node_index: Dict[str, int]):
    """(img_id[P] int32, image_score[Si, N] int64): pod container-image
    multisets interned to signature ids, with the ImageLocalityPriority score
    (image_locality.go thresholds) per (signature, node)."""
    by_idx = _nodes_by_index(nodes, node_index)
    sig_ids: Dict[tuple, int] = {}
    reps: List = []
    img_id = np.zeros(len(pods), dtype=np.int32)
    for j, pod in enumerate(pods):
        # a multiset: two containers sharing an image each add its size
        sig = tuple(sorted(c.image for c in pod.spec.containers))
        if sig not in sig_ids:
            sig_ids[sig] = len(reps)
            reps.append(pod)
        img_id[j] = sig_ids[sig]

    table = np.zeros((max(len(reps), 1), len(by_idx)), dtype=np.int64)
    for s, rep in enumerate(reps):
        for i, node in enumerate(by_idx):
            info = SimpleNamespace(node=node)
            table[s, i] = image_locality_priority_map(rep, None, info).score
    return img_id, table


def _label_value_row(by_idx: list, label: str, extra_values=()):
    """Intern one node label's values into an int32 row (0 = absent);
    returns (row[N], number of distinct values + 1, value->id map).
    extra_values are interned too (after the node values), so pod-side pins
    share the id space; a pinned value no node carries gets a fresh id that
    matches nothing."""
    row = np.zeros(len(by_idx), dtype=np.int32)
    values: Dict[str, int] = {}
    for i, node in enumerate(by_idx):
        value = node.metadata.labels.get(label)
        if value is None:
            continue
        vid = values.get(value)
        if vid is None:
            vid = len(values) + 1
            values[value] = vid
        row[i] = vid
    for value in extra_values:
        if value not in values:
            values[value] = len(values) + 1
    return row, len(values) + 1, values


def saa_dom_rows(cp: CompiledPolicy, nodes, node_index: Dict[str, int]):
    """(saa_dom [E, N] int32, n_doms int): per ServiceAntiAffinity entry the
    node label-value domains (0 = label absent; values interned per entry,
    one shared domain count)."""
    by_idx = _nodes_by_index(nodes, node_index)
    dom = np.zeros((max(len(cp.saa_entries), 1), len(by_idx)), dtype=np.int32)
    n_doms = 1
    for e, (label, _w) in enumerate(cp.saa_entries):
        dom[e], n_values, _ = _label_value_row(by_idx, label)
        n_doms = max(n_doms, n_values)
    return dom, n_doms


def service_affinity_columns(cp: CompiledPolicy, pods, snapshot,
                             node_index: Dict[str, int], saa_defs: list):
    """The ServiceAffinity state (predicates.py check_service_affinity):
    (sa_self_id[P], sa_pin[Cs, La], sa_val[La, N], sa_lock_init[Fd]).

    The label axis concatenates every entry's labels in PolicySpec.sa_segs
    order. Pod-side pins are interned into sa_val's per-label value space
    (0 = unpinned). The plugin's pod lister is the scheduler cache (ASSIGNED
    pods, seeded in snapshot order, then bound pods in bind order), so the
    first matching pod is either a seeded assigned pod (its node index locks
    signature f, or -2 when the node is unknown and nothing ever pins) or
    the first matching pod to bind, which the kernel locks at that bind (-1
    until then). The lock, a node index, is shared by every entry."""
    labels = [label for entry in cp.sa_entries for label in entry]
    n = len(node_index)
    la = max(len(labels), 1)
    by_idx = _nodes_by_index(snapshot.nodes, node_index)

    pinned_values: List[set] = [set() for _ in labels]
    for pod in pods:
        selector = pod.spec.node_selector or {}
        for li, label in enumerate(labels):
            if label in selector:
                pinned_values[li].add(selector[label])
    sa_val = np.zeros((la, n), dtype=np.int32)
    value_maps: List[Dict[str, int]] = [{} for _ in range(la)]
    for li, label in enumerate(labels):
        sa_val[li], _, value_maps[li] = _label_value_row(
            by_idx, label, extra_values=sorted(pinned_values[li]))

    sig_ids: Dict[tuple, int] = {}
    reps: List[tuple] = []
    sa_self_id = np.zeros(len(pods), dtype=np.int32)
    for j, pod in enumerate(pods):
        selector = pod.spec.node_selector or {}
        pins = tuple(sorted((label, selector[label]) for label in set(labels)
                            if label in selector))
        cid = sig_ids.get(pins)
        if cid is None:
            cid = len(reps)
            sig_ids[pins] = cid
            reps.append(pins)
        sa_self_id[j] = cid

    sa_pin = np.zeros((max(len(reps), 1), la), dtype=np.int32)
    for c, pins in enumerate(reps):
        pinned = dict(pins)
        for li, label in enumerate(labels):
            if label in pinned:
                sa_pin[c, li] = value_maps[li][pinned[label]]

    lock_init = sa_lock_init_rows(saa_defs, snapshot.pods, node_index)
    return sa_self_id, sa_pin, sa_val, lock_init


def sa_lock_init_rows(saa_defs: list, pods, node_index: Dict[str, int]):
    """sa_lock_init[Fd] int32: per first-service signature, the node index
    of the first matching assigned pod in `pods` (cache order), -2 when that
    pod's node is unknown, -1 when there is none."""
    lock_init = np.full(max(len(saa_defs), 1), -1, dtype=np.int32)
    for f in range(1, len(saa_defs)):
        ns, sel = saa_defs[f]
        first = next(
            (p for p in pods
             if p.spec.node_name and p.namespace == ns
             and all(p.metadata.labels.get(k) == v for k, v in sel.items())),
            None)
        if first is not None:
            if first.spec.node_name in node_index:
                lock_init[f] = node_index[first.spec.node_name]
            else:
                # assigned to an unknown node: it stays the first matching
                # pod forever, so nothing ever pins
                lock_init[f] = -2
    return lock_init


def policy_static_rows(cp: CompiledPolicy, nodes,
                       node_index: Dict[str, int]):
    """(label_ok[L, N], label_prio[N]) in compiled node order, rows parallel
    to spec.label_rows."""
    n = len(node_index)
    by_idx = _nodes_by_index(nodes, node_index)
    if cp.label_rows:
        label_ok = np.stack([_label_pred_row(by_idx, entries)
                             for _, entries in cp.label_rows])
    else:
        label_ok = np.ones((1, n), dtype=bool)
    prio = np.zeros(n, dtype=np.int64)
    for label, presence, weight in cp.label_prios:
        for i, node in enumerate(by_idx):
            if (label in node.metadata.labels) == presence:
                prio[i] += weight * MAX_PRIORITY
    return label_ok, prio


@dataclass
class PolicyTables:
    """The host-built policy tables plan_fast turns into kernel operands."""

    label_ok: np.ndarray         # [L, N] bool: label-presence pass masks
    label_prio: np.ndarray       # [N] int64: NodeLabel priority scores
    image_score: np.ndarray      # [Si, N] int64: ImageLocality table
    has_image: bool              # the policy weights ImageLocality
    saa_dom: np.ndarray          # [E, N] int32: SAA per-entry label domains
    n_saa_doms: int              # shared domain count (incl. absent 0)
    sa_pin: np.ndarray           # [Cs, La] int32: per pod-pin signature
    sa_val: np.ndarray           # [La, N] int32: SA node label values
    sa_lock_init: np.ndarray     # [Fd] int32: first-matching-pod locks


def build_policy_tables(cp: CompiledPolicy, snapshot, pods,
                        compiled, cols) -> PolicyTables:
    """Every policy table the kernel consumes. Fills cols.img_id and
    cols.sa_self_id IN PLACE and returns the node-axis tables."""
    ps = cp.spec
    nodes = snapshot.nodes
    node_index = compiled.node_index
    n = max(len(node_index), 1)
    label_ok, label_prio = policy_static_rows(cp, nodes, node_index)
    has_image = bool(ps.w_image)
    if has_image:
        img_id, image_score = image_locality_columns(pods, nodes, node_index)
        cols.img_id[:] = img_id
    else:
        image_score = np.zeros((1, n), dtype=np.int64)
    saa_dom, n_saa_doms = saa_dom_rows(cp, nodes, node_index)
    if ps.sa_enabled or ps.sa_slots:
        sa_self_id, sa_pin, sa_val, sa_lock_init = service_affinity_columns(
            cp, pods, snapshot, node_index, compiled.groups.saa_defs)
        cols.sa_self_id[:] = sa_self_id
    else:
        sa_pin = np.zeros((1, 1), dtype=np.int32)
        sa_val = np.zeros((1, n), dtype=np.int32)
        sa_lock_init = np.full(
            compiled.groups.saa_rows.shape[0], -1, dtype=np.int32)
    return PolicyTables(label_ok=label_ok, label_prio=label_prio,
                        image_score=image_score, has_image=has_image,
                        saa_dom=saa_dom, n_saa_doms=n_saa_doms,
                        sa_pin=sa_pin, sa_val=sa_val,
                        sa_lock_init=sa_lock_init)


# ---------------------------------------------------------------------------
# Policy residency: the interning a resident set of policy tables was built
# with, so that the streaming twin can (a) map a new batch's per-pod
# signature columns onto the RESIDENT id spaces and (b) recompute only the
# churned nodes' policy columns, both without restaging. A signature or a
# label value outside the resident spaces would grow a table: the caller
# restages.


def policy_plan_key(cp: Optional[CompiledPolicy]):
    """A hashable identity of the plan a policy's tables serve. PolicySpec
    alone under-determines the tables (label_rows holds slots, not the
    labels; two policies can share a spec and mask different labels), so the
    key freezes every input that shapes them. Equal keys stage equal policy
    statics on one cluster; a change of key is the policy_plan_change
    restage."""
    if cp is None:
        return None
    return (cp.spec, cp.hard_weight,
            tuple((slot, tuple((tuple(labels), presence)
                               for labels, presence in entries))
                  for slot, entries in cp.label_rows),
            tuple((label, presence, weight)
                  for label, presence, weight in cp.label_prios),
            tuple((label, weight) for label, weight in cp.saa_entries),
            tuple(tuple(entry) for entry in cp.sa_entries))


@dataclass
class PolicyResidency:
    """The interning captured at a restage (build_policy_residency).

    img_rows / img_reps: container-image multiset -> image_score row, and
    the representative pod of each row (image_locality_columns' first-seen
    order). sa_rows: pod pin signature -> sa_pin row. sa_value_maps /
    saa_value_maps: per label, value -> id (sa_val / saa_dom), derived again
    from the snapshot exactly as the table builders interned them."""

    img_rows: Dict[tuple, int] = field(default_factory=dict)
    img_reps: List = field(default_factory=list)
    sa_labels: tuple = ()
    sa_rows: Dict[tuple, int] = field(default_factory=dict)
    sa_value_maps: List[Dict[str, int]] = field(default_factory=list)
    saa_value_maps: List[Dict[str, int]] = field(default_factory=list)


def build_policy_residency(cp: CompiledPolicy, snapshot, pods,
                           compiled, ptabs: PolicyTables) -> PolicyResidency:
    """The interning the `ptabs` tables were built with: pods and nodes are
    walked in the table builders' order, so the ids line up."""
    by_idx = _nodes_by_index(snapshot.nodes, compiled.node_index)
    res = PolicyResidency()

    if ptabs.has_image:
        for pod in pods:
            sig = tuple(sorted(c.image for c in pod.spec.containers))
            if sig not in res.img_rows:
                res.img_rows[sig] = len(res.img_reps)
                res.img_reps.append(pod)

    ps = cp.spec
    if ps.sa_enabled or ps.sa_slots:
        labels = [label for entry in cp.sa_entries for label in entry]
        res.sa_labels = tuple(labels)
        pinned_values: List[set] = [set() for _ in labels]
        for pod in pods:
            selector = pod.spec.node_selector or {}
            for li, label in enumerate(labels):
                if label in selector:
                    pinned_values[li].add(selector[label])
        res.sa_value_maps = [{} for _ in range(max(len(labels), 1))]
        for li, label in enumerate(labels):
            _, _, res.sa_value_maps[li] = _label_value_row(
                by_idx, label, extra_values=sorted(pinned_values[li]))
        label_set = set(labels)
        for pod in pods:
            selector = pod.spec.node_selector or {}
            pins = tuple(sorted((label, selector[label])
                                for label in label_set if label in selector))
            if pins not in res.sa_rows:
                res.sa_rows[pins] = len(res.sa_rows)

    for label, _w in cp.saa_entries:
        _, _, vmap = _label_value_row(by_idx, label)
        res.saa_value_maps.append(vmap)
    return res


def remap_policy_columns(cp: CompiledPolicy, res: PolicyResidency,
                         pods, cols) -> Optional[str]:
    """Fill cols.img_id and cols.sa_self_id of a NEW batch against the
    resident id spaces. None on success, or the restage reason
    ("new_signature") when a pod carries a signature the resident tables
    never interned."""
    ps = cp.spec
    if ps.w_image:
        for j, pod in enumerate(pods):
            sig = tuple(sorted(c.image for c in pod.spec.containers))
            row = res.img_rows.get(sig)
            if row is None:
                return "new_signature"
            cols.img_id[j] = row
    if ps.sa_enabled or ps.sa_slots:
        label_set = set(res.sa_labels)
        for j, pod in enumerate(pods):
            selector = pod.spec.node_selector or {}
            pins = tuple(sorted((label, selector[label])
                                for label in label_set if label in selector))
            row = res.sa_rows.get(pins)
            if row is None:
                return "new_signature"
            cols.sa_self_id[j] = row
    return None


def policy_delta_columns(cp: Optional[CompiledPolicy],
                         res: Optional[PolicyResidency],
                         ptabs: Optional[PolicyTables],
                         by_idx: list, idxs, shapes):
    """The policy statics columns of the churned node indices `idxs`.

    by_idx: the nodes in compiled order (post-churn host truth); shapes: the
    resident (L, Si, E, La) leading axes. Returns (label_ok [L, U],
    label_prio [U], image_score [Si, U], saa_dom [E, U], sa_val [La, U]), or
    the restage reason ("new_signature") when a churned node carries a label
    value outside the resident interning."""
    n_l, n_si, n_e, n_la = shapes
    u = len(idxs)
    label_ok = np.ones((n_l, u), dtype=bool)
    label_prio = np.zeros(u, dtype=np.int64)
    image_score = np.zeros((n_si, u), dtype=np.int64)
    saa_dom = np.zeros((n_e, u), dtype=np.int32)
    sa_val = np.zeros((n_la, u), dtype=np.int32)
    if cp is None:
        return label_ok, label_prio, image_score, saa_dom, sa_val

    for r, (_slot, entries) in enumerate(cp.label_rows):
        label_ok[r] = _label_pred_row([by_idx[i] for i in idxs], entries)
    for label, presence, weight in cp.label_prios:
        for k, i in enumerate(idxs):
            if (label in by_idx[i].metadata.labels) == presence:
                label_prio[k] += weight * MAX_PRIORITY
    if ptabs is not None and ptabs.has_image:
        for s, rep in enumerate(res.img_reps):
            for k, i in enumerate(idxs):
                info = SimpleNamespace(node=by_idx[i])
                image_score[s, k] = image_locality_priority_map(
                    rep, None, info).score
    for rows, labels, maps in ((saa_dom, [lb for lb, _w in cp.saa_entries],
                                res.saa_value_maps),
                               (sa_val, res.sa_labels, res.sa_value_maps)):
        for li, label in enumerate(labels):
            vmap = maps[li]
            for k, i in enumerate(idxs):
                value = by_idx[i].metadata.labels.get(label)
                if value is None:
                    continue
                vid = vmap.get(value)
                if vid is None:
                    return "new_signature"
                rows[li, k] = vid
    return label_ok, label_prio, image_score, saa_dom, sa_val
