"""A plain NumPy kube-scheduler v1.10 for the benchmark's cells: the
DefaultProvider, or a scheduler Policy as the configuration's file writes it,
deciding one cycle's pods in order over node state of its own.

Written from upstream's semantics (pkg/scheduler/core/generic_scheduler.go,
algorithm/predicates, algorithm/priorities at v1.10) and independent of the
program under test: it imports nothing of it and reads only the benchmark's
plain inputs (generator.NodeSpec, generator.PodSpec, the cycle's events).

What it decides, per pod:
  filter   predicates in upstream's fixed order, a node stopping at its first
           failing predicate (GeneralPredicates reports each insufficient
           resource); a policy's custom predicates run after the ordered ones,
           sorted by name (the 1.11 behaviour; 1.10 skipped them);
  score    the weighted sum of the priorities, each map/reduce over the nodes
           that passed the filter;
  select   the highest score, ties in node order, picked round robin by a
           counter that starts at 0 each cycle and moves only when more than
           one node passed the filter (a lone feasible node is taken
           directly); no feasible node: FitError's text, the reasons counted
           over the nodes and sorted as strings.

It covers what the cells' inputs hold: cpu, memory and pod-count requests,
NoSchedule taints and Equal tolerations, node labels, one Service per app
label. Inputs outside that (volumes, affinity terms, node conditions, a
failure-domain zone label) raise NotImplementedError rather than being
decided wrongly.

Scores are exact rationals with one floor at the end (the repository's
documented departure from Go, DEVIATIONS.md 16: Go computes
BalancedResourceAllocation and the SelectorSpread and ServiceAntiAffinity
normalizes in float64 and truncates, which differs where the rounding
crosses a whole number).

Departures that make controls of the comparison that decides `correct`:
`precision="float64"` computes those scores as Go does, in float64, and
`"float32"` one precision below that; `carry_rr=True` carries selectHost's
counter from one cycle's batch to the next (upstream's persistent
lastNodeIndex) instead of starting each batch from 0, and `first_tie=True`
takes the first of the tied nodes (an argmax's choice) instead of going
round robin: both break the tie-break guarantee the configurations state.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_PRIORITY = 10
DEFAULT_MILLI_CPU = 100                 # priorities/util/non_zero.go
DEFAULT_MEMORY = 200 * 1024 * 1024
ZONE_KEYS = ("failure-domain.beta.kubernetes.io/zone",
             "failure-domain.beta.kubernetes.io/region")

# predicates.Ordering() at v1.10 (predicates.go predicatesOrdering)
ORDERING = (
    "CheckNodeCondition", "CheckNodeUnschedulable", "GeneralPredicates",
    "HostName", "PodFitsHostPorts", "MatchNodeSelector", "PodFitsResources",
    "NoDiskConflict", "PodToleratesNodeTaints",
    "PodToleratesNodeNoExecuteTaints", "CheckNodeLabelPresence",
    "CheckServiceAffinity", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "CheckVolumeBinding", "NoVolumeZoneConflict",
    "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
    "MatchInterPodAffinity",
)
# predicates that the cells' inputs can never fail: no volumes, no host
# ports, no node selectors or affinity, no node conditions
ALWAYS_PASS = frozenset((
    "CheckNodeUnschedulable", "HostName", "PodFitsHostPorts",
    "MatchNodeSelector", "NoDiskConflict", "PodToleratesNodeNoExecuteTaints",
    "MaxEBSVolumeCount", "MaxGCEPDVolumeCount", "MaxAzureDiskVolumeCount",
    "CheckVolumeBinding", "NoVolumeZoneConflict", "CheckNodeMemoryPressure",
    "CheckNodeDiskPressure", "MatchInterPodAffinity",
))
# algorithmprovider/defaults at v1.10, CheckNodeCondition being mandatory
DEFAULT_PREDICATES = (
    "NoVolumeZoneConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "MatchInterPodAffinity", "NoDiskConflict",
    "GeneralPredicates", "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
    "CheckNodeCondition", "PodToleratesNodeTaints", "CheckVolumeBinding",
)
DEFAULT_PRIORITIES = (
    ("SelectorSpreadPriority", 1), ("InterPodAffinityPriority", 1),
    ("LeastRequestedPriority", 1), ("BalancedResourceAllocation", 1),
    ("NodePreferAvoidPodsPriority", 10000), ("NodeAffinityPriority", 1),
    ("TaintTolerationPriority", 1),
)

R_PODS = "Insufficient pods"
R_CPU = "Insufficient cpu"
R_MEM = "Insufficient memory"
R_TAINT = "node(s) had taints that the pod didn't tolerate"
R_SERVICE = "node(s) didn't match service affinity"


def _tolerates(toleration: Optional[dict], taint: dict) -> bool:
    """v1.Toleration.ToleratesTaint for the Equal and Exists operators."""
    if toleration is None:
        return False
    if toleration.get("effect") and toleration["effect"] != taint["effect"]:
        return False
    if toleration.get("key") and toleration["key"] != taint["key"]:
        return False
    op = toleration.get("operator", "Equal")
    if op == "Exists":
        return True
    if op != "Equal":
        raise NotImplementedError(f"toleration operator {op}")
    return toleration.get("value", "") == taint.get("value", "")


class Policy:
    """The predicates and the weighted priorities the scheduler runs: the
    DefaultProvider's, or a Policy document's. Each custom predicate is a
    ("service_affinity", labels) and each custom priority a
    ("service_anti_affinity", label) entry."""

    def __init__(self, scheduler: dict):
        if "policy" not in scheduler:
            if scheduler.get("provider", "DefaultProvider") != "DefaultProvider":
                raise NotImplementedError(scheduler["provider"])
            predicates = list(DEFAULT_PREDICATES)
            self.custom_predicates: Dict[str, Tuple[str, list]] = {}
            self.priorities = [(name, w, None) for name, w in DEFAULT_PRIORITIES]
        else:
            doc = scheduler["policy"]
            predicates, self.custom_predicates = [], {}
            for p in doc.get("predicates", []):
                arg = p.get("argument")
                if arg is None:
                    predicates.append(p["name"])
                elif "serviceAffinity" in arg:
                    self.custom_predicates[p["name"]] = (
                        "service_affinity", list(arg["serviceAffinity"]["labels"]))
                else:
                    raise NotImplementedError(f"predicate argument {arg}")
            # CheckNodeCondition is mandatory in every configuration
            if "CheckNodeCondition" not in predicates:
                predicates.append("CheckNodeCondition")
            self.priorities = []
            for p in doc.get("priorities", []):
                arg = p.get("argument")
                if arg is None:
                    self.priorities.append((p["name"], p["weight"], None))
                elif "serviceAntiAffinity" in arg:
                    self.priorities.append(
                        ("ServiceAntiAffinity", p["weight"],
                         arg["serviceAntiAffinity"]["label"]))
                else:
                    raise NotImplementedError(f"priority argument {arg}")
        known = set(ORDERING)
        for name in predicates:
            if name not in known:
                raise NotImplementedError(f"predicate {name}")
        # the order a node's predicates run in: upstream's ordering, then
        # the custom ones by name
        self.order = [n for n in ORDERING if n in predicates] + sorted(
            self.custom_predicates)
        for name, _w, _arg in self.priorities:
            if name not in _PRIORITY_NAMES:
                raise NotImplementedError(f"priority {name}")


_PRIORITY_NAMES = frozenset((
    "SelectorSpreadPriority", "InterPodAffinityPriority",
    "LeastRequestedPriority", "BalancedResourceAllocation",
    "NodePreferAvoidPodsPriority", "NodeAffinityPriority",
    "TaintTolerationPriority", "ServiceAntiAffinity", "EqualPriority",
))


class ReferenceScheduler:
    """Node state of its own, folded from the same events as the program
    is, and the scheduler's decisions over it."""

    def __init__(self, config: dict, nodes, precision: str = "exact",
                 carry_rr: bool = False, first_tie: bool = False):
        if precision not in ("exact", "float64", "float32"):
            raise ValueError(precision)
        self.carry_rr = carry_rr
        self.first_tie = first_tie
        self.rr = 0
        self.exact = precision == "exact"
        self.frac_dtype = np.float32 if precision == "float32" else np.float64
        self.policy = Policy(config["scheduler"])
        self.toleration = (dict(config["pods"]["toleration"])
                           if config["pods"].get("toleration") else None)
        n = len(nodes)
        self.n = n
        self.names = [nd.name for nd in nodes]
        self.alloc_cpu = np.array([nd.milli_cpu for nd in nodes], np.int64)
        self.alloc_mem = np.array([nd.memory for nd in nodes], np.int64)
        self.allowed = np.array([nd.pods for nd in nodes], np.int64)
        # the exact balanced score multiplies cpu by memory, 10 times that
        # has to stay inside int64, and LeastRequested's float quotient is
        # exact while 10 x memory stays below 2^53
        if (self.alloc_cpu <= 0).any() or (self.alloc_mem <= 0).any() \
                or (self.alloc_cpu * self.alloc_mem).max() >= 1 << 59 \
                or self.alloc_mem.max() >= 1 << 49:
            raise NotImplementedError("a node without cpu or memory, or "
                                      "too large for exact int64 scores")
        self.cap_cpu_64 = self.alloc_cpu.astype(np.float64)
        self.cap_mem_64 = self.alloc_mem.astype(np.float64)
        self.cap_cpu_f = self.alloc_cpu.astype(self.frac_dtype)
        self.cap_mem_f = self.alloc_mem.astype(self.frac_dtype)
        self.used_cpu = np.zeros(n, np.int64)
        self.used_mem = np.zeros(n, np.int64)
        self.nz_cpu = np.zeros(n, np.int64)
        self.nz_mem = np.zeros(n, np.int64)
        self.count = np.zeros(n, np.int64)
        self.apps = config["pods"].get("apps", 0)
        self.app_count = np.zeros((max(self.apps, 1), n), np.int64)
        self.labels: List[Dict[str, str]] = []
        self.taints: List[list] = []
        # untolerated NoSchedule/NoExecute taints, PreferNoSchedule counts,
        # for pods without (0) and with (1) the configuration's toleration
        self.blocked = np.zeros((2, n), bool)
        self.prefer_untol = np.zeros((2, n), np.int64)
        # each label key's values as codes a node, -1 where it is absent
        self.label_codes: Dict[str, np.ndarray] = {}
        self.label_values: Dict[str, Dict[str, int]] = {}
        for i, nd in enumerate(nodes):
            self.labels.append({})
            self._set_labels(i, nd.labels)
            self.taints.append([dict(t) for t in nd.taints])
            self._taint_row(i)
        self.any_prefer = bool(self.prefer_untol.any())
        # live pods: name -> (PodSpec, node index); ServiceAffinity's first
        # matching pod is the earliest bound of those still live
        self.pods: Dict[str, Tuple[object, int]] = {}
        # app -> its live pods' nodes by name, in that order
        self.by_app: Dict[int, "OrderedDict[str, int]"] = {}

    # -- node state -----------------------------------------------------
    def _code(self, key: str, value: Optional[str]) -> int:
        """A label value's code under `key`, -1 for an absent label."""
        if value is None:
            return -1
        codes = self.label_values.setdefault(key, {})
        return codes.setdefault(value, len(codes))

    def _set_labels(self, i: int, labels: Dict[str, str]) -> None:
        if any(k in labels for k in ZONE_KEYS):
            raise NotImplementedError("SelectorSpread's zone weighting")
        for key in set(self.labels[i]) | set(labels):
            if key not in self.label_codes:
                self.label_codes[key] = np.full(self.n, -1, np.int64)
            self.label_codes[key][i] = self._code(key, labels.get(key))
        self.labels[i] = dict(labels)

    def _taint_row(self, i: int) -> None:
        for tol in (0, 1):
            toleration = self.toleration if tol else None
            blocked, prefer = False, 0
            for taint in self.taints[i]:
                ok = _tolerates(toleration, taint)
                if taint["effect"] in ("NoSchedule", "NoExecute") and not ok:
                    blocked = True
                elif taint["effect"] == "PreferNoSchedule" and not ok:
                    prefer += 1
            self.blocked[tol, i] = blocked
            self.prefer_untol[tol, i] = prefer

    def relabel(self, i: int, labels: Dict[str, str]) -> None:
        self._set_labels(i, labels)

    def retaint(self, i: int, taints: list) -> None:
        self.taints[i] = [dict(t) for t in taints]
        self._taint_row(i)
        self.any_prefer = bool(self.prefer_untol.any())

    def bind(self, pod, i: int) -> None:
        self.used_cpu[i] += pod.milli_cpu
        self.used_mem[i] += pod.memory
        self.nz_cpu[i] += pod.milli_cpu or DEFAULT_MILLI_CPU
        self.nz_mem[i] += pod.memory or DEFAULT_MEMORY
        self.count[i] += 1
        if pod.app >= 0:
            self.app_count[pod.app, i] += 1
            self.by_app.setdefault(pod.app, OrderedDict())[pod.name] = i
        self.pods[pod.name] = (pod, i)

    def evict(self, name: str) -> bool:
        """Remove a bound pod; False where this side never bound it."""
        entry = self.pods.pop(name, None)
        if entry is None:
            return False
        pod, i = entry
        self.used_cpu[i] -= pod.milli_cpu
        self.used_mem[i] -= pod.memory
        self.nz_cpu[i] -= pod.milli_cpu or DEFAULT_MILLI_CPU
        self.nz_mem[i] -= pod.memory or DEFAULT_MEMORY
        self.count[i] -= 1
        if pod.app >= 0:
            self.app_count[pod.app, i] -= 1
            del self.by_app[pod.app][name]
        return True

    # -- one pod ----------------------------------------------------------
    def _service_pin(self, pod, labels: List[str]) -> Dict[str, str]:
        """checkServiceAffinity's label values: those of the node of the
        first live pod with the pod's labels, where the pod has a Service."""
        live = self.by_app.get(pod.app) if pod.app >= 0 else None
        if not live:
            return {}
        node_labels = self.labels[next(iter(live.values()))]
        return {k: node_labels[k] for k in labels if k in node_labels}

    def _filter(self, pod):
        """(feasible mask, [(stage's failing nodes, their reasons)]): each
        node stops at its first failing predicate. A reason array is built
        only where no node passes, for FitError's text."""
        n = self.n
        tol = 1 if pod.tolerate else 0
        failed = np.zeros(n, bool)
        stages = []
        for name in self.policy.order:
            if name in ALWAYS_PASS or name == "CheckNodeCondition":
                continue
            if name in ("GeneralPredicates", "PodFitsResources"):
                parts = ((R_PODS, self.count + 1 > self.allowed),
                         (R_CPU, self.alloc_cpu < pod.milli_cpu + self.used_cpu),
                         (R_MEM, self.alloc_mem < pod.memory + self.used_mem))
                fail = parts[0][1] | parts[1][1] | parts[2][1]
            elif name == "PodToleratesNodeTaints":
                fail = self.blocked[tol].copy()
                parts = ((R_TAINT, fail),)
            elif name in self.policy.custom_predicates:
                _kind, keys = self.policy.custom_predicates[name]
                fail = np.zeros(n, bool)
                for key, value in self._service_pin(pod, keys).items():
                    fail |= self.label_codes[key] != self._code(key, value)
                parts = ((R_SERVICE, fail),)
            else:
                raise NotImplementedError(name)
            fail &= ~failed
            stages.append((fail, parts))
            failed |= fail
        return ~failed, stages

    # Each priority maps every node and reduces over the feasible ones
    # (`ok`); the total is read only where `ok` holds.

    def _least_requested(self, pod, ok):
        """(cap - requested) * 10 // cap a resource, the mean of cpu's and
        memory's, over the nodes' nonzero requests and the pod's. The floor
        of a float64 quotient is the integer one here: every operand is
        exact below 2^53, and a quotient that is not whole lies at least
        1/cap, far above float64's rounding, from the next whole number."""
        def score(requested, capacity_f, capacity):
            out = np.floor((capacity - requested) * MAX_PRIORITY
                           / capacity_f).astype(np.int64)
            return np.where(requested > capacity, 0, out)

        cpu = score(self.nz_cpu + (pod.milli_cpu or DEFAULT_MILLI_CPU),
                    self.cap_cpu_64, self.alloc_cpu)
        mem = score(self.nz_mem + (pod.memory or DEFAULT_MEMORY),
                    self.cap_mem_64, self.alloc_mem)
        return (cpu + mem) // 2

    def _balanced(self, pod, ok):
        """int((1 - |cpu fraction - memory fraction|) * 10), 0 where either
        fraction reaches 1: exactly, floor(10 (den - |rc am - rm ac|) / den)
        with den = ac am; or as Go computes it, in floating point."""
        rc = self.nz_cpu + (pod.milli_cpu or DEFAULT_MILLI_CPU)
        rm = self.nz_mem + (pod.memory or DEFAULT_MEMORY)
        ac, am = self.alloc_cpu, self.alloc_mem
        full = (rc >= ac) | (rm >= am)
        if self.exact:
            num = np.abs(np.minimum(rc, ac) * am - np.minimum(rm, am) * ac)
            den = ac * am
            score = (MAX_PRIORITY * (den - num)) // den
        else:
            dt = self.frac_dtype
            diff = np.abs(rc.astype(dt) / self.cap_cpu_f
                          - rm.astype(dt) / self.cap_mem_f)
            score = ((dt(1) - diff) * dt(MAX_PRIORITY)).astype(np.int64)
        return np.where(full, 0, score)

    def _fraction_score(self, num, den: int):
        """10 x num / den, floored: exactly, or as Go's
        int(10.0 * (float64(num) / float64(den)))."""
        if self.exact:
            return (MAX_PRIORITY * num) // den
        dt = self.frac_dtype
        return (dt(MAX_PRIORITY) * (num.astype(dt) / dt(den))).astype(np.int64)

    def _selector_spread(self, pod, ok):
        """10 x (max - count) / max over the feasible nodes, count being the
        pods of the pod's Services on the node; 10 everywhere without."""
        if pod.app < 0:
            return np.full(self.n, MAX_PRIORITY, np.int64)
        counts = self.app_count[pod.app]
        top = int(counts[ok].max())
        if top == 0:
            return np.full(self.n, MAX_PRIORITY, np.int64)
        return self._fraction_score(top - counts, top)

    def _service_anti_affinity(self, pod, ok, label: str):
        """ServiceAntiAffinity: the pod's first Service's pods counted on the
        feasible nodes, summed by the label's value; a labelled node scores
        10 x (all - its value's) / all, an unlabelled one 0."""
        codes = self.label_codes.get(label)
        if codes is None:
            return np.zeros(self.n, np.int64)
        has = codes >= 0
        counts = (np.where(ok, self.app_count[pod.app], 0) if pod.app >= 0
                  else np.zeros(self.n, np.int64))
        total = int(counts.sum())
        if total == 0:
            return np.where(has, MAX_PRIORITY, 0).astype(np.int64)
        per_value = np.bincount(codes[has], weights=counts[has],
                                minlength=len(self.label_values[label]))
        mine = np.where(has, per_value[np.maximum(codes, 0)], 0)
        return np.where(has, self._fraction_score(
            (total - mine).astype(np.int64), total), 0)

    def _taint_toleration(self, pod, ok):
        """10 - 10 x count / max over the feasible nodes, count being the
        node's PreferNoSchedule taints the pod does not tolerate."""
        counts = self.prefer_untol[1 if pod.tolerate else 0]
        top = int(counts[ok].max()) if self.any_prefer else 0
        if top == 0:
            return np.full(self.n, MAX_PRIORITY, np.int64)
        # NormalizeReduce(MaxPriority, reverse=true), in integers
        return MAX_PRIORITY - (MAX_PRIORITY * counts) // top

    def _scores(self, pod, ok):
        total = np.zeros(self.n, np.int64)
        for name, weight, arg in self.policy.priorities:
            if name == "LeastRequestedPriority":
                s = self._least_requested(pod, ok)
            elif name == "BalancedResourceAllocation":
                s = self._balanced(pod, ok)
            elif name == "SelectorSpreadPriority":
                s = self._selector_spread(pod, ok)
            elif name == "ServiceAntiAffinity":
                s = self._service_anti_affinity(pod, ok, arg)
            elif name == "TaintTolerationPriority":
                s = self._taint_toleration(pod, ok)
            elif name in ("NodePreferAvoidPodsPriority", "EqualPriority"):
                # no node carries the preferAvoidPods annotation: every
                # node scores alike, as under EqualPriority
                continue
            else:
                # InterPodAffinityPriority and NodeAffinityPriority: no pod
                # has an affinity term, so every node scores 0
                continue
            total += weight * s
        return total

    def decide(self, pod, rr: int) -> Tuple[str, str, int]:
        """(node name or "", FitError text or "", the counter after it)."""
        ok, stages = self._filter(pod)
        feasible = np.count_nonzero(ok)
        if feasible == 0:
            hist: Dict[str, int] = {}
            for fail, parts in stages:
                for reason, mask in parts:
                    c = int(np.count_nonzero(fail & mask))
                    if c:
                        hist[reason] = hist.get(reason, 0) + c
            text = ", ".join(sorted(f"{c} {r}" for r, c in hist.items()))
            return "", f"0/{self.n} nodes are available: {text}.", rr
        if feasible == 1:
            choice = int(np.flatnonzero(ok)[0])
        else:
            scores = np.where(ok, self._scores(pod, ok), -1)
            ties = np.flatnonzero(scores == scores.max())
            choice = int(ties[0 if self.first_tie else rr % len(ties)])
            rr += 1
        self.bind(pod, choice)
        return self.names[choice], "", rr

    def schedule_cycle(self, pods) -> List[Tuple[str, str]]:
        """A cycle's batch in order, as one fresh scheduler decides it."""
        rr = self.rr if self.carry_rr else 0
        out = []
        for pod in pods:
            node, msg, rr = self.decide(pod, rr)
            out.append((node, msg))
        self.rr = rr
        return out
