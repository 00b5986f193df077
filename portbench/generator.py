"""The inputs of a cell, made from its configuration, its traffic mix and a
seed: the cluster's nodes, the standing population of Running pods, the
Services, and each cycle's watch events and arrivals.

Frozen here from the port's own generators, so that a change to the program
cannot move the yardstick:

- the nodes and the pod mix follow `tpusim_torch/workloads.py::build_workload`
  (node shapes in turn, a taint on every k-th node, Zipf requests, a share
  of pods that tolerate the taint), read from the configuration's file
  instead of constants: a configuration with one shape and one request size
  is uniform;
- the churn is `tpusim_torch/stream/loadgen.py::ChurnLoadGen`'s (evictions of
  bound pods, label rewrites over a closed universe, a NoSchedule taint
  toggled), with the arrivals drawn from the configuration's own mix, the
  standing population among the eviction candidates, and an O(1) eviction
  draw in place of a sort of every bound name.

Everything is plain data (`NodeSpec`, `PodSpec`, `Cycle`): `program.py` turns
it into the port's objects and `reference/` reads it as it is, so both sides
are handed the same inputs and neither reads what the other made.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

GIB = 1 << 30
MIB = 1 << 20


@dataclass
class NodeSpec:
    name: str
    milli_cpu: int
    memory: int
    pods: int
    labels: Dict[str, str]
    taints: List[Dict[str, str]]


@dataclass(frozen=True)
class PodSpec:
    name: str
    milli_cpu: int
    memory: int
    tolerate: bool          # tolerates the configuration's node taint
    app: int                # index of its app label and Service, -1 none


@dataclass
class Cycle:
    """One cycle's watch events, in the order they are applied, then its
    arrivals. `evict` names bound pods (DELETED); `relabel` and `retaint`
    give a node's whole new labels or taints (MODIFIED)."""

    evict: List[str] = field(default_factory=list)
    relabel: List[Tuple[int, Dict[str, str]]] = field(default_factory=list)
    retaint: List[Tuple[int, List[Dict[str, str]]]] = field(default_factory=list)
    arrivals: List[PodSpec] = field(default_factory=list)


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def make_nodes(cluster: dict) -> List[NodeSpec]:
    """The configuration's nodes: node i takes shape i % len(shapes), the
    taint when i % taint_every == 0, and for each label the value
    values[(i % period) // span]."""
    shapes = cluster["shapes"]
    out = []
    for i in range(cluster["nodes"]):
        cpu, mem_gib = shapes[i % len(shapes)]
        labels = {"kubernetes.io/hostname": f"node-{i}"}
        for key, rule in cluster.get("labels", {}).items():
            values = rule["values"]
            labels[key] = values[(i % rule["period"]) // rule["span"]]
        taints = ([dict(cluster["taint"])]
                  if cluster.get("taint_every") and i % cluster["taint_every"] == 0
                  else [])
        out.append(NodeSpec(f"node-{i}", cpu, mem_gib * GIB,
                            cluster["max_pods"], labels, taints))
    return out


class PodMix:
    """Pods drawn from the configuration's mix: Zipf cpu and memory buckets
    drawn apart, the taint's tolerating share, and an app label drawn Zipf
    over the configuration's apps (none where it has no apps)."""

    def __init__(self, pods: dict, rng: np.random.Generator, prefix: str):
        self.cpu = np.asarray(pods["cpu_m"], dtype=np.int64)
        self.mem = np.asarray(pods["memory_mib"], dtype=np.int64) * MIB
        # without zipf_s the request sizes are drawn alike
        self.w_cpu = zipf_weights(len(self.cpu), pods.get("zipf_s", 0.0))
        self.w_mem = zipf_weights(len(self.mem), pods.get("zipf_s", 0.0))
        self.tolerate_share = pods.get("tolerate_share", 0.0)
        self.apps = pods.get("apps", 0)
        self.w_app = (zipf_weights(self.apps, pods["app_zipf_s"])
                      if self.apps else None)
        self.rng = rng
        self.prefix = prefix
        self.serial = 0

    def draw(self, n: int) -> List[PodSpec]:
        rng = self.rng
        cpu = self.cpu[rng.choice(len(self.cpu), size=n, p=self.w_cpu)]
        mem = self.mem[rng.choice(len(self.mem), size=n, p=self.w_mem)]
        tol = rng.random(n) < self.tolerate_share
        app = (rng.choice(self.apps, size=n, p=self.w_app) if self.apps
               else np.full(n, -1))
        out = [PodSpec(f"{self.prefix}-{self.serial + k}", int(cpu[k]),
                       int(mem[k]), bool(tol[k]), int(app[k]))
               for k in range(n)]
        self.serial += n
        return out


def place_population(nodes: List[NodeSpec], pods: List[PodSpec]
                     ) -> List[int]:
    """The standing population's nodes, given and not decided, as a live
    snapshot's Running pods are: pod k goes to the first node, from node
    k % N on and around, that has room for its cpu, memory and pod count
    and whose taints it tolerates. -1 where none has (the pod is left out)."""
    n = len(nodes)
    free_cpu = [nd.milli_cpu for nd in nodes]
    free_mem = [nd.memory for nd in nodes]
    free_pods = [nd.pods for nd in nodes]
    tainted = [bool(nd.taints) for nd in nodes]
    out = []
    for k, p in enumerate(pods):
        chosen = -1
        for step in range(n):
            j = (k + step) % n
            if (free_cpu[j] >= p.milli_cpu and free_mem[j] >= p.memory
                    and free_pods[j] >= 1 and (p.tolerate or not tainted[j])):
                chosen = j
                break
        if chosen >= 0:
            free_cpu[chosen] -= p.milli_cpu
            free_mem[chosen] -= p.memory
            free_pods[chosen] -= 1
        out.append(chosen)
    return out


class Traffic:
    """A cell's cycles, drawn from one seed. Arrivals are drawn from the
    configuration's mix whatever the program decides; evictions draw
    uniformly from the pods bound so far (the standing population
    included), so they follow the decisions, which `note_bound` reports."""

    def __init__(self, config: dict, mix: dict, nodes: List[NodeSpec],
                 seed: int, bound: Dict[str, int]):
        self.mix = mix
        ss = np.random.SeedSequence(seed)
        draws, evicts, churns = ss.spawn(3)
        self.pods = PodMix(config["pods"], np.random.default_rng(draws),
                           "arr")
        self.evict_rng = np.random.default_rng(evicts)
        self.churn_rng = np.random.default_rng(churns)
        self.n_nodes = len(nodes)
        self.labels = [dict(nd.labels) for nd in nodes]
        self.taints = [list(nd.taints) for nd in nodes]
        self.universe = {k: list(v) for k, v in
                         mix.get("label_universe", {}).items()}
        self.churn_taint = mix.get("churn_taint")
        # eviction candidates: a list and its index, so a draw and a
        # removal cost O(1)
        self.bound_names: List[str] = list(bound)
        self.bound_pos = {name: i for i, name in enumerate(self.bound_names)}

    def _unbind(self, name: str) -> None:
        i = self.bound_pos.pop(name)
        last = self.bound_names.pop()
        if i < len(self.bound_names):
            self.bound_names[i] = last
            self.bound_pos[last] = i

    def note_bound(self, names) -> None:
        for name in names:
            self.bound_pos[name] = len(self.bound_names)
            self.bound_names.append(name)

    def next_cycle(self) -> Cycle:
        mix = self.mix
        c = Cycle()
        for _ in range(min(mix["evictions"], len(self.bound_names))):
            name = self.bound_names[
                int(self.evict_rng.integers(len(self.bound_names)))]
            self._unbind(name)
            c.evict.append(name)
        rng = self.churn_rng
        for _ in range(mix.get("label_churn", 0)):
            i = int(rng.integers(self.n_nodes))
            labels = dict(self.labels[i])
            for key, values in self.universe.items():
                choice = int(rng.integers(len(values) + 1))
                if choice == len(values):
                    labels.pop(key, None)
                else:
                    labels[key] = values[choice]
            self.labels[i] = labels
            c.relabel.append((i, dict(labels)))
        for _ in range(mix.get("taint_churn", 0)):
            i = int(rng.integers(self.n_nodes))
            taints = [] if self.taints[i] else [dict(self.churn_taint)]
            self.taints[i] = taints
            c.retaint.append((i, [dict(t) for t in taints]))
        c.arrivals = self.pods.draw(mix["arrivals"])
        return c


@dataclass
class CellInputs:
    nodes: List[NodeSpec]
    population: List[PodSpec]
    placed_on: List[int]        # population pod -> node index
    apps: int


def make_inputs(config: dict, seed: int) -> CellInputs:
    """The cluster and its standing population, from the seed."""
    nodes = make_nodes(config["cluster"])
    ss = np.random.SeedSequence([seed, 1])
    mix = PodMix(config["pods"], np.random.default_rng(ss), "run")
    population = mix.draw(config["population"])
    placed_on = place_population(nodes, population)
    kept = [(p, j) for p, j in zip(population, placed_on) if j >= 0]
    return CellInputs(nodes, [p for p, _ in kept], [j for _, j in kept],
                      config["pods"].get("apps", 0))


def app_label(app: int) -> Optional[Dict[str, str]]:
    return {"app": f"a{app}"} if app >= 0 else None
