"""Seeded churn for the streaming twin.

Per cycle: a batch of fresh pod arrivals (the steady state the resident path
is built for), after watch events: evictions of pods bound earlier (O(delta)
commits), periodic node flaps (structural restages), label and taint churn
(statics commits) and, optionally, pod groups. Deterministic under a seed
(Python's random.Random, drawn in the JAX package's order), so the port and
the JAX package replay identical sequences.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from tpusim_torch.api.snapshot import ClusterSnapshot, make_pod
from tpusim_torch.api.types import Node, Pod, Taint
from tpusim_torch.backends import Placement
from tpusim_torch.framework.store import DELETED, MODIFIED
from tpusim_torch.gang.group import mark_gang

# (milli_cpu, memory) request shapes, in rotation
DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = (
    (100, 256 << 20),
    (250, 512 << 20),
    (500, 1 << 30),
)

# Label churn universe: the keys the compat policies gate on (region and
# zone for ServiceAffinity and ServiceAntiAffinity, foo for LabelsPresence,
# bar for LabelPreference), each over a small closed set of values, so that
# a seeded cluster interns every value at cold start and pure churn never
# grows a domain-id space.
DEFAULT_LABEL_UNIVERSE: Dict[str, Tuple[str, ...]] = {
    "zone": ("z0", "z1", "z2"),
    "region": ("r0", "r1"),
    "bar": ("on", "off"),
    "foo": ("present",),
}

# Taint churn toggles this NoSchedule taint, which the compat policies'
# tolerations do not cover, so it flips taint_ok columns.
CHURN_TAINT = Taint(key="dedicated", value="batch", effect="NoSchedule")


class ChurnLoadGen:
    """Deterministic churn: arrivals and evictions, optionally node flaps,
    label and taint churn, and gangs.

    evict_fraction: each cycle, this fraction of the arrival batch size is
        drawn from the bound population and DELETED (journal rows on the
        twin, not a restage).
    node_flap_every: every k-th cycle cordons one node (MODIFIED,
        unschedulable) and restores it the next cycle: structural events the
        twin cannot scatter, a classified restage pair.
    label_churn / taint_churn: each cycle, rewrite this many nodes' labels
        (values from label_universe, keys possibly removed) / toggle
        CHURN_TAINT on this many nodes: label- or taint-only changes, which
        the statics commit absorbs without a restage.
    gang_size / gang_count: each cycle, append gang_count complete pod
        groups of gang_size members after the arrivals, with no random draw,
        so a seeded run's churn is the same with gangs off.
    """

    def __init__(self, snapshot: ClusterSnapshot, *, seed: int = 0,
                 arrivals: int = 32, evict_fraction: float = 0.25,
                 node_flap_every: int = 0,
                 label_churn: int = 0, taint_churn: int = 0,
                 label_universe: Optional[Dict[str, Tuple[str, ...]]] = None,
                 shapes: Tuple[Tuple[int, int], ...] = DEFAULT_SHAPES,
                 name_prefix: str = "churn",
                 gang_size: int = 0, gang_count: int = 0):
        self.rng = random.Random(seed)
        self.nodes: List[Node] = list(snapshot.nodes)
        self.arrivals = arrivals
        self.evict_fraction = evict_fraction
        self.node_flap_every = node_flap_every
        self.label_churn = label_churn
        self.taint_churn = taint_churn
        self.label_universe = (DEFAULT_LABEL_UNIVERSE
                               if label_universe is None else label_universe)
        self.shapes = shapes
        self.name_prefix = name_prefix
        self.gang_size = gang_size
        self.gang_count = gang_count
        self.serial = 0
        self.gang_serial = 0
        self.bound: Dict[str, Pod] = {}       # pod name -> bound copy
        self._flapped: Optional[Node] = None  # cordoned, awaiting restore
        self.stats = {"arrivals": 0, "evictions": 0, "flaps": 0,
                      "label_churns": 0, "taint_churns": 0,
                      "gang_arrivals": 0, "gangs": 0}

    def batch(self) -> List[Pod]:
        """The cycle's fresh arrivals (pending pods, no node), the gangs
        after them."""
        out = []
        for _ in range(self.arrivals):
            cpu, mem = self.shapes[self.serial % len(self.shapes)]
            out.append(make_pod(f"{self.name_prefix}-{self.serial}",
                                milli_cpu=cpu, memory=mem))
            self.serial += 1
        self.stats["arrivals"] += len(out)
        if self.gang_size > 0 and self.gang_count > 0:
            for _ in range(self.gang_count):
                name = f"{self.name_prefix}-gang-{self.gang_serial}"
                self.gang_serial += 1
                for j in range(self.gang_size):
                    cpu, mem = self.shapes[self.serial % len(self.shapes)]
                    out.append(mark_gang(
                        make_pod(f"{name}-{j}", milli_cpu=cpu, memory=mem),
                        name))
                    self.serial += 1
                self.stats["gangs"] += 1
                self.stats["gang_arrivals"] += self.gang_size
        return out

    def events(self, cycle: int) -> List[Tuple[str, object]]:
        """The watch events before this cycle's batch."""
        out: List[Tuple[str, object]] = []
        if self._flapped is not None:
            restored = self._flapped.copy()
            restored.spec.unschedulable = False
            out.append((MODIFIED, restored))
            self._flapped = None
        n_evict = int(self.arrivals * self.evict_fraction)
        if n_evict and self.bound:
            names = self.rng.sample(sorted(self.bound),
                                    min(n_evict, len(self.bound)))
            for name in names:
                out.append((DELETED, self.bound.pop(name)))
            self.stats["evictions"] += len(names)
        if self.node_flap_every and cycle and self.nodes \
                and cycle % self.node_flap_every == 0:
            node = self.nodes[self.rng.randrange(len(self.nodes))].copy()
            node.spec.unschedulable = True
            out.append((MODIFIED, node))
            self._flapped = node
            self.stats["flaps"] += 1
        # the churn blocks draw last, so a run without them draws the same
        # sequence as it would with them off
        if self.label_churn and self.nodes:
            for _ in range(self.label_churn):
                i = self.rng.randrange(len(self.nodes))
                node = self.nodes[i].copy()
                labels = dict(node.metadata.labels)
                for key, values in self.label_universe.items():
                    choice = self.rng.randrange(len(values) + 1)
                    if choice == len(values):
                        labels.pop(key, None)
                    else:
                        labels[key] = values[choice]
                node.metadata.labels = labels
                # stored back: a later event must differ from the CURRENT
                # node in labels or taints only to ride the column path
                self.nodes[i] = node
                out.append((MODIFIED, node))
                self.stats["label_churns"] += 1
        if self.taint_churn and self.nodes:
            for _ in range(self.taint_churn):
                i = self.rng.randrange(len(self.nodes))
                node = self.nodes[i].copy()
                if node.spec.taints:
                    node.spec.taints = []
                else:
                    node.spec.taints = [Taint(key=CHURN_TAINT.key,
                                              value=CHURN_TAINT.value,
                                              effect=CHURN_TAINT.effect)]
                self.nodes[i] = node
                out.append((MODIFIED, node))
                self.stats["taint_churns"] += 1
        return out

    def note_bound(self, placements: List[Placement]) -> None:
        """Record this cycle's binds as future eviction candidates."""
        for pl in placements:
            if pl.node_name:
                self.bound[pl.pod.name] = pl.pod
