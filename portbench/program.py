"""The system under test, as the benchmark drives it: the port's streaming
twin (`tpusim_torch.stream.StreamSession`) built from a cell's plain inputs.

This is the only module of the benchmark that imports the program. It turns
the generator's NodeSpec and PodSpec into the port's objects and hands each
cycle's events and arrivals to `StreamSession.apply_events` and
`StreamSession.schedule`, the entry the window times.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

from portbench.generator import CellInputs, Cycle, PodSpec, app_label


class Twin:
    """A StreamSession over the cell's cluster and standing population."""

    def __init__(self, config: dict, inputs: CellInputs, device: str):
        from tpusim_torch.api.snapshot import ClusterSnapshot, make_node, \
            make_pod
        from tpusim_torch.api.types import Pod, Service, Taint
        from tpusim_torch.framework.store import DELETED, MODIFIED
        from tpusim_torch.stream import StreamSession

        self._make_pod = make_pod
        self._pod_type = Pod
        self._shapes: Dict[tuple, object] = {}
        self._taint = Taint
        self.DELETED, self.MODIFIED = DELETED, MODIFIED
        pods_cfg = config["pods"]
        self.tolerations = ([dict(pods_cfg["toleration"])]
                            if pods_cfg.get("toleration") else None)
        self.nodes = [make_node(nd.name, milli_cpu=nd.milli_cpu,
                                memory=nd.memory, pods=nd.pods,
                                labels=dict(nd.labels),
                                taints=[dict(t) for t in nd.taints] or None)
                      for nd in inputs.nodes]
        running = [self.pod(p, node_name=inputs.nodes[j].name,
                            phase="Running")
                   for p, j in zip(inputs.population, inputs.placed_on)]
        services = [Service.from_obj({"metadata": {"name": f"svc-a{a}"},
                                      "spec": {"selector": {"app": f"a{a}"}}})
                    for a in range(inputs.apps)]
        snapshot = ClusterSnapshot(nodes=list(self.nodes), pods=running,
                                   services=services)
        # the pods bound so far, by name, as the program bound them: an
        # eviction is the DELETED event of that object
        self.bound: Dict[str, object] = {p.name: p for p in running}
        sched = config["scheduler"]
        policy = None
        if "policy" in sched:
            from tpusim_torch.engine.policy import decode_policy

            policy = decode_policy(sched["policy"])
        self.session = StreamSession(
            snapshot, provider=sched.get("provider", "DefaultProvider"),
            policy=policy, device=device)

    def pod(self, p: PodSpec, **kw):
        return self._make_pod(p.name, milli_cpu=p.milli_cpu, memory=p.memory,
                              labels=app_label(p.app),
                              tolerations=(self.tolerations if p.tolerate
                                           else None), **kw)

    def arrival(self, p: PodSpec):
        """A pending pod: a copy of its shape's pod with its own metadata,
        sharing the shape's spec and empty status, which the program reads
        and never changes (a decision binds or marks a copy). Parsing the
        quantities pod by pod would take the harness about 1 ms a cycle."""
        key = (p.milli_cpu, p.memory, p.tolerate, p.app)
        shape = self._shapes.get(key)
        if shape is None:
            shape = self._shapes[key] = self.pod(p)
        meta = copy.copy(shape.metadata)
        meta.name = meta.uid = p.name
        meta.labels = dict(shape.metadata.labels)
        return self._pod_type(metadata=meta, spec=shape.spec,
                              status=shape.status)

    def prepare(self, c: Cycle) -> Tuple[list, list]:
        """The cycle's watch events and its pending pods, as objects."""
        events = [(self.DELETED, self.bound.pop(name)) for name in c.evict]
        for i, labels in c.relabel:
            node = self.nodes[i].copy()
            node.metadata.labels = dict(labels)
            self.nodes[i] = node
            events.append((self.MODIFIED, node))
        for i, taints in c.retaint:
            node = self.nodes[i].copy()
            node.spec.taints = [self._taint.from_obj(t) for t in taints]
            self.nodes[i] = node
            events.append((self.MODIFIED, node))
        return events, [self.arrival(p) for p in c.arrivals]

    def run_cycle(self, events: list, pods: list):
        """The timed entry: the events folded in, then the batch decided."""
        self.session.apply_events(events)
        return self.session.schedule(pods)

    def note(self, placements) -> List[str]:
        """Record the cycle's binds; returns the bound pods' names."""
        names = []
        for pl in placements:
            if pl.node_name:
                self.bound[pl.pod.name] = pl.pod
                names.append(pl.pod.name)
        return names
