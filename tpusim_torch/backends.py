"""SimulatorBackend boundary: Schedule(pod_batch, cluster_state) -> placements.

The orchestration layer feeds an ordered pod batch plus a cluster snapshot
to a backend and gets back placements and failure reasons. Two
implementations:

  ReferenceBackend — pure Python, line for line the kube-scheduler loop
                     (the host route, and the device routes' parity oracle)
  TorchBackend     — the device routes on the card (tpusim_torch.backend)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod, PodCondition
from tpusim_torch.engine.generic_scheduler import FitError, SchedulingError
from tpusim_torch.engine.providers import (
    DEFAULT_PROVIDER,
    PluginFactoryArgs,
    create_from_config,
    create_from_provider,
)
from tpusim_torch.engine.resources import new_node_info_map
from tpusim_torch.engine.volume import VolumeBinder


@dataclass
class Placement:
    """One scheduling decision. For parity hashing: (pod name, node|'', reason)."""

    pod: Pod
    node_name: str = ""
    reason: str = ""   # "" on success, "Unschedulable" on predicate failure
    message: str = ""  # FitError reason histogram text

    @property
    def scheduled(self) -> bool:
        return bool(self.node_name)


def bind_pod(pod: Pod, node_name: str) -> Pod:
    """The Bind intercept's state mutation (reference: simulator.go:108-128):
    set nodeName, mark Running."""
    bound = pod.copy()
    bound.spec.node_name = node_name
    bound.status.phase = "Running"
    return bound


def mark_unschedulable(pod: Pod, message: str) -> Pod:
    """The Update intercept (reference: simulator.go:163-185 + scheduler.go
    error path): Pending phase, PodScheduled=False condition,
    Reason=Unschedulable."""
    failed = pod.copy()
    failed.status.phase = "Pending"
    failed.status.conditions.append(PodCondition(
        type="PodScheduled", status="False", reason="Unschedulable", message=message))
    failed.status.reason = "Unschedulable"
    return failed


def placement_hash(placements: List[Placement]) -> str:
    """Stable digest of the ordered decision list for parity checking."""
    h = hashlib.sha256()
    for p in placements:
        h.update(f"{p.pod.name}\x00{p.node_name}\x00{p.reason}\n".encode())
    return h.hexdigest()


class ReferenceBackend:
    """Sequential per-pod loop with reference semantics.

    Mirrors scheduleOne (scheduler.go:431-497): schedule → bind (mutating the
    node aggregates seen by the next pod) or mark unschedulable. The pod order
    is the caller's: the orchestrator reproduces the reference's LIFO feed
    (store.go:223-233).
    """

    name = "reference"

    def __init__(self, provider: str = DEFAULT_PROVIDER,
                 hard_pod_affinity_symmetric_weight: int = 10,
                 policy=None, extender_transport=None):
        self.provider = provider
        self.hard_pod_affinity_symmetric_weight = hard_pod_affinity_symmetric_weight
        # policy-as-data (factory.go CreateFromConfig); replaces the provider
        self.policy = policy
        self.extender_transport = extender_transport

    def schedule(self, pods: List[Pod], snapshot: ClusterSnapshot) -> List[Placement]:
        node_info_map = new_node_info_map(snapshot.nodes, snapshot.pods)
        nodes = list(snapshot.nodes)

        # the plugin pod lister is the SCHEDULER CACHE, not the store
        # (factory.go:166 podLister: schedulerCache): assigned pods only —
        # seeded placed pods in snapshot order, then bound pods in bind
        # order (the cache's deterministic stand-in for Go's random map
        # iteration). "First matching pod" consumers (the ServiceAffinity
        # predicate) depend on this order.
        cluster_pods: List[Pod] = [p for p in snapshot.pods if p.spec.node_name]
        # VolumeScheduling (delayed binding) runs on the host orchestrator,
        # simulator.ClusterCapacity; here the gate stays off
        binder = VolumeBinder(snapshot.pvs, snapshot.pvcs,
                              snapshot.storage_classes)

        args = PluginFactoryArgs(
            pod_lister=lambda: list(cluster_pods),
            service_lister=lambda: list(snapshot.services),
            node_info_getter=lambda name: node_info_map.get(name),
            pvc_getter=binder.get_pvc,
            pv_getter=binder.get_pv,
            storage_class_getter=binder.get_class,
            volume_binder=binder,
            hard_pod_affinity_symmetric_weight=self.hard_pod_affinity_symmetric_weight,
        )
        if self.policy is not None:
            scheduler = create_from_config(
                self.policy, args,
                extender_transport=self.extender_transport)
        else:
            scheduler = create_from_provider(self.provider, args)

        placements: List[Placement] = []
        for pod in pods:
            try:
                host = scheduler.schedule(pod, nodes, node_info_map)
            except FitError as fit_err:
                placements.append(Placement(pod=mark_unschedulable(pod, fit_err.error()),
                                            reason="Unschedulable",
                                            message=fit_err.error()))
                continue
            except SchedulingError as sched_err:
                placements.append(Placement(pod=mark_unschedulable(pod, str(sched_err)),
                                            reason="Unschedulable",
                                            message=str(sched_err)))
                continue
            bound = bind_pod(pod, host)
            node_info_map[host].add_pod(bound)
            cluster_pods.append(bound)  # enters the cache view on bind
            placements.append(Placement(pod=bound, node_name=host))
        return placements


def get_backend(name: str, **kwargs):
    if name == "reference":
        return ReferenceBackend(**kwargs)
    if name == "torch":
        from tpusim_torch.backend import TorchBackend

        return TorchBackend(**kwargs)
    raise ValueError(f"unknown backend {name!r} (expected 'reference' or 'torch')")
