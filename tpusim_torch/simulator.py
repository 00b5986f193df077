"""The simulation entry: feed a pod batch to TorchBackend and collect the
Status the report prints.

The reference pops its pod queue last-in first-out (store.go:223-233), so the
feed is the batch reversed.
"""

from __future__ import annotations

from typing import List

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod
from tpusim_torch.backend import DEFAULT_PROVIDER, TorchBackend
from tpusim_torch.framework.report import Status
from tpusim_torch.gang import GANG_NAME_ANNOTATION, gang_name, has_gangs


def run_simulation(pods: List[Pod], snapshot: ClusterSnapshot,
                   provider: str = DEFAULT_PROVIDER, device="cuda",
                   hard_pod_affinity_symmetric_weight: int = 10,
                   policy=None, route: str = "auto") -> Status:
    """policy: an engine.policy.Policy replacing the provider's predicates
    and priorities (AlgorithmSource.Policy, simulator.go:383-424). route:
    TorchBackend's ("auto", "kernel" or "scan").

    A feed holding pod groups raises NotImplementedError: a gang is admitted
    all or nothing, and the port has no gang driver."""
    if has_gangs(pods):
        names = sorted({gang_name(p) for p in pods} - {""})
        raise NotImplementedError(
            f"pod groups ({GANG_NAME_ANNOTATION}: {', '.join(names)}) are "
            "admitted all or nothing, and the torch backend has no gang "
            "driver yet")
    backend = TorchBackend(
        provider=provider, device=device,
        hard_pod_affinity_symmetric_weight=hard_pod_affinity_symmetric_weight,
        policy=policy, route=route)
    feed = list(reversed(pods))  # the LIFO queue pops the last element first
    placements = backend.schedule(feed, snapshot)
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
