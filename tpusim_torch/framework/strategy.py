"""Emulation strategy: how a scheduling decision mutates cluster state.

Reference: pkg/framework/strategy/strategy.go:29-83 — the predictive strategy's
Add marks the pod Running and routes it through ResourceStore.Update so the
Modified event reaches the scheduler's cache; Update/Delete are unimplemented
upstream and raise here.
"""

from __future__ import annotations

from tpusim_torch.api.types import Pod, ResourceType
from tpusim_torch.framework.store import ResourceStore


class PredictiveStrategy:
    def __init__(self, store: ResourceStore):
        self._store = store

    def add(self, pod: Pod) -> None:
        """strategy.go:47-75: the pod must already carry its binding
        (spec.nodeName); phase goes Running and the store emits Modified."""
        if not pod.spec.node_name:
            raise ValueError("predictive strategy requires a bound pod (nodeName set)")
        pod.status.phase = "Running"
        self._store.update(ResourceType.PODS, pod)

    def update(self, pod: Pod) -> None:
        raise NotImplementedError("Not implemented yet")  # strategy.go:77-79

    def delete(self, pod: Pod) -> None:
        raise NotImplementedError("Not implemented yet")  # strategy.go:81-83
