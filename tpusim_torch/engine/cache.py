"""SchedulerCache: the assumed-pod lifecycle + generation-based snapshots.

Reference: schedulercache/cache.go — schedulerCache struct (:46-80),
AssumePod/FinishBinding/ForgetPod (:125-197), AddPod confirmation and the
expire path (:199-262), the 30s assumed-pod TTL with the cleanup loop
(:32-44, :434-470), and the generation-checked snapshot
UpdateNodeNameToInfoMap (:83-97).

The lifecycle: scheduleOne optimistically Assumes the pod into the cache so
later pods see it immediately while the bind runs asynchronously
(scheduler.go:431-497); FinishBinding arms the TTL; the informer's Add event
Confirms it (clearing the deadline); an assumed pod whose confirmation never
arrives expires after the TTL and its resources are returned. In this offline
simulator the Bind intercept is synchronous, so confirmation normally lands
before FinishBinding — the machinery is engine behavior kept for parity (and
for callers that drive the seams asynchronously), exercised directly by
tests/test_cache.py.

Clock injection: `now` is a monotonic-seconds callable so tests (and any
replay driver) can control expiry deterministically, instead of the
reference's wall-clock ticker goroutine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from tpusim_torch.api.types import Node, Pod
from tpusim_torch.engine.resources import NodeInfo

DEFAULT_ASSUMED_POD_TTL = 30.0  # factory.go:156 (30 * time.Second)


@dataclass
class _PodState:
    """cache.go podState: the cached pod + its assumed-expiry bookkeeping."""

    pod: Pod
    deadline: Optional[float] = None     # set by FinishBinding (cache.go:189)
    binding_finished: bool = False


class CacheError(RuntimeError):
    """Invalid lifecycle transition (the Go methods return errors)."""


class SchedulerCache:
    def __init__(self, ttl: float = DEFAULT_ASSUMED_POD_TTL,
                 now: Callable[[], float] = time.monotonic):
        self.ttl = ttl
        self._now = now
        self.nodes: Dict[str, NodeInfo] = {}       # the live view
        self.pod_states: Dict[str, _PodState] = {}
        self.assumed_pods: set = set()

    # --- internal helpers ---

    def _info(self, node_name: str) -> NodeInfo:
        info = self.nodes.get(node_name)
        if info is None:
            info = NodeInfo()
            self.nodes[node_name] = info
        return info

    def _add_to_node(self, pod: Pod) -> None:
        self._info(pod.spec.node_name).add_pod(pod)

    def _remove_from_node(self, pod: Pod) -> None:
        info = self.nodes.get(pod.spec.node_name)
        if info is not None:
            info.remove_pod(pod)
            # cache.go removePod deletes a node entry that has become empty
            # and carries no Node object (:301-306)
            if info.node is None and not info.pods:
                del self.nodes[pod.spec.node_name]

    # --- assumed-pod lifecycle (cache.go:125-197) ---

    def assume_pod(self, pod: Pod) -> None:
        key = pod.key()
        if key in self.pod_states:
            raise CacheError(f"pod {key} is in the cache, so can't be assumed")
        self._add_to_node(pod)
        self.pod_states[key] = _PodState(pod=pod)
        self.assumed_pods.add(key)

    def finish_binding(self, pod: Pod) -> None:
        """Arms the expiry deadline (cache.go:180-197). A no-op when the pod
        was already confirmed — in the synchronous simulator the store's
        Modified event lands before FinishBinding."""
        key = pod.key()
        if key in self.assumed_pods:
            state = self.pod_states[key]
            state.binding_finished = True
            state.deadline = self._now() + self.ttl

    def forget_pod(self, pod: Pod) -> None:
        """cache.go:199-216 — only assumed pods may be forgotten."""
        key = pod.key()
        state = self.pod_states.get(key)
        if state is not None and key in self.assumed_pods:
            self._remove_from_node(state.pod)
            del self.pod_states[key]
            self.assumed_pods.discard(key)
        elif state is not None:
            raise CacheError(f"pod {key} was assumed on {pod.spec.node_name} "
                             "but assigned to a different node")

    # --- confirmed-pod events (cache.go:218-299, informer handlers) ---

    def add_pod(self, pod: Pod) -> None:
        key = pod.key()
        state = self.pod_states.get(key)
        if state is not None and key in self.assumed_pods:
            # the informer confirms the assumed pod; if the apiserver placed
            # it elsewhere, move the accounting (cache.go:226-236)
            if state.pod.spec.node_name != pod.spec.node_name:
                self._remove_from_node(state.pod)
                self._add_to_node(pod)
            else:
                # refresh the cached object without re-counting
                info = self.nodes.get(pod.spec.node_name)
                if info is not None:
                    info.pods = [pod if p.key() == key else p
                                 for p in info.pods]
            self.assumed_pods.discard(key)
            self.pod_states[key] = _PodState(pod=pod)
        elif state is None:
            # plain add (or an expired assumed pod re-added, cache.go:243-246)
            self._add_to_node(pod)
            self.pod_states[key] = _PodState(pod=pod)
        # already-confirmed duplicate Add: ignore (the simulator's Modified
        # events re-deliver the same bound pod)

    def update_pod(self, old: Pod, new: Pod) -> None:
        key = old.key()
        if key in self.assumed_pods:
            raise CacheError(f"assumed pod {key} should not be updated")
        if key in self.pod_states:
            self._remove_from_node(self.pod_states[key].pod)
        self._add_to_node(new)
        self.pod_states[key] = _PodState(pod=new)

    def remove_pod(self, pod: Pod) -> None:
        key = pod.key()
        state = self.pod_states.get(key)
        if state is not None:
            self._remove_from_node(state.pod)
            del self.pod_states[key]
            self.assumed_pods.discard(key)

    def is_assumed_pod(self, pod: Pod) -> bool:
        return pod.key() in self.assumed_pods

    # --- expiry (cache.go:434-470; the 1s ticker becomes an explicit call) ---

    def cleanup_assumed_pods(self, now: Optional[float] = None) -> int:
        """Expire assumed pods whose binding finished and whose deadline
        passed; returns how many expired."""
        if now is None:
            now = self._now()
        expired = 0
        for key in list(self.assumed_pods):
            state = self.pod_states[key]
            if state.binding_finished and state.deadline is not None \
                    and now >= state.deadline:
                self._remove_from_node(state.pod)
                del self.pod_states[key]
                self.assumed_pods.discard(key)
                expired += 1
        return expired

    # --- node events (cache.go:308-345) ---

    def add_node(self, node: Node) -> None:
        self._info(node.name).set_node(node)

    def update_node(self, node: Node) -> None:
        self._info(node.name).set_node(node)

    def remove_node(self, node: Node) -> None:
        info = self.nodes.get(node.name)
        if info is None:
            return
        info.remove_node()
        if not info.pods:
            del self.nodes[node.name]

    # --- snapshot (cache.go:83-97) ---

    def update_node_name_to_info_map(self, info_map: Dict[str, NodeInfo]
                                     ) -> Dict[str, NodeInfo]:
        """Refresh `info_map` in place: clone only nodes whose generation
        moved, drop deleted nodes. Mutating the returned snapshot never
        touches the live cache."""
        for name, info in self.nodes.items():
            existing = info_map.get(name)
            if existing is None or existing.generation != info.generation:
                info_map[name] = info.clone()
        for name in list(info_map):
            if name not in self.nodes:
                del info_map[name]
        return info_map
