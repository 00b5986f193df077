"""Scheduling queues: FIFO and the priority queue.

Reference: core/scheduling_queue.go — `NewSchedulingQueue` returns a plain FIFO
unless pod priority is enabled, else the PriorityQueue with an active heap,
an unschedulable map, a nominated-pods index, and the receivedMoveRequest flag
(:49-340). The simulator runs one pod in flight so the queues are small, but
the semantics (ordering, unschedulable parking, nominated-index maintenance,
affinity-triggered moves) are preserved — pinned by the golden tables ported
from core/scheduling_queue_test.go (tests/test_queue_goldens.py).

Deviation from upstream: Pop() returns None on an empty queue instead of
blocking on a condition variable — the single-threaded simulator drives the
feed itself (simulator.py nextPod), so there is never a consumer to park.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional

from tpusim_torch.api.types import Pod
from tpusim_torch.engine.util import get_pod_priority


def nominated_node_name(pod: Pod) -> str:
    """scheduling_queue.go:143-145."""
    return pod.status.nominated_node_name


def is_pod_unschedulable(pod: Pod) -> bool:
    """scheduling_queue.go:268-271: carries PodScheduled=False with reason
    Unschedulable."""
    for cond in pod.status.conditions:
        if cond.type == "PodScheduled":
            return cond.status == "False" and cond.reason == "Unschedulable"
    return False


def _pod_uid(pod: Pod) -> str:
    """Nominated-index identity: upstream compares pod UIDs
    (scheduling_queue.go:190-216); fall back to the ns/name key for fixtures
    without UIDs."""
    return pod.metadata.uid or pod.key()


def is_pod_updated(old_pod: Optional[Pod], new_pod: Pod) -> bool:
    """scheduling_queue.go:321-331 isPodUpdated: strip status (and the
    versioning fields our model does not carry) and compare — an update that
    only touches status cannot have made the pod schedulable."""
    if old_pod is None:
        return True

    def strip(pod: Pod) -> dict:
        o = pod.to_obj()
        o.pop("status", None)
        meta = o.get("metadata") or {}
        meta.pop("resourceVersion", None)
        meta.pop("generation", None)
        return o

    return strip(old_pod) != strip(new_pod)


class SchedulingQueue:
    """Reference: scheduling_queue.go:49-61 (interface)."""

    def add(self, pod: Pod) -> None:
        raise NotImplementedError

    def has_nominated_pods(self) -> bool:
        """True when any parked pod carries a nominated node (those feed the
        feasibility double-pass of later pods, generic_scheduler.go:420-534)."""
        return False

    def add_if_not_present(self, pod: Pod) -> None:
        raise NotImplementedError

    def add_unschedulable_if_not_present(self, pod: Pod) -> None:
        raise NotImplementedError

    def pop(self) -> Optional[Pod]:
        raise NotImplementedError

    def update(self, old_pod: Optional[Pod], new_pod: Pod) -> None:
        raise NotImplementedError

    def delete(self, pod: Pod) -> None:
        raise NotImplementedError

    def assigned_pod_added(self, pod: Pod) -> None:
        raise NotImplementedError

    def assigned_pod_updated(self, pod: Pod) -> None:
        raise NotImplementedError

    def move_all_to_active_queue(self) -> None:
        raise NotImplementedError

    def waiting_pods_for_node(self, node_name: str) -> List[Pod]:
        raise NotImplementedError

    def clear_nominations_for_node(self, node_name: str) -> List[Pod]:
        """Drop every nomination pointing at `node_name` (the node left the
        cluster; a nomination on it is a promise that can't be kept) and
        return the affected pods so the caller can clear their status."""
        return []

    def take_matching(self, pred) -> List[Pod]:
        """Remove and return every queued pod satisfying `pred` — the gang
        gather on retry: a popped group member pulls its queued mates
        forward so the group re-decides as one unit. Implementations
        without queued state hold nothing to gather."""
        return []

    def clear_nominations_for_gangs(self, names) -> List[Pod]:
        """Drop every nomination held by a member of the named pod groups
        (the gang released — e.g. one member was preempted, so its mates'
        nominations are promises for a group that no longer stands) and
        return the affected pods."""
        return []


class FIFO(SchedulingQueue):
    """Reference: scheduling_queue.go:73-139 — wrapper over cache.FIFO."""

    def __init__(self):
        self._order: List[str] = []
        self._items: Dict[str, Pod] = {}

    def add(self, pod: Pod) -> None:
        key = pod.key()
        if key not in self._items:
            self._order.append(key)
        self._items[key] = pod

    def add_if_not_present(self, pod: Pod) -> None:
        if pod.key() not in self._items:
            self.add(pod)

    # FIFO treats unschedulable pods like any other (scheduling_queue.go:87-92)
    def add_unschedulable_if_not_present(self, pod: Pod) -> None:
        self.add_if_not_present(pod)

    def pop(self) -> Optional[Pod]:
        while self._order:
            key = self._order.pop(0)
            pod = self._items.pop(key, None)
            if pod is not None:
                return pod
        return None

    def update(self, old_pod: Optional[Pod], new_pod: Pod) -> None:
        self.add(new_pod)

    def delete(self, pod: Pod) -> None:
        self._items.pop(pod.key(), None)

    # FIFO ignores assigned-pod and move events (scheduling_queue.go:104-116)
    def assigned_pod_added(self, pod: Pod) -> None:
        pass

    def assigned_pod_updated(self, pod: Pod) -> None:
        pass

    def move_all_to_active_queue(self) -> None:
        pass

    def waiting_pods_for_node(self, node_name: str) -> List[Pod]:
        return []

    def take_matching(self, pred) -> List[Pod]:
        taken = [p for p in self._items.values() if pred(p)]
        for pod in taken:
            self.delete(pod)
        return taken

    def __len__(self) -> int:
        return len(self._items)


class PriorityQueue(SchedulingQueue):
    """Reference: scheduling_queue.go:147-460 — activeQ heap ordered by pod
    priority (ties FIFO by insertion), unschedulableQ parking lot, nominated
    pods index maintained across add/update/delete/pop, receivedMoveRequest,
    and affinity-triggered unschedulable->active moves."""

    def __init__(self):
        self._counter = itertools.count()
        self._active: List[tuple] = []  # (-priority, seq, key)
        self._active_items: Dict[str, Pod] = {}
        self._active_seq: Dict[str, int] = {}  # key -> live heap entry seq
        self._unschedulable: Dict[str, Pod] = {}
        self._nominated: Dict[str, List[Pod]] = {}  # node name -> pods
        self.received_move_request = False

    # --- nominated-pods index (scheduling_queue.go:188-226) ---

    def _add_nominated(self, pod: Pod) -> None:
        node = nominated_node_name(pod)
        if node:
            if any(_pod_uid(np) == _pod_uid(pod)
                   for np in self._nominated.get(node, ())):
                return  # adding an existing pod does not update it
            self._nominated.setdefault(node, []).append(pod)

    def _delete_nominated(self, pod: Pod) -> None:
        node = nominated_node_name(pod)
        if node and node in self._nominated:
            self._nominated[node] = [p for p in self._nominated[node]
                                     if _pod_uid(p) != _pod_uid(pod)]
            if not self._nominated[node]:
                del self._nominated[node]

    def _update_nominated(self, old_pod: Optional[Pod], new_pod: Pod) -> None:
        if old_pod is not None:
            self._delete_nominated(old_pod)
        self._add_nominated(new_pod)

    def has_nominated_pods(self) -> bool:
        return bool(self._nominated)

    # --- activeQ heap with lazy invalidation (cache.Heap Add/Update) ---

    def _heap_add(self, pod: Pod) -> None:
        key = pod.key()
        seq = next(self._counter)
        heapq.heappush(self._active, (-get_pod_priority(pod), seq, key))
        self._active_items[key] = pod
        self._active_seq[key] = seq

    # --- queue ops ---

    def add(self, pod: Pod) -> None:
        """scheduling_queue.go:228-246."""
        key = pod.key()
        self._heap_add(pod)
        if key in self._unschedulable:
            self._delete_nominated(pod)
            del self._unschedulable[key]
        self._add_nominated(pod)

    def add_if_not_present(self, pod: Pod) -> None:
        """scheduling_queue.go:248-266."""
        key = pod.key()
        if key in self._unschedulable or key in self._active_items:
            return
        self._heap_add(pod)
        self._add_nominated(pod)

    def add_unschedulable_if_not_present(self, pod: Pod) -> None:
        """scheduling_queue.go:273-293: park only when no move request
        arrived mid-flight AND the pod actually carries the Unschedulable
        condition; anything else goes (back) to the active queue."""
        key = pod.key()
        if key in self._unschedulable or key in self._active_items:
            return
        if not self.received_move_request and is_pod_unschedulable(pod):
            self._unschedulable[key] = pod
            self._add_nominated(pod)
            return
        self._heap_add(pod)
        self._add_nominated(pod)

    def pop(self) -> Optional[Pod]:
        """scheduling_queue.go:295-312 (non-blocking; see module docstring):
        removes the popped pod from the nominated index and clears
        receivedMoveRequest to mark a new scheduling cycle."""
        while self._active:
            _, seq, key = heapq.heappop(self._active)
            if self._active_seq.get(key) != seq:
                continue  # superseded by an update; skip the stale entry
            del self._active_seq[key]
            pod = self._active_items.pop(key)
            self._delete_nominated(pod)
            self.received_move_request = False
            return pod
        return None

    def update(self, old_pod: Optional[Pod], new_pod: Pod) -> None:
        """scheduling_queue.go:333-363."""
        key = new_pod.key()
        if key in self._active_items:
            self._update_nominated(old_pod, new_pod)
            self._heap_add(new_pod)  # re-push; stale entry skipped at pop
            return
        if key in self._unschedulable:
            self._update_nominated(old_pod, new_pod)
            if is_pod_updated(old_pod, new_pod):
                del self._unschedulable[key]
                self._heap_add(new_pod)
            else:
                self._unschedulable[key] = new_pod
            return
        self._heap_add(new_pod)
        self._add_nominated(new_pod)

    def delete(self, pod: Pod) -> None:
        """scheduling_queue.go:365-376."""
        key = pod.key()
        self._delete_nominated(pod)
        if key in self._active_items:
            del self._active_items[key]
            self._active_seq.pop(key, None)
        else:
            self._unschedulable.pop(key, None)

    # --- assigned-pod events (scheduling_queue.go:378-446) ---

    def assigned_pod_added(self, pod: Pod) -> None:
        self._move_pods_to_active_queue(
            self._unschedulable_pods_with_matching_affinity_term(pod))

    def assigned_pod_updated(self, pod: Pod) -> None:
        self._move_pods_to_active_queue(
            self._unschedulable_pods_with_matching_affinity_term(pod))

    def _move_pods_to_active_queue(self, pods: List[Pod]) -> None:
        for pod in pods:
            self._heap_add(pod)
            self._unschedulable.pop(pod.key(), None)
        self.received_move_request = True

    def _unschedulable_pods_with_matching_affinity_term(
            self, pod: Pod) -> List[Pod]:
        """getUnschedulablePodsWithMatchingAffinityTerm: parked pods with any
        REQUIRED pod-affinity term matching the newly assigned pod."""
        from tpusim_torch.engine.predicates import (
            get_namespaces_from_pod_affinity_term,
            get_pod_affinity_terms,
            pod_matches_term_namespace_and_selector,
        )

        to_move = []
        for up in self._unschedulable.values():
            affinity = up.spec.affinity
            if affinity is None or affinity.pod_affinity is None:
                continue
            for term in get_pod_affinity_terms(affinity.pod_affinity):
                namespaces = get_namespaces_from_pod_affinity_term(up, term)
                if pod_matches_term_namespace_and_selector(
                        pod, namespaces, term.label_selector):
                    to_move.append(up)
                    break
        return to_move

    def move_all_to_active_queue(self) -> None:
        """scheduling_queue.go:391-410 (pods keep their nominated entries)."""
        for pod in self._unschedulable.values():
            self._heap_add(pod)
        self._unschedulable.clear()
        self.received_move_request = True

    def waiting_pods_for_node(self, node_name: str) -> List[Pod]:
        return list(self._nominated.get(node_name, []))

    def clear_nominations_for_node(self, node_name: str) -> List[Pod]:
        cleared = self._nominated.pop(node_name, [])
        if cleared:
            # the parked pods lost their claim on the dead node; re-activate
            # them so they re-attempt against the surviving cluster
            self._move_pods_to_active_queue(
                [p for p in cleared if p.key() in self._unschedulable])
        return list(cleared)

    def take_matching(self, pred) -> List[Pod]:
        taken = [p for p in self._active_items.values() if pred(p)]
        taken += [p for p in self._unschedulable.values() if pred(p)]
        for pod in taken:
            self.delete(pod)
        return taken

    def clear_nominations_for_gangs(self, names) -> List[Pod]:
        from tpusim_torch.gang import gang_name

        names = set(names)
        cleared: List[Pod] = []
        for node in list(self._nominated):
            stale = [p for p in self._nominated[node]
                     if gang_name(p) in names]
            if not stale:
                continue
            remaining = [p for p in self._nominated[node]
                         if gang_name(p) not in names]
            if remaining:
                self._nominated[node] = remaining
            else:
                del self._nominated[node]
            cleared.extend(stale)
        if cleared:
            # released members re-attempt with the rest of their gang
            self._move_pods_to_active_queue(
                [p for p in cleared if p.key() in self._unschedulable])
        return cleared

    def __len__(self) -> int:
        return len(self._active_items) + len(self._unschedulable)


def new_scheduling_queue(pod_priority_enabled: bool) -> SchedulingQueue:
    """Reference: scheduling_queue.go:64-70."""
    return PriorityQueue() if pod_priority_enabled else FIFO()
