"""In-memory resource store + LIFO pod queue.

Reference: pkg/framework/store/store.go — five keyed caches with per-resource
event handlers fired on Add/Update/Delete/Replace (:61-118,144-169), and the
PodQueue whose Pop takes the LAST element (:223-233) — the simulation feed is
LIFO, which is observable in placement order and therefore preserved.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from tpusim_torch.api.types import ResourceType

# event types (client-go watch.EventType)
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

EventHandler = Callable[[str, object], None]  # (event_type, object)


class ResourceStore:
    """Reference: store.go:32-46 (interface) / :179-201 (impl)."""

    RESOURCES = (ResourceType.PODS, ResourceType.NODES,
                 ResourceType.PERSISTENT_VOLUME_CLAIMS,
                 ResourceType.PERSISTENT_VOLUMES, ResourceType.SERVICES)

    def __init__(self):
        self._caches: Dict[ResourceType, Dict[str, object]] = {
            r: {} for r in self.RESOURCES}
        self._handlers: Dict[ResourceType, List[EventHandler]] = {
            r: [] for r in self.RESOURCES}

    def resources(self) -> List[ResourceType]:
        return list(self._caches.keys())

    def register_event_handler(self, resource: ResourceType,
                               handler: EventHandler) -> None:
        self._handlers[resource].append(handler)

    def unregister_event_handler(self, resource: ResourceType,
                                 handler: EventHandler) -> None:
        """Detach a handler (no client-go analog — informers live as long as
        their store — but per-client consumers like FakeRESTClient.close()
        need it to avoid leaking dead closures on a shared store)."""
        try:
            self._handlers[resource].remove(handler)
        except ValueError:
            pass

    def _emit(self, resource: ResourceType, event: str, obj) -> None:
        for handler in self._handlers[resource]:
            handler(event, obj)

    def add(self, resource: ResourceType, obj) -> None:
        self._caches[resource][obj.key()] = obj
        self._emit(resource, ADDED, obj)

    def update(self, resource: ResourceType, obj) -> None:
        self._caches[resource][obj.key()] = obj
        self._emit(resource, MODIFIED, obj)

    def delete(self, resource: ResourceType, obj) -> None:
        self._caches[resource].pop(obj.key(), None)
        self._emit(resource, DELETED, obj)

    def list(self, resource: ResourceType) -> list:
        return list(self._caches[resource].values())

    def get(self, resource: ResourceType, key: str):
        """Returns (object, exists) like cache.Store.Get."""
        obj = self._caches[resource].get(key)
        return obj, obj is not None

    def replace(self, resource: ResourceType, objects: list) -> None:
        """store.go:144-169 — swap contents, emitting Added for each."""
        self._caches[resource] = {o.key(): o for o in objects}
        for o in objects:
            self._emit(resource, ADDED, o)


class PodQueue:
    """LIFO pod feed. Reference: store.go:213-240 — Pop() returns the *last*
    element, so a podspec expands into reverse-order scheduling."""

    def __init__(self, pods: Optional[list] = None):
        self._pods: list = list(pods or [])

    def push(self, pod) -> None:
        self._pods.append(pod)

    def pop(self):
        if not self._pods:
            return None
        return self._pods.pop()

    def take_matching(self, pred) -> list:
        """Remove and return every queued pod satisfying `pred`, in pop
        (LIFO) order — the gang gather: when a group member pops, its mates
        are pulled forward so the group decides as one unit."""
        taken = [p for p in reversed(self._pods) if pred(p)]
        if taken:
            self._pods = [p for p in self._pods if not pred(p)]
        return taken

    def __len__(self) -> int:
        return len(self._pods)
