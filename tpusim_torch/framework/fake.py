"""Closure-backed read-only store for tests.

Reference: pkg/framework/store/fake.go:30-97 — FakeResourceStore with
per-resource data closures and no-op mutations.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from tpusim_torch.api.types import ResourceType


class FakeResourceStore:
    def __init__(self,
                 pods_data: Optional[Callable[[], list]] = None,
                 nodes_data: Optional[Callable[[], list]] = None,
                 services_data: Optional[Callable[[], list]] = None,
                 pvc_data: Optional[Callable[[], list]] = None,
                 pv_data: Optional[Callable[[], list]] = None):
        self._data: Dict[ResourceType, Callable[[], list]] = {}
        if pods_data:
            self._data[ResourceType.PODS] = pods_data
        if nodes_data:
            self._data[ResourceType.NODES] = nodes_data
        if services_data:
            self._data[ResourceType.SERVICES] = services_data
        if pvc_data:
            self._data[ResourceType.PERSISTENT_VOLUME_CLAIMS] = pvc_data
        if pv_data:
            self._data[ResourceType.PERSISTENT_VOLUMES] = pv_data

    def resources(self):
        return list(self._data.keys())

    def list(self, resource: ResourceType) -> list:
        fn = self._data.get(resource)
        return list(fn()) if fn else []

    def get(self, resource: ResourceType, key: str):
        for obj in self.list(resource):
            if obj.key() == key:
                return obj, True
        return None, False

    # mutations are no-ops (fake.go:99-160)
    def add(self, resource, obj) -> None:
        pass

    def update(self, resource, obj) -> None:
        pass

    def delete(self, resource, obj) -> None:
        pass

    def register_event_handler(self, resource, handler) -> None:
        pass
