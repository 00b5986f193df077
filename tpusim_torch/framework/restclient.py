"""Fake apiserver REST surface over the ResourceStore.

Reference: pkg/framework/restclient/external/restclient.go — the client-go
RESTClient stand-in whose Do(req) parses URL paths (:428-555), serializes
store contents into list/get JSON bodies (:312-378), spins per-(resource,
fieldSelector) watch streams that replay current objects as Added
(:380-426), fans store events out to matching watchers
(EmitObjectWatchEvent, :218-236), and evaluates field selectors against
objects (ObjectFieldsAccessor, :47-90 — a text/template hack there; a plain
dotted-path lookup over the serialized object here).

Path grammar (relative to the API group root, restclient.go:436-469):

    /{resource}
    /{resource}/{name}
    /namespaces/{ns}/{resource}
    /namespaces/{ns}/{resource}/{name}
    /namespaces/{ns}/{resource}/{name}/status
    /watch/{resource}                      (+ ?fieldSelector=...)
    /watch/namespaces/{ns}/{resource}

The `Request` builder mirrors client-go's chaining (Namespace/Resource/Name/
FieldsSelectorParam/Do/Watch), so the request side of the contract — build a
URL, have the fake parse it back — is exercised exactly as in the reference's
restclient_test.go / watch_test.go.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from tpusim_torch.api.types import ResourceType
from tpusim_torch.framework.events import WatchBuffer, WatchExpiredError
from tpusim_torch.framework.store import ADDED, ResourceStore

# resources served by the "core" group client (restclient.go NewRESTClient
# registers the core kinds; storageclasses live in the storage group)
_CORE_RESOURCES = (ResourceType.PODS, ResourceType.NODES,
                   ResourceType.SERVICES, ResourceType.PERSISTENT_VOLUMES,
                   ResourceType.PERSISTENT_VOLUME_CLAIMS)


class ApiError(Exception):
    """An apiserver error body (metav1.Status)."""

    def __init__(self, code: int, reason: str, message: str):
        self.code = code
        self.reason = reason
        self.message = message
        super().__init__(message)

    def to_obj(self) -> dict:
        return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
                "reason": self.reason, "message": self.message,
                "code": self.code}


def _field_value(obj_dict: dict, dotted: str) -> str:
    """Dotted-path lookup over the serialized object; missing fields resolve
    to "" (the template hack in ObjectFieldsAccessor.Get does the same)."""
    cur = obj_dict
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return ""
        cur = cur[part]
    if cur is None:
        return ""
    return cur if isinstance(cur, str) else json.dumps(cur)


class FieldSelector:
    """metav1 field selector: comma-separated terms, `=`/`==` and `!=`."""

    def __init__(self, selector: str = ""):
        self.selector = selector or ""
        self.terms: List[Tuple[str, str, bool]] = []  # (path, value, negate)
        for term in filter(None, (t.strip() for t in self.selector.split(","))):
            if "!=" in term:
                path, value = term.split("!=", 1)
                self.terms.append((path.strip(), value.strip(), True))
            elif "==" in term:
                path, value = term.split("==", 1)
                self.terms.append((path.strip(), value.strip(), False))
            elif "=" in term:
                path, value = term.split("=", 1)
                self.terms.append((path.strip(), value.strip(), False))
            else:
                raise ApiError(400, "BadRequest",
                               f"invalid field selector term {term!r}")

    def matches_dict(self, obj_dict: dict) -> bool:
        for path, value, negate in self.terms:
            equal = _field_value(obj_dict, path) == value
            if equal == negate:
                return False
        return True

    def matches(self, obj) -> bool:
        if not self.terms:
            return True
        return self.matches_dict(obj.to_obj())


class Request:
    """client-go rest.Request chaining, minus the transport."""

    def __init__(self, client: "FakeRESTClient"):
        self._client = client
        self._namespace = ""
        self._resource = ""
        self._name = ""
        self._subresource = ""
        self._field_selector = ""

    def namespace(self, ns: str) -> "Request":
        self._namespace = ns
        return self

    def resource(self, resource: str) -> "Request":
        self._resource = resource
        return self

    def name(self, name: str) -> "Request":
        self._name = name
        return self

    def sub_resource(self, sub: str) -> "Request":
        self._subresource = sub
        return self

    def field_selector(self, selector: str) -> "Request":
        self._field_selector = selector
        return self

    def url(self, watch: bool = False) -> str:
        parts = []
        if watch:
            parts.append("watch")
        if self._namespace:
            parts.extend(["namespaces", self._namespace])
        parts.append(self._resource)
        if self._name:
            parts.append(self._name)
        if self._subresource:
            parts.append(self._subresource)
        return "/" + "/".join(parts)

    def do(self) -> dict:
        """GET list/get; returns the decoded JSON body (raises ApiError)."""
        return json.loads(self._client.handle(self.url(),
                                              self._field_selector))

    def watch(self) -> WatchBuffer:
        return self._client.handle_watch(self.url(watch=True),
                                         self._field_selector)


class FakeRESTClient:
    """restclient.go:557-570 NewRESTClient + the Do() dispatch."""

    def __init__(self, store: ResourceStore,
                 resources: tuple = _CORE_RESOURCES):
        self.store = store
        self.resources = {rt.value: rt for rt in resources}
        # (resource, namespace, selector) -> (parsed selector, shared buffer)
        # (restclient.go:380-426 keys watchers per resource+fieldSelector)
        self._watchers: Dict[Tuple[str, str, str],
                             Tuple[FieldSelector, WatchBuffer]] = {}
        # chaos seam (tpusim_torch.chaos.FabricInjector): classifies each
        # watcher-frame delivery as deliver/drop/dup/disconnect
        self.fault_injector = None
        self._handlers = []
        for rt in resources:
            handler = (lambda event, obj, rt=rt:
                       self.emit_object_watch_event(rt, event, obj))
            self._handlers.append((rt, handler))
            self.store.register_event_handler(rt, handler)

    # --- request builder entry (client-go Client.Get()) ---

    def get(self) -> Request:
        return Request(self)

    # --- the event fan-out (restclient.go:218-236) ---

    def emit_object_watch_event(self, resource: ResourceType, event: str,
                                obj) -> None:
        obj_dict = None  # serialized lazily, once per event
        for (res, ns, _), (selector, buf) in list(self._watchers.items()):
            if res != resource.value or buf.closed:
                continue
            if ns and getattr(obj, "namespace", "") != ns:
                continue
            if selector.terms:
                if obj_dict is None:
                    obj_dict = obj.to_obj()
                if not selector.matches_dict(obj_dict):
                    continue
            if self.fault_injector is not None:
                action = self.fault_injector.on_event(res, event)
                if action == "drop":
                    continue
                if action == "disconnect":
                    # transport error mid-stream: already-queued frames
                    # survive, this one is lost, and the consumer's next
                    # read past them raises — a reflector must relist
                    buf.close_with_error(WatchExpiredError(
                        f"chaos: watch stream disconnect on {res}"))
                    continue
                if action == "dup":
                    buf.emit(event, obj)
            buf.emit(event, obj)

    # --- the Do() dispatch (restclient.go:428-555) ---

    def _parse(self, path: str):
        """Returns (watch, namespace, ResourceType, name, subresource)."""
        segments = [s for s in path.split("/") if s]
        watch = False
        if segments and segments[0] == "watch":
            watch = True
            segments = segments[1:]
        namespace = ""
        if len(segments) >= 2 and segments[0] == "namespaces":
            namespace = segments[1]
            segments = segments[2:]
        if not segments:
            raise ApiError(400, "BadRequest", f"unsupported path {path!r}")
        resource, name, subresource = segments[0], "", ""
        if len(segments) > 1:
            name = segments[1]
        if len(segments) > 2:
            subresource = segments[2]
        if len(segments) > 3 or (subresource and subresource != "status"):
            raise ApiError(400, "BadRequest", f"unsupported path {path!r}")
        rt = self.resources.get(resource.lower())
        if rt is None:
            raise ApiError(404, "NotFound",
                           f"the server could not find the requested "
                           f"resource {resource!r}")
        return watch, namespace, rt, name, subresource

    def _list_objects(self, rt: ResourceType, namespace: str,
                      selector: FieldSelector) -> list:
        objs = self.store.list(rt)
        if namespace:
            objs = [o for o in objs
                    if getattr(o, "namespace", "") == namespace]
        return [o for o in objs if selector.matches(o)]

    def handle(self, path: str, field_selector: str = "") -> str:
        """GET dispatch: list or single-object JSON body (the reference's
        createListReadCloser/createGetReadCloser, restclient.go:312-378)."""
        watch, namespace, rt, name, _sub = self._parse(path)
        if watch:
            raise ApiError(400, "BadRequest",
                           "watch paths stream; use handle_watch")
        selector = FieldSelector(field_selector)
        if not name:
            items = self._list_objects(rt, namespace, selector)
            kind = rt.object_type().kind
            return json.dumps({"kind": f"{kind}List", "apiVersion": "v1",
                               "items": [o.to_obj() for o in items]},
                              sort_keys=True)
        key = f"{namespace}/{name}" if namespace else name
        obj, exists = self.store.get(rt, key)
        if not exists and not namespace:
            # cluster-scoped lookups of namespaced kinds fall back to a scan
            # (the reference's accessor matches on metadata.name)
            for o in self.store.list(rt):
                if getattr(o, "name", "") == name:
                    obj, exists = o, True
                    break
        if not exists:
            raise ApiError(404, "NotFound",
                           f'{rt.value} "{name}" not found')
        return json.dumps(obj.to_obj(), sort_keys=True)

    def handle_watch(self, path: str, field_selector: str = "") -> WatchBuffer:
        """Watch dispatch: replay current objects as ADDED on a shared
        per-(resource, namespace, selector) buffer, then stream store events
        (restclient.go:380-426)."""
        watch, namespace, rt, name, _sub = self._parse(path)
        if not watch or name:
            raise ApiError(400, "BadRequest",
                           f"unsupported watch path {path!r}")
        key = (rt.value, namespace, field_selector or "")
        entry = self._watchers.get(key)
        if entry is not None and not entry[1].closed:
            return entry[1]
        selector = FieldSelector(field_selector)
        buf = WatchBuffer(resource=rt.value)
        for obj in self._list_objects(rt, namespace, selector):
            buf.emit(ADDED, obj)
        self._watchers[key] = (selector, buf)
        return buf

    def close(self) -> None:
        for _, buf in self._watchers.values():
            buf.close()
        self._watchers.clear()
        # detach from the store so a shared ResourceStore doesn't keep dead
        # clients alive (and pay per-event fan-out to them)
        for rt, handler in self._handlers:
            self.store.unregister_event_handler(rt, handler)
        self._handlers = []


def decode_list(body: dict, rt: ResourceType) -> list:
    """Typed round-trip of a list body (the tests' compare-typed-lists step
    in restclient_test.go)."""
    cls = rt.object_type()
    return [cls.from_obj(item) for item in body.get("items", [])]
