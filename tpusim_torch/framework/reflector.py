"""Reflector: list+watch with relist-on-error, the client-go analogue.

The watch fabric can fail like the real one: a stream dies mid-flight (a
transport disconnect) or falls too far behind and gets the "410 Gone"
analog (framework/events.py WatchBuffer overflow). A bare watcher silently
diverges from the store at that point. The Reflector is the consumer that
provably reconverges: it mirrors the stream into a ``known`` map, and when
a read raises :class:`WatchExpiredError` (or the stream closes under it)
it RELISTS through the fake apiserver, diffs the authoritative list
against ``known`` into synthetic DELETED/ADDED/MODIFIED events, replays
those through its handler, and re-watches — exactly client-go's
Reflector.ListAndWatch recovery loop (reflector.go), minus the goroutine.

Single-threaded determinism: nothing mutates the store between the relist
and the re-watch, so the fresh stream's replay-as-ADDED prefix mirrors the
list just diffed and is discarded instead of re-applied.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from tpusim_torch.api.types import ResourceType
from tpusim_torch.framework.events import WatchBuffer, WatchExpiredError
from tpusim_torch.framework.restclient import FakeRESTClient, decode_list
from tpusim_torch.framework.store import ADDED, DELETED, MODIFIED
from tpusim_torch.obs import recorder as flight

EventHandler = Callable[[str, object], None]  # (event_type, object)


class Reflector:
    """Mirrors one (resource, namespace, fieldSelector) stream into
    ``known``, forwarding every event — live or synthesized by a relist —
    to ``handler``. Drive it with :meth:`sync` from the simulation loop."""

    def __init__(self, client: FakeRESTClient, resource: ResourceType,
                 handler: Optional[EventHandler] = None, namespace: str = "",
                 field_selector: str = "",
                 on_relist: Optional[Callable[[int], None]] = None):
        """on_relist: called with the relist ordinal after every recovery
        relist completes. The stream runtime (StreamSession.watch) hooks
        this to invalidate its device-resident state — a relist means the
        event stream lost frames, so the synthetic diff it replayed may not be
        O(delta)-expressible against the resident arrays."""
        self.client = client
        self.resource = resource
        self.handler = handler
        self.namespace = namespace
        self.field_selector = field_selector
        self.on_relist = on_relist
        self.known: Dict[str, object] = {}
        self.relists = 0
        self._buf: Optional[WatchBuffer] = None

    # -- plumbing ---------------------------------------------------------

    def _request(self):
        req = self.client.get().resource(self.resource.value)
        if self.namespace:
            req.namespace(self.namespace)
        if self.field_selector:
            req.field_selector(self.field_selector)
        return req

    def _apply(self, event_type: str, obj) -> None:
        key = obj.key()
        if event_type == DELETED:
            self.known.pop(key, None)
        else:
            self.known[key] = obj
        if self.handler is not None:
            self.handler(event_type, obj)

    # -- the recovery loop ------------------------------------------------

    def relist(self) -> int:
        """List the authoritative state, diff against ``known`` into
        synthetic events, then re-watch. Returns events applied."""
        self.relists += 1
        flight.instant("reflector:relist", "host",
                       {"resource": self.resource.value,
                        "relists": self.relists})
        current = {o.key(): o
                   for o in decode_list(self._request().do(), self.resource)}
        applied = 0
        for key, obj in list(self.known.items()):
            if key not in current:
                self._apply(DELETED, obj)
                applied += 1
        for key, obj in current.items():
            old = self.known.get(key)
            if old is None:
                self._apply(ADDED, obj)
                applied += 1
            elif old.to_obj() != obj.to_obj():
                self._apply(MODIFIED, obj)
                applied += 1
        self._buf = self._request().watch()
        # the fresh stream front-loads `current` as ADDED (restclient.go:
        # 380-426 replay); the diff above already synced to it — discard
        for _ in range(len(current)):
            try:
                if self._buf.read(timeout=0) is None:
                    break
            except WatchExpiredError:
                break
        if self.on_relist is not None:
            self.on_relist(self.relists)
        return applied

    def sync(self, max_relists: int = 8) -> int:
        """Drain every available frame into ``known``/``handler``; on a
        dead stream (error or plain close) relist and keep draining.
        Returns the number of events applied this call."""
        applied = 0
        relists = 0
        if self._buf is None:
            # initial ListAndWatch: the watch replay serves as the list
            self._buf = self._request().watch()
        while True:
            try:
                ev = self._buf.read(timeout=0)
            except WatchExpiredError:
                if relists >= max_relists:
                    return applied
                relists += 1
                applied += self.relist()
                continue
            if ev is None:
                if self._buf.closed and relists < max_relists:
                    relists += 1
                    applied += self.relist()
                    continue
                return applied
            self._apply(ev.type, ev.object)
            applied += 1
