"""Distributed trace context: one causal id per request or cycle.

A ``TraceContext`` is the propagation unit of the tracing: a 16-hex
``trace_id`` naming the causal story (one serve request, one stream
cycle), a ``span_id`` naming the current hop, and ``parent_id`` linking
back to the hop that spawned it. Contexts cross

- **threads** by riding the object being handed over (the serve worker
  re-activates the context stashed on the ``WhatIfRequest``), and
- **processes** by riding wire frames: ``to_wire()`` stamps a frame and
  ``from_wire()`` rebuilds the context on the other side (the JAX
  package's WAL shipping does so; the port has no replication yet).

Design constraints (same contract as the flight recorder):

- **Zero-cost when disabled.**  ``start()`` returns ``None`` unless a
  flight recorder is installed — the scheduling hot paths hold one
  module-attribute ``None``-check and allocate nothing.
- **Deterministic under an injected id source.**  Ids default to a
  per-process random nonce + counter; tests install a counting source
  via ``set_id_source`` so trace goldens are byte-stable.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
from typing import Any, Callable, Dict, Optional

from tpusim_torch.obs import recorder as _flight


class TraceContext:
    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        """A new hop inside the same trace (this hop becomes the parent)."""
        return TraceContext(self.trace_id, _next_id(), self.span_id)

    def to_wire(self) -> Dict[str, str]:
        """The frame-field schema of a shipped frame: ``{"tid": ...,
        "sid": ...}`` (the JAX package's WAL ``rec``/``ckpt`` frames)."""
        return {"tid": self.trace_id, "sid": self.span_id}

    @classmethod
    def from_wire(cls, obj: Any) -> Optional["TraceContext"]:
        """Rebuild a remote context from a frame field; None on anything
        malformed — a follower must never die on a bad trace stamp."""
        if not isinstance(obj, dict):
            return None
        tid, sid = obj.get("tid"), obj.get("sid")
        if not (isinstance(tid, str) and isinstance(sid, str)):
            return None
        return cls(tid, sid)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, parent_id={self.parent_id!r})")


# -- id source -------------------------------------------------------------

_id_lock = threading.Lock()
_id_source: Optional[Callable[[], str]] = None
_default_counter = itertools.count(1)
_process_nonce = os.urandom(4).hex()


def _default_ids() -> str:
    # 16 hex chars: process nonce (8) + monotonic counter (8) — unique
    # across the fleet's processes without coordination
    return f"{_process_nonce}{next(_default_counter) & 0xFFFFFFFF:08x}"


def set_id_source(source: Optional[Callable[[], str]]) -> None:
    """Install a deterministic id generator (tests); None restores the
    process-nonce default."""
    global _id_source
    with _id_lock:
        _id_source = source


def _next_id() -> str:
    source = _id_source
    return source() if source is not None else _default_ids()


# -- the active context ----------------------------------------------------

_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("tpusim_trace_context", default=None)


def current() -> Optional[TraceContext]:
    return _current.get()


def start(parent: Optional[TraceContext] = None) -> Optional[TraceContext]:
    """A fresh root context (or a child hop of ``parent``) — but ONLY when
    tracing is armed (a flight recorder is installed); None otherwise so
    the disabled path allocates nothing."""
    if _flight.get_recorder() is None:
        return None
    if parent is not None:
        return parent.child()
    return TraceContext(_next_id(), _next_id())


def attach(ctx: Optional[TraceContext]) -> Optional[contextvars.Token]:
    """Make ``ctx`` the current context; returns the token for detach().
    None ctx is a no-op (the disabled path)."""
    if ctx is None:
        return None
    return _current.set(ctx)


def detach(token: Optional[contextvars.Token]) -> None:
    if token is not None:
        _current.reset(token)


class activate:
    """``with activate(ctx): ...`` — scoped attach/detach; ctx may be None
    (disabled path: pure no-op)."""

    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Optional[TraceContext]:
        self._token = attach(self.ctx)
        return self.ctx

    def __exit__(self, *exc: object) -> bool:
        detach(self._token)
        self._token = None
        return False
