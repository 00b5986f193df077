"""Live telemetry plane: the in-process HTTP endpoint.

`serve --listen HOST:PORT` and `stream --listen HOST:PORT` start one of
these on a daemon thread next to the runtime:

- `GET /metrics`  — the metrics registry in Prometheus/OpenMetrics text
  exposition format, rendered under the registry-level read lock so one
  scrape is a consistent snapshot.
- `GET /healthz`  — JSON liveness: breaker state (HTTP 503 while the
  device-dispatch breaker is OPEN), WAL record count, checkpoint
  freshness, admission-queue depth, SLO burn rate.
- `GET /debug/provenance` — the ring of recent decision-provenance
  records (`?limit=N`, default 100), JSON.
- `GET /analytics` — the cluster analytics plane: the latest
  utilization/fragmentation sample reduced on the device, device
  residency, compile costs, plus a bounded time-series ring (`?limit=N`,
  default 60). `top` renders this body live.
- `GET /debug/trace` — the flight recorder's bounded event ring
  (`?limit=N`, default 100), newest events last, plus the per-category
  drop counters. Bounded exactly like the provenance ring: a
  deque(maxlen) with drops counted, never an unbounded buffer.

Stdlib-only (http.server): a scrape endpoint needs no HTTP framework. The
handler reads shared state only through the metrics registry, the
recorder, the provenance ring and the analytics plane; it holds no
reference to the runtime, so serve, stream and the tests wire it alike.

A handler runs on a thread of its own, never on the stream that produced
the state it reads, and must not stall the runtime: an analytics sample
reaches it in host memory behind the CUDA event recorded at its capture
(obs/analytics.py), which the decode waits on; no handler synchronizes the
device.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import analytics
from tpusim_torch.obs import provenance
from tpusim_torch.obs import recorder as flight

METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def health_payload() -> Tuple[int, dict]:
    """(http_status, body) for /healthz — 503 while the breaker is open."""
    reg = register()
    breaker = reg.breaker_state.value
    body = {
        "status": "breaker_open" if breaker >= 1.0 else "ok",
        "breaker_state": breaker,
        "wal_records": reg.recovery_wal_records.value,
        "queue_depth": reg.serve_queue_depth.value,
        "slo_burn_rate": reg.slo_burn_rate.value,
    }
    ckpt_ts = reg.recovery_last_checkpoint_timestamp.value
    body["checkpoint_age_s"] = (round(max(0.0, time.time() - ckpt_ts), 3)
                                if ckpt_ts else None)
    chain = reg.stream_chain_head
    if chain.value:
        body["chain_head"] = dict(chain.labels)
    # replication fields: role and lag, so a probe of either side of a
    # leader/follower pair describes itself. A sys.modules lookup, not an
    # import: a process that never replicated reports role "none" (the
    # port has no replication module yet, so every process does)
    import sys

    _replicate = sys.modules.get("tpusim_torch.stream.replicate")
    repl = (_replicate.get_status() if _replicate is not None
            else {"role": "none", "replication_lag_records": 0,
                  "last_shipped_seq": -1})
    body["role"] = repl.get("role", "none")
    body["replication_lag_records"] = repl.get("replication_lag_records", 0)
    body["last_shipped_seq"] = repl.get("last_shipped_seq", -1)
    return (503 if breaker >= 1.0 else 200), body


class _Handler(BaseHTTPRequestHandler):
    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        parsed = urlparse(self.path)
        if parsed.path == "/metrics":
            # fold the latest analytics sample + HBM sources into the
            # tpusim_cluster_*/tpusim_hbm_* gauges so every scrape is live
            analytics.refresh_gauges()
            text = register().expose()
            self._send(200, METRICS_CONTENT_TYPE, text.encode())
        elif parsed.path == "/healthz":
            status, body = health_payload()
            self._send(status, "application/json",
                       (json.dumps(body, sort_keys=True) + "\n").encode())
        elif parsed.path == "/debug/provenance":
            try:
                limit = int(parse_qs(parsed.query).get("limit", ["100"])[0])
            except ValueError:
                limit = 100
            log = provenance.get_log()
            records = log.tail(limit) if log is not None else []
            self._send(200, "application/json",
                       (json.dumps(records) + "\n").encode())
        elif parsed.path == "/debug/trace":
            try:
                limit = int(parse_qs(parsed.query).get("limit", ["100"])[0])
            except ValueError:
                limit = 100
            rec = flight.get_recorder()
            if rec is None:
                body = {"enabled": False, "events": [], "dropped": 0,
                        "dropped_by_category": {}}
            else:
                body = {"enabled": True, "events": rec.tail(limit),
                        "dropped": rec.dropped,
                        "dropped_by_category": dict(rec.dropped_by_category)}
            self._send(200, "application/json",
                       (json.dumps(body, sort_keys=True) + "\n").encode())
        elif parsed.path == "/analytics":
            try:
                limit = int(parse_qs(parsed.query).get("limit", ["60"])[0])
            except ValueError:
                limit = 60
            log = analytics.get()
            if log is None:
                body = {"enabled": False,
                        "hbm": analytics.hbm_snapshot(),
                        "compile": analytics.compile_snapshot()}
            else:
                analytics.refresh_gauges()
                body = log.snapshot()
                body["series"] = log.series(limit)
            self._send(200, "application/json",
                       (json.dumps(body, sort_keys=True) + "\n").encode())
        else:
            self._send(404, "text/plain; charset=utf-8", b"not found\n")

    def log_message(self, fmt: str, *args: object) -> None:
        # scrapes every few seconds would flood stderr; stay quiet
        pass


class ObsServer:
    """The telemetry endpoint on a daemon thread; `address` is the bound
    (host, port) — pass port 0 to let the OS pick (tests do)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ObsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="tpusim-obs", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def parse_listen(spec: str) -> Tuple[str, int]:
    """'HOST:PORT' | ':PORT' | 'PORT' -> (host, port) for --listen."""
    spec = spec.strip()
    if ":" in spec:
        host, _, port = spec.rpartition(":")
        return host or "127.0.0.1", int(port)
    return "127.0.0.1", int(spec)


def start_server(listen: str) -> ObsServer:
    host, port = parse_listen(listen)
    return ObsServer(host, port).start()
