"""WAL-shipping hot standby and chaos-driven leader failover.

The WAL (stream.persist) made one process recoverable; this module
replicates it. A leader's StreamPersistence has two seams (``on_append``,
``on_checkpoint``) that a ``WalShipper`` drains over a length-prefixed
socket protocol to a ``FollowerTwin``: a live standby that does not merely
store the records but decides every shipped cycle again through its OWN
scheduler (the replay discipline of recover_stream_session), so at any
instant it holds a warm host picture, a warm device twin and a placement
chain it checks byte for byte against the leader's emissions. Divergence
latches: a follower whose own decisions ever disagree with a shipped
emission refuses promotion.

Wire protocol (the JAX package's, frame for frame, so a leader of either
package ships to a follower of either): a 4-byte big-endian length prefix
and one JSON object.

    {"t":"hello","next":N,"chain":H}      follower -> shipper on connect:
                                          resume from sequence N
    {"t":"rec","seq":N,"rec":R,"ofs":B}   one WAL record; B = the byte
                                          offset AFTER it in the leader's
                                          journal (the follower's applied
                                          position, and the promotion
                                          replay's tail_wal resume point)
    {"t":"ckpt","seq":N,"meta":M}         a checkpoint manifest (without
                                          the snapshot): the chain
                                          cross-check's anchor, the shard
                                          layout and durability
    {"t":"ack","seq":N,"chain":H}         follower -> shipper: applied
                                          through N, chain head H
    {"t":"snap","seq":N,"meta":M,"open":B}  shipper -> follower, only when
                                          the hello carried
                                          ``"bootstrap": true`` with next=0
                                          (a late join): the FULL
                                          checkpoint manifest (snapshot
                                          included) and the admitted but
                                          unemitted batches below its WAL
                                          offset; the follower rebuilds
                                          from it and resumes at N+1

The shipper numbers frames in append order; acks are cumulative. A
reconnect resumes from the follower's hello: the shipper keeps its frame
log and resends from ``next``, so a flapping link degrades to lag, never
to loss.

Failover: a ``FailoverController`` watches the leader's ``/healthz`` (or
any probe) and, on its death, promotes the FRESHEST non-diverged follower.
Promotion replays only the unshipped tail of the leader's durable WAL
(``tail_wal`` from the follower's applied offset), deciding crash-tail
cycles again as a cold recovery does, but from a warm twin: the replayed
record count is the replication lag, not the checkpoint interval. The
promotion's invariant is the byte-identical chain head, checked against the
leader's last durable checkpoint manifest both ways.

Two faults of the JAX package's promotion are repaired here, both reached
when the follower lags the leader at its death: a cycle whose batch the
follower applied but whose bind it never received is decided again (the
JAX package abandons it, and the resumed driver journals it under the next
cycle id), and a crash-tail cycle whose bind record is already durable is
decided again without journaling that record a second time (the JAX
package appends a duplicate, which chaos.engine.audit_failover counts as a
lost pod).

Threads: the follower decides shipped cycles on its pump thread while the
leader decides its own on the caller's; both capture CUDA graphs, which
scan._Steps serializes process-wide. Every wait is bounded (``drain``,
``close``, ``stop``, ``FailoverController.run`` take timeouts). An error
while applying a record (a device error among them) stops the follower and
is kept in ``FollowerTwin.error``; promote raises it. The twin runs on
``device`` ("cuda" by default, or "cpu").
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
from dataclasses import dataclass, field
from time import monotonic, perf_counter, sleep
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpusim_torch.api.types import Pod
from tpusim_torch.backends import Placement, bind_pod, placement_hash
from tpusim_torch.engine.providers import DEFAULT_PROVIDER
from tpusim_torch.framework.metrics import register, since_in_microseconds
from tpusim_torch.framework.store import MODIFIED
from tpusim_torch.obs import recorder as flight
from tpusim_torch.obs import tracectx
from tpusim_torch.obs.recorder import flow_end, flow_start
from tpusim_torch.stream.persist import (
    _LOADERS,
    StreamPersistence,
    chain_fold,
    tail_wal,
)

log = logging.getLogger(__name__)

_FRAME_LIMIT = 64 << 20   # a single frame larger than this is corruption
_CKPT_FIELDS = ("cycle", "next_cycle", "chain", "wal_offset",
                "wal_records", "shard_layout", "durability", "plan_sig")


class ReplicationError(RuntimeError):
    """A broken replication stream (an oversized frame, protocol garbage)."""


class PromotionRefused(RuntimeError):
    """The candidate follower cannot become leader: its chain diverged from
    the leader's durable truth (or it never attached)."""


# -- the process's replication status (the /healthz seam) ------------------
#
# obs.server.health_payload reads it through sys.modules: role transitions
# and the shipper's live lag land here, so a scrape of either side of a
# pair describes itself. Process-wide: an in-process pair shares it, as it
# shares the metrics registry.

_state_lock = threading.Lock()
_state: Dict[str, object] = {"role": "none", "replication_lag_records": 0,
                             "last_shipped_seq": -1}


def set_role(role: str) -> None:
    """leader | follower | candidate | none."""
    with _state_lock:
        _state["role"] = role
    register().replication_role.set_info(role=role)


def _set_state(**kw) -> None:
    with _state_lock:
        _state.update(kw)


def get_status() -> Dict[str, object]:
    with _state_lock:
        return dict(_state)


# -- framing ---------------------------------------------------------------

def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _read_frame(reader) -> Optional[dict]:
    hdr = reader.read(4)
    if len(hdr) < 4:
        return None
    n = struct.unpack(">I", hdr)[0]
    if n > _FRAME_LIMIT:
        raise ReplicationError(f"replication frame of {n} bytes exceeds "
                               f"the {_FRAME_LIMIT}-byte limit")
    data = reader.read(n)
    if len(data) < n:
        return None
    return json.loads(data)


def _hang_up(sock: socket.socket, how: int = socket.SHUT_RDWR) -> None:
    """End a connection so the peer reads EOF now: a plain close leaves the
    descriptor open while a makefile reader of it lives (the other
    thread's), and that thread would block on it."""
    try:
        sock.shutdown(how)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# -- leader side -----------------------------------------------------------

class WalShipper:
    """Streams a StreamPersistence's WAL records to one follower.

    Hooks ``persist.on_append`` and ``persist.on_checkpoint``: every durable
    record is framed with a sequence number and enqueued on the scheduling
    thread (the crash model stays exact: the record that kills the leader
    is enqueued before the crash fires); a sender thread drains the queue
    to the follower and an ack reader advances the cumulative acked
    sequence. The frame log is kept for reconnect-with-resume. ``drain()``
    blocks until the follower has acked everything (or its timeout): the
    barrier of the tests and the graceful shutdown; a crashing leader never
    drains."""

    def __init__(self, persist: StreamPersistence,
                 address: Tuple[str, int], *,
                 retry_interval: float = 0.02):
        self.persist = persist
        self.address = address
        self.retry_interval = retry_interval
        self._frames: List[dict] = []        # seq == index
        self._meta: List[Tuple[float, int, bool]] = []  # (t_enq, ofs, is_rec)
        self._cond = threading.Condition()
        self._acked = -1
        self._acked_ofs = 0
        self._acked_chain = ""
        self._end_ofs = 0
        self._recs = 0
        self._recs_acked = 0
        self._stop = False
        persist.on_append = self._on_append
        persist.on_checkpoint = self._on_checkpoint
        set_role("leader")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpusim-wal-shipper")
        self._thread.start()

    # persistence hooks: called on the scheduling thread, never block

    def _on_append(self, rec: dict, kind: str, cycle: int,
                   start: int, end: int) -> None:
        # the hooks fire on the scheduling thread, so the active trace
        # context is the originating cycle's: the frame carries it across
        # the socket and the follower's replay spans join the leader's
        # trace. The flow start is emitted once an enqueue, not a send: a
        # resend after a reconnect must not duplicate it
        ctx = tracectx.current()
        with self._cond:
            seq = len(self._frames)
            fr = {"t": "rec", "seq": seq, "rec": rec, "ofs": end}
            if ctx is not None:
                fr["tr"] = ctx.to_wire()
            self._frames.append(fr)
            self._meta.append((perf_counter(), end, True))
            self._end_ofs = end
            self._recs += 1
            self._cond.notify_all()
        if ctx is not None:
            flow_start("wal:ship", str(seq), cat="wal", site="wal")
        self._publish_lag()

    def _on_checkpoint(self, meta: dict) -> None:
        slim = {k: meta.get(k) for k in _CKPT_FIELDS}
        ctx = tracectx.current()
        with self._cond:
            seq = len(self._frames)
            fr = {"t": "ckpt", "seq": seq, "meta": slim}
            if ctx is not None:
                fr["tr"] = ctx.to_wire()
            self._frames.append(fr)
            self._meta.append((perf_counter(), int(meta.get("wal_offset", 0)),
                               False))
            self._cond.notify_all()
        if ctx is not None:
            flow_start("wal:ship", str(seq), cat="wal", site="wal")
        self._publish_lag()

    def _publish_lag(self) -> None:
        reg = register()
        with self._cond:
            lag_records = self._recs - self._recs_acked
            lag_bytes = max(0, self._end_ofs - self._acked_ofs)
            oldest = (self._meta[self._acked + 1][0]
                      if self._acked + 1 < len(self._meta) else None)
        reg.replication_lag_records.set(float(lag_records))
        reg.replication_lag_bytes.set(float(lag_bytes))
        reg.replication_lag_seconds.set(
            max(0.0, perf_counter() - oldest) if oldest is not None else 0.0)
        _set_state(replication_lag_records=lag_records)

    # sender and ack machinery

    def _connect(self) -> Optional[socket.socket]:
        while True:
            with self._cond:
                if self._stop:
                    return None
            try:
                return socket.create_connection(self.address, timeout=5.0)
            except OSError:
                with self._cond:
                    self._cond.wait(self.retry_interval)

    def _run(self) -> None:
        while True:
            sock = self._connect()
            if sock is None:
                return
            try:
                reader = sock.makefile("rb")
                hello = _read_frame(reader)
                if hello is None or hello.get("t") != "hello":
                    continue
                cursor = int(hello.get("next", 0))
                rec_ = flight.get_recorder()
                if rec_ is not None and "clk" in hello:
                    # the clock-alignment handshake: the follower's
                    # recorder-relative reading at the hello's send, paired
                    # with ours at its receipt
                    rec_.set_anchor("peer_clk_us", float(hello["clk"]))
                    rec_.set_anchor("peer_clk_rx_us")
                if hello.get("bootstrap") and cursor == 0:
                    snap_fr, cursor = self._bootstrap_frame()
                    if snap_fr is not None:
                        _send_frame(sock, snap_fr)
                # a connected socket reads without a timeout: the ack reader
                # waits on the follower for as long as the link lives
                sock.settimeout(None)
                ack_thread = threading.Thread(
                    target=self._ack_loop, args=(reader,), daemon=True,
                    name="tpusim-wal-acks")
                ack_thread.start()
                while True:
                    with self._cond:
                        while cursor >= len(self._frames) and not self._stop:
                            self._cond.wait(0.1)
                        if self._stop:
                            return
                        batch = self._frames[cursor:]
                    for fr in batch:
                        _send_frame(sock, fr)
                        cursor = fr["seq"] + 1
                        register().replication_last_shipped_seq.set(
                            float(fr["seq"]))
                        _set_state(last_shipped_seq=fr["seq"])
            except (OSError, ReplicationError, ValueError):
                continue   # reconnect; the follower's hello resumes us
            finally:
                # the write side only: the follower reads every frame sent
                # before the EOF, and the ack reader drains its acks until
                # the follower hangs up (closing on unread acks would reset
                # the link under frames the follower has not read)
                _hang_up(sock, socket.SHUT_WR)

    def _bootstrap_frame(self) -> Tuple[Optional[dict], int]:
        """The snapshot bootstrap of a late-joining follower.

        A follower that was not up at the leader's start has no cycle-0
        snapshot to replay from, and the frame log goes back only to the
        shipper's attach. Instead of history, ship the leader's latest
        durable checkpoint manifest (it carries the whole host snapshot)
        and the WAL offset it is consistent with: the follower rebuilds a
        warm session from the manifest and resumes the live stream at the
        first frame PAST that offset. Admitted but unemitted batches below
        the cut (a pipelined cycle in flight) ride along, so the later bind
        and emit records find their arrivals. Assumes the shipper was
        attached before any record landed past the manifest's offset: true
        where attach() cuts the genesis checkpoint right after the shipper
        is built."""
        try:
            with open(self.persist.checkpoint_path, "r",
                      encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None, 0
        wal_ofs = int(manifest.get("wal_offset", 0))
        with self._cond:
            frames = list(self._frames)
            meta = list(self._meta)
        cursor = len(frames)
        for i, (_t_enq, ofs, is_rec) in enumerate(meta):
            if is_rec and ofs > wal_ofs:
                cursor = i
                break
        emitted = {int(fr["rec"]["c"]) for fr in frames[:cursor]
                   if fr["t"] == "rec" and fr["rec"]["k"] == "emit"}
        open_batches = [[int(fr["rec"]["c"]), fr["rec"]["pods"]]
                        for fr in frames[:cursor]
                        if fr["t"] == "rec" and fr["rec"]["k"] == "batch"
                        and int(fr["rec"]["c"]) not in emitted]
        return ({"t": "snap", "seq": cursor - 1, "meta": manifest,
                 "open": open_batches}, cursor)

    def _ack_loop(self, reader) -> None:
        try:
            while True:
                fr = _read_frame(reader)
                if fr is None:
                    return
                if fr.get("t") != "ack":
                    continue
                seq = int(fr["seq"])
                with self._cond:
                    if seq > self._acked:
                        for s in range(self._acked + 1, seq + 1):
                            t_enq, ofs, is_rec = self._meta[s]
                            if is_rec:
                                self._recs_acked += 1
                                register().replication_ship_latency.observe(
                                    since_in_microseconds(t_enq))
                        self._acked = seq
                        self._acked_ofs = self._meta[seq][1]
                    self._acked_chain = str(fr.get("chain", ""))
                    self._cond.notify_all()
                self._publish_lag()
        except (OSError, ValueError, ReplicationError):
            return

    # public surface

    @property
    def acked_seq(self) -> int:
        with self._cond:
            return self._acked

    @property
    def acked_chain(self) -> str:
        with self._cond:
            return self._acked_chain

    def enqueued(self) -> int:
        """Frames enqueued so far (the next frame's sequence number)."""
        with self._cond:
            return len(self._frames)

    def lag_records(self) -> int:
        with self._cond:
            return self._recs - self._recs_acked

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every enqueued frame is acked (or the timeout)."""
        deadline = monotonic() + timeout
        with self._cond:
            while self._acked < len(self._frames) - 1:
                remaining = deadline - monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(0.1, remaining))
        self._publish_lag()
        return True

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> bool:
        """Detach from the persistence and stop the sender. drain=False
        models the leader's death: what the wire has not carried stays
        unshipped, and only the durable WAL knows the tail."""
        drained = self.drain(timeout) if drain else False
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self.persist.on_append == self._on_append:
            self.persist.on_append = None
        if self.persist.on_checkpoint == self._on_checkpoint:
            self.persist.on_checkpoint = None
        self._thread.join(timeout=5.0)
        return drained


# -- follower side ---------------------------------------------------------

@dataclass
class PromotionReport:
    """What a promotion replayed, and what it cost."""

    resume_cycle: int = 0         # the first cycle the driver runs after
    tail_records: int = 0         # WAL records replayed past applied_ofs
    applied_records: int = 0      # records the follower had applied live
    recomputed: List[int] = field(default_factory=list)
    settled_live: List[int] = field(default_factory=list)
    chain: str = ""
    wal_records: int = 0
    replay_s: float = 0.0
    rto_s: float = 0.0            # stamped by the FailoverController
    violations: List[str] = field(default_factory=list)


class FollowerTwin:
    """A live standby: applies shipped WAL records by deciding each cycle
    again through its own StreamSession.

    The apply discipline (the WAL's ordering invariants make it exact for
    the synchronous and the pipelined driver):

      ev(c)    -> apply to the host picture at once (a cycle's ev records
                  precede its batch, and never interleave into an open
                  cycle)
      batch(c) -> buffer the arrivals
      bind(c)  -> the leader folded cycle c: schedule batch c through OUR
                  scheduler now (bind(c) precedes every cycle c+1 record,
                  so the host pictures align), fold our own binds, keep our
                  placements
      emit(c)  -> check our placement hash against the shipped one; fold
                  the chain; a divergence latches promotion off
      ckpt     -> the chain history's cross-check

    The twin stays one warm scheduler, not a cold journal: promotion
    replays only the unshipped tail."""

    def __init__(self, snapshot=None, *, incremental=None,
                 provider: str = DEFAULT_PROVIDER, policy=None,
                 always_restage: bool = False,
                 listen: Tuple[str, int] = ("127.0.0.1", 0),
                 bootstrap: bool = False, device="cuda"):
        from tpusim_torch.stream.runtime import StreamSession

        self._provider = provider
        self._policy = policy
        self._always_restage = always_restage
        self._device = device
        # a late join asks the shipper for the leader's latest checkpoint
        # manifest and WAL offset in the hello exchange instead of needing
        # the leader's cycle-0 snapshot; the session below starts empty and
        # is rebuilt from the shipped manifest
        self._bootstrap = bootstrap
        self.bootstrapped = False
        self.session = StreamSession(snapshot, incremental=incremental,
                                     provider=provider, policy=policy,
                                     always_restage=always_restage,
                                     device=device)
        self.batches: Dict[int, List[Pod]] = {}
        self.bound_by_cycle: Dict[int, List[Tuple[str, str]]] = {}
        self.events_applied: Dict[int, int] = {}
        self.chain = ""
        self.chain_history: Dict[int, str] = {0: ""}
        self.cycles_emitted = 0
        self.decisions = 0
        self.scheduled = 0
        self.next_cycle = 0
        self.applied_seq = -1
        self.applied_ofs = 0
        self.wal_records_applied = 0
        self.diverged: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.shard_layout: Optional[dict] = None
        self.durability: Optional[dict] = None
        self.promoted = False
        self.persist: Optional[StreamPersistence] = None
        self._emitted: set = set()    # cycle ids whose emit we applied
        self._live_pending: Dict[int, List[Placement]] = {}
        self._lock = threading.RLock()
        self._stop = False
        self._conn: Optional[socket.socket] = None
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(listen)
        self._server.listen(1)
        self._server.settimeout(0.2)
        self.address = self._server.getsockname()
        set_role("follower")
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="tpusim-follower")
        self._thread.start()

    # -- receive loop -----------------------------------------------------

    def _serve(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            with self._lock:
                if self._stop:
                    _hang_up(conn)
                    return
                self._conn = conn
            try:
                self._pump(conn)
            except (OSError, ValueError, ReplicationError):
                continue   # the shipper reconnects and resumes
            except Exception as exc:
                # an apply that failed (a device error among them): the
                # twin's state is unknown, so it stops taking records, and
                # promote() and run_replicated_stream raise this
                log.exception("follower twin: applying a shipped frame "
                              "failed; the twin stops")
                with self._lock:
                    self.error = exc
                    self._stop = True
                _hang_up(self._server)
                return
            finally:
                with self._lock:
                    self._conn = None
                _hang_up(conn)

    def _pump(self, conn: socket.socket) -> None:
        reader = conn.makefile("rb")
        with self._lock:
            hello = {"t": "hello", "next": self.applied_seq + 1,
                     "chain": self.chain}
            rec_ = flight.get_recorder()
            if rec_ is not None:
                # the clock-alignment handshake: our recorder-relative
                # reading at the hello's send; the shipper pins it and its
                # own receipt as anchors
                hello["clk"] = rec_.now_us()
                rec_.set_anchor("hello_tx_us", hello["clk"])
            if self._bootstrap and self.applied_seq < 0:
                hello["bootstrap"] = True
            _send_frame(conn, hello)
        while True:
            fr = _read_frame(reader)
            if fr is None:
                return
            t0 = perf_counter()
            if fr.get("t") == "snap":
                with self._lock:
                    if self._stop:
                        return
                    self._apply_bootstrap(fr)
                    seq, chain = self.applied_seq, self.chain
                if seq >= 0:
                    _send_frame(conn, {"t": "ack", "seq": seq,
                                       "chain": chain})
                continue
            seq = int(fr.get("seq", -1))
            ctx = tracectx.TraceContext.from_wire(fr.get("tr"))
            with self._lock:
                if self._stop:
                    return
                if seq <= self.applied_seq:
                    continue   # a duplicate after a resume race
                if seq != self.applied_seq + 1:
                    return     # a gap: drop; the next hello renegotiates
                # replay under the LEADER's trace context: the apply span,
                # and every scheduler span the replayed cycle records under
                # it, carries the originating cycle's trace id, and the flow
                # end closes the leader's arrow (the guards above already
                # dropped a resend, so no seq gets a second end)
                with tracectx.activate(ctx), \
                        flight.span("replicate:apply") as asp:
                    if asp:
                        asp.set("seq", seq)
                        asp.set("frame", str(fr.get("t")))
                    if ctx is not None:
                        flow_end("wal:ship", str(seq), cat="wal")
                    if fr.get("t") == "rec":
                        self._apply_record(fr["rec"], int(fr.get("ofs", 0)))
                    elif fr.get("t") == "ckpt":
                        self._apply_ckpt(fr.get("meta") or {})
                self.applied_seq = seq
                chain = self.chain
            register().replication_apply_latency.observe(
                since_in_microseconds(t0))
            _send_frame(conn, {"t": "ack", "seq": seq, "chain": chain})

    def _apply_bootstrap(self, fr: dict) -> None:
        """A late join: rebuild the twin from the shipped checkpoint
        manifest instead of a cycle-0 snapshot, then resume the live stream
        at the first frame past the manifest's WAL offset."""
        if not self._bootstrap or self.applied_seq >= 0:
            return   # an unsolicited or duplicate snap frame
        from tpusim_torch.api.snapshot import ClusterSnapshot
        from tpusim_torch.stream.runtime import StreamSession

        meta = fr.get("meta") or {}
        snapshot = ClusterSnapshot.from_obj(meta["snapshot"])
        self.session = StreamSession(snapshot, provider=self._provider,
                                     policy=self._policy,
                                     always_restage=self._always_restage,
                                     device=self._device)
        self.chain = str(meta.get("chain", ""))
        ck_cycle = int(meta.get("cycle", 0))
        self.cycles_emitted = ck_cycle
        self.chain_history = {0: "", ck_cycle: self.chain}
        self.decisions = int(meta.get("decisions", 0))
        self.scheduled = int(meta.get("scheduled", 0))
        self.next_cycle = int(meta.get("next_cycle", 0))
        self.shard_layout = meta.get("shard_layout") or self.shard_layout
        self.durability = meta.get("durability") or self.durability
        self.applied_ofs = int(meta.get("wal_offset", 0))
        self.wal_records_applied = int(meta.get("wal_records", 0))
        self.applied_seq = int(fr.get("seq", -1))
        self.batches = {int(c): [Pod.from_obj(o) for o in pods]
                        for c, pods in (fr.get("open") or [])}
        for c in self.batches:
            self.next_cycle = max(self.next_cycle, c + 1)
        self.bound_by_cycle = {}
        self._live_pending = {}
        self._emitted = set()
        self.bootstrapped = True
        flight.note_route("follower_bootstrap", len(self.batches))

    # -- read replica ------------------------------------------------------

    def overlay_query(self, pods) -> Optional[List[Placement]]:
        """Answer a live what-if on the standby's warm twin: an overlay
        leaves the carry as it found it (mark -> scan -> roll back), so a
        non-diverged follower answers without disturbing its replay. It
        runs under the twin's lock, between applies, on the caller's
        thread; None when the replica cannot answer (diverged, stopped, or
        the overlay itself refused)."""
        with self._lock:
            if self._stop or self.diverged is not None:
                register().overlay_fallback.inc("replica_unavailable")
                return None
            return self.session.overlay_query(pods, _path="follower")

    def _diverge(self, msg: str) -> None:
        if self.diverged is None:
            self.diverged = msg
            register().replication_divergence.inc()
            flight.note_fault("replication_divergence", {"detail": msg})

    def _apply_record(self, rec: dict, end_ofs: int) -> None:
        self.wal_records_applied += 1
        self.applied_ofs = max(self.applied_ofs, end_ofs)
        if self.diverged is not None:
            return   # latched: keep acking so the leader is not wedged,
            #          but the twin stops changing (it can never promote)
        k, c = rec["k"], int(rec["c"])
        if k == "ev":
            self.session.apply(rec["t"], _LOADERS[rec["r"]](rec["o"]))
            self.events_applied[c] = self.events_applied.get(c, 0) + 1
        elif k == "batch":
            self.batches[c] = [Pod.from_obj(o) for o in rec["pods"]]
            self.next_cycle = max(self.next_cycle, c + 1)
        elif k == "bind":
            pods = self.batches.get(c)
            if pods is None:
                self._diverge(f"bind record for unknown batch {c}")
                return
            placements = self.session.schedule(pods)
            bound = sorted((pl.pod.key(), pl.node_name)
                           for pl in placements if pl.node_name)
            theirs = sorted((key, node) for key, node in rec["b"])
            if bound != theirs:
                self._diverge(
                    f"bind divergence at cycle {c}: our scheduler bound "
                    f"{len(bound)} pods, the leader bound {len(theirs)} "
                    "(or to different nodes)")
                return
            self.bound_by_cycle[c] = list(bound)
            self._live_pending[c] = placements
        elif k == "emit":
            placements = self._live_pending.pop(c, None)
            if placements is None:
                self._diverge(f"emit record for cycle {c} the follower "
                              "never replayed")
                return
            mine = placement_hash(placements)
            if mine != rec["h"]:
                self._diverge(
                    f"placement hash diverges at cycle {c}: follower "
                    f"{mine[:16]} vs leader {rec['h'][:16]}")
                return
            self.chain = chain_fold(self.chain, rec["h"])
            self.decisions += int(rec["n"])
            self.scheduled += int(rec["s"])
            self.cycles_emitted += 1
            self.chain_history[self.cycles_emitted] = self.chain
            self._emitted.add(c)

    def _apply_ckpt(self, meta: dict) -> None:
        if self.diverged is not None:
            return
        # the port's twin is single-device: a leader's announced node-mesh
        # layout is recorded, and never restages it
        self.shard_layout = meta.get("shard_layout") or self.shard_layout
        self.durability = meta.get("durability") or self.durability
        ck_cycle = meta.get("cycle")
        ck_chain = meta.get("chain")
        if ck_cycle is not None and ck_chain is not None:
            mine = self.chain_history.get(int(ck_cycle))
            if mine is not None and mine != ck_chain:
                self._diverge(
                    f"checkpoint chain diverges at cycle {ck_cycle}: "
                    f"follower {mine[:16]} vs manifest {ck_chain[:16]}")

    # -- promotion --------------------------------------------------------

    def promote(self, directory: str, *, checkpoint_every: int = 0,
                fsync_every: int = 0) -> PromotionReport:
        """Become leader: replay the unshipped tail of the durable WAL in
        ``directory`` from our applied byte offset, deciding crash-tail
        cycles again, then attach the journal and keep appending.

        The byte-identical chain head is the invariant: a diverged follower
        refuses, and the replayed fold must agree with the leader's last
        durable checkpoint manifest."""
        with self._lock:
            if self.error is not None:
                raise RuntimeError(
                    f"the follower twin failed applying a record: "
                    f"{self.error}") from self.error
            if self.diverged is not None:
                raise PromotionRefused(
                    f"follower chain diverged; refusing promotion: "
                    f"{self.diverged}")
            if self.promoted:
                raise PromotionRefused("already promoted")
            report = self._promote_locked(directory, checkpoint_every,
                                          fsync_every)
            # no frame lands on the promoted twin: the pump checks this
            # under the lock before every apply
            self._stop = True
        self.stop(keep_session=True)
        return report

    def _promote_locked(self, directory: str, checkpoint_every: int,
                        fsync_every: int) -> PromotionReport:
        set_role("candidate")
        t0 = perf_counter()
        report = PromotionReport(applied_records=self.wal_records_applied)
        wal_path = os.path.join(directory, StreamPersistence.WAL)
        ck_path = os.path.join(directory, StreamPersistence.CHECKPOINT)
        if not os.path.exists(wal_path):
            set_role("follower")
            raise PromotionRefused(
                f"no durable WAL at {wal_path}: nothing to promote "
                "from (is the shared durability directory mounted?)")
        records, torn, _end = tail_wal(wal_path, self.applied_ofs)
        report.tail_records = len(records)
        report.violations.extend(torn)
        ck_cycle = ck_chain = None
        if os.path.exists(ck_path):
            with open(ck_path, "r", encoding="utf-8") as f:
                ck = json.load(f)
            ck_cycle, ck_chain = int(ck["cycle"]), ck["chain"]
            mine = self.chain_history.get(ck_cycle)
            if mine is not None and mine != ck_chain:
                set_role("follower")
                raise PromotionRefused(
                    f"chain head mismatch vs the leader's durable "
                    f"checkpoint at cycle {ck_cycle}: follower "
                    f"{mine[:16]} vs manifest {ck_chain[:16]}")

        # the tail's prepass: batches, the cycles that reached emit, and
        # the bind records the dead leader made durable
        emitted_tail = set()
        tail_batches = set()
        durable_binds: Dict[int, list] = {}
        for _, rec in records:
            c = int(rec["c"])
            if rec["k"] == "batch":
                self.batches[c] = [Pod.from_obj(o) for o in rec["pods"]]
                self.next_cycle = max(self.next_cycle, c + 1)
                tail_batches.add(c)
            elif rec["k"] == "emit":
                emitted_tail.add(c)
            elif rec["k"] == "bind":
                durable_binds[c] = rec["b"]

        persist = StreamPersistence(directory, checkpoint_every=0,
                                    fsync_every=fsync_every)
        persist.next_cycle = self.next_cycle
        persist.cycles_emitted = self.cycles_emitted
        persist.chain = self.chain
        persist.decisions = self.decisions
        persist.scheduled = self.scheduled
        persist.wal_records = self.wal_records_applied + len(records)
        persist.attach(self.session)

        # cycles to decide again, in cycle order. A batch applied live whose
        # bind never reached us (the link died between the two records) is
        # open from the start: its cycle is neither live-folded nor a tail
        # batch (the JAX package's promotion starts this list empty, and so
        # abandons such a cycle)
        pending: List[int] = sorted(
            c for c in self.batches
            if c not in self._emitted and c not in self._live_pending
            and c not in emitted_tail and c not in tail_batches)

        def recompute(cid: int) -> None:
            persist.queue_resume(cid)
            if cid in durable_binds:
                # the dead leader's bind record is durable: decide the cycle
                # again without journaling it a second time
                persist.adopt_bind(cid, durable_binds[cid])
            with flight.span("promote:recompute") as sp:
                if sp:
                    sp.set("cycle", cid)
                placements = self.session.schedule(self.batches[cid])
            report.recomputed.append(cid)
            self.bound_by_cycle[cid] = [
                (pl.pod.key(), pl.node_name)
                for pl in placements if pl.node_name]

        def flush_below(cycle: int) -> None:
            while pending and pending[0] < cycle:
                recompute(pending.pop(0))

        def fold_emit(rec: dict) -> None:
            persist.chain = chain_fold(persist.chain, rec["h"])
            persist.decisions += int(rec["n"])
            persist.scheduled += int(rec["s"])
            persist.cycles_emitted += 1
            if ck_cycle is not None \
                    and persist.cycles_emitted == ck_cycle \
                    and persist.chain != ck_chain:
                report.violations.append(
                    f"tail-replay chain missed the durable manifest "
                    f"at cycle {ck_cycle}")

        inc = self.session.inc
        rsp = flight.span("replicate:promote")
        # one trace context for the whole promotion: the tail replay, the
        # cycles decided again and the settle pass share one trace id
        with tracectx.activate(tracectx.start()), rsp, \
                persist.suppress_events():
            tsp = flight.span("promote:tail_replay")
            if tsp:
                tsp.set("records", len(records))
            for _ofs, rec in records:
                k, c = rec["k"], int(rec["c"])
                if k == "ev":
                    flush_below(c)
                    inc.apply(rec["t"], _LOADERS[rec["r"]](rec["o"]))
                    self.events_applied[c] = \
                        self.events_applied.get(c, 0) + 1
                elif k == "batch":
                    if c not in emitted_tail:
                        pending.append(c)
                elif k == "bind":
                    if c in self._live_pending or c not in emitted_tail:
                        continue   # live-folded already, or the crash
                        #            tail decides it again instead
                    flush_below(c)
                    pods_by_key = {p.key(): p
                                   for p in self.batches.get(c, [])}
                    for key, node in rec["b"]:
                        pod = pods_by_key.get(key)
                        if pod is None:
                            report.violations.append(
                                f"bind without batch: {key} in cycle {c}")
                            continue
                        inc.apply(MODIFIED, bind_pod(pod, node))
                    self.bound_by_cycle[c] = [(key, node)
                                              for key, node in rec["b"]]
                elif k == "emit":
                    flush_below(c)
                    live = self._live_pending.pop(c, None)
                    if live is not None \
                            and placement_hash(live) != rec["h"]:
                        report.violations.append(
                            f"live placements diverge from the durable "
                            f"emit at cycle {c}")
                    fold_emit(rec)
                    self.chain_history[persist.cycles_emitted] = \
                        persist.chain
            if tsp:
                tsp.end()
            # settle everything still open, in cycle order: a cycle we
            # scheduled live whose emit never became durable gets its emit
            # appended now (our placements are the leader's: the per-cycle
            # cross-checks proved it); the rest of the crash tail is
            # decided again
            ssp = flight.span("promote:settle")
            for cid in sorted(set(pending) | set(self._live_pending)):
                if cid in self._live_pending:
                    persist.log_emit(cid, self._live_pending.pop(cid))
                    report.settled_live.append(cid)
                else:
                    pending.remove(cid)
                    recompute(cid)
            if ssp:
                ssp.set("settled_live", len(report.settled_live))
                ssp.end()
            if rsp:
                rsp.set("tail_records", report.tail_records)
                rsp.set("recomputed", len(report.recomputed))
        report.violations.extend(persist.bind_mismatches)
        if any("chain missed" in v for v in report.violations):
            persist.close()
            set_role("follower")
            raise PromotionRefused(report.violations[-1])

        persist.checkpoint_every = checkpoint_every
        persist.checkpoint()
        self.chain = persist.chain
        self.cycles_emitted = persist.cycles_emitted
        self.decisions = persist.decisions
        self.scheduled = persist.scheduled
        self.next_cycle = persist.next_cycle
        self.persist = persist
        self.promoted = True
        report.resume_cycle = persist.cycles_emitted
        report.chain = persist.chain
        report.wal_records = persist.wal_records
        report.replay_s = perf_counter() - t0
        register().replication_promotions.inc()
        set_role("leader")
        from tpusim_torch.obs import slo as _slo

        tracker = _slo.get_tracker()
        if tracker is not None:
            tracker.reset()   # the promoted twin's error budget starts
            #                   clean: the replay was not serving
        flight.note_recovery("promotion", {
            "resume_cycle": report.resume_cycle,
            "tail_records": report.tail_records,
            "recomputed": len(report.recomputed),
            "chain": report.chain[:16]})
        return report

    def stop(self, *, keep_session: bool = True) -> None:
        """Stop taking records: close the listener, hang up the link and
        wait (5 s at most) for the receive thread to end."""
        with self._lock:
            self._stop = True
            conn = self._conn
        _hang_up(self._server)
        if conn is not None:
            _hang_up(conn)
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)
        if not keep_session and self.persist is not None:
            self.persist.close()


# -- failover --------------------------------------------------------------

def http_probe(url: str, timeout: float = 1.0) -> Callable[[], bool]:
    """A leader-health probe of a /healthz URL."""
    from urllib.request import urlopen

    def probe() -> bool:
        with urlopen(url, timeout=timeout) as resp:
            return resp.status == 200
    return probe


class FailoverController:
    """Watches the leader's health and promotes the freshest follower.

    ``probe`` is any callable that is truthy while the leader lives (an
    exception or a falsy return is a miss); ``misses`` misses in a row
    declare death. The RTO is measured end to end: from the first missed
    probe to promoted and journaling."""

    def __init__(self, probe: Callable[[], bool],
                 followers: Sequence[FollowerTwin], wal_dir: str, *,
                 interval_s: float = 0.02, misses: int = 2,
                 checkpoint_every: int = 0, fsync_every: int = 0,
                 leader_was_alive: bool = False):
        self.probe = probe
        self.followers = list(followers)
        self.wal_dir = wal_dir
        self.interval_s = interval_s
        self.misses = misses
        self.checkpoint_every = checkpoint_every
        self.fsync_every = fsync_every
        # misses count only once the leader has been SEEN alive: a follower
        # started before its leader waits for first contact instead of
        # failing over onto a WAL that does not exist yet. A caller that
        # watched the leader run (the in-process driver catches its
        # ProcessCrash itself) passes leader_was_alive=True
        self.leader_was_alive = leader_was_alive

    def leader_alive(self) -> bool:
        try:
            return bool(self.probe())
        except Exception:
            return False

    def wait_for_death(self, timeout: float = 30.0) -> float:
        """Poll until ``misses`` probe failures in a row AFTER the leader
        was seen alive at least once; returns the perf_counter reading of
        the FIRST miss of the fatal streak."""
        deadline = monotonic() + timeout
        streak, first_miss = 0, 0.0
        while True:
            if self.leader_alive():
                self.leader_was_alive = True
                streak = 0
            elif self.leader_was_alive:
                if streak == 0:
                    first_miss = perf_counter()
                streak += 1
                if streak >= self.misses:
                    return first_miss
            if monotonic() >= deadline:
                raise TimeoutError(
                    "leader never died within the watch window"
                    if self.leader_was_alive else
                    "leader was never observed alive within the watch "
                    "window")
            sleep(self.interval_s)

    def failover(self, t_detect: Optional[float] = None
                 ) -> Tuple[FollowerTwin, PromotionReport]:
        """Promote the freshest non-diverged follower; refuse when none
        qualifies. A refusal by the freshest candidate falls through to the
        next freshest: degraded, never silently wrong."""
        if t_detect is None:
            t_detect = perf_counter()
        candidates = sorted(self.followers,
                            key=lambda f: f.applied_seq, reverse=True)
        last_refusal: Optional[Exception] = None
        for follower in candidates:
            try:
                report = follower.promote(
                    self.wal_dir, checkpoint_every=self.checkpoint_every,
                    fsync_every=self.fsync_every)
            except PromotionRefused as exc:
                last_refusal = exc
                continue
            report.rto_s = perf_counter() - t_detect
            register().replication_rto_seconds.set(report.rto_s)
            return follower, report
        raise PromotionRefused(
            f"no promotable follower among {len(candidates)} candidates: "
            f"{last_refusal}")

    def run(self, timeout: float = 30.0
            ) -> Tuple[FollowerTwin, PromotionReport]:
        """Watch until the leader dies, then fail over."""
        t_detect = self.wait_for_death(timeout)
        return self.failover(t_detect)
