"""Write-ahead journal and checkpoints for the streaming twin, and crash
recovery from them.

The device-resident twin (stream.runtime.DeviceResidentCluster) survives any
watch churn cycle by cycle, but a process crash loses it whole: the resident
carry lives in device memory, the host IncrementalCluster in process memory,
and neither has a durable form. This module makes the twin recoverable with
the classic WAL and checkpoint pair:

  WAL (``wal.jsonl``): one compact JSON record per committed host mutation
      or emission, in host-picture order:

        {"k":"ev",   "c":C, "t":TYPE, "r":KIND, "o":OBJ}   committed watch delta
        {"k":"batch","c":C, "pods":[OBJ...]}               cycle C's arrivals
        {"k":"bind", "c":C, "b":[[POD_KEY, NODE]...]}      binds folded into
                                                           the host picture
        {"k":"emit", "c":C, "h":HASH, "n":N, "s":S}        cycle C emitted
                                                           (placement_hash,
                                                           decisions, scheduled)

      ``ev`` records are appended from the IncrementalCluster's ``on_event``
      hook (delta.py), so deltas arriving by ANY path (session.apply,
      Reflector.watch, ingest) are journaled the moment they commit. Bind
      records are written at fold time: pipelined, cycle N's binds land
      BEFORE cycle N+1's events, the order the host picture mutates in, so a
      sequential replay rebuilds the picture byte for byte.

  Checkpoint (``checkpoint.json``): a periodic host snapshot (the
      IncrementalCluster as a ClusterSnapshot), the resumable placement
      chain, the counters and the WAL byte offset the snapshot is
      consistent with. With the twin resident, the checkpoint also copies
      the carry and statics tensors (and the PolicyTables arrays) to an
      ``.npz`` keyed on the plan: the durable image of the device state,
      cross-checked against host truth (the carry's pod_count against the
      bound pods) at a quiesced boundary, so a diverged twin cannot
      checkpoint silently. The copy is issued on the stream the scans run
      on, so it waits for a pipelined scan still in flight.

Recovery (``recover_stream_session``) = load the checkpoint and replay the
WAL: events and committed binds apply again to a fresh IncrementalCluster;
batches that never reached their ``emit`` record (the crash tail) are
scheduled again through a fresh session. Placements are deterministic, so
the recovered emission chain is byte-identical to an uninterrupted run's,
for a crash at any record boundary, mid-pipeline included. The recovery
restage is classified once as
``tpusim_stream_restage_total{reason="recovered"}``.

The placement chain is a RESUMABLE fold, ``sha256(prev_hex + hash)`` per
emission, because a running hashlib state cannot be written into a
checkpoint.

Crash injection: ``arm_crash`` raises chaos.engine.ProcessCrash right AFTER
the matching WAL record is durably written: the strictest crash model a WAL
can be tested under (every prefix of the record stream is a reachable crash
state).
"""

from __future__ import annotations

import hashlib
import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from time import perf_counter, time as wall_time
from typing import Dict, List, Optional, Tuple

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    Service,
)
from tpusim_torch.backends import Placement, bind_pod, placement_hash
from tpusim_torch.engine.providers import DEFAULT_PROVIDER
from tpusim_torch.framework.metrics import register, since_in_microseconds
from tpusim_torch.framework.store import MODIFIED
from tpusim_torch.obs import recorder as flight

# WAL record kinds double as the crash-point names a process_crash churn
# event targets: the crash fires right after the matching record of the
# armed cycle hits the journal. chaos.plan owns the tuple (plan
# validation needs it without importing the stream package).
from tpusim_torch.chaos.plan import CRASH_POINTS  # noqa: E402  (re-export)

_KINDS: Tuple[Tuple[type, str], ...] = (
    (Pod, "pod"), (Node, "node"), (Service, "service"),
    (PersistentVolume, "pv"), (PersistentVolumeClaim, "pvc"))
_LOADERS = {"pod": Pod.from_obj, "node": Node.from_obj,
            "service": Service.from_obj, "pv": PersistentVolume.from_obj,
            "pvc": PersistentVolumeClaim.from_obj}


class PersistError(RuntimeError):
    """A corrupt or inconsistent checkpoint/WAL pair."""


def _obj_kind(obj) -> str:
    for cls, kind in _KINDS:
        if isinstance(obj, cls):
            return kind
    raise TypeError(f"unsupported WAL object: {type(obj).__name__}")


def chain_fold(prev_hex: str, placement_hex: str) -> str:
    """One step of the resumable placement chain: unlike a streaming
    sha256, the fold state IS a hex digest, so a checkpoint can carry it
    and a recovered session can keep folding where the dead process
    stopped."""
    return hashlib.sha256((prev_hex + placement_hex).encode()).hexdigest()


def _capture_device(dev) -> Dict[str, object]:
    """Copy the resident tensors to host numpy: the carry (THE resident
    state), the statics tables, and the host PolicyTables arrays. The copy
    runs on the current stream, behind any scan already launched on it (a
    pipelined cycle in flight), never beside it."""
    import numpy as np

    out: Dict[str, object] = {}
    for prefix, tree in (("carry_", dev.carry), ("statics_", dev.statics)):
        if tree is None:
            continue
        for name, value in tree._asdict().items():
            out[prefix + name] = value.cpu().numpy()
    if dev.ptabs is not None:
        for name, value in getattr(dev.ptabs, "__dict__", {}).items():
            if isinstance(value, np.ndarray):
                out["ptab_" + name] = value
    return out


class StreamPersistence:
    """The WAL writer + checkpointer one StreamSession journals through.

    Wiring (StreamSession.attach_persistence): committed watch deltas
    arrive via IncrementalCluster.on_event; the session calls
    begin_cycle at batch admission, log_bind at fold time, log_emit at
    emission. ``checkpoint_every`` > 0 checkpoints after every that-many
    emitted cycles (0 = genesis checkpoint only)."""

    CHECKPOINT = "checkpoint.json"
    WAL = "wal.jsonl"

    def __init__(self, directory: str, *, checkpoint_every: int = 0,
                 fsync_every: int = 0):
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every={checkpoint_every}: "
                             "need >= 0")
        if fsync_every < 0:
            raise ValueError(f"fsync_every={fsync_every}: need >= 0")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.checkpoint_every = checkpoint_every
        # 0 = flush-only (OS buffers may lose the newest records on a HOST
        # crash, though never on a process crash); N = fsync the journal
        # fd every N appends, trading append latency for host-crash
        # durability. The chosen mode is stamped into every checkpoint
        # manifest so recovery/audit can tell what the WAL promises.
        self.fsync_every = fsync_every
        self.wal_path = os.path.join(directory, self.WAL)
        self.checkpoint_path = os.path.join(directory, self.CHECKPOINT)
        self._wal = None
        self.session = None
        self.next_cycle = 0       # cycle id the next batch record gets
        self.cycles_emitted = 0   # emit records written (ever, this WAL)
        self.chain = ""           # resumable fold over emitted hashes
        self.decisions = 0
        self.scheduled = 0
        self.wal_records = 0
        self.checkpoints = 0
        self._suppress = 0
        self._resume_ids: List[int] = []   # recovery recompute cycle ids
        self._crash: Optional[Tuple[int, str]] = None
        self._crashed = False
        # replication seams (stream.replicate.WalShipper): on_append sees
        # every durable record with its byte extent, on_checkpoint every
        # manifest. Both fire AFTER the write is durable and BEFORE any
        # armed crash — a shipped record is always a durable record, and
        # the record that kills the leader still reaches the wire.
        self.on_append = None      # (rec, kind, cycle, start_ofs, end_ofs)
        self.on_checkpoint = None  # (manifest_dict)
        # a promotion's crash-tail cycles whose bind record the dead leader
        # made durable already (cycle id -> its entries): log_bind journals
        # no second record for them and notes a re-decision that differs
        self._durable_binds: Dict[int, list] = {}
        self.bind_mismatches: List[str] = []

    # -- wiring ------------------------------------------------------------

    def attach(self, session) -> "StreamPersistence":
        """Bind to a StreamSession (use session.attach_persistence). A
        fresh directory gets a genesis checkpoint so recovery always has
        a snapshot to replay onto."""
        self.session = session
        session.persist = self
        session.inc.on_event = self.on_inc_event
        if self._wal is None:
            self._wal = open(self.wal_path, "a", encoding="utf-8")
        if not os.path.exists(self.checkpoint_path):
            self.checkpoint()
        return self

    def close(self) -> None:
        if self._wal is not None:
            self._wal.flush()
            self._wal.close()
            self._wal = None
        if self.session is not None \
                and self.session.inc.on_event == self.on_inc_event:
            self.session.inc.on_event = None

    @contextmanager
    def suppress_events(self):
        """Gate on_inc_event off: fold-back binds are journaled as bind
        records (not ev records), and recovery replay re-applies records
        that are already durable."""
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1

    # -- crash injection ---------------------------------------------------

    def arm_crash(self, cycle: int, point: str) -> None:
        """Raise chaos.engine.ProcessCrash right after the ``point``
        record of cycle ``cycle`` is durably appended."""
        if point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r} "
                             f"(expected one of {CRASH_POINTS})")
        self._crash = (int(cycle), point)

    def _maybe_crash(self, kind: str, cycle: int) -> None:
        if self._crash is None or self._crashed:
            return
        at, point = self._crash
        if kind == point and cycle == at:
            from tpusim_torch.chaos.engine import ProcessCrash

            self._crashed = True
            flight.note_fault("process_crash",
                             {"cycle": cycle, "point": point})
            raise ProcessCrash(
                f"chaos: injected process crash after the {point} record "
                f"of cycle {cycle}")

    # -- record writing ----------------------------------------------------

    def _append(self, rec: dict, kind: str, cycle: int) -> None:
        start = self._wal.tell()
        self._wal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal.flush()
        if self.fsync_every \
                and (self.wal_records + 1) % self.fsync_every == 0:
            os.fsync(self._wal.fileno())
        self.wal_records += 1
        register().recovery_wal_records.set(float(self.wal_records))
        if self.on_append is not None:
            self.on_append(rec, kind, cycle, start, self._wal.tell())
        self._maybe_crash(kind, cycle)

    def on_inc_event(self, event_type: str, obj) -> None:
        """IncrementalCluster.on_event hook: one committed watch delta.
        Labeled with the UPCOMING cycle id — events precede the batch
        they affect."""
        if self._suppress:
            return
        self._append({"k": "ev", "c": self.next_cycle, "t": event_type,
                      "r": _obj_kind(obj), "o": obj.to_obj()},
                     "events", self.next_cycle)

    def queue_resume(self, cid: int) -> None:
        """Recovery: the next begin_cycle reuses ``cid`` (its batch
        record is already durable) instead of assigning a fresh id."""
        self._resume_ids.append(int(cid))

    def begin_cycle(self, pods: List[Pod]) -> int:
        if self._resume_ids:
            return self._resume_ids.pop(0)
        cid = self.next_cycle
        self.next_cycle += 1
        self._append({"k": "batch", "c": cid,
                      "pods": [p.to_obj() for p in pods]}, "batch", cid)
        return cid

    def adopt_bind(self, cid: int, entries: list) -> None:
        """Cycle ``cid``'s bind record is durable already (a promotion
        decides the cycle again): its next log_bind writes nothing."""
        self._durable_binds[int(cid)] = [list(e) for e in entries]

    def log_bind(self, cid: int, bound: List[Placement]) -> None:
        """Cycle ``cid``'s binds, at the moment they fold into the host
        picture. Always written (possibly empty) so every cycle exposes
        all four crash boundaries."""
        entries = [[pl.pod.key(), pl.node_name] for pl in bound]
        durable = self._durable_binds.pop(cid, None)
        if durable is not None:
            if durable != entries:
                self.bind_mismatches.append(
                    f"cycle {cid} decided again binds {len(entries)} pods "
                    f"otherwise than its durable bind record "
                    f"({len(durable)})")
            return
        self._append({"k": "bind", "c": cid, "b": entries}, "bind", cid)

    def log_emit(self, cid: int, placements: List[Placement]) -> None:
        h = placement_hash(placements)
        s = sum(1 for p in placements if p.node_name)
        self.chain = chain_fold(self.chain, h)
        self.decisions += len(placements)
        self.scheduled += s
        self.cycles_emitted += 1
        register().stream_chain_head.set_info(head=self.chain,
                                              cycle=str(cid))
        self._append({"k": "emit", "c": cid, "h": h,
                      "n": len(placements), "s": s}, "emit", cid)
        if self.checkpoint_every \
                and self.cycles_emitted % self.checkpoint_every == 0:
            self.checkpoint()

    # -- checkpoint --------------------------------------------------------

    def checkpoint(self) -> dict:
        """Write an atomic host snapshot consistent with the current WAL
        offset (tmp + rename). Replaying WAL[offset:] onto it reproduces
        the live host picture exactly, because every host mutation is a
        durable ev/bind record BEFORE the picture moves on."""
        import numpy as np

        t0 = perf_counter()
        session = self.session
        inc = session.inc
        sp = flight.span("recover:checkpoint")
        with sp:
            self._wal.flush()
            device_npz = None
            device_bound = None
            # bound-to-a-known-node count: the host-truth side of the
            # carry pod_count cross-check (parked pods on unknown nodes
            # have no carry row)
            bound_pods = sum(1 for p in inc._pods.values()
                             if p.spec.node_name in inc._node_index)
            if session.device.valid:
                arrays = _capture_device(session.device)
                if arrays:
                    sig = hashlib.sha256(
                        repr(session.device.plan_key).encode()
                    ).hexdigest()[:12]
                    device_npz = f"device-{sig}.npz"
                    np.savez(os.path.join(self.directory, device_npz),
                             **arrays)
                    quiesced = (session._pending is None
                                and not inc._journal_nodes
                                and not inc._journal_presence)
                    if quiesced and "carry_pod_count" in arrays:
                        # cross-check only at a quiesced boundary: an
                        # in-flight pipelined cycle has already advanced
                        # the carry past the host fold, and undrained
                        # journal deltas (watch events applied to the host
                        # but not yet scatter-committed) lag it behind
                        device_bound = int(arrays["carry_pod_count"].sum())
            meta = {
                "cycle": self.cycles_emitted,
                "next_cycle": self.next_cycle,
                "chain": self.chain,
                "decisions": self.decisions,
                "scheduled": self.scheduled,
                "wal_offset": self._wal.tell(),
                "wal_records": self.wal_records,
                "bound_pods": bound_pods,
                "device_bound": device_bound,
                "plan_sig": repr(session._plan_key),
                "device_npz": device_npz,
                # the node-sharded residency layout: the port's twin is
                # single-device, so there is none
                "shard_layout": None,
                # the WAL's durability promise at the time this manifest
                # was cut: flush-only survives process crashes, fsync
                # survives host crashes too
                "durability": {
                    "mode": "fsync" if self.fsync_every else "flush",
                    "fsync_every": self.fsync_every,
                },
                "snapshot": inc.to_snapshot().to_obj(),
            }
            tmp = self.checkpoint_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                # the same bytes as json.dump, through the C encoder
                # (json.dump streams through the pure-Python one)
                f.write(json.dumps(meta, separators=(",", ":")))
            os.replace(tmp, self.checkpoint_path)
            if sp:
                sp.set("cycle", self.cycles_emitted)
                sp.set("wal_records", self.wal_records)
        register().recovery_checkpoint_latency.observe(
            since_in_microseconds(t0))
        register().recovery_last_checkpoint_timestamp.set(wall_time())
        self.checkpoints += 1
        flight.note_recovery("checkpoint", {"cycle": self.cycles_emitted,
                                            "wal_records": self.wal_records})
        if self.on_checkpoint is not None:
            self.on_checkpoint(meta)
        return meta


@dataclass
class RecoveryReport:
    """What recover_stream_session reconstructed, and from how much."""

    resume_cycle: int = 0          # first cycle the driver should run
    checkpoint_cycle: int = 0      # cycles already folded at checkpoint
    chain: str = ""                # resumable fold chain after replay
    decisions: int = 0
    scheduled: int = 0
    wal_records: int = 0
    tail_records: int = 0          # records replayed past the checkpoint
    recomputed: List[int] = field(default_factory=list)
    replay_s: float = 0.0
    events_applied: Dict[int, int] = field(default_factory=dict)
    bound_by_cycle: Dict[int, List[Tuple[str, str]]] = \
        field(default_factory=dict)
    violations: List[str] = field(default_factory=list)
    device_arrays: Optional[dict] = None
    shard_layout: Optional[dict] = None   # node-mesh layout at checkpoint


def tail_wal(wal_path: str, offset: int = 0
             ) -> Tuple[List[Tuple[int, dict]], List[str], int]:
    """Incremental WAL reader: parse complete records from
    byte ``offset`` to EOF, returning ([(byte offset, record)],
    violations, resume_offset). ``resume_offset`` is the position after
    the last COMPLETE record — hand it back to the next call to follow
    the live tail without re-parsing the prefix. The shipper, the
    follower's promotion replay, and cold recovery all share this one
    parser.

    Torn-line policy: unparseable trailing lines are a live-tail
    artifact (a crash mid-write, or a writer mid-append) — dropped, and
    ``resume_offset`` stops BEFORE them so a later call retries once the
    line completes. An unparseable line followed by further complete
    records is a torn INTERIOR write: the journal itself is corrupt, and
    each such line is reported as a violation."""
    records: List[Tuple[int, Optional[dict]]] = []
    with open(wal_path, "r", encoding="utf-8") as f:
        f.seek(offset)
        while True:
            ofs = f.tell()
            line = f.readline()
            if not line:
                break
            if not line.strip():
                continue
            if not line.endswith("\n"):
                # a partial final line with no terminator is still being
                # written (or was torn by a crash): never a violation
                records.append((ofs, None))
                break
            try:
                records.append((ofs, json.loads(line)))
            except json.JSONDecodeError:
                records.append((ofs, None))
    resume_offset = offset
    while records and records[-1][1] is None:
        records.pop()
    if records:
        last_ofs = records[-1][0]
        with open(wal_path, "rb") as f:
            f.seek(last_ofs)
            resume_offset = last_ofs + len(f.readline())
    violations: List[str] = []
    for ofs, rec in records:
        if rec is None:
            violations.append(f"corrupt WAL record at byte {ofs} "
                              "(torn interior write)")
    return ([(o, r) for o, r in records if r is not None], violations,
            resume_offset)


def read_wal(wal_path: str) -> Tuple[List[Tuple[int, dict]], List[str]]:
    """Parse a whole WAL into [(byte offset, record)] plus violation
    strings — ``tail_wal`` from byte 0, keeping the original two-tuple
    shape recovery and the tests consume."""
    records, violations, _ = tail_wal(wal_path, 0)
    return records, violations


def recover_stream_session(directory: str, *,
                           provider: str = DEFAULT_PROVIDER,
                           policy=None, always_restage: bool = False,
                           checkpoint_every: int = 0, device="cuda"):
    """Rebuild a StreamSession from a checkpoint + WAL directory.

    Returns (session, RecoveryReport, StreamPersistence): the session's
    host picture equals the crashed process's at its last durable record;
    batches that never emitted (the crash tail) have been re-scheduled —
    deterministically identical to the lost decisions — and their
    emit records appended, with a bind record only where the crashed
    process left none (a durable one is adopted, never written twice), so
    the WAL ends every cycle committed.
    The persistence object is re-attached and appends to the same WAL;
    the session's next cycle restages classified ``recovered`` (exactly
    once — re-scheduling the tail consumes the latch when there is one).
    device: "cuda" (the default) or "cpu", the recovered session's.
    """
    from tpusim_torch.delta import IncrementalCluster
    from tpusim_torch.stream.runtime import StreamSession

    t0 = perf_counter()
    ck_path = os.path.join(directory, StreamPersistence.CHECKPOINT)
    wal_path = os.path.join(directory, StreamPersistence.WAL)
    if not os.path.exists(ck_path) or not os.path.exists(wal_path):
        raise PersistError(f"{directory}: no checkpoint/WAL pair to "
                           "recover from")
    with open(ck_path, "r", encoding="utf-8") as f:
        ck = json.load(f)
    records, torn = read_wal(wal_path)
    report = RecoveryReport(checkpoint_cycle=int(ck["cycle"]),
                            violations=list(torn),
                            shard_layout=ck.get("shard_layout"))

    snapshot = ClusterSnapshot.from_obj(ck["snapshot"])
    inc = IncrementalCluster(snapshot)
    session = StreamSession(incremental=inc, provider=provider,
                            policy=policy, always_restage=always_restage,
                            device=device)

    # metadata pass over the FULL journal: batch pods, committed cycles,
    # per-cycle bind maps (the driver's load-generator fast-forward feed)
    batches: Dict[int, List[Pod]] = {}
    batch_ofs: Dict[int, int] = {}
    binds: Dict[int, list] = {}
    emitted = set()
    max_cid = -1   # over ADMITTED cycles only: ev records labeled with a
    #                never-admitted upcoming cycle must not consume its id
    for _ofs, rec in records:
        k, c = rec["k"], int(rec["c"])
        if k == "batch":
            max_cid = max(max_cid, c)
            batches[c] = [Pod.from_obj(o) for o in rec["pods"]]
            batch_ofs[c] = _ofs
        elif k == "emit":
            emitted.add(c)
        elif k == "bind":
            binds[c] = rec["b"]
            report.bound_by_cycle[c] = [(key, node)
                                        for key, node in rec["b"]]
        elif k == "ev":
            report.events_applied[c] = report.events_applied.get(c, 0) + 1

    # checkpointing stays off until replay finishes: recomputed bind/emit
    # records append at the WAL tail OUT of host-picture order, so a
    # checkpoint mid-replay would anchor a non-replayable offset
    persist = StreamPersistence(directory, checkpoint_every=0)
    persist.next_cycle = max(int(ck["next_cycle"]), max_cid + 1)
    persist.cycles_emitted = int(ck["cycle"])
    persist.chain = ck["chain"]
    persist.decisions = int(ck["decisions"])
    persist.scheduled = int(ck["scheduled"])
    persist.wal_records = len(records)
    persist.attach(session)

    offset_limit = int(ck["wal_offset"])
    # batches with no emit, in cycle order. A pipelined checkpoint is cut
    # while the next cycle is in flight, so its batch record lies BEFORE
    # the checkpoint's offset: the cycle is pending from the start (the
    # JAX package's recovery starts this list empty, and so loses such a
    # cycle when the process dies before its emit record)
    pending: List[int] = sorted(c for c, ofs in batch_ofs.items()
                                if ofs < offset_limit and c not in emitted)

    def recompute(cid: int) -> None:
        persist.queue_resume(cid)
        if cid in binds:
            # the crashed process's bind record of this cycle is durable:
            # decide the cycle again without journaling it a second time
            persist.adopt_bind(cid, binds[cid])
        placements = session.schedule(batches[cid])
        report.recomputed.append(cid)
        report.bound_by_cycle[cid] = [(pl.pod.key(), pl.node_name)
                                      for pl in placements if pl.node_name]

    def flush_below(cycle: int) -> None:
        while pending and pending[0] < cycle:
            recompute(pending.pop(0))

    session.force_restage("recovered")
    rsp = flight.span("recover:replay")
    with rsp, persist.suppress_events():
        for ofs, rec in records:
            if ofs < offset_limit:
                continue
            report.tail_records += 1
            k, c = rec["k"], int(rec["c"])
            if k == "ev":
                # an uncommitted batch below this cycle must re-decide
                # BEFORE later events apply (host-picture order)
                flush_below(c)
                inc.apply(rec["t"], _LOADERS[rec["r"]](rec["o"]))
            elif k == "batch":
                if c not in emitted:
                    pending.append(c)
            elif k == "bind":
                if c not in emitted:
                    continue   # crash tail: the cycle re-decides instead
                flush_below(c)
                pods_by_key = {p.key(): p for p in batches.get(c, [])}
                for key, node in rec["b"]:
                    prev = inc._pods.get(key)
                    if prev is not None and prev.spec.node_name \
                            and prev.spec.node_name != node:
                        report.violations.append(
                            f"double-bind in WAL: {key} bound to "
                            f"{prev.spec.node_name} then {node} in "
                            f"cycle {c}")
                    pod = pods_by_key.get(key)
                    if pod is None:
                        report.violations.append(
                            f"bind without batch: {key} in cycle {c}")
                        continue
                    inc.apply(MODIFIED, bind_pod(pod, node))
            elif k == "emit":
                flush_below(c)
                persist.chain = chain_fold(persist.chain, rec["h"])
                persist.decisions += int(rec["n"])
                persist.scheduled += int(rec["s"])
                persist.cycles_emitted += 1
        flush_below(persist.next_cycle + 1)
        report.violations.extend(persist.bind_mismatches)
        if rsp:
            rsp.set("tail_records", report.tail_records)
            rsp.set("recomputed", len(report.recomputed))

    report.resume_cycle = persist.cycles_emitted
    report.chain = persist.chain
    report.decisions = persist.decisions
    report.scheduled = persist.scheduled
    report.wal_records = persist.wal_records
    # a fresh checkpoint makes the recovered picture the new replay base:
    # everything below this offset (including the out-of-order recomputed
    # tail) is metadata-only for any future recovery
    persist.checkpoint_every = checkpoint_every
    persist.checkpoint()
    report.replay_s = perf_counter() - t0
    register().recovery_replay_latency.observe(since_in_microseconds(t0))
    flight.note_recovery("replay", {
        "resume_cycle": report.resume_cycle,
        "tail_records": report.tail_records,
        "recomputed": len(report.recomputed)})

    # durable device image: load + integrity-check when the plan matches
    if ck.get("device_npz"):
        npz = os.path.join(directory, ck["device_npz"])
        if os.path.exists(npz):
            import numpy as np

            report.device_arrays = dict(np.load(npz))
        db = ck.get("device_bound")
        if db is not None and db != ck.get("bound_pods"):
            report.violations.append(
                f"checkpointed device twin diverged from host truth: "
                f"carry pod_count {db} vs {ck.get('bound_pods')} bound "
                "pods")
    return session, report, persist
