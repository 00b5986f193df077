"""Decision provenance: a structured record of why each pod was placed where
it was, or why it was not.

Every route already computes it: the scan and the fused kernel emit a reason
histogram a failed pod, and `backend.decode_placements` renders it into
`Placement.message`, byte-identical to the host's `FitError.Error()`. This
module captures the decoded decisions, optionally with the top-k score
breakdown that the scan's explain lanes emit under `EngineConfig.explain_k`,
into:

- a bounded ring in memory (`tail`), and
- an append-only JSON-lines file (`--explain-out`), read back offline by the
  CLI's `explain` subcommand.

Record schema, one JSON object a line:

    {"seq": 17, "source": "stream", "cycle": 3,
     "pod": "default/pod-41", "placed": false,
     "reason": "Unschedulable",
     "message": "0/9 nodes are available: 3 Insufficient cpu, ..."}

    {"seq": 18, "source": "backend", "pod": "default/pod-42",
     "placed": true, "node": "node-7",
     "top_k": [{"node": "node-7", "score": 13,
                "parts": {"LeastRequestedPriority": 6, ...}}, ...]}

Capture is lazy: `capture_batch` keeps a reference to the Placement list
(and the top-k arrays, where given) and builds the strings and dicts only
at export or query, so a scheduling loop pays a lock and an append a batch.
With no log installed, a call site costs one None-check.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

import numpy as np

from tpusim_torch.framework.metrics import register


class _Batch:
    __slots__ = ("placements", "source", "cycle", "ts", "seq0", "topk")

    def __init__(self, placements, source, cycle, ts, seq0, topk):
        self.placements = placements
        self.source = source
        self.cycle = cycle
        self.ts = ts
        self.seq0 = seq0
        self.topk = topk


def _pod_name(pod) -> str:
    ns = pod.metadata.namespace or "default"
    return f"{ns}/{pod.metadata.name}"


def _decode_topk(topk: Dict[str, Any], i: int) -> List[Dict[str, Any]]:
    """Pod i's top-k rows; rows at or below the sentinel are padding (fewer
    than k feasible nodes) and are dropped."""
    names = topk["names"]
    part_names = topk["part_names"]
    sentinel = topk["sentinel"]
    out: List[Dict[str, Any]] = []
    idx = np.asarray(topk["idx"][i])
    scores = np.asarray(topk["scores"][i])
    parts = np.asarray(topk["parts"][i]) if topk["parts"] is not None else None
    for r in range(idx.shape[0]):
        score = int(scores[r])
        if score <= sentinel:
            continue
        row: Dict[str, Any] = {"node": names[int(idx[r])], "score": score}
        if parts is not None and part_names:
            row["parts"] = {part_names[j]: int(parts[r][j])
                            for j in range(len(part_names))}
        out.append(row)
    return out


def decode_batch(batch: _Batch) -> List[Dict[str, Any]]:
    """One captured batch -> its record dicts (the lazy half)."""
    records: List[Dict[str, Any]] = []
    for i, pl in enumerate(batch.placements):
        rec: Dict[str, Any] = {"seq": batch.seq0 + i, "ts": batch.ts,
                               "source": batch.source}
        if batch.cycle is not None:
            rec["cycle"] = batch.cycle
        rec["pod"] = _pod_name(pl.pod)
        if pl.node_name:
            rec["placed"] = True
            rec["node"] = pl.node_name
            if batch.topk is not None:
                rec["top_k"] = _decode_topk(batch.topk, i)
        else:
            rec["placed"] = False
            rec["reason"] = pl.reason or "Unschedulable"
            rec["message"] = pl.message
        records.append(rec)
    return records


class ProvenanceLog:
    """A bounded ring of recent decision batches and an optional JSON-lines
    sink.

    capacity: the most records (pods) the ring keeps; the oldest batches
        fall off whole. path: the file `--explain-out` appends to, written
        at flush() and close(). top_k: the depth of score breakdown asked of
        the scan (read by the backends through requested_top_k; 0 records
        failures' reasons and placements only)."""

    def __init__(self, capacity: int = 4096, top_k: int = 0,
                 path: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self.top_k = int(top_k)
        self.path = path
        self._ring: Deque[_Batch] = deque()
        self._ring_pods = 0
        self._pending: List[_Batch] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._file = open(path, "a") if path is not None else None

    # -- capture (hot path) ------------------------------------------------

    def capture_batch(self, placements, source: str,
                      cycle: Optional[int] = None,
                      topk: Optional[Dict[str, Any]] = None) -> None:
        if not placements:
            return
        batch = _Batch(placements, source, cycle, round(time.time(), 3),
                       0, topk)
        with self._lock:
            batch.seq0 = self._seq
            self._seq += len(placements)
            self._ring.append(batch)
            self._ring_pods += len(placements)
            while self._ring_pods > self.capacity and len(self._ring) > 1:
                self._ring_pods -= len(self._ring.popleft().placements)
            if self._file is not None:
                self._pending.append(batch)
        register().provenance_records.inc(len(placements))

    # -- query and export (cold path) --------------------------------------

    def tail(self, limit: int = 100) -> List[Dict[str, Any]]:
        """The most recent `limit` records, decoded, oldest first."""
        with self._lock:
            batches = list(self._ring)
        records: List[Dict[str, Any]] = []
        for batch in reversed(batches):
            records[:0] = decode_batch(batch)
            if len(records) >= limit:
                break
        return records[-limit:]

    def flush(self) -> None:
        """Format the pending batches and append them to the file."""
        with self._lock:
            pending, self._pending = self._pending, []
        if self._file is None or not pending:
            return
        lines = []
        for batch in pending:
            for rec in decode_batch(batch):
                lines.append(json.dumps(rec, sort_keys=True,
                                        separators=(",", ":")))
        self._file.write("\n".join(lines) + "\n")
        self._file.flush()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None


# -- the process's active log (as recorder.install) ----------------------

_active: Optional[ProvenanceLog] = None


def install(log: ProvenanceLog) -> ProvenanceLog:
    global _active
    _active = log
    return log


def uninstall() -> None:
    global _active
    if _active is not None:
        _active.close()
    _active = None


def get_log() -> Optional[ProvenanceLog]:
    return _active


def capture(placements, source: str, cycle: Optional[int] = None,
            topk: Optional[Dict[str, Any]] = None) -> None:
    """Capture one decoded batch; a None-check when no log is installed."""
    log = _active
    if log is not None:
        log.capture_batch(placements, source, cycle=cycle, topk=topk)


def requested_top_k() -> int:
    """The explain depth the active log asks for (0 without a log, or for a
    failures-only one): a backend reads it to decide whether the scan
    writes the explain lanes."""
    log = _active
    return log.top_k if log is not None else 0


def read_jsonl(path: str) -> Iterator[Dict[str, Any]]:
    """The records of an --explain-out file, in file order."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)
