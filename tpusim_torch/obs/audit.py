"""Chain-divergence forensics: the ``audit`` subcommand.

Two runs that should have produced byte-identical decision streams (a
leader and its follower, two same-seed simulations, a run and its recovery
replay) sometimes do not. The placement-hash chain says THAT they diverged;
this module answers WHERE and WHY:

1. **Bisect.** Fold each WAL's per-cycle digests (sha256 over the cycle's
   sorted bind list, emit hash, batch keys and event count) into a
   resumable chain (persist.chain_fold) and bisect on chain equality to the
   FIRST divergent cycle: O(log n) chain-head comparisons over the prefix,
   then one record-level diff at the divergence.

2. **Replay and re-decide.** Rebuild the shared prefix (checkpoint snapshot
   + WAL replay, as recover_stream_session does) into a fresh session, then
   schedule the divergent cycle's batch again through TorchBackend with a
   ProvenanceLog asking for ``explain_k`` score-breakdown lanes (route
   "auto" takes the scan for them, counted): the top-k candidate order, the
   score parts by priority, the restage classification, and, where the
   checkpoint carries a shard layout, the shard that owned the flipped
   node. The port's checkpoints carry none (its twin is single-device), so
   no shard fields are added, as for an unsharded directory in the JAX
   package.

The audited directories are only read: the replay session journals nothing,
and the report is a plain dict (rendered by ``render_report`` for the CLI,
JSON-dumpable for artifacts). The replay runs on ``device`` ("cuda" by
default, or "cpu").
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from tpusim_torch.engine.providers import DEFAULT_PROVIDER


@dataclass
class CycleDigest:
    """One cycle's comparable identity, extracted from a WAL."""

    cycle: int
    binds: List[Tuple[str, str]] = field(default_factory=list)
    emit_hash: Optional[str] = None
    batch_keys: List[str] = field(default_factory=list)
    events: int = 0

    def digest(self) -> str:
        body = json.dumps({"b": sorted(self.binds), "h": self.emit_hash,
                           "p": self.batch_keys, "e": self.events},
                          sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(body.encode()).hexdigest()


def extract_cycles(wal_path: str) -> Dict[int, CycleDigest]:
    """The per-cycle digest table of one WAL (violations are tolerated: a
    torn tail ends the comparable range early)."""
    from tpusim_torch.stream.persist import read_wal

    records, _violations = read_wal(wal_path)
    cycles: Dict[int, CycleDigest] = {}

    def at(c: int) -> CycleDigest:
        if c not in cycles:
            cycles[c] = CycleDigest(cycle=c)
        return cycles[c]

    for _ofs, rec in records:
        k, c = rec.get("k"), int(rec.get("c", -1))
        if k == "batch":
            at(c).batch_keys = [
                f"{(o.get('metadata') or {}).get('namespace') or 'default'}"
                f"/{(o.get('metadata') or {}).get('name')}"
                for o in rec.get("pods", [])]
        elif k == "bind":
            at(c).binds = [(key, node) for key, node in rec.get("b", [])]
        elif k == "emit":
            at(c).emit_hash = rec.get("h")
        elif k == "ev":
            at(c).events += 1
    return cycles


def _chain_heads(cycles: Dict[int, CycleDigest],
                 upto: int) -> List[Tuple[int, str]]:
    """[(cycle, folded chain head AFTER that cycle)] for cycles 0..upto, in
    order: the bisection axis."""
    from tpusim_torch.stream.persist import chain_fold

    heads: List[Tuple[int, str]] = []
    chain = ""
    for c in sorted(k for k in cycles if k <= upto):
        chain = chain_fold(chain, cycles[c].digest())
        heads.append((c, chain))
    return heads


def first_divergence(a: Dict[int, CycleDigest],
                     b: Dict[int, CycleDigest]) -> Optional[int]:
    """The first cycle whose digest differs between the two tables, found by
    bisecting the folded digest chain, or None when the shared range agrees
    everywhere. A cycle present on one side only counts as divergent (a
    truncated run diverges at its first missing cycle)."""
    last = max(max(a, default=-1), max(b, default=-1))
    if last < 0:
        return None
    heads_a = dict(_chain_heads(a, last))
    heads_b = dict(_chain_heads(b, last))
    axis = sorted(set(a) | set(b))
    if heads_a.get(axis[-1]) == heads_b.get(axis[-1]) \
            and set(a) == set(b):
        return None
    lo, hi = 0, len(axis) - 1
    # invariant: some cycle in axis[lo..hi] diverges; the chains agree
    # strictly below axis[lo]
    while lo < hi:
        mid = (lo + hi) // 2
        c = axis[mid]
        if heads_a.get(c) == heads_b.get(c) and c in a and c in b:
            lo = mid + 1
        else:
            hi = mid
    return axis[lo]


def _classify(da: Optional[CycleDigest],
              db: Optional[CycleDigest]) -> str:
    if da is None or db is None:
        return "missing_cycle"
    if da.batch_keys != db.batch_keys:
        return "batch"
    if da.events != db.events:
        return "events"
    if sorted(da.binds) != sorted(db.binds):
        return "bind"
    if da.emit_hash != db.emit_hash:
        return "emit"
    return "unknown"


def _bind_diff(da: CycleDigest, db: CycleDigest) -> List[Dict[str, Any]]:
    ma, mb = dict(da.binds), dict(db.binds)
    rows = []
    for key in sorted(set(ma) | set(mb)):
        if ma.get(key) != mb.get(key):
            rows.append({"pod": key, "a": ma.get(key), "b": mb.get(key)})
    return rows


def _shard_owner(layout: Optional[dict], node: Optional[str]
                 ) -> Optional[int]:
    """Which shard of a checkpointed node-mesh layout owns ``node``."""
    if not layout or not node:
        return None
    for shard, nodes in enumerate(layout.get("blocks") or []):
        if node in nodes:
            return shard
    owners = layout.get("owners")
    if isinstance(owners, dict):
        return owners.get(node)
    return None


def _replay_prefix(directory: str, divergent: int, *,
                   provider: str, policy=None, device="cuda"):
    """Rebuild the host picture as of the divergent cycle's admission: the
    checkpoint snapshot + a replay of every WAL record strictly BEFORE
    cycle ``divergent``'s batch record (events labeled with the divergent
    cycle included: they precede the batch in host-picture order). Returns
    (session, batch_pods, ck), or (None, reason, None) when the directory
    cannot support a replay (its checkpoint is past the divergence)."""
    from tpusim_torch.api.snapshot import ClusterSnapshot
    from tpusim_torch.api.types import Pod
    from tpusim_torch.backends import bind_pod
    from tpusim_torch.delta import IncrementalCluster
    from tpusim_torch.framework.store import MODIFIED
    from tpusim_torch.stream.persist import (
        _LOADERS,
        StreamPersistence,
        read_wal,
    )
    from tpusim_torch.stream.runtime import StreamSession

    ck_path = os.path.join(directory, StreamPersistence.CHECKPOINT)
    wal_path = os.path.join(directory, StreamPersistence.WAL)
    if not os.path.exists(ck_path):
        return None, "no checkpoint manifest to replay from", None
    with open(ck_path, "r", encoding="utf-8") as f:
        ck = json.load(f)
    if int(ck["cycle"]) > divergent:
        return None, (f"checkpoint already covers cycle {ck['cycle']} > "
                      f"divergent cycle {divergent}; re-run with "
                      "checkpoint_every=0 to audit"), None
    records, _ = read_wal(wal_path)
    inc = IncrementalCluster(ClusterSnapshot.from_obj(ck["snapshot"]))
    session = StreamSession(incremental=inc, provider=provider,
                            policy=policy, device=device)
    offset_limit = int(ck["wal_offset"])
    batch_pods: Optional[List] = None
    for ofs, rec in records:
        if ofs < offset_limit:
            continue
        k, c = rec["k"], int(rec["c"])
        if k == "batch":
            if c == divergent:
                batch_pods = [Pod.from_obj(o) for o in rec["pods"]]
                break
            continue
        if c >= divergent and k != "ev":
            break
        if k == "ev":
            inc.apply(rec["t"], _LOADERS[rec["r"]](rec["o"]))
        elif k == "bind":
            pods_by_key = {}
            for rec2 in (r for _o, r in records
                         if r["k"] == "batch" and int(r["c"]) == c):
                pods_by_key = {p.key(): p
                               for p in (Pod.from_obj(o)
                                         for o in rec2["pods"])}
            for key, node in rec["b"]:
                pod = pods_by_key.get(key)
                if pod is not None:
                    inc.apply(MODIFIED, bind_pod(pod, node))
    if batch_pods is None:
        return None, (f"cycle {divergent} has no batch record in "
                      f"{wal_path}"), None
    return session, batch_pods, ck


def _forensic_rerun(session, batch_pods, *, explain_k: int,
                    provider: str, device="cuda") -> Dict[str, Any]:
    """Decide the divergent batch again, twice: once through the streaming
    session (the restage and path classification, and the placements), and
    once through TorchBackend with explain lanes armed (the stream's
    restage does not thread explain_k into its scan, but the stream's
    exactness contract makes the backend's decisions, and so its top-k
    score-parts lanes, the same decisions)."""
    from tpusim_torch.obs import provenance

    out: Dict[str, Any] = {}
    if explain_k > 0:
        from tpusim_torch.backends import get_backend

        snap = session.inc.to_snapshot()
        saved = provenance.get_log()
        log = provenance.ProvenanceLog(capacity=4096,
                                       top_k=int(explain_k))
        provenance._active = log
        try:
            backend = get_backend("torch", provider=provider, device=device)
            explained = backend.schedule(batch_pods, snap)
        finally:
            provenance._active = saved
        out["decisions"] = log.tail(limit=max(1, len(batch_pods)))
        out["explain_placements"] = sorted(
            (pl.pod.key(), pl.node_name)
            for pl in explained if pl.node_name)
    placements = session.schedule(batch_pods)
    out["path"] = dict(session.path_counts)
    out["restages"] = dict(session.restage_counts)
    out["placements"] = sorted((pl.pod.key(), pl.node_name)
                               for pl in placements if pl.node_name)
    if "explain_placements" in out \
            and out["explain_placements"] != out["placements"]:
        out["violations"] = ["explain-lane backend re-run disagrees with "
                             "the streaming re-run (parity breach)"]
    return out


def audit_wal_pair(dir_a: str, dir_b: str, *,
                   provider: str = DEFAULT_PROVIDER, policy=None,
                   explain_k: int = 3, replay: bool = True,
                   device="cuda") -> Dict[str, Any]:
    """The ``audit`` engine: bisect two WAL directories to the first
    divergent cycle and (where the checkpoints allow) decide that cycle
    again with explain lanes for a per-decision forensic diff. device: where
    the replay runs, "cuda" (the default) or "cpu"."""
    from tpusim_torch.stream.persist import StreamPersistence

    wal_a = os.path.join(dir_a, StreamPersistence.WAL)
    wal_b = os.path.join(dir_b, StreamPersistence.WAL)
    cycles_a = extract_cycles(wal_a)
    cycles_b = extract_cycles(wal_b)
    report: Dict[str, Any] = {
        "a": dir_a, "b": dir_b,
        "cycles_a": len(cycles_a), "cycles_b": len(cycles_b),
    }
    divergent = first_divergence(cycles_a, cycles_b)
    report["divergent_cycle"] = divergent
    if divergent is None:
        report["verdict"] = "identical"
        return report
    da, db = cycles_a.get(divergent), cycles_b.get(divergent)
    kind = _classify(da, db)
    report["verdict"] = "diverged"
    report["kind"] = kind
    if da is not None and db is not None:
        report["bind_diff"] = _bind_diff(da, db)
        report["emit_hash"] = {"a": da.emit_hash, "b": db.emit_hash}
        report["batch"] = da.batch_keys
    if not replay:
        return report
    session, batch_or_reason, ck = _replay_prefix(
        dir_a, divergent, provider=provider, policy=policy, device=device)
    if session is None:
        report["replay_skipped"] = batch_or_reason
        return report
    rerun = _forensic_rerun(session, batch_or_reason, explain_k=explain_k,
                            provider=provider, device=device)
    report["replay"] = rerun
    layout = (ck or {}).get("shard_layout")
    if report.get("bind_diff") and layout:
        for row in report["bind_diff"]:
            row["shard_a"] = _shard_owner(layout, row.get("a"))
            row["shard_b"] = _shard_owner(layout, row.get("b"))
    # the recorded side (if either) the deterministic re-decision agrees
    # with: the side that disagrees holds the corrupted or nondeterministic
    # record
    if da is not None and db is not None:
        ours = rerun["placements"]
        agrees_a = ours == sorted(da.binds)
        agrees_b = ours == sorted(db.binds)
        report["replay_agrees_with"] = (
            "both" if agrees_a and agrees_b else
            "a" if agrees_a else "b" if agrees_b else "neither")
    return report


def render_report(report: Dict[str, Any]) -> str:
    """The human-readable forensic report (the CLI's stdout body)."""
    lines = [f"audit: {report['a']}  vs  {report['b']}"]
    if report.get("verdict") == "identical":
        lines.append(f"chains identical across "
                     f"{report['cycles_a']} cycles")
        return "\n".join(lines) + "\n"
    d = report["divergent_cycle"]
    lines.append(f"FIRST DIVERGENT CYCLE: {d}  (kind: "
                 f"{report.get('kind', '?')})")
    eh = report.get("emit_hash") or {}
    if eh.get("a") != eh.get("b"):
        lines.append(f"  emit hash  a={str(eh.get('a'))[:16]}  "
                     f"b={str(eh.get('b'))[:16]}")
    for row in report.get("bind_diff", []):
        extra = ""
        if row.get("shard_a") is not None or row.get("shard_b") is not None:
            extra = (f"  [shard {row.get('shard_a')} -> "
                     f"{row.get('shard_b')}]")
        lines.append(f"  pod {row['pod']}: a={row.get('a')}  "
                     f"b={row.get('b')}{extra}")
    if "replay_skipped" in report:
        lines.append(f"  replay skipped: {report['replay_skipped']}")
    if "replay" in report:
        rr = report["replay"]
        lines.append(f"  re-decide agrees with: "
                     f"{report.get('replay_agrees_with', '?')}")
        diff_pods = {row["pod"] for row in report.get("bind_diff", [])}
        for rec in rr.get("decisions", []):
            if diff_pods and rec.get("pod") not in diff_pods:
                continue
            if rec.get("placed"):
                lines.append(f"    {rec['pod']} -> {rec.get('node')}")
                for cand in rec.get("top_k", [])[:5]:
                    parts = cand.get("parts") or {}
                    parts_s = " ".join(f"{k}={v}"
                                       for k, v in sorted(parts.items()))
                    lines.append(f"      candidate {cand['node']} "
                                 f"score={cand['score']}"
                                 + (f"  {parts_s}" if parts_s else ""))
            else:
                lines.append(f"    {rec['pod']} UNSCHEDULABLE: "
                             f"{rec.get('message')}")
        if rr.get("restages"):
            lines.append(f"  re-run restages: {rr['restages']}")
    return "\n".join(lines) + "\n"
