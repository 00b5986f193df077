"""The cluster analytics plane: fleet-level telemetry from the scheduler's
device state.

Provenance makes single decisions observable; this module reports the state
of the whole fleet: per resource the allocatable and requested totals, a
fragmentation score (the largest free slot against the total free), the
count of nodes with room, and the top-k hottest and coldest nodes. The
aggregates are reduced on the device (`scan.analytics_reduce`) from the
(Statics, Carry) columns a scan already holds, and decoded here only when
read. The reduction runs after the scan, outside it, so placements cannot
change with it, and a stream cycle pays one more reduction.

The device returns integers only (sums, maxima, counts, packed top-k keys);
ratios are derived at decode. `host_reduce` repeats the same integer
operations in numpy, so the two compare for equality:
`ClusterAnalytics.verify_against_host` holds every kept sample to it.

Capture follows provenance: an active instance installed at module level
behind one None-check at each call site, lazy decode, a bounded ring and an
append-only JSON-lines file (`--analytics-out`).

A sample is decoded on whichever thread reads it: the telemetry server's
handlers run on threads of their own, while the stream that produced the
sample may still be running its reduction (a pipelined cycle launches it
behind the scan and waits for nothing). On a CUDA device the capture
therefore copies the integers to pinned host memory on the producing
stream and records a CUDA event behind the copy; the decode waits on that
event alone, so no reader touches the device or synchronizes it.

Two accounting registries need no install, as compiles and residency
changes are cold by nature:

- device residency: components register a weakly held byte and entry
  source (`register_hbm_source`), polled only at snapshot time; `tenant`
  attributes the bytes;
- compile cost: `note_compile(site, signature, latency_us)` adds up builds
  and their wall a (site, signature); the per-signature table shows only
  in `compile_snapshot`, the registry counts by site.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpusim_torch.framework.metrics import register
from tpusim_torch.packing import decode_topk_key, encode_topk_keys

UTIL_SCALE = 1_000_000
RESOURCES = ("cpu", "memory", "gpu", "ephemeral", "pods")


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


# -- the numpy mirror of scan.analytics_reduce ----------------------------

def host_reduce(inp, n_valid: int, k: int) -> Dict[str, np.ndarray]:
    """The device reduction again, in numpy, integer for integer. `inp` is
    an AnalyticsIn of tensors or numpy arrays. The dict is keyed like
    AnalyticsStats' fields, and every value must equal the device's, the
    order of the top-k keys included (the keys are unique, so a descending
    sort is deterministic)."""
    alloc = np.stack([_host(inp.alloc_cpu).astype(np.int64),
                      _host(inp.alloc_mem).astype(np.int64),
                      _host(inp.alloc_gpu).astype(np.int64),
                      _host(inp.alloc_eph).astype(np.int64),
                      _host(inp.allowed_pods).astype(np.int64)])
    used = np.stack([_host(inp.used_cpu).astype(np.int64),
                     _host(inp.used_mem).astype(np.int64),
                     _host(inp.used_gpu).astype(np.int64),
                     _host(inp.used_eph).astype(np.int64),
                     _host(inp.pod_count).astype(np.int64)])
    n = alloc.shape[1]
    mask = np.arange(n) < n_valid
    alloc = np.where(mask[None, :], alloc, 0)
    used = np.where(mask[None, :], used, 0)
    free = np.maximum(alloc - used, 0)

    util = np.where(alloc[:2] > 0,
                    (used[:2] * UTIL_SCALE) // np.maximum(alloc[:2], 1), 0)
    score = np.clip(np.maximum(util[0], util[1]), 0, UTIL_SCALE)
    # the encode the device runs (packing.py): parity by shared source
    idx = np.arange(n, dtype=np.int64)
    hot = encode_topk_keys(score, idx, mask)
    cold = encode_topk_keys(UTIL_SCALE - score, idx, mask)
    return {
        "alloc": alloc.sum(axis=1),
        "used": used.sum(axis=1),
        "free_sum": free.sum(axis=1),
        "free_max": free.max(axis=1),
        "headroom_nodes": (free > 0).sum(axis=1).astype(np.int64),
        "feasible_nodes": np.int64(((free[0] > 0) & (free[1] > 0)
                                    & (free[4] > 0)).sum()),
        "valid_nodes": np.int64(mask.sum()),
        "hot_keys": np.sort(hot)[::-1][:k],
        "cold_keys": np.sort(cold)[::-1][:k],
    }


def _decode_keys(keys: np.ndarray, names, hot: bool) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for key in keys.tolist():
        if key < 0:
            continue  # padding past n_valid
        score, idx = decode_topk_key(key)
        ppm = score if hot else UTIL_SCALE - score
        out.append({"node": names[idx] if names else idx,
                    "utilization_ppm": int(ppm)})
    return out


def decode_stats(stats, names=None) -> Dict[str, Any]:
    """One AnalyticsStats -> its JSON body, the ratios derived here from
    the device's integers."""
    alloc = _host(stats.alloc).tolist()
    used = _host(stats.used).tolist()
    free_sum = _host(stats.free_sum).tolist()
    free_max = _host(stats.free_max).tolist()
    headroom = _host(stats.headroom_nodes).tolist()
    resources: Dict[str, Any] = {}
    for r, name in enumerate(RESOURCES):
        a, u, fs, fm = alloc[r], used[r], free_sum[r], free_max[r]
        resources[name] = {
            "allocatable": a, "requested": u,
            "free": fs, "largest_free": fm,
            "nodes_with_headroom": headroom[r],
            "utilization": (u / a) if a > 0 else None,
            "fragmentation": (1.0 - fm / fs) if fs > 0 else 0.0,
        }
    return {
        "nodes": {"valid": int(_host(stats.valid_nodes)),
                  "feasible": int(_host(stats.feasible_nodes))},
        "resources": resources,
        "hot_nodes": _decode_keys(_host(stats.hot_keys), names, True),
        "cold_nodes": _decode_keys(_host(stats.cold_keys), names, False),
    }


def _to_host_behind_event(stats):
    """On a CUDA device: the stats copied into pinned host memory on the
    current stream, and the event recorded behind the copies. Elsewhere
    the stats themselves and None."""
    if stats.alloc.device.type != "cuda":
        return stats, None
    host = []
    for t in stats:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return type(stats)(*host), event


class _Sample:
    __slots__ = ("stats", "source", "cycle", "ts", "seq", "names",
                 "n_valid", "k", "inputs", "decoded", "event")

    def __init__(self, stats, source, cycle, ts, seq, names, n_valid, k,
                 inputs, event=None):
        self.stats = stats
        self.source = source
        self.cycle = cycle
        self.ts = ts
        self.seq = seq
        self.names = names
        self.n_valid = n_valid
        self.k = k
        self.inputs = inputs
        self.decoded = None
        # the CUDA event behind the sample's copies to the host (None off
        # the card): a reader on any thread waits on it, and on nothing else
        self.event = event

    def ready(self) -> None:
        """Wait until the capture's reduction and copies are done."""
        if self.event is not None:
            self.event.synchronize()


def _decode_sample(sample: _Sample) -> Dict[str, Any]:
    if sample.decoded is None:  # idempotent; racing readers are harmless
        sample.ready()
        rec = {"seq": sample.seq, "ts": sample.ts, "source": sample.source}
        if sample.cycle is not None:
            rec["cycle"] = sample.cycle
        rec.update(decode_stats(sample.stats, sample.names))
        sample.decoded = rec
    return sample.decoded


class ClusterAnalytics:
    """A bounded ring of device-reduced samples and an optional JSON-lines
    sink.

    capacity: samples the ring keeps (one a cycle or dispatch). top_k: the
        depth of the hottest and coldest lists asked of the reduction
        (clamped to the node count). path: the file `--analytics-out`
        appends to. keep_inputs: keep a copy of each sample's columns and
        its n_valid, so that verify_against_host can redo the reduction in
        numpy (tests and the smoke run: it holds device memory).
    sample_interval_s: the least wall time between two captures (4 Hz by
        default): consumers read at seconds' granularity, and a stream can
        run a cycle every few milliseconds. A throttled call costs a clock
        read and a compare; 0.0 captures every dispatch."""

    def __init__(self, capacity: int = 512, top_k: int = 8,
                 path: Optional[str] = None, keep_inputs: bool = False,
                 sample_interval_s: float = 0.25):
        self.capacity = max(1, int(capacity))
        self.top_k = max(1, int(top_k))
        self.path = path
        self.keep_inputs = keep_inputs
        self.sample_interval_s = float(sample_interval_s)
        self._last_capture = float("-inf")  # the first capture fires
        self._ring: Deque[_Sample] = deque(maxlen=self.capacity)
        self._pending: List[_Sample] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._file = open(path, "a") if path is not None else None

    # -- capture (hot path) ------------------------------------------------

    def want_sample(self) -> bool:
        """The throttle, read before any column is gathered or reduced.
        Unlocked: a racing duplicate sample is harmless and cheaper than a
        lock in the cycle loop."""
        if self.sample_interval_s <= 0.0:
            return True
        return time.monotonic() - self._last_capture >= self.sample_interval_s

    def _want(self, mesh, device) -> bool:
        """want_sample, agreed by every rank of a node-sharded pair: the
        ranks reduce together or not at all, and each reads its own clock,
        so a rank that wants the sample makes every rank take it (one
        all_reduce of a flag)."""
        want = self.want_sample()
        if mesh is None:
            return want
        import torch.distributed as dist

        flag = torch.tensor([int(want)], dtype=torch.int64, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                        group=mesh.get_group("node"))
        return bool(flag.item())

    def capture_device(self, inp, n_valid: int, source: str,
                       cycle: Optional[int] = None, names=None,
                       mesh=None) -> None:
        """Launch the reduction on the device columns and ring its result.

        The launch is asynchronous and nothing is read back here: on the
        card the stats reach pinned host memory behind an event that a
        query or a flush waits on, so a pipelined stream keeps its
        overlap. With keep_inputs the columns are cloned on their stream
        now, since the resident carry is overwritten in place by the next
        commit and scan.

        mesh: the node mesh when `inp` holds this rank's block of padded,
        node-sharded columns (the TPUSIM_SHARDS route). The reduction then
        merges across the ranks (scan.analytics_reduce_sharded, span
        shard:topk_collective), equal to the single-device reduce, and
        kept inputs are the whole columns, put together the same way."""
        from tpusim_torch.scan import analytics_reduce

        if not self._want(mesh, inp.alloc_cpu.device):
            return
        self._last_capture = time.monotonic()
        n = int(inp.alloc_cpu.shape[0])
        shard = None
        if mesh is not None:
            from tpusim_torch.scan import mesh_shard

            shard = mesh_shard(mesh, n)
            n *= shard.size
        k = max(1, min(self.top_k, n))
        if shard is None:
            stats = analytics_reduce(inp, int(n_valid), k)
        else:
            from tpusim_torch.obs import recorder as flight
            from tpusim_torch.scan import analytics_reduce_sharded

            with flight.span("shard:topk_collective", "device",
                             inp.alloc_cpu.device):
                stats = analytics_reduce_sharded(mesh, inp, int(n_valid), k)
        inputs = None
        if self.keep_inputs:
            if shard is None:
                inputs = type(inp)(*(leaf.clone() for leaf in inp))
            else:
                from tpusim_torch.scan import gather_nodes

                inputs = type(inp)(*(gather_nodes(shard, leaf)
                                     for leaf in inp))
        stats, event = _to_host_behind_event(stats)
        sample = _Sample(stats, source, cycle, round(time.time(), 3), 0,
                         names, int(n_valid), k, inputs, event)
        with self._lock:
            sample.seq = self._seq
            self._seq += 1
            self._ring.append(sample)
            if self._file is not None:
                self._pending.append(sample)
        register().analytics_samples.inc()

    # -- query and export (cold path) --------------------------------------

    def samples(self) -> List[_Sample]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            sample = self._ring[-1] if self._ring else None
        return _decode_sample(sample) if sample is not None else None

    def series(self, limit: int = 60) -> List[Dict[str, Any]]:
        """The most recent `limit` samples, decoded, oldest first."""
        with self._lock:
            tail = list(self._ring)[-max(0, limit):]
        return [_decode_sample(s) for s in tail]

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": True, "samples": self._seq,
                "capacity": self.capacity, "latest": self.latest(),
                "hbm": hbm_snapshot(), "compile": compile_snapshot()}

    def verify_against_host(self) -> List[str]:
        """Redo every kept reduction in numpy; the mismatches described
        (empty: equal). Needs keep_inputs=True."""
        problems: List[str] = []
        for sample in self.samples():
            if sample.inputs is None:
                problems.append(f"seq {sample.seq}: no inputs retained "
                                "(keep_inputs=False)")
                continue
            sample.ready()
            want = host_reduce(sample.inputs, sample.n_valid, sample.k)
            for field, expect in want.items():
                got = _host(getattr(sample.stats, field))
                if not np.array_equal(got, expect):
                    problems.append(
                        f"seq {sample.seq} [{sample.source}] {field}: "
                        f"device {got.tolist()} != host {expect.tolist()}")
        return problems

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if self._file is None or not pending:
            return
        lines = [json.dumps(_decode_sample(s), sort_keys=True,
                            separators=(",", ":")) for s in pending]
        self._file.write("\n".join(lines) + "\n")
        self._file.flush()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None


# -- the process's active instance (as provenance.install) ---------------

_active: Optional[ClusterAnalytics] = None


def install(log: ClusterAnalytics) -> ClusterAnalytics:
    global _active
    _active = log
    return log


def uninstall() -> None:
    global _active
    if _active is not None:
        _active.close()
    _active = None


def get() -> Optional[ClusterAnalytics]:
    return _active


def capture(statics, carry, n_valid: int, source: str,
            cycle: Optional[int] = None, names=None, mesh=None) -> None:
    """Reduce one (Statics, Carry) pair; a None-check when no instance is
    installed. mesh: the node mesh of a node-sharded pair (this rank's
    blocks)."""
    log = _active
    if log is None or (mesh is None and not log.want_sample()):
        return
    from tpusim_torch.scan import analytics_in

    log.capture_device(analytics_in(statics, carry), n_valid, source,
                       cycle=cycle, names=names, mesh=mesh)


# -- device residency (always on, polled at snapshot time) ---------------

def tree_nbytes(tree) -> int:
    """The bytes of every tensor or array in a nested tuple, list or dict,
    from its shape and element size: nothing is read from the device."""
    if tree is None:
        return 0
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(leaf) for leaf in tree)
    if isinstance(tree, dict):
        return sum(tree_nbytes(leaf) for leaf in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    shape = getattr(tree, "shape", None)
    dtype = getattr(tree, "dtype", None)
    if shape is None or dtype is None:
        return 0
    size = 1
    for dim in shape:
        size *= int(dim)
    return size * np.dtype(dtype).itemsize


_hbm_lock = threading.Lock()
_hbm_sources: List[Dict[str, Any]] = []


def register_hbm_source(component: str, owner, fn,
                        tenant: str = "default") -> None:
    """Register a residency source polled at snapshot time: `fn(owner) ->
    (bytes, entries)`, or `fn()` for a process-wide source (owner None).
    The owner is held weakly: a collected owner drops its source, so
    sessions and executors need no teardown."""
    entry = {"component": component, "tenant": tenant, "fn": fn,
             "ref": weakref.ref(owner) if owner is not None else None}
    with _hbm_lock:
        _hbm_sources.append(entry)


def hbm_snapshot() -> Dict[str, Any]:
    """component -> {bytes, entries, tenants: {tenant: bytes}} over the
    live sources, pruning the dead ones."""
    with _hbm_lock:
        sources = list(_hbm_sources)
    out: Dict[str, Any] = {}
    dead: List[Dict[str, Any]] = []
    for entry in sources:
        owner = None
        if entry["ref"] is not None:
            owner = entry["ref"]()
            if owner is None:
                dead.append(entry)
                continue
        try:
            nbytes, entries = (entry["fn"](owner) if entry["ref"] is not None
                               else entry["fn"]())
        except Exception:
            continue  # a source mid-teardown must not break a snapshot
        slot = out.setdefault(entry["component"],
                              {"bytes": 0, "entries": 0, "tenants": {}})
        slot["bytes"] += int(nbytes)
        slot["entries"] += int(entries)
        tenants = slot["tenants"]
        tenants[entry["tenant"]] = (tenants.get(entry["tenant"], 0)
                                    + int(nbytes))
    if dead:
        with _hbm_lock:
            for entry in dead:
                if entry in _hbm_sources:
                    _hbm_sources.remove(entry)
    return out


def _built_programs_source() -> Tuple[int, int]:
    """The port's built programs: CUDA graphs the scans captured, the
    batched programs whatif built and the kernel libraries loaded. Their
    sizes are not exposed, so bytes stay 0. A module never imported has
    built nothing and is not imported here."""
    entries = 0
    scan = sys.modules.get("tpusim_torch.scan")
    if scan is not None:
        entries += scan.graphs_captured()
    whatif = sys.modules.get("tpusim_torch.whatif")
    if whatif is not None:
        entries += whatif.compile_count()
    build = sys.modules.get("tpusim_torch.kernels.build")
    if build is not None:
        entries += len(build._LOADED)
    return (0, entries)


register_hbm_source("compiled_executables", None, _built_programs_source)


# -- compile cost (always on; compiles are cold by nature) ---------------

_compile_lock = threading.Lock()
_compile_costs: Dict[Tuple[str, str], Dict[str, float]] = {}


def note_compile(site: str, signature, latency_us: float,
                 traces: int = 1) -> None:
    """Add `traces` builds and their wall to (site, signature)."""
    key = (site, str(signature))
    with _compile_lock:
        slot = _compile_costs.setdefault(key, {"traces": 0, "total_us": 0.0})
        slot["traces"] += traces
        slot["total_us"] += float(latency_us)
    reg = register()
    reg.compile_traces.inc(site, traces)
    reg.compile_cost.inc(site, float(latency_us))


def compile_snapshot() -> Dict[str, Any]:
    """site -> {traces, total_us, signatures: {sig: {traces, total_us}}}."""
    with _compile_lock:
        items = [(key, dict(slot)) for key, slot in _compile_costs.items()]
    out: Dict[str, Any] = {}
    for (site, sig), slot in items:
        site_slot = out.setdefault(site, {"traces": 0, "total_us": 0.0,
                                          "signatures": {}})
        site_slot["traces"] += slot["traces"]
        site_slot["total_us"] += slot["total_us"]
        site_slot["signatures"][sig] = slot
    return out


def reset_compile_costs() -> None:
    """Isolation between tests and runs."""
    with _compile_lock:
        _compile_costs.clear()


# -- gauges (refreshed when read) ----------------------------------------

def refresh_gauges() -> None:
    """Fold the latest sample and the residency sources into the
    tpusim_cluster_* and tpusim_hbm_* gauges: called before the registry
    is written out."""
    reg = register()
    for component, slot in hbm_snapshot().items():
        reg.hbm_resident_bytes.set(component, slot["bytes"])
        reg.hbm_cache_entries.set(component, slot["entries"])
    log = _active
    if log is None:
        return
    latest = log.latest()
    if latest is None:
        return
    for name, row in latest["resources"].items():
        if row["utilization"] is not None:
            reg.cluster_utilization.set(name, row["utilization"])
        reg.cluster_fragmentation.set(name, row["fragmentation"])
    reg.cluster_feasible_nodes.set(latest["nodes"]["feasible"])
    reg.cluster_nodes.set(latest["nodes"]["valid"])


def read_jsonl(path: str):
    """The samples of an --analytics-out file, in file order."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)
