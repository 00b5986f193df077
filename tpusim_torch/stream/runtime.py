"""The streaming twin: the compiled cluster resident on the device across
scheduling cycles, and O(delta) commits of each cycle's watch events.

  DeviceResidentCluster: the compiled statics and carry held on the device
      across decisions, with the host-side facts that prove a new batch can
      reuse them (the resident signature-row interning, the node count and
      the scalar width), and one built scan program (scan.ResidentScan) a
      pod bucket, bound to those tensors. A cycle's watch events land as
      in-place sets of the touched rows (scan.apply_delta_) gathered from
      the IncrementalCluster's journal, so a warm cycle's update is
      O(touched rows), not O(nodes).
  StreamSession: drives events -> commit -> schedule -> fold-back. The scan
      binds into the resident carry itself (its final carry IS the post-bind
      state), so the fold-back's journal entries are dropped, not
      committed again. What a commit cannot express (node churn, a dirty
      group table, an evicted signature row, a new scalar) restages,
      classified in restage_counts.

Exactness contract: the placements of the resident path are byte-identical
(placement_hash) to scheduling every batch through a full compile
(TorchBackend.schedule) over any event sequence. The host IncrementalCluster
stays the source of truth; commits SET its authoritative values (idempotent,
self-healing); each commit re-arms the per-batch lanes (sa_lock, rr) as a
restage's carry_init_host does, the ServiceAffinity locks of a policy
recomputed from the live pods; a field without a commit path
(presence_dom, used_vols, the group tables) changes only under events that
restage. Label- and taint-only node churn lands as a statics commit
(scan.apply_statics_delta_): signature rows gathered from the host memo,
policy rows recomputed against the RESIDENT interning; only a real change
of plan restages (policy_plan_change).

Pipelined cycles (schedule_pipelined / poll_placed / flush) keep the
contract: cycle N's scan is launched without waiting for it, cycle N-1 is
decoded meanwhile, and N-1's binds are folded back BEFORE the driver draws
N's events, so the host picture evolves in the synchronous order. Each
cycle's outputs go to pinned host memory behind an event before the next
cycle's scan can overwrite the device buffers. A cycle that cannot ride
the resident path (a restage, a gang, no nodes) drains the pipeline and
runs synchronously.

No cycle silently leaves the device: a device error raises, and a cycle
reaches the host route only when the compile classifies its workload
unsupported ("reference_fallback", counted in path_counts["host"]), or while
a chaos plan's device section is installed (backend.install_chaos): then
every cycle's dispatch runs behind the circuit breaker and the fault
injector (_run_guarded), a denied or faulted dispatch and a divergence under
verification are answered by the host pipeline, each classified
(breaker_open, device_fault, verify_divergence) and counted, and any
intervention drops residency, so the next cycle restages from host truth by
copying into the resident tensors. Pipelined cycles run synchronously while
the seam is armed.

With a stream.persist.StreamPersistence attached (attach_persistence),
every committed watch delta, batch, bind and emission is journaled to its
WAL on every emission path (synchronous, host, gang and pipelined cycles).

The session's events may come from a watch fabric instead of the caller:
watch() attaches a framework.reflector.Reflector to a FakeRESTClient
stream and sync() drains every attached one; a stream torn by overflow
relists, and the relist forces a restage classified "watch_expired" (the
first reason wins), as does a torn stream given to ingest().

Node sharding: with TPUSIM_SHARDS=k and a default process group of k
ranks, every rank runs the same session (SPMD) and each restage decides the
layout again (_decide_shard_layout): a config the sharded route serves is
staged node-sharded, each rank holding one contiguous block of the padded
node axis and every pod's columns (span shard:stage, after the ranks'
host digests agree), and scans with the sharded step, eagerly (span
shard:scan); anything else stays single-device, the reason counted in
tpusim_shard_fallback_total. The host journal holds global node indices:
commits, label and taint churn and overlay rollbacks set only the rows of
this rank's block, and the replicated lanes (presence_dom, rr, sa_lock)
alike on every rank. A twin's mesh_tag gives it process groups of its own.

With a flight recorder installed the runtime records the JAX package's
spans (stream_ingest, stream_commit, statics_commit, compile_cluster,
device_dispatch, decode_placements, stream_overlap, stream_decode and the
overlay_* spans) and, around the host's own work, the port's
stream_route (residency, the batch's columns and their remaps),
commit_gather (the journal's rows, the lock lanes), stream_pack (the pod
rows) and stream_foldback (the binds folded back, the journal, the WAL's
bind and emit records), each cycle under a trace context of its own
(obs/tracectx.py; a pipelined cycle's decode and fold-back under its
dispatch's context); every cycle counts in
tpusim_stream_cycles_total{path} and its latency in
tpusim_stream_cycle_latency_us{path} (with its trace id as an exemplar
when traced), judged by an armed SLO tracker (obs/slo.py), every restage
in tpusim_stream_restage_total{reason}.
"""

from __future__ import annotations

import logging
from contextlib import nullcontext
from dataclasses import replace
from time import perf_counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod, ResourceType
from tpusim_torch import backend as _backend
from tpusim_torch.backend import (
    _KNOWN_PROVIDERS,
    _MOST_REQUESTED_PROVIDERS,
    DEFAULT_PROVIDER,
    TorchBackend,
    decode_placements,
    unsupported_detail,
)
from tpusim_torch.backends import (
    Placement,
    ReferenceBackend,
    bind_pod,
    mark_unschedulable,
    placement_hash,
)
from tpusim_torch.config import config_for
from tpusim_torch.delta import _SIG_KINDS, IncrementalCluster
from tpusim_torch.device import resolve_device
from tpusim_torch.framework.events import WatchExpiredError
from tpusim_torch.framework.metrics import register, since_in_microseconds
from tpusim_torch.framework.reflector import Reflector
from tpusim_torch.framework.store import MODIFIED
from tpusim_torch.gang.driver import schedule_with_gangs
from tpusim_torch.gang.group import has_gangs
from tpusim_torch.obs import analytics, provenance, slo, tracectx
from tpusim_torch.obs import recorder as flight
from tpusim_torch.policyc import (
    build_policy_residency,
    build_policy_tables,
    compile_policy,
    policy_delta_columns,
    policy_plan_key,
    remap_policy_columns,
    sa_lock_init_rows,
)
from tpusim_torch.scan import (
    GRAPH_STEPS,
    DeltaRows,
    ResidentScan,
    StaticsDelta,
    apply_delta_,
    apply_statics_delta_,
    carry_init_host,
    mesh_shard,
    overlay_restore_,
    pad_infeasible_rows,
    pod_columns_to_host,
    statics_to_host,
    tree_to,
)
from tpusim_torch.state import reason_strings

log = logging.getLogger(__name__)

# Commit and pod-batch axes are padded up to pow2 buckets (floor 8), so a
# warm steady state cycles through a handful of built programs (one
# ResidentScan a pod bucket) instead of one per delta count.
MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Smallest pow2 >= n, floored at MIN_BUCKET."""
    return max(MIN_BUCKET, 1 << max(0, n - 1).bit_length())


def _pad_index(idx: np.ndarray, size: int) -> np.ndarray:
    """`idx` padded to `size` by repeating its first entry (0 when empty):
    the commits set authoritative values, so a duplicate writes what its
    original writes."""
    if len(idx) >= size:
        return idx
    fill = idx[0] if len(idx) else 0
    return np.concatenate([idx, np.full(size - len(idx), fill, np.int64)])


def _delta_rows(inc: IncrementalCluster, nodes) -> tuple:
    """(padded node indices, DeltaRows): the host's authoritative dynamic
    rows of `nodes`."""
    idx = np.fromiter(sorted(nodes), dtype=np.int64, count=len(nodes))
    idx = _pad_index(idx, bucket_size(max(len(idx), 1)))
    dyn = inc._ensure_dyn()
    return idx, DeltaRows(*(getattr(dyn, name)[idx]
                            for name in DeltaRows._fields))


def _presence_cells(inc: IncrementalCluster, cells) -> tuple:
    """(gid, nid, val), padded: the host's authoritative presence of the
    (group, node) `cells`."""
    cell_list = sorted(cells)
    gid = np.fromiter((g for g, _ in cell_list), np.int64, len(cell_list))
    nid = np.fromiter((n for _, n in cell_list), np.int64, len(cell_list))
    size = bucket_size(max(len(gid), 1))
    gid, nid = _pad_index(gid, size), _pad_index(nid, size)
    if inc._presence is not None:
        val = inc._presence[gid, nid].astype(np.int32)
    else:
        # a trivial [1, N] presence: the padded (0, 0) cells are zeros on
        # both sides
        val = np.zeros(size, np.int32)
    return gid, nid, val


# the statics a scan program reads once, when it is built (scan._Const)
_BUILD_TIME_STATICS = ("vol_type", "anti_key", "pref_key", "aff_key")


class _Fetch:
    """The first p rows of a scan's choices and counts on their way to the
    host. On a CUDA device they are copied into pinned memory behind an
    event, so nothing waits until get() reads them, and the next scan may
    be launched at once: the copy is ordered before it on the stream."""

    def __init__(self, out, p: int):
        choices, counts = out.choices[:p], out.counts[:p]
        self.event = None
        if choices.device.type == "cuda":
            self.choices = torch.empty(choices.shape, dtype=choices.dtype,
                                       pin_memory=True)
            self.counts = torch.empty(counts.shape, dtype=counts.dtype,
                                      pin_memory=True)
            self.choices.copy_(choices, non_blocking=True)
            self.counts.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.choices, self.counts = choices.clone(), counts.clone()

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return self.choices.numpy(), self.counts.numpy()


class DeviceResidentCluster:
    """The device half of the twin: the compiled statics and carry held on
    the device across decisions, the scan programs bound to them, and the
    host-side metadata that proves a new batch can reuse them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.compiled = None        # the restage's host CompiledCluster
        self.config = None          # its EngineConfig
        self.statics = None         # scan.Statics on the device
        self.carry = None           # scan.Carry on the device: THE state
        self.sig_rows: Optional[Dict[str, Dict[object, int]]] = None
        self.plan_key = None        # policyc.policy_plan_key of the restage
        self.ptabs = None           # the restage's host PolicyTables
        self.pol_res = None         # policyc.PolicyResidency interning
        self.n_nodes = 0
        self.scalar_width = 0
        self.evictions_mark = 0     # inc.sig_evictions at adopt time
        self.commits = 0            # delta commits since construction
        # the node-sharded twin: the mesh this rank's block lies on and
        # the block (scan.Shard); None for the single-device twin
        self.mesh = None
        self.shard = None
        self._programs: Dict[int, ResidentScan] = {}

    @property
    def valid(self) -> bool:
        return self.compiled is not None

    def invalidate(self) -> None:
        """Drop residency. The tensors and their programs stay: a restage
        of the same config and shapes copies into them and replays the
        graphs already captured."""
        self.compiled = self.sig_rows = None
        self.plan_key = self.ptabs = self.pol_res = None

    def graphs(self) -> int:
        """The CUDA graphs captured for this twin's scan programs."""
        return sum(1 for program in self._programs.values()
                   if program.graph_captured)

    def release(self) -> None:
        """Drop residency and the device memory behind it: the tensors,
        and the programs whose graphs are bound to them (each graph's
        private pool with it). The next cycle restages onto new tensors."""
        self.invalidate()
        self.config = self.statics = self.carry = None
        self.mesh = self.shard = None
        self._programs = {}

    def stage(self, config, statics_host, carry_host, mesh=None) -> None:
        """Load a restage's host trees (scan.Statics and scan.Carry of
        numpy arrays) into the resident tensors: copied into the tensors
        there are when the config, the mesh and every shape agree, else
        onto new tensors, which drops the programs bound to the old ones.

        With `mesh` (a TPUSIM_SHARDS node mesh) the node axis is padded to
        the shard multiple and this rank keeps its contiguous block of it
        (sharding.node_blocks); every other axis stays whole on every
        rank."""
        if mesh is not None:
            from tpusim_torch.sharding import node_blocks

            statics_host, carry_host = node_blocks(mesh, statics_host,
                                                   carry_host)
        same = (self.statics is not None and config == self.config
                and mesh is self.mesh
                and all(t.shape == np.shape(h) for t, h in
                        zip(self.statics + self.carry,
                            tuple(statics_host) + tuple(carry_host)))
                # a program tabulates these at build time (scan._Const)
                and all(np.array_equal(getattr(self.statics, name).cpu(),
                                       getattr(statics_host, name))
                        for name in _BUILD_TIME_STATICS))
        if same:
            for t, h in zip(self.statics + self.carry,
                            tuple(statics_host) + tuple(carry_host)):
                t.copy_(torch.as_tensor(np.asarray(h)))
            return
        self.config = config
        self.statics = tree_to(statics_host, self.device, index=True)
        self.carry = tree_to(carry_host, self.device)
        self.mesh = mesh
        self.shard = (None if mesh is None else
                      mesh_shard(mesh, self.statics.alloc_cpu.shape[0]))
        self._programs = {}

    def scan(self, xs_host):
        """Scan a bucket of pods (host numpy columns, padded to the bucket)
        on the resident state in place: the program's output buffers. On
        the node-sharded twin every rank scans every pod over its block,
        eagerly (span shard:scan); the choices are global node indices."""
        bucket = int(np.asarray(xs_host.req_cpu).shape[0])
        program = self._programs.get(bucket)
        if program is None:
            program = ResidentScan(self.config, self.carry, self.statics,
                                   bucket, graph_steps=GRAPH_STEPS,
                                   shard=self.shard)
            self._programs[bucket] = program
        if self.shard is None:
            return program.run(xs_host)
        with flight.span("shard:scan", "device", self.device) as sp:
            out = program.run(xs_host)
            if sp:
                sp.set("shards", self.shard.size)
                sp.set("pods", bucket)
        return out

    def adopt(self, inc: IncrementalCluster, compiled, plan_key=None,
              ptabs=None, pol_res=None) -> None:
        """Declare the staged state, scanned over the restage's batch,
        resident."""
        self.compiled = compiled
        # the resident signature-row order per kind: later batches' ids are
        # remapped onto the resident table rows through these
        self.sig_rows = {kind: {key: row for row, key in enumerate(keys)}
                         for kind, keys in inc.last_batch_key_lists.items()}
        self.plan_key = plan_key
        self.ptabs = ptabs
        self.pol_res = pol_res
        self.n_nodes = len(compiled.statics.names)
        self.scalar_width = len(compiled.scalar_names)
        self.evictions_mark = inc.sig_evictions

    def residency_miss(self, inc: IncrementalCluster,
                       plan_key=None) -> Optional[str]:
        """The structural reason the resident state cannot serve the next
        cycle, or None. The order is the classification's: node events also
        dirty the group tables, so the node set is tested first; a change of
        plan outranks everything but a cold start."""
        if not self.valid:
            return "cold_start"
        if plan_key != self.plan_key:
            return "policy_plan_change"
        if len(inc.nodes) != self.n_nodes:
            return "node_set"
        if inc._groups_dirty:
            return "groups_dirty"
        if len(inc._scalar_names) != self.scalar_width:
            return "scalar_set"
        return None

    def remap_signatures(self, inc: IncrementalCluster, cols,
                         key_lists: Dict[str, List]) -> Optional[str]:
        """Rewrite the batch's batch-local signature ids into resident table
        rows in place. None on success, or the restage reason of a
        signature the resident tables have no row for ("sig_evict" when the
        memo evicted rows since the restage, as the miss may be memo
        pressure, not novelty)."""
        luts = {}
        for kind, keys in key_lists.items():
            resident = self.sig_rows[kind]
            try:
                luts[kind] = np.fromiter((resident[k] for k in keys),
                                         dtype=np.int32, count=len(keys))
            except KeyError:
                return ("sig_evict"
                        if inc.sig_evictions > self.evictions_mark
                        else "new_signature")
        for kind, lut in luts.items():
            col = getattr(cols, kind)
            col[:] = lut[col]
        return None

    def commit(self, inc: IncrementalCluster,
               sa_lock_init: Callable[[], np.ndarray]) -> None:
        """Drain the IncrementalCluster's journal and set the authoritative
        values of every touched node row and presence cell into the
        resident carry, in place. Runs even with an empty journal, as the
        commit also re-arms the per-batch lanes to what a restage would
        stage (`sa_lock_init()`: all unlocked for a provider, the live
        first-matching-pod pins under ServiceAffinity; rr 0). The host's
        gathering runs in span commit_gather, the carry's update in
        stream_commit."""
        gsp = flight.span("commit_gather")
        sa_lock = sa_lock_init()
        nodes, cells = inc.drain_journal()
        idx, rows = _delta_rows(inc, nodes)
        if gsp:
            gsp.set("rows", int(len(nodes)))
            gsp.end()
        sp = flight.span("stream_commit", "device", self.device)
        apply_delta_(self.carry, idx, rows, *_presence_cells(inc, cells),
                     sa_lock, shard=self.shard)
        if sp:
            sp.set("rows", int(len(nodes)))
            sp.set("cells", int(len(cells)))
            sp.end()
        self.commits += 1


class _PendingCycle:
    """One pipelined cycle in flight (its outputs on their way to the
    host), or one run synchronously and buffered for emission order."""

    __slots__ = ("pods", "fetch", "compiled", "folded", "choices", "counts",
                 "bound", "placements", "t0", "dispatched_at", "wal_cycle",
                 "trace")

    def __init__(self, pods, fetch=None, compiled=None, placements=None,
                 t0: float = 0.0, dispatched_at: float = 0.0,
                 wal_cycle: Optional[int] = None):
        self.pods = pods
        self.fetch = fetch
        self.compiled = compiled
        self.t0 = t0
        self.dispatched_at = dispatched_at
        self.folded = placements is not None
        self.choices = self.counts = None
        self.bound: List[Placement] = []
        self.placements = placements
        # the WAL cycle id with a persistence layer attached; None for a
        # buffered synchronous cycle (schedule() journaled it already)
        self.wal_cycle = wal_cycle
        # the dispatching cycle's trace context: the deferred decode runs
        # under THIS cycle's trace, not the overlapping cycle's
        self.trace = tracectx.current()


class StreamSession:
    """Drives the streaming loop: apply watch events -> commit -> schedule
    on the resident state -> fold the placements back.

    Providers and compiled policies stay resident, keyed on the policy's
    plan; a workload the compile classifies unsupported (a policy's
    extenders, a claim the host resolves per pod) runs its cycle on the
    host route, counted."""

    def __init__(self, snapshot: Optional[ClusterSnapshot] = None, *,
                 incremental: Optional[IncrementalCluster] = None,
                 provider: str = DEFAULT_PROVIDER,
                 hard_pod_affinity_symmetric_weight: int = 10,
                 always_restage: bool = False,
                 policy=None, compiled_policy=None, device="cuda",
                 mesh_tag: str = ""):
        """always_restage: no resident path, every cycle pays the full
        compile and staging (the comparison arm; placements are identical).
        policy / compiled_policy: a scheduler Policy, compiled here unless
        given compiled; set_policy swaps it (a change of plan restages
        once). device: "cuda" (the default) or "cpu". mesh_tag: the process
        groups of the twin's TPUSIM_SHARDS node mesh (sharding.make_mesh;
        "" the default group's mesh): two twins of one process whose cycles
        run on two threads need two."""
        if provider not in _KNOWN_PROVIDERS:
            raise KeyError(f"plugin {provider!r} has not been registered")
        if policy is not None and compiled_policy is None:
            compiled_policy = compile_policy(policy)
        self.torch_device = resolve_device(device)
        self.inc = (incremental if incremental is not None
                    else IncrementalCluster(snapshot))
        self.provider = provider
        self.hard_weight = hard_pod_affinity_symmetric_weight
        self.always_restage = always_restage
        self.policy = policy
        self.cp = compiled_policy
        self._plan_key = policy_plan_key(compiled_policy)
        self.device = DeviceResidentCluster(self.torch_device)
        self.cycles = 0
        self.restage_counts: Dict[str, int] = {}
        self.path_counts: Dict[str, int] = {}
        self._forced: Optional[str] = None
        self._reflectors: List[Reflector] = []
        self._statics_patch = None    # (padded idx, StaticsDelta) or None
        self._pending: Optional[_PendingCycle] = None
        self._gang_torch = None       # TorchBackend of the gang cycles
        self._last_path = ""
        self.persist = None           # stream.persist.StreamPersistence
        # the node-sharded residency (TPUSIM_SHARDS=k, decided at every
        # restage): its mesh, and the layout a checkpoint records
        self.mesh_tag = mesh_tag
        self._shard_layout: Optional[Dict[str, int]] = None
        # device residency, polled at snapshot time only; the weak
        # reference drops the source with the session
        analytics.register_hbm_source(
            "stream_twin", self.device,
            lambda dev: (analytics.tree_nbytes((dev.statics, dev.carry)),
                         1 if dev.valid else 0))

    def set_policy(self, policy=None, compiled_policy=None) -> None:
        """Swap the session's policy. The next cycle restages once,
        classified policy_plan_change, unless the new plan is the resident
        one."""
        if policy is not None and compiled_policy is None:
            compiled_policy = compile_policy(policy)
        self.policy = policy
        self.cp = compiled_policy
        self._plan_key = policy_plan_key(compiled_policy)

    # -- events -----------------------------------------------------------

    def apply(self, event_type: str, obj) -> None:
        self.inc.apply(event_type, obj)

    def apply_events(self, events) -> None:
        """Fold a cycle's watch events into the host picture (span
        stream_ingest)."""
        with flight.span("stream_ingest") as sp:
            if sp:
                events = list(events)
                sp.set("events", len(events))
            self.inc.apply_events(events)

    def ingest(self, watch_buffer) -> int:
        """Drain a WatchBuffer into the host picture (span stream_ingest).
        A torn stream (the 410 Gone analog) forces a restage on the next
        cycle and raises again, so the caller can relist (or use watch()
        and sync(), which do)."""
        with flight.span("stream_ingest") as sp:
            try:
                n = self.inc.ingest(watch_buffer)
            except WatchExpiredError:
                self.force_restage("watch_expired")
                raise
            if sp:
                sp.set("events", n)
        return n

    def watch(self, client, resource: ResourceType, **kwargs) -> Reflector:
        """Attach a Reflector stream feeding this session; its relists
        after a torn stream force a restage (the synthetic diff they
        replay may not be expressible as a commit)."""
        r = Reflector(client, resource, handler=self.inc.apply,
                      on_relist=lambda _n: self.force_restage("watch_expired"),
                      **kwargs)
        self._reflectors.append(r)
        return r

    def sync(self) -> int:
        """Drain every attached Reflector; returns the events applied."""
        return sum(r.sync() for r in self._reflectors)

    def force_restage(self, reason: str) -> None:
        """Drop residency before the next cycle (the first reason wins)."""
        if self._forced is None:
            self._forced = reason

    # -- persistence (stream.persist) -------------------------------------

    def attach_persistence(self, persistence) -> None:
        """Journal this session's committed deltas, batches, binds and
        emissions through a StreamPersistence (WAL and checkpoints)."""
        persistence.attach(self)

    def _persist_suppressed(self):
        """Gate the WAL's watch-delta hook around fold-back binds: binds are
        journaled as bind records, not as synthetic MODIFIED events."""
        return (self.persist.suppress_events() if self.persist is not None
                else nullcontext())

    # -- the cycle --------------------------------------------------------

    def schedule(self, pods: List[Pod], _routed=None) -> List[Placement]:
        """One decision cycle: the batch on the resident path where
        residency holds, else a classified restage; the scheduled
        placements folded back into the host picture. `_routed`: the
        (reason, cols) of a _route call this cycle made already
        (schedule_pipelined's synchronous degrade); routing consumes the
        forced latch and the column journal, so it is not repeated."""
        if not pods:
            return []
        # one trace context a decision cycle: every span the cycle emits
        # carries its id. A context already active (serve's front door, the
        # stream driver's cycle) is its parent; start() is None, and
        # activate a no-op, unless a flight recorder is installed
        with tracectx.activate(tracectx.start(parent=tracectx.current())):
            return self._schedule_cycle(pods, _routed)

    def _schedule_cycle(self, pods: List[Pod], _routed=None
                        ) -> List[Placement]:
        self.cycles += 1
        inc = self.inc
        t0 = perf_counter()
        cid = (self.persist.begin_cycle(pods)
               if self.persist is not None else None)
        if not inc.nodes:
            msg = "no nodes available to schedule pods"
            placements = [Placement(pod=mark_unschedulable(p, msg),
                                    reason="Unschedulable", message=msg)
                          for p in pods]
            self._note_path("no_nodes", len(pods))
            if cid is not None:
                self.persist.log_bind(cid, [])
                self.persist.log_emit(cid, placements)
            self._observe_cycle("no_nodes", t0)
            return placements
        if has_gangs(pods):
            placements = self._gang_cycle(pods, cid)
            self._observe_cycle("gang", t0)
            return placements
        reason, cols = _routed if _routed is not None else self._route(pods)
        if reason is None:
            placements = self._stream_cycle(pods, cols)
        else:
            placements = self._restage_cycle(pods, reason)
        sp = flight.span("stream_foldback")
        bound = [pl for pl in placements if pl.node_name]
        with self._persist_suppressed():
            for pl in bound:
                inc.apply(MODIFIED, pl.pod)
        if self.device.valid:
            # the scan applied these binds to the resident carry already,
            # with the same integer arithmetic: committing the fold-back's
            # journal next cycle would set the bytes it holds
            inc.drain_journal()
        if cid is not None:
            self.persist.log_bind(cid, bound)
            self.persist.log_emit(cid, placements)
        if sp:
            sp.set("bound", len(bound))
            sp.end()
        self._observe_cycle(self._last_path, t0)
        return placements

    def _gang_cycle(self, pods: List[Pod], cid=None) -> List[Placement]:
        """A batch with gangs: the gang driver against the live host
        picture (member lanes, joint packing, all or nothing). The driver
        applies its binds to `inc`, so they sit in the journal and the NEXT
        cycle's commit carries them onto the resident carry like any other
        churn: residency holds, nothing restages. The WAL hook is off
        around the driver: its binds are journaled as a bind record."""
        with self._persist_suppressed():
            placements = schedule_with_gangs(self._gang_backend(), self.inc,
                                             pods, source="stream-gang")
        self._note_path("gang", len(pods))
        if cid is not None:
            self.persist.log_bind(cid, [pl for pl in placements
                                        if pl.node_name])
            self.persist.log_emit(cid, placements)
        return placements

    def _gang_backend(self) -> TorchBackend:
        """The gang cycles' backend on the session's device: the driver's
        ungrouped segments and member lanes run on fresh compiles, not on
        the resident state (a gang decision takes its own picture)."""
        if self._gang_torch is None:
            self._gang_torch = TorchBackend(
                provider=self.provider, device=self.torch_device,
                hard_pod_affinity_symmetric_weight=self.hard_weight,
                policy=self.policy, mesh_tag=self.mesh_tag)
        return self._gang_torch

    def _route(self, pods: List[Pod]):
        """Resident path or restage for a batch: (None, cols) when the
        resident state can serve it, else (reason, cols or None). Consumes
        the forced-restage latch and the column journal (a restage rebuilds
        everything, so a dropped patch is harmless)."""
        sp = flight.span("stream_route")
        inc = self.inc
        reason = self._forced
        self._forced = None
        if reason is None and self.always_restage:
            reason = "forced_restage"
        if reason is None:
            reason = self.device.residency_miss(inc, self._plan_key)
        cols = None
        if reason is None:
            cols, key_lists = inc._batch_columns(pods)
            if len(inc._scalar_names) != self.device.scalar_width:
                # the batch itself widened the scalar universe
                reason = "scalar_set"
            else:
                reason = self.device.remap_signatures(inc, cols, key_lists)
            if reason is None and not inc.assign_group_ids(cols, pods):
                reason = "group_shape"
            if reason is None and self.device.config.has_interpod \
                    and inc._journal_presence:
                # presence_dom has no commit path: presence churn under
                # inter-pod terms rebuilds it on the host
                reason = "interpod_delta"
            if reason is None and self.cp is not None:
                # the per-pod policy columns against the RESIDENT interning
                # (image multisets, ServiceAffinity pins)
                reason = remap_policy_columns(self.cp, self.device.pol_res,
                                              pods, cols)
            if reason is None:
                reason = self._prepare_statics_delta()
        if sp:
            sp.set("pods", len(pods))
            if reason is not None:
                sp.set("reason", reason)
            sp.end()
        return reason, cols

    # -- paths ------------------------------------------------------------

    def _prepare_statics_delta(self) -> Optional[str]:
        """Turn the column journal (label- or taint-only node churn) into a
        pending statics commit: the churned nodes' authoritative columns,
        gathered from the host signature-row memo (patched in place by the
        node event, so current) and recomputed against the RESIDENT policy
        interning. The restage reason where the resident tables cannot
        express them (an evicted signature row with no representative, a
        label value outside the resident domains), else None with the patch
        staged for the next dispatch."""
        inc = self.inc
        dev = self.device
        touched = inc.drain_column_journal()
        if not touched:
            return None
        n = len(touched)
        idx = _pad_index(np.fromiter(sorted(touched), np.int64, count=n),
                         bucket_size(n))
        u = len(idx)
        cols: Dict[str, np.ndarray] = {}
        for col_kind, _fn, table_kinds in _SIG_KINDS:
            keys_by_row = sorted(dev.sig_rows[col_kind].items(),
                                 key=lambda kv: kv[1])
            for tk in table_kinds:
                if tk == "taint_ok_noexec" \
                        and not dev.compiled.has_noexec_table:
                    # the resident table is compile()'s all-pass dummy
                    cols[tk] = np.ones((max(len(keys_by_row), 1), u),
                                       dtype=bool)
                    continue
                fn, dtype = inc._row_fns[tk]
                out = np.zeros((max(len(keys_by_row), 1), u), dtype=dtype)
                for sig_key, row in keys_by_row:
                    memo = inc._sig_rows.get((tk, sig_key))
                    if memo is not None:
                        out[row] = memo[idx]
                        continue
                    rep = inc._sig_reps.get(sig_key)
                    if rep is None:
                        return "sig_evict"
                    out[row] = np.fromiter((fn(rep, int(i)) for i in idx),
                                           dtype=dtype, count=u)
                cols[tk] = out
        st = dev.statics
        shapes = (st.label_ok.shape[0], st.image_score.shape[0],
                  st.saa_dom.shape[0], st.sa_val.shape[0])
        pol = policy_delta_columns(self.cp, dev.pol_res, dev.ptabs,
                                   inc.nodes, idx, shapes)
        if isinstance(pol, str):
            return pol
        label_ok, label_prio, image_score, saa_dom, sa_val = pol
        self._statics_patch = (idx, StaticsDelta(
            label_ok=label_ok, label_prio=label_prio,
            image_score=image_score, saa_dom=saa_dom, sa_val=sa_val,
            **{tk: cols[tk] for _k, _f, kinds in _SIG_KINDS
               for tk in kinds}))
        return None

    def _commit_sa_lock(self) -> np.ndarray:
        """The sa_lock a restage would stage NOW: the live first-matching-
        pod pins under ServiceAffinity (in the cache's pod order, which
        inc._pods keeps), all unlocked otherwise."""
        dev = self.device
        if self.cp is not None and self.cp.spec.sa_enabled:
            return sa_lock_init_rows(dev.compiled.groups.saa_defs,
                                     list(self.inc._pods.values()),
                                     dev.compiled.node_index)
        return np.full(dev.compiled.groups.saa_rows.shape[0], -1,
                       dtype=np.int32)

    def _apply_statics_patch(self) -> None:
        """Set the pending label and taint churn columns into the resident
        statics, in place."""
        if self._statics_patch is None:
            return
        idx, delta = self._statics_patch
        self._statics_patch = None
        sp = flight.span("statics_commit", "device", self.torch_device)
        apply_statics_delta_(self.device.statics, idx, delta,
                             shard=self.device.shard)
        if sp:
            sp.set("cols", int(len(idx)))
            sp.end()

    def _commit(self) -> None:
        """Commit the pending churn (label and taint columns, then the
        journal's rows and cells) into the resident state."""
        self._apply_statics_patch()
        self.device.commit(self.inc, self._commit_sa_lock)

    @staticmethod
    def _xs_host(pods: List[Pod], cols):
        """The batch's pod rows on the host, padded to its bucket (span
        stream_pack)."""
        p = len(pods)
        with flight.span("stream_pack") as sp:
            if sp:
                sp.set("pods", p)
            return pad_infeasible_rows(pod_columns_to_host(cols),
                                       bucket_size(p) - p)

    def _dispatch(self, pods: List[Pod], xs_host, compiled
                  ) -> Tuple[List[Placement], bool]:
        """Scan the batch on the resident state and wait for its choices
        on the host (the device_dispatch span), then decode. The decoded
        batch goes to the provenance log, and the post-scan state to the
        analytics plane: one more reduction on the stream before the next
        commit, outside the scan's graph. Returns (placements, intervened):
        `intervened` flags a scripted corruption of this dispatch, whose
        emitted results may not be the device's own decisions, so residency
        must drop.

        Under an installed chaos seam a scripted exception raises before the
        scan; a scripted corruption applies to the host copies of the real
        pods' outputs, and the structural checks run on them."""
        metrics = register()
        injector = _backend._CHAOS["injector"]
        corrupt_kind = (injector.begin_dispatch() if injector is not None
                        else None)
        t0 = perf_counter()
        dsp = flight.span("device_dispatch", "device", self.torch_device)
        out = self.device.scan(xs_host)
        choices, counts = _Fetch(out, len(pods)).get()
        if injector is not None:
            if corrupt_kind is not None:
                from tpusim_torch.chaos.engine import DeviceInjector

                choices, counts = DeviceInjector.corrupt(corrupt_kind,
                                                         choices, counts)
            _backend.check_device_output(choices, counts,
                                         len(compiled.statics.names))
        if dsp:
            dsp.set("pods", len(pods))
            dsp.end()
        metrics.backend_dispatch_latency.observe(since_in_microseconds(t0))
        metrics.scheduling_algorithm_latency.observe(
            since_in_microseconds(t0))
        with flight.span("decode_placements"):
            placements = self._decode(pods, choices, counts, compiled)
        provenance.capture(placements, "stream", cycle=self.cycles)
        dev = self.device
        analytics.capture(dev.statics, dev.carry, len(compiled.statics.names),
                          "stream", cycle=self.cycles,
                          names=compiled.statics.names, mesh=dev.mesh)
        return placements, corrupt_kind is not None

    def _stream_cycle(self, pods: List[Pod], cols) -> List[Placement]:
        def dispatch():
            self._commit()
            return self._dispatch(pods, self._xs_host(pods, cols),
                                  self.device.compiled)

        return self._run_guarded(pods, "stream_scan", dispatch)

    def _restage_cycle(self, pods: List[Pod], reason: str) -> List[Placement]:
        inc = self.inc
        dev = self.device
        cp = self.cp
        dev.invalidate()
        inc.drain_journal()  # a structural restage: indices may have moved
        self._statics_patch = None
        ps = cp.spec if cp is not None else None
        t0 = perf_counter()
        with flight.span("compile_cluster") as csp:
            compiled, cols = inc.compile(
                pods, need_noexec=ps is not None and ps.has_noexec,
                need_saa=ps is not None and ps.has_services)
            if csp:
                csp.set("pods", len(pods))
                csp.set("nodes", len(inc.nodes))
        compile_us = since_in_microseconds(t0)
        register().backend_compile_latency.observe(compile_us)
        analytics.note_compile(
            "stream_restage",
            f"plan={self._plan_key}/nodes={len(inc.nodes)}", compile_us)
        detail = unsupported_detail(compiled, cp)
        if detail:
            log.warning("stream runtime falling back to reference for: %s",
                        detail)
            return self._host_cycle(pods, "reference_fallback")
        hard_weight = self.hard_weight
        if cp is not None and cp.hard_weight is not None:
            hard_weight = cp.hard_weight
        config = config_for(
            compiled,
            most_requested=self.provider in _MOST_REQUESTED_PROVIDERS,
            hard_weight=hard_weight)
        ptabs = pol_res = sa_lock_init = None
        if cp is not None:
            # the backend's staging recipe: the policy's rows replace the
            # trivial ones, and the residency records the interning they
            # were built with
            config = replace(config, policy=cp.spec)
            snapshot = inc.to_snapshot()
            ptabs = build_policy_tables(cp, snapshot, pods, compiled, cols)
            if cp.saa_entries:
                config = replace(config, n_saa_doms=ptabs.n_saa_doms)
            pol_res = build_policy_residency(cp, snapshot, pods, compiled,
                                             ptabs)
            if cp.spec.sa_enabled:
                sa_lock_init = ptabs.sa_lock_init
        statics_host = statics_to_host(compiled, ptabs)
        carry_host = carry_init_host(compiled, sa_lock_init)
        xs_host = self._xs_host(pods, cols)
        mesh = self._decide_shard_layout(config)
        self._stage_resident(config, mesh, statics_host, carry_host, xs_host)

        def dispatch():
            placements, intervened = self._dispatch(pods, xs_host, compiled)
            if not intervened:
                dev.adopt(inc, compiled, plan_key=self._plan_key,
                          ptabs=ptabs, pol_res=pol_res)
            return placements, intervened

        return self._run_guarded(pods, "restage_scan", dispatch, reason)

    def _decide_shard_layout(self, config):
        """Decide the residency layout again at restage time, the only
        place it can change (stream cycles inherit what the twin was staged
        as): the twin's node mesh where TPUSIM_SHARDS=k > 1, the config is
        one the sharded route serves and the default process group has k
        ranks; else None, the twin single-device and the reason counted in
        tpusim_shard_fallback_total{reason} with a trace instant."""
        self._shard_layout = None
        n_shards = _backend._shard_count()
        if n_shards <= 1:
            return None
        return _backend.shard_mesh_for(
            config, n_shards, self.torch_device,
            note="stream residency staying single-device", tag=self.mesh_tag)

    def _stage_resident(self, config, mesh, statics_host, carry_host,
                        xs_host) -> None:
        """Stage the restage's host trees as the resident twin: whole, or
        on `mesh`'s node-sharded layout (span shard:stage) once every rank
        has shown the same host picture (backend.check_ranks_agree raises
        where the ranks differ); the layout and the tpusim_shard_* gauges
        are set from it."""
        dev = self.device
        if mesh is None:
            dev.stage(config, statics_host, carry_host)
            return
        _backend.check_ranks_agree(mesh, dev.device, statics_host,
                                   carry_host, xs_host)
        n_real = int(np.asarray(statics_host.alloc_cpu).shape[0])
        with flight.span("shard:stage") as ssp:
            dev.stage(config, statics_host, carry_host, mesh=mesh)
            if ssp:
                ssp.set("shards", dev.shard.size)
                ssp.set("nodes", n_real)
        k, per = dev.shard.size, dev.shard.n_local
        self._shard_layout = {"shards": k, "nodes": n_real,
                              "nodes_per_shard": per}
        m = register()
        m.shard_count.set(k)
        for r in range(k):
            m.shard_node_occupancy.set(str(r),
                                       max(0, min(n_real - r * per, per)))

    def _run_guarded(self, pods: List[Pod], path: str,
                     dispatch: Callable[[], Tuple[List[Placement], bool]],
                     restage_reason: Optional[str] = None
                     ) -> List[Placement]:
        """The chaos seam, as TorchBackend.schedule's: a dispatch the
        breaker denies or a fault aborts is answered by the host pipeline,
        a probe and every dispatch under verify="all" are checked against
        the host pipeline before their placements are emitted, and ANY
        intervention drops residency (the next cycle re-arms from host
        truth). The scan binds into the resident carry in place, so a
        cycle that leaves here by an exception drops residency too.

        The classification is made here, so each cycle off the resident
        path carries ONE label, its final disposition: a restage cycle the
        breaker denies counts as breaker_open, not as its structural reason
        and breaker_open."""
        breaker = _backend._CHAOS["breaker"]
        if breaker is None:
            try:
                placements, intervened = dispatch()
            except BaseException:
                self.device.invalidate()
                raise
            if restage_reason is not None:
                self._classify(restage_reason)
            if intervened:
                self.device.invalidate()
            self._note_path(path, len(pods))
            return placements
        from tpusim_torch.chaos.engine import DeviceFault

        if not breaker.allow():
            flight.note_route("breaker_fallback", len(pods))
            return self._host_cycle(pods, "breaker_open")
        probing = breaker.probing
        try:
            placements, intervened = dispatch()
        except DeviceFault as exc:
            breaker.record_failure(f"{type(exc).__name__}: {exc}")
            flight.note_route("breaker_fallback", len(pods))
            return self._host_cycle(pods, "device_fault")
        except BaseException:
            self.device.invalidate()
            raise
        if probing or _backend._CHAOS["verify"] == "all":
            expected = self._reference(pods)
            if placement_hash(placements) != placement_hash(expected):
                breaker.record_failure("device/host placement divergence")
                flight.note_route("breaker_fallback", len(pods))
                self.device.invalidate()
                self._classify("verify_divergence")
                self._note_path("host", len(pods))
                return expected
        breaker.record_success()
        if restage_reason is not None:
            self._classify(restage_reason)
        if intervened:
            self.device.invalidate()
        self._note_path(path, len(pods))
        return placements

    @staticmethod
    def _decode(pods, choices, counts, compiled, prebound=None):
        return decode_placements(pods, choices, counts,
                                 compiled.statics.names,
                                 reason_strings(compiled.scalar_names),
                                 prebound=prebound)

    def _host_cycle(self, pods: List[Pod], reason: str) -> List[Placement]:
        """A cycle on the host route (a workload the compile classifies
        unsupported, or the chaos seam's answer): residency drops, as the
        device never sees these binds."""
        self._classify(reason)
        self.device.invalidate()
        placements = self._reference(pods)
        self._note_path("host", len(pods))
        return placements

    def _reference(self, pods: List[Pod]) -> List[Placement]:
        placements = ReferenceBackend(
            provider=self.provider,
            hard_pod_affinity_symmetric_weight=self.hard_weight,
            policy=self.policy,
        ).schedule(pods, self.inc.to_snapshot())
        provenance.capture(placements, "stream_host", cycle=self.cycles)
        return placements

    # -- pipelined cycles -------------------------------------------------

    def poll_placed(self) -> List[Placement]:
        """Wait for the in-flight pipelined cycle's choices (if any), fold
        its binds into the host picture and return the placements that
        bound: a pipelined driver's note_bound feed. Call it before applying
        the next cycle's events, so the host picture evolves in the
        synchronous order; the full decode stays deferred to the next
        schedule_pipelined or flush."""
        p = self._pending
        if p is None:
            return []
        if p.placements is not None:
            return [pl for pl in p.placements if pl.node_name]
        self._fold_binds(p)
        return p.bound

    def schedule_pipelined(self, pods: List[Pod]) -> Optional[List[Placement]]:
        """One pipelined cycle: launch THIS batch's scan without waiting for
        it and return the PREVIOUS cycle's placements (None before any
        cycle completes); cycle N-1's decode overlaps cycle N's device work.
        The placements equal schedule()'s: a cycle that cannot ride the
        resident path runs synchronously, buffered one cycle so the
        emission order holds. flush() returns the tail."""
        if not pods:
            return self.flush()
        prev_p, self._pending = self._pending, None
        if prev_p is not None and prev_p.placements is None:
            self._fold_binds(prev_p)
        # the verify mode alone is inert (it gates nothing until a breaker
        # is installed), so only live seams force the synchronous path
        chaos = (_backend._CHAOS["breaker"] is not None
                 or _backend._CHAOS["injector"] is not None)
        routed = None
        if not chaos and self.inc.nodes and not has_gangs(pods):
            # a gang batch runs synchronously: schedule() sends it to the
            # gang driver
            routed = self._route(pods)
        if routed is not None and routed[0] is None:
            self.cycles += 1
            with tracectx.activate(tracectx.start(
                    parent=tracectx.current())):
                cid = (self.persist.begin_cycle(pods)
                       if self.persist is not None else None)
                self._dispatch_async(pods, routed[1], cid)
            register().stream_pipeline_depth.set(1.0)
            osp = flight.span("stream_overlap")
            prev = self._finalize(prev_p)
            if osp:
                osp.end()
            return prev
        # off the resident path: drain the pipeline, then run this cycle
        # synchronously (restage classification included)
        prev = self._finalize(prev_p)
        self._pending = _PendingCycle(pods, placements=self.schedule(
            pods, _routed=routed))
        register().stream_pipeline_depth.set(0.0)
        return prev

    def _dispatch_async(self, pods: List[Pod], cols,
                        wal_cycle: Optional[int] = None) -> None:
        """Commit the pending churn and launch the batch's scan without
        waiting for it: its outputs go to pinned memory behind an event,
        and the cycle waits in _pending for its fold and decode."""
        t0 = perf_counter()
        self._commit()
        xs_host = self._xs_host(pods, cols)
        dsp = flight.span("device_dispatch", "device", self.torch_device)
        fetch = _Fetch(self.device.scan(xs_host), len(pods))
        if dsp:
            dsp.set("pods", len(pods))
            dsp.end()
        # the reduction is launched behind the scan and reads nothing
        # back, so the overlap stays
        dev = self.device
        analytics.capture(dev.statics, dev.carry,
                          len(dev.compiled.statics.names), "stream",
                          cycle=self.cycles, names=dev.compiled.statics.names,
                          mesh=dev.mesh)
        self._pending = _PendingCycle(pods, fetch, dev.compiled, t0=t0,
                                      dispatched_at=perf_counter(),
                                      wal_cycle=wal_cycle)

    def flush(self) -> List[Placement]:
        """Drain the in-flight (or buffered) pipelined cycle and return its
        placements ([] when none): a pipelined run's tail."""
        p, self._pending = self._pending, None
        out = self._finalize(p)
        register().stream_pipeline_depth.set(0.0)
        return out if out is not None else []

    def _fold_binds(self, p: _PendingCycle) -> None:
        """Wait for the pending cycle's outputs and apply its binds to the
        host IncrementalCluster. The fold's journal entries roll back to
        the pre-fold mark: the scan applied these binds to the resident
        carry already, with the same integer arithmetic. Watch events
        journaled BEFORE the fold sit inside the mark and stay."""
        if p.folded:
            return
        waited0 = perf_counter()
        p.choices, p.counts = p.fetch.get()
        waited = perf_counter() - waited0
        # the share of the cycle's device time the host did not wait for
        elapsed = max(waited0 - p.dispatched_at + waited, 1e-9)
        register().stream_overlap_fraction.set(
            max(0.0, 1.0 - waited / elapsed))
        names = p.compiled.statics.names
        sp = flight.span("stream_foldback")
        mark = self.inc.journal_mark()
        with self._persist_suppressed():
            for pod, c in zip(p.pods, p.choices):
                c = int(c)
                if c >= 0:
                    bound = bind_pod(pod, names[c])
                    self.inc.apply(MODIFIED, bound)
                    p.bound.append(Placement(pod=bound, node_name=names[c]))
        self.inc.journal_rollback(mark)
        p.folded = True
        with tracectx.activate(p.trace):
            if self.persist is not None and p.wal_cycle is not None:
                # journaled at fold time: cycle N's binds land BEFORE cycle
                # N+1's watch events, the order the host picture mutates
                # in, under cycle N's trace context
                self.persist.log_bind(p.wal_cycle, p.bound)
            if sp:
                sp.set("bound", len(p.bound))
                sp.end()

    def _finalize(self, p: Optional[_PendingCycle]
                  ) -> Optional[List[Placement]]:
        """Decode a pending cycle into its placements (None for None): the
        deferred host half of a pipelined cycle, overlapping the next
        cycle's device work when schedule_pipelined calls it."""
        if p is None:
            return None
        if p.placements is not None:
            return p.placements
        with tracectx.activate(p.trace):
            self._fold_binds(p)
            with flight.span("stream_decode"):
                p.placements = self._decode(p.pods, p.choices, p.counts,
                                            p.compiled, prebound=p.bound)
            provenance.capture(p.placements, "stream",
                               cycle=p.wal_cycle if p.wal_cycle is not None
                               else self.cycles)
            self._note_path("pipelined", len(p.pods))
            if self.persist is not None and p.wal_cycle is not None:
                self.persist.log_emit(p.wal_cycle, p.placements)
            self._observe_cycle("pipelined", p.t0)
        return p.placements

    # -- live what-if overlays --------------------------------------------

    def overlay_query(self, pods: List[Pod],
                      _path: str = "resident") -> Optional[List[Placement]]:
        """Answer a what-if query on the LIVE resident twin in O(query):
        behind a journal mark, commit the pending churn as the next real
        cycle would (authoritative and idempotent: the restored journal
        makes that cycle's commit set the same bytes again), scan the query
        batch, decode, and roll the carry back to host truth
        (scan.overlay_restore_ over the nodes the query bound, the
        per-batch lanes restored from copies taken before). The query never
        folds back: the cycle chain and the classification are untouched,
        and the placements equal whatif.run_what_if on inc.to_snapshot()
        and the query.

        Returns None where the query cannot ride the resident twin (no
        residency, a change a real cycle would restage for, gang semantics,
        a config whose carry has no rollback path); a restage reason found
        here is latched, so the next real cycle classifies it as _route
        would have. _path labels the answer in
        tpusim_overlay_queries_total ("follower" for a replica's twin)."""
        if not pods:
            return []
        t0 = perf_counter()
        routed = self._overlay_route(pods)
        if isinstance(routed, str):
            register().overlay_fallback.inc(routed)
            flight.note_route("overlay_fallback", len(pods))
            return None
        placements = self._overlay_dispatch(pods, routed)
        if placements is None:
            return None
        m = register()
        m.overlay_queries.inc(_path)
        ctx = tracectx.current()
        m.overlay_latency.observe(
            since_in_microseconds(t0),
            exemplar=ctx.trace_id if ctx is not None else None)
        return placements

    def _overlay_route(self, pods: List[Pod]):
        """_route for a query, without disturbing the live session: the
        batch's remapped PodColumns, or the reason it cannot ride the
        resident twin. Stricter than _route: whatever a real cycle would
        restage for refuses, and so do the configs whose carry fields have
        no rollback path."""
        inc = self.inc
        dev = self.device
        if self._pending is not None and self._pending.placements is None:
            # a pipelined cycle in flight: fold its binds first, so the
            # mark brackets the state the resident carry holds
            self._fold_binds(self._pending)
        if self._forced is not None or self.always_restage:
            return "forced_restage"
        if not inc.nodes:
            return "no_nodes"
        if has_gangs(pods):
            return "gang_semantics"
        breaker = _backend._CHAOS["breaker"]
        if breaker is not None and (breaker.probing
                                    or _backend._CHAOS["verify"] == "all"
                                    or not breaker.allow()):
            # a probe or a verified cycle owes a check against the host the
            # overlay cannot give; an open breaker denies the dispatch
            return "breaker_open"
        reason = dev.residency_miss(inc, self._plan_key)
        if reason is not None:
            return reason
        if dev.config.has_interpod or dev.config.has_maxpd:
            # presence_dom and used_vols have no rollback path
            return "no_rollback_path"
        n_scalars = len(inc._scalar_names)
        cols, key_lists = inc._batch_columns(pods)
        if len(inc._scalar_names) != n_scalars:
            # the QUERY widened the scalar universe: drop the names it
            # noted (no live object has them; _note_scalar only appends), so
            # the live session keeps its resident width
            for name in inc._scalar_names[n_scalars:]:
                del inc._scalar_idx[name]
            del inc._scalar_names[n_scalars:]
            if inc._statics is not None:
                inc._statics.alloc_scalar = \
                    inc._statics.alloc_scalar[:, :n_scalars]
            if inc._dyn is not None:
                inc._dyn.used_scalar = inc._dyn.used_scalar[:, :n_scalars]
            return "scalar_set"
        reason = dev.remap_signatures(inc, cols, key_lists)
        if reason is not None:
            return reason
        if not inc.assign_group_ids(cols, pods):
            return "group_shape"
        if self.cp is not None:
            reason = remap_policy_columns(self.cp, dev.pol_res, pods, cols)
            if reason is not None:
                return reason
        reason = self._prepare_statics_delta()
        if reason is not None:
            # the column journal cannot land as a commit: the next REAL
            # cycle restages for it, classified as _route would have
            self.force_restage(reason)
            return reason
        return cols

    def _overlay_dispatch(self, pods: List[Pod], cols
                          ) -> Optional[List[Placement]]:
        """Mark -> commit -> scan -> decode -> roll back. A device error
        rolls the journal back, drops residency (the next real cycle
        restages from host truth) and raises. Under an installed chaos seam
        an injected fault or a scripted corruption drops the overlay the
        same way but returns None (counted in
        tpusim_overlay_fallback_total): the caller takes the staged path."""
        inc = self.inc
        dev = self.device
        injector = _backend._CHAOS["injector"]
        breaker = _backend._CHAOS["breaker"]
        mark = inc.journal_mark()
        rr_save = dev.carry.rr.clone()
        sa_save = dev.carry.sa_lock.clone()
        try:
            self._commit()
            corrupt_kind = (injector.begin_dispatch()
                            if injector is not None else None)
            xs_host = self._xs_host(pods, cols)
            with flight.span("overlay_scan", "device", self.torch_device):
                choices, counts = _Fetch(dev.scan(xs_host), len(pods)).get()
        except Exception as exc:
            inc.journal_rollback(mark)
            dev.invalidate()
            from tpusim_torch.chaos.engine import DeviceFault

            if isinstance(exc, DeviceFault):
                if breaker is not None:
                    breaker.record_failure(f"{type(exc).__name__}: {exc}")
                register().overlay_fallback.inc("device_fault")
                flight.note_route("overlay_fallback", len(pods))
                return None
            raise
        if corrupt_kind is not None:
            # the reported choices may not be the device's own decisions,
            # so the row-wise restore below cannot be trusted to cover every
            # bound node: drop residency instead (the next real cycle
            # restages from host truth)
            inc.journal_rollback(mark)
            dev.invalidate()
            register().overlay_fallback.inc("corruption")
            flight.note_route("overlay_fallback", len(pods))
            return None
        self._overlay_rollback(cols, choices, mark, sa_save, rr_save)
        if breaker is not None:
            breaker.record_success()
        with flight.span("overlay_decode"):
            placements = self._decode(pods, choices, counts, dev.compiled)
        provenance.capture(placements, "overlay", cycle=self.cycles)
        return placements

    def _overlay_rollback(self, cols, choices: np.ndarray, mark,
                          sa_save, rr_save) -> None:
        """Set the query's bound rows back to host truth (the gather
        commit() makes, over the nodes the query bound: the query never
        touched inc, so its columns hold the values from before it), and
        restore the journal mark."""
        inc = self.inc
        bound = {int(c) for c in choices if int(c) >= 0}
        idx, rows = _delta_rows(inc, bound)
        cells = {(int(cols.group_id[j]), int(c))
                 for j, c in enumerate(choices) if int(c) >= 0}
        sp = flight.span("overlay_rollback", "device", self.torch_device)
        overlay_restore_(self.device.carry, idx, rows,
                         *_presence_cells(inc, cells), sa_save, rr_save,
                         shard=self.device.shard)
        if sp:
            sp.set("rows", int(len(bound)))
            sp.end()
        inc.journal_rollback(mark)

    # -- accounting -------------------------------------------------------

    def _classify(self, reason: str) -> None:
        self.restage_counts[reason] = self.restage_counts.get(reason, 0) + 1
        flight.note_stream_restage(reason)

    def _note_path(self, path: str, pods: int) -> None:
        self.path_counts[path] = self.path_counts.get(path, 0) + 1
        self._last_path = path
        flight.note_stream_cycle(path, pods)

    @staticmethod
    def _observe_cycle(path: str, t0: float) -> None:
        """A cycle's latency, in the e2e histogram and in the per-path
        stream histogram, judged by the SLO tracker when one is armed. With
        a trace context active, the cycle's trace id rides both histograms
        as an exemplar, so a slow cycle on a dashboard names its trace."""
        us = since_in_microseconds(t0)
        ctx = tracectx.current()
        ex = ctx.trace_id if ctx is not None else None
        m = register()
        m.e2e_scheduling_latency.observe(us, exemplar=ex)
        m.stream_cycle_latency.observe(path, us, exemplar=ex)
        slo.observe_cycle(path, us)
