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
unsupported ("reference_fallback", counted in path_counts["host"]).
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod
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
)
from tpusim_torch.config import config_for
from tpusim_torch.delta import _SIG_KINDS, IncrementalCluster
from tpusim_torch.device import resolve_device
from tpusim_torch.framework.store import MODIFIED
from tpusim_torch.gang.driver import schedule_with_gangs
from tpusim_torch.gang.group import has_gangs
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

    def stage(self, config, statics_host, carry_host) -> None:
        """Load a restage's host trees (scan.Statics and scan.Carry of
        numpy arrays) into the resident tensors: copied into the tensors
        there are when the config and every shape agree, else onto new
        tensors, which drops the programs bound to the old ones."""
        same = (self.statics is not None and config == self.config
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
        self._programs = {}

    def scan(self, xs_host):
        """Scan a bucket of pods (host numpy columns, padded to the bucket)
        on the resident state in place: the program's output buffers."""
        bucket = int(np.asarray(xs_host.req_cpu).shape[0])
        program = self._programs.get(bucket)
        if program is None:
            program = ResidentScan(self.config, self.carry, self.statics,
                                   bucket, graph_steps=GRAPH_STEPS)
            self._programs[bucket] = program
        return program.run(xs_host)

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

    def commit(self, inc: IncrementalCluster, sa_lock_init) -> None:
        """Drain the IncrementalCluster's journal and set the authoritative
        values of every touched node row and presence cell into the
        resident carry, in place. Runs even with an empty journal, as the
        commit also re-arms the per-batch lanes to what a restage would
        stage (`sa_lock_init`: all unlocked for a provider, the live
        first-matching-pod pins under ServiceAffinity; rr 0)."""
        nodes, cells = inc.drain_journal()
        idx, rows = _delta_rows(inc, nodes)
        apply_delta_(self.carry, idx, rows, *_presence_cells(inc, cells),
                     sa_lock_init)
        self.commits += 1


class _PendingCycle:
    """One pipelined cycle in flight (its outputs on their way to the
    host), or one run synchronously and buffered for emission order."""

    __slots__ = ("pods", "fetch", "compiled", "folded", "choices", "counts",
                 "bound", "placements")

    def __init__(self, pods, fetch=None, compiled=None, placements=None):
        self.pods = pods
        self.fetch = fetch
        self.compiled = compiled
        self.folded = placements is not None
        self.choices = self.counts = None
        self.bound: List[Placement] = []
        self.placements = placements


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
                 policy=None, compiled_policy=None, device="cuda"):
        """always_restage: no resident path, every cycle pays the full
        compile and staging (the comparison arm; placements are identical).
        policy / compiled_policy: a scheduler Policy, compiled here unless
        given compiled; set_policy swaps it (a change of plan restages
        once). device: "cuda" (the default) or "cpu"."""
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
        self._statics_patch = None    # (padded idx, StaticsDelta) or None
        self._pending: Optional[_PendingCycle] = None
        self._gang_torch = None       # TorchBackend of the gang cycles

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
        self.inc.apply_events(events)

    def force_restage(self, reason: str) -> None:
        """Drop residency before the next cycle (the first reason wins)."""
        if self._forced is None:
            self._forced = reason

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
        self.cycles += 1
        inc = self.inc
        if not inc.nodes:
            msg = "no nodes available to schedule pods"
            self._note_path("no_nodes")
            return [Placement(pod=mark_unschedulable(p, msg),
                              reason="Unschedulable", message=msg)
                    for p in pods]
        if has_gangs(pods):
            return self._gang_cycle(pods)
        reason, cols = _routed if _routed is not None else self._route(pods)
        if reason is None:
            placements = self._stream_cycle(pods, cols)
        else:
            placements = self._restage_cycle(pods, reason)
        for pl in placements:
            if pl.node_name:
                inc.apply(MODIFIED, pl.pod)
        if self.device.valid:
            # the scan applied these binds to the resident carry already,
            # with the same integer arithmetic: committing the fold-back's
            # journal next cycle would set the bytes it holds
            inc.drain_journal()
        return placements

    def _gang_cycle(self, pods: List[Pod]) -> List[Placement]:
        """A batch with gangs: the gang driver against the live host
        picture (member lanes, joint packing, all or nothing). The driver
        applies its binds to `inc`, so they sit in the journal and the NEXT
        cycle's commit carries them onto the resident carry like any other
        churn: residency holds, nothing restages."""
        placements = schedule_with_gangs(self._gang_backend(), self.inc, pods)
        self._note_path("gang")
        return placements

    def _gang_backend(self) -> TorchBackend:
        """The gang cycles' backend on the session's device: the driver's
        ungrouped segments and member lanes run on fresh compiles, not on
        the resident state (a gang decision takes its own picture)."""
        if self._gang_torch is None:
            self._gang_torch = TorchBackend(
                provider=self.provider, device=self.torch_device,
                hard_pod_affinity_symmetric_weight=self.hard_weight,
                policy=self.policy)
        return self._gang_torch

    def _route(self, pods: List[Pod]):
        """Resident path or restage for a batch: (None, cols) when the
        resident state can serve it, else (reason, cols or None). Consumes
        the forced-restage latch and the column journal (a restage rebuilds
        everything, so a dropped patch is harmless)."""
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
        apply_statics_delta_(self.device.statics, idx, delta)

    def _commit_and_scan(self, pods: List[Pod], cols):
        """Commit the pending churn and launch the resident scan of the
        batch: the scan's output buffers."""
        dev = self.device
        self._apply_statics_patch()
        dev.commit(self.inc, self._commit_sa_lock())
        p = len(pods)
        return dev.scan(pad_infeasible_rows(pod_columns_to_host(cols),
                                            bucket_size(p) - p))

    def _stream_cycle(self, pods: List[Pod], cols) -> List[Placement]:
        out = self._commit_and_scan(pods, cols)
        placements = self._decode(pods, *_Fetch(out, len(pods)).get(),
                                  self.device.compiled)
        self._note_path("stream_scan")
        return placements

    def _restage_cycle(self, pods: List[Pod], reason: str) -> List[Placement]:
        inc = self.inc
        dev = self.device
        cp = self.cp
        dev.invalidate()
        inc.drain_journal()  # a structural restage: indices may have moved
        self._statics_patch = None
        ps = cp.spec if cp is not None else None
        compiled, cols = inc.compile(
            pods, need_noexec=ps is not None and ps.has_noexec,
            need_saa=ps is not None and ps.has_services)
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
        dev.stage(config, statics_to_host(compiled, ptabs),
                  carry_init_host(compiled, sa_lock_init))
        p = len(pods)
        out = dev.scan(pad_infeasible_rows(pod_columns_to_host(cols),
                                           bucket_size(p) - p))
        placements = self._decode(pods, *_Fetch(out, p).get(), compiled)
        dev.adopt(inc, compiled, plan_key=self._plan_key, ptabs=ptabs,
                  pol_res=pol_res)
        self._classify(reason)
        self._note_path("restage_scan")
        return placements

    @staticmethod
    def _decode(pods, choices, counts, compiled, prebound=None):
        return decode_placements(pods, choices, counts,
                                 compiled.statics.names,
                                 reason_strings(compiled.scalar_names),
                                 prebound=prebound)

    def _host_cycle(self, pods: List[Pod], reason: str) -> List[Placement]:
        """A cycle on the host route (the workload the compile classifies
        unsupported): residency drops, as the device never sees these
        binds."""
        self._classify(reason)
        self.device.invalidate()
        placements = ReferenceBackend(
            provider=self.provider,
            hard_pod_affinity_symmetric_weight=self.hard_weight,
            policy=self.policy,
        ).schedule(pods, self.inc.to_snapshot())
        self._note_path("host")
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
        routed = None
        if self.inc.nodes and not has_gangs(pods):
            # a gang batch runs synchronously: schedule() sends it to the
            # gang driver
            routed = self._route(pods)
        if routed is not None and routed[0] is None:
            self.cycles += 1
            out = self._commit_and_scan(pods, routed[1])
            self._pending = _PendingCycle(pods, _Fetch(out, len(pods)),
                                          self.device.compiled)
            return self._finalize(prev_p)
        # off the resident path: drain the pipeline, then run this cycle
        # synchronously (restage classification included)
        prev = self._finalize(prev_p)
        self._pending = _PendingCycle(pods, placements=self.schedule(
            pods, _routed=routed))
        return prev

    def flush(self) -> List[Placement]:
        """Drain the in-flight (or buffered) pipelined cycle and return its
        placements ([] when none): a pipelined run's tail."""
        p, self._pending = self._pending, None
        out = self._finalize(p)
        return out if out is not None else []

    def _fold_binds(self, p: _PendingCycle) -> None:
        """Wait for the pending cycle's outputs and apply its binds to the
        host IncrementalCluster. The fold's journal entries roll back to
        the pre-fold mark: the scan applied these binds to the resident
        carry already, with the same integer arithmetic. Watch events
        journaled BEFORE the fold sit inside the mark and stay."""
        if p.folded:
            return
        p.choices, p.counts = p.fetch.get()
        names = p.compiled.statics.names
        mark = self.inc.journal_mark()
        for pod, c in zip(p.pods, p.choices):
            c = int(c)
            if c >= 0:
                bound = bind_pod(pod, names[c])
                self.inc.apply(MODIFIED, bound)
                p.bound.append(Placement(pod=bound, node_name=names[c]))
        self.inc.journal_rollback(mark)
        p.folded = True

    def _finalize(self, p: Optional[_PendingCycle]
                  ) -> Optional[List[Placement]]:
        """Decode a pending cycle into its placements (None for None): the
        deferred host half of a pipelined cycle, overlapping the next
        cycle's device work when schedule_pipelined calls it."""
        if p is None:
            return None
        if p.placements is not None:
            return p.placements
        self._fold_binds(p)
        p.placements = self._decode(p.pods, p.choices, p.counts, p.compiled,
                                    prebound=p.bound)
        self._note_path("pipelined")
        return p.placements

    # -- live what-if overlays --------------------------------------------

    def overlay_query(self, pods: List[Pod]) -> Optional[List[Placement]]:
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
        would have."""
        if not pods:
            return []
        routed = self._overlay_route(pods)
        if isinstance(routed, str):
            return None
        return self._overlay_dispatch(pods, routed)

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

    def _overlay_dispatch(self, pods: List[Pod], cols) -> List[Placement]:
        """Mark -> commit -> scan -> decode -> roll back. A device error
        rolls the journal back, drops residency (the next real cycle
        restages from host truth) and raises."""
        inc = self.inc
        dev = self.device
        mark = inc.journal_mark()
        rr_save = dev.carry.rr.clone()
        sa_save = dev.carry.sa_lock.clone()
        try:
            out = self._commit_and_scan(pods, cols)
            choices, counts = _Fetch(out, len(pods)).get()
        except Exception:
            inc.journal_rollback(mark)
            dev.invalidate()
            raise
        self._overlay_rollback(cols, choices, mark, sa_save, rr_save)
        return self._decode(pods, choices, counts, dev.compiled)

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
        overlay_restore_(self.device.carry, idx, rows,
                         *_presence_cells(inc, cells), sa_save, rr_save)
        inc.journal_rollback(mark)

    # -- accounting -------------------------------------------------------

    def _classify(self, reason: str) -> None:
        self.restage_counts[reason] = self.restage_counts.get(reason, 0) + 1

    def _note_path(self, path: str) -> None:
        self.path_counts[path] = self.path_counts.get(path, 0) + 1
