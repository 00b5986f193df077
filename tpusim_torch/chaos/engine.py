"""ChaosEngine: applies a FaultPlan against a live ClusterCapacity run.

Injection points, one per layer of the plan:

1. **Cluster churn** (`fire_boundary`) — the simulator calls it at every
   pod-attempt boundary; due churn events mutate the ResourceStore, so
   every downstream consequence rides the EXISTING event fabric: node
   DELETED → cache remove + whole-node equivalence-cache invalidation,
   pod DELETED → move_all_to_active_queue, bind-time Modified → cache
   confirm. Node deletion additionally clears nominations pointing at the
   dead node (queue.clear_nominations_for_node) and keeps the
   orchestrator's authoritative node list in sync.

2. **Fabric faults** (`FabricInjector`) — installed on the
   FakeRESTClient fan-out; classifies each (watcher, frame) delivery by a
   global event index into deliver/drop/dup/disconnect.

3. **Device faults** (`DeviceInjector`) — installed process-wide in
   backend.py; scripts per-dispatch exceptions and corrupted outputs,
   which the dispatch circuit breaker must absorb.

Determinism: the engine never reads wall-clock. `ChaosClock` is a
manually-advanced monotonic counter threaded into PodBackoff (and
available for the flight recorder), advanced a fixed 1s per attempt
boundary, so backoff expiry — and therefore the retry order — is a pure
function of the plan.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from tpusim_torch.chaos.plan import ChurnEvent, FaultPlan
from tpusim_torch.obs.recorder import note_fault

log = logging.getLogger(__name__)


class ChaosClock:
    """Injectable deterministic clock (the obs/recorder.py pattern): a
    float that only moves when advanced."""

    def __init__(self, start: float = 0.0, tick: float = 1.0):
        self.now = start
        self.tick = tick

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: Optional[float] = None) -> float:
        self.now += self.tick if dt is None else dt
        return self.now


class DeviceFault(RuntimeError):
    """Base of the device-fault family the dispatch circuit breaker
    absorbs. Only these trip the breaker — configuration errors and
    genuine bugs still propagate."""


class InjectedDeviceError(DeviceFault):
    """A scripted device-dispatch failure (the chaos analog of a dead
    accelerator tunnel mid-batch)."""


class DeviceOutputError(DeviceFault):
    """Structurally invalid device output: out-of-range node choices or
    NaN reason counts. Caught by the backend's post-dispatch validation
    regardless of verification mode."""


class ProcessCrash(RuntimeError):
    """A scripted whole-process death (the ``process_crash`` churn
    action). Deliberately NOT a DeviceFault: no breaker absorbs it and no
    retry survives it — it propagates out of the run, and the test
    harness "reboots" by recovering from the WAL + checkpoint pair
    (stream.persist). Raised immediately AFTER the targeted WAL record is
    durably written, the strictest crash model a journal can be fuzzed
    under."""


class DeviceInjector:
    """Scripted per-dispatch device faults, keyed by dispatch index."""

    def __init__(self, faults: Dict[int, str]):
        self.faults = dict(faults)
        self.dispatch_index = 0
        self.injected: List[Tuple[int, str]] = []

    def _take(self) -> Optional[str]:
        idx = self.dispatch_index
        self.dispatch_index += 1
        kind = self.faults.get(idx)
        if kind is not None:
            self.injected.append((idx, kind))
            note_fault("device_" + kind, {"dispatch": idx})
        return kind

    def begin_dispatch(self) -> Optional[str]:
        """Called at device-dispatch start. Raises for scripted exceptions;
        returns a corruption kind (applied post-scan) or None."""
        kind = self._take()
        if kind == "exception":
            raise InjectedDeviceError(
                f"chaos: injected device fault at dispatch "
                f"{self.dispatch_index - 1}")
        return kind

    @staticmethod
    def corrupt(kind: str, choices, counts):
        """Corrupt a scan result in place-ish (returns new arrays).

        corrupt_invalid: out-of-range node index + NaN-poisoned reason
        counts — structurally detectable. corrupt_silent: rotate in-range
        choices — only host verification can catch it."""
        import numpy as np

        choices = np.array(choices, copy=True)
        if kind == "corrupt_invalid":
            counts = np.asarray(counts, dtype=float).copy()
            if choices.size:
                choices[0] = 2 ** 30
            if counts.size:
                counts.flat[0] = float("nan")
            return choices, counts
        if kind == "corrupt_silent":
            if choices.size:
                # shift every decision by one "node": wrong but in-range
                choices = np.where(choices >= 0, (choices + 1) % max(
                    int(choices.max()) + 1, 1), choices)
            return choices, counts
        raise ValueError(f"unknown corruption kind {kind!r}")


class FabricInjector:
    """Classifies each watch-frame delivery by global event index."""

    def __init__(self, drop, dup, disconnect):
        self.drop: Set[int] = set(drop)
        self.dup: Set[int] = set(dup)
        self.disconnect: Set[int] = set(disconnect)
        self.event_index = 0
        self.injected: List[Tuple[int, str]] = []

    def on_event(self, resource: str, event_type: str) -> str:
        """Returns deliver|drop|dup|disconnect for this delivery."""
        idx = self.event_index
        self.event_index += 1
        if idx in self.drop:
            action = "drop"
        elif idx in self.dup:
            action = "dup"
        elif idx in self.disconnect:
            action = "disconnect"
        else:
            return "deliver"
        self.injected.append((idx, action))
        note_fault("watch_" + action,
                   {"event": idx, "resource": resource, "type": event_type})
        return action


class ChaosEngine:
    """Drives one FaultPlan against one ClusterCapacity run."""

    def __init__(self, plan: FaultPlan, clock: Optional[ChaosClock] = None):
        self.plan = plan.validate()
        self.clock = clock or ChaosClock()
        self.cc = None  # attached ClusterCapacity
        self.boundary = 0
        self.fired: List[Tuple[int, str, str]] = []   # (boundary, action, target)
        self.skipped: List[Tuple[int, str, str]] = [] # target vanished first
        self.violations: List[str] = []
        self.fed_keys: List[str] = []
        self.evicted_keys: Set[str] = set()
        self.requeued_keys: Set[str] = set()
        self.retries: Dict[str, int] = {}
        self.deleted_nodes: Set[str] = set()  # currently-deleted node names
        self._pending_restores: List[Tuple[int, object]] = []  # (boundary, Node)
        self._churn = sorted(self.plan.churn,
                             key=lambda ev: (ev.at, ev.action, ev.target))
        self.fabric_injector = (
            None if self.plan.fabric.empty() else FabricInjector(
                self.plan.fabric.drop, self.plan.fabric.dup,
                self.plan.fabric.disconnect))
        self.device_injector = (
            None if self.plan.device.empty() else DeviceInjector(
                self.plan.device.faults))
        # process_crash handler: the persistence layer (stream.persist)
        # registers one to arm itself; without a handler the event is
        # skipped like churn on a vanished target
        self.on_process_crash = None
        # fabric mirror: a FakeRESTClient + Reflector pair consuming the
        # run's store mutations THROUGH the fault injector — built lazily
        # at the first boundary (the store exists by then), audited at the
        # end for reconvergence with the authoritative store
        self._mirror_client = None
        self._mirrors: List[object] = []

    # -- wiring ------------------------------------------------------------

    def attach(self, cc) -> "ChaosEngine":
        """Bind to a ClusterCapacity (the simulator calls this from its
        constructor when built with chaos=...)."""
        self.cc = cc
        return self

    def note_fed(self, pod) -> None:
        key = pod.key()
        if key not in self.fed_keys:
            self.fed_keys.append(key)

    def _ensure_fabric_mirror(self) -> None:
        """Stand up the faulty-fabric consumer: a FakeRESTClient whose
        fan-out runs through the FabricInjector, mirrored by one Reflector
        per resource. The mirror is a pure observer — it proves that a
        consumer behind a lossy stream reconverges (via 410-triggered
        relists) to the authoritative store, which `audit_fabric` checks
        at the end of the run."""
        if self.fabric_injector is None or self._mirror_client is not None:
            return
        from tpusim_torch.api.types import ResourceType
        from tpusim_torch.framework.reflector import Reflector
        from tpusim_torch.framework.restclient import FakeRESTClient

        self._mirror_client = FakeRESTClient(self.cc.resource_store)
        self._mirror_client.fault_injector = self.fabric_injector
        self._mirrors = [Reflector(self._mirror_client, rt)
                         for rt in (ResourceType.PODS, ResourceType.NODES)]

    def _sync_mirrors(self) -> None:
        for refl in self._mirrors:
            refl.sync()

    # -- attempt boundaries ------------------------------------------------

    def fire_boundary(self) -> int:
        """Apply every churn event due at the current boundary (plus any
        flap restores), advance the injected clock one tick, and return
        the number of events fired."""
        self._ensure_fabric_mirror()
        b = self.boundary
        fired = 0
        for when, node in list(self._pending_restores):
            if when <= b:
                self._restore_node(node)
                self._pending_restores.remove((when, node))
                fired += 1
        while self._churn and self._churn[0].at <= b:
            ev = self._churn.pop(0)
            self._apply(ev)
            fired += 1
        self.boundary += 1
        self.clock.advance()
        self._sync_mirrors()
        return fired

    def has_pending_churn(self) -> bool:
        return bool(self._churn or self._pending_restores)

    def flush(self) -> None:
        """Apply whatever the attempt loop never reached (the run drained
        first), so the plan's full end-state is what invariants audit."""
        while self._churn or self._pending_restores:
            self.fire_boundary()

    # -- churn actions -----------------------------------------------------

    def _apply(self, ev: ChurnEvent) -> None:
        action = {"node_delete": self._node_delete,
                  "node_cordon": self._node_cordon,
                  "node_flap": self._node_flap,
                  "pod_evict": self._pod_evict,
                  "process_crash": self._process_crash}[ev.action]
        if action(ev):
            self.fired.append((self.boundary, ev.action, ev.target))
            note_fault(ev.action,
                       {"target": ev.target, "boundary": self.boundary})
        else:
            self.skipped.append((self.boundary, ev.action, ev.target))
            log.info("chaos: %s %s skipped at boundary %d (target gone)",
                     ev.action, ev.target, self.boundary)

    def _process_crash(self, ev: ChurnEvent) -> bool:
        """Hand a scripted crash to the installed handler — the stream
        persistence layer arms itself to raise ProcessCrash at the
        targeted WAL record (``ev.target`` names the record kind,
        ``ev.at`` the cycle). Skipped, like churn on a vanished target,
        when nothing in this run handles crashes."""
        if self.on_process_crash is None:
            return False
        self.on_process_crash(ev)
        return True

    def _find_node(self, name: str):
        from tpusim_torch.api.types import ResourceType

        node, ok = self.cc.resource_store.get(ResourceType.NODES, name)
        return node if ok else None

    def _node_delete(self, ev: ChurnEvent, flap: bool = False) -> bool:
        from tpusim_torch.api.types import ResourceType

        node = self._find_node(ev.target)
        if node is None:
            return False
        # DELETED rides the store fabric: cache.remove_node + whole-node
        # equivalence-cache invalidation via the registered handlers
        self.cc.resource_store.delete(ResourceType.NODES, node)
        self.cc.nodes = [n for n in self.cc.nodes if n.name != node.name]
        self.cc._cached_node_infos.pop(node.name, None)
        self.deleted_nodes.add(node.name)
        # nominated-node cleanup: a nomination on a dead node is a promise
        # the cluster can no longer keep
        queue = self.cc.scheduling_queue
        cleared = queue.clear_nominations_for_node(node.name)
        for pod in cleared:
            pod.status.nominated_node_name = ""
        self._release_gang_members(node.name)
        if flap:
            self._pending_restores.append(
                (self.boundary + ev.restore_after, node))
        return True

    def _release_gang_members(self, node_name: str) -> None:
        """No partial gang bound: losing a node releases every gang with a
        member bound on it — all still-bound mates (on ANY node) are
        evicted through the same store mechanics as _pod_evict, so a
        surviving fraction can never masquerade as an admitted group. Fed
        members are re-fed for a fresh all-or-nothing attempt against the
        shrunken cluster."""
        from tpusim_torch.api.types import ResourceType
        from tpusim_torch.gang.group import gang_name

        store = self.cc.resource_store
        doomed = {gang_name(p) for p in store.list(ResourceType.PODS)
                  if gang_name(p) and p.spec.node_name == node_name}
        if not doomed:
            return
        released = 0
        for pod in list(store.list(ResourceType.PODS)):
            if gang_name(pod) not in doomed or not pod.spec.node_name:
                continue
            store.delete(ResourceType.PODS, pod)
            key = pod.key()
            self.evicted_keys.add(key)
            st = self.cc.status
            st.successful_pods = [p for p in st.successful_pods
                                  if p.key() != key]
            st.scheduled_pods = [p for p in st.scheduled_pods
                                 if p.key() != key]
            if key in self.fed_keys:
                fresh = pod.copy()
                fresh.spec.node_name = ""
                fresh.status.phase = ""
                fresh.status.conditions = []
                fresh.status.reason = ""
                self.cc.pod_queue.push(fresh)
                self.requeued_keys.add(key)
            released += 1
        self.cc.metrics.gang_partial_rollback.inc()
        cleared = self.cc.scheduling_queue.clear_nominations_for_gangs(doomed)
        for pod in cleared:
            pod.status.nominated_node_name = ""
        note_fault("gang_release", {"groups": sorted(doomed),
                                    "released": released})

    def _restore_node(self, node) -> None:
        from tpusim_torch.api.types import ResourceType

        self.cc.resource_store.add(ResourceType.NODES, node)
        self.cc.nodes.append(node)
        self.deleted_nodes.discard(node.name)
        # a returning node may make parked pods schedulable again
        self.cc.scheduling_queue.move_all_to_active_queue()
        note_fault("node_restore", {"target": node.name,
                                    "boundary": self.boundary})

    def _node_cordon(self, ev: ChurnEvent) -> bool:
        from tpusim_torch.api.types import ResourceType

        node = self._find_node(ev.target)
        if node is None:
            return False
        cordoned = node.copy()
        cordoned.spec.unschedulable = True
        self.cc.resource_store.update(ResourceType.NODES, cordoned)
        self.cc.nodes = [cordoned if n.name == node.name else n
                         for n in self.cc.nodes]
        return True

    def _node_flap(self, ev: ChurnEvent) -> bool:
        return self._node_delete(ev, flap=True)

    def _pod_evict(self, ev: ChurnEvent) -> bool:
        from tpusim_torch.api.types import ResourceType

        pod, ok = self.cc.resource_store.get(ResourceType.PODS, ev.target)
        if not ok or not pod.spec.node_name:
            return False  # not placed (or already gone): nothing to evict
        self.cc.resource_store.delete(ResourceType.PODS, pod)
        key = pod.key()
        self.evicted_keys.add(key)
        # mirror commit_preemption's bookkeeping: an evicted pod is no
        # longer placed, so it leaves the success/pre-scheduled buckets
        st = self.cc.status
        st.successful_pods = [p for p in st.successful_pods
                              if p.key() != key]
        st.scheduled_pods = [p for p in st.scheduled_pods if p.key() != key]
        if key in self.fed_keys:
            # a fed pod gets re-fed for another attempt (the controller
            # re-creates it); a seed pod is terminally evicted
            fresh = pod.copy()
            fresh.spec.node_name = ""
            fresh.status.phase = ""
            fresh.status.conditions = []
            fresh.status.reason = ""
            self.cc.pod_queue.push(fresh)
            self.requeued_keys.add(key)
        return True

    # -- retry gating ------------------------------------------------------

    def allow_retry(self, pod) -> bool:
        """May this churn-reactivated pod re-attempt? Bounded by the plan's
        per-pod max_retries; backoff-gated through the injected clock (the
        deterministic analog of MakeDefaultErrorFunc's podBackoff wait)."""
        key = pod.key()
        if self.retries.get(key, 0) >= self.plan.max_retries:
            return False
        backoff = self.cc.pod_backoff
        spins = 0
        while not backoff.try_backoff_and_wait(key):
            self.clock.advance()
            spins += 1
            if spins > 64:  # > max backoff (60s) at 1s ticks: impossible
                self.violations.append(
                    f"backoff for {key} never expired under the injected "
                    f"clock")
                return False
        self.retries[key] = self.retries.get(key, 0) + 1
        return True

    def audit_fabric(self) -> List[str]:
        """Final reconvergence check: every mirror's ``known`` map must
        agree with the authoritative store — key set and, for pods, the
        bound node. A lossy stream is allowed to lag mid-run; it is NOT
        allowed to end diverged. Streams torn by disconnect/overflow heal
        through relist-on-410 during the run; a silently DROPPED frame is
        undetectable from the stream alone, so the audit first runs one
        forced relist per mirror — the client-go periodic-resync analog —
        and then requires exact agreement."""
        if not self._mirrors:
            return []
        violations = []
        self._sync_mirrors()
        for refl in self._mirrors:
            refl.relist()
            refl.sync()
        for refl in self._mirrors:
            rt = refl.resource
            truth = {o.key(): o
                     for o in self.cc.resource_store.list(rt)}
            if set(refl.known) != set(truth):
                missing = sorted(set(truth) - set(refl.known))
                extra = sorted(set(refl.known) - set(truth))
                violations.append(
                    f"fabric mirror diverged on {rt.value}: "
                    f"missing={missing} extra={extra} after "
                    f"{refl.relists} relist(s)")
                continue
            for key, obj in truth.items():
                mirrored = refl.known[key]
                if getattr(obj.spec, "node_name", "") != \
                        getattr(mirrored.spec, "node_name", ""):
                    violations.append(
                        f"fabric mirror stale on {key}: node "
                        f"{getattr(mirrored.spec, 'node_name', '')!r} vs "
                        f"store {getattr(obj.spec, 'node_name', '')!r}")
        return violations

    def record_violation(self, message: str) -> None:
        self.violations.append(message)
        note_fault("invariant_violation", {"message": message})

    def summary(self) -> dict:
        return {
            "boundaries": self.boundary,
            "churn_fired": len(self.fired),
            "churn_skipped": len(self.skipped),
            "evicted": sorted(self.evicted_keys),
            "retries": dict(sorted(self.retries.items())),
            "fabric_injected": (list(self.fabric_injector.injected)
                                if self.fabric_injector else []),
            "fabric_relists": sum(r.relists for r in self._mirrors),
            "device_injected": (list(self.device_injector.injected)
                                if self.device_injector else []),
            "violations": list(self.violations),
        }


def check_invariants(cc, engine: ChaosEngine) -> List[str]:
    """End-state audit of a chaos run. Returns violation strings (empty =
    the system degraded gracefully):

    - **no pod lost** — every fed pod terminates scheduled or
      unschedulable (evicted seed pods are accounted as evicted, and
      evicted fed pods were re-fed so they too must terminate);
    - **no double-bind** — no pod occupies two placements: the success
      list is key-unique and agrees with the store's bound state;
    - **no bind to a deleted node** — checked at bind time by the
      simulator's seam (engine.record_violation) and re-checked here
      against the store's surviving nodes;
    - **fabric reconvergence** — when fabric faults are planned, the
      mirror consumer behind the lossy stream must end in agreement with
      the store (engine.audit_fabric).
    """
    from tpusim_torch.api.types import ResourceType

    violations = list(engine.violations)
    violations.extend(engine.audit_fabric())
    st = cc.status
    scheduled_keys = [p.key() for p in st.successful_pods]
    scheduled_set = set(scheduled_keys)
    failed_set = {p.key() for p in st.failed_pods}

    # no pod lost
    for key in engine.fed_keys:
        if key in scheduled_set:
            continue
        if key in failed_set:
            continue
        if key in engine.evicted_keys and key not in engine.requeued_keys:
            continue
        violations.append(f"pod lost: {key} is neither scheduled, "
                          "unschedulable, nor accounted as evicted")

    # no double-bind
    dupes = {k for k in scheduled_set if scheduled_keys.count(k) > 1}
    for key in sorted(dupes):
        violations.append(f"double-bind: {key} appears "
                          f"{scheduled_keys.count(key)}x in successful_pods")
    for p in st.successful_pods:
        stored, ok = cc.resource_store.get(ResourceType.PODS, p.key())
        if not ok:
            if p.key() not in engine.evicted_keys:
                violations.append(f"bound pod {p.key()} missing from store")
        elif stored.spec.node_name != p.spec.node_name:
            violations.append(
                f"double-bind: {p.key()} bound to {p.spec.node_name} but "
                f"store says {stored.spec.node_name}")

    # no bind to a deleted node (bind-time seam already recorded live
    # violations; this catches placements that survived node deletion
    # without eviction bookkeeping going through the fabric)
    live_nodes = {n.name for n in cc.resource_store.list(ResourceType.NODES)}
    for p in st.successful_pods:
        node = p.spec.node_name
        if node not in live_nodes and node not in engine.deleted_nodes:
            violations.append(f"{p.key()} bound to unknown node {node}")

    # no partial gang bound (gang/): a pod group either holds at
    # least its min-available members or none at all — chaos that breaks a
    # gang mid-flight must have released every member
    from tpusim_torch.gang.group import PodGroup, gang_name

    members: Dict[str, Dict[str, object]] = {}
    for p in (list(cc.resource_store.list(ResourceType.PODS))
              + st.successful_pods + st.failed_pods):
        name = gang_name(p)
        if name:
            members.setdefault(name, {})[p.key()] = p
    for name, by_key in sorted(members.items()):
        group = PodGroup(name=name, pods=list(by_key.values()))
        bound = sum(1 for p in cc.resource_store.list(ResourceType.PODS)
                    if gang_name(p) == name and p.spec.node_name)
        if 0 < bound < group.min_available:
            violations.append(
                f"partial gang bound: group {name} holds {bound}/"
                f"{len(group.pods)} members (min-available "
                f"{group.min_available})")

    # cache/store coherence: every store-bound pod the cache still tracks
    # must agree on its node (the informer seam never diverged)
    for key, state in cc.cache.pod_states.items():
        stored, ok = cc.resource_store.get(ResourceType.PODS, key)
        if ok and stored.spec.node_name and \
                state.pod.spec.node_name != stored.spec.node_name:
            violations.append(
                f"cache/store divergence for {key}: cache on "
                f"{state.pod.spec.node_name}, store on "
                f"{stored.spec.node_name}")
    return violations


def audit_failover(records) -> List[str]:
    """Journal-level invariant audit across a leader failover.

    Input is the [(offset, record)] list of the FULL post-failover WAL —
    leader prefix, recomputed crash tail, and promoted-leader
    continuation all in one journal. Returns violation strings:

    - **no pod lost** — every emit record's scheduled count ``s`` is
      matched by exactly that many bind entries for its cycle, and every
      emit accounts for its whole batch (``n`` == the batch size);
    - **no double-bind** — no pod key is bound to two different nodes
      without an intervening DELETED event for it (a rebind of a live
      pod across the failover boundary would mean the promoted twin
      re-decided a cycle the dead leader had already committed);
    - **bind provenance** — every bind entry's pod key belongs to its
      cycle's batch record.
    """
    violations: List[str] = []
    batch_keys: Dict[int, Set[str]] = {}
    batch_sizes: Dict[int, int] = {}
    binds_by_cycle: Dict[int, List[Tuple[str, str]]] = {}
    bound_to: Dict[str, str] = {}
    for _ofs, rec in records:
        k, c = rec.get("k"), int(rec.get("c", -1))
        if k == "batch":
            keys = set()
            for obj in rec.get("pods", []):
                md = obj.get("metadata", obj)
                ns = md.get("namespace") or "default"
                keys.add(f"{ns}/{md.get('name')}")
            batch_keys[c] = keys
            batch_sizes[c] = len(rec.get("pods", []))
        elif k == "ev" and rec.get("t") == "DELETED" \
                and rec.get("r") == "pod":
            obj = rec.get("o", {})
            md = obj.get("metadata", obj)
            ns = md.get("namespace") or "default"
            bound_to.pop(f"{ns}/{md.get('name')}", None)
        elif k == "bind":
            entries = [(key, node) for key, node in rec.get("b", [])]
            binds_by_cycle.setdefault(c, []).extend(entries)
            for key, node in entries:
                prev = bound_to.get(key)
                if prev is not None and prev != node:
                    violations.append(
                        f"double-bind across failover: {key} bound to "
                        f"{prev} then {node} (cycle {c})")
                bound_to[key] = node
                keys = batch_keys.get(c)
                if keys is not None and key not in keys:
                    violations.append(
                        f"bind without batch: {key} in cycle {c}")
        elif k == "emit":
            n, s = int(rec.get("n", 0)), int(rec.get("s", 0))
            got = len(binds_by_cycle.get(c, []))
            if got != s:
                violations.append(
                    f"pod lost in cycle {c}: emit says {s} scheduled "
                    f"but the journal holds {got} bind entries")
            size = batch_sizes.get(c)
            if size is not None and n != size:
                violations.append(
                    f"pod lost in cycle {c}: emit covers {n} decisions "
                    f"for a batch of {size}")
    return violations
