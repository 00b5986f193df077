"""The declarative fault plan: what breaks, where, and when.

A plan is plain data — JSON on disk, dataclasses in memory — so a chaos
run is a pure function of (workload, snapshot, plan): replaying the same
plan reproduces the same fault sequence byte-for-byte. Three sections,
one per injection layer:

``churn``   scripted cluster events fired through the store at pod-attempt
            boundaries: ``node_delete``, ``node_cordon``, ``node_flap``
            (delete + re-add ``restore_after`` boundaries later), and
            ``pod_evict``. ``process_crash`` rides in this section too but
            fires from the persistence layer, not the attempt loop: the
            process dies right after the targeted WAL record (``target``
            names a record kind, one of CRASH_POINTS) of cycle ``at`` is
            durably written.
``fabric``  watch-stream faults keyed by the global fan-out event index:
            ``drop`` (the frame never reaches the watcher), ``dup`` (the
            frame is delivered twice), ``disconnect`` (the stream closes
            mid-flight with a transport error — the reflector must relist).
``device``  per-dispatch backend faults keyed by dispatch index:
            ``exception`` (the dispatch dies), ``corrupt_invalid``
            (out-of-range/NaN outputs — caught structurally), and
            ``corrupt_silent`` (in-range but wrong placements — caught
            only by host verification), plus the breaker thresholds.

Schema example (the README "Chaos & fault injection" quickstart):

    {
      "seed": 42,
      "max_retries": 3,
      "churn": [
        {"at": 2, "action": "node_delete", "target": "node-1"},
        {"at": 3, "action": "node_cordon", "target": "node-2"},
        {"at": 4, "action": "node_flap", "target": "node-0",
         "restore_after": 2},
        {"at": 5, "action": "pod_evict", "target": "default/web-1"}
      ],
      "fabric": {"drop": [4], "dup": [7], "disconnect": [9]},
      "device": {"faults": {"0": "exception", "1": "corrupt_silent"},
                 "failure_threshold": 2, "cooldown": 2, "verify": "all"}
    }
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

CHURN_ACTIONS = ("node_delete", "node_cordon", "node_flap", "pod_evict",
                 "process_crash")
DEVICE_FAULTS = ("exception", "corrupt_invalid", "corrupt_silent")
DEVICE_VERIFY_MODES = ("all", "probe")
# process_crash targets: the WAL record kind of cycle ``at`` the process
# dies immediately after (stream.persist writes the record, then raises) —
# together they cover every commit boundary a streaming cycle has
CRASH_POINTS = ("events", "batch", "bind", "emit")


class PlanError(ValueError):
    """A malformed fault plan (schema violation)."""


@dataclass(frozen=True)
class ChurnEvent:
    """One scripted cluster event, fired at pod-attempt boundary ``at``."""

    at: int                 # attempt boundary (0 = before the first attempt)
    action: str             # one of CHURN_ACTIONS
    target: str             # node name, or pod key (ns/name) for pod_evict
    restore_after: int = 0  # node_flap: boundaries until the node re-adds

    def validate(self) -> None:
        if self.action not in CHURN_ACTIONS:
            raise PlanError(f"unknown churn action {self.action!r} "
                            f"(expected one of {CHURN_ACTIONS})")
        if self.at < 0:
            raise PlanError(f"churn event {self.target!r}: negative boundary")
        if self.action == "node_flap" and self.restore_after < 1:
            raise PlanError(f"node_flap {self.target!r}: restore_after "
                            "must be >= 1")
        if self.action == "process_crash" and self.target not in CRASH_POINTS:
            raise PlanError(f"process_crash target must be a WAL record "
                            f"kind {CRASH_POINTS}, got {self.target!r}")


@dataclass
class FabricFaultPlan:
    """Watch-fabric faults by global fan-out event index (the order frames
    leave FakeRESTClient.emit_object_watch_event, which is deterministic in
    the single-threaded simulator)."""

    drop: List[int] = field(default_factory=list)
    dup: List[int] = field(default_factory=list)
    disconnect: List[int] = field(default_factory=list)

    def validate(self) -> None:
        for name in ("drop", "dup", "disconnect"):
            idxs = getattr(self, name)
            if any(i < 0 for i in idxs):
                raise PlanError(f"fabric.{name}: negative event index")
        overlap = set(self.drop) & set(self.dup)
        if overlap:
            raise PlanError(f"fabric: event(s) {sorted(overlap)} are both "
                            "dropped and duplicated")

    def empty(self) -> bool:
        return not (self.drop or self.dup or self.disconnect)


@dataclass
class DeviceFaultPlan:
    """Device-backend faults by dispatch index, plus breaker tuning."""

    faults: Dict[int, str] = field(default_factory=dict)
    failure_threshold: int = 3   # consecutive faults before the breaker opens
    cooldown: int = 2            # denied dispatches before half-open re-probe
    verify: str = "all"          # "all": host-verify every device batch under
                                 # chaos; "probe": only half-open probes

    def validate(self) -> None:
        for idx, kind in self.faults.items():
            if idx < 0:
                raise PlanError("device.faults: negative dispatch index")
            if kind not in DEVICE_FAULTS:
                raise PlanError(f"unknown device fault {kind!r} "
                                f"(expected one of {DEVICE_FAULTS})")
        if self.failure_threshold < 1:
            raise PlanError("device.failure_threshold must be >= 1")
        if self.cooldown < 1:
            raise PlanError("device.cooldown must be >= 1")
        if self.verify not in DEVICE_VERIFY_MODES:
            raise PlanError(f"device.verify must be one of "
                            f"{DEVICE_VERIFY_MODES}, got {self.verify!r}")

    def empty(self) -> bool:
        return not self.faults


@dataclass
class FaultPlan:
    """The full declarative plan; every section optional."""

    seed: int = 0
    max_retries: int = 3        # per-pod re-attempts after churn requeues
    churn: List[ChurnEvent] = field(default_factory=list)
    fabric: FabricFaultPlan = field(default_factory=FabricFaultPlan)
    device: DeviceFaultPlan = field(default_factory=DeviceFaultPlan)

    def validate(self) -> "FaultPlan":
        if self.max_retries < 0:
            raise PlanError("max_retries must be >= 0")
        for ev in self.churn:
            ev.validate()
        self.fabric.validate()
        self.device.validate()
        return self

    def host_sections_empty(self) -> bool:
        """True when only device faults and/or process crashes are planned
        (the torch batch path has no per-attempt boundary, so node/pod churn
        and fabric faults are host-orchestrator sections; a process_crash
        is fired by the persistence layer, not the attempt loop)."""
        return (self.fabric.empty()
                and all(ev.action == "process_crash" for ev in self.churn))

    def crash_events(self) -> List[ChurnEvent]:
        """The plan's scripted process deaths, in firing order."""
        return sorted((ev for ev in self.churn
                       if ev.action == "process_crash"),
                      key=lambda ev: (ev.at, ev.target))

    # -- (de)serialization -------------------------------------------------

    def to_obj(self) -> dict:
        obj: dict = {"seed": self.seed, "max_retries": self.max_retries}
        if self.churn:
            obj["churn"] = [
                {k: v for k, v in (("at", ev.at), ("action", ev.action),
                                   ("target", ev.target),
                                   ("restore_after", ev.restore_after))
                 if not (k == "restore_after" and v == 0)}
                for ev in self.churn]
        if not self.fabric.empty():
            obj["fabric"] = {k: v for k, v in
                             (("drop", self.fabric.drop),
                              ("dup", self.fabric.dup),
                              ("disconnect", self.fabric.disconnect)) if v}
        if not self.device.empty():
            obj["device"] = {
                "faults": {str(i): kind
                           for i, kind in sorted(self.device.faults.items())},
                "failure_threshold": self.device.failure_threshold,
                "cooldown": self.device.cooldown,
                "verify": self.device.verify,
            }
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_obj(), sort_keys=True, indent=2) + "\n"

    @classmethod
    def from_obj(cls, obj: dict) -> "FaultPlan":
        if not isinstance(obj, dict):
            raise PlanError(f"plan must be a JSON object, got "
                            f"{type(obj).__name__}")
        unknown = set(obj) - {"seed", "max_retries", "churn", "fabric",
                              "device"}
        if unknown:
            raise PlanError(f"unknown plan key(s): {sorted(unknown)}")
        churn = []
        for i, entry in enumerate(obj.get("churn") or []):
            if not isinstance(entry, dict):
                raise PlanError(f"churn[{i}] must be an object")
            try:
                churn.append(ChurnEvent(
                    at=int(entry["at"]), action=str(entry["action"]),
                    target=str(entry["target"]),
                    restore_after=int(entry.get("restore_after", 0))))
            except KeyError as exc:
                raise PlanError(f"churn[{i}]: missing {exc}") from exc
        fab = obj.get("fabric") or {}
        if not isinstance(fab, dict):
            raise PlanError("fabric must be an object")
        fabric = FabricFaultPlan(
            drop=[int(i) for i in fab.get("drop") or []],
            dup=[int(i) for i in fab.get("dup") or []],
            disconnect=[int(i) for i in fab.get("disconnect") or []])
        dev = obj.get("device") or {}
        if not isinstance(dev, dict):
            raise PlanError("device must be an object")
        device = DeviceFaultPlan(
            faults={int(i): str(kind)
                    for i, kind in (dev.get("faults") or {}).items()},
            failure_threshold=int(dev.get("failure_threshold", 3)),
            cooldown=int(dev.get("cooldown", 2)),
            verify=str(dev.get("verify", "all")))
        return cls(seed=int(obj.get("seed", 0)),
                   max_retries=int(obj.get("max_retries", 3)),
                   churn=churn, fabric=fabric, device=device).validate()


def load_plan(path: str) -> FaultPlan:
    """Parse a fault-plan JSON file (raises PlanError/OSError)."""
    with open(path, "r", encoding="utf-8") as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as exc:
            raise PlanError(f"{path}: not JSON: {exc}") from exc
    return FaultPlan.from_obj(obj)


def random_crash_plan(seed: int, cycles: int,
                      points=CRASH_POINTS) -> FaultPlan:
    """One seeded process_crash at a random (cycle, WAL-record) boundary —
    the crash-recovery fuzz unit. Deterministic in ``seed``; the cycle is
    drawn from [0, cycles) and the record kind from ``points``, so a seed
    sweep covers every commit boundary class the streaming cycle has."""
    if cycles < 1:
        raise PlanError("random_crash_plan needs cycles >= 1")
    rng = random.Random(seed)
    ev = ChurnEvent(at=rng.randrange(cycles), action="process_crash",
                    target=rng.choice(tuple(points)))
    return FaultPlan(seed=seed, churn=[ev]).validate()


def kill_leader_campaign(seed: int, cycles: int,
                         points=CRASH_POINTS) -> List[FaultPlan]:
    """A kill-the-leader campaign: one FaultPlan per WAL
    record boundary class, each crashing the LEADER of a replicated pair
    at a seeded mid-run cycle. The failover matrix runs every plan
    against the same workload and asserts that a follower promotes with
    a byte-identical placement-hash chain head at all four boundaries.

    Crash cycles are drawn from the middle half of the run ([cycles/4,
    3*cycles/4)) so every campaign leaves both a replicated prefix to
    promote FROM and a post-failover tail to keep scheduling INTO —
    a crash at cycle 0 or the final cycle would test recovery, not
    continuity. Deterministic in ``seed``."""
    if cycles < 4:
        raise PlanError("kill_leader_campaign needs cycles >= 4")
    rng = random.Random(seed)
    lo, hi = cycles // 4, max(cycles // 4 + 1, (3 * cycles) // 4)
    return [FaultPlan(seed=seed, churn=[
        ChurnEvent(at=rng.randrange(lo, hi), action="process_crash",
                   target=point)]).validate()
        for point in points]


def random_plan(seed: int, node_names: List[str], pod_keys: List[str],
                attempts: int, device_dispatches: int = 0,
                max_retries: int = 3,
                keep_nodes: int = 1) -> FaultPlan:
    """Generate a seeded adversarial plan against a concrete workload.

    Deterministic: ``random.Random(seed)`` drives every choice, so the
    fault-fuzz matrix replays byte-identically. ``keep_nodes`` nodes are
    never deleted/cordoned (a cluster with zero schedulable nodes proves
    nothing beyond the all-unschedulable arm, which gets its own fixed
    case in the test matrix). ``device_dispatches`` > 0 additionally
    scripts device faults over that many dispatch indices.
    """
    rng = random.Random(seed)
    attempts = max(attempts, 1)
    churn: List[ChurnEvent] = []
    killable = list(node_names[keep_nodes:])
    rng.shuffle(killable)
    n_node_events = min(len(killable), rng.randint(0, 2 + len(killable) // 2))
    for name in killable[:n_node_events]:
        action = rng.choice(("node_delete", "node_cordon", "node_flap"))
        churn.append(ChurnEvent(
            at=rng.randrange(attempts), action=action, target=name,
            restore_after=rng.randint(1, 3) if action == "node_flap" else 0))
    evictable = list(pod_keys)
    rng.shuffle(evictable)
    for key in evictable[:rng.randint(0, min(2, len(evictable)))]:
        churn.append(ChurnEvent(at=rng.randrange(attempts),
                                action="pod_evict", target=key))
    churn.sort(key=lambda ev: (ev.at, ev.action, ev.target))

    # fabric faults over a conservative estimate of the fan-out stream:
    # every attempt emits at least an ADDED (feed) frame; churn adds more
    n_events = attempts * 2 + len(churn) + len(node_names)
    idxs = rng.sample(range(n_events), min(n_events, rng.randint(0, 5)))
    fabric = FabricFaultPlan()
    for i in sorted(idxs):
        bucket = rng.choice(("drop", "dup", "disconnect"))
        getattr(fabric, bucket).append(i)

    device = DeviceFaultPlan()
    if device_dispatches > 0:
        threshold = rng.randint(1, 3)
        n_faults = rng.randint(threshold, min(device_dispatches,
                                              threshold + 2))
        for i in rng.sample(range(device_dispatches),
                            min(n_faults, device_dispatches)):
            device.faults[i] = rng.choice(DEVICE_FAULTS)
        device.failure_threshold = threshold
        device.cooldown = rng.randint(1, 2)
    return FaultPlan(seed=seed, max_retries=max_retries, churn=churn,
                     fabric=fabric, device=device).validate()
