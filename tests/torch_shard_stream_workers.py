"""Rank functions of tests/test_torch_shard_stream.py: the port's node-
sharded streaming twin under k gloo ranks on the CPU.

stream_rank runs every arm of one world size in one spawn
(sharding.run_ranks), each rank the same calls with TPUSIM_SHARDS=k, and
returns what the parent compares: the chains of every feed, the overlay
checks, the checkpoint's manifest and WAL bytes, and at k = 2 the crash
recovery, the promotion, the follower's restage, the audit and the
fallbacks. single() is the same feed on the port's single-device twin, in
the parent. Directories come from the parent's temporary root; each rank
journals under sharding.rank_directory.
"""

import copy
import json
import os
import shutil

# every feed at 16-64 nodes: evictions and node flaps (restages), a node
# count no shard count divides (padding), label and taint churn under a
# policy without ServiceAffinity, pipelined cycles with overlay queries,
# and gang cycles beside plain ones
FEEDS = {
    "churn": dict(num_nodes=20, cycles=6, arrivals=6, evict_fraction=0.25,
                  node_flap_every=3, seed=5),
    "padded": dict(num_nodes=23, cycles=5, arrivals=7, evict_fraction=0.25,
                   node_flap_every=2, seed=11),
    "labels": dict(num_nodes=16, cycles=5, arrivals=5, seed=3,
                   label_churn=2, taint_churn=1, policy=True),
    "pipelined": dict(num_nodes=20, cycles=6, arrivals=6, seed=7,
                      node_flap_every=4, pipeline=True, whatif_every=2),
    "gang": dict(num_nodes=24, cycles=4, arrivals=5, seed=2, gang_size=3,
                 gang_count=1),
}
KEYS = ("placement_chain", "fold_chain", "paths", "restages", "commits",
        "load")
# the checkpointed run whose manifest and WAL the layout test reads
CHECKPOINTED = dict(num_nodes=23, cycles=6, arrivals=6,
                    evict_fraction=0.25, node_flap_every=4, seed=9)
CHECKPOINT_EVERY = 2
# the crash recovery and the promotion (tests/test_torch_replicate.py's
# workload)
CRASH = (3, "bind")
REPLICATED = dict(num_nodes=16, cycles=6, arrivals=12, evict_fraction=0.25,
                  node_flap_every=3, seed=5)
# the audit's same-seed pair: a checkpoint at cycle 4 anchors the replay of
# cycle 5, whose first bind the copy flips
AUDITED = dict(num_nodes=16, cycles=6, arrivals=8, evict_fraction=0.25,
               seed=7)
AUDIT_CHECKPOINT_EVERY = 4
FLIPPED_CYCLE = 5


def policy_dict(service_affinity: bool = False) -> dict:
    """bench config 10's stream policy, with or without its
    ServiceAffinity predicate (the sharded route declines it)."""
    from tpusim_torch.workloads import STREAM_POLICY

    policy = copy.deepcopy(STREAM_POLICY)
    if not service_affinity:
        policy["predicates"] = [p for p in policy["predicates"]
                                if p["name"] != "TestServiceAffinity"]
    return policy


def feed_kwargs(name: str, decode) -> dict:
    """FEEDS[name] with its policy decoded by `decode` (either package's
    decode_policy)."""
    kw = dict(FEEDS[name])
    if kw.pop("policy", False):
        kw["policy"] = decode(policy_dict())
    return kw


def summary(out: dict) -> dict:
    got = {key: out[key] for key in KEYS}
    if "overlay" in out:
        got["overlay"] = {k: out["overlay"][k]
                          for k in ("queries", "answered", "fallbacks")}
    return got


def single(name: str) -> dict:
    """FEEDS[name] on the port's single-device twin."""
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.simulator import run_stream_simulation

    return summary(run_stream_simulation(device="cpu",
                                         **feed_kwargs(name, decode_policy)))


def _spans(rec) -> dict:
    names = [e["name"] for e in list(rec.events)
             if e["name"].startswith("shard:")]
    return {n: names.count(n) for n in sorted(set(names))}


def _chains(names=tuple(FEEDS), device="cpu") -> dict:
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import recorder as flight
    from tpusim_torch.simulator import run_stream_simulation

    m = register()
    out = {"gauges": {}}
    for name in names:
        rec = flight.install(flight.FlightRecorder())
        try:
            got = run_stream_simulation(
                device=device, **feed_kwargs(name, decode_policy))
        finally:
            flight.uninstall()
        out[name] = summary(got)
        out[name]["spans"] = _spans(rec)
        out["gauges"][name] = (m.shard_count.value,
                               dict(m.shard_node_occupancy.values))
    return out


def analytics_run(name: str = "pipelined", device="cpu") -> dict:
    """FEEDS[name] with the analytics plane sampling every cycle, inputs
    kept: the samples without their time stamps, and the kept inputs
    against host_reduce."""
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.obs import analytics
    from tpusim_torch.simulator import run_stream_simulation

    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0))
    try:
        run_stream_simulation(device=device,
                              **feed_kwargs(name, decode_policy))
        samples = log.series(limit=len(log.samples()))
        problems = log.verify_against_host()
    finally:
        analytics.uninstall()
    for sample in samples:
        sample.pop("ts", None)
    return {"samples": samples, "problems": problems}


def _query_pods(cycle: int, n: int = 4):
    from tpusim_torch.api.snapshot import make_pod

    return [make_pod(f"q-{cycle}-{i}", milli_cpu=300 + 150 * i,
                     memory=(1 + i) << 28) for i in range(n)]


def _carry(session):
    """The resident carry put together from the ranks' blocks."""
    from tpusim_torch.scan import CARRY_AXES, gather_nodes

    dev = session.device
    return {name: (gather_nodes(dev.shard, t, CARRY_AXES[name].index("node"))
                   if "node" in CARRY_AXES[name] else t).clone()
            for name, t in dev.carry._asdict().items()}


def _overlays() -> dict:
    """tests/test_stream.py::test_overlay_sharded_twin on the port: the
    queries ride the sharded twin, answer as the staged run_what_if does,
    leave the carry bit-equal, and a session that answers them keeps the
    chain of one that answers none."""
    import torch

    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.stream import ChurnLoadGen, StreamSession
    from tpusim_torch.whatif import run_what_if

    def fresh():
        return (StreamSession(synthetic_cluster(16), device="cpu"),
                ChurnLoadGen(synthetic_cluster(16), seed=2, arrivals=16,
                             evict_fraction=0.25))

    quiet, qg = fresh()
    live, lg = fresh()
    checks = {"answered": 0, "oracle": True, "carry": True,
              "lockstep": True}
    for cycle in range(6):
        quiet.apply_events(qg.events(cycle))
        a = quiet.schedule(qg.batch())
        qg.note_bound(a)
        live.apply_events(lg.events(cycle))
        b = live.schedule(lg.batch())
        lg.note_bound(b)
        checks["lockstep"] &= placement_hash(a) == placement_hash(b)
        if cycle % 2 == 1:
            pods = _query_pods(cycle, n=6)
            before = _carry(live)
            got = live.overlay_query(pods)
            if got is None:
                continue
            checks["answered"] += 1
            after = _carry(live)
            checks["carry"] &= all(torch.equal(before[k], after[k])
                                   for k in before)
            [oracle] = run_what_if([(live.inc.to_snapshot(), pods)],
                                   device="cpu")
            checks["oracle"] &= (placement_hash(got)
                                 == placement_hash(oracle.placements))
    checks["layout"] = live._shard_layout
    return checks


def _manifest(directory: str) -> dict:
    from tpusim_torch.stream.persist import StreamPersistence

    with open(os.path.join(directory, StreamPersistence.CHECKPOINT)) as f:
        ck = json.load(f)
    ck.pop("snapshot")
    return ck


def _wal(directory: str) -> bytes:
    from tpusim_torch.stream.persist import StreamPersistence

    with open(os.path.join(directory, StreamPersistence.WAL), "rb") as f:
        return f.read()


def _checkpointed(root: str, device="cpu") -> dict:
    from tpusim_torch.sharding import rank_directory
    from tpusim_torch.simulator import run_stream_simulation

    named = os.path.join(root, "ck")
    out = run_stream_simulation(device=device, **CHECKPOINTED,
                                checkpoint_dir=named,
                                checkpoint_every=CHECKPOINT_EVERY)
    directory = rank_directory(named)
    return {"dir": directory, "fold_chain": out["fold_chain"],
            "manifest": _manifest(directory), "wal": _wal(directory)}


def _recovery(root: str) -> dict:
    """CHECKPOINTED crashed at CRASH, then recovered."""
    from tpusim_torch.chaos.engine import ProcessCrash, audit_failover
    from tpusim_torch.chaos.plan import ChurnEvent, FaultPlan
    from tpusim_torch.sharding import rank_directory
    from tpusim_torch.simulator import run_stream_simulation
    from tpusim_torch.stream.persist import read_wal

    named = os.path.join(root, "crash")
    at, point = CRASH
    plan = FaultPlan(seed=0, churn=[ChurnEvent(
        at=at, action="process_crash", target=point)])
    try:
        run_stream_simulation(device="cpu", **CHECKPOINTED,
                              checkpoint_dir=named,
                              checkpoint_every=CHECKPOINT_EVERY,
                              chaos_plan=plan)
        crashed = False
    except ProcessCrash:
        crashed = True
    out = run_stream_simulation(device="cpu", **CHECKPOINTED,
                                checkpoint_dir=named,
                                checkpoint_every=CHECKPOINT_EVERY,
                                recover=True)
    directory = rank_directory(named)
    records, torn = read_wal(os.path.join(directory, "wal.jsonl"))
    return {"crashed": crashed, "fold_chain": out["fold_chain"],
            "violations": out["recovery_violations"],
            "restages": out["restages"], "torn": torn,
            "audit": audit_failover(records),
            "layout": _manifest(directory)["shard_layout"]}


def _replication(root: str, world: int) -> dict:
    """The promotion of tests/test_replicate.py::test_kill_leader_sharded_
    twin, and a leader checkpoint announcing another shard count."""
    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.chaos.engine import audit_failover
    from tpusim_torch.chaos.plan import CRASH_POINTS, kill_leader_campaign
    from tpusim_torch.sharding import rank_directory
    from tpusim_torch.simulator import run_replicated_stream
    from tpusim_torch.stream import ChurnLoadGen
    from tpusim_torch.stream.persist import read_wal
    from tpusim_torch.stream.replicate import FollowerTwin

    named = os.path.join(root, "repl")
    plan = kill_leader_campaign(seed=5, cycles=REPLICATED["cycles"])[
        CRASH_POINTS.index("emit")]
    out = run_replicated_stream(device="cpu", **REPLICATED,
                                checkpoint_dir=named, checkpoint_every=2,
                                chaos_plan=plan)
    records, torn = read_wal(os.path.join(rank_directory(named),
                                          "wal.jsonl"))
    got = {key: out[key] for key in (
        "promoted", "fold_chain", "promotion_violations", "divergence",
        "follower_restages")}
    got["audit"] = audit_failover(records) + torn
    # the follower's restage for a leader layout of another shard count:
    # once, classified "replicated", and none for its own
    follower = FollowerTwin(synthetic_cluster(16), device="cpu",
                            mesh_tag="announce")
    try:
        gen = ChurnLoadGen(synthetic_cluster(16), seed=3, arrivals=6)
        session = follower.session
        layouts = []
        for cycle in range(4):
            if cycle == 1:
                follower._apply_ckpt({"shard_layout": dict(
                    session._shard_layout, shards=2 * world)})
            if cycle == 2:
                follower._apply_ckpt({"shard_layout": dict(
                    session._shard_layout)})
            session.apply_events(gen.events(cycle))
            gen.note_bound(session.schedule(gen.batch()))
            layouts.append(session._shard_layout)
        got["announced"] = {"restages": dict(session.restage_counts),
                            "layouts": layouts}
    finally:
        follower.stop()
    return got


LAGGED_CRASH = 3


def _lagged_promotion(rank: int, root: str) -> dict:
    """The two ranks' followers lag their leaders differently at the
    leader's death after cycle LAGGED_CRASH's emit record: rank 0's has
    every frame (it decides that cycle live), rank 1's link dies before
    the cycle's bind record (its promotion decides the cycle from the
    tail). Each rank decides every cycle once, so the followers'
    collectives stay in step, and both promote onto the crash-free
    chain."""
    import threading
    import time

    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backends import Placement, bind_pod
    from tpusim_torch.chaos.engine import ProcessCrash, audit_failover
    from tpusim_torch.simulator import (
        FOLLOWER_MESH,
        LEADER_MESH,
        _twin_meshes,
    )
    from tpusim_torch.stream import (
        ChurnLoadGen,
        StreamPersistence,
        StreamSession,
    )
    from tpusim_torch.stream.persist import read_wal
    from tpusim_torch.stream.replicate import (
        FailoverController,
        FollowerTwin,
        WalShipper,
    )

    gen_kw = {k: v for k, v in REPLICATED.items()
              if k not in ("num_nodes", "cycles")}
    cycles = REPLICATED["cycles"]
    directory = os.path.join(root, f"lagged-{rank}")
    _twin_meshes("cpu", (LEADER_MESH, FOLLOWER_MESH))
    follower = FollowerTwin(synthetic_cluster(16), device="cpu",
                            mesh_tag=FOLLOWER_MESH)
    leader = StreamSession(synthetic_cluster(16), device="cpu",
                           mesh_tag=LEADER_MESH)
    persist = StreamPersistence(directory, checkpoint_every=2)
    shipper = WalShipper(persist, follower.address)
    leader.attach_persistence(persist)
    persist.arm_crash(LAGGED_CRASH, "emit")
    if rank == 1:
        ship = persist.on_append
        cut = threading.Event()

        def on_append(rec, kind, cycle, start, end):
            if not cut.is_set() and rec["k"] == "bind" \
                    and int(rec["c"]) == LAGGED_CRASH:
                cut.set()
                shipper.close(drain=True, timeout=60.0)   # the link dies
            ship(rec, kind, cycle, start, end)

        persist.on_append = on_append
    gen = ChurnLoadGen(synthetic_cluster(16), **gen_kw)
    try:
        try:
            for cycle in range(cycles):
                leader.apply_events(gen.events(cycle))
                gen.note_bound(leader.schedule(gen.batch()))
            crashed = False
        except ProcessCrash:
            crashed = True
        persist.close()
        if rank == 0:
            # every frame, the crash cycle's emit among them, applied
            deadline = time.monotonic() + 60.0
            while follower.applied_seq < shipper.enqueued() - 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
        live = LAGGED_CRASH in follower._emitted
        promoted, report = FailoverController(
            lambda: False, [follower], directory, interval_s=0.001,
            misses=1, checkpoint_every=2, leader_was_alive=True).run(60.0)
        resume = report.resume_cycle
        gen2 = ChurnLoadGen(synthetic_cluster(16), **gen_kw)
        for c in range(resume):
            gen2.events(c)
            by_key = {p.key(): p for p in gen2.batch()}
            gen2.note_bound([
                Placement(pod=bind_pod(by_key[k], node), node_name=node)
                for k, node in promoted.bound_by_cycle.get(c, [])
                if k in by_key])
        skip = promoted.events_applied.get(resume, 0)
        for cycle in range(resume, cycles):
            evs = gen2.events(cycle)[skip:]
            skip = 0
            promoted.session.apply_events(evs)
            gen2.note_bound(promoted.session.schedule(gen2.batch()))
        promoted.persist.close()
        records, torn = read_wal(os.path.join(directory, "wal.jsonl"))
        return {"crashed": crashed, "live": live,
                "decided": promoted.session.cycles,
                "chain": promoted.persist.chain,
                "violations": report.violations,
                "audit": audit_failover(records) + torn}
    finally:
        shipper.close(drain=False, timeout=0.0)
        persist.close()
        follower.stop()


def _flip_first_bind(src: str, dst: str, cycle: int) -> tuple:
    """A copy of WAL directory `src` at `dst` with the first bind of
    `cycle` moved to another node: (pod, old node, new node)."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "wal.jsonl")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    nodes = sorted({n for r in records if r["k"] == "bind"
                    for _, n in r["b"]})
    target = next(r for r in records if r["k"] == "bind"
                  and r["c"] == cycle and r["b"])
    pod, old = target["b"][0]
    new = next(n for n in nodes if n != old)
    target["b"][0] = [pod, new]
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")
    return pod, old, new


def strip_report(report: dict) -> dict:
    """An audit report without its wall times and directory names."""
    out = copy.deepcopy(report)
    for rec in out.get("replay", {}).get("decisions", []):
        rec.pop("ts", None)
    for key in ("a", "b"):
        out.pop(key, None)
    return out


def _audit(root: str) -> dict:
    """Two same-seed runs give one chain; the audit of the first against a
    copy with one flipped bind names the cycle and the pod."""
    from tpusim_torch.obs.audit import audit_wal_pair
    from tpusim_torch.sharding import rank_directory
    from tpusim_torch.simulator import run_stream_simulation

    chains = []
    for side in ("a", "b"):
        chains.append(run_stream_simulation(
            device="cpu", **AUDITED,
            checkpoint_dir=os.path.join(root, f"audit-{side}"),
            checkpoint_every=AUDIT_CHECKPOINT_EVERY)["fold_chain"])
    a = rank_directory(os.path.join(root, "audit-a"))
    b = rank_directory(os.path.join(root, "audit-b"))
    flipped = b + "-flipped"
    flip = _flip_first_bind(b, flipped, FLIPPED_CYCLE)
    same = audit_wal_pair(a, b, device="cpu")
    report = audit_wal_pair(a, flipped, device="cpu")
    return {"chains": chains, "same": same["verdict"], "flip": flip,
            "report": strip_report(report), "dirs": (a, flipped)}


def _fallbacks(world: int) -> dict:
    """Each reason the twin stays single-device, counted: a ServiceAffinity
    policy, explain lanes in the config, a group of another size."""
    from dataclasses import replace

    from tpusim_torch.api.snapshot import synthetic_cluster
    from tpusim_torch.backends import placement_hash
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.stream import ChurnLoadGen, StreamSession
    from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE

    m = register()

    def counted(reason, fn):
        before = m.shard_fallback.get(reason)
        got = fn()
        return got, m.shard_fallback.get(reason) - before

    def labeled(n):
        snap = synthetic_cluster(n)
        for i, node in enumerate(snap.nodes):
            node.metadata.labels.update(
                {k: vals[i % len(vals)]
                 for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
        return snap

    def sa_run():
        session = StreamSession(labeled(16), device="cpu",
                                policy=decode_policy(policy_dict(True)))
        gen = ChurnLoadGen(labeled(16), seed=4, arrivals=6)
        hashes = []
        for cycle in range(3):
            session.apply_events(gen.events(cycle))
            placements = session.schedule(gen.batch())
            gen.note_bound(placements)
            hashes.append(placement_hash(placements))
        return hashes, session._shard_layout

    out = {}
    out["service_affinity"] = counted("service_affinity", sa_run)

    def explain():
        session = StreamSession(synthetic_cluster(16), device="cpu")
        gen = ChurnLoadGen(synthetic_cluster(16), seed=4, arrivals=6)
        session.schedule(gen.batch())
        mesh = session._decide_shard_layout(replace(session.device.config,
                                                    explain_k=2))
        return mesh, session._shard_layout

    out["explain_lanes"] = counted("explain_lanes", explain)

    def wrong_size():
        os.environ["TPUSIM_SHARDS"] = str(world + 1)
        try:
            session = StreamSession(synthetic_cluster(16), device="cpu")
            gen = ChurnLoadGen(synthetic_cluster(16), seed=4, arrivals=6)
            placements = session.schedule(gen.batch())
            return placement_hash(placements), session._shard_layout
        finally:
            os.environ["TPUSIM_SHARDS"] = str(world)

    out["device_count"] = counted("device_count", wrong_size)
    return out


def _disagreeing(rank: int) -> str:
    """Rank 1 sees one node more than the others: every rank raises."""
    from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
    from tpusim_torch.stream import StreamSession

    session = StreamSession(synthetic_cluster(16 + (rank == 1)),
                            device="cpu")
    try:
        session.schedule([make_pod("p-0", milli_cpu=100, memory=1 << 20)])
    except RuntimeError as exc:
        return str(exc)
    return ""


def stream_rank(rank: int, world: int, root: str) -> dict:
    """Every arm of one world size on one rank, its directories under
    <root>/k<world>."""
    os.environ["TPUSIM_SHARDS"] = str(world)
    root = os.path.join(root, f"k{world}")
    out = {"chains": _chains(), "analytics": analytics_run(),
           "overlays": _overlays(),
           "checkpointed": _checkpointed(root)}
    if world == 2:
        out["recovery"] = _recovery(root)
        out["replication"] = _replication(root, world)
        out["lagged"] = _lagged_promotion(rank, root)
        out["audit"] = _audit(root)
        out["fallbacks"] = _fallbacks(world)
        out["disagreeing"] = _disagreeing(rank)
    return out


# the feeds tests/test_torch_shard_stream_cuda.py runs on the card
CUDA_FEEDS = ("churn", "padded", "pipelined")


def cuda_stream_rank(rank: int, world: int, root: str) -> dict:
    """tests/test_torch_shard_stream_cuda.py on one rank: every rank on
    the one card under the gloo group."""
    os.environ["TPUSIM_SHARDS"] = str(world)
    root = os.path.join(root, f"k{world}")
    return {"chains": _chains(CUDA_FEEDS, device="cuda"),
            "checkpointed": _checkpointed(root, device="cuda")}
