"""The port's hot standby and leader failover (tpusim_torch/stream/
replicate.py, simulator.run_replicated_stream, run_stream_simulation's
replicate_to, serve's replica reads, the follow and promote commands)
against the JAX package's, on the CPU.

Every tier-1 case of tests/test_replicate.py runs on the port with each of
its assertions. The kill-the-leader matrix (every CRASH_POINTS entry at
checkpoint cadences 1 and 5) must end on the JAX package's crash-free fold
chain on the same workload, with a tail-only replay and a journal that
chaos.engine.audit_failover finds clean. The wire is the JAX package's: a
JAX WalShipper ships to a port FollowerTwin and a port WalShipper to a JAX
FollowerTwin, each follower's chain the leader's. Tolerance: exact; the
times (rto_s, replay_s) are walls and are only bounded.

The JAX package's test_kill_leader_promotes_chain_identical is unsteady
under load. Its cause: when the follower lags the leader at its death, the
JAX promotion journals a second bind record for a crash-tail cycle whose
bind record was durable already (audit_failover reads a lost pod), or
abandons a cycle whose batch the follower applied and whose bind it never
received. The port repairs both; test_failover_when_the_link_died pins each
state through seams the test drives (the shipper held until the follower
acks every frame before the cut), with no sleep deciding the verdict.

Each case resets both packages' process-wide replication state and chaos
seams (an autouse fixture).
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from tpusim.api.snapshot import synthetic_cluster as jax_cluster
from tpusim.jaxe.backend import uninstall_chaos as jax_uninstall
from tpusim.simulator import run_stream_simulation as jax_stream
from tpusim.stream import ChurnLoadGen as JaxGen
from tpusim.stream import StreamPersistence as JaxPersistence
from tpusim.stream import StreamSession as JaxSession
from tpusim.stream import replicate as jax_replicate

from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
from tpusim_torch.backend import uninstall_chaos
from tpusim_torch.backends import Placement, bind_pod, placement_hash
from tpusim_torch.chaos.engine import ProcessCrash, audit_failover
from tpusim_torch.chaos.plan import PlanError, kill_leader_campaign
from tpusim_torch.cli import main as port_main
from tpusim_torch.framework.metrics import register
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
from tpusim_torch.simulator import (
    run_replicated_stream,
    run_stream_simulation,
)
from tpusim_torch.stream import (
    CRASH_POINTS,
    ChurnLoadGen,
    StreamPersistence,
    StreamSession,
    chain_fold,
    replicate,
    tail_wal,
)
from tpusim_torch.stream.persist import read_wal
from tpusim_torch.stream.replicate import (
    FailoverController,
    FollowerTwin,
    PromotionRefused,
    WalShipper,
)
from tpusim_torch.whatif import run_what_if

CYCLES = 8
WORKLOAD = dict(num_nodes=16, cycles=CYCLES, arrivals=16,
                evict_fraction=0.25, node_flap_every=3, seed=5)
GEN = dict(seed=5, arrivals=16, evict_fraction=0.25, node_flap_every=3)


@pytest.fixture(autouse=True)
def _no_process_state():
    for mod in (replicate, jax_replicate):
        mod.set_role("none")
        mod._set_state(replication_lag_records=0, last_shipped_seq=-1)
    uninstall_chaos()
    jax_uninstall()
    yield
    for mod in (replicate, jax_replicate):
        mod.set_role("none")
        mod._set_state(replication_lag_records=0, last_shipped_seq=-1)
    uninstall_chaos()
    jax_uninstall()


def crash_plan(point, seed=5, cycles=CYCLES):
    """The campaign plan that targets one WAL record kind."""
    return kill_leader_campaign(seed=seed, cycles=cycles)[
        CRASH_POINTS.index(point)]


def wait_until(cond, timeout=30.0):
    """Poll `cond` until it holds or the timeout passes; its last value."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.005)
    return True


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The crash-free fold chain, the failover's parity oracle: the port's,
    equal to the JAX package's on the same workload."""
    d = tmp_path_factory.mktemp("repl-base")
    out = run_stream_simulation(**WORKLOAD, checkpoint_dir=str(d),
                                checkpoint_every=2, device="cpu")
    jd = tmp_path_factory.mktemp("repl-base-jax")
    want = jax_stream(**WORKLOAD, checkpoint_dir=str(jd), checkpoint_every=2)
    assert out["fold_chain"] == want["fold_chain"]
    out["dir"] = str(d)
    return out


def check_failover(out, baseline, directory):
    assert out["crashed"] and out["promoted"]
    assert out["divergence"] is None
    assert out["promotion_violations"] == []
    # the headline invariant: the promoted twin's resumed run ends on the
    # crash-free chain, byte for byte
    assert out["fold_chain"] == baseline["fold_chain"]
    # a tail-only replay: the promotion replayed the unshipped lag, not the
    # journal
    assert out["replayed_records"] < out["wal_records"]
    assert 0.0 < out["rto_s"] < 30.0
    # the failover audit over the whole durable journal: no pod lost across
    # the promotion, no key bound twice, every bind provenanced
    records, torn = read_wal(os.path.join(str(directory),
                                          StreamPersistence.WAL))
    assert torn == []
    assert audit_failover(records) == []
    # one emit record a cycle, every cycle once
    assert sorted(r["c"] for _, r in records if r["k"] == "emit") == \
        list(range(CYCLES))


# ---------------------------------------------------------------------------
# the kill-the-leader matrix: every crash point x checkpoint cadence
# ---------------------------------------------------------------------------


@pytest.mark.chaos_fuzz
@pytest.mark.parametrize("cadence", [1, 5])
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_kill_leader_promotes_chain_identical(tmp_path, baseline, point,
                                              cadence):
    out = run_replicated_stream(**WORKLOAD, checkpoint_dir=str(tmp_path),
                                checkpoint_every=cadence,
                                chaos_plan=crash_plan(point), device="cpu")
    check_failover(out, baseline, tmp_path)


@pytest.mark.chaos_fuzz
@pytest.mark.slow
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_kill_leader_sparse_checkpoints(tmp_path, baseline, point):
    """Cadence 20 > cycles: the genesis checkpoint only. The promotion is
    still tail-only: the WARM TWIN, not the checkpoint, is the anchor."""
    out = run_replicated_stream(**WORKLOAD, checkpoint_dir=str(tmp_path),
                                checkpoint_every=20,
                                chaos_plan=crash_plan(point), device="cpu")
    check_failover(out, baseline, tmp_path)


@pytest.mark.chaos_fuzz
def test_kill_leader_pipelined_driver(tmp_path, tmp_path_factory):
    """The pipelined driver's WAL order (bind N before ev N+1) gives the
    follower the same replay alignment."""
    d = tmp_path_factory.mktemp("repl-pipe-base")
    base = run_stream_simulation(**WORKLOAD, pipeline=True,
                                 checkpoint_dir=str(d), checkpoint_every=2,
                                 device="cpu")
    jd = tmp_path_factory.mktemp("repl-pipe-base-jax")
    assert base["fold_chain"] == jax_stream(
        **WORKLOAD, pipeline=True, checkpoint_dir=str(jd),
        checkpoint_every=2)["fold_chain"]
    out = run_replicated_stream(**WORKLOAD, pipeline=True,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=2,
                                chaos_plan=crash_plan("bind"), device="cpu")
    assert out["promoted"] and out["promotion_violations"] == []
    assert out["fold_chain"] == base["fold_chain"]


def _drive(session, gen, cycles, start=0):
    for cycle in range(start, cycles):
        session.apply_events(gen.events(cycle))
        gen.note_bound(session.schedule(gen.batch()))


@pytest.mark.chaos_fuzz
@pytest.mark.parametrize("point", ["bind", "emit"])
@pytest.mark.parametrize("cut", ["batch", "bind"])
def test_failover_when_the_link_died(tmp_path, baseline, cut, point):
    """The follower lags the leader at its death, pinned: the link dies
    right before the crash cycle's `cut` record (the shipper is held until
    the follower acked every frame before it, and ships nothing from it
    on), then the leader dies after that cycle's `point` record. The
    promotion must decide the crash cycle again where it has no emit,
    journal no bind record twice, and land on the crash-free chain."""
    at = crash_plan(point).churn[0].at
    follower = FollowerTwin(synthetic_cluster(16), device="cpu")
    leader = StreamSession(synthetic_cluster(16), device="cpu")
    persist = StreamPersistence(str(tmp_path), checkpoint_every=5)
    shipper = WalShipper(persist, follower.address)
    leader.attach_persistence(persist)
    persist.arm_crash(at, point)
    ship = persist.on_append
    held = {}

    def on_append(rec, kind, cycle, start, end):
        if not held and rec["k"] == cut and int(rec["c"]) == at:
            held["seq"] = shipper.enqueued()
            held["acked"] = wait_until(
                lambda: shipper.acked_seq >= held["seq"] - 1)
            shipper.close(drain=False)   # the link dies here
        ship(rec, kind, cycle, start, end)

    persist.on_append = on_append
    gen = ChurnLoadGen(synthetic_cluster(16), **GEN)
    try:
        with pytest.raises(ProcessCrash):
            _drive(leader, gen, CYCLES)
        persist.close()
        assert held["acked"], "the follower never acked the frames before " \
                              "the cut"
        assert follower.applied_seq == held["seq"] - 1
        assert (at in follower.batches) == (cut == "bind")
        promoted, report = FailoverController(
            lambda: False, [follower], str(tmp_path), interval_s=0.001,
            misses=1, checkpoint_every=5, leader_was_alive=True).run(5.0)
        assert report.violations == []
        if point == "bind":
            assert at in report.recomputed
        resume = report.resume_cycle
        assert resume == at + 1
        gen2 = ChurnLoadGen(synthetic_cluster(16), **GEN)
        for c in range(resume):
            gen2.events(c)
            by_key = {p.key(): p for p in gen2.batch()}
            gen2.note_bound([
                Placement(pod=bind_pod(by_key[k], node), node_name=node)
                for k, node in promoted.bound_by_cycle.get(c, [])
                if k in by_key])
        skip = promoted.events_applied.get(resume, 0)
        for cycle in range(resume, CYCLES):
            evs = gen2.events(cycle)[skip:]
            skip = 0
            promoted.session.apply_events(evs)
            gen2.note_bound(promoted.session.schedule(gen2.batch()))
        promoted.persist.close()
        assert promoted.persist.chain == baseline["fold_chain"]
        records, torn = read_wal(os.path.join(str(tmp_path),
                                              StreamPersistence.WAL))
        assert torn == [] and audit_failover(records) == []
        assert sorted(r["c"] for _, r in records if r["k"] == "emit") == \
            list(range(CYCLES))
    finally:
        shipper.close(drain=False, timeout=0.0)
        persist.close()
        follower.stop()


def test_concurrent_pairs_under_a_short_switch_interval(tmp_path, baseline):
    """Four replicated pairs at once (four leaders, four followers, their
    shippers and ack readers: more threads than cores), two of them killed
    and promoted, with the interpreter switching threads every 10 µs: each
    run ends on the crash-free chain (the process-wide role, status and
    metrics are shared; nothing else is)."""
    import sys

    outs, errors = {}, []

    def pair(i):
        kw = {"chaos_plan": crash_plan(("bind", "emit")[i // 2])} \
            if i % 2 else {}
        try:
            outs[i] = run_replicated_stream(
                **WORKLOAD, checkpoint_dir=str(tmp_path / f"pair-{i}"),
                checkpoint_every=5, device="cpu", **kw)
        except Exception as exc:   # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=pair, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    for i, out in outs.items():
        assert out["fold_chain"] == baseline["fold_chain"], i
        assert out["promoted"] if i % 2 else out["follower_chain_matches"]
    assert len(outs) == 4


@pytest.mark.parametrize("crash", [False, True])
def test_a_follower_error_raises(tmp_path, monkeypatch, crash):
    """No silent fallback: an error while the follower applies a record (a
    device error on the card) stops the twin and raises from the run,
    through promote() when the leader died."""
    apply = FollowerTwin._apply_record

    def failing(self, rec, end):
        if rec["k"] == "bind" and int(rec["c"]) == 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        return apply(self, rec, end)

    monkeypatch.setattr(FollowerTwin, "_apply_record", failing)
    kw = {"chaos_plan": crash_plan("emit")} if crash else {}
    with pytest.raises(RuntimeError, match="follower twin failed"):
        run_replicated_stream(**WORKLOAD, checkpoint_dir=str(tmp_path),
                              checkpoint_every=5, device="cpu", **kw)


# ---------------------------------------------------------------------------
# steady-state replication (no crash)
# ---------------------------------------------------------------------------


def test_replicated_run_drains_to_identical_chain(tmp_path, baseline):
    out = run_replicated_stream(**WORKLOAD, checkpoint_dir=str(tmp_path),
                                checkpoint_every=2, device="cpu")
    assert not out["crashed"]
    assert out["drained"]
    assert out["divergence"] is None
    assert out["follower_chain_matches"]
    assert out["fold_chain"] == baseline["fold_chain"]
    # the follower applied every durable record
    assert out["applied_records"] == out["wal_records"]
    # the journal is the unreplicated run's, line for line
    with open(os.path.join(str(tmp_path), StreamPersistence.WAL)) as f:
        mine = f.read()
    with open(os.path.join(baseline["dir"], StreamPersistence.WAL)) as f:
        assert mine == f.read()


def test_stream_simulation_ships_to_follower(tmp_path):
    """run_stream_simulation's replicate_to: the driver ships to a twin
    built elsewhere and drains its acks."""
    follower = FollowerTwin(synthetic_cluster(WORKLOAD["num_nodes"]),
                            device="cpu")
    try:
        out = run_stream_simulation(**WORKLOAD, checkpoint_dir=str(tmp_path),
                                    checkpoint_every=2,
                                    replicate_to=follower.address,
                                    device="cpu")
        assert out["replication_lag_at_close"] == 0
        assert out["replication_acked_chain"] == out["fold_chain"]
        assert follower.chain == out["fold_chain"]
        assert follower.diverged is None
    finally:
        follower.stop()


def test_replicate_to_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_stream_simulation(**WORKLOAD, replicate_to=("127.0.0.1", 1),
                              device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_replicated_stream(**WORKLOAD, device="cpu")


# ---------------------------------------------------------------------------
# divergence: a twin that disagrees refuses promotion
# ---------------------------------------------------------------------------


def _mini_twin():
    twin = FollowerTwin(synthetic_cluster(4), device="cpu")
    pod = make_pod("diverge-0", milli_cpu=100, memory=1 << 20)
    twin._apply_record({"k": "batch", "c": 0, "pods": [pod.to_obj()]}, 64)
    return twin


def test_bind_divergence_latches_and_refuses_promotion(tmp_path):
    twin = _mini_twin()
    try:
        # the leader claims a bind our scheduler cannot reproduce
        twin._apply_record({"k": "bind", "c": 0,
                            "b": [["default/diverge-0", "no-such-node"]]},
                           128)
        assert twin.diverged is not None
        with pytest.raises(PromotionRefused, match="diverged"):
            twin.promote(str(tmp_path))
        # a diverged twin keeps counting applied records (it still acks)
        # but stops changing its scheduler
        emitted_before = twin.cycles_emitted
        twin._apply_record({"k": "emit", "c": 0, "h": "00", "n": 1,
                            "s": 1}, 160)
        assert twin.cycles_emitted == emitted_before
        assert twin.wal_records_applied == 3
    finally:
        twin.stop()


def test_emit_divergence_via_wrong_hash():
    twin = FollowerTwin(synthetic_cluster(4), device="cpu")
    try:
        pod = make_pod("diverge-1", milli_cpu=100, memory=1 << 20)
        twin._apply_record({"k": "batch", "c": 0, "pods": [pod.to_obj()]},
                           64)
        # schedule through the twin so the bind matches...
        placements = twin.session.schedule([pod])
        twin.batches[0] = [pod]
        twin._live_pending[0] = placements
        real = placement_hash(placements)
        twin._apply_record({"k": "emit", "c": 0,
                            "h": "f" * len(real), "n": 1, "s": 1}, 128)
        assert twin.diverged is not None
        assert "placement hash diverges" in twin.diverged
    finally:
        twin.stop()


def test_failover_controller_skips_diverged_candidate(tmp_path):
    """The freshest candidate refusing promotion falls through to the next
    freshest instead of failing the failover."""
    healthy = FollowerTwin(synthetic_cluster(4), device="cpu")
    poisoned = FollowerTwin(synthetic_cluster(4), device="cpu")
    poisoned.applied_seq = 10 ** 6      # "freshest" on paper
    poisoned._diverge("poisoned for the test")
    # an empty WAL: the healthy twin promotes over nothing
    os.makedirs(str(tmp_path), exist_ok=True)
    open(os.path.join(str(tmp_path), StreamPersistence.WAL), "w").close()
    controller = FailoverController(lambda: False, [healthy, poisoned],
                                    str(tmp_path), interval_s=0.001,
                                    misses=1, leader_was_alive=True)
    try:
        promoted, report = controller.run(timeout=5.0)
        assert promoted is healthy
        assert report.violations == []
        assert replicate.get_status()["role"] == "leader"
    finally:
        if healthy.persist is not None:
            healthy.persist.close()
        healthy.stop()
        poisoned.stop()
    with pytest.raises(PromotionRefused):
        poisoned.promote(str(tmp_path))


def test_controller_waits_for_first_contact(tmp_path):
    """A follower started BEFORE its leader waits for first contact
    instead of declaring death over a WAL that does not exist yet."""
    follower = FollowerTwin(synthetic_cluster(4), device="cpu")
    try:
        controller = FailoverController(
            lambda: False, [follower], str(tmp_path),
            interval_s=0.001, misses=1)
        with pytest.raises(TimeoutError, match="never observed alive"):
            controller.wait_for_death(timeout=0.05)
        assert follower.promoted is False
        # one successful probe arms the death watch
        pulse = [True, True, False, False]
        controller.probe = lambda: pulse.pop(0) if pulse else False
        controller.wait_for_death(timeout=5.0)
    finally:
        follower.stop()


def test_promote_refuses_on_missing_wal(tmp_path):
    """A promotion against a directory with no WAL is a clean refusal (an
    unmounted shared volume, say), not a traceback."""
    follower = FollowerTwin(synthetic_cluster(4), device="cpu")
    try:
        with pytest.raises(PromotionRefused, match="no durable WAL"):
            follower.promote(str(tmp_path))
        assert follower.promoted is False   # still a standby, not wedged
        assert replicate.get_status()["role"] == "follower"
    finally:
        follower.stop()


# ---------------------------------------------------------------------------
# tail_wal, the campaign, the durability dial, /healthz, the metrics
# ---------------------------------------------------------------------------


def _write_wal(path, lines, torn_tail=""):
    with open(path, "w", encoding="utf-8") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
        if torn_tail:
            f.write(torn_tail)


def test_tail_wal_resume_offset_follows_live_tail(tmp_path):
    p = str(tmp_path / "wal.jsonl")
    _write_wal(p, [{"k": "ev", "c": 0}, {"k": "batch", "c": 0}])
    records, violations, resume = tail_wal(p, 0)
    assert [r["k"] for _, r in records] == ["ev", "batch"]
    assert violations == []
    assert resume == os.path.getsize(p)
    with open(p, "a", encoding="utf-8") as f:
        f.write(json.dumps({"k": "bind", "c": 0}) + "\n")
        f.write(json.dumps({"k": "emit", "c": 0}) + "\n")
    more, violations, resume2 = tail_wal(p, resume)
    assert [r["k"] for _, r in more] == ["bind", "emit"]
    assert violations == []
    assert resume2 == os.path.getsize(p)


def test_tail_wal_torn_final_line_is_not_a_violation(tmp_path):
    p = str(tmp_path / "wal.jsonl")
    _write_wal(p, [{"k": "ev", "c": 0}], torn_tail='{"k": "ba')
    records, violations, resume = tail_wal(p, 0)
    assert len(records) == 1 and violations == []
    with open(p, "a", encoding="utf-8") as f:
        f.write('tch", "c": 0}\n')
    more, violations, _ = tail_wal(p, resume)
    assert violations == []
    assert [r["k"] for _, r in more] == ["batch"]


def test_tail_wal_torn_interior_is_a_violation(tmp_path):
    p = str(tmp_path / "wal.jsonl")
    with open(p, "w", encoding="utf-8") as f:
        f.write(json.dumps({"k": "ev", "c": 0}) + "\n")
        f.write('{"k": "torn interior\n')
        f.write(json.dumps({"k": "emit", "c": 0}) + "\n")
    records, violations, _ = tail_wal(p, 0)
    assert [r["k"] for _, r in records] == ["ev", "emit"]
    assert len(violations) == 1 and "torn interior" in violations[0]


def test_kill_leader_campaign_covers_every_point():
    plans = kill_leader_campaign(seed=3, cycles=12)
    assert [pl.churn[0].target for pl in plans] == list(CRASH_POINTS)
    for pl in plans:
        assert pl.churn[0].action == "process_crash"
        assert 3 <= pl.churn[0].at < 12
    with pytest.raises(PlanError):
        kill_leader_campaign(seed=3, cycles=2)


@pytest.mark.parametrize("fsync_every,want", [
    (4, {"mode": "fsync", "fsync_every": 4}),
    (0, {"mode": "flush", "fsync_every": 0})])
def test_durability_mode_stamped_into_checkpoint_manifest(tmp_path,
                                                          fsync_every, want):
    out = run_stream_simulation(num_nodes=8, cycles=3, arrivals=8, seed=1,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=1, fsync_every=fsync_every,
                                device="cpu")
    assert out["checkpoints"] >= 1
    with open(os.path.join(str(tmp_path),
                           StreamPersistence.CHECKPOINT)) as f:
        meta = json.load(f)
    assert meta["durability"] == want


def test_fsync_every_validated(tmp_path):
    with pytest.raises(ValueError, match="fsync_every"):
        run_stream_simulation(num_nodes=8, cycles=1, arrivals=4, seed=1,
                              checkpoint_dir=str(tmp_path), fsync_every=-1,
                              device="cpu")


def test_healthz_reports_replication_role():
    from tpusim.obs.server import health_payload as jax_health

    from tpusim_torch.obs.server import health_payload

    replicate.set_role("candidate")
    replicate._set_state(replication_lag_records=7, last_shipped_seq=41)
    jax_replicate.set_role("candidate")
    jax_replicate._set_state(replication_lag_records=7, last_shipped_seq=41)
    _, body = health_payload()
    assert body["role"] == "candidate"
    assert body["replication_lag_records"] == 7
    assert body["last_shipped_seq"] == 41
    _, want = jax_health()
    keys = ("role", "replication_lag_records", "last_shipped_seq")
    assert {k: body[k] for k in keys} == {k: want[k] for k in keys}


def test_replication_metrics_registered_and_observed(tmp_path):
    reg = register()
    for name in ("replication_lag_records", "replication_lag_bytes",
                 "replication_lag_seconds", "replication_last_shipped_seq",
                 "replication_ship_latency", "replication_apply_latency",
                 "replication_promotions", "replication_divergence",
                 "replication_rto_seconds", "replication_role"):
        assert hasattr(reg, name), name
    promotions = reg.replication_promotions.value
    run_replicated_stream(**WORKLOAD, checkpoint_dir=str(tmp_path),
                          checkpoint_every=5, chaos_plan=crash_plan("emit"),
                          device="cpu")
    assert reg.replication_promotions.value == promotions + 1
    assert reg.replication_rto_seconds.value > 0
    text = reg.expose()
    for family in ("tpusim_replication_ship_latency_microseconds",
                   "tpusim_replication_apply_latency_microseconds",
                   "tpusim_replication_role_info"):
        assert family in text


# ---------------------------------------------------------------------------
# replica reads and the late join
# ---------------------------------------------------------------------------


def _wait_caught_up(shipper, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if shipper.drain(timeout=1.0):
            return True
    return False


def _whatif_pods(seed=7, n=4):
    rng = np.random.RandomState(seed)
    return [make_pod(f"repl-whatif-{seed}-{i}",
                     milli_cpu=int(rng.randint(100, 1200)),
                     memory=int(rng.randint(1 << 20, 1 << 30)))
            for i in range(n)]


def _leader(tmp_path, follower_address):
    leader = StreamSession(synthetic_cluster(8), device="cpu")
    persist = StreamPersistence(str(tmp_path), checkpoint_every=2)
    shipper = WalShipper(persist, follower_address)
    leader.attach_persistence(persist)
    gen = ChurnLoadGen(synthetic_cluster(8), seed=5, arrivals=8,
                       evict_fraction=0.25, node_flap_every=3)
    return leader, persist, shipper, gen


def test_replica_overlay_read_then_replay(tmp_path):
    """A caught-up follower answers overlay what-ifs (the staged oracle's
    placement hash on ITS state) and keeps replaying the leader's WAL
    afterwards: reads never disturb the replica's chain. A fleet with the
    replica attached answers from it first, a diverged replica refuses."""
    follower = FollowerTwin(synthetic_cluster(8), device="cpu")
    leader, persist, shipper, gen = _leader(tmp_path, follower.address)
    try:
        _drive(leader, gen, 4)
        assert _wait_caught_up(shipper)
        assert follower.diverged is None
        assert follower.chain == persist.chain
        qpods = _whatif_pods()
        placements = follower.overlay_query(qpods)
        assert placements is not None, "replica overlay refused"
        [oracle] = run_what_if(
            [(follower.session.inc.to_snapshot(), qpods)], device="cpu")
        assert placement_hash(placements) == \
            placement_hash(oracle.placements)
        chain_before = follower.chain
        _drive(leader, gen, 6, start=4)
        assert _wait_caught_up(shipper)
        assert follower.diverged is None
        assert follower.chain == persist.chain != chain_before

        # serve: the replica answers first, the leader's twin after it
        fleet = ScenarioFleet(bucket_size=4, device="cpu")
        try:
            fleet.attach_stream(leader)
            fleet.attach_replica(follower)
            [resp] = fleet.run([WhatIfRequest(pods=qpods,
                                              snapshot_ref="live")])
            assert resp.error is None
            [want] = run_what_if([(leader.inc.to_snapshot(), qpods)],
                                 device="cpu")
            assert placement_hash(resp.result.placements) == \
                placement_hash(want.placements)
            before = register().overlay_queries.values.get("follower", 0)
            fleet.run([WhatIfRequest(pods=qpods, snapshot_ref="live")])
            assert register().overlay_queries.values.get(
                "follower", 0) == before + 1
            follower._diverge("poisoned for the read test")
            resident = register().overlay_queries.values.get("resident", 0)
            [resp] = fleet.run([WhatIfRequest(pods=qpods,
                                              snapshot_ref="live")])
            assert placement_hash(resp.result.placements) == \
                placement_hash(want.placements)
            assert register().overlay_queries.values.get(
                "resident", 0) == resident + 1
        finally:
            fleet.stop()
    finally:
        shipper.close()
        persist.close()
        follower.stop()


def test_diverged_replica_refuses_overlay_reads():
    twin = _mini_twin()
    try:
        twin._diverge("poisoned for the read test")
        assert twin.overlay_query(_whatif_pods()) is None
    finally:
        twin.stop()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_late_join_bootstrap(tmp_path):
    """A follower that joins AFTER the leader has run bootstraps from the
    shipped checkpoint manifest and open batches, lands on the leader's
    chain, then replays live records and serves overlay reads."""
    port = _free_port()
    leader, persist, shipper, gen = _leader(tmp_path, ("127.0.0.1", port))
    late = None
    try:
        _drive(leader, gen, 4)   # nobody listening yet
        late = FollowerTwin(bootstrap=True, listen=("127.0.0.1", port),
                            device="cpu")
        assert _wait_caught_up(shipper), "late joiner never caught up"
        assert late.bootstrapped, "snap frame never applied"
        assert late.diverged is None
        assert late.chain == persist.chain
        # the accounting covers the whole journal: the manifest's records
        # are credited by the snap frame, the tail by live replay
        assert late.wal_records_applied == persist.wal_records
        _drive(leader, gen, 6, start=4)
        assert _wait_caught_up(shipper)
        assert late.diverged is None
        assert late.chain == persist.chain
        qpods = _whatif_pods(seed=9)
        placements = late.overlay_query(qpods)
        assert placements is not None
        [oracle] = run_what_if([(late.session.inc.to_snapshot(), qpods)],
                               device="cpu")
        assert placement_hash(placements) == \
            placement_hash(oracle.placements)
    finally:
        shipper.close()
        persist.close()
        if late is not None:
            late.stop()


# ---------------------------------------------------------------------------
# the wire between the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leader_pkg", ["jax", "port"])
def test_wire_between_packages(tmp_path, leader_pkg):
    """A JAX leader ships to a port follower, and a port leader to a JAX
    follower: every record applies, the chains equal the leader's."""
    if leader_pkg == "jax":
        follower = FollowerTwin(synthetic_cluster(8), device="cpu")
        leader = JaxSession(jax_cluster(8))
        persist = JaxPersistence(str(tmp_path), checkpoint_every=2)
        shipper = jax_replicate.WalShipper(persist, follower.address)
        gen = JaxGen(jax_cluster(8), seed=5, arrivals=8, evict_fraction=0.25,
                     node_flap_every=3)
    else:
        follower = jax_replicate.FollowerTwin(jax_cluster(8))
        leader = StreamSession(synthetic_cluster(8), device="cpu")
        persist = StreamPersistence(str(tmp_path), checkpoint_every=2)
        shipper = WalShipper(persist, follower.address)
        gen = ChurnLoadGen(synthetic_cluster(8), seed=5, arrivals=8,
                           evict_fraction=0.25, node_flap_every=3)
    leader.attach_persistence(persist)
    try:
        _drive(leader, gen, 5)
        assert _wait_caught_up(shipper)
        assert follower.diverged is None
        assert follower.chain == persist.chain == shipper.acked_chain
        assert follower.wal_records_applied == persist.wal_records
        assert follower.cycles_emitted == 5
    finally:
        shipper.close()
        persist.close()
        follower.stop()


# ---------------------------------------------------------------------------
# the commands: stream --replicate-to, follow, promote
# ---------------------------------------------------------------------------


def _stream_args(ckdir):
    return ["stream", "--synthetic-nodes", str(WORKLOAD["num_nodes"]),
            "--cycles", str(CYCLES), "--arrivals", str(WORKLOAD["arrivals"]),
            "--flap-every", str(WORKLOAD["node_flap_every"]),
            "--seed", str(WORKLOAD["seed"]), "--checkpoint-every", "2",
            "--checkpoint-dir", str(ckdir), "--device", "cpu"]


def _head(directory, cycles):
    """The fold of the first `cycles` emits of a journal."""
    records, _ = read_wal(os.path.join(directory, StreamPersistence.WAL))
    chain = ""
    for _, rec in records:
        if rec["k"] == "emit" and rec["c"] < cycles:
            chain = chain_fold(chain, rec["h"])
    return chain


def test_follow_watch_leader_then_recover(tmp_path, baseline, capsys):
    """`follow --watch-leader` against a leader whose /healthz dies with
    it: the follower promotes itself onto the leader's directory, and
    `stream --recover` there finishes on the crash-free chain. The leader
    is `stream --replicate-to --listen` in this process, its crash
    scripted; the follower's listener and the leader's endpoint take
    ports picked here."""
    from tpusim_torch.chaos.plan import ChurnEvent, FaultPlan

    plan = tmp_path / "crash.json"
    at = 5
    plan.write_text(FaultPlan(seed=5, churn=[ChurnEvent(
        at=at, action="process_crash", target="emit")]).to_json())
    ckdir = tmp_path / "ck"
    bind, listen = _free_port(), _free_port()
    rc = {}

    def follow():
        rc["follow"] = port_main([
            "follow", "--bind", f"127.0.0.1:{bind}", "--checkpoint-dir",
            str(ckdir), "--watch-leader", f"127.0.0.1:{listen}",
            "--watch-interval", "0.02", "--watch-timeout", "60",
            "--synthetic-nodes", str(WORKLOAD["num_nodes"]),
            "--checkpoint-every", "2", "--device", "cpu", "--json"])

    thread = threading.Thread(target=follow, daemon=True)
    thread.start()
    try:
        # the follower listens before the leader ships to it
        assert wait_until(lambda: replicate.get_status()["role"]
                          == "follower", 30.0)
        assert port_main(_stream_args(ckdir) + [
            "--replicate-to", f"127.0.0.1:{bind}", "--listen",
            f"127.0.0.1:{listen}", "--chaos-plan", str(plan)]) == 3
        thread.join(timeout=60.0)
        assert not thread.is_alive()
    finally:
        thread.join(timeout=1.0)
    assert rc["follow"] == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out["promoted"] and out["promotion_violations"] == []
    assert out["resume_cycle"] == at + 1
    assert out["chain"] == _head(baseline["dir"], at + 1)
    assert port_main(_stream_args(ckdir) + ["--recover", "--json"]) == 0
    done = json.loads(capsys.readouterr().out)
    assert done["fold_chain"] == baseline["fold_chain"]


def test_promote_cli_equals_jax(tmp_path, baseline, capsys):
    """`promote` on a crashed leader's directory: the report equals the
    JAX command's on the JAX package's own crash directory (the replay's
    wall aside), but for the journal's length: the leader died right after
    cycle 4's bind record, and the port's promotion decides the cycle again
    without journaling that record a second time (the JAX package appends
    a duplicate). `stream --recover` then ends on the crash-free chain."""
    from tpusim.cli import main as jax_main
    from tpusim_torch.chaos.plan import ChurnEvent, FaultPlan

    plan = tmp_path / "crash.json"
    plan.write_text(FaultPlan(seed=5, churn=[ChurnEvent(
        at=4, action="process_crash", target="bind")]).to_json())
    reports = []
    for name, main in (("port", port_main), ("jax", jax_main)):
        ckdir = tmp_path / name
        args = _stream_args(ckdir)
        if name == "jax":
            args = [a for a in args if a not in ("--device", "cpu")]
        assert main(args + ["--chaos-plan", str(plan)]) == 3
        capsys.readouterr()
        promote = ["promote", "--checkpoint-dir", str(ckdir),
                   "--synthetic-nodes", str(WORKLOAD["num_nodes"]),
                   "--checkpoint-every", "2", "--json"]
        if name == "port":
            promote += ["--device", "cpu"]
        assert main(promote) == 0
        body = json.loads(capsys.readouterr().out)
        body.pop("replay_s")
        reports.append(body)
    assert reports[0].pop("wal_records") == reports[1].pop("wal_records") - 1
    assert reports[0] == reports[1]
    assert reports[0]["recomputed_cycles"] == [4]
    records, _ = read_wal(os.path.join(str(tmp_path / "port"),
                                       StreamPersistence.WAL))
    assert audit_failover(records) == []
    assert port_main(_stream_args(tmp_path / "port")
                     + ["--recover", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["fold_chain"] == \
        baseline["fold_chain"]
    missing = ["promote", "--checkpoint-dir", str(tmp_path / "nowhere"),
               "--synthetic-nodes", "4", "--device", "cpu"]
    assert port_main(missing) == 1
    assert "no durable WAL" in capsys.readouterr().err


def test_stream_cli_replicate_to(tmp_path, capsys):
    follower = FollowerTwin(synthetic_cluster(WORKLOAD["num_nodes"]),
                            device="cpu")
    try:
        host, port = follower.address
        assert port_main(_stream_args(tmp_path / "ck") + [
            "--replicate-to", f"{host}:{port}"]) == 0
        out = capsys.readouterr().out
        assert "follower chain matches the leader" in out
        assert f"fold chain {follower.chain[:16]}" in out
    finally:
        follower.stop()
    assert port_main(["stream", "--replicate-to", "127.0.0.1:1",
                      "--device", "cpu"]) == 2
    assert "--checkpoint-dir" in capsys.readouterr().err
