"""The port's node-sharded streaming twin (TPUSIM_SHARDS=k: the twin's node
axis over k gloo ranks on the CPU) against the port's single-device twin
and the JAX package's.

One spawn of k ranks for each k in (2, 4), both at once, runs every arm
(tests/torch_shard_stream_workers.stream_rank); the tests read the ranks'
results. On every feed (evictions and node flaps, a node count no k
divides, label and taint churn under a policy without ServiceAffinity,
pipelined cycles with overlay queries, gang cycles) every rank's placement
and fold chains, paths, restages, commits and load counts equal the port's
single-device run and the JAX package's single-device
run_stream_simulation. Overlay queries on the sharded twin answer as the
staged run_what_if and leave the carry bit-equal. The checkpoint's
shard_layout is the JAX package's for the same node count and k, rank 0's
WAL is the single-device WAL byte for byte and every rank's WAL is rank
0's. At k = 2: a crash and its recovery, a killed leader's promotion, the
follower's restage for a leader layout of another shard count, the audit
of a flipped bind against the JAX audit of the same pair, each fallback
counted, and ranks whose host pictures differ raising. Tolerance: exact.
"""

import json
import os

import pytest

from tpusim.engine.policy import decode_policy as jax_decode
from tpusim.obs.audit import audit_wal_pair as jax_audit
from tpusim.simulator import run_stream_simulation as jax_stream

from tpusim_torch import sharding
from tpusim_torch.api.snapshot import synthetic_cluster
from tpusim_torch.backends import placement_hash
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import ChurnLoadGen, StreamSession
from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE
import torch_shard_stream_workers as SW

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("shard-stream"))


@pytest.fixture(scope="module")
def ranks(root):
    """k -> the k ranks' results (one spawn each, both at once)."""
    return sharding.run_ranks_each(SW.stream_rank, SHARDS, args=(root,),
                                   timeout=300)


@pytest.fixture(scope="module")
def single():
    """Each feed on the port's single-device twin, held to the JAX
    package's single-device run."""
    out = {}
    for name in SW.FEEDS:
        got = SW.single(name)
        want = SW.summary(jax_stream(**SW.feed_kwargs(name, jax_decode)))
        assert got == want, name
        out[name] = got
    return out


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", sorted(SW.FEEDS))
def test_sharded_chains(ranks, single, name, k):
    spans = set()
    for got in (r["chains"][name] for r in ranks[k]):
        spans |= set(got.pop("spans"))
        assert got == single[name]
    # the twin ran sharded: its stages and scans, or the gang lanes
    assert spans == ({"shard:gang_lanes"} if name == "gang"
                     else {"shard:stage", "shard:scan"})


@pytest.mark.parametrize("k", SHARDS)
def test_shard_gauges(ranks, k):
    """After the padded feed: the real nodes of each shard's block."""
    n = SW.FEEDS["padded"]["num_nodes"]
    per = -(-n // k)
    for r in ranks[k]:
        count, occupancy = r["chains"]["gauges"]["padded"]
        assert count == k
        assert occupancy == {str(s): min(per, n - s * per)
                             for s in range(k)}


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_stream_analytics(ranks, k):
    """The stream's analytics samples ride the sharded twin (one a cycle,
    the throttle agreed across the ranks): equal to the single-device
    twin's, and to host_reduce of the whole kept columns."""
    want = SW.analytics_run()
    assert want["problems"] == [] and want["samples"]
    for r in ranks[k]:
        assert r["analytics"]["problems"] == []
        assert r["analytics"]["samples"] == want["samples"]


@pytest.mark.parametrize("k", SHARDS)
def test_overlays_on_the_sharded_twin(ranks, k):
    for r in ranks[k]:
        got = r["overlays"]
        assert got["answered"] == 3
        assert got["oracle"] and got["carry"] and got["lockstep"]
        assert got["layout"] == {"shards": k, "nodes": 16,
                                 "nodes_per_shard": 16 // k}


@pytest.fixture(scope="module")
def single_checkpointed(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("single-ck"))
    out = run_stream_simulation(device="cpu", **SW.CHECKPOINTED,
                                checkpoint_dir=d,
                                checkpoint_every=SW.CHECKPOINT_EVERY)
    return out, SW._manifest(d), SW._wal(d)


@pytest.mark.parametrize("k", SHARDS)
def test_checkpoint_layout_is_the_jax_layout(ranks, k, tmp_path,
                                             monkeypatch):
    """The JAX twin sharded over k of conftest's virtual CPU devices:
    only its layout is compared (its sharded chain has an open
    nondeterminism, tests/test_audit.py)."""
    monkeypatch.setenv("TPUSIM_SHARDS", str(k))
    jax_stream(**dict(SW.CHECKPOINTED, cycles=2), checkpoint_dir=str(tmp_path),
               checkpoint_every=1)
    with open(tmp_path / "checkpoint.json") as f:
        want = json.load(f)["shard_layout"]
    n = SW.CHECKPOINTED["num_nodes"]
    assert want == {"shards": k, "nodes": n, "nodes_per_shard": -(-n // k)}
    for r in ranks[k]:
        assert r["checkpointed"]["manifest"]["shard_layout"] == want


@pytest.mark.parametrize("k", SHARDS)
def test_rank_wals_are_the_single_device_wal(ranks, single_checkpointed,
                                             root, k):
    out, manifest, wal = single_checkpointed
    for rank, r in enumerate(ranks[k]):
        got = r["checkpointed"]
        named = os.path.join(root, f"k{k}", "ck")
        assert got["dir"] == (named if rank == 0 else f"{named}.rank{rank}")
        assert got["fold_chain"] == out["fold_chain"]
        assert got["wal"] == wal
        # the manifests differ in the layout alone
        mine, want = dict(got["manifest"]), dict(manifest)
        assert mine.pop("shard_layout") is not None
        assert want.pop("shard_layout") is None
        assert mine == want
        # the device image holds the whole padded columns: its bound
        # count is the host's
        assert mine["device_bound"] == mine["bound_pods"]


def test_sharded_crash_recovery(ranks, single_checkpointed):
    out, _manifest, _wal = single_checkpointed
    for r in ranks[2]:
        got = r["recovery"]
        assert got["crashed"]
        assert got["fold_chain"] == out["fold_chain"]
        assert got["violations"] == [] and got["torn"] == []
        assert got["audit"] == []
        assert got["restages"]["recovered"] == 1
        assert got["layout"] == {"shards": 2, "nodes": 23,
                                 "nodes_per_shard": 12}


def test_sharded_promotion(ranks, tmp_path):
    base = run_stream_simulation(device="cpu", **SW.REPLICATED,
                                 checkpoint_dir=str(tmp_path / "port"),
                                 checkpoint_every=2)
    want = jax_stream(**SW.REPLICATED, checkpoint_dir=str(tmp_path / "jax"),
                      checkpoint_every=2)
    assert base["fold_chain"] == want["fold_chain"]
    for r in ranks[2]:
        got = r["replication"]
        assert got["promoted"]
        assert got["fold_chain"] == base["fold_chain"]
        assert got["promotion_violations"] == []
        assert got["divergence"] is None
        assert got["audit"] == []


def test_promotion_with_lags_that_differ_by_rank(ranks, tmp_path):
    """Rank 0's follower decided the crash cycle live, rank 1's lost its
    link before that cycle's bind record: every rank's twin decides every
    cycle once (the followers' collectives in step) and both promote onto
    the crash-free chain."""
    base = run_stream_simulation(device="cpu", **SW.REPLICATED,
                                 checkpoint_dir=str(tmp_path),
                                 checkpoint_every=2)
    got = [r["lagged"] for r in ranks[2]]
    assert [g["live"] for g in got] == [True, False]
    for g in got:
        assert g["crashed"]
        assert g["chain"] == base["fold_chain"]
        assert g["decided"] == SW.REPLICATED["cycles"]
        assert g["violations"] == [] and g["audit"] == []


def test_follower_restages_for_another_layout(ranks):
    """A leader checkpoint announcing 2k shards restages the follower once,
    classified replicated; its own layout restages nothing."""
    for r in ranks[2]:
        got = r["replication"]["announced"]
        assert got["restages"] == {"cold_start": 1, "replicated": 1}
        assert got["layouts"] == [{"shards": 2, "nodes": 16,
                                   "nodes_per_shard": 8}] * 4


def test_sharded_audit_is_the_jax_audit(ranks):
    """Two same-seed k = 2 runs give one chain; the audit of a flipped
    bind names its cycle and pod, and its rows carry shard_a and shard_b
    as the JAX audit of the same pair does (null: the reference's
    _shard_owner reads fields no checkpoint writes)."""
    reports = []
    for r in ranks[2]:
        got = r["audit"]
        assert got["chains"][0] == got["chains"][1]
        assert got["same"] == "identical"
        report = got["report"]
        pod, old, new = got["flip"]
        assert report["verdict"] == "diverged"
        assert report["divergent_cycle"] == SW.FLIPPED_CYCLE
        assert report["bind_diff"] == [{"pod": pod, "a": old, "b": new,
                                        "shard_a": None, "shard_b": None}]
        reports.append(report)
    assert reports[0] == reports[1]
    a, flipped = ranks[2][0]["audit"]["dirs"]
    assert SW.strip_report(jax_audit(a, flipped)) == reports[0]


def _labeled(n):
    snap = synthetic_cluster(n)
    for i, node in enumerate(snap.nodes):
        node.metadata.labels.update(
            {k: vals[i % len(vals)]
             for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
    return snap


def test_service_affinity_stays_single_device(ranks):
    session = StreamSession(_labeled(16), device="cpu",
                            policy=decode_policy(SW.policy_dict(True)))
    gen = ChurnLoadGen(_labeled(16), seed=4, arrivals=6)
    hashes = []
    for cycle in range(3):
        session.apply_events(gen.events(cycle))
        placements = session.schedule(gen.batch())
        gen.note_bound(placements)
        hashes.append(placement_hash(placements))
    for r in ranks[2]:
        (got, layout), counted = r["fallbacks"]["service_affinity"]
        assert got == hashes
        assert layout is None
        assert counted == 1   # the one restage decides, counts once


@pytest.mark.parametrize("reason", ["explain_lanes", "device_count"])
def test_fallbacks_counted(ranks, reason):
    for r in ranks[2]:
        (_, layout), counted = r["fallbacks"][reason]
        assert layout is None and counted == 1
    if reason == "device_count":
        session = StreamSession(synthetic_cluster(16), device="cpu")
        gen = ChurnLoadGen(synthetic_cluster(16), seed=4, arrivals=6)
        want = placement_hash(session.schedule(gen.batch()))
        assert all(r["fallbacks"][reason][0][0] == want for r in ranks[2])


def test_ranks_that_disagree_raise(ranks):
    for r in ranks[2]:
        assert "host pictures differ" in r["disagreeing"]
