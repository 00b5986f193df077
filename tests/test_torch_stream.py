"""The port's streaming twin (tpusim_torch/stream/, run_stream_simulation)
against the JAX package's (tpusim/stream/), on the CPU.

run_stream_simulation(device="cpu") on the fixtures of tests/test_stream.py
(steady churn, node flaps classified groups_dirty, the always-restage arm,
policies 1.0, 1.3 and 1.9 under label and taint churn, pipelined cycles,
live what-if overlays) must give the JAX package's placement_chain,
fold_chain, paths, restages, commits and load counts on the same arguments,
and verify=True must find no cycle that differs from a fresh
TorchBackend.schedule. Overlay queries must answer as run_what_if on the
live snapshot does and leave the resident carry bit-equal, tensor by
tensor. Tolerance: exact (hashes and integer tensors equal).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import tpusim.api.snapshot as jax_api
from tpusim.engine.policy import decode_policy as jax_decode
from tpusim.framework.store import DELETED as JAX_DELETED
from tpusim.simulator import run_stream_simulation as jax_stream
from tpusim.stream import StreamSession as JaxSession

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.backends import placement_hash
from tpusim_torch.engine.policy import decode_policy as port_decode
from tpusim_torch.framework.store import DELETED
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import (
    MIN_BUCKET,
    ChurnLoadGen,
    StreamSession,
    bucket_size,
)
from tpusim_torch.whatif import run_what_if

NODES = 8
ARRIVALS = 8
KEYS = ("placement_chain", "fold_chain", "paths", "restages", "commits",
        "load")
POLICIES = json.loads(
    (pathlib.Path(__file__).parent / "compat_policies.json").read_text())


def both(policy=None, **kw):
    """The JAX package's summary and the port's on the same arguments."""
    kw.setdefault("num_nodes", NODES)
    kw.setdefault("arrivals", ARRIVALS)
    want = jax_stream(**kw, **({"policy": jax_decode(POLICIES[policy])}
                               if policy else {}))
    got = run_stream_simulation(device="cpu", **kw, **(
        {"policy": port_decode(POLICIES[policy])} if policy else {}))
    for key in KEYS:
        assert got[key] == want[key], key
    for key in ("verified", "mismatched_cycles"):
        assert got.get(key) == want.get(key), key
    if "overlay" in want:
        for key in ("queries", "answered", "fallbacks"):
            assert got["overlay"][key] == want["overlay"][key], key
    return got


def assert_accounted(out):
    """Every cycle took one path, and every cycle off the resident path was
    classified with one restage reason."""
    assert sum(out["paths"].values()) == out["cycles"]
    off = (out["cycles"] - out["paths"].get("stream_scan", 0)
           - out["paths"].get("pipelined", 0)
           - out["paths"].get("no_nodes", 0) - out["paths"].get("gang", 0))
    assert sum(out["restages"].values()) == off


def test_bucket_size_pow2_floor():
    assert bucket_size(0) == MIN_BUCKET
    assert bucket_size(1) == MIN_BUCKET
    assert bucket_size(MIN_BUCKET) == MIN_BUCKET
    assert bucket_size(MIN_BUCKET + 1) == MIN_BUCKET * 2
    assert bucket_size(100) == 128


@pytest.mark.parametrize("seed,flap_every,evict", [
    (0, 0, 0.25), (1, 4, 0.25), (2, 3, 0.5)])
def test_churn_matches_jax(seed, flap_every, evict):
    out = both(cycles=8, seed=seed, node_flap_every=flap_every,
               evict_fraction=evict, verify=True)
    assert out["verified"] and out["mismatched_cycles"] == 0
    assert_accounted(out)
    assert out["paths"].get("stream_scan", 0) >= 1
    assert out["restages"].get("cold_start") == 1


def test_flap_restages_classified_groups_dirty():
    out = both(cycles=7, seed=3, node_flap_every=3, verify=True)
    assert out["restages"] == {"cold_start": 1, "groups_dirty": 3}
    assert out["paths"] == {"restage_scan": 4, "stream_scan": 3}
    assert out["commits"] == 3


def test_always_restage_chain_equals_stream():
    stream = both(cycles=6, seed=4, node_flap_every=3)
    restage = both(cycles=6, seed=4, node_flap_every=3, always_restage=True)
    assert restage["placement_chain"] == stream["placement_chain"]
    assert restage["restages"] == {"forced_restage": 6}
    assert restage["commits"] == 0


@pytest.mark.parametrize("version", ["1.0", "1.3", "1.9"])
def test_policy_churn_matches_jax(version):
    out = both(policy=version, cycles=8, seed=9, label_churn=2,
               taint_churn=1, verify=True)
    assert out["verified"]
    assert out["restages"] == {"cold_start": 1}
    assert out["paths"] == {"restage_scan": 1, "stream_scan": 7}


def test_pipelined_matches_synchronous():
    sync = both(cycles=8, seed=12, label_churn=2)
    pipe = both(cycles=8, seed=12, label_churn=2, pipeline=True)
    assert pipe["placement_chain"] == sync["placement_chain"]
    assert pipe["paths"].get("pipelined", 0) >= 6
    assert_accounted(pipe)
    sync = both(policy="1.3", cycles=8, seed=13, label_churn=2,
                taint_churn=1)
    pipe = both(policy="1.3", cycles=8, seed=13, label_churn=2,
                taint_churn=1, pipeline=True, verify=True)
    assert pipe["placement_chain"] == sync["placement_chain"]
    assert pipe["restages"] == {"cold_start": 1} and pipe["verified"]


@pytest.mark.parametrize("pipeline", [False, True])
def test_live_whatif_matches_jax_and_leaves_the_chain(pipeline):
    kw = dict(cycles=8, seed=3, evict_fraction=0.25, node_flap_every=3,
              pipeline=pipeline)
    base = both(**kw)
    live = both(whatif_every=1, whatif_pods=6, **kw)
    assert live["placement_chain"] == base["placement_chain"]
    assert live["overlay"]["queries"] == 8
    assert live["overlay"]["answered"] >= 4


def carry_copy(session):
    return [t.clone() for t in session.device.carry]


@pytest.mark.parametrize("pipelined", [False, True])
def test_overlay_equals_run_what_if_and_restores_the_carry(pipelined):
    """After every cycle, a query on the resident twin: its placements equal
    run_what_if's on the live snapshot, and the resident tensors are
    bit-equal to what they held before it."""
    session = StreamSession(port_api.synthetic_cluster(NODES), device="cpu")
    gen = ChurnLoadGen(port_api.synthetic_cluster(NODES), seed=7,
                       arrivals=ARRIVALS, evict_fraction=0.25)
    rng = np.random.RandomState(1)
    answered = 0
    for cycle in range(6):
        if pipelined:
            gen.note_bound(session.poll_placed())
        session.apply_events(gen.events(cycle))
        if pipelined:
            session.schedule_pipelined(gen.batch())
        else:
            gen.note_bound(session.schedule(gen.batch()))
        if not session.device.valid:
            continue
        qpods = [port_api.make_pod(
            f"q{cycle}-{i}", milli_cpu=int(rng.randint(100, 1500)),
            memory=int(rng.randint(2 ** 20, 2 ** 30))) for i in range(5)]
        if pipelined:
            # the overlay folds the in-flight cycle first; the carry is
            # compared from there on
            session._fold_binds(session._pending)
        before = carry_copy(session)
        journal = (set(session.inc._journal_nodes),
                   set(session.inc._journal_presence))
        placements = session.overlay_query(qpods)
        assert placements is not None
        answered += 1
        [oracle] = run_what_if([(session.inc.to_snapshot(), qpods)],
                               device="cpu")
        assert placement_hash(placements) == placement_hash(
            oracle.placements)
        after = session.device.carry
        for name, a, b in zip(after._fields, before, after):
            assert torch.equal(a, b), f"carry.{name} changed"
        assert (set(session.inc._journal_nodes),
                set(session.inc._journal_presence)) == journal
    if pipelined:
        session.flush()
    assert answered >= 4


def test_no_nodes_cycle():
    session = StreamSession(port_api.ClusterSnapshot(nodes=[], pods=[]),
                            device="cpu")
    placements = session.schedule([port_api.make_pod("orphan", milli_cpu=100,
                                                     memory=1 << 20)])
    assert [pl.node_name for pl in placements] == [""]
    assert placements[0].message == "no nodes available to schedule pods"
    assert session.cycles == 1
    assert session.path_counts == {"no_nodes": 1}
    assert session.restage_counts == {}
    jax_session = JaxSession(jax_api.ClusterSnapshot(nodes=[], pods=[]))
    want = jax_session.schedule([jax_api.make_pod("orphan", milli_cpu=100,
                                                  memory=1 << 20)])
    assert placement_hash(placements) == placement_hash(want)


def test_policy_plan_change_classified():
    def session_for(api, cls, decode, **kw):
        from tpusim_torch.stream.loadgen import DEFAULT_LABEL_UNIVERSE

        snap = api.synthetic_cluster(NODES)
        for i, node in enumerate(snap.nodes):
            node.metadata.labels.update(
                {k: vals[i % len(vals)]
                 for k, vals in DEFAULT_LABEL_UNIVERSE.items()})
        session = cls(snap, policy=decode(POLICIES["1.0"]), **kw)
        hashes = []
        for c in range(5):
            if c == 2:
                session.set_policy(decode(POLICIES["1.9"]))
            if c == 4:
                session.set_policy(decode(POLICIES["1.9"]))
            hashes.append(placement_hash(session.schedule([api.make_pod(
                f"swap-{c}-{i}", milli_cpu=50, memory=1 << 20)
                for i in range(4)])))
        return session.restage_counts, hashes

    got = session_for(port_api, StreamSession, port_decode, device="cpu")
    assert got == session_for(jax_api, JaxSession, jax_decode)
    assert got[0] == {"cold_start": 1, "policy_plan_change": 1}


def test_interpod_presence_churn_restages_as_jax():
    """Presence churn under inter-pod terms has no commit path
    (presence_dom): the next cycle restages, classified interpod_delta."""
    def run(api, cls, deleted, **kw):
        snap = api.synthetic_cluster(NODES)
        web = []
        for i in range(3):
            pod = api.make_pod(f"web-{i}", milli_cpu=100, labels={"app": "web"},
                               node_name=f"node-{i}", affinity={
                                   "podAntiAffinity": {
                                       "requiredDuringSchedulingIgnoredDuringExecution": [
                                           {"labelSelector": {"matchLabels": {
                                               "app": "web"}},
                                            "topologyKey":
                                                "kubernetes.io/hostname"}]}})
            snap.pods.append(pod)
            web.append(pod)
        session = cls(snap, **kw)
        hashes = []
        for c in range(4):
            if c == 2:
                session.apply(deleted, web[0])
            hashes.append(placement_hash(session.schedule([api.make_pod(
                f"p{c}-{i}", milli_cpu=200, memory=1 << 26)
                for i in range(4)])))
        return session.restage_counts, session.path_counts, hashes

    got = run(port_api, StreamSession, DELETED, device="cpu")
    assert got == run(jax_api, JaxSession, JAX_DELETED)
    assert got[0] == {"cold_start": 1, "interpod_delta": 1}


def test_policy_churn_fifty_cycles_only_cold_start():
    """Fifty cycles of pure label and taint churn under a fixed plan
    restage once, at the cold start: every churned column rides the statics
    commit."""
    out = both(policy="1.0", cycles=50, seed=11, label_churn=2,
               taint_churn=1)
    assert out["restages"] == {"cold_start": 1}
    assert out["paths"] == {"restage_scan": 1, "stream_scan": 49}
    assert out["load"]["label_churns"] == 100
    assert out["load"]["taint_churns"] == 50


@pytest.mark.parametrize("extra", [
    [], ["--gang-size", "3", "--gang-count", "1", "--verify"],
    ["--pipeline", "--whatif-every", "2", "--label-churn", "1"]])
def test_stream_cli_matches_jax(extra, capsys):
    from tpusim.cli import main as jax_main

    from tpusim_torch.cli import main as port_main

    argv = ["stream", "--synthetic-nodes", "8", "--cycles", "4",
            "--arrivals", "6", "--seed", "3", "--json"] + extra

    def summary():
        out = capsys.readouterr().out
        return json.loads(out[out.index("{"):out.rindex("}") + 1])

    assert jax_main(argv) == 0
    want = summary()
    assert port_main(argv + ["--device", "cpu"]) == 0
    got = summary()
    for key in KEYS + ("scheduled", "unschedulable"):
        assert got[key] == want[key], key
    assert got.get("verified") == want.get("verified")


def test_stream_cli_refuses_synthetic_sizes_it_would_ignore(capsys):
    from tpusim_torch.cli import main as port_main

    for flag, value in (("--synthetic-milli-cpu", "8000"),
                        ("--synthetic-memory", str(1 << 30))):
        assert port_main(["stream", flag, value, "--device", "cpu"]) == 2
        assert flag in capsys.readouterr().err
