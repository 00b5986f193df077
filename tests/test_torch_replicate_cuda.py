"""Replication, tenancy and the audit on the card, against the same runs on
the CPU (tolerance 0: chains, hashes and reports are exact).

- A replicated run captures CUDA graphs on two threads (the leader on the
  caller's, the follower on its pump thread); two such runs at once, their
  leaders held to enter their first capture together and each follower's
  first capture held to start with both leaders' first graph replays, must
  give the CPU's chains and capture as many graphs as the runs alone do.
- A tenant's eviction gives its device memory back: memory_allocated falls
  by at least the twin's bytes.
- The audit's forensic re-run on the card reports what it reports on the
  CPU (the decision records' time stamps aside).
- A serve thread reads a follower's overlay on the card while the
  follower replays.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_replicate_cuda.py

Without a card every case skips.
"""

import copy
import gc
import json
import os
import shutil
import threading

import pytest
import torch

from tpusim_torch import scan
from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
from tpusim_torch.backends import placement_hash
from tpusim_torch.chaos.plan import kill_leader_campaign
from tpusim_torch.obs.audit import audit_wal_pair
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
from tpusim_torch.simulator import (
    run_replicated_stream,
    run_stream_simulation,
)
from tpusim_torch.stream import (
    CRASH_POINTS,
    ChurnLoadGen,
    ResidencyBudget,
    StreamPersistence,
    StreamSession,
    replicate,
)
from tpusim_torch.whatif import run_what_if

SHAPE = dict(num_nodes=64, cycles=8, arrivals=32, evict_fraction=0.25,
             node_flap_every=3, seed=5)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _no_process_state():
    replicate.set_role("none")
    yield
    replicate.set_role("none")


def _graphs_of(fn):
    before = scan.graphs_captured()
    out = fn()
    return out, scan.graphs_captured() - before


@pytest.mark.cuda
def test_cuda_replicated_runs_capture_on_two_threads_at_once(tmp_path):
    need_card()
    plan = kill_leader_campaign(seed=5, cycles=SHAPE["cycles"])[
        CRASH_POINTS.index("emit")]
    want = run_stream_simulation(**SHAPE, device="cpu")["fold_chain"]
    # each arm alone on the card: its chain and the graphs it captures
    alone = {}
    for arm, kw in (("steady", {}), ("crash", {"chaos_plan": plan})):
        out, graphs = _graphs_of(lambda: run_replicated_stream(
            **SHAPE, checkpoint_dir=str(tmp_path / f"alone-{arm}"),
            checkpoint_every=5, device="cuda", **kw))
        assert out["fold_chain"] == want
        alone[arm] = graphs
    assert alone["steady"] > 0

    # both arms at once, their leaders' first captures entered together;
    # then each follower's first capture entered together with both
    # leaders' first graph replays (a follower decides a cycle once its
    # leader's bind record arrives, so a leader meets its own follower's
    # capture in its next cycle, and never waits on it)
    leaders_capture = threading.Barrier(2, timeout=60.0)
    pairs = threading.Barrier(4, timeout=60.0)
    met = {"capture": set(), "pair": set()}
    run = scan._Steps.run

    def run_together(self, count):
        me = threading.current_thread()
        ready = self.graph_steps and count >= self.graph_steps
        leader = me.name.startswith("arm-")
        follower = me.name == "tpusim-follower"
        if ready and self.graph is None and leader \
                and me.name not in met["capture"]:
            met["capture"].add(me.name)
            leaders_capture.wait()
        elif ready and me.ident not in met["pair"] and (
                (leader and self.graph is not None)
                or (follower and self.graph is None)):
            met["pair"].add(me.ident)
            pairs.wait()
        return run(self, count)

    outs, errors = {}, []

    def arm(name, kw):
        try:
            outs[name] = run_replicated_stream(
                **SHAPE, checkpoint_dir=str(tmp_path / f"both-{name}"),
                checkpoint_every=5, device="cuda", **kw)
        except BaseException as exc:   # reported below, not swallowed
            errors.append(exc)

    scan._Steps.run = run_together
    try:
        before = scan.graphs_captured()
        threads = [threading.Thread(target=arm, args=(n, kw), name=f"arm-{n}")
                   for n, kw in (("steady", {}), ("crash",
                                                  {"chaos_plan": plan}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        graphs = scan.graphs_captured() - before
    finally:
        scan._Steps.run = run
    assert not errors, errors
    assert met["capture"] == {"arm-steady", "arm-crash"}
    assert len(met["pair"]) == 4
    assert outs["steady"]["fold_chain"] == want
    assert outs["steady"]["follower_chain_matches"]
    assert outs["crash"]["promoted"] and outs["crash"]["fold_chain"] == want
    assert graphs == alone["steady"] + alone["crash"]


@pytest.mark.cuda
def test_cuda_tenant_eviction_frees_device_memory(tmp_path):
    need_card()
    budget = ResidencyBudget(1 << 40, device="cuda")
    budget.admit("a", synthetic_cluster(2_000),
                 directory=str(tmp_path / "a"), checkpoint_every=0)
    gen = ChurnLoadGen(synthetic_cluster(2_000), seed=16, arrivals=64,
                       evict_fraction=0.25)
    for c in range(3):
        budget.session("a").apply_events(gen.events(c))
        gen.note_bound(budget.schedule("a", gen.batch()))
    chain = budget.chain("a")
    nbytes = budget._tenants["a"].nbytes()
    assert nbytes > 0
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated()
    budget.evict("a")
    gc.collect()
    after = torch.cuda.memory_allocated()
    assert before - after >= nbytes, (before, after, nbytes)
    budget.restore("a")
    assert budget.chain("a") == chain
    budget.session("a").apply_events(gen.events(3))
    gen.note_bound(budget.schedule("a", gen.batch()))
    assert budget._tenants["a"].nbytes() > 0


def _strip(report):
    out = copy.deepcopy(report)
    for rec in out.get("replay", {}).get("decisions", []):
        rec.pop("ts", None)
    return out


@pytest.mark.cuda
def test_cuda_audit_rerun_equals_cpu(tmp_path):
    need_card()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    run_stream_simulation(num_nodes=64, cycles=6, arrivals=16, seed=3,
                          checkpoint_dir=a, checkpoint_every=0,
                          device="cuda")
    shutil.copytree(a, b)
    path = os.path.join(b, StreamPersistence.WAL)
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    nodes = sorted({n for r in records if r["k"] == "bind" for _, n in r["b"]})
    target = next(r for r in records
                  if r["k"] == "bind" and r["c"] >= 3 and r["b"])
    target["b"][0][1] = next(n for n in nodes if n != target["b"][0][1])
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
    card = audit_wal_pair(a, b, explain_k=3, device="cuda")
    assert card["divergent_cycle"] == target["c"]
    assert card["kind"] == "bind" and card["replay_agrees_with"] == "a"
    assert _strip(card) == _strip(audit_wal_pair(a, b, explain_k=3,
                                                 device="cpu"))


@pytest.mark.cuda
def test_cuda_replica_reads_from_a_serve_thread(tmp_path):
    need_card()
    follower = replicate.FollowerTwin(synthetic_cluster(200), device="cuda")
    leader = StreamSession(synthetic_cluster(200), device="cuda")
    persist = StreamPersistence(str(tmp_path), checkpoint_every=2)
    shipper = replicate.WalShipper(persist, follower.address)
    leader.attach_persistence(persist)
    gen = ChurnLoadGen(synthetic_cluster(200), seed=16, arrivals=32,
                       evict_fraction=0.25)
    fleet = ScenarioFleet(bucket_size=4, device="cuda")
    try:
        for c in range(4):
            leader.apply_events(gen.events(c))
            gen.note_bound(leader.schedule(gen.batch()))
        assert shipper.drain(60.0)
        fleet.attach_stream(leader)
        fleet.attach_replica(follower)
        pods = [make_pod(f"q{i}", milli_cpu=300 + 100 * i, memory=1 << 28)
                for i in range(8)]
        # the fleet answers on its worker thread while the leader goes on
        # and the follower replays on its pump thread
        done = []
        reader = threading.Thread(target=lambda: done.append(fleet.run(
            [WhatIfRequest(pods=pods[:1 + i % 8], snapshot_ref="live")
             for i in range(8)])))
        reader.start()
        for c in range(4, 6):
            leader.apply_events(gen.events(c))
            gen.note_bound(leader.schedule(gen.batch()))
        reader.join(timeout=120.0)
        assert done and all(r.error is None for r in done[0])
        assert shipper.drain(60.0)
        assert follower.diverged is None and follower.chain == persist.chain
        [want] = run_what_if([(follower.session.inc.to_snapshot(), pods)],
                             device="cpu")
        [resp] = fleet.run([WhatIfRequest(pods=pods, snapshot_ref="live")])
        assert placement_hash(resp.result.placements) == \
            placement_hash(want.placements)
    finally:
        fleet.stop()
        shipper.close(drain=False)
        persist.close()
        follower.stop()
