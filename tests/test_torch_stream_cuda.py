"""The streaming twin's device programs on the card against the same work on
the CPU (tolerance 0): the resident scan (its graph captured once and
replayed over the resident tensors) against schedule_scan, the gang packing
solve against its numpy oracle (ties included), one overlay query's
rollback of the resident carry, and whole stream runs (synchronous,
pipelined, with gangs admitted and rejected, and with a policy) against the
CPU's chains.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_stream_cuda.py

Without a card every case skips.
"""

import numpy as np
import pytest
import torch

from tpusim_torch import scan
from tpusim_torch import workloads as W
from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
from tpusim_torch.backends import placement_hash
from tpusim_torch.config import config_for
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.gang.oracle import select_oracle
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.state import compile_cluster
from tpusim_torch.stream import ChurnLoadGen, StreamSession
from tpusim_torch.whatif import run_what_if


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cuda_resident_scan_matches_schedule_scan():
    need_card()
    snapshot, pods = W.build_workload(192, 300, seed=21)
    compiled, cols = compile_cluster(snapshot, pods)
    config = config_for(compiled, most_requested=False)
    cuda = torch.device("cuda")
    carry = scan.carry_init(compiled, cuda)
    statics = scan.statics_to(compiled, cuda)
    xs_host = scan.pod_columns_to_host(cols)
    program = scan.ResidentScan(config, carry, statics, 64,
                                graph_steps=scan.GRAPH_STEPS)
    ref = scan.carry_init(compiled, cuda)
    graphs = []
    for k in range(3):        # capture and replay, then replays alone
        rows = scan.PodX(*(np.asarray(c)[64 * k:64 * (k + 1)]
                           for c in xs_host))
        ref_carry, ch, ct, _ = scan.schedule_scan(
            config, ref, statics, scan.tree_to(rows, cuda, index=True))
        out = program.run(rows)
        assert torch.equal(out.choices, ch) and torch.equal(out.counts, ct)
        for name, a, b in zip(scan.Carry._fields, carry, ref_carry):
            assert torch.equal(a, b), name
        ref = ref_carry
        graphs.append(program._steps.graph)
    assert graphs[0] is not None and graphs.count(graphs[0]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,seed", [(2, 3, 0), (4, 8, 1), (7, 16, 2),
                                      (12, 5, 3), (8, 2000, 4)])
def test_cuda_gang_select_matches_the_oracle(m, n, seed):
    need_card()
    rng = np.random.RandomState(seed)
    feasible = rng.rand(m, n) > 0.3
    # a narrow score range: many ties for the first-occurrence argmax
    score = rng.randint(0, 4, size=(m, n)).astype(np.int64)
    members = (feasible, score, rng.randint(0, 2000, m).astype(np.int64),
               rng.randint(0, 2**30, m).astype(np.int64),
               np.zeros(m, np.int64), np.zeros(m, np.int64), rng.rand(m) > 0.8)
    nodes = dict(
        alloc_cpu=np.full(n, 4000, np.int64),
        alloc_mem=np.full(n, 2**34, np.int64),
        alloc_gpu=np.zeros(n, np.int64), alloc_eph=np.zeros(n, np.int64),
        allowed_pods=np.full(n, 8, np.int64),
        used_cpu=rng.randint(0, 2000, n).astype(np.int64),
        used_mem=np.zeros(n, np.int64), used_gpu=np.zeros(n, np.int64),
        used_eph=np.zeros(n, np.int64),
        pod_count=rng.randint(0, 4, n).astype(np.int64),
        zone_dom=rng.randint(0, 3, n).astype(np.int32),
        rack_dom=rng.randint(0, 4, n).astype(np.int32))
    want = select_oracle(*members, *nodes.values(), 3, 4)
    gi = scan.GangIn(**{k: torch.as_tensor(v, device="cuda")
                        for k, v in nodes.items()})
    got = scan.gang_select(*(torch.as_tensor(a, device="cuda")
                             for a in members), gi, 3, 4)
    assert got.tolist() == want


@pytest.mark.cuda
def test_cuda_overlay_restores_the_carry():
    need_card()
    session = StreamSession(synthetic_cluster(64))
    gen = ChurnLoadGen(synthetic_cluster(64), seed=16, arrivals=32,
                       evict_fraction=0.25)
    for c in range(4):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
    rng = np.random.RandomState(16)
    qpods = [make_pod(f"q{i}", milli_cpu=int(rng.randint(100, 1500)),
                      memory=int(rng.randint(2 ** 20, 2 ** 30)))
             for i in range(8)]
    before = [t.clone() for t in session.device.carry]
    placements = session.overlay_query(qpods)
    for name, a, b in zip(scan.Carry._fields, before, session.device.carry):
        assert torch.equal(a, b), name
    [oracle] = run_what_if([(session.inc.to_snapshot(), qpods)])
    assert placement_hash(placements) == placement_hash(oracle.placements)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["churn", "pipelined", "gangs",
                                  "gang_reject", "policy"])
def test_cuda_stream_matches_cpu(case):
    need_card()
    kw = dict(num_nodes=48, cycles=10, arrivals=24, seed=9,
              node_flap_every=4, whatif_every=3)
    if case == "pipelined":
        kw.update(pipeline=True, label_churn=2)
    elif case == "gangs":
        kw.update(gang_size=4, gang_count=1, verify=True)
    elif case == "gang_reject":
        # 4 nodes fill by the third cycle: from then on every gang is
        # rejected whole, its trial binds rolled back
        kw.update(num_nodes=4, gang_size=4, gang_count=1, verify=True)
    elif case == "policy":
        kw.update(label_churn=2, taint_churn=1, node_flap_every=0)
    runs = {}
    for device in ("cpu", "cuda"):
        policy = (decode_policy(W.COMPAT_POLICIES["1.9"])
                  if case == "policy" else None)
        runs[device] = run_stream_simulation(device=device, policy=policy,
                                             **kw)
    for key in ("placement_chain", "fold_chain", "paths", "restages",
                "commits", "load", "overlay"):
        if key == "overlay":
            for k in ("queries", "answered", "fallbacks"):
                assert runs["cuda"][key][k] == runs["cpu"][key][k]
        else:
            assert runs["cuda"][key] == runs["cpu"][key], key
    assert runs["cuda"].get("verified", True)
    if case == "gang_reject":
        assert runs["cuda"]["unschedulable"] > 0
