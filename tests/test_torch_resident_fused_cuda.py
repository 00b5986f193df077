"""The resident scan's fused step on the card against its torch step
(tolerance 0): csrc/resident_step.cu, one launch a step, held to
scan.make_step's torch operations on the same resident tensors, bucket by
bucket, on choices, counts, advanced, every field of the carry and rr.

Cases:
  (a) the scheduler-perf-5000n cluster at full size (5,000 nodes, 150,000
      Running pods), several buckets back to back, every decision a tie;
  (b) group-free clusters of mixed node shapes with taints, node selectors,
      hostname pins, NodePreferAvoidPods and scalar resources: refused pods
      (non-zero histograms), pods with none, one and many feasible nodes,
      and ties that wrap rr;
  (c) nodes large enough that req_cpu * alloc_mem overflows int64;
  (d) ghost pad rows (GHOST_CPU) and padded nodes (PAD_SENTINEL);
  (e) apply_delta_, apply_statics_delta_ and overlay_restore_ between
      replays of the captured graph, which reads the patched tensors;
  (f) whole twins through StreamSession (sequential, pipelined, overlay
      what-ifs) against the same twins on the torch step.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_resident_fused_cuda.py

Without a card every case skips.
"""

import json

import numpy as np
import pytest
import torch

from tpusim_torch import scan
from tpusim_torch import workloads as W
from tpusim_torch.api.snapshot import ClusterSnapshot, make_node, make_pod
from tpusim_torch.api.types import OwnerReference
from tpusim_torch.backends import placement_hash
from tpusim_torch.config import config_for
from tpusim_torch.sharding import pad_node_axis
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.state import compile_cluster
from tpusim_torch.stream import StreamSession

BUCKET = 64
AVOID = "scheduler.alpha.kubernetes.io/preferAvoidPods"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def torch_step_only(monkeypatch):
    """Every program built in the context takes the torch step."""
    monkeypatch.setattr(scan, "fused_step_eligible", lambda *a, **k: False)


def _clone(tree):
    return type(tree)(*(t.clone() for t in tree))


class Pair:
    """A fused program and a torch-step program on two equal copies of the
    same resident tensors."""

    def __init__(self, config, statics, carry, monkeypatch, bucket=BUCKET):
        self.statics, self.carry = statics, carry
        self.fused = scan.ResidentScan(config, carry, statics, bucket,
                                       graph_steps=scan.GRAPH_STEPS)
        assert self.fused.route == "fused_step"
        self.ref_statics, self.ref_carry = _clone(statics), _clone(carry)
        with monkeypatch.context() as m:
            torch_step_only(m)
            self.ref = scan.ResidentScan(config, self.ref_carry,
                                         self.ref_statics, bucket,
                                         graph_steps=scan.GRAPH_STEPS)
        assert self.ref.route == "torch_step"
        self.bucket = bucket
        self.kinds = {"refused": 0, "one": 0, "many": 0}

    def run(self, rows):
        """One bucket on both routes; every output and carry field equal."""
        before = scan.fused_buckets()
        got = self.fused.run(rows)
        want = self.ref.run(rows)
        torch.cuda.synchronize()
        assert scan.fused_buckets() == before + 1
        for name, a, b in zip(scan.ScanOutputs._fields, got, want):
            assert torch.equal(a, b), name
        for name, a, b in zip(scan.Carry._fields, self.carry, self.ref_carry):
            assert torch.equal(a, b), name
        choices = want.choices.cpu().numpy()
        adv = want.advanced.cpu().numpy()
        real = np.asarray(rows.req_cpu) != scan.GHOST_CPU
        self.kinds["refused"] += int(((choices < 0) & real).sum())
        self.kinds["one"] += int(((choices >= 0) & ~adv).sum())
        self.kinds["many"] += int(adv.sum())
        return want

    def run_all(self, xs_host, between=None):
        p = len(np.asarray(xs_host.req_cpu))
        xs = scan.pad_infeasible_rows(xs_host, (-p) % self.bucket)
        for k in range(len(np.asarray(xs.req_cpu)) // self.bucket):
            if between is not None:
                between(k)
            self.run(scan.PodX(*(np.asarray(c)[k * self.bucket:
                                               (k + 1) * self.bucket]
                                 for c in xs)))
        assert self.fused.graph_captured and self.ref.graph_captured


def _pair_of(snapshot, pods, monkeypatch, most=False, pad_to=0):
    compiled, cols = compile_cluster(snapshot, pods)
    config = config_for(compiled, most_requested=most)
    statics = scan.statics_to_host(compiled)
    carry = scan.carry_init_host(compiled)
    if pad_to:
        statics, carry, _ = pad_node_axis(statics, carry, pad_to)
    cuda = torch.device("cuda")
    pair = Pair(config, scan.tree_to(statics, cuda, index=True),
                scan.tree_to(carry, cuda), monkeypatch)
    return pair, scan.pod_columns_to_host(cols)


def with_avoid(snapshot, pods, seed):
    """NodePreferAvoidPods on every fourth node against one of two
    ReplicaSets, which every third pod belongs to."""
    rng = np.random.RandomState(seed)
    for i, node in enumerate(snapshot.nodes):
        if i % 4 == 1:
            uid = f"rs-{rng.randint(2)}"
            node.metadata.annotations[AVOID] = json.dumps({"preferAvoidPods": [
                {"podSignature": {"podController": {
                    "kind": "ReplicaSet", "uid": uid}}}]})
    for i, pod in enumerate(pods):
        if i % 3 == 0:
            pod.metadata.owner_references.append(OwnerReference(
                api_version="apps/v1", kind="ReplicaSet", name="rs",
                uid=f"rs-{i % 2}", controller=True))
    return snapshot, pods


@pytest.mark.cuda
def test_scheduler_perf_5000n_buckets_back_to_back(monkeypatch):
    need_card()
    pair, xs = _pair_of(*W.scheduler_perf_workload(6 * BUCKET), monkeypatch)
    pair.run_all(xs)
    assert pair.kinds == {"refused": 0, "one": 0, "many": 6 * BUCKET}
    assert pair.fused._steps.graph_steps == BUCKET


@pytest.mark.cuda
@pytest.mark.parametrize("seed,pods,nodes,scalars,most", [
    (0, 320, 200, 2, False), (1, 256, 61, 1, True), (2, 192, 333, 0, False)])
def test_mixed_group_free_clusters(monkeypatch, seed, pods, nodes, scalars,
                                   most):
    need_card()
    snapshot, plist = with_avoid(*W.random_workload(
        seed, pods, nodes, num_scalars=scalars, infeasible=True), seed)
    pair, xs = _pair_of(snapshot, plist, monkeypatch, most=most)
    pair.run_all(xs)
    assert min(pair.kinds.values()) > 0, pair.kinds


@pytest.mark.cuda
def test_ties_wrap_rr(monkeypatch):
    need_card()
    pair, xs = _pair_of(*W.uniform_workload(3 * BUCKET, 12), monkeypatch)
    pair.run_all(xs)
    # 12 equal nodes: rr passes the ties within the first bucket
    assert pair.kinds["many"] > 12
    assert int(pair.carry.rr) > 12


@pytest.mark.cuda
def test_products_past_int64(monkeypatch):
    need_card()
    rng = np.random.RandomState(5)
    nodes = [make_node(f"big-{i}", milli_cpu=int(rng.randint(1, 8)) << 20,
                       memory=int(rng.randint(1, 8)) << 52, pods=500)
             for i in range(96)]
    pods = [make_pod(f"p-{k}", milli_cpu=int(rng.randint(1, 1 << 19)),
                     memory=int(rng.randint(1, 1 << 50)))
            for k in range(2 * BUCKET)]
    # req_cpu * alloc_mem and alloc_cpu * alloc_mem overflow int64
    assert (1 << 19) * (1 << 52) > 2**63
    pair, xs = _pair_of(ClusterSnapshot(nodes=nodes), pods, monkeypatch)
    pair.run_all(xs)
    assert pair.kinds["many"] > 0


@pytest.mark.cuda
def test_ghost_rows_and_padded_nodes(monkeypatch):
    need_card()
    snapshot, plist = W.random_workload(7, 100, 37, num_scalars=1)
    pair, xs = _pair_of(snapshot, plist, monkeypatch, pad_to=16)
    cond = pair.statics.cond_fail_bits.cpu().numpy()
    assert len(cond) == 48 and (cond[37:] & scan.PAD_SENTINEL).all()
    pair.run_all(xs)     # 100 pods in buckets of 64: 28 ghost rows
    assert pair.kinds["many"] > 0


def _host_rows(carry, idx):
    return scan.DeltaRows(*(getattr(carry, name)[idx].cpu().numpy()
                            for name in scan.DeltaRows._fields))


@pytest.mark.cuda
def test_commits_between_replays(monkeypatch):
    need_card()
    snapshot, plist = with_avoid(*W.random_workload(
        11, 6 * BUCKET, 150, num_scalars=2), 11)
    pair, xs = _pair_of(snapshot, plist, monkeypatch)
    rng = np.random.RandomState(3)
    n = pair.statics.alloc_cpu.shape[0]
    fd = pair.carry.sa_lock.shape[0]
    saved = {}

    def between(k):
        if k == 0:
            return     # the first bucket captures both graphs
        sides = ((pair.statics, pair.carry), (pair.ref_statics,
                                               pair.ref_carry))
        if k == 1:
            # the host's authoritative rows: some usage freed
            idx = np.unique(rng.randint(0, n, 16))
            rows = _host_rows(pair.carry, idx)
            rows = rows._replace(used_cpu=rows.used_cpu // 2,
                                 pod_count=np.maximum(rows.pod_count - 1, 0))
            zero = np.zeros(8, np.int64)
            for _, carry in sides:
                scan.apply_delta_(carry, idx, rows, zero, zero,
                                  np.zeros(8, np.int32),
                                  np.full(fd, -1, np.int32))
        elif k == 2:
            # label and taint churn: the churned nodes' columns flipped
            idx = np.unique(rng.randint(0, n, 24))
            d = scan.StaticsDelta(*(
                getattr(pair.statics, name).index_select(
                    0 if name == "label_prio" else 1,
                    torch.as_tensor(idx, device="cuda")).cpu().numpy()
                for name in scan.StaticsDelta._fields))
            d = d._replace(taint_ok=~d.taint_ok, selector_ok=~d.selector_ok,
                           intolerable=d.intolerable + 1)
            for statics, _ in sides:
                scan.apply_statics_delta_(statics, idx, d)
        elif k == 3:
            saved["carry"] = _clone(pair.carry)
        elif k == 4:
            # roll bucket 3 back: the rows it bound, rr and the locks
            before = saved["carry"]
            bound = np.nonzero((pair.carry.pod_count != before.pod_count)
                               .cpu().numpy())[0]
            rows = _host_rows(before, bound)
            zero = np.zeros(8, np.int64)
            for _, carry in sides:
                scan.overlay_restore_(carry, bound, rows, zero, zero,
                                      np.zeros(8, np.int32),
                                      before.sa_lock.cpu().numpy(),
                                      before.rr.cpu().numpy())
            for name, a, b in zip(scan.Carry._fields, pair.carry, before):
                assert torch.equal(a, b), name

    pair.run_all(xs, between)
    assert pair.kinds["many"] > 0 and pair.kinds["refused"] > 0


def _stream(monkeypatch, fused, **kw):
    """run_stream_simulation on the card, with the placements of every
    overlay answer hashed, and the buckets it ran fused."""
    before = scan.fused_buckets()
    answers = []
    query = StreamSession.overlay_query

    def recorded(self, pods, *a, **k):
        got = query(self, pods, *a, **k)
        answers.append(None if got is None else placement_hash(got))
        return got

    with monkeypatch.context() as m:
        if not fused:
            torch_step_only(m)
        m.setattr(StreamSession, "overlay_query", recorded)
        out = run_stream_simulation(device="cuda", **kw)
    return out, answers, scan.fused_buckets() - before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sequential", "pipelined", "whatif"])
def test_twin_on_both_steps(monkeypatch, mode):
    need_card()
    kw = dict(num_nodes=500, arrivals=64, cycles=10, seed=31,
              evict_fraction=0.25, node_flap_every=4,
              pipeline=mode == "pipelined")
    if mode == "whatif":
        kw.update(whatif_every=1, whatif_pods=12)
    fused, fused_answers, n_fused = _stream(monkeypatch, True, **kw)
    plain, plain_answers, n_plain = _stream(monkeypatch, False, **kw)
    assert n_fused > 0 and n_plain == 0
    for key in ("placement_chain", "fold_chain", "paths", "restages"):
        assert fused[key] == plain[key], key
    assert fused_answers == plain_answers
    if mode == "whatif":
        assert fused["overlay"]["answered"] > 0
        assert sum(a is not None for a in fused_answers) == \
            fused["overlay"]["answered"]
