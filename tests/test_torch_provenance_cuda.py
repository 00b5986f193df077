"""The explain lanes and the analytics reduction on the card, against the
same calls on the CPU: the scan's top-k rows (indices, scores and score
parts; ties listed lower node index first) eagerly and replayed from CUDA
graphs, analytics_reduce over random and tied columns, and the records and
samples of TorchBackend and a stream with a provenance log and the
analytics plane installed. Tolerance: exact (integers).

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_provenance_cuda.py

Without a card every case skips.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import tpusim_torch.api.snapshot as api
from tpusim_torch import workloads as W
from tpusim_torch.backend import TorchBackend, compile_inputs
from tpusim_torch.obs import analytics, provenance
from tpusim_torch.scan import (
    GRAPH_STEPS,
    AnalyticsIn,
    analytics_reduce,
    scan_inputs,
    schedule_scan,
)
from tpusim_torch.simulator import run_stream_simulation

CPU = torch.device("cpu")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _clean_logs():
    yield
    provenance.uninstall()
    analytics.uninstall()


def tie_build():
    snapshot = api.synthetic_cluster(16, milli_cpu=4000, memory=8 * 1024**3)
    pods = [api.make_pod(f"tie-{i}", milli_cpu=500, memory=256 * 1024**2)
            for i in range(48)]
    return snapshot, pods


BUILDS = {
    "ties": tie_build,
    "config3": lambda: W.build_workload(512, 300, seed=5),
    "policy": lambda: W.policy_workload(256, 60),
    "interpod": lambda: W.interpod_workload(256, 40),
}


def lanes_on(device, build, k, graph_steps):
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.policyc import compile_policy

    snapshot, pods = build()
    cp = None
    if build is BUILDS["policy"]:
        cp = compile_policy(decode_policy(W.COMPAT_POLICIES["1.2"]))
    config, compiled, cols, ptabs = compile_inputs(snapshot, pods,
                                                   compiled_policy=cp)
    config = replace(config, explain_k=k)
    carry, statics, xs = scan_inputs(config, compiled, cols, ptabs, device)
    out = schedule_scan(config, carry, statics, xs, graph_steps=graph_steps)
    return [t.cpu().numpy() for t in out[1:4]] + [
        t.cpu().numpy() for t in out[4]]


@pytest.mark.cuda
@pytest.mark.parametrize("graph_steps", [0, GRAPH_STEPS])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_cuda_explain_lanes_match_cpu(name, graph_steps):
    need_card()
    k = 3
    want = lanes_on(CPU, BUILDS[name], k, 0)
    got = lanes_on(torch.device("cuda"), BUILDS[name], k, graph_steps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    idx, scores, parts = got[3:]
    assert idx.shape[1] == k
    real = scores > -(1 << 61)
    assert np.array_equal(parts.sum(axis=-1)[real], scores[real])
    if name == "ties":
        # every node scores the same at the first pod: nodes 0, 1, 2
        assert idx[0].tolist() == [0, 1, 2]


def reduce_cols(rng, n, ties):
    if ties:
        same = np.full(n, 4000, np.int64)
        return dict(alloc_cpu=same, alloc_mem=same * 2**20,
                    alloc_gpu=np.zeros(n, np.int64), alloc_eph=same,
                    allowed_pods=np.full(n, 110, np.int64),
                    used_cpu=same // 2, used_mem=same * 2**19,
                    used_gpu=np.zeros(n, np.int64), used_eph=same // 4,
                    pod_count=np.full(n, 7, np.int64))
    return {f: rng.integers(0, hi, size=n).astype(np.int64) for f, hi in (
        ("alloc_cpu", 8000), ("alloc_mem", 2**34), ("alloc_gpu", 8),
        ("alloc_eph", 2**30), ("allowed_pods", 110), ("used_cpu", 12000),
        ("used_mem", 2**34), ("used_gpu", 8), ("used_eph", 2**30),
        ("pod_count", 120))}


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_valid,k,ties", [
    (1, 1, 1, False), (16, 9, 8, False), (5000, 5000, 8, False),
    (5000, 4096, 8, False), (8, 0, 3, False), (64, 64, 8, True),
    (64, 40, 8, True)])
def test_cuda_analytics_reduce_matches_cpu_and_numpy(n, n_valid, k, ties):
    need_card()
    cols = reduce_cols(np.random.default_rng(n + k), n, ties)
    k = min(k, n)
    want = analytics_reduce(AnalyticsIn(**{
        f: torch.from_numpy(v) for f, v in cols.items()}), n_valid, k)
    got = analytics_reduce(AnalyticsIn(**{
        f: torch.from_numpy(v).cuda() for f, v in cols.items()}), n_valid, k)
    host = analytics.host_reduce(AnalyticsIn(**cols), n_valid, k)
    for field in host:
        g = getattr(got, field).cpu().numpy()
        assert np.array_equal(g, getattr(want, field).numpy()), field
        assert np.array_equal(g, host[field]), field


def records(device, top_k, route="auto"):
    log = provenance.install(provenance.ProvenanceLog(capacity=1 << 20,
                                                      top_k=top_k))
    snapshot, pods = W.build_workload(600, 200, seed=11)
    TorchBackend(device=device, route=route, fallback="error").schedule(
        pods, snapshot)
    provenance.uninstall()
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in log.tail(1 << 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,route", [(0, "kernel"), (3, "auto")])
def test_cuda_backend_records_match_cpu(top_k, route):
    need_card()
    assert records("cuda", top_k, route) == records("cpu", top_k, route)
    with pytest.raises(NotImplementedError, match="explain lanes"):
        records("cuda", 2, "kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_cuda_stream_analytics_match_cpu(pipeline):
    need_card()
    series = {}
    for device in ("cpu", "cuda"):
        log = analytics.install(analytics.ClusterAnalytics(
            keep_inputs=True, sample_interval_s=0.0))
        out = run_stream_simulation(num_nodes=200, cycles=6, arrivals=32,
                                    evict_fraction=0.25, seed=9,
                                    pipeline=pipeline, device=device)
        assert log.verify_against_host() == []
        assert out["restages"] == {"cold_start": 1}
        series[device] = ([{k: v for k, v in s.items() if k != "ts"}
                           for s in log.series()], out["placement_chain"])
        analytics.uninstall()
    assert series["cuda"] == series["cpu"]
