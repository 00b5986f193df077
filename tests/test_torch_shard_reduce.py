"""The port's sharded reductions at k = 2 and 4 gloo ranks on the CPU: the
analytics plane's reduction over node-sharded columns
(scan.analytics_reduce_sharded, wired through obs.analytics on the
backend's TPUSIM_SHARDS route) and the gang driver's member lanes
(scan.gang_lanes_sharded, wired through gang.driver), against their
single-device results.

Each k runs every case in one spawn of k ranks
(tests/torch_shard_workers.reduce_rank); the parametrised tests read the
gathered results. An analytics sample from the sharded backend equals the
single-device sample and host_reduce on the whole columns, every rank; a
direct reduction of random columns equals analytics_reduce and the numpy
host_reduce at several k; the sharded lanes equal gang_lanes on the whole
columns; a gang feed through run_simulation on the scan route gives the
single-device split and the JAX package's, with the shard:gang_lanes span
recorded. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from tpusim.simulator import run_simulation as jax_run

import tpusim.api.snapshot as jax_api
import tpusim_torch.api.snapshot as port_api
from tpusim.gang import group as jgroup
from tpusim_torch import scan, sharding
from tpusim_torch.gang import group as pgroup
from tpusim_torch.obs.analytics import host_reduce
from tpusim_torch.simulator import run_simulation
import torch_shard_workers as SW

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    """k -> the k ranks' results (one spawn each, both at once)."""
    return sharding.run_ranks_each(SW.reduce_rank, SHARDS, timeout=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-device analytics samples (no TPUSIM_SHARDS)."""
    import os

    saved = os.environ.pop("TPUSIM_SHARDS", None)
    try:
        return {k: SW.backend_case("groups", analytics_k=k) for k in (1, 4)}
    finally:
        if saved is not None:
            os.environ["TPUSIM_SHARDS"] = saved


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("top_k", [1, 4])
def test_sharded_analytics_sample(ranks, single, top_k, k):
    want = single[top_k]
    assert want["sample"] is not None and want["problems"] == []
    for got in (r["analytics"][top_k] for r in ranks[k]):
        assert got["sample"] == want["sample"]
        assert got["problems"] == []
        assert got["hash"] == want["hash"]
        assert got["spans"] == ["shard:scan", "shard:stage",
                                "shard:topk_collective"]


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("top_k", [1, 3, SW.NODES - 2])
def test_sharded_reduce_of_random_columns(ranks, top_k, k):
    n_valid = SW.NODES - 2
    cols = ranks[k][0]["direct"][2]
    inp = scan.AnalyticsIn(*(torch.tensor(c) for c in cols))
    want = scan.analytics_reduce(inp, n_valid, top_k)
    host = host_reduce(inp, n_valid, top_k)
    for r in ranks[k]:
        got = r["direct"][3][top_k]
        for name, g, w in zip(scan.AnalyticsStats._fields, got, want):
            assert g.dtype == w.numpy().dtype, name
            assert np.array_equal(g, w.numpy()), name
            assert np.array_equal(g, host[name]), name


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_gang_lanes(ranks, k):
    config, carry, statics, xs = SW.host_inputs("groups")
    members = scan.PodX(*(col[:5] for col in scan.tree_to(xs, "cpu",
                                                          index=True)))
    feasible, score = scan.gang_lanes(
        config, scan.tree_to(carry, "cpu"),
        scan.tree_to(statics, "cpu", index=True), members)
    for r in ranks[k]:
        got_f, got_s = r["direct"][0], r["direct"][1]
        n_pad = -(-SW.NODES // k) * k
        assert got_f.shape == (5, n_pad)
        assert not got_f[:, SW.NODES:].any()
        assert np.array_equal(got_f[:, :SW.NODES], feasible.numpy())
        assert np.array_equal(got_s[:, :SW.NODES], score.numpy())
    assert feasible.any() and not feasible.all()


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", sorted(SW.GANG_FEEDS))
def test_sharded_gang_decision(ranks, name, k, monkeypatch):
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    pods, snap = SW.GANG_FEEDS[name](port_api, pgroup)
    status = run_simulation(pods, snap, backend="torch", device="cpu",
                            route="scan")
    want = ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods])
    jpods, jsnap = SW.GANG_FEEDS[name](jax_api, jgroup)
    jstatus = jax_run(jpods, jsnap, backend="jax")
    assert want == ([(p.name, p.spec.node_name)
                     for p in jstatus.successful_pods],
                    [(p.name, p.status.conditions[-1].message)
                     for p in jstatus.failed_pods])
    for r in ranks[k]:
        placed, failed, lanes_spans = r["gang"][name]
        assert (placed, failed) == want
        assert lanes_spans >= 1
