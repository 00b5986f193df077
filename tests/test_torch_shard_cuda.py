"""The node-sharded route on the card: k = 2 and 4 ranks, each a process
on the one card under a gloo group (NCCL takes one card a rank), against
the single-device scan on the card and on the CPU (tolerance 0: choices,
counts, advanced, the final carry put back together from the ranks'
blocks, placement hashes, analytics samples and gang splits are exact).

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_shard_cuda.py

Without a card every case skips.
"""

import os

import numpy as np
import pytest
import torch

from tpusim_torch import sharding
from tpusim_torch.backend import TorchBackend, placement_hash
import torch_shard_workers as SW

SHARDS = (2, 4)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def ranks():
    need_card()
    return sharding.run_ranks_each(SW.cuda_rank, SHARDS, timeout=600)


def assert_equal(got, want):
    (gc, *gout), (wc, *wout) = got, want
    for g, w in zip(gout, wout):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for name in wc:
        assert np.array_equal(gc[name], wc[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", SW.CUDA_CASES)
def test_cuda_sharded_scan(ranks, name, k):
    got = SW.gathered([r["scan"][name] for r in ranks[k]])
    assert_equal(got, SW.single_scan(name, "cuda"))
    assert_equal(got, SW.single_scan(name, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", SHARDS)
def test_cuda_sharded_chunked_scan(ranks, k):
    got = SW.gathered([r["chunked"] for r in ranks[k]])
    assert_equal(got, SW.single_scan("provider", "cpu", chunk=20))


@pytest.mark.cuda
@pytest.mark.parametrize("k", SHARDS)
def test_cuda_sharded_backend_analytics_gang(ranks, k, monkeypatch):
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    import tpusim_torch.api.snapshot as api

    build, _ = SW.scan_cases()["provider"]
    snap, pods = build(api)
    want = placement_hash(TorchBackend(route="scan", device="cuda")
                          .schedule(pods, snap))
    sample = SW.backend_case("groups", device="cuda", analytics_k=4)
    gang = SW.gang_split("rank_aware", device="cpu")
    for r in ranks[k]:
        assert r["backend"]["hash"] == want
        assert r["backend"]["shard_count"] == k
        assert r["analytics"]["sample"] == sample["sample"]
        assert r["analytics"]["problems"] == []
        assert r["gang"][:2] == gang[:2] and r["gang"][2] >= 1
    assert "TPUSIM_SHARDS" not in os.environ
