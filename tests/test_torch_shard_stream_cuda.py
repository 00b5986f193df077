"""The node-sharded streaming twin on the card: k = 2 and 4 ranks, each a
process on the one card under a gloo group, against the single-device
twin on the CPU (tolerance 0: placement and fold chains, paths, restages,
commits, load counts, the checkpoint's layout and WAL bytes).

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_shard_stream_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch import sharding
from tpusim_torch.simulator import run_stream_simulation
import torch_shard_stream_workers as SW

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = str(tmp_path_factory.mktemp("shard-stream-cuda"))
    return sharding.run_ranks_each(SW.cuda_stream_rank, SHARDS,
                                   args=(root,), timeout=600)


@pytest.mark.cuda
@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", SW.CUDA_FEEDS)
def test_cuda_sharded_chains(ranks, name, k):
    want = SW.single(name)
    for got in (r["chains"][name] for r in ranks[k]):
        spans = got.pop("spans")
        assert got == want
        assert set(spans) == {"shard:stage", "shard:scan"}


@pytest.mark.cuda
@pytest.mark.parametrize("k", SHARDS)
def test_cuda_sharded_checkpoint(ranks, k, tmp_path):
    out = run_stream_simulation(device="cpu", **SW.CHECKPOINTED,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=SW.CHECKPOINT_EVERY)
    wal = SW._wal(str(tmp_path))
    n = SW.CHECKPOINTED["num_nodes"]
    for r in ranks[k]:
        got = r["checkpointed"]
        assert got["fold_chain"] == out["fold_chain"]
        assert got["wal"] == wal
        assert got["manifest"]["shard_layout"] == {
            "shards": k, "nodes": n, "nodes_per_shard": -(-n // k)}
        assert got["manifest"]["device_bound"] == \
            got["manifest"]["bound_pods"]
