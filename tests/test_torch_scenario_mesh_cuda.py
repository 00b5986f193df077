"""The scenario mesh on the card: k = 2 and 4 ranks, each a process on the
one card under a gloo group (NCCL takes one card a rank), running what
tests/test_torch_scenario_mesh.py runs on the CPU (what-if on both mesh
kinds and the multihost form, the hybrid on a node mesh, the fleet on a
scenario mesh), against the single-device runs on the CPU and on the card.
Tolerance: exact (placements, FitError texts, counts and hashes equal).

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_scenario_mesh_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch import sharding
import torch_mesh_workers as MW

WORLDS = (2, 4)
LAYOUTS = [(k, MW.mesh_name(*layout)) for k in WORLDS
           for layout in MW.MESHES[k]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def ranks():
    need_card()
    return sharding.run_ranks_each(MW.scenario_mesh_rank, WORLDS, ("cuda",),
                                   timeout=600)


@pytest.mark.cuda
@pytest.mark.parametrize("k,layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(MW.WHATIF_CASES))
def test_cuda_what_if_mesh(ranks, name, k, layout):
    want = MW.single_what_if(name, "cpu")
    assert MW.single_what_if(name, "cuda") == want
    for got in ranks[k]:
        assert got["whatif"][(name, layout)] == want


@pytest.mark.cuda
def test_cuda_multihost_form(ranks):
    for got in ranks[4]:
        assert got["multihost"] == MW.single_what_if("groups", "cpu")


@pytest.mark.cuda
def test_cuda_hybrid_on_a_node_mesh(ranks):
    want = MW.single_hybrid(device="cpu")
    assert MW.single_hybrid(device="cuda") == want
    for got in ranks[2]:
        assert got["hybrid"][0][0] == want


@pytest.mark.cuda
@pytest.mark.parametrize("k", WORLDS)
def test_cuda_serve_mesh(ranks, k):
    want = MW.serve_hashes("port")
    serve = ranks[k][0]["serve"]
    assert [r[4] for r in serve["cold"]] == want
    assert [r[4] for r in serve["warm"]] == want
    assert all(r[3] for r in serve["warm"])
    assert [r[4] for r in ranks[k][0]["skewed"]["responses"]] == \
        MW.serve_hashes("port", MW.skewed_seeds(k))
    for got in ranks[k]:
        assert got["serve"]["warm_built"] == 0
        assert got["skewed"]["dispatches"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", WORLDS)
def test_cuda_ranks_that_disagree_raise(ranks, k):
    for got in ranks[k]:
        assert "host pictures differ" in got["disagree"]
