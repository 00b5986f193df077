"""The port's scenario mesh on the CPU, at k = 2 and 4 gloo ranks: what-if
(whatif.run_what_if's mesh on both kinds, run_what_if_multihost), the
preemption hybrid on a node mesh and the scenario fleet on a scenario mesh,
against the single-device runs of the port and of the JAX package.

Each k runs every case in one spawn of k ranks (tests/torch_mesh_workers
.scenario_mesh_rank); a module-scoped fixture gathers the ranks' results
and the parametrised tests read them. Every rank returns every scenario's
placements, FitError text and counts, and they equal both packages'
single-device runs; so do the hybrid's placements, failures and preempted
pods, and the fleet's placement hashes, with a warm pass that builds no
program on any rank and a rank whose clock runs ahead that still
dispatches rank 0's buckets; a bucket that raises on one rank after rank
0 sent it fails on rank 0 and leaves no rank waiting. Ranks that disagree
on the inputs raise, and so does every request a mesh cannot serve. Tolerance: exact (integer
outputs and texts equal).
"""

import re
from types import SimpleNamespace

import pytest
import torch

from tpusim.jaxe.preempt import run_with_preemption as jax_run_with_preemption
from tpusim.jaxe.whatif import run_what_if as jax_run_what_if

from tpusim_torch import sharding
from tpusim_torch.serve import ScenarioFleet, ServeExecutor
from tpusim_torch.whatif import _unify_batch, run_what_if, \
    run_what_if_multihost
import torch_mesh_workers as MW

WORLDS = (2, 4)
LAYOUTS = [(k, MW.mesh_name(*layout)) for k in WORLDS
           for layout in MW.MESHES[k]]
CASES = sorted(MW.WHATIF_CASES)


@pytest.fixture(scope="module")
def ranks():
    """k -> the k ranks' results (one spawn each, both at once)."""
    return sharding.run_ranks_each(MW.scenario_mesh_rank, WORLDS,
                                   timeout=300)


@pytest.fixture(scope="module")
def singles():
    """Each case's single-device results: (the port's, the JAX
    package's)."""
    out = {}
    for name, (build, policy) in MW.WHATIF_CASES.items():
        out[name] = (MW.single_what_if(name), MW.results_key(
            jax_run_what_if(build("jax"), policy=MW.policy_of(policy,
                                                              "jax"))))
    return out


@pytest.mark.parametrize("k,layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_what_if_mesh_is_the_single_device_run(ranks, singles, name, k,
                                               layout):
    port, jax = singles[name]
    assert port == jax
    for got in ranks[k]:
        assert got["whatif"][(name, layout)] == port
    assert all(r[1] for r in port)


def test_cases_reach_fit_errors(singles):
    """Some pod of the cases fails, so the FitError text is compared."""
    assert any(r[2] for name in CASES for r in singles[name][0])


@pytest.mark.parametrize("k,layout", LAYOUTS)
def test_what_if_mesh_builds_one_program_a_call(ranks, k, layout):
    """Each call builds one program for its block, counted under
    "scenario_sharded"; only a node axis of several ranks issues node
    all_reduces from the step."""
    for got in ranks[k]:
        assert got["built"][layout] == {"batched": 0,
                                        "scenario_sharded": len(CASES)}
        node_ranks = int(layout.split("x")[1])
        if layout.startswith("snap") and node_ranks > 1:
            assert got["collectives"][layout] > 0
        else:
            assert got["collectives"][layout] == 0


def test_multihost_form(ranks, singles):
    """run_what_if_multihost at 4 ranks, 2 a machine: a 2 x 2 snap mesh."""
    port, jax = singles["groups"]
    for got in ranks[4]:
        assert got["multihost"] == port == jax


@pytest.fixture(scope="module")
def hybrid_singles():
    snap, pods = MW.hybrid_feed("jax")
    return (MW.single_hybrid(),
            MW.status_sig(jax_run_with_preemption(pods, snap)))


def test_hybrid_on_a_node_mesh(ranks, hybrid_singles):
    port, jax = hybrid_singles
    assert port == jax
    assert port["preempted"] and port["failed"]
    for got in ranks[2]:
        sig, counts = got["hybrid"][0]
        assert sig == port
        assert counts["route_scan"] >= 1 and counts["route_kernel"] == 0
        assert counts["rearms"] >= 1


@pytest.fixture(scope="module")
def serve_hashes():
    port = MW.serve_hashes("port")
    assert port == MW.serve_hashes("jax")
    return port


@pytest.mark.parametrize("k", WORLDS)
def test_serve_mesh_matches_single_device(ranks, serve_hashes, k):
    serve = ranks[k][0]["serve"]
    assert [r[4] for r in serve["cold"]] == serve_hashes
    assert [r[:3] for r in serve["cold"]] == [(True, 3, 5)] * 3
    assert [r[3] for r in serve["warm"]] == [True] * 3
    assert [r[4] for r in serve["warm"]] == serve_hashes
    for got in ranks[k]:
        serve = got["serve"]
        assert "does not divide" in serve["refused"]
        assert serve["cold_built"] == 1
        # the warm pass builds nothing, on any rank
        assert serve["warm_built"] == 0
        assert serve["dispatches"] == 2
    for got in ranks[k][1:]:
        assert got["serve"]["cold"] == got["serve"]["warm"] == []


@pytest.mark.parametrize("k", WORLDS)
def test_serve_mesh_ignores_the_other_ranks_clocks(ranks, k):
    """Rank 0's buckets (a full one and a partial one) are what every rank
    dispatches, whatever the other ranks' clocks say."""
    want = MW.serve_hashes("port", MW.skewed_seeds(k))
    first = ranks[k][0]["skewed"]
    assert [r[4] for r in first["responses"]] == want
    assert [r[1:3] for r in first["responses"]] == \
        [(k, 0)] * k + [(1, k - 1)]
    for got in ranks[k]:
        assert got["skewed"]["dispatches"] == 2


@pytest.mark.parametrize("k", WORLDS)
def test_serve_mesh_bucket_failing_after_the_send(ranks, k):
    """A bucket whose build raises on rank 0 after rank 0 sent it, or on
    rank 1, fails on rank 0 with that error and leaves no rank waiting: the
    next bucket runs on every rank, and rank 1 raises its own error."""
    want = MW.serve_hashes("port", MW.faulted_seeds(k)[k:])
    first = ranks[k][0]["faulted"]
    for failing_rank, error in (
            (0, "RuntimeError: injected build failure on rank 0"),
            (1, r"PeerDispatchError: serve mesh: rank\(s\) \[1\] failed")):
        responses = first[failing_rank]
        assert [r[0] for r in responses] == [False] * k + [True] * k
        assert all(re.match(error, r[4]) for r in responses[:k])
        assert [r[4] for r in responses[k:]] == want
    assert ranks[k][1]["faulted"][1] == \
        "injected build failure on rank 1"
    for rank, got in enumerate(ranks[k]):
        if rank > 0:
            assert got["faulted"][0] == []
        if rank > 1:
            assert got["faulted"][1] == []
        assert got["faulted"]["dispatches"] == 4


@pytest.mark.parametrize("k", WORLDS)
def test_ranks_that_disagree_raise(ranks, k):
    for got in ranks[k]:
        assert got["disagree"] is not None
        assert "host pictures differ" in got["disagree"]


REFUSALS = {
    "whatif_kernel": "route='kernel' cannot run on a what-if mesh",
    "hybrid_kernel": "route='kernel' cannot run on a preemption mesh",
    "hybrid_scenario_mesh": r"pass a \('snap', 'node'\) mesh",
    "serve_snap_mesh": r"ServeExecutor shards over scenarios: pass a "
                       r"\('scenario', 'node'\) mesh",
    "far_rank": r"spans 1 rank\(s\) not in this process's default group",
}


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_mesh_refusals(ranks, name, k):
    for got in ranks[k]:
        assert got["refusals"][name] is not None
        assert re.search(REFUSALS[name], got["refusals"][name])


@pytest.mark.parametrize("k", WORLDS)
def test_vmapped_all_reduce_is_one_collective(ranks, k):
    """A vmapped reduction over a batch of 3 issues one all_reduce (the
    operator's batching rule), and gives each row's sum or maximum across
    the ranks."""
    x = torch.arange(24, dtype=torch.int64).reshape(3, 4, 2).sum(2)
    shift = [200 * r for r in range(k)]
    want_sum = (k * x + sum(shift)).tolist()
    want_max = (x + max(shift)).tolist()
    for got in ranks[k]:
        assert got["vmapped"]["sum"] == (want_sum, 1)
        assert got["vmapped"]["max"] == (want_max, 1)
        assert got["vmapped"]["plain"] == 1


# ---- without a group: the refusals that need no ranks ---------------------


def test_unknown_mesh_axes_rejected():
    bogus = SimpleNamespace(mesh_dim_names=("model", "data"),
                            mesh=torch.tensor([[0]]))
    build, _ = MW.WHATIF_CASES["provider"]
    with pytest.raises(ValueError, match=r"axes \('model', 'data'\)"):
        run_what_if(build("port"), mesh=bogus, device="cpu")


@pytest.mark.parametrize("call", ["what_if", "serve", "executor",
                                  "multihost"])
def test_a_mesh_needs_a_process_group(call):
    mesh = SimpleNamespace(mesh_dim_names=("scenario", "node"),
                           mesh=torch.tensor([[0], [1]]))
    build, _ = MW.WHATIF_CASES["provider"]
    with pytest.raises(ValueError, match="process group"):
        if call == "what_if":
            run_what_if(build("port"), mesh=mesh, device="cpu")
        elif call == "serve":
            ScenarioFleet(bucket_size=2, mesh=mesh, device="cpu")
        elif call == "executor":
            ServeExecutor(mesh=mesh, device="cpu")
        else:
            run_what_if_multihost(build("port"), device="cpu")


def test_unify_batch_pads_to_the_shard_multiples():
    """3 scenarios on 2 rows pad one replica of the first; the node axis
    pads to the node-shard multiple past the largest scenario's 24."""
    from tpusim_torch.whatif import _prepare_host_batch

    build, _ = MW.WHATIF_CASES["provider"]
    _, staged = _prepare_host_batch(build("port"), "DefaultProvider", 10,
                                    None)
    trees = [(s.statics, s.carry, s.xs) for s in staged]
    per = _unify_batch(trees, 2, 5)
    assert len(per) == 4 and per[3] is per[0]
    assert {p[1].alloc_cpu.shape[0] for p in per} == {25}
    assert len(_unify_batch(trees)) == 3
