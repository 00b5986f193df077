"""The port's what-if and serve fleet on the card against the same runs on
the CPU, placement for placement and FitError text for text (tolerance 0):
the fast loop (the CUDA kernel) and the batched scan (its steps replayed as
CUDA graphs) on group-free, inter-pod and policy scenarios, and a warm serve
pass that builds no program.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_whatif_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch import workloads as W
from tpusim_torch.backends import placement_hash
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
from tpusim_torch.whatif import compile_count, run_what_if

CASES = {
    "group_free": (lambda: [W.random_workload(0, 200, 50, num_scalars=1,
                                              infeasible=True),
                            W.random_workload(1, 150, 40, infeasible=True)],
                   None),
    "interpod": (lambda: [W.random_interpod_workload(30, 200, 45),
                          W.random_interpod_workload(31, 150, 45,
                                                     services=True)], None),
    "policy": (lambda: [W.random_policy_workload(40, 200, 50),
                        W.random_policy_workload(41, 150, 50)],
               W.COMPAT_POLICIES["1.2"]),
}


def key(results):
    return [[(p.pod.name, p.node_name, p.message) for p in r.placements]
            for r in results]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_what_if_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    build, policy = CASES[name]
    runs = {}
    for device in ("cpu", "cuda"):
        for route in ("kernel", "scan"):
            runs[device, route] = key(run_what_if(
                build(), policy=policy and decode_policy(policy),
                device=device, route=route))
    want = runs["cpu", "scan"]
    assert all(got == want for got in runs.values())
    placed = sum(1 for r in want for _, node, _ in r if node)
    assert 0 < placed < sum(len(r) for r in want)


@pytest.mark.cuda
def test_cuda_warm_serve_pass_builds_no_program():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    snapshot, pool = W.build_workload(300, 40, seed=4242)
    sizes = [150, 200, 260, 300, 170]

    def load():
        return [WhatIfRequest(pods=pool[:n], snapshot_ref="base",
                              cache_key=f"k{i}-{n}")
                for i, n in enumerate(sizes)]

    hashes = {}
    for device in ("cpu", "cuda"):
        fleet = ScenarioFleet(bucket_size=4, flush_after_s=60.0,
                              device=device)
        fleet.register_snapshot("base", snapshot)
        cold = fleet.run(load())
        before = compile_count()
        warm = fleet.run(load())
        assert compile_count() == before
        assert all(r.ok for r in cold + warm)
        assert all(r.compile_cache_hit for r in warm)
        hashes[device] = [placement_hash(r.result.placements)
                          for r in cold + warm]
    assert hashes["cuda"] == hashes["cpu"]
