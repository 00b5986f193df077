"""The CUDA kernel's thread-block cluster against the kernel's plain PyTorch
version, bit for bit (tolerance 0), at forced cluster sizes of 2, 4 and 16
CTAs, on workloads.cluster_hazard_cases: every instantiation, ties across
slabs, round-robin picks in the last CTA, slabs of pad nodes only, CTAs
with no feasible node beside CTAs with some, the reason histogram (in
count mode too), binds that another CTA's next inter-pod phase or
ServiceAffinity lock reads, and plans too narrow for 16 CTAs; and one CTA
on 10,000 nodes, whose scratch does not fit its shared memory.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cluster_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch.backend import build_plan
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.fastplan import init_carry
from tpusim_torch.fastscan import DevicePlan, carry_tensors, pd_tensor, pod_matrix
from tpusim_torch.kernels.fastscan import (
    _variant,
    fastscan_chunk,
    fastscan_chunk_plain,
    launch_geometry,
)
from tpusim_torch.policyc import compile_policy
from tpusim_torch.state import NUM_FIXED_BITS
from tpusim_torch.workloads import (
    cluster_hazard_cases,
    interpod_workload,
    random_workload,
)

CLUSTERS = (2, 4, 16)


def hazard_plan(name):
    build, policy, most_requested, hard_weight, variant = \
        cluster_hazard_cases()[name]
    snapshot, pods = build()
    cp = compile_policy(decode_policy(policy)) if policy else None
    plan = build_plan(snapshot, pods, most_requested, hard_weight, cp)[0]
    return plan, variant


def run_chunk(plan, device, cluster=None):
    """The plan's first chunk from its initial state: outputs, carry, misc
    and presence_dom, on the CPU."""
    d = torch.device(device)
    dp = DevicePlan(plan, d)
    init = init_carry(plan)
    carry, misc = carry_tensors(init, d)
    pd = pd_tensor(init, d)
    k = min(plan.num_pods, 512)
    pods = torch.from_numpy(pod_matrix(plan, 0, k, k)).to(d)
    args = (pods, dp.statics, dp.tables, carry, misc, dp.alloc_scalar,
            plan.num_scalars, NUM_FIXED_BITS + plan.num_scalars,
            plan.most_requested, dp.groups, dp.ip, pd, dp.pol)
    res = (fastscan_chunk_plain(*args) if d.type == "cpu"
           else fastscan_chunk(*args, cluster=cluster))
    return [t.cpu() for t in (*res, carry, misc)
            + ((pd,) if pd is not None else ())]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(cluster_hazard_cases()))
def test_cluster_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plan, variant = hazard_plan(name)
    dp = DevicePlan(plan, "cpu")
    assert _variant(dp.groups, dp.ip, dp.pol) == variant
    npad = plan.alloc_cpu.shape[1]
    want = run_chunk(plan, "cpu")
    assert int((want[0] >= 0).sum()) > 0
    for cluster in CLUSTERS:
        if cluster > npad // 32:
            # too narrow a plan for this cluster: refused, never shrunk
            with pytest.raises(ValueError):
                run_chunk(plan, "cuda", cluster)
            continue
        got = run_chunk(plan, "cuda", cluster)
        geom = fastscan_chunk.last_geometry
        assert geom.cluster == cluster
        for a, b in zip(want, got):
            assert torch.equal(a, b), (name, cluster)
        # the picks reach the last CTA that holds a real node
        last = max(lo for lo, _ in geom.slabs if lo < plan.num_nodes)
        assert int((got[0] >= last).sum()) > 0, (name, cluster)
    # the default geometry is the widest cluster the plan allows
    run_chunk(plan, "cuda")
    assert fastscan_chunk.last_geometry.cluster == \
        launch_geometry(npad).cluster


# one CTA on a slab too wide for its scratch in shared memory
WIDE = {"group_free": lambda: random_workload(11, 64, 10_000, infeasible=True),
        "interpod": lambda: interpod_workload(64, 10_000)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE))
def test_cluster_kernel_scratch_in_device_memory(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plan = build_plan(*WIDE[name]())[0]
    want = run_chunk(plan, "cpu")
    got = run_chunk(plan, "cuda", 1)
    assert not fastscan_chunk.last_geometry.scratch_in_smem
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert int((got[0] >= 0).sum()) > 0
