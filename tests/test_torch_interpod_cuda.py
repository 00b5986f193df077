"""The CUDA kernel's inter-pod instantiation (Variant 3) against its plain
PyTorch version, bit for bit (tolerance 0), on the port's own plans.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_interpod_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch.config import config_for
from tpusim_torch.fastplan import init_carry, plan_fast
from tpusim_torch.fastscan import DevicePlan, carry_tensors, pd_tensor, pod_matrix
from tpusim_torch.kernels.fastscan import fastscan_chunk, fastscan_chunk_plain
from tpusim_torch.state import NUM_FIXED_BITS, compile_cluster
from tpusim_torch.workloads import interpod_workload, random_interpod_workload

BUILDS = {
    "plain": lambda: random_interpod_workload(0, 150, 30),
    "services_ports": lambda: random_interpod_workload(
        3, 150, 30, services=True, ports=True),
    "hostname_63_nodes": lambda: random_interpod_workload(4, 100, 63),
    "interpod_workload": lambda: interpod_workload(2_000, 500),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,most_requested,hard_weight", [
    ("plain", False, 10), ("services_ports", True, 1),
    ("hostname_63_nodes", False, 100), ("interpod_workload", True, 10)])
def test_cuda_interpod_kernel_matches_plain(name, most_requested,
                                            hard_weight):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    compiled, cols = compile_cluster(*BUILDS[name]())
    plan, why = plan_fast(config_for(compiled, most_requested, hard_weight),
                          compiled, cols)
    assert plan is not None and plan.has_interpod, why
    k = min(plan.num_pods, 512)
    num_bits = NUM_FIXED_BITS + plan.num_scalars
    outs = {}
    for dev in ("cpu", "cuda"):
        d = torch.device(dev)
        dp = DevicePlan(plan, d)
        init = init_carry(plan)
        carry, misc = carry_tensors(init, d)
        pd = pd_tensor(init, d)
        pods = torch.from_numpy(pod_matrix(plan, 0, k, k)).to(d)
        run = fastscan_chunk_plain if dev == "cpu" else fastscan_chunk
        res = run(pods, dp.statics, dp.tables, carry, misc, dp.alloc_scalar,
                  plan.num_scalars, num_bits, most_requested, dp.groups,
                  dp.ip, pd)
        outs[dev] = [t.cpu() for t in (*res, carry, misc, pd)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)
    placed = int((outs["cuda"][0] >= 0).sum())
    assert placed > 0
