"""The CUDA kernel's policy instantiations (Variant 5) against their plain
PyTorch version, bit for bit (tolerance 0), on the port's own plans: random
policies over random group and inter-pod workloads, and the policy workload
under the upstream 1.2 policy.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_policy_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch.backend import build_plan
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.fastplan import init_carry
from tpusim_torch.fastscan import DevicePlan, carry_tensors, pd_tensor, pod_matrix
from tpusim_torch.kernels.fastscan import fastscan_chunk, fastscan_chunk_plain
from tpusim_torch.policyc import compile_policy
from tpusim_torch.state import NUM_FIXED_BITS
from tpusim_torch.workloads import (
    COMPAT_POLICIES,
    policy_workload,
    random_policy,
    random_policy_workload,
)

CASES = {
    "count_noexec_alias": (
        lambda: random_policy_workload(40, 300, 80),
        random_policy(40, count_mode=True, noexec=True, ports_alias=True)),
    "two_sa_no_ebs": (lambda: random_policy_workload(41, 300, 80),
                      random_policy(41, sa_entries=2, maxpd_off=(0,))),
    "parts_count_mode": (lambda: random_policy_workload(42, 300, 80),
                         random_policy(42, general=False, count_mode=True)),
    "interpod_1.9": (lambda: random_policy_workload(45, 300, 60,
                                                    interpod=True),
                     COMPAT_POLICIES["1.9"]),
    "policy_workload": (lambda: policy_workload(2_000, 500),
                        COMPAT_POLICIES["1.2"]),
}


def policy_plan(build, policy):
    """The port's plan of a workload under a policy, as TorchBackend
    builds it."""
    snapshot, pods = build()
    plan, _ = build_plan(snapshot, pods,
                         compiled_policy=compile_policy(decode_policy(policy)))
    assert plan.policy is not None
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_policy_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plan = policy_plan(*CASES[name])
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
                  plan.num_scalars, num_bits, False, dp.groups, dp.ip, pd,
                  dp.pol)
        outs[dev] = [t.cpu() for t in (*res, carry, misc)
                     + ((pd,) if pd is not None else ())]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)
    assert int((outs["cuda"][0] >= 0).sum()) > 0
