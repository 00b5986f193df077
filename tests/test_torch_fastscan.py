"""The port's fused-scan chunk (plain PyTorch version on the CPU) against the
JAX package: bit-equal choices, reason counts, advanced flags and final
carry, on plans the JAX package's own plan_fast builds.

The reference results come from the JAX XLA scan (schedule_scan, int64 in
original units: its carry is compared after dividing by the plan's gcds) and,
in one case, from the Pallas fast_scan in interpret mode. A CUDA-marked test
holds the CUDA kernel against the plain version when a card is present.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.jaxe import fastscan as jfs  # noqa: E402
from tpusim.jaxe.kernels import (  # noqa: E402
    carry_init,
    config_for,
    pod_columns_to_device,
    schedule_scan,
    statics_to_device,
)
from tpusim.jaxe.state import NUM_FIXED_BITS, compile_cluster  # noqa: E402

from tpusim_torch.fastplan import init_carry, plan_from_numpy  # noqa: E402
from tpusim_torch.fastscan import DevicePlan, carry_tensors, fast_scan, pod_matrix  # noqa: E402
from tpusim_torch.kernels.fastscan import (  # noqa: E402
    fastscan_chunk,
    fastscan_chunk_plain,
)
from tpusim_torch.workloads import random_workload  # noqa: E402

CARRY_FIELDS = ("used_cpu", "used_mem", "used_gpu", "used_eph",
                "nonzero_cpu", "nonzero_mem", "pod_count")


def jax_case(seed, num_pods, num_nodes, most_requested, num_scalars=0,
             infeasible=False):
    """(JAX FastPlan, XLA-scan final carry, choices, counts, advanced)."""
    snapshot, pods = random_workload(seed, num_pods, num_nodes,
                                     num_scalars=num_scalars,
                                     infeasible=infeasible, api=jax_api)
    compiled, cols = compile_cluster(snapshot, pods)
    assert not compiled.unsupported
    config = config_for([compiled], most_requested=most_requested,
                        num_reason_bits=NUM_FIXED_BITS
                        + len(compiled.scalar_names))
    plan, why = jfs.plan_fast(config, compiled, cols)
    assert plan is not None, why
    assert plan.num_groups == 0 and not plan.has_interpod
    carry, choices, counts, advanced = schedule_scan(
        config, carry_init(compiled), statics_to_device(compiled),
        pod_columns_to_device(cols))
    return (plan, carry, np.asarray(choices), np.asarray(counts),
            np.asarray(advanced))


def assert_carry_matches_xla(plan, carry_out, xla_carry):
    n = plan.num_nodes
    gcds = dict(zip(CARRY_FIELDS, (*plan.gcds, plan.gcds[0], plan.gcds[1], 1)))
    for i, name in enumerate(CARRY_FIELDS):
        want = np.asarray(getattr(xla_carry, name)).astype(np.int64)
        assert np.all(want % gcds[name] == 0)
        got = carry_out.rows[i].cpu().numpy().reshape(-1)
        assert np.array_equal(got[:n], want // gcds[name]), name
        assert not got[n:].any(), f"{name}: pad nodes were bound"
    if plan.num_scalars:
        us = np.asarray(xla_carry.used_scalar).astype(np.int64)
        for si, g in enumerate(plan.scalar_gcds):
            got = carry_out.scal[si].cpu().numpy()
            assert np.array_equal(got[:n], us[:, si] // g)
    assert int(carry_out.misc.reshape(-1)[0]) == int(np.asarray(xla_carry.rr))


@pytest.mark.parametrize("seed,most_requested,num_scalars,infeasible", [
    (0, False, 0, False),
    (1, True, 0, True),
    (2, False, 1, True),
    (3, True, 2, False),
    (4, False, 2, True),
])
def test_plain_chunk_matches_xla_scan(seed, most_requested, num_scalars,
                                      infeasible):
    num_pods = 16 + 12 * seed
    num_nodes = 100 + 50 * seed
    plan, xcarry, xch, xcnt, xadv = jax_case(
        seed, num_pods, num_nodes, most_requested, num_scalars, infeasible)
    port_plan = plan_from_numpy(dataclasses.asdict(plan))
    # int32 floor and trunc division agree only on non-negative operands:
    # every operand the plan hands the kernel is >= 0
    for name in ("alloc_cpu", "alloc_mem", "req_cpu", "req_mem", "nz_cpu",
                 "nz_mem", "aff_count", "intolerable", "avoid_score",
                 "used_cpu", "nonzero_cpu", "nonzero_mem"):
        assert int(getattr(port_plan, name).min()) >= 0, name
    # chunk 7 exercises several launches and a ghost-padded tail
    ch, cnt, adv, carry = fast_scan(port_plan, chunk=7, device="cpu",
                                    return_carry=True)
    assert np.array_equal(ch, xch)
    assert np.array_equal(cnt, xcnt)
    assert np.array_equal(adv, xadv)
    assert_carry_matches_xla(plan, carry, xcarry)
    scheduled = int(np.sum(ch >= 0))
    assert 0 < scheduled < num_pods  # both outcomes exercised


def test_chunking_ghosts_and_resume_are_invisible(monkeypatch):
    plan, _, xch, xcnt, xadv = jax_case(5, 40, 130, False, 1, True)
    port_plan = plan_from_numpy(dataclasses.asdict(plan))
    monkeypatch.setenv("TPUSIM_FAST_SYNC_EVERY", "1")
    # 40 pods in launches of 16: the third launch is 8 pods and 8 ghosts
    ghosted = fast_scan(port_plan, chunk=16, device="cpu")
    head = fast_scan(port_plan, chunk=8, stop=13, device="cpu",
                     return_carry=True)
    tail = fast_scan(port_plan, chunk=8, start=13, device="cpu",
                     carry_in=head[3])
    for got in (ghosted, tuple(np.concatenate([h, t])
                             for h, t in zip(head[:3], tail))):
        assert np.array_equal(got[0], xch)
        assert np.array_equal(got[1], xcnt)
        assert np.array_equal(got[2], xadv)


def test_plain_chunk_matches_pallas_interpret():
    """One small case against the Pallas kernel itself (interpret mode):
    choices, counts, advanced, every carry row and rr bit-equal."""
    plan, *_ = jax_case(6, 24, 100, True, 1, True)
    jch, jcnt, jadv, jcarry = jfs.fast_scan(plan, interpret=True,
                                            return_carry=True)
    port_plan = plan_from_numpy(dataclasses.asdict(plan))
    ch, cnt, adv, carry = fast_scan(port_plan, device="cpu",
                                    return_carry=True)
    assert np.array_equal(ch, np.asarray(jch))
    assert np.array_equal(cnt, np.asarray(jcnt))
    assert np.array_equal(adv, np.asarray(jadv))
    for i in range(7):
        assert np.array_equal(carry.rows[i].numpy(),
                              np.asarray(jcarry.rows[i])), i
    srows = port_plan.used_scalar.shape[0]
    assert np.array_equal(carry.scal.numpy()[:srows],
                          np.asarray(jcarry.scal))
    assert int(carry.misc[0, 0]) == int(np.asarray(jcarry.misc)[0, 0])


def test_wrapper_uses_plain_version_on_cpu_only():
    plan, *_ = jax_case(7, 20, 100, False)
    port_plan = plan_from_numpy(dataclasses.asdict(plan))
    before = fastscan_chunk.launches
    fast_scan(port_plan, device="cpu")
    assert fastscan_chunk.launches == before  # plain runs are not launches
    dp = DevicePlan(port_plan, torch.device("cpu"))
    carry, misc = carry_tensors(init_carry(port_plan), torch.device("cpu"))
    pods = torch.from_numpy(pod_matrix(port_plan, 0, 20, 20))
    with pytest.raises(ValueError):
        fastscan_chunk(pods.to("meta"), dp.statics, dp.tables, carry, misc,
                       dp.alloc_scalar, 0, NUM_FIXED_BITS, False)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,most_requested,num_scalars", [
    (0, False, 0), (1, True, 2)])
def test_cuda_kernel_matches_plain(seed, most_requested, num_scalars):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plan, *_ = jax_case(seed, 96, 300, most_requested, num_scalars, True)
    port_plan = plan_from_numpy(dataclasses.asdict(plan))
    outs = {}
    for dev in ("cpu", "cuda"):
        d = torch.device(dev)
        dp = DevicePlan(port_plan, d)
        carry, misc = carry_tensors(init_carry(port_plan), d)
        pods = torch.from_numpy(pod_matrix(port_plan, 0, 96, 96)).to(d)
        run = fastscan_chunk_plain if dev == "cpu" else fastscan_chunk
        res = run(pods, dp.statics, dp.tables, carry, misc, dp.alloc_scalar,
                  port_plan.num_scalars, NUM_FIXED_BITS + num_scalars,
                  most_requested)
        outs[dev] = [t.cpu() for t in (*res, carry, misc)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)
