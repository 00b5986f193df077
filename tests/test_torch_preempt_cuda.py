"""The preemption hybrid on the card against its run on the CPU: config 6
cut to 3,000 pods on 150 nodes through run_with_preemption, on the CUDA
kernel and the card's victim selection (device="cuda") and on their plain
versions (device="cpu"); and preempt_select on the card against the CPU on
seeded lanes. Everything compared is an integer or a string (tolerance 0).

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_preempt_cuda.py

Without a card every case skips.
"""

import numpy as np
import pytest
import torch

from tpusim_torch import preempt, scan
from tpusim_torch.kernels.fastscan import fastscan_chunk
from tpusim_torch.workloads import build_workload


def split(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods],
            [p.name for p in status.preempted_pods], status.stop_reason)


@pytest.mark.cuda
@pytest.mark.parametrize("route,victims", [("kernel", "auto"),
                                           ("kernel", "host"),
                                           ("scan", "auto")])
def test_cuda_hybrid_matches_cpu(route, victims):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    snapshot, pods = build_workload(3_000, 150, affinity=True,
                                    priorities=True, seed=777)
    out = {}
    for device in ("cpu", "cuda"):
        preempt.reset_preempt_stats()
        launches = fastscan_chunk.launches
        status = preempt.run_with_preemption(
            [p.copy() for p in pods], snapshot, device=device, route=route,
            victims=victims)
        out[device] = split(status)
        if device == "cuda":
            assert (fastscan_chunk.launches > launches) == (route == "kernel")
            paths = preempt.PREEMPT_CLASS_STATS
            assert bool(paths["device"]) == (victims == "auto")
    assert out["cuda"] == out["cpu"]
    assert len(out["cuda"][2]) == 12


@pytest.mark.cuda
@pytest.mark.parametrize("zero_req", [False, True])
def test_cuda_preempt_select_matches_cpu(zero_req):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in range(8):
        rng = np.random.RandomState(seed)
        c, v = 256, 24
        counts = rng.randint(1, v + 1, size=c)
        valid = np.arange(v)[None, :] < counts[:, None]
        alloc = rng.choice([4000, 8000], size=(c, 4)).astype(np.int64)
        v_prio = np.where(valid, -np.sort(-rng.randint(0, 3, size=(c, v)),
                                          axis=1), 0).astype(np.int64)
        v_req = (rng.randint(0, 4, size=(c, v, 4)) * 250 * valid[:, :, None]
                 ).astype(np.int64)
        base = rng.randint(0, 8, size=(c, 4)).astype(np.int64) * 500
        n_base = rng.randint(0, 4, size=c).astype(np.int64)
        args = (np.ones(c, bool), np.arange(c, dtype=np.int64) * 3,
                *(alloc[:, k] for k in range(4)), n_base + counts + 2,
                n_base, *(base[:, k] for k in range(4)), v_prio,
                *(v_req[:, :, k] for k in range(4)), valid)
        outs = [scan.preempt_select(zero_req, *(
            torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in args))
            for d in ("cpu", "cuda")]
        for a, b in zip(*outs):
            assert torch.equal(a, b.cpu())
