"""The port's exact sequential scan on the card against the same scan on
the CPU, bit for bit (tolerance 0): choices, reason counts, advanced flags
and every field of the final carry, on a hostname inter-pod plan (past the
fused kernel's int32 plan) and a count-mode policy plan, eagerly and with
blocks of steps replayed as CUDA graphs.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_cuda.py

Without a card every case skips.
"""

import pytest
import torch

from tpusim_torch import workloads as W
from tpusim_torch.backend import compile_inputs
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.fastplan import plan_fast
from tpusim_torch.policyc import compile_policy
from tpusim_torch.scan import scan_inputs, schedule_scan

CASES = {
    "hostname_70_nodes": (lambda: W.random_interpod_workload(
        33, 200, 70, services=True), None),
    "count_mode_policy": (lambda: W.random_policy_workload(40, 200, 50),
                          W.random_policy(40, count_mode=True, noexec=True,
                                          ports_alias=True, sa_entries=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_scan_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    build, policy = CASES[name]
    snapshot, pods = build()
    cp = compile_policy(decode_policy(policy)) if policy else None
    config, compiled, cols, ptabs = compile_inputs(snapshot, pods,
                                                   compiled_policy=cp)
    if policy is None:
        assert plan_fast(config, compiled, cols, ptabs)[0] is None
    outs = {}
    for dev, graph_steps in (("cpu", 0), ("cuda", 0), ("cuda", 16)):
        # 16 steps a graph: 200 pods replay 12 blocks and run 7 eagerly
        carry, statics, xs = scan_inputs(config, compiled, cols, ptabs,
                                         torch.device(dev))
        final, *res = schedule_scan(config, carry, statics, xs,
                                    graph_steps=graph_steps)
        outs[dev, graph_steps] = [t.cpu() for t in (*final, *res)]
    for key in (("cuda", 0), ("cuda", 16)):
        for a, b in zip(outs["cpu", 0], outs[key]):
            assert a.dtype == b.dtype and torch.equal(a, b), key
    choices = outs["cuda", 16][-3]
    assert 0 < int((choices >= 0).sum()) < len(choices)
