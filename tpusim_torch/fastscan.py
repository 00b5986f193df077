"""The fused fast scan: pods of a FastPlan through the chunk kernel.

The plan is uploaded once per call; pods run in chunks of CHUNK (512) pods
with the carry chained device to device (the kernel updates it
in place, so consecutive launches on one stream see each other's binds with
no host round trip). Per-chunk outputs stay on the device until more than
TPUSIM_FAST_SYNC_EVERY chunks (default 64) are in flight; then the oldest is
copied to the host, so device memory for outputs stays O(sync_every * chunk)
while the host keeps launching ahead of the device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpusim_torch.device import resolve_device
from tpusim_torch.fastplan import GHOST_REQ, FastCarry, FastPlan, init_carry
from tpusim_torch.kernels.fastscan import (
    CARRY_ROWS,
    MISC_WIDTH,
    POD_FIELDS,
    STATIC_ROWS,
    TABLES,
    fastscan_chunk,
)
from tpusim_torch.state import NUM_FIXED_BITS

# pods per kernel launch
CHUNK = 512

def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def pod_matrix(plan: FastPlan, start: int, stop: int, rows: int) -> np.ndarray:
    """Pods [start, stop) as the kernel's [rows, 13 + S] int32 columns; rows
    past the span are ghost pods (req_cpu = GHOST_REQ: infeasible on every
    node, so they leave the carry and rr untouched)."""
    out = np.zeros((rows, len(POD_FIELDS) + plan.num_scalars), dtype=np.int32)
    out[:, 0] = GHOST_REQ
    span = stop - start
    for c, name in enumerate(POD_FIELDS):
        out[:span, c] = getattr(plan, name)[start:stop]
    if plan.num_scalars:
        out[:span, len(POD_FIELDS):] = plan.req_scalar[start:stop]
    return out


class DevicePlan:
    """The plan's node-side arrays on one device, in the kernel's layout."""

    def __init__(self, plan: FastPlan, device: torch.device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                    ).to(device)

        self.statics = put(np.concatenate(
            [getattr(plan, name) for name in STATIC_ROWS], axis=0))
        self.tables = tuple(put(getattr(plan, name)) for name in TABLES)
        npad = plan.alloc_cpu.shape[1]
        self.alloc_scalar = (put(plan.alloc_scalar) if plan.num_scalars
                             else torch.zeros((0, npad), dtype=torch.int32,
                                              device=device))


def carry_tensors(carry: FastCarry, device: torch.device):
    """A fresh [7 + Srows, Npad] carry tensor and [128] misc row on
    `device` (copies: the caller's carry is never updated in place)."""
    def host(a):
        return a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32))

    parts = [host(r).reshape(1, -1) for r in carry.rows]
    if carry.scal is not None:
        parts.append(host(carry.scal))
    rows = torch.cat(parts, dim=0).to(torch.int32)
    misc = host(carry.misc).reshape(-1)[:MISC_WIDTH].to(torch.int32)
    return rows.to(device).contiguous(), misc.to(device).clone()


def fast_scan(plan: FastPlan, chunk: int = CHUNK, start: int = 0,
              stop: Optional[int] = None, carry_in: Optional[FastCarry] = None,
              return_carry: bool = False, device="cuda"):
    """Run pods [start, stop) of the plan in launches of `chunk` pods (the
    last one ghost-padded); returns (choices, counts, advanced) over that
    span as numpy arrays, plus the FastCarry out (torch tensors on the
    device) when return_carry.

    carry_in: resume from an explicit carry instead of the plan's initial
    state. device: "cuda" (the default) launches the CUDA kernel, "cpu" runs
    its plain version."""
    device = resolve_device(device)
    if stop is None:
        stop = plan.num_pods
    span = stop - start
    num_bits = NUM_FIXED_BITS + plan.num_scalars
    k = min(max(chunk, 1), max(span, 1))
    num_chunks = -(-span // k) if span > 0 else 0

    dp = DevicePlan(plan, device)
    carry, misc = carry_tensors(carry_in or init_carry(plan), device)
    pods = torch.from_numpy(pod_matrix(plan, start, stop, num_chunks * k)
                            ).to(device)
    # clamp to >= 1: 0 would keep every chunk's outputs on the device
    sync_every = max(1, _env_int("TPUSIM_FAST_SYNC_EVERY", 64))
    results = []   # host triples (choices[n], counts[n, B], adv[n])
    pending = []   # FIFO of (choices_dev, counts_dev, adv_dev, n_real)

    def drain_one():
        och, ocnt, oadv, n_real = pending.pop(0)
        results.append((och[:n_real].cpu().numpy(),
                        ocnt[:n_real].cpu().numpy(),
                        oadv[:n_real].cpu().numpy() != 0))

    for ci in range(num_chunks):
        out = fastscan_chunk(pods[ci * k:(ci + 1) * k], dp.statics, dp.tables,
                             carry, misc, dp.alloc_scalar, plan.num_scalars,
                             num_bits, plan.most_requested)
        pending.append(out + (min(k, span - ci * k),))
        if len(pending) > sync_every:
            drain_one()
    while pending:
        drain_one()
    if not results:
        out3 = (np.zeros(0, np.int32), np.zeros((0, num_bits), np.int32),
                np.zeros(0, bool))
    else:
        out3 = tuple(np.concatenate([r[i] for r in results])
                     for i in range(3))
    if not return_carry:
        return out3
    carry_out = FastCarry(
        rows=[carry[i:i + 1] for i in range(CARRY_ROWS)],
        misc=misc.reshape(1, MISC_WIDTH),
        scal=carry[CARRY_ROWS:] if plan.num_scalars else None)
    return out3 + (carry_out,)
