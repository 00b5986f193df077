"""The fused fast-scan chunk: the CUDA kernel's wrapper and its plain
PyTorch version.

One call schedules a chunk of pods in order against the node state and
updates the carry in place (the carry tensor is the running cluster state;
updating it in place keeps one copy on the device). Tensor layout, all int32
and contiguous, node axis padded to Npad:

  pods     [k, 13 + S]  POD_FIELDS, then the S scalar requests
  statics  [8, Npad]    STATIC_ROWS
  tables   six [S_x, Npad] signature tables, TABLES order
  carry    [7 + Srows, Npad]  CARRY_ROWS, then the scalar rows
  misc     [128]        rr at [0]
  alloc_scalar [Srows, Npad] (or an empty tensor when S == 0)

Returns (choices [k], counts [k, num_bits], advanced [k]). A CPU tensor runs
the plain version; a CUDA tensor launches the kernel of csrc/fastscan.cu.
"""

from __future__ import annotations

import torch

from tpusim_torch.config import policy_weights
from tpusim_torch.engine.priorities import MAX_PRIORITY
from tpusim_torch.fastplan import PAD_SENTINEL_BIT
from tpusim_torch.state import (
    BIT_DISK_PRESSURE,
    BIT_HOSTNAME_MISMATCH,
    BIT_INSUFFICIENT_CPU,
    BIT_INSUFFICIENT_EPHEMERAL,
    BIT_INSUFFICIENT_GPU,
    BIT_INSUFFICIENT_MEMORY,
    BIT_INSUFFICIENT_PODS,
    BIT_MEMORY_PRESSURE,
    BIT_NODE_SELECTOR_MISMATCH,
    BIT_TAINTS_NOT_TOLERATED,
    NUM_FIXED_BITS,
)

POD_FIELDS = ("req_cpu", "req_mem", "req_gpu", "req_eph", "nz_cpu", "nz_mem",
              "zero_request", "best_effort", "sel_id", "tol_id", "aff_id",
              "avoid_id", "host_id")
STATIC_ROWS = ("alloc_cpu", "alloc_mem", "alloc_gpu", "alloc_eph", "allowed",
               "cond_bits", "mem_pressure", "disk_pressure")
TABLES = ("selector_ok", "taint_ok", "intolerable", "aff_count",
          "avoid_score", "host_ok")
CARRY_ROWS = 7
MISC_WIDTH = 128


def _bit(mask, b):
    return mask.to(torch.int32) << b


def filter_pod(row, statics, tables, carry, alloc_scalar, num_scalars: int):
    """The filter stages in predicatesOrdering for one pod (`row`, a list of
    its pod columns) against the current carry: (feasible mask, reason word
    of the first failing stage) over the node axis."""
    rc, rm, rg, re_, _, _, zero, best_effort, sel, tol, _, _, host = row[:13]
    rs = row[13:13 + num_scalars]
    acpu, amem, agpu, aeph, allowed, cond, mpr, dpr = statics
    sel_t, tol_t, _, _, _, host_t = tables
    used_c, used_m, used_g, used_e, _, _, pc = carry[:CARRY_ROWS]
    insuff_pods = (pc + 1) > allowed
    bits_res = _bit(insuff_pods, BIT_INSUFFICIENT_PODS)
    fail_res = insuff_pods
    if zero == 0:
        for b, (alloc, used, req) in zip(
                (BIT_INSUFFICIENT_CPU, BIT_INSUFFICIENT_MEMORY,
                 BIT_INSUFFICIENT_GPU, BIT_INSUFFICIENT_EPHEMERAL),
                ((acpu, used_c, rc), (amem, used_m, rm),
                 (agpu, used_g, rg), (aeph, used_e, re_))):
            ins = alloc < used + req
            fail_res = fail_res | ins
            bits_res = bits_res | _bit(ins, b)
        for si in range(num_scalars):
            ins = alloc_scalar[si] < carry[CARRY_ROWS + si] + rs[si]
            fail_res = fail_res | ins
            bits_res = bits_res | _bit(ins, NUM_FIXED_BITS + si)
    host_bad = host_t[host] == 0
    sel_bad = sel_t[sel] == 0
    stages = [
        (cond != 0, cond),
        (fail_res | host_bad | sel_bad,
         bits_res | _bit(host_bad, BIT_HOSTNAME_MISMATCH)
         | _bit(sel_bad, BIT_NODE_SELECTOR_MISMATCH)),
        (tol_t[tol] == 0, 1 << BIT_TAINTS_NOT_TOLERATED),
        ((mpr != 0) & (best_effort != 0), 1 << BIT_MEMORY_PRESSURE),
        (dpr != 0, 1 << BIT_DISK_PRESSURE),
    ]
    feasible = torch.ones_like(cond, dtype=torch.bool)
    reason = torch.zeros_like(cond)
    for fail, bits in reversed(stages):
        feasible = feasible & ~fail
        reason = torch.where(fail, bits, reason)
    return feasible, reason


def fastscan_chunk_plain(pods, statics, tables, carry, misc, alloc_scalar,
                         num_scalars: int, num_bits: int,
                         most_requested: bool):
    """The chunk as int32 tensor ops and a Python loop over pods, on the
    inputs' device. The same arithmetic as the kernel: int32 products wrap,
    integer division floors."""
    dev = pods.device
    i32 = torch.int32
    k = pods.shape[0]
    choices = torch.full((k,), -1, dtype=i32, device=dev)
    counts = torch.zeros((k, num_bits), dtype=i32, device=dev)
    adv = torch.zeros((k,), dtype=i32, device=dev)
    acpu, amem = statics[0], statics[1]
    _, tol_t, intol_t, aff_t, avoid_t, _ = tables
    w_least, w_most, w_balanced, w_aff, w_taint, w_avoid = \
        policy_weights(most_requested)
    shifts = torch.arange(num_bits, dtype=i32, device=dev)[:, None]
    rr = int(misc[0])
    rows = pods.cpu().tolist()

    def ratio(req, cap, most):
        valid = (cap > 0) & (req <= cap)
        expr = ((req if most else cap - req) * MAX_PRIORITY) \
            // torch.clamp(cap, min=1)
        return torch.where(valid, expr, 0)

    for j, row in enumerate(rows):
        rc, rm, rg, re_, nzc, nzm, _, _, _, tol, aff, avoid, _ = row[:13]
        rs = row[13:13 + num_scalars]
        nz_c, nz_m = carry[4], carry[5]
        feasible, reason = filter_pod(row, statics, tables, carry,
                                      alloc_scalar, num_scalars)
        n_feasible = int(feasible.sum())

        if n_feasible == 0:
            counts[j] = ((reason[None, :] >> shifts) & 1).sum(dim=1).to(i32)
            continue

        # ---- weighted score (generic_scheduler.go:631-639) ----
        total_c = nz_c + nzc
        total_m = nz_m + nzm
        score = torch.zeros_like(acpu)
        if w_least:
            score = score + w_least * ((ratio(total_c, acpu, False)
                                        + ratio(total_m, amem, False)) // 2)
        if w_most:
            score = score + w_most * ((ratio(total_c, acpu, True)
                                       + ratio(total_m, amem, True)) // 2)
        num = (total_c * amem - total_m * acpu).abs()
        den = acpu * amem
        bal = (MAX_PRIORITY * (den - num)) // torch.clamp(den, min=1)
        bal_zero = ((acpu == 0) | (total_c >= acpu) | (amem == 0)
                    | (total_m >= amem))
        score = score + w_balanced * torch.where(bal_zero, 0, bal)
        aff_row = aff_t[aff]
        aff_max = int(torch.where(feasible, aff_row, 0).max())
        if aff_max > 0:
            score = score + w_aff * (MAX_PRIORITY * aff_row // aff_max)
        intol_row = intol_t[tol]
        intol_max = int(torch.where(feasible, intol_row, 0).max())
        if intol_max > 0:
            score = score + w_taint * (
                MAX_PRIORITY - MAX_PRIORITY * intol_row // intol_max)
        else:
            score = score + w_taint * MAX_PRIORITY
        score = score + avoid_t[avoid] * w_avoid

        # ---- selectHost: max score, round-robin pick among the ties ----
        masked = torch.where(feasible, score, -1)
        tie = feasible & (masked == masked.max())
        ties = max(int(tie.sum()), 1)
        pick = rr % ties if n_feasible > 1 else 0
        choice = int(torch.nonzero(tie).flatten()[pick])
        choices[j] = choice
        adv[j] = int(n_feasible > 1)
        rr += int(n_feasible > 1)

        # ---- bind ----
        add = torch.tensor([rc, rm, rg, re_, nzc, nzm, 1] + rs, dtype=i32,
                           device=dev)
        carry[:CARRY_ROWS + num_scalars, choice] += add
    misc[0] = rr
    return choices, counts, adv


def _check(name, t, device, rows=None, cols=None):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if rows is not None and t.shape[0] < rows:
        raise ValueError(f"{name}: {t.shape[0]} rows, need {rows}")
    if cols is not None and (t.dim() != 2 or t.shape[1] != cols):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, need [*, {cols}]")


def fastscan_chunk(pods, statics, tables, carry, misc, alloc_scalar,
                   num_scalars: int, num_bits: int, most_requested: bool):
    """Schedule one chunk of pods: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    device = pods.device
    if device.type == "cpu":
        return fastscan_chunk_plain(pods, statics, tables, carry, misc,
                                    alloc_scalar, num_scalars, num_bits,
                                    most_requested)
    if device.type != "cuda":
        raise ValueError(f"fastscan_chunk runs on cuda or cpu, not {device}")
    npad = statics.shape[1]
    k = pods.shape[0]
    _check("pods", pods, device, cols=len(POD_FIELDS) + num_scalars)
    _check("statics", statics, device, rows=len(STATIC_ROWS), cols=npad)
    for name, t in zip(TABLES, tables):
        _check(name, t, device, cols=npad)
    _check("carry", carry, device, rows=CARRY_ROWS + num_scalars, cols=npad)
    _check("misc", misc, device)
    if num_scalars:
        _check("alloc_scalar", alloc_scalar, device, rows=num_scalars,
               cols=npad)
    if NUM_FIXED_BITS + num_scalars > PAD_SENTINEL_BIT \
            or num_bits > PAD_SENTINEL_BIT:
        raise ValueError(f"{num_scalars} scalar axes / {num_bits} reason "
                         "bits exceed the kernel's int32 reason word")
    from tpusim_torch.kernels import build

    lib = build.load("fastscan.cu")
    i32 = torch.int32
    choices = torch.empty((k,), dtype=i32, device=device)
    counts = torch.empty((k, num_bits), dtype=i32, device=device)
    adv = torch.empty((k,), dtype=i32, device=device)
    scratch = torch.empty((2, npad), dtype=i32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.tpusim_fastscan_chunk(
        pods.data_ptr(), k, pods.shape[1], statics.data_ptr(),
        *(t.data_ptr() for t in tables), carry.data_ptr(), misc.data_ptr(),
        alloc_scalar.data_ptr() if num_scalars else None, num_scalars,
        choices.data_ptr(), counts.data_ptr(), adv.data_ptr(),
        scratch.data_ptr(), num_bits, npad, int(bool(most_requested)),
        stream)
    if rc != 0:
        raise RuntimeError(f"fastscan kernel launch failed: CUDA error {rc}")
    fastscan_chunk.launches += 1
    return choices, counts, adv


# launches of the CUDA kernel (the plain version does not count)
fastscan_chunk.launches = 0
