"""The yardstick of the scan step's roofline: the published peaks of the card
and the least bytes one step of the resident scan has to move.

The step decides one pod over every node: it reads the node columns of the
resident statics and carry once, the one row of each signature table that
the pod's signature selects, every row of the policy's per-node tables, the
pod's packed row, and writes the pod's outputs and the bound node's carry
row. The count is taken from the shapes alone, so it is the same whatever
implements the step: a fused kernel is judged on the same work.

The step is integer work (int64 sums, compares and a 16-bit-limb product
for BalancedResourceAllocation): it has no floating-point operations to set
against a FLOP/s peak, so its least time is its bytes over the card's memory
bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, at the card's full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

# every other statics and carry field is read whole: the node columns, the
# policy's [rows, node] tables (label masks, ServiceAntiAffinity domains,
# ServiceAffinity values, topology domains) and the small tables of
# signatures, groups and terms
_ROW_PER_POD = {
    # [signature, node]: the pod's signature selects one row
    "selector_ok", "taint_ok", "taint_ok_noexec", "intolerable",
    "affinity_count", "avoid_score", "host_ok", "image_score",
    # [group, node]: the pod's group selects one row
    "zone_ok",
}
# [group, node] and [group, key, domain]: the pod's group's row
_CARRY_ROW_PER_POD = {"presence", "presence_dom"}


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _row_bytes(t) -> int:
    """Bytes of one row along the first axis."""
    return _nbytes(t) // max(int(t.shape[0]), 1) if t.dim() >= 2 else _nbytes(t)


def step_bytes(statics, carry, pod_row, outputs) -> int:
    """Least bytes one step moves: each input column read once, each output
    written once. `statics` and `carry` are the resident trees (named
    tuples of tensors), `pod_row` one packed pod row, `outputs` the bytes a
    step writes to its output rows."""
    total = _nbytes(pod_row)
    for name, t in zip(statics._fields, statics):
        if name in _ROW_PER_POD:
            total += _row_bytes(t)
        else:
            total += _nbytes(t)
    for name, t in zip(carry._fields, carry):
        if name in _CARRY_ROW_PER_POD:
            total += _row_bytes(t)
        else:
            total += _nbytes(t)
    n = int(carry.used_cpu.shape[0])
    # the bound node's row of each [node] carry column written back
    node_cols = sum(_nbytes(t) // max(n, 1) for name, t in
                    zip(carry._fields, carry)
                    if t.dim() >= 1 and int(t.shape[0]) == n)
    return total + node_cols + outputs
