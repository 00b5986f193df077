"""Which side solves a gang's joint packing: the device solve
(scan.gang_select) or its numpy oracle (oracle.select_oracle).

TPUSIM_GANG_KERNEL=0 forces the oracle; unset or any other value runs the
device solve. Nothing here compares the two or falls back from one to the
other: a device error raises. The tests and chip_smoke.py hold the two sides
against each other instead.
"""

from __future__ import annotations

import os
from typing import List

from tpusim_torch.gang.oracle import select_oracle


def gang_kernel_enabled() -> bool:
    """False when TPUSIM_GANG_KERNEL=0 asks for the host oracle."""
    return os.environ.get("TPUSIM_GANG_KERNEL") != "0"


def gang_choices(feasible, score, xs, gi, n_zone: int,
                 n_rack: int) -> List[int]:
    """One gang's joint packing: each member's node index, or -1.

    feasible, score: the members' lanes [M, N] (scan.gang_lanes); xs: the
    members' scan.PodX; gi: scan.GangIn; all tensors on one device."""
    if not gang_kernel_enabled():
        host = [t.cpu().numpy() for t in (
            feasible, score, xs.req_cpu, xs.req_mem, xs.req_gpu, xs.req_eph,
            xs.zero_request, gi.alloc_cpu, gi.alloc_mem, gi.alloc_gpu,
            gi.alloc_eph, gi.allowed_pods, gi.used_cpu, gi.used_mem,
            gi.used_gpu, gi.used_eph, gi.pod_count, gi.zone_dom,
            gi.rack_dom)]
        return select_oracle(*host, n_zone, n_rack)
    from tpusim_torch.scan import gang_select

    return gang_select(feasible, score, xs.req_cpu, xs.req_mem, xs.req_gpu,
                       xs.req_eph, xs.zero_request, gi, n_zone,
                       n_rack).cpu().tolist()
