"""The resident scan's group-free step as one CUDA launch: the wrapper of
csrc/resident_step.cu.

make_fused_step binds the kernel to the streaming twin's resident tensors
(scan.Statics and scan.Carry on the card), to a program's packed pod rows,
its outputs and its device-held pod counter t1, and returns step(): one
launch that decides pod t1, binds it into the carry in place, writes its
rows of the outputs and advances t1, bit for bit as scan.make_step's step
(the torch operations it replaces). The launch reads nothing from the host
and goes to torch's current stream, read at call time, so torch.cuda.graph
captures it. Only a configuration scan.fused_step_eligible admits is taken
(group-free, no policy, unsharded, on CUDA, at most MAX_NODES nodes); a CPU
tensor raises, as the torch step is the route there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpusim_torch.config import EngineConfig, policy_weights
from tpusim_torch.state import NUM_FIXED_BITS

# the kernel's limits (csrc/resident_step.cu kMaxThreads, kMaxCluster,
# kMaxBits): threads a CTA, CTAs a cluster (16 is a non-portable size) and
# reason bits, so at most MAX_BITS - NUM_FIXED_BITS scalar resources
MAX_THREADS = 512
CLUSTER_SIZES = (16, 8, 4, 2, 1)
MAX_BITS = 64
MAX_SCALARS = MAX_BITS - NUM_FIXED_BITS
# a CTA's shared memory (232,448 bytes on sm_90), less the kernel's static
# arrays, holds two int64 a node of its slab: at most MAX_SLAB nodes a CTA,
# and MAX_NODES over the largest portable cluster (8 CTAs), which
# scan.fused_step_eligible admits
SMEM_LIMIT = 232_448
STATIC_SMEM_RESERVE = 16_384
MAX_SLAB = 32 * ((SMEM_LIMIT - STATIC_SMEM_RESERVE) // (2 * 8 * 32))
MAX_NODES = 8 * MAX_SLAB

# the resident statics the kernel reads, in the entry point's order, with
# their dtypes and shapes: int64 node columns [N] and signature rows [R, N],
# bool masks, the scalar allocatable [N, S]
I64, BOOL = torch.int64, torch.bool
STATICS_READ = (("alloc_cpu", I64, "node"), ("alloc_mem", I64, "node"),
                ("alloc_gpu", I64, "node"), ("alloc_eph", I64, "node"),
                ("allowed_pods", I64, "node"),
                ("cond_fail_bits", I64, "node"),
                ("alloc_scalar", I64, "scalar"),
                ("mem_pressure", BOOL, "node"),
                ("disk_pressure", BOOL, "node"),
                ("selector_ok", BOOL, "rows"), ("taint_ok", BOOL, "rows"),
                ("host_ok", BOOL, "rows"), ("intolerable", I64, "rows"),
                ("affinity_count", I64, "rows"), ("avoid_score", I64, "rows"))
CARRY_WRITTEN = ("used_cpu", "used_mem", "used_gpu", "used_eph",
                 "used_scalar", "nonzero_cpu", "nonzero_mem", "pod_count",
                 "rr")
# the packed pod row's columns (scan._pod_layout): the four requests, the S
# scalar requests, then these, as the kernel's P_* and Q_* enums lay them
POD_HEAD = ("req_cpu", "req_mem", "req_gpu", "req_eph")
POD_TAIL = ("nz_cpu", "nz_mem", "zero_request", "best_effort", "sel_id",
            "tol_id", "aff_id", "avoid_id", "host_id", "group_id", "img_id",
            "sa_self_id")


class Geometry(NamedTuple):
    cluster: int     # CTAs
    threads: int     # threads a CTA
    slab: int        # nodes a CTA at most
    smem: int        # dynamic shared memory bytes


def launch_geometry(n: int, cluster: int) -> Geometry:
    """The kernel's geometry over n nodes with `cluster` CTAs: the nodes cut
    into u = ceil(n / 32) lane groups, CTA r owning the groups [floor(r u /
    c), floor((r + 1) u / c)), one node a thread up to MAX_THREADS, each
    node's reason word and score in shared memory."""
    units = -(-n // 32)
    if n <= 0 or cluster not in CLUSTER_SIZES or cluster > units:
        raise ValueError(f"a cluster of {cluster} CTAs over {n} nodes: the "
                         f"kernel takes one of {CLUSTER_SIZES} up to "
                         f"{units} (ceil(n / 32))")
    slab = 32 * -(-units // cluster)
    if slab > MAX_SLAB:
        raise ValueError(f"a cluster of {cluster} CTAs over {n} nodes: a "
                         f"CTA's {slab} nodes pass the {MAX_SLAB} its shared "
                         f"memory holds")
    return Geometry(cluster, min(MAX_THREADS, slab), slab, 2 * 8 * slab)


def check_operands(statics, carry, pods, out, t1) -> None:
    """Raise ValueError on a tensor the kernel does not take: every tensor
    on one device, contiguous, in the dtype and shape the kernel reads."""
    n = statics.alloc_cpu.shape[0]
    s = statics.alloc_scalar.shape[-1]
    dev = statics.alloc_cpu.device

    def need(name, t, dtype, shape=None):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"the fused step needs {name} contiguous "
                             f"{dtype} on {dev}, not {t.dtype} on "
                             f"{t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"the fused step needs {name} of shape {shape}, "
                             f"not {tuple(t.shape)}")

    if s > MAX_SCALARS:
        raise ValueError(f"{s} scalar resources: the fused step takes at "
                         f"most {MAX_SCALARS}")
    for name, dtype, kind in STATICS_READ:
        t = getattr(statics, name)
        need(name, t, dtype, (n,) if kind == "node" else
             (n, s) if kind == "scalar" else None)
        if kind == "rows" and (t.dim() != 2 or t.shape[1] != n):
            raise ValueError(f"the fused step needs {name} rows of {n} "
                             f"nodes, not {tuple(t.shape)}")
    for name in CARRY_WRITTEN:
        want = () if name == "rr" else (n, s) if name == "used_scalar" \
            else (n,)
        need(name, getattr(carry, name), I64, want)
    need("pods", pods, I64)
    if pods.dim() != 2 or pods.shape[1] != len(POD_HEAD) + s + len(POD_TAIL):
        raise ValueError(f"the fused step needs packed pod rows of "
                         f"{len(POD_HEAD) + s + len(POD_TAIL)} columns, "
                         f"not {tuple(pods.shape)}")
    bucket = pods.shape[0]
    need("choices", out.choices, torch.int32, (bucket,))
    need("counts", out.counts, torch.int32, (bucket, NUM_FIXED_BITS + s))
    need("advanced", out.advanced, BOOL, (bucket,))
    need("t1", t1, I64, (1,))


def launch_args(config: EngineConfig, statics, carry, pods, out, t1,
                geom: Geometry, stream: int) -> tuple:
    """The arguments of tpusim_resident_step, in build.SOURCES order:
    pointers as addresses, counts as ints."""
    n = statics.alloc_cpu.shape[0]
    s = statics.alloc_scalar.shape[-1]
    return (pods.data_ptr(), pods.shape[1], t1.data_ptr(),
            *(getattr(statics, name).data_ptr()
              for name, _, _ in STATICS_READ),
            *(getattr(carry, name).data_ptr() for name in CARRY_WRITTEN),
            out.choices.data_ptr(), out.counts.data_ptr(),
            out.advanced.data_ptr(), n, s, NUM_FIXED_BITS + s,
            # least, most, balanced, node affinity, taint, avoid
            *policy_weights(None, config.most_requested)[:6],
            geom.cluster, geom.threads, geom.smem, stream)


def schedulable(lib, geom: Geometry, device) -> bool:
    """Whether the card can schedule a cluster of this geometry
    (cudaOccupancyMaxActiveClusters), the kernel's attributes set for it."""
    with torch.cuda.device(device):
        held = lib.tpusim_resident_step_prepare(geom.cluster, geom.threads,
                                                geom.smem)
    if held < 0:
        raise RuntimeError(f"resident step cluster query failed: CUDA error "
                           f"{-held}")
    return held > 0


def pick_geometry(lib, n: int, device) -> Geometry:
    """The largest cluster of CLUSTER_SIZES over n nodes that the card can
    schedule. Raises when none can be."""
    for c in CLUSTER_SIZES:
        try:
            g = launch_geometry(n, c)
        except ValueError:     # too many CTAs for n, or a slab past MAX_SLAB
            continue
        if schedulable(lib, g, device):
            return g
    raise RuntimeError(f"no cluster of the resident step kernel can be "
                       f"scheduled on {device} over {n} nodes")


def make_fused_step(config: EngineConfig, statics, pods, carry, out, t1,
                    geometry: Optional[Geometry] = None):
    """step(): one launch of the kernel for pod t1 (see the module's
    docstring), at `geometry` (launch_geometry) or else the largest cluster
    the card schedules. The tensors are checked once and bound by address,
    so they must be patched in place, never rebound, as make_step's."""
    dev = statics.alloc_cpu.device
    if dev.type != "cuda":
        raise ValueError(f"the fused step runs on a CUDA device, not {dev}")
    check_operands(statics, carry, pods, out, t1)
    from tpusim_torch.kernels import build

    lib = build.load("resident_step.cu")
    n = statics.alloc_cpu.shape[0]
    geom = geometry
    if geom is None:
        geom = pick_geometry(lib, n, dev)
    elif geom != launch_geometry(n, geom.cluster) or not schedulable(
            lib, geom, dev):
        raise ValueError(f"{geom} is not a geometry the card schedules "
                         f"over {n} nodes")
    fn = lib.tpusim_resident_step

    def step():
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*launch_args(config, statics, carry, pods, out, t1, geom,
                             stream))
        if rc != 0:
            raise RuntimeError(f"resident step kernel launch failed: CUDA "
                               f"error {rc}")

    step.geometry = geom
    return step
