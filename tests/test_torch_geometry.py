"""The fast-scan kernel's launch geometry (kernels/fastscan.py
launch_geometry), computed on the host: one thread-block cluster whose CTAs
split the node axis into slabs. Runs on the CPU; the kernel itself is held
against its plain version on the card (tests/test_torch_cluster_cuda.py).
"""

import os
import re

import pytest

from tpusim_torch.backend import build_plan
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.kernels import fastscan as kfs
from tpusim_torch.kernels.fastscan import (
    CLUSTER_SIZES,
    MAX_THREADS,
    SCRATCH_ROWS,
    SMEM_LIMIT,
    STATIC_SMEM_RESERVE,
    launch_geometry,
    slab_bounds,
)
from tpusim_torch.policyc import compile_policy
from tpusim_torch import workloads as wl

NPADS = (32, 64, 96, 128, 160, 224, 256, 384, 480, 512, 544, 640, 992, 1024,
         2048, 2080, 3200, 5120, 5152, 8192, 10240)


def check_geometry(g, npad, pd_words=0):
    assert g.cluster in CLUSTER_SIZES and g.cluster <= npad // 32
    # slabs tile [0, npad) in rank order, none empty, none wider than slab
    assert len(g.slabs) == g.cluster
    assert g.slabs[0][0] == 0 and g.slabs[-1][1] == npad
    for (lo, hi), (nlo, _) in zip(g.slabs, g.slabs[1:]):
        assert hi == nlo
    for lo, hi in g.slabs:
        assert lo % 32 == 0 and 0 < hi - lo <= g.slab
    assert g.slab == max(hi - lo for lo, hi in g.slabs)
    # whole warps, at most MAX_THREADS (<= 1024), enough to cover a slab
    assert g.threads % 32 == 0 and 32 <= g.threads <= MAX_THREADS <= 1024
    assert g.threads * g.nodes_per_thread >= g.slab
    assert g.threads == min(MAX_THREADS, g.slab)
    # the presence_dom replica and, where it fits beside, the scratch in the
    # CTA's shared memory beside the static part
    assert g.smem == SCRATCH_ROWS * g.slab * 4 * g.scratch_in_smem \
        + 4 * pd_words
    assert g.smem + STATIC_SMEM_RESERVE <= SMEM_LIMIT
    assert g.scratch_in_smem or \
        SCRATCH_ROWS * g.slab * 4 + g.smem + STATIC_SMEM_RESERVE > SMEM_LIMIT


@pytest.mark.parametrize("npad", NPADS)
@pytest.mark.parametrize("cluster", (None,) + CLUSTER_SIZES)
def test_launch_geometry(npad, cluster):
    if cluster is not None and cluster > npad // 32:
        with pytest.raises(ValueError):
            launch_geometry(npad, cluster)
        return
    g = launch_geometry(npad, cluster)
    check_geometry(g, npad)
    # an inter-pod plan's presence_dom replica, up to the budget's largest
    # (Gpad 128, 4 keys, 64 domains), which pushes a wide slab's scratch out
    for pd_words in (8 * 2 * 64, 128 * 4 * 64):
        gp = launch_geometry(npad, cluster, pd_words)
        check_geometry(gp, npad, pd_words)
        assert (gp.cluster, gp.threads, gp.slabs) == \
            (g.cluster, g.threads, g.slabs)
    if cluster is None:
        # the widest cluster with a lane group of nodes a CTA
        assert g.cluster == max(c for c in CLUSTER_SIZES if c <= npad // 32)
    else:
        assert g.cluster == cluster


@pytest.mark.parametrize("npad,cluster", [(0, None), (-32, None), (100, None),
                                          (5120, 3), (5120, 32), (96, 4)])
def test_launch_geometry_refuses(npad, cluster):
    with pytest.raises(ValueError):
        launch_geometry(npad, cluster)


def test_slab_bounds_balance():
    # 5 lane groups over 4 CTAs: one CTA takes two, in rank order
    assert slab_bounds(160, 4) == ((0, 32), (32, 64), (64, 96), (96, 160))
    assert slab_bounds(5120, 16)[3] == (960, 1280)
    g = launch_geometry(5120)
    assert (g.cluster, g.threads, g.nodes_per_thread, g.smem) == \
        (16, 320, 1, 5 * 320 * 4)
    g = launch_geometry(5120, None, 8 * 2 * 64)
    assert g.scratch_in_smem and g.smem == 5 * 320 * 4 + 4 * 8 * 2 * 64
    g = launch_geometry(5120, 1, 128 * 4 * 64)
    assert not g.scratch_in_smem and g.smem == 4 * 128 * 4 * 64
    assert not launch_geometry(10240, 1).scratch_in_smem
    with pytest.raises(ValueError):
        launch_geometry(5120, None, 60_000)
    g = launch_geometry(5120, 1)
    assert (g.threads, g.nodes_per_thread) == (512, 10)


def test_kernel_constants_match():
    """The CUDA source's geometry constants are the wrapper's."""
    src = open(os.path.join(os.path.dirname(kfs.__file__), os.pardir, "csrc",
                            "fastscan.cu")).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("kMaxThreads") == MAX_THREADS
    assert const("kMaxCluster") == max(CLUSTER_SIZES)
    assert const("kScratchRows") == SCRATCH_ROWS
    assert const("kMiscWidth") == kfs.MISC_WIDTH


# every plan shape the port's CPU tests build, and the cluster hazard cases
PLAN_SHAPES = {
    "uniform_200x30": (lambda: wl.uniform_workload(200, 30), None),
    "random_10x20": (lambda: wl.random_workload(2, 10, 20), None),
    "random_40x120": (lambda: wl.random_workload(0, 40, 120), None),
    "build_300x60": (lambda: wl.build_workload(300, 60), None),
    "build_2000x500": (lambda: wl.build_workload(2_000, 500), None),
    "group_120x40": (lambda: wl.random_group_workload(
        3, 120, 40, ports=True, services=True, disk=True, vol_zone=True,
        maxpd=True), None),
    "groups_2000x500": (lambda: wl.groups_workload(2_000, 500), None),
    "interpod_150x30": (lambda: wl.random_interpod_workload(0, 150, 30),
                        None),
    "interpod_100x63": (lambda: wl.random_interpod_workload(4, 100, 63),
                        None),
    "interpod_2000x500": (lambda: wl.interpod_workload(2_000, 500), None),
    "policy_300x80": (lambda: wl.random_policy_workload(40, 300, 80),
                      wl.random_policy(40, count_mode=True)),
    "policy_300x60": (lambda: wl.policy_workload(300, 60),
                      wl.COMPAT_POLICIES["1.2"]),
    "policy_2000x500": (lambda: wl.policy_workload(2_000, 500),
                        wl.COMPAT_POLICIES["1.2"]),
    **{f"hazard_{name}": (case[0], case[1])
       for name, case in wl.cluster_hazard_cases().items()},
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_geometry_of_every_plan_shape(name):
    build, policy = PLAN_SHAPES[name]
    snapshot, pods = build()
    cp = compile_policy(decode_policy(policy)) if policy else None
    plan = build_plan(snapshot, pods, compiled_policy=cp)[0]
    npad = plan.alloc_cpu.shape[1]
    g = launch_geometry(npad)
    check_geometry(g, npad)
    assert g.slabs[0][0] < plan.num_nodes
    for cluster in CLUSTER_SIZES:
        if cluster <= npad // 32:
            check_geometry(launch_geometry(npad, cluster), npad)
