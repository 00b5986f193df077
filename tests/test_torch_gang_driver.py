"""The port's gang driver (tpusim_torch/gang/) against the JAX package's
(tpusim/gang/), on the CPU.

Each module alone: the feed planner (split_feed), the packing solve on the
device (scan.gang_select) against the JAX package's numpy oracle on the
(m, n, seed) cases of tests/test_gang.py, and the member lanes
(scan.gang_lanes) against the JAX package's gang_lanes. Then the slice as a
whole: run_simulation(backend="torch", device="cpu") on every gang feed of
tests/test_gang.py (all or nothing, min-available, mixed feeds, rank-aware
packing), on route "kernel" and "scan" and with the solve on the device and
on the host oracle (TPUSIM_GANG_KERNEL=0), must give the JAX package's
run_simulation(backend="jax") split byte for byte, FitError text included;
a gang the compile classifies unsupported takes the sequential trial on
both. Then gangs in the streaming twin: a verified gang stream and the
pipelined against the synchronous chain, against the JAX package's.
Tolerance: exact (choices, lanes and hashes equal).
"""

import numpy as np
import pytest
import torch

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
import tpusim.api.types as jax_types  # noqa: E402
from tpusim.gang import group as jgroup  # noqa: E402
from tpusim.gang.oracle import select_oracle as jax_oracle  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402
from tpusim.simulator import run_simulation as jax_run  # noqa: E402
from tpusim.simulator import run_stream_simulation as jax_stream  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
import tpusim_torch.api.types as port_types  # noqa: E402
from tpusim_torch import config as pconfig  # noqa: E402
from tpusim_torch import scan as pscan  # noqa: E402
from tpusim_torch import state as pstate  # noqa: E402
from tpusim_torch.gang import group as pgroup  # noqa: E402
from tpusim_torch.gang.oracle import select_oracle  # noqa: E402
from tpusim_torch.simulator import run_simulation  # noqa: E402
from tpusim_torch.simulator import run_stream_simulation  # noqa: E402
from test_torch_backend import forbid_host_route  # noqa: E402

STREAM_KEYS = ("placement_chain", "fold_chain", "paths", "restages",
               "commits", "load")


def cluster(api, num_nodes=6, milli_cpu=4000, racks=True, zones=False):
    nodes = []
    for i in range(num_nodes):
        labels = {}
        if racks:
            labels["topology.kubernetes.io/rack"] = f"rack-{i // 2}"
        if zones:
            labels["failure-domain.beta.kubernetes.io/region"] = "r1"
            labels["failure-domain.beta.kubernetes.io/zone"] = f"z{i // 3}"
        nodes.append(api.make_node(f"node-{i}", milli_cpu=milli_cpu,
                                   labels=labels))
    return api.ClusterSnapshot(nodes=nodes, pods=[])


def gang(api, grp, name, size, milli_cpu=1000, min_available=0):
    return [grp.mark_gang(api.make_pod(f"{name}-{i}", milli_cpu=milli_cpu),
                          name, min_available=min_available)
            for i in range(size)]


# the gang feeds of tests/test_gang.py, in podspec order: (pods, snapshot)
FEEDS = {
    "all_or_nothing": lambda api, grp: (
        gang(api, grp, "big", 8, milli_cpu=3900), cluster(api)),
    "min_available": lambda api, grp: (
        gang(api, grp, "part", 8, milli_cpu=3900, min_available=4),
        cluster(api)),
    "mixed": lambda api, grp: (
        [api.make_pod("s0", milli_cpu=100)] + gang(api, grp, "g", 4)
        + [api.make_pod(f"s{i}", milli_cpu=100) for i in (1, 2)]
        + gang(api, grp, "big", 8, milli_cpu=3900), cluster(api)),
    "rank_aware": lambda api, grp: (
        gang(api, grp, "g", 4, milli_cpu=500),
        cluster(api, num_nodes=8, racks=True, zones=True)),
    "admits": lambda api, grp: (gang(api, grp, "g", 4), cluster(api)),
}


def split(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods])


def test_split_feed_matches_jax():
    def plan(api, grp):
        solos = [api.make_pod(f"s{i}") for i in range(4)]
        g, h = gang(api, grp, "g", 3), gang(api, grp, "h", 2)
        feed = [solos[0], g[0], solos[1], h[0], g[1], solos[2], g[2], h[1],
                solos[3]]
        return [(None if s.group is None else s.group.name,
                 [p.name for p in (s.pods or s.group.pods)],
                 None if s.group is None else s.group.min_available)
                for s in grp.split_feed(feed)]

    want = plan(jax_api, jgroup)
    assert plan(port_api, pgroup) == want
    assert [name for name, _, _ in want] == [None, "g", None, "h", None]


def packing_case(m, n, seed):
    """tests/test_gang.py's random packing inputs."""
    rng = np.random.RandomState(seed)
    feasible = rng.rand(m, n) > 0.3
    score = rng.randint(0, 10_000, size=(m, n)).astype(np.int64)
    req_cpu = rng.randint(0, 2000, size=m).astype(np.int64)
    req_mem = rng.randint(0, 2**30, size=m).astype(np.int64)
    zeros = np.zeros(m, dtype=np.int64)
    zero_request = rng.rand(m) > 0.8
    nodes = dict(
        alloc_cpu=np.full(n, 4000, dtype=np.int64),
        alloc_mem=np.full(n, 2**34, dtype=np.int64),
        alloc_gpu=np.zeros(n, dtype=np.int64),
        alloc_eph=np.zeros(n, dtype=np.int64),
        allowed_pods=np.full(n, 8, dtype=np.int64),
        used_cpu=rng.randint(0, 2000, size=n).astype(np.int64),
        used_mem=np.zeros(n, dtype=np.int64),
        used_gpu=np.zeros(n, dtype=np.int64),
        used_eph=np.zeros(n, dtype=np.int64),
        pod_count=rng.randint(0, 4, size=n).astype(np.int64),
        zone_dom=rng.randint(0, 3, size=n).astype(np.int32),
        rack_dom=rng.randint(0, 4, size=n).astype(np.int32))
    return (feasible, score, req_cpu, req_mem, zeros, zeros,
            zero_request), nodes


@pytest.mark.parametrize("m,n,seed", [(2, 3, 0), (4, 8, 1), (7, 16, 2),
                                      (12, 5, 3)])
def test_gang_select_matches_the_jax_oracle(m, n, seed):
    members, nodes = packing_case(m, n, seed)
    want = jax_oracle(*members, *nodes.values(), 3, 4)
    assert select_oracle(*members, *nodes.values(), 3, 4) == want
    gi = pscan.GangIn(**{k: torch.as_tensor(v) for k, v in nodes.items()})
    got = pscan.gang_select(*(torch.as_tensor(a) for a in members), gi, 3, 4)
    assert got.dtype == torch.int32 and got.tolist() == want


def test_gang_select_ties_pick_the_first_node():
    # every node equal: each member goes to the first node that fits, as
    # numpy's first-occurrence argmax picks
    m, n = 6, 9
    members = (np.ones((m, n), bool), np.full((m, n), 7, np.int64),
               np.full(m, 1000, np.int64), np.zeros(m, np.int64),
               np.zeros(m, np.int64), np.zeros(m, np.int64),
               np.zeros(m, bool))
    nodes = {k: np.full(n, v, np.int64) for k, v in (
        ("alloc_cpu", 2000), ("alloc_mem", 0), ("alloc_gpu", 0),
        ("alloc_eph", 0), ("allowed_pods", 110), ("used_cpu", 0),
        ("used_mem", 0), ("used_gpu", 0), ("used_eph", 0), ("pod_count", 0))}
    nodes["zone_dom"] = np.zeros(n, np.int32)
    nodes["rack_dom"] = np.zeros(n, np.int32)
    want = jax_oracle(*members, *nodes.values(), 1, 1)
    gi = pscan.GangIn(**{k: torch.as_tensor(v) for k, v in nodes.items()})
    got = pscan.gang_select(*(torch.as_tensor(a) for a in members), gi, 1, 1)
    assert got.tolist() == want == [0, 0, 1, 1, 2, 2]


def test_gang_lanes_match_jax():
    """Every member's feasibility and score lanes against one carry, on a
    cluster with a bound pod and a failing member."""
    def build(api):
        snap = cluster(api, num_nodes=5, zones=True)
        snap.pods.append(api.make_pod("placed", milli_cpu=3000,
                                      node_name="node-1"))
        return snap, [api.make_pod(f"m{i}", milli_cpu=700 * (i + 1),
                                   memory=(i + 1) << 28) for i in range(5)]

    jsnap, jpods = build(jax_api)
    jc, jcols = jstate.compile_cluster(jsnap, jpods)
    jconfig = jk.config_for([jc], most_requested=False,
                            num_reason_bits=jstate.NUM_FIXED_BITS)
    jf, js = jk.gang_lanes(jconfig, jk.carry_init(jc),
                           jk.statics_to_device(jc),
                           jk.pod_columns_to_device(jcols))
    psnap, ppods = build(port_api)
    pc, pcols = pstate.compile_cluster(psnap, ppods)
    config = pconfig.config_for(pc, most_requested=False)
    cpu = torch.device("cpu")
    pf, ps = pscan.gang_lanes(config, pscan.carry_init(pc, cpu),
                              pscan.statics_to(pc, cpu),
                              pscan.pod_columns_to(pcols, cpu))
    assert pf.shape == (5, 5) and pf.dtype == torch.bool
    assert np.array_equal(pf.numpy(), np.asarray(jf))
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert pf.any() and not pf.all()


@pytest.mark.parametrize("solve", ["device", "host"])
@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_run_simulation_matches_jax(feed, route, solve, monkeypatch):
    if solve == "host":
        monkeypatch.setenv("TPUSIM_GANG_KERNEL", "0")
    want = split(jax_run(*FEEDS[feed](jax_api, jgroup), backend="jax"))
    with monkeypatch.context() as patch:
        forbid_host_route(patch)
        got = split(run_simulation(*FEEDS[feed](port_api, pgroup),
                                   device="cpu", route=route))
    assert got == want
    if feed == "rank_aware":
        racks = {int(name.split("-")[1]) // 2 for _, name in got[0]}
        assert len(got[0]) == 4 and len(racks) <= 2
    if feed == "min_available":
        assert len(got[0]) == 6
        assert all("admitted at 6/8" in text for _, text in got[1])


def test_unsupported_gang_takes_the_sequential_trial(monkeypatch, caplog):
    """A gang whose compile is unsupported (here: more raw pod groups than
    TPUSIM_MAX_RAW_GROUPS) is tried pod by pod on the host route, then
    admitted or rejected whole, as in the JAX package."""
    monkeypatch.setenv("TPUSIM_MAX_RAW_GROUPS", "1")

    def feed(api, types, grp):
        pods = []
        for name, ports in (("ok", (8080, 8081, 8080)),
                            ("clash", (9090, 9090, 9090))):
            for i, port in enumerate(ports):
                pod = grp.mark_gang(api.make_pod(f"{name}-{i}",
                                                 milli_cpu=100), name)
                pod.spec.containers[0].ports = [types.ContainerPort.from_obj(
                    {"containerPort": port, "hostPort": port})]
                pods.append(pod)
        return pods, cluster(api, num_nodes=2)

    want = split(jax_run(*feed(jax_api, jax_types, jgroup), backend="jax"))
    caplog.clear()
    got = split(run_simulation(*feed(port_api, port_types, pgroup),
                               device="cpu"))
    assert got == want
    trials = [r for r in caplog.records
              if r.name == "tpusim_torch.gang.driver"]
    # the feed runs LIFO: "clash" comes first, on a cluster with no placed
    # pod (one raw group, so the joint solve); "ok" second, its members'
    # raw group beside the placed clash pods' (the sequential trial)
    assert len(trials) == 1 and "raw pod groups" in trials[0].getMessage()


@pytest.mark.parametrize("pipeline", [False, True])
def test_gang_stream_matches_jax(pipeline):
    kw = dict(num_nodes=12, cycles=4, arrivals=6, gang_size=3, gang_count=1,
              seed=2, pipeline=pipeline, verify=not pipeline)
    want = jax_stream(**kw)
    got = run_stream_simulation(device="cpu", **kw)
    for key in STREAM_KEYS:
        assert got[key] == want[key], key
    assert got["paths"] == {"gang": 4} and got["load"]["gangs"] == 4
    if not pipeline:
        assert got["verified"] and got["mismatched_cycles"] == 0


def test_gang_stream_pipelined_equals_synchronous():
    kw = dict(num_nodes=12, cycles=6, arrivals=6, gang_size=3, gang_count=1,
              seed=5, node_flap_every=4, device="cpu")
    sync = run_stream_simulation(**kw)
    piped = run_stream_simulation(pipeline=True, **kw)
    assert piped["placement_chain"] == sync["placement_chain"]
    assert piped["fold_chain"] == sync["fold_chain"]


def test_gang_stream_rejects_match_jax():
    """A stream whose 4 nodes fill by the third cycle: from then on every
    gang is rejected whole and its trial binds rolled back, on both."""
    kw = dict(num_nodes=4, cycles=6, arrivals=24, gang_size=4, gang_count=1,
              seed=9, verify=True)
    want = jax_stream(**kw)
    got = run_stream_simulation(device="cpu", **kw)
    for key in STREAM_KEYS + ("scheduled", "unschedulable"):
        assert got[key] == want[key], key
    assert got["unschedulable"] >= 16 and got["verified"]
