"""The port's preemption hybrid (tpusim_torch/preempt.py) against the JAX
package's (tpusim/jaxe/preempt.py), on the CPU: the plain version of the
fused kernel and the torch ops of the exact scan and the victim selection.

Every feed of tests/test_jax_preempt.py runs on route "kernel" and "scan"
and with victims "auto" (picked on the device wherever the class allows)
and "host" (always the host pipeline); the split
(placements and FitError text), the preempted pods in order and the stop
reason must equal the JAX package's run_simulation(backend="jax",
enable_pod_priority=True) byte for byte (its XLA scan; the inter-pod feed
once more with its Pallas kernel in interpret mode). Then each module of
the slice alone: preempt_select, IncrementalCluster, plan_fast's gcd fold
of the placed pods and rearm_carry, classify_preemption_class; a workload
the first compile classifies unsupported, which both packages reroute to
the host orchestrator; and a disagreement between the device scan and the
host, which the JAX package resolves on the host and the port raises.

Each run gets a fresh build: the orchestrator writes conditions and
nominated node names onto the pods fed to it.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.engine.policy import decode_policy as jax_decode  # noqa: E402
from tpusim.engine.providers import default_registry as jax_registry  # noqa: E402
from tpusim.framework.store import ADDED as JAX_ADDED  # noqa: E402
from tpusim.framework.store import DELETED as JAX_DELETED  # noqa: E402
from tpusim.jaxe import fastscan as jfs  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import policyc as jpc  # noqa: E402
from tpusim.jaxe import preempt as jpreempt  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402
from tpusim.jaxe.delta import IncrementalCluster as JaxIncremental  # noqa: E402
from tpusim.simulator import run_simulation as jax_run  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import config as pconfig  # noqa: E402
from tpusim_torch import fastplan as pfp  # noqa: E402
from tpusim_torch import policyc as ppc  # noqa: E402
from tpusim_torch import preempt as ppreempt  # noqa: E402
from tpusim_torch import scan as pscan  # noqa: E402
from tpusim_torch import state as pstate  # noqa: E402
from tpusim_torch.delta import IncrementalCluster  # noqa: E402
from tpusim_torch.engine.policy import decode_policy as port_decode  # noqa: E402
from tpusim_torch.engine.providers import default_registry  # noqa: E402
from tpusim_torch.framework.store import ADDED, DELETED  # noqa: E402
from tpusim_torch.workloads import COMPAT_POLICIES, build_workload  # noqa: E402


def prio_pod(api, name, priority, milli_cpu=500, node_name="", labels=None,
             memory=0):
    p = api.make_pod(name, milli_cpu=milli_cpu, node_name=node_name,
                     labels=labels, memory=memory)
    p.spec.priority = priority
    if node_name:
        p.status.phase = "Running"
    return p


def split(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message if p.status.conditions
              else "") for p in status.failed_pods],
            [p.name for p in status.preempted_pods],
            status.stop_reason)


# --- the feeds of tests/test_jax_preempt.py, through `api` ---

def lower_priority_victim(api):
    node = api.make_node("n1", milli_cpu=1000, memory=16 * 1024**3)
    return (api.ClusterSnapshot(nodes=[node], pods=[
        prio_pod(api, "victim", 1, milli_cpu=800, node_name="n1")]),
        [prio_pod(api, "high", 10, milli_cpu=800)])


def equal_priorities(api):
    node = api.make_node("n1", milli_cpu=1000, memory=16 * 1024**3)
    return (api.ClusterSnapshot(nodes=[node], pods=[
        prio_pod(api, "peer", 10, milli_cpu=800, node_name="n1")]),
        [prio_pod(api, "pod", 10, milli_cpu=800)])


def mid_batch_redispatch(api):
    nodes = [api.make_node(f"n{i}", milli_cpu=2000, memory=16 * 1024**3)
             for i in range(3)]
    victims = [prio_pod(api, f"v{i}", 0, milli_cpu=1800, node_name=f"n{i}")
               for i in range(3)]
    pods = [prio_pod(api, "post", 0, milli_cpu=150),
            prio_pod(api, "preemptor", 5, milli_cpu=1900),
            prio_pod(api, "small-b", 0, milli_cpu=100),
            prio_pod(api, "small-a", 0, milli_cpu=100)]
    return api.ClusterSnapshot(nodes=nodes, pods=victims), pods


def cascade(api):
    nodes = [api.make_node(f"n{i}", milli_cpu=1000, memory=16 * 1024**3)
             for i in range(4)]
    victims = [prio_pod(api, f"v{i}", i % 3, milli_cpu=900, node_name=f"n{i}")
               for i in range(4)]
    pods = [prio_pod(api, f"h{i}", 8, milli_cpu=900) for i in range(6)]
    return api.ClusterSnapshot(nodes=nodes, pods=victims), pods


def unresolvable_nodes(api):
    tainted = api.make_node("tainted", milli_cpu=4000, memory=16 * 1024**3,
                            taints=[{"key": "k", "value": "v",
                                     "effect": "NoSchedule"}])
    normal = api.make_node("normal", milli_cpu=1000, memory=16 * 1024**3)
    return (api.ClusterSnapshot(nodes=[tainted, normal], pods=[
        prio_pod(api, "vt", 0, milli_cpu=100, node_name="tainted"),
        prio_pod(api, "vn", 0, milli_cpu=900, node_name="normal")]),
        [prio_pod(api, "pod", 9, milli_cpu=900)])


def random_differential(trial):
    def build(api):
        rng = random.Random(7)
        for t in range(trial + 1):   # the trials of one seeded stream
            nodes = [api.make_node(f"n{i}",
                                   milli_cpu=rng.choice([1000, 2000, 3000]),
                                   memory=16 * 1024**3) for i in range(6)]
            placed = [prio_pod(api, f"placed-{t}-{i}", rng.randint(0, 5),
                               milli_cpu=rng.choice([200, 500, 900]),
                               node_name=f"n{rng.randrange(6)}")
                      for i in range(10)]
            pods = [prio_pod(api, f"new-{t}-{i}", rng.randint(0, 10),
                             milli_cpu=rng.choice([300, 800, 1500, 2500]))
                    for i in range(18)]
        return api.ClusterSnapshot(nodes=nodes, pods=placed), pods
    return build


def no_nodes(api):
    return (api.ClusterSnapshot(nodes=[], pods=[]),
            [prio_pod(api, "pod", 5, milli_cpu=100)])


def empty_feed(api):
    return api.ClusterSnapshot(nodes=[api.make_node("n1", milli_cpu=1000)],
                               pods=[]), []


def chunk_sizing(api):
    rng = np.random.RandomState(11)
    nodes = [api.make_node(f"n{i}", milli_cpu=2000, memory=16 * 1024**3)
             for i in range(12)]
    placed = [prio_pod(api, f"placed-{i}", i % 3, milli_cpu=700,
                       node_name=f"n{i % 12}") for i in range(18)]
    pods = [prio_pod(api, f"new-{i}", int(rng.randint(0, 10)),
                     milli_cpu=int(rng.choice([400, 900, 1600])))
            for i in range(40)]
    return api.ClusterSnapshot(nodes=nodes, pods=placed), pods


def interpod(api):
    rng = random.Random(31)
    nodes = [api.make_node(f"n{i}", milli_cpu=2000, memory=8 * 1024**3,
                           labels={"zone": f"z{i % 3}"}) for i in range(12)]
    low = []
    for i in range(20):
        p = api.make_pod(f"low{i}", milli_cpu=800, memory=2**28,
                         labels={"app": "lo"})
        p.spec.node_name = f"n{i % 12}"
        p.spec.priority = 0
        low.append(p)
    pods = []
    for i in range(60):
        kw = {"labels": {"app": f"a{rng.randrange(2)}"}}
        if rng.random() < 0.3:
            kw["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector":
                     {"matchLabels": {"app": kw["labels"]["app"]}},
                     "topologyKey": "zone"}]}}
        p = api.make_pod(f"p{i}", milli_cpu=rng.choice([400, 800]),
                         memory=2**28, **kw)
        p.spec.priority = int(rng.choice([0, 500, 1000]))
        pods.append(p)
    return api.ClusterSnapshot(nodes=nodes, pods=low), pods


# feed name -> (build, the chunk schedule both sides run it under)
FEEDS = {
    "lower_priority_victim": (lower_priority_victim, None),
    "equal_priorities": (equal_priorities, None),
    "mid_batch_redispatch": (mid_batch_redispatch, None),
    "cascade": (cascade, None),
    "unresolvable_nodes": (unresolvable_nodes, None),
    **{f"random_differential_{t}": (random_differential(t), None)
       for t in range(3)},
    "no_nodes": (no_nodes, None),
    "empty_feed": (empty_feed, None),
    "chunk_sizing_8_16": (chunk_sizing, (8, 16)),
    "chunk_sizing_single": (chunk_sizing, (1 << 20, 1 << 20)),
    "interpod": (interpod, None),
}
_JAX_RESULTS = {}


def set_chunks(monkeypatch, chunks):
    if chunks is None:
        monkeypatch.delenv("TPUSIM_PREEMPT_CHUNK0", raising=False)
        monkeypatch.delenv("TPUSIM_PREEMPT_CHUNK_MAX", raising=False)
    else:
        monkeypatch.setenv("TPUSIM_PREEMPT_CHUNK0", str(chunks[0]))
        monkeypatch.setenv("TPUSIM_PREEMPT_CHUNK_MAX", str(chunks[1]))


def jax_result(name, monkeypatch):
    """The JAX package's hybrid on its XLA scan, once per feed."""
    if name not in _JAX_RESULTS:
        build, chunks = FEEDS[name]
        with monkeypatch.context() as patch:
            patch.delenv("TPUSIM_FAST", raising=False)
            set_chunks(patch, chunks)
            snapshot, pods = build(jax_api)
            _JAX_RESULTS[name] = split(jax_run(
                pods, snapshot, backend="jax", enable_pod_priority=True))
    return _JAX_RESULTS[name]


@pytest.mark.parametrize("victims", ["auto", "host"])
@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("name", list(FEEDS))
def test_hybrid_matches_jax(name, route, victims, monkeypatch):
    want = jax_result(name, monkeypatch)
    build, chunks = FEEDS[name]
    set_chunks(monkeypatch, chunks)
    snapshot, pods = build(port_api)
    ppreempt.reset_preempt_stats()
    got = ppreempt.run_with_preemption(pods, snapshot, device="cpu",
                                       route=route, victims=victims)
    assert split(got) == want
    stats, paths = ppreempt.HYBRID_STATS, ppreempt.PREEMPT_CLASS_STATS
    if got.preempted_pods and name != "interpod":
        # an arithmetic class: "auto" picks every victim set on the device,
        # but for a pod no node fits even stripped, whose FitError the host
        # writes; "host" never picks on the device
        if victims == "auto":
            assert paths["device"] > 0
            assert paths["host"] == stats["no_candidates"]
        else:
            assert paths["host"] > 0 and paths["device"] == 0
    if name == "interpod" and got.preempted_pods:
        # inter-pod terms keep the victim search on the host
        assert paths["host"] > 0 and paths["device"] == 0
    if pods and snapshot.nodes:
        assert stats[f"route_{route}"] >= 1
        assert stats["fast_scan_calls" if route == "kernel"
                     else "scan_calls"] >= 1


def test_preemption_feeds_preempt():
    """The feeds reach what they are for: preemption, re-arms, several
    chunks."""
    for name in ("lower_priority_victim", "cascade", "chunk_sizing_8_16",
                 "interpod"):
        build, chunks = FEEDS[name]
        snapshot, pods = build(port_api)
        ppreempt.reset_preempt_stats()
        with pytest.MonkeyPatch.context() as patch:
            set_chunks(patch, chunks)
            got = ppreempt.run_with_preemption(pods, snapshot, device="cpu")
        assert got.preempted_pods, name
        assert ppreempt.HYBRID_STATS["rearms"] > 0, name
    assert ppreempt.HYBRID_STATS["fast_scan_calls"] > 1


def test_hybrid_matches_jax_pallas_interpret(monkeypatch):
    """The JAX hybrid with its Pallas kernel in interpret mode (its fast
    path, TPUSIM_FAST=1) on the inter-pod feed, against the port's kernel
    route: the post-victim re-arm rebuilds both presence carries."""
    monkeypatch.setenv("TPUSIM_FAST", "1")
    monkeypatch.setenv("TPUSIM_FAST_INTERPRET", "1")
    # chunks of 8 pods: few kernel shapes for the interpreter to trace
    set_chunks(monkeypatch, (8, 8))
    calls = []
    real = jfs.fast_scan

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jfs, "fast_scan", counted)
    snapshot, pods = interpod(jax_api)
    want = split(jpreempt.run_with_preemption(pods, snapshot))
    assert calls, "the JAX fast path did not engage"
    assert want == jax_result("interpod", monkeypatch)
    set_chunks(monkeypatch, None)
    snapshot, pods = interpod(port_api)
    got = ppreempt.run_with_preemption(pods, snapshot, device="cpu",
                                       route="kernel")
    assert split(got) == want
    assert got.preempted_pods


def test_run_simulation_takes_the_hybrid(monkeypatch):
    """run_simulation(backend="torch", enable_pod_priority=True) and its
    PodPriority feature-gate form run the hybrid, never the host
    orchestrator's loop."""
    from tpusim_torch import simulator

    def refuse(self):
        raise AssertionError("the host orchestrator ran")

    monkeypatch.setattr(simulator.ClusterCapacity, "run", refuse)
    want = jax_result("cascade", monkeypatch)
    for kw in ({"enable_pod_priority": True},
               {"feature_gates": {"PodPriority": True}}):
        snapshot, pods = cascade(port_api)
        got = simulator.run_simulation(pods, snapshot, device="cpu", **kw)
        assert split(got) == want


def test_unknown_arms_raise():
    snapshot, pods = cascade(port_api)
    for kw in ({"route": "pallas"}, {"victims": "kernel"},
               {"victims": "device"}):
        with pytest.raises(ValueError):
            ppreempt.run_with_preemption(pods, snapshot, device="cpu", **kw)


def test_route_kernel_raises_where_the_plan_refuses(monkeypatch):
    monkeypatch.setenv("TPUSIM_FAST_MAX_GROUPS", "1")
    snapshot, pods = interpod(port_api)
    with pytest.raises(NotImplementedError, match="pod groups exceed"):
        ppreempt.run_with_preemption(pods, snapshot, device="cpu",
                                     route="kernel")
    snapshot, pods = interpod(port_api)
    ppreempt.reset_preempt_stats()
    got = ppreempt.run_with_preemption(pods, snapshot, device="cpu")
    assert ppreempt.HYBRID_STATS["route_scan"] >= 1
    assert split(got) == jax_result("interpod", monkeypatch)


@pytest.mark.parametrize("route", ["auto", "kernel", "scan"])
def test_unsupported_compile_runs_the_host_orchestrator(route, monkeypatch):
    """A raw-group budget of 1 makes the first compile of the inter-pod
    feed unsupported: both packages run it on their host orchestrator, and
    the port counts the reroute and never scans."""
    monkeypatch.setenv("TPUSIM_MAX_RAW_GROUPS", "1")
    monkeypatch.delenv("TPUSIM_FAST", raising=False)
    snapshot, pods = interpod(jax_api)
    want = split(jax_run(pods, snapshot, backend="jax",
                         enable_pod_priority=True))
    assert want == jax_result("interpod", monkeypatch)
    snapshot, pods = interpod(port_api)
    assert pstate.compile_cluster(snapshot, pods)[0].unsupported
    ppreempt.reset_preempt_stats()
    got = ppreempt.run_with_preemption(pods, snapshot, device="cpu",
                                       route=route)
    assert split(got) == want
    stats = ppreempt.HYBRID_STATS
    assert stats["host_orchestrator"] == 1 and stats["compiles"] == 1
    assert stats["pods_scanned"] == 0 and not ppreempt.PREEMPT_CLASS_STATS


# --- a disagreement between the device scan and the host raises ---

def two_nodes(api):
    nodes = [api.make_node(f"n{i}", milli_cpu=1000, memory=16 * 1024**3)
             for i in range(2)]
    return (api.ClusterSnapshot(nodes=nodes, pods=[
        prio_pod(api, "victim", 1, milli_cpu=800, node_name="n0")]),
        [prio_pod(api, "high", 10, milli_cpu=300)])


@pytest.mark.parametrize("victims", ["auto", "host"])
@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_disagreement_raises(route, victims, monkeypatch):
    """The scan reports the feed's one pod infeasible though it fits on n1:
    the JAX package places it on the host with an error logged; the port
    raises RuntimeError naming the pod."""
    real_jax = jpreempt.schedule_scan

    def jax_wrong(*a, **kw):
        carry, choices, counts, advanced = real_jax(*a, **kw)
        return carry, np.full_like(np.asarray(choices), -1), counts, advanced

    monkeypatch.delenv("TPUSIM_FAST", raising=False)
    monkeypatch.setattr(jpreempt, "schedule_scan", jax_wrong)
    snapshot, pods = two_nodes(jax_api)
    want = jpreempt.run_with_preemption(pods, snapshot)
    assert [(p.name, p.spec.node_name) for p in want.successful_pods] == \
        [("high", "n1")]

    if route == "kernel":
        real = ppreempt.fast_scan

        def wrong(*a, **kw):
            choices, *rest = real(*a, **kw)
            return (np.full_like(choices, -1), *rest)

        monkeypatch.setattr(ppreempt, "fast_scan", wrong)
    else:
        real = pscan.schedule_scan

        def wrong(*a, **kw):
            carry, choices, *rest = real(*a, **kw)
            return (carry, torch.full_like(choices, -1), *rest)

        monkeypatch.setattr(pscan, "schedule_scan", wrong)
    snapshot, pods = two_nodes(port_api)
    with pytest.raises(RuntimeError, match="default/high"):
        ppreempt.run_with_preemption(pods, snapshot, device="cpu",
                                     route=route, victims=victims)


# --- preempt_select ---

def random_lanes(seed, zero_req):
    """Seeded lanes and slots: up to 8 candidate nodes near their pod and
    resource limits, up to 6 victims each sorted by descending priority,
    padded to 8 x 6 (one shape for the JAX program to compile)."""
    rng = np.random.RandomState(seed)
    c, v = 8, 6
    alloc = rng.choice([1000, 2000, 4000], size=(c, 4)) * np.array(
        [1, 1 << 20, 1, 1 << 20])
    counts = rng.randint(1, v + 1, size=c)
    valid = np.arange(v)[None, :] < counts[:, None]
    v_prio = -np.sort(-rng.randint(0, 4, size=(c, v)), axis=1)
    v_req = rng.randint(0, 5, size=(c, v, 4)) * (alloc[:, None, :] // 8)
    n_base = rng.randint(0, 3, size=c)
    want = (np.zeros(4, np.int64) if zero_req
            else rng.randint(1, 4, size=4) * (alloc.min(axis=0) // 8))
    base = rng.randint(0, 3, size=(c, 4)) * (alloc // 8) + want
    allowed = n_base + counts + rng.randint(0, 3, size=c)
    lane_valid = np.arange(c) < int(rng.randint(1, c + 1))
    valid &= lane_valid[:, None]
    v_req *= valid[:, :, None]
    v_prio = np.where(valid, v_prio, 0)
    node_idx = np.sort(rng.choice(100, size=c, replace=False))
    return (lane_valid, node_idx.astype(np.int64),
            *(alloc[:, k].astype(np.int64) for k in range(4)),
            allowed.astype(np.int64), n_base.astype(np.int64),
            *(base[:, k].astype(np.int64) for k in range(4)),
            v_prio.astype(np.int64),
            *(v_req[:, :, k].astype(np.int64) for k in range(4)), valid)


@pytest.mark.parametrize("zero_req", [False, True])
def test_preempt_select_matches_jax(zero_req):
    picks = empties = 0
    for seed in range(40):
        args = random_lanes(seed, zero_req)
        want = [np.asarray(a) for a in jk.preempt_select(zero_req, *args)]
        got = [t.numpy() for t in pscan.preempt_select(
            zero_req, *(torch.from_numpy(np.ascontiguousarray(a))
                        for a in args))]
        for g, w in zip(got, want):
            assert np.array_equal(g, w), seed
        picks += int(got[0]) < pscan.PREEMPT_NONE
        empties += int(got[1]) < pscan.PREEMPT_NONE
    assert picks > 5 and empties > 5


# --- IncrementalCluster ---

def event_sequence(api, incremental_cls, added, deleted):
    """One seeded pod-event sequence on config 6's small feed, its pods
    labelled app=a0..a2 and one in four with a required anti-affinity term
    on its own label (so the group tables are active): a third of the new
    pods bound, every fourth of those deleted, one bound pod moved to
    another node. Returns the incremental cluster after it and the feed
    left to schedule."""
    snapshot, pods = build_workload(120, 12, affinity=True, priorities=True,
                                    seed=5, api=api)
    for i, pod in enumerate(pods):
        pod.metadata.labels = {"app": f"a{i % 3}"}
        if i % 4 == 0:
            anti = api.make_pod("anti", affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": f"a{i % 3}"}},
                     "topologyKey": "kubernetes.io/hostname"}]}})
            if pod.spec.affinity is None:
                pod.spec.affinity = anti.spec.affinity
            else:
                pod.spec.affinity.pod_anti_affinity = \
                    anti.spec.affinity.pod_anti_affinity
    inc = incremental_cls(snapshot)
    rng = random.Random(3)
    node_names = [n.name for n in snapshot.nodes]
    bound = []
    for pod in pods[:40]:
        b = pod.copy()
        b.spec.node_name = rng.choice(node_names)
        inc.apply(added, b)
        bound.append(b)
    for b in bound[::4]:
        inc.apply(deleted, b)
    moved = bound[1].copy()
    moved.spec.node_name = node_names[(node_names.index(
        bound[1].spec.node_name) + 1) % len(node_names)]
    inc.apply(added, moved)
    return inc, pods[40:]


def assert_compiled_equal(got, want):
    assert got.scalar_names == want.scalar_names
    assert got.node_index == want.node_index
    assert got.statics.names == want.statics.names
    for part in ("statics", "tables", "dynamic", "groups"):
        for f in dataclasses.fields(getattr(got, part)):
            if f.name == "names":
                continue
            g = getattr(getattr(got, part), f.name)
            w = getattr(getattr(want, part), f.name)
            if isinstance(w, np.ndarray):
                assert np.array_equal(g, w), f"{part}.{f.name}"
            else:
                assert g == w, f"{part}.{f.name}"
    for name in ("has_ports", "has_services", "has_interpod",
                 "has_disk_conflict", "has_maxpd", "has_vol_zone",
                 "maxpd_limits", "n_topo_doms", "n_zone_doms", "unsupported"):
        assert getattr(got, name) == getattr(want, name), name


def assert_cols_equal(got, want):
    for f in dataclasses.fields(got):
        assert np.array_equal(getattr(got, f.name),
                              getattr(want, f.name)), f.name


def test_incremental_cluster_matches_jax_and_a_fresh_compile():
    jinc, jfeed = event_sequence(jax_api, JaxIncremental, JAX_ADDED,
                                 JAX_DELETED)
    pinc, pfeed = event_sequence(port_api, IncrementalCluster, ADDED,
                                 DELETED)
    jc, jcols = jinc.compile(jfeed)
    pc, pcols = pinc.compile(pfeed)
    assert_compiled_equal(pc, jc)
    assert_cols_equal(pcols, jcols)
    # the equivalence contract, on the port alone
    fc, fcols = pstate.compile_cluster(pinc.to_snapshot(), pfeed)
    assert_compiled_equal(pc, fc)
    assert_cols_equal(pcols, fcols)
    assert pc.has_interpod and pc.groups.presence.sum() > 0

    # placed-pod churn on clean tables: refresh_dynamic, on both
    for inc, added, deleted, feed in (
            (jinc, JAX_ADDED, JAX_DELETED, jfeed),
            (pinc, ADDED, DELETED, pfeed)):
        for pod in feed[:6]:
            bound = pod.copy()
            bound.spec.node_name = inc.nodes[-1].name
            inc.apply(added, bound)
        inc.apply(deleted, feed[0])
    jr, pr = jinc.refresh_dynamic(jc), pinc.refresh_dynamic(pc)
    assert jr is not None and pr is not None
    assert_compiled_equal(pr, jr)
    assert not np.array_equal(pr.dynamic.pod_count, pc.dynamic.pod_count)
    fresh, _ = pstate.compile_cluster(pinc.to_snapshot(), pfeed)
    for f in dataclasses.fields(pr.dynamic):
        assert np.array_equal(getattr(pr.dynamic, f.name),
                              getattr(fresh.dynamic, f.name)), f.name
    assert np.array_equal(pr.groups.presence, fresh.groups.presence)
    # a bind with volumes dirties the group tables: refresh_dynamic leaves
    # it to a full compile, on both
    for inc, api_, added in ((jinc, jax_api, JAX_ADDED),
                             (pinc, port_api, ADDED)):
        vol = api_.make_pod("with-volume", milli_cpu=100,
                            node_name=inc.nodes[0].name,
                            volumes=[api_.make_pod_volume(
                                "v", {"gcePersistentDisk": {"pdName": "d"}})])
        inc.apply(added, vol)
    assert jinc.refresh_dynamic(jc) is None
    assert pinc.refresh_dynamic(pc) is None
    jc2, jcols2 = jinc.compile(jfeed)
    pc2, pcols2 = pinc.compile(pfeed)
    assert_compiled_equal(pc2, jc2)
    assert_cols_equal(pcols2, jcols2)
    assert_compiled_equal(pc2, pstate.compile_cluster(pinc.to_snapshot(),
                                                      pfeed)[0])


# --- plan_fast(placed_pods=) and rearm_carry ---

def test_placed_pod_gcds_and_rearm_match_jax():
    """Placed pods of 250m and 2Gi, two a node, fold into the gcds (where
    the new pods and the node sums alone reduce by 500m and 4Gi); after a
    victim's deletion the re-armed carry divides exactly, on both packages,
    and without the fold it refuses on both."""
    def build(api):
        nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=16 * 1024**3)
                 for i in range(5)]
        placed = [prio_pod(api, f"v{i}", 0, milli_cpu=250,
                           memory=2 * 1024**3, node_name=f"n{i % 5}")
                  for i in range(10)]
        pods = [prio_pod(api, f"p{i}", 5, milli_cpu=500, memory=4 * 1024**3)
                for i in range(9)]
        return api.ClusterSnapshot(nodes=nodes, pods=placed), pods

    out = {}
    for name, api, inc_cls, deleted, plan_fast, cfg_for in (
            ("jax", jax_api, JaxIncremental, JAX_DELETED,
             lambda c, cl, pl: jfs.plan_fast(
                 jk.config_for([c], False,
                               jstate.NUM_FIXED_BITS + len(c.scalar_names)),
                 c, cl, placed_pods=pl), None),
            ("port", port_api, IncrementalCluster, DELETED,
             lambda c, cl, pl: pfp.plan_fast(pconfig.config_for(c, False), c,
                                             cl, placed_pods=pl), None)):
        snapshot, pods = build(api)
        inc = inc_cls(snapshot)
        compiled, cols = inc.compile(pods)
        plan, why = plan_fast(compiled, cols, snapshot.pods)
        bare, _ = plan_fast(compiled, cols, None)
        assert plan is not None, why
        inc.apply(deleted, snapshot.pods[3])
        out[name] = (plan, bare, inc.refresh_dynamic(compiled), compiled)
    jplan, jbare, jref, jc = out["jax"]
    pplan, pbare, pref, pc = out["port"]
    assert pplan.gcds == jplan.gcds == (250, 2 * 1024**3, 1, 1)
    assert pbare.gcds == jbare.gcds == (500, 4 * 1024**3, 1, 1)
    handed = pfp.plan_from_numpy(dataclasses.asdict(jplan))
    for rr in (0, 7):
        want = jfs.rearm_carry(jplan, jref, rr)
        for plan in (pplan, handed):
            got = pfp.rearm_carry(plan, pref, rr)
            for g, w in zip(got.rows, want.rows):
                assert np.array_equal(g, w)
            assert np.array_equal(got.misc, want.misc)
    # without the fold, the deleted victim's 250m leaves a cpu row that
    # 500m does not divide: both refuse
    assert jfs.rearm_carry(jbare, jref, 0) is None
    assert pfp.rearm_carry(pbare, pref, 0) is None
    assert pfp.rearm_carry(pfp.plan_from_numpy(dataclasses.asdict(jbare)),
                           pref, 0) is None


def test_rearm_carry_interpod_matches_jax():
    """The inter-pod feed's plan: presence and presence_dom re-armed."""
    out = {}
    for name, api, inc_cls, deleted in (
            ("jax", jax_api, JaxIncremental, JAX_DELETED),
            ("port", port_api, IncrementalCluster, DELETED)):
        snapshot, pods = interpod(api)
        inc = inc_cls(snapshot)
        compiled, cols = inc.compile(pods)
        if name == "jax":
            cfg = jk.config_for([compiled], False, jstate.NUM_FIXED_BITS)
            plan, why = jfs.plan_fast(cfg, compiled, cols,
                                      placed_pods=snapshot.pods)
        else:
            plan, why = pfp.plan_fast(pconfig.config_for(compiled, False),
                                      compiled, cols,
                                      placed_pods=snapshot.pods)
        assert plan is not None and plan.has_interpod, why
        inc.apply(deleted, snapshot.pods[0])
        out[name] = (plan, inc.refresh_dynamic(compiled))
    (jplan, jref), (pplan, pref) = out["jax"], out["port"]
    want = jfs.rearm_carry(jplan, jref, 3)
    got = pfp.rearm_carry(pplan, pref, 3)
    for field in ("pres", "pd", "misc"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    for g, w in zip(got.rows, want.rows):
        assert np.array_equal(g, w)


# --- classify_preemption_class ---

FLAG_SETS = [None, {}, {"has_ports": False},
             {"has_ports": False, "has_interpod": False},
             {"has_ports": False, "has_interpod": False,
              "has_disk_conflict": False, "has_maxpd": False}]


def test_classify_preemption_class_matches_jax_on_providers():
    jreg, preg = jax_registry(), default_registry()
    assert sorted(preg.providers) == sorted(jreg.providers)
    classes = set()
    for name in sorted(preg.providers):
        keys = frozenset(preg.get_algorithm_provider(name)[0])
        assert keys == frozenset(jreg.get_algorithm_provider(name)[0])
        for flags in FLAG_SETS:
            for ext in (False, True):
                got = ppc.classify_preemption_class(keys, flags, ext)
                assert got == jpc.classify_preemption_class(keys, flags, ext)
                classes.add(got[0])
    assert classes == {"arithmetic", "general"}
    for keys in (None, frozenset({"PodFitsResources", "PodFitsPorts"}),
                 frozenset({"HostName"})):
        for flags in FLAG_SETS:
            assert ppc.classify_preemption_class(keys, flags) == \
                jpc.classify_preemption_class(keys, flags)


@pytest.mark.parametrize("version", sorted(COMPAT_POLICIES))
def test_policy_preemption_class_matches_jax(version):
    """Each compatibility policy's predicate set, classified at compile
    time (every feature assumed present): the port's class equals the JAX
    package's, and its CompiledPolicy.preemption_class where no
    ServiceAffinity lock overrides it."""
    policy = COMPAT_POLICIES[version]
    got_cp = ppc.compile_policy(port_decode(policy))
    want_cp = jpc.compile_policy(jax_decode(policy))
    assert got_cp.spec.pred_keys == want_cp.spec.pred_keys
    has_ext = bool(port_decode(policy).extender_configs)
    got = ppc.classify_preemption_class(got_cp.spec.pred_keys,
                                        has_extenders=has_ext)
    assert got == jpc.classify_preemption_class(want_cp.spec.pred_keys,
                                                has_extenders=has_ext)
    if not want_cp.sa_entries:
        assert got == (want_cp.preemption_class,
                       want_cp.preemption_class_reason)
