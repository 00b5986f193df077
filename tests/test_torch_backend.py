"""TorchBackend (CPU: the plain kernel versions and the scan) against the
JAX package's JaxBackend and ReferenceBackend: identical placement hashes
and byte-identical FitError text on the group-free parity workloads, the
same simulation split, the same CLI report.

PARITY holds the group-free shapes of tests/test_jax_parity.py with memory
and cpu in coarser units (and a few small pod limits) so that their int32
plan fits the fused kernel's bounds; ORIGINAL holds them as
tests/test_jax_parity.py builds them, byte-granular, which the kernel's plan
refuses and the scan route runs (route="auto"), as the JAX package sends
them to its XLA scan.
"""

import random

import numpy as np
import pytest
import torch

import bench
import tpusim.api.snapshot as jax_api
from tpusim.api.podspec import expand_simulation_pods as jax_expand
from tpusim.api.podspec import parse_simulation_pods as jax_parse
from tpusim.backends import ReferenceBackend, placement_hash as jax_hash
from tpusim.jaxe.backend import JaxBackend
from tpusim.simulator import run_simulation as jax_run_simulation

import tpusim_torch.api.snapshot as port_api
import tpusim_torch.backend as port_backend
import tpusim_torch.simulator as port_simulator
from tpusim_torch.api.podspec import expand_simulation_pods, parse_simulation_pods
from tpusim_torch.backend import TorchBackend, placement_hash
from tpusim_torch.simulator import run_simulation
from tpusim_torch.workloads import build_workload



def forbid_host_route(monkeypatch):
    """Make the port's host route raise, so that a device-route test fails
    when its workload is rerouted (TorchBackend's fallback, run_simulation's
    rules) instead of passing on the host's placements, which match the
    JAX package's by construction."""
    def refuse(*args, **kwargs):
        raise AssertionError("the workload was rerouted to the host route")

    monkeypatch.setattr(port_backend, "ReferenceBackend", refuse)
    monkeypatch.setattr(port_simulator, "ClusterCapacity", refuse)


PODSPEC_YAML = """
- name: A
  num: 10
  pod:
    spec:
      containers:
      - resources:
          requests:
            cpu: 500m
            memory: 512Mi
- name: B
  num: 10
  pod:
    spec:
      containers:
      - resources:
          requests:
            cpu: 2
            memory: 4Gi
"""
# the reference quickstart: byte-granular memory and 100-core pods put its
# plan past the int32 bounds
QUICKSTART_YAML = """
- name: A
  num: 10
  pod:
    spec:
      containers:
      - resources:
          requests:
            cpu: 1
            memory: 1
- name: B
  num: 10
  pod:
    spec:
      containers:
      - resources:
          requests:
            cpu: 100
            memory: 1000
"""


def podspec_pods(api, text):
    parse, expand = ((jax_parse, jax_expand) if api is jax_api
                     else (parse_simulation_pods, expand_simulation_pods))
    return expand(parse(text), deterministic_ids=True)


def quickstart(api):
    pods = podspec_pods(api, PODSPEC_YAML)
    return (api.synthetic_cluster(4, milli_cpu=4000, memory=16 * 1024**3),
            list(reversed(pods)))


def random_uniform(api):
    rng = random.Random(42)
    nodes = [api.make_node(f"n{i}", milli_cpu=rng.choice([2000, 4000, 8000]),
                           memory=rng.choice([4, 8, 16]) * 1024**3,
                           pods=rng.choice([5, 110]))
             for i in range(12)]
    pods = [api.make_pod(f"p{i}", milli_cpu=rng.randrange(0, 30) * 100,
                         memory=rng.randrange(0, 16) * 256 * 2**20)
            for i in range(80)]
    return api.ClusterSnapshot(nodes=nodes), pods


def taints_and_selectors(api):
    rng = random.Random(7)
    nodes = []
    for i in range(10):
        taints = []
        if i % 3 == 0:
            taints.append({"key": "dedicated", "value": "batch", "effect": "NoSchedule"})
        if i % 4 == 0:
            taints.append({"key": "soft", "value": "x", "effect": "PreferNoSchedule"})
        nodes.append(api.make_node(f"n{i}", milli_cpu=4000, memory=8 * 1024**3,
                                   labels={"zone": "a" if i < 5 else "b"},
                                   taints=taints))
    pods = []
    for i in range(60):
        kwargs = {}
        roll = rng.random()
        if roll < 0.3:
            kwargs["node_selector"] = {"zone": rng.choice(["a", "b"])}
        if roll < 0.5:
            kwargs["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                      "value": "batch", "effect": "NoSchedule"}]
        if 0.5 < roll < 0.7:
            kwargs["tolerations"] = [{"key": "soft", "operator": "Exists",
                                      "effect": "PreferNoSchedule"}]
        pods.append(api.make_pod(f"p{i}", milli_cpu=rng.randrange(1, 15) * 100,
                                 memory=rng.randrange(1, 8) * 256 * 2**20,
                                 **kwargs))
    return api.ClusterSnapshot(nodes=nodes), pods


def node_affinity(api):
    nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=8 * 1024**3,
                           labels={"disk": "ssd" if i % 2 == 0 else "hdd",
                                   "zone": f"z{i % 3}"})
             for i in range(9)]
    required = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
        "nodeSelectorTerms": [{"matchExpressions": [
            {"key": "disk", "operator": "In", "values": ["ssd"]}]}]}}}
    preferred = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 3, "preference": {"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["z1"]}]}},
        {"weight": 1, "preference": {"matchExpressions": [
            {"key": "disk", "operator": "Exists"}]}}]}}
    both = {"nodeAffinity": {**required["nodeAffinity"], **preferred["nodeAffinity"]}}
    pods = [api.make_pod(f"p{i}", milli_cpu=300, memory=512 * 2**20,
                         affinity=[None, required, preferred, both][i % 4])
            for i in range(30)]
    return api.ClusterSnapshot(nodes=nodes), pods


def unschedulable_reasons(api):
    nodes = [api.make_node("ok", milli_cpu=1000, memory=1024**3, pods=10),
             api.make_node("down", ready=False, pods=10),
             api.make_node("cordoned", unschedulable=True, pods=10)]
    pods = [api.make_pod("fits", milli_cpu=500),
            api.make_pod("too-big", milli_cpu=5000, memory=8 * 1024**3),
            api.make_pod("fits2", milli_cpu=400),
            api.make_pod("no-room", milli_cpu=500)]
    return api.ClusterSnapshot(nodes=nodes), pods


def scalars_and_gpu(api):
    nodes = [api.make_node("gpu1", milli_cpu=8000, memory=16 * 1024**3, gpus=4,
                           scalars={"example.com/fpga": 2}),
             api.make_node("plain", milli_cpu=8000, memory=16 * 1024**3,
                           scalars={"example.com/fpga": 2})]
    pods = [api.make_pod(f"g{i}", milli_cpu=500, gpus=1) for i in range(6)]
    pods.append(api.make_pod("f0", milli_cpu=100,
                             scalars={"example.com/fpga": 3}))
    return api.ClusterSnapshot(nodes=nodes), pods


def prescheduled(api):
    nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=8 * 1024**3)
             for i in range(4)]
    existing = [api.make_pod(f"e{i}", milli_cpu=1000, memory=1024**3,
                             node_name=f"n{i % 2}", phase="Running")
                for i in range(4)]
    pods = [api.make_pod(f"p{i}", milli_cpu=800, memory=512 * 2**20)
            for i in range(10)]
    return api.ClusterSnapshot(nodes=nodes, pods=existing), pods


def node_only_scalar(api):
    node = api.make_node("n1", milli_cpu=2000, memory=4 * 1024**3,
                         scalars={"example.com/fpga": 2})
    return api.ClusterSnapshot(nodes=[node]), [api.make_pod("p", milli_cpu=100)]


def no_nodes(api):
    return api.ClusterSnapshot(), [api.make_pod("p")]


PARITY = [quickstart, random_uniform, taints_and_selectors, node_affinity,
          unschedulable_reasons, scalars_and_gpu, prescheduled,
          node_only_scalar, no_nodes]


@pytest.mark.parametrize("provider", ["DefaultProvider", "TalkintDataProvider"])
@pytest.mark.parametrize("build", PARITY, ids=[b.__name__ for b in PARITY])
def test_parity_with_jax_and_reference(build, provider):
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    ref = ReferenceBackend(provider=provider).schedule(jpods, jsnap)
    jx = JaxBackend(provider=provider, fallback="error").schedule(jpods, jsnap)
    port = TorchBackend(provider=provider, device="cpu",
                        fallback="error").schedule(ppods, psnap)
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        assert (p.pod.name, p.node_name, p.reason) == \
            (r.pod.name, r.node_name, r.reason)
        assert p.message == r.message
    assert placement_hash(port) == jax_hash(ref) == jax_hash(jx)


def test_run_simulation_split_matches_jax(monkeypatch):
    forbid_host_route(monkeypatch)
    jsnap, jpods = taints_and_selectors(jax_api)
    psnap, ppods = taints_and_selectors(port_api)
    want = jax_run_simulation(jpods, jsnap, backend="jax")
    got = run_simulation(ppods, psnap, device="cpu")

    def split(status):
        return ([(p.name, p.spec.node_name) for p in status.successful_pods],
                [(p.name, p.status.reason, p.status.conditions[-1].message)
                 for p in status.failed_pods],
                status.stop_reason)

    assert split(got) == split(want)
    assert got.failed_pods  # both outcomes exercised


@pytest.mark.parametrize("affinity", [False, True])
def test_config_shape_end_to_end(affinity):
    """build_workload(2_000, 500) through the port and the JAX XLA scan: the
    workload is built seed for seed alike and placed identically (the
    placement golden of the benchmark's form)."""
    jsnap, jpods = bench.build_workload(2_000, 500, affinity=affinity)
    psnap, ppods = build_workload(2_000, 500, affinity=affinity)
    jx = JaxBackend(fallback="error").schedule(jpods, jsnap)
    backend = TorchBackend(device="cpu", fallback="error")
    port = backend.schedule(ppods, psnap)
    assert placement_hash(port) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]
    index = {n.name: i for i, n in enumerate(jsnap.nodes)}
    choices = np.array([index[p.node_name] if p.node_name else -1 for p in jx],
                       dtype=np.int32)
    assert np.array_equal(backend.last_choices, choices)
    assert 0 < int((choices >= 0).sum()) <= 2_000


def _jax_plan_refusal(jsnap, jpods):
    from tpusim.jaxe.fastscan import plan_fast as jax_plan_fast
    from tpusim.jaxe.kernels import config_for as jax_config_for
    from tpusim.jaxe.state import compile_cluster as jax_compile

    compiled, cols = jax_compile(jsnap, jpods)
    plan, why = jax_plan_fast(jax_config_for([compiled], False, 24),
                              compiled, cols)
    assert plan is None
    return why


def assert_scan_parity(jsnap, jpods, psnap, ppods, route="auto"):
    """The port on `route` places like JaxBackend and ReferenceBackend, on
    the scan route."""
    ref = ReferenceBackend().schedule(jpods, jsnap)
    jx = JaxBackend(fallback="error").schedule(jpods, jsnap)
    backend = TorchBackend(device="cpu", route=route)
    port = backend.schedule(ppods, psnap)
    assert backend.last_route == "scan"
    assert [p.message for p in port] == [p.message for p in ref] == \
        [p.message for p in jx]
    assert placement_hash(port) == jax_hash(ref) == jax_hash(jx)
    return backend, port


def test_plan_ineligible_workload_raises():
    """The reference quickstart is past the int32 plan bounds: route="kernel"
    raises with the reason the JAX package's plan_fast gives; the default
    route runs it on the scan, placed like JaxBackend and ReferenceBackend."""
    jsnap = jax_api.synthetic_cluster(4)
    jpods = podspec_pods(jax_api, QUICKSTART_YAML)
    why = _jax_plan_refusal(jsnap, jpods)
    psnap = port_api.synthetic_cluster(4)
    ppods = podspec_pods(port_api, QUICKSTART_YAML)
    with pytest.raises(NotImplementedError) as err:
        TorchBackend(device="cpu", route="kernel").schedule(ppods, psnap)
    assert str(err.value) == f"torch backend: {why}"
    backend, port = assert_scan_parity(jsnap, jpods, psnap, ppods)
    assert backend.last_route_reason == why
    assert 0 < sum(p.scheduled for p in port) < len(port)


def test_group_workload_raises_not_implemented():
    """A hostname-keyed inter-pod workload on 70 nodes has 71 topology
    domains, past the kernel's 64: route="kernel" raises with the reason
    the JAX package's plan_fast gives; the default route runs it on the
    scan, placed like JaxBackend and ReferenceBackend (one web pod a node,
    the rest fail with the inter-pod reason)."""
    def build(api):
        return api.synthetic_cluster(70), [api.make_pod(
            f"p{i}", milli_cpu=100, labels={"app": "web"},
            affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "web"}},
                     "topologyKey": "kubernetes.io/hostname"}]}})
            for i in range(75)]

    jsnap, jpods = build(jax_api)
    why = _jax_plan_refusal(jsnap, jpods)
    assert "71 topology domains exceed" in why
    snap, pods = build(port_api)
    with pytest.raises(NotImplementedError) as err:
        TorchBackend(device="cpu", route="kernel").schedule(pods, snap)
    assert str(err.value) == f"torch backend: {why}"
    _, port = assert_scan_parity(jsnap, jpods, snap, pods)
    assert sum(p.scheduled for p in port) == 70
    assert "didn't match pod affinity/anti-affinity" in port[-1].message


def quickstart_bytes(api):
    pods = podspec_pods(api, QUICKSTART_YAML)
    return (api.synthetic_cluster(4, milli_cpu=4000, memory=16 * 1024**3),
            list(reversed(pods)))


def random_uniform_bytes(api):
    rng = random.Random(42)
    nodes = [api.make_node(f"n{i}", milli_cpu=rng.choice([2000, 4000, 8000]),
                           memory=rng.choice([4, 8, 16]) * 1024**3,
                           pods=rng.choice([5, 110]))
             for i in range(12)]
    pods = [api.make_pod(f"p{i}", milli_cpu=rng.randrange(0, 3000),
                         memory=rng.randrange(0, 4 * 1024**3))
            for i in range(80)]
    return api.ClusterSnapshot(nodes=nodes), pods


def taints_and_selectors_bytes(api):
    snapshot, pods = taints_and_selectors(api)
    rng = random.Random(7)
    return snapshot, [api.make_pod(
        p.name, milli_cpu=rng.randrange(100, 1500),
        memory=rng.randrange(2**20, 2 * 1024**3),
        node_selector=p.spec.node_selector or None,
        tolerations=[t.to_obj() for t in p.spec.tolerations] or None)
        for p in pods]


def unschedulable_reasons_bytes(api):
    nodes = [api.make_node("ok", milli_cpu=1000, memory=1024**3),
             api.make_node("down", ready=False),
             api.make_node("cordoned", unschedulable=True)]
    pods = [api.make_pod("fits", milli_cpu=500, memory=3),
            api.make_pod("too-big", milli_cpu=5000, memory=8 * 1024**3),
            api.make_pod("fits2", milli_cpu=400, memory=12345),
            api.make_pod("no-room", milli_cpu=500)]
    return api.ClusterSnapshot(nodes=nodes), pods


def scalars_and_gpu_bytes(api):
    snapshot, pods = scalars_and_gpu(api)
    pods[0] = api.make_pod("g0", milli_cpu=500, memory=7, gpus=1)
    return snapshot, pods


def prescheduled_bytes(api):
    nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=8 * 1024**3 + 1)
             for i in range(4)]
    existing = [api.make_pod(f"e{i}", milli_cpu=1000, memory=1024**3 + i,
                             node_name=f"n{i % 2}", phase="Running")
                for i in range(4)]
    pods = [api.make_pod(f"p{i}", milli_cpu=800, memory=512 * 2**20 + i)
            for i in range(10)]
    return api.ClusterSnapshot(nodes=nodes, pods=existing), pods


def node_affinity_bytes(api):
    snapshot, pods = node_affinity(api)
    return snapshot, [api.make_pod(p.name, milli_cpu=300,
                                   memory=512 * 2**20 + i,
                                   affinity=p.spec.affinity.to_obj()
                                   if p.spec.affinity else None)
                      for i, p in enumerate(pods)]


ORIGINAL = [quickstart_bytes, random_uniform_bytes, taints_and_selectors_bytes,
            node_affinity_bytes, unschedulable_reasons_bytes,
            scalars_and_gpu_bytes, prescheduled_bytes]


@pytest.mark.parametrize("route", ["auto", "scan"])
@pytest.mark.parametrize("build", ORIGINAL, ids=[b.__name__ for b in ORIGINAL])
def test_byte_granular_shapes_run_on_the_scan(build, route):
    jsnap, jpods = build(jax_api)
    _jax_plan_refusal(jsnap, jpods)
    psnap, ppods = build(port_api)
    assert_scan_parity(jsnap, jpods, psnap, ppods, route)


@pytest.mark.parametrize("build", PARITY[:-1], ids=[b.__name__
                                                    for b in PARITY[:-1]])
def test_routes_agree_where_the_kernel_runs(build):
    """On plans the kernel takes, route="auto" launches it and route="scan"
    places identically."""
    snap, pods = build(port_api)
    kernel = TorchBackend(device="cpu")
    scan = TorchBackend(device="cpu", route="scan")
    got_k, got_s = kernel.schedule(pods, snap), scan.schedule(pods, snap)
    assert (kernel.last_route, scan.last_route) == ("kernel", "scan")
    assert placement_hash(got_k) == placement_hash(got_s)
    assert [p.message for p in got_k] == [p.message for p in got_s]


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        TorchBackend(device="cpu", route="xla")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBackend()
    with pytest.raises(RuntimeError):
        run_simulation([port_api.make_pod("p")], port_api.synthetic_cluster(1))
    with pytest.raises(ValueError):
        TorchBackend(device="meta")


def test_cli_report_matches_jax_cli(tmp_path, capsys, monkeypatch):
    forbid_host_route(monkeypatch)
    from tpusim.cli import main as jax_main
    from tpusim_torch.cli import main as port_main

    spec = tmp_path / "pods.yaml"
    spec.write_text(PODSPEC_YAML)
    common = ["--podspec", str(spec), "--synthetic-nodes", "4"]
    assert jax_main(common + ["--backend", "jax"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_main(common + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    # everything but the summary line (engine name and timing) is identical
    assert got[:-2] == want[:-2] and got[-1] == want[-1]
    assert "unschedulable" in got[-2] and "torch backend" in got[-2]
    assert "Successful Pods" in got[0]
