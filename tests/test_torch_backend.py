"""TorchBackend (CPU: the plain kernel versions) against the JAX package's
JaxBackend and ReferenceBackend: identical placement hashes and
byte-identical FitError text on the group-free parity workloads, the same
simulation split, the same CLI report.

The workloads are the group-free shapes of tests/test_jax_parity.py, with
memory and cpu in coarser units (and a few small pod limits) so that their
int32 plan fits the fused scan's bounds: the byte-granular originals are
refused by the JAX package's plan_fast too, which then takes its XLA scan, a
route the port does not carry yet; the port raises for them instead
(test_plan_ineligible_workload_raises).
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
from tpusim_torch.api.podspec import expand_simulation_pods, parse_simulation_pods
from tpusim_torch.backend import TorchBackend, placement_hash
from tpusim_torch.simulator import run_simulation
from tpusim_torch.workloads import build_workload

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
    port = TorchBackend(provider=provider, device="cpu").schedule(ppods, psnap)
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        assert (p.pod.name, p.node_name, p.reason) == \
            (r.pod.name, r.node_name, r.reason)
        assert p.message == r.message
    assert placement_hash(port) == jax_hash(ref) == jax_hash(jx)


def test_run_simulation_split_matches_jax():
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
    backend = TorchBackend(device="cpu")
    port = backend.schedule(ppods, psnap)
    assert placement_hash(port) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]
    index = {n.name: i for i, n in enumerate(jsnap.nodes)}
    choices = np.array([index[p.node_name] if p.node_name else -1 for p in jx],
                       dtype=np.int32)
    assert np.array_equal(backend.last_choices, choices)
    assert 0 < int((choices >= 0).sum()) <= 2_000


def test_plan_ineligible_workload_raises():
    """The reference quickstart is past the int32 plan bounds: the port
    raises with the reason the JAX package's plan_fast gives."""
    from tpusim.jaxe.fastscan import plan_fast as jax_plan_fast
    from tpusim.jaxe.kernels import config_for as jax_config_for
    from tpusim.jaxe.state import compile_cluster as jax_compile

    jpods = podspec_pods(jax_api, QUICKSTART_YAML)
    compiled, cols = jax_compile(jax_api.synthetic_cluster(4), jpods)
    plan, why = jax_plan_fast(jax_config_for([compiled], False, 24),
                              compiled, cols)
    assert plan is None
    ppods = podspec_pods(port_api, QUICKSTART_YAML)
    with pytest.raises(NotImplementedError, match=why):
        TorchBackend(device="cpu").schedule(ppods,
                                            port_api.synthetic_cluster(4))


def test_group_workload_raises_not_implemented():
    """A hostname-keyed inter-pod workload on 70 nodes has 71 topology
    domains, past the kernel's 64: the port raises with the reason the JAX
    package's plan_fast gives (JAX sends it to its XLA scan, which the port
    does not have)."""
    from tpusim.jaxe.fastscan import plan_fast as jax_plan_fast
    from tpusim.jaxe.kernels import config_for as jax_config_for
    from tpusim.jaxe.state import compile_cluster as jax_compile

    def build(api):
        return api.synthetic_cluster(70), [api.make_pod(
            "p", milli_cpu=100, labels={"app": "web"},
            affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "web"}},
                     "topologyKey": "kubernetes.io/hostname"}]}})]

    jsnap, jpods = build(jax_api)
    compiled, cols = jax_compile(jsnap, jpods)
    plan, why = jax_plan_fast(jax_config_for([compiled], False, 24),
                              compiled, cols)
    assert plan is None and "71 topology domains exceed" in why
    snap, pods = build(port_api)
    with pytest.raises(NotImplementedError) as err:
        TorchBackend(device="cpu").schedule(pods, snap)
    assert str(err.value) == f"torch backend: {why}"


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBackend()
    with pytest.raises(RuntimeError):
        run_simulation([port_api.make_pod("p")], port_api.synthetic_cluster(1))
    with pytest.raises(ValueError):
        TorchBackend(device="meta")


def test_cli_report_matches_jax_cli(tmp_path, capsys):
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
