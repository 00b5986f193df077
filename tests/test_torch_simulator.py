"""The port's run_simulation on the host route (the ClusterCapacity
orchestrator) against the JAX package's run_simulation(backend="reference"):
the same split (placements, FitError text, stop reason) and the same
preempted pods on the quickstart, config 6's priority bands, the volume
scheduling fixtures of tests/test_volumes.py, both registry-surgery feature
gates, a gang feed and the equivalence cache on and off. Then every routing
rule of run_simulation, and the CLI's host route and snapshot sources.

Each run gets a fresh build: the orchestrator writes Unschedulable
conditions and nominated node names onto the pods fed to it.
"""

import json
import logging
import re

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.cli import main as jax_main
from tpusim.simulator import ClusterCapacity as JaxClusterCapacity
from tpusim.simulator import SchedulerServerConfig as JaxConfig
from tpusim.simulator import run_simulation as jax_run

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.cli import main as port_main
from tpusim_torch.engine.policy import decode_policy as port_decode
from tpusim_torch.gang import GANG_NAME_ANNOTATION
from tpusim_torch.simulator import (
    ClusterCapacity,
    SchedulerServerConfig,
    auto_routes_to_host,
    run_simulation,
)
from tpusim_torch.workloads import build_workload
from test_torch_backend import (
    PODSPEC_YAML,
    QUICKSTART_YAML,
    forbid_host_route,
    podspec_pods,
)
from test_torch_gang import FIT_TEXT, gang_feed
from test_torch_policy import COMPAT, compat_build, drop_node_transport

ZONE = "failure-domain.beta.kubernetes.io/zone"
SIM = "tpusim_torch.simulator"


def split(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.reason, p.status.conditions[-1].message)
             for p in status.failed_pods],
            [p.name for p in status.preempted_pods],
            [p.name for p in status.scheduled_pods],
            status.stop_reason)


def assert_host_parity(build, **kwargs):
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    want = jax_run(jpods, jsnap, backend="reference", **kwargs)
    got = run_simulation(ppods, psnap, backend="reference", **kwargs)
    assert split(got) == split(want)
    return got


def quickstart(api):
    return (api.synthetic_cluster(4, milli_cpu=4000, memory=16 * 1024**3),
            podspec_pods(api, QUICKSTART_YAML))


def test_quickstart():
    status = assert_host_parity(quickstart)
    assert status.successful_pods and status.failed_pods


@pytest.mark.parametrize("num_pods,num_nodes", [(600, 30), (900, 30)])
def test_config6_priority_bands(num_pods, num_nodes):
    """Config 6's shape, small: priority bands with PodPriority on. At 900
    pods the cluster saturates and late high-priority pods preempt."""
    def build(api):
        snapshot, pods = build_workload(num_pods, num_nodes, affinity=True,
                                        priorities=True, api=api)
        return snapshot, pods

    status = assert_host_parity(build, enable_pod_priority=True)
    if num_pods == 900:
        assert len(status.preempted_pods) > 0


# --- the volume fixtures of tests/test_volumes.py, through `api` ---


def _volume_snapshot(api):
    nodes = [api.make_node(f"n{i}", labels={
        ZONE: "us-west1-a" if i < 2 else "us-west1-b"}) for i in range(4)]
    pvs = [api.make_pv("vol-a", labels={ZONE: "us-west1-a"}),
           api.make_pv("vol-b", labels={ZONE: "us-west1-b"})]
    pvcs = [api.make_pvc("claim-a", volume_name="vol-a"),
            api.make_pvc("claim-b", volume_name="vol-b")]
    return api.ClusterSnapshot(nodes=nodes, pvs=pvs, pvcs=pvcs)


def zone_constrained(api):
    return _volume_snapshot(api), [
        api.make_pod("pod-a", milli_cpu=100,
                     volumes=[api.make_pod_volume("v", pvc="claim-a")]),
        api.make_pod("pod-b", milli_cpu=100,
                     volumes=[api.make_pod_volume("v", pvc="claim-b")])]


def disk_conflict(api):
    disk = {"gcePersistentDisk": {"pdName": "shared"}}
    return api.ClusterSnapshot(nodes=[api.make_node("n0"),
                                      api.make_node("n1")]), [
        api.make_pod(f"p{i}", milli_cpu=10, volumes=[
            api.make_pod_volume("v", source=dict(disk))]) for i in range(3)]


def max_pd(api):
    return api.ClusterSnapshot(nodes=[api.make_node("n0")]), [
        api.make_pod(f"p{i}", milli_cpu=10, volumes=[api.make_pod_volume(
            "v", source={"awsElasticBlockStore": {"volumeID": f"vol{i}"}})])
        for i in range(2)]


def _wait_pv(api, name, zone):
    return api.make_pv(name, storage="5Gi", storage_class="wait",
                       node_affinity_terms=[{"matchExpressions": [
                           {"key": "zone", "operator": "In",
                            "values": [zone]}]}])


def volume_scheduling_gate(api):
    classes = [api.make_storage_class("wait",
                                      binding_mode="WaitForFirstConsumer")]
    nodes = [api.make_node("n0", labels={"zone": "a"}),
             api.make_node("n1", labels={"zone": "b"})]
    pvcs = [api.make_pvc("c1", storage="1Gi", storage_class="wait"),
            api.make_pvc("c2", storage="1Gi", storage_class="wait")]
    snapshot = api.ClusterSnapshot(nodes=nodes, pvs=[_wait_pv(api, "pv-a",
                                                              "a")],
                                   pvcs=pvcs, storage_classes=classes)
    return snapshot, [api.make_pod(f"p{i}", milli_cpu=10, volumes=[
        api.make_pod_volume("v", pvc=f"c{i}")]) for i in (1, 2)]


def _binding_one(api, pvs, pvcs, volumes):
    classes = [api.make_storage_class("wait",
                                      binding_mode="WaitForFirstConsumer")]
    node = api.make_node("machine1", labels={"zone": "a"})
    snapshot = api.ClusterSnapshot(nodes=[node], pvs=pvs, pvcs=pvcs,
                                   storage_classes=classes)
    return snapshot, [api.make_pod("foo", milli_cpu=10, volumes=[
        api.make_pod_volume(f"v{i}", pvc=c) for i, c in enumerate(volumes)])]


def binding_all_bound(api):
    return _binding_one(api, [_wait_pv(api, "pv-ok", "a")], [
        api.make_pvc("claim", storage="1Gi", storage_class="wait",
                     volume_name="pv-ok")], ["claim"])


def binding_invalid_pv_affinity(api):
    return _binding_one(api, [_wait_pv(api, "pv-wrong", "other")], [
        api.make_pvc("claim", storage="1Gi", storage_class="wait",
                     volume_name="pv-wrong")], ["claim"])


def binding_unbound_no_matches(api):
    return _binding_one(api, [], [
        api.make_pvc("claim", storage="1Gi", storage_class="wait")],
        ["claim"])


def binding_bound_and_unbound(api):
    return _binding_one(api, [_wait_pv(api, "pv-wrong", "other")], [
        api.make_pvc("bound-claim", storage="1Gi", storage_class="wait",
                     volume_name="pv-wrong"),
        api.make_pvc("unbound-claim", storage="1Gi", storage_class="wait")],
        ["bound-claim", "unbound-claim"])


VOLUME_BUILDS = [zone_constrained, disk_conflict, max_pd]
BINDING_BUILDS = [volume_scheduling_gate, binding_all_bound,
                  binding_invalid_pv_affinity, binding_unbound_no_matches,
                  binding_bound_and_unbound]


@pytest.mark.parametrize("build", VOLUME_BUILDS,
                         ids=[b.__name__ for b in VOLUME_BUILDS])
def test_volume_fixtures(build, monkeypatch):
    monkeypatch.setenv("KUBE_MAX_PD_VOLS", "1")
    assert_host_parity(build)


@pytest.mark.parametrize("build", BINDING_BUILDS,
                         ids=[b.__name__ for b in BINDING_BUILDS])
def test_volume_scheduling_fixtures(build):
    status = assert_host_parity(build, enable_volume_scheduling=True)
    assert status.successful_pods or status.failed_pods
    # the gate given as a feature gate does the same
    assert split(assert_host_parity(
        build, feature_gates={"VolumeScheduling": True})) == split(status)


def tainted_condition(api):
    """Nodes with taints and a not-ready condition: TaintNodesByCondition
    swaps CheckNodeCondition for a mandatory taint check."""
    nodes = []
    for i in range(6):
        kw = {}
        if i % 3 == 0:
            kw["taints"] = [{"key": "node.kubernetes.io/not-ready",
                             "effect": "NoSchedule"}]
        node = api.make_node(f"n{i}", milli_cpu=2000, **kw)
        if i == 4:
            obj = node.to_obj()
            obj["status"]["conditions"] = [{"type": "Ready",
                                            "status": "False"}]
            node = api.Node.from_obj(obj)
        nodes.append(node)
    pods = [api.make_pod(f"p{i}", milli_cpu=700, tolerations=[{
        "key": "node.kubernetes.io/not-ready", "operator": "Exists",
        "effect": "NoSchedule"}] if i % 4 == 0 else None) for i in range(20)]
    return api.ClusterSnapshot(nodes=nodes), pods


@pytest.mark.parametrize("gate", ["TaintNodesByCondition",
                                  "ResourceLimitsPriorityFunction"])
def test_registry_surgery_gates(gate):
    status = assert_host_parity(tainted_condition, feature_gates={gate: True})
    assert status.failed_pods and status.successful_pods
    if gate == "TaintNodesByCondition":
        # the not-ready node without a taint takes pods once its condition
        # check is gone
        assert split(status) != split(assert_host_parity(tainted_condition))


@pytest.mark.parametrize("gate", ["TaintNodesByCondition",
                                  "ResourceLimitsPriorityFunction"])
def test_gates_reroute_torch_to_the_host(gate, caplog):
    snapshot, pods = tainted_condition(port_api)
    with caplog.at_level(logging.WARNING, logger=SIM):
        got = run_simulation(pods, snapshot, device="cpu",
                             feature_gates={gate: True})
    assert caplog.messages == [
        f"feature gates ['{gate}'] are host-bound: running the reference "
        "orchestrator instead of the torch backend"]
    jsnap, jpods = tainted_condition(jax_api)
    assert split(got) == split(jax_run(jpods, jsnap, backend="reference",
                                       feature_gates={gate: True}))


def test_gang_feed_admits_all_or_nothing():
    status = assert_host_parity(gang_feed)
    assert not status.successful_pods and len(status.failed_pods) == 4
    for pod in status.failed_pods:
        assert FIT_TEXT in pod.status.conditions[-1].message


def test_gang_with_priority_goes_to_the_host(caplog):
    snapshot, pods = gang_feed(port_api)
    with caplog.at_level(logging.WARNING, logger=SIM):
        got = run_simulation(pods, snapshot, device="cpu",
                             enable_pod_priority=True)
    assert caplog.messages == [
        "pod groups with PodPriority are host-bound: running the reference "
        "orchestrator instead of the torch backend"]
    jsnap, jpods = gang_feed(jax_api)
    assert split(got) == split(jax_run(jpods, jsnap, backend="jax",
                                       enable_pod_priority=True))


@pytest.mark.parametrize("ecache", [False, True])
@pytest.mark.parametrize("policy", [None, "1.2"])
def test_equivalence_cache(ecache, policy):
    def run(api, cc, config, decode):
        snapshot, pods = compat_build(api)
        pol = decode(COMPAT[policy]) if policy else None
        sim = cc(config(enable_equivalence_cache=ecache, policy=pol),
                 new_pods=pods, scheduled_pods=snapshot.pods,
                 nodes=snapshot.nodes, services=snapshot.services)
        sim.run()
        return split(sim.status)

    from tpusim.engine.policy import decode_policy as jax_decode

    assert run(port_api, ClusterCapacity, SchedulerServerConfig,
               port_decode) == run(jax_api, JaxClusterCapacity, JaxConfig,
                                   jax_decode)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_auto_threshold(monkeypatch):
    assert auto_routes_to_host(20, 4)
    assert not auto_routes_to_host(100, 1000)
    assert auto_routes_to_host(100, 1000, enable_volume_scheduling=True)
    monkeypatch.setenv("TPUSIM_AUTO_THRESHOLD", "80")
    assert auto_routes_to_host(20, 3) and not auto_routes_to_host(20, 4)


@pytest.mark.parametrize("threshold,route", [("81", "reference"),
                                             ("80", "torch")])
def test_auto_routes_at_the_threshold(monkeypatch, threshold, route):
    """20 pods on 4 nodes are 80 pairs: under a threshold of 81 they run on
    the host; at 80 on torch, where the default device needs a card."""
    monkeypatch.setenv("TPUSIM_AUTO_THRESHOLD", threshold)
    snapshot, pods = quickstart(port_api)
    want = jax_run(*reversed(quickstart(jax_api)), backend="reference")
    if route == "reference":
        got = run_simulation(pods, snapshot, backend="auto")
        assert split(got) == split(want)
    else:
        with monkeypatch.context() as patch:
            forbid_host_route(patch)
            got = run_simulation(pods, snapshot, backend="auto",
                                 device="cpu")
        assert split(got)[:2] == split(want)[:2]
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_simulation(pods, snapshot, backend="auto")


def test_volume_scheduling_on_torch_raises():
    snapshot, pods = quickstart(port_api)
    with pytest.raises(ValueError) as err:
        run_simulation(pods, snapshot, device="cpu",
                       enable_volume_scheduling=True)
    jsnap, jpods = quickstart(jax_api)
    with pytest.raises(ValueError) as jerr:
        jax_run(jpods, jsnap, backend="jax", enable_volume_scheduling=True)
    assert str(err.value) == str(jerr.value)
    # auto sends it to the host, like the JAX package
    status = run_simulation(pods, snapshot, backend="auto",
                            enable_volume_scheduling=True)
    assert status.successful_pods


def config6_saturated(api):
    return build_workload(900, 30, affinity=True, priorities=True, api=api)


@pytest.mark.parametrize("build", [quickstart, config6_saturated])
def test_pod_priority_on_torch_raises(build, monkeypatch):
    """PodPriority on torch used to raise; it now runs the preemption
    hybrid, and both forms of the gate give the JAX package's hybrid's
    split, preempted pods included, without the host orchestrator's loop.
    The name is kept on purpose, so the test's history stays one record:
    nothing raises any more."""
    jsnap, jpods = build(jax_api)
    want = split(jax_run(jpods, jsnap, backend="jax",
                         enable_pod_priority=True))
    monkeypatch.setattr(ClusterCapacity, "run", lambda self: pytest.fail(
        "the host orchestrator ran"))
    for kwargs in ({"enable_pod_priority": True},
                   {"feature_gates": {"PodPriority": True}}):
        snapshot, pods = build(port_api)
        got = run_simulation(pods, snapshot, device="cpu", **kwargs)
        assert split(got) == want
    assert bool(want[2]) == (build is config6_saturated)


# a label predicate under the mandatory predicate's name: host-bound, and
# runnable with no extender
LABEL_OVER_CONDITION = {"kind": "Policy", "predicates": [
    {"name": "CheckNodeCondition", "argument": {"labelsPresence": {
        "labels": ["foo"], "presence": True}}},
    {"name": "PodFitsResources"}]}


@pytest.mark.parametrize("policy,priority,reason", [
    (LABEL_OVER_CONDITION, False,
     "label predicate replacing the mandatory CheckNodeCondition"),
    (COMPAT["1.2"], True, "preemption with a policy scheduler"),
])
def test_host_bound_policies_reroute(policy, priority, reason, caplog):
    from tpusim.engine.policy import decode_policy as jax_decode

    snapshot, pods = compat_build(port_api)
    with caplog.at_level(logging.WARNING, logger=SIM):
        got = run_simulation(pods, snapshot, device="cpu",
                             policy=port_decode(policy),
                             enable_pod_priority=priority)
    assert caplog.messages == [
        f"policy is host-bound ({reason}): running the reference "
        "orchestrator instead of the torch backend"]
    jsnap, jpods = compat_build(jax_api)
    assert split(got) == split(jax_run(
        jpods, jsnap, backend="jax", policy=jax_decode(policy),
        enable_pod_priority=priority))
    assert got.successful_pods


@pytest.mark.parametrize("backend", ["torch", "reference"])
def test_extender_transport_reaches_the_host_route(backend, caplog):
    """A policy's filter extender, served in process through
    run_simulation's extender_transport: on either backend it runs on the
    host orchestrator and places as the JAX package's ClusterCapacity does
    with the same transport, with no network call."""
    from tpusim.engine.policy import decode_policy as jax_decode

    ext = {"kind": "Policy", "predicates": [{"name": "PodFitsResources"}],
           "extenders": [{"urlPrefix": "http://extender.invalid",
                          "filterVerb": "filter"}]}
    snapshot, pods = compat_build(port_api)
    dropped = snapshot.nodes[0].name
    with caplog.at_level(logging.WARNING, logger=SIM):
        got = run_simulation(pods, snapshot, backend=backend, device="cpu",
                             policy=port_decode(ext),
                             extender_transport=drop_node_transport(dropped))
    assert bool(caplog.messages) == (backend == "torch")
    jsnap, jpods = compat_build(jax_api)
    want = JaxClusterCapacity(
        JaxConfig(policy=jax_decode(ext),
                  extender_transport=drop_node_transport(dropped)),
        new_pods=jpods, scheduled_pods=jsnap.pods, nodes=jsnap.nodes,
        services=jsnap.services)
    want.run()
    assert split(got) == split(want.status)
    assert got.successful_pods and dropped not in {
        p.spec.node_name for p in got.successful_pods}


def test_unknown_backend():
    snapshot, pods = quickstart(port_api)
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        run_simulation(pods, snapshot, backend="jax")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TIMING = re.compile(r"\d+\.\d+s, \d+ pods/s")


def cli_lines(main, argv, capsys):
    assert main(argv) == 0
    return [TIMING.sub("", line) for line in capsys.readouterr().out
            .splitlines()]


@pytest.mark.parametrize("extra", [[], ["--enable-pod-priority"],
                                   ["--feature-gates",
                                    "TaintNodesByCondition=true"]])
def test_cli_reference_report_matches_jax_cli(tmp_path, capsys, extra):
    spec = tmp_path / "pods.yaml"
    spec.write_text(PODSPEC_YAML)
    argv = ["--podspec", str(spec), "--synthetic-nodes", "4",
            "--backend", "reference"] + extra
    want = cli_lines(jax_main, argv, capsys)
    got = cli_lines(port_main, argv, capsys)
    assert got == want
    assert "[reference backend, ]" in got[-2]


def test_cli_snapshot_sources(tmp_path, capsys):
    snapshot, _ = compat_build(port_api)
    path = tmp_path / "cluster.json"
    snapshot.save(str(path))
    loaded = port_api.ClusterSnapshot.load(str(path))
    assert loaded.to_obj() == snapshot.to_obj()
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([{"name": "small", "num": 12, "pod": {
        "metadata": {"labels": {"app": "app0"}},
        "spec": {"containers": [{"resources": {"requests": {
            "cpu": "700m", "memory": "1Gi"}}}]}}}]))
    for backend in ("reference", "auto"):
        argv = ["--podspec", str(spec), "--snapshot", str(path),
                "--backend", backend]
        want = cli_lines(jax_main, argv, capsys)
        assert cli_lines(port_main, argv, capsys) == want
    assert "4 pre-scheduled" in want[-2]
    got = cli_lines(port_main, ["--podspec", str(spec), "--snapshot",
                                str(path), "--device", "cpu"], capsys)
    assert got[:-2] == want[:-2] and "torch backend on cpu" in got[-2]
    # nodes.json and pods.json checkpoints
    nodes, pods = tmp_path / "nodes.json", tmp_path / "running.json"
    nodes.write_text(json.dumps([n.to_obj() for n in snapshot.nodes]))
    pods.write_text(json.dumps([p.to_obj() for p in snapshot.pods]))
    argv = ["--podspec", str(spec), "--nodes", str(nodes), "--pods",
            str(pods), "--backend", "reference"]
    assert cli_lines(port_main, argv, capsys) == cli_lines(jax_main, argv,
                                                            capsys)


def test_cli_refusals_exit_2(tmp_path, capsys):
    spec = tmp_path / "pods.yaml"
    spec.write_text(PODSPEC_YAML)
    common = ["--podspec", str(spec), "--synthetic-nodes", "4",
              "--device", "cpu"]
    assert port_main(common + ["--feature-gates", "Bogus=true"]) == 2
    assert "unrecognized feature gate: Bogus" in capsys.readouterr().err
    assert port_main(common + ["--enable-volume-scheduling"]) == 2
    assert "requires --backend reference" in capsys.readouterr().err
    assert port_main(["--podspec", str(spec)]) == 2
    assert "no cluster nodes" in capsys.readouterr().err


def test_cli_pod_priority_on_torch(tmp_path, capsys):
    """--enable-pod-priority on backend torch runs the hybrid and prints the
    JAX package's report on backend jax (the engine line aside)."""
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([
        {"name": name, "num": num, "pod": {"spec": {
            "priority": priority, "containers": [{"resources": {
                "requests": {"cpu": cpu, "memory": "1Gi"}}}]}}}
        for name, num, priority, cpu in (("high", 3, 100, "3"),
                                         ("low", 8, 0, "1500m"))]))
    argv = ["--podspec", str(spec), "--synthetic-nodes", "4",
            "--enable-pod-priority"]
    want = cli_lines(jax_main, argv + ["--backend", "jax"], capsys)
    got = cli_lines(port_main, argv + ["--device", "cpu"], capsys)
    assert got[:-2] + got[-1:] == want[:-2] + want[-1:]
    assert "torch backend on cpu" in got[-2] and "jax backend" in want[-2]
    # the three high pods preempt six of the eight low ones
    assert "5 pod(s) scheduled, 0 unschedulable" in got[-2]


def test_cli_gang_podspec_on_the_host(tmp_path, capsys):
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([{"name": "g1", "num": 4, "pod": {
        "metadata": {"annotations": {GANG_NAME_ANNOTATION: "g1"}},
        "spec": {"containers": [{"resources": {"requests": {
            "cpu": "3"}}}]}}}]))
    argv = ["--podspec", str(spec), "--synthetic-nodes", "3",
            "--synthetic-milli-cpu", "4000", "--backend", "reference"]
    want = cli_lines(jax_main, argv, capsys)
    assert cli_lines(port_main, argv, capsys) == want
    assert "0 pod(s) scheduled, 4 unschedulable" in want[-2]
