"""The port's chaos layer (tpusim_torch/chaos/, the device breaker of
backend.py, the host chaos of simulator.py, the REST client's fault seam)
against the JAX package's (tpusim/chaos/), on the CPU.

The same plans, made from the same seeds, must give the same plan JSON, the
same PlanError text, the same breaker transition trail and the same
corrupted arrays; run_simulation with churn and fabric faults on the host
route must give the JAX package's split, chaos_summary and
chaos_violations; device-only plans on backend "torch" (routes "kernel",
the plain version on the CPU, and "scan") must give the JAX package's
placements and breaker trail under both verify modes, the JAX side running
its XLA route. A kernel error that is not a chaos.engine.DeviceFault raises
under chaos. Tolerance: exact (strings, hashes and integer arrays equal).
"""

import json

import numpy as np
import pytest

import tpusim.api.snapshot as jax_api
import tpusim.chaos as jax_chaos
from tpusim.chaos import engine as jax_engine
from tpusim.chaos import plan as jax_plan
from tpusim.cli import main as jax_main
from tpusim.framework.metrics import register as jax_register
from tpusim.framework.restclient import FakeRESTClient as JaxClient
from tpusim.framework.store import ResourceStore as JaxStore
from tpusim.gang.group import mark_gang as jax_mark_gang
from tpusim.jaxe.backend import uninstall_chaos as jax_uninstall
from tpusim.simulator import run_simulation as jax_run

import tpusim_torch.api.snapshot as port_api
import tpusim_torch.backend as port_backend
import tpusim_torch.chaos as port_chaos
from tpusim_torch.api.types import ResourceType
from tpusim_torch.backend import TorchBackend, install_chaos, uninstall_chaos
from tpusim_torch.chaos import engine as port_engine
from tpusim_torch.chaos import plan as port_plan
from tpusim_torch.cli import main as port_main
from tpusim_torch.framework.metrics import register as port_register
from tpusim_torch.framework.restclient import FakeRESTClient
from tpusim_torch.framework.store import ResourceStore
from tpusim_torch.gang.group import mark_gang
from tpusim_torch.simulator import run_simulation
from test_torch_gang import report_lines
from test_torch_simulator import split

SEEDS = (0, 1, 2, 7, 13, 42)


@pytest.fixture(autouse=True)
def _no_chaos_seam():
    """The seams are process-wide: no test leaves one armed."""
    uninstall_chaos()
    jax_uninstall()
    yield
    uninstall_chaos()
    jax_uninstall()


def workload(api, num_nodes=4, num_pods=8):
    return (api.synthetic_cluster(num_nodes),
            [api.make_pod(f"p{i}", milli_cpu=400, memory=1024**3)
             for i in range(num_pods)])


def gang_workload(api, mark):
    nodes = [api.make_node(f"node-{i}", milli_cpu=4000,
                           labels={"topology.kubernetes.io/rack":
                                   f"rack-{i // 2}"})
             for i in range(6)]
    pods = [api.make_pod(f"s{i}", milli_cpu=200) for i in range(4)]
    pods += [mark(api.make_pod(f"g-{j}", milli_cpu=800), "g")
             for j in range(4)]
    return api.ClusterSnapshot(nodes=nodes, pods=[]), pods


# --- plans ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_random_plans_equal(seed):
    nodes = [f"node-{i}" for i in range(5)]
    pods = [f"default/p{i}" for i in range(9)]
    for kw in ({}, {"keep_nodes": 0},
               {"device_dispatches": 6, "max_retries": 1}):
        want = jax_plan.random_plan(seed, nodes, pods, attempts=9, **kw)
        got = port_plan.random_plan(seed, nodes, pods, attempts=9, **kw)
        assert got.to_json() == want.to_json()
        assert port_plan.FaultPlan.from_obj(json.loads(got.to_json())) == got
    assert (port_plan.random_crash_plan(seed, 12).to_json()
            == jax_plan.random_crash_plan(seed, 12).to_json())
    assert ([p.to_json() for p in port_plan.kill_leader_campaign(seed, 9)]
            == [p.to_json() for p in jax_plan.kill_leader_campaign(seed, 9)])


def test_plan_round_trip_and_load(tmp_path):
    obj = {"seed": 42, "max_retries": 3,
           "churn": [{"at": 2, "action": "node_delete", "target": "node-1"},
                     {"at": 4, "action": "node_flap", "target": "node-0",
                      "restore_after": 2},
                     {"at": 6, "action": "process_crash", "target": "bind"}],
           "fabric": {"drop": [4], "dup": [7], "disconnect": [9]},
           "device": {"faults": {"0": "exception", "1": "corrupt_silent"},
                      "failure_threshold": 2, "cooldown": 2,
                      "verify": "probe"}}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(obj))
    got = port_chaos.load_plan(str(path))
    want = jax_chaos.load_plan(str(path))
    assert got.to_json() == want.to_json()
    assert got.to_obj() == want.to_obj()
    assert got.host_sections_empty() == want.host_sections_empty()
    assert ([e.at for e in got.crash_events()]
            == [e.at for e in want.crash_events()])
    assert port_plan.CRASH_POINTS == jax_plan.CRASH_POINTS


BAD_PLANS = [
    [],
    {"bogus": 1},
    {"churn": [{"at": 1, "action": "explode", "target": "n"}]},
    {"churn": [{"at": -1, "action": "node_delete", "target": "n"}]},
    {"churn": [{"at": 1, "action": "node_flap", "target": "n"}]},
    {"churn": [{"at": 1, "action": "process_crash", "target": "n"}]},
    {"churn": [{"at": 1, "action": "node_delete"}]},
    {"churn": ["x"]},
    {"fabric": {"drop": [1], "dup": [1]}},
    {"fabric": {"drop": [-1]}},
    {"fabric": [1]},
    {"device": {"faults": {"0": "melt"}}},
    {"device": {"faults": {"-1": "exception"}}},
    {"device": {"failure_threshold": 0}},
    {"device": {"cooldown": 0}},
    {"device": {"verify": "some"}},
    {"device": "x"},
]


@pytest.mark.parametrize("obj", BAD_PLANS, ids=range(len(BAD_PLANS)))
def test_plan_errors_word_for_word(obj):
    with pytest.raises(jax_plan.PlanError) as want:
        jax_plan.FaultPlan.from_obj(obj)
    with pytest.raises(port_plan.PlanError) as got:
        port_plan.FaultPlan.from_obj(obj)
    assert str(got.value) == str(want.value)


# --- breaker and injectors -------------------------------------------------


BREAKER_SCRIPT = "fsfffaaaasfaaasaaffaaas"


@pytest.mark.parametrize("threshold,cooldown", [(1, 1), (2, 3), (3, 2)])
def test_breaker_trail(threshold, cooldown):
    """One script of failures (f), successes (s) and allow() calls (a) on
    both breakers: the same answers, states and transition trail, and the
    port's gauges move as the JAX package's."""
    before = dict(port_register().breaker_transitions.values)
    jbefore = dict(jax_register().breaker_transitions.values)
    got = port_chaos.CircuitBreaker("device", threshold, cooldown)
    want = jax_chaos.CircuitBreaker("device", threshold, cooldown)
    for step in BREAKER_SCRIPT:
        if step == "f":
            got.record_failure("x")
            want.record_failure("x")
        elif step == "s":
            got.record_success()
            want.record_success()
        else:
            assert got.allow() == want.allow()
        assert got.state.value == want.state.value
        assert got.probing == want.probing
    assert got.transitions == want.transitions
    assert got.transitions, "the script must move the breaker"
    delta = {k: v - before.get(k, 0)
             for k, v in port_register().breaker_transitions.values.items()}
    jdelta = {k: v - jbefore.get(k, 0)
              for k, v in jax_register().breaker_transitions.values.items()}
    assert {k: v for k, v in delta.items() if v} \
        == {k: v for k, v in jdelta.items() if v}
    assert port_register().breaker_state.value \
        == jax_register().breaker_state.value


@pytest.mark.parametrize("kind", ["corrupt_invalid", "corrupt_silent"])
def test_corrupt_equal(kind):
    rng = np.random.RandomState(3)
    choices = rng.randint(-1, 40, size=17).astype(np.int32)
    counts = rng.randint(0, 9, size=(17, 11)).astype(np.int64)
    got = port_engine.DeviceInjector.corrupt(kind, choices, counts)
    want = jax_engine.DeviceInjector.corrupt(kind, choices, counts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype
    with pytest.raises(ValueError) as err:
        port_engine.DeviceInjector.corrupt("melt", choices, counts)
    assert str(err.value) == "unknown corruption kind 'melt'"


def test_device_injector_script():
    faults = {0: "exception", 2: "corrupt_silent", 3: "corrupt_invalid"}
    got = port_engine.DeviceInjector(faults)
    want = jax_engine.DeviceInjector(faults)
    for _ in range(5):
        outcome = []
        for inj, exc in ((got, port_engine.InjectedDeviceError),
                         (want, jax_engine.InjectedDeviceError)):
            try:
                outcome.append(inj.begin_dispatch())
            except exc as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    assert got.injected == want.injected
    assert issubclass(port_engine.DeviceOutputError, port_engine.DeviceFault)
    assert not issubclass(port_engine.ProcessCrash, port_engine.DeviceFault)


def _fan_out(client_cls, store_cls, api, injector):
    """Three watchers over one store behind a FabricInjector: the frames
    each receives, or the error that tore its stream."""
    store = store_cls()
    client = client_cls(store)
    client.fault_injector = injector
    bufs = [client.get().resource("nodes").watch() for _ in range(3)]
    nodes = [api.make_node(f"n{i}") for i in range(4)]
    rt = _rt(api)
    for node in nodes:
        store.add(rt.NODES, node)
    store.delete(rt.NODES, nodes[1])
    seen = []
    for buf in bufs:
        got = []
        try:
            for ev in buf:
                got.append((ev.type, ev.object.name))
        except Exception as exc:  # a torn stream
            got.append((type(exc).__name__, str(exc)))
        seen.append(got)
    return seen, injector.injected


def _rt(api):
    if api is port_api:
        return ResourceType
    from tpusim.api.types import ResourceType as JaxResourceType

    return JaxResourceType


@pytest.mark.parametrize("drop,dup,disconnect", [
    (set(), set(), set()), ({0, 5}, {2, 7}, set()), ({1}, {3}, {4, 9}),
    (set(), set(), {0, 1, 2})])
def test_fabric_injector_on_the_rest_client(drop, dup, disconnect):
    got = _fan_out(FakeRESTClient, ResourceStore, port_api,
                   port_chaos.FabricInjector(drop, dup, disconnect))
    want = _fan_out(JaxClient, JaxStore, jax_api,
                    jax_chaos.FabricInjector(drop, dup, disconnect))
    assert got == want


def test_audit_failover_equal():
    recs = [
        (0, {"k": "batch", "c": 0, "pods": [
            {"metadata": {"name": "a"}}, {"metadata": {"name": "b"}}]}),
        (1, {"k": "bind", "c": 0, "b": [["default/a", "n1"],
                                        ["default/z", "n2"]]}),
        (2, {"k": "emit", "c": 0, "h": "x", "n": 3, "s": 1}),
        (3, {"k": "ev", "c": 1, "t": "DELETED", "r": "pod",
             "o": {"metadata": {"name": "a"}}}),
        (4, {"k": "bind", "c": 1, "b": [["default/b", "n1"],
                                        ["default/b", "n3"]]}),
        (5, {"k": "emit", "c": 1, "h": "y", "n": 0, "s": 2}),
    ]
    got = port_engine.audit_failover(recs)
    assert got == jax_engine.audit_failover(recs)
    assert got


# --- host chaos: churn and fabric faults on the host orchestrator ----------


def _host_chaos(build, seed, **plan_kw):
    out = []
    for api, plans, run in ((jax_api, jax_plan, jax_run),
                            (port_api, port_plan, run_simulation)):
        snap, pods = build(api)
        plan = plans.random_plan(seed, [n.name for n in snap.nodes],
                                 [p.key() for p in pods],
                                 attempts=len(pods) + 4, **plan_kw)
        out.append((plan, run(pods, snap, backend="reference",
                              chaos_plan=plan)))
    (jplan, want), (pplan, got) = out
    assert pplan.to_json() == jplan.to_json()
    assert split(got) == split(want)
    assert got.chaos_summary == want.chaos_summary
    assert got.chaos_violations == want.chaos_violations
    return got


@pytest.mark.parametrize("seed", SEEDS)
def test_host_chaos_equal(seed):
    got = _host_chaos(workload, seed)
    assert got.chaos_violations == []


@pytest.mark.parametrize("seed", [3, 11])
def test_host_chaos_all_nodes_killable(seed):
    _host_chaos(lambda api: workload(api, 3, 5), seed, keep_nodes=0)


@pytest.mark.parametrize("seed", [1, 7])
def test_host_chaos_gangs(seed):
    got = _host_chaos(
        lambda api: gang_workload(
            api, jax_mark_gang if api is jax_api else mark_gang), seed)
    bound = [p for p in got.successful_pods if p.name.startswith("g-")]
    assert len(bound) in (0, 4)


def test_torch_request_with_churn_runs_on_the_host(caplog):
    snap, pods = workload(port_api)
    plan = port_plan.random_plan(2, [n.name for n in snap.nodes],
                                 [p.key() for p in pods], attempts=8)
    assert not plan.host_sections_empty()
    jsnap, jpods = workload(jax_api)
    want = jax_run(jpods, jsnap, backend="jax", chaos_plan=jax_plan.
                   FaultPlan.from_obj(plan.to_obj()))
    with caplog.at_level("WARNING"):
        got = run_simulation(pods, snap, backend="torch", device="cpu",
                             chaos_plan=plan)
    assert "chaos churn/fabric sections are host-bound" in caplog.text
    assert split(got) == split(want)
    assert got.chaos_summary == want.chaos_summary


# --- device chaos: the breaker in front of TorchBackend --------------------


def _device_plan(plans, faults, verify, threshold=2, cooldown=1):
    return plans.FaultPlan(seed=0, device=plans.DeviceFaultPlan(
        faults=faults, failure_threshold=threshold, cooldown=cooldown,
        verify=verify))


def divergent(api):
    """Every placement lands on a node index > 0 (node 0 fits no pod), so
    corrupt_silent's rotation always changes the answer."""
    nodes = [api.make_node("vd-n0", milli_cpu=500, memory=1024**3)]
    nodes += [api.make_node(f"vd-n{i}", milli_cpu=4000 * i,
                            memory=8 * 1024**3) for i in (1, 2, 3)]
    pods = [api.make_pod(f"vd-p{i}", milli_cpu=800 + i * 100,
                         memory=1024**3) for i in range(3)]
    return api.ClusterSnapshot(nodes=nodes), pods


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("verify", ["all", "probe"])
@pytest.mark.parametrize("faults", [
    {0: "exception"}, {0: "corrupt_invalid"}, {0: "corrupt_silent"},
    {0: "exception", 1: "exception"}])
def test_device_chaos_equal(route, verify, faults):
    jsnap, jpods = divergent(jax_api)
    want = jax_run(jpods, jsnap, backend="jax",
                   chaos_plan=_device_plan(jax_plan, faults, verify))
    psnap, ppods = divergent(port_api)
    got = run_simulation(ppods, psnap, backend="torch", device="cpu",
                         route=route,
                         chaos_plan=_device_plan(port_plan, faults, verify))
    assert split(got) == split(want)
    assert got.chaos_summary == want.chaos_summary
    assert got.chaos_violations == want.chaos_violations == []


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_breaker_cycle_through_the_backend(route):
    """Open -> half-open -> close on one backend: the transitions, the
    placements of every dispatch, the host answers counted and kernel
    launches only on the dispatches the breaker allowed."""
    from tpusim.jaxe.backend import JaxBackend, install_chaos as jax_install

    jsnap, jpods = divergent(jax_api)
    psnap, ppods = divergent(port_api)
    plan = {"faults": {0: "exception", 1: "corrupt_invalid",
                       4: "corrupt_silent"},
            "failure_threshold": 2, "cooldown": 1, "verify": "all"}
    jb = jax_install(jax_plan.DeviceFaultPlan(**plan))
    try:
        want = [JaxBackend().schedule(jpods, jsnap) for _ in range(7)]
    finally:
        jax_uninstall()
    routes_before = dict(port_register().backend_route.values)
    pb = install_chaos(port_plan.DeviceFaultPlan(**plan))
    backend = TorchBackend(device="cpu", route=route)
    routes = []
    got = []
    for _ in range(7):
        got.append(backend.schedule(ppods, psnap))
        routes.append(backend.last_route)
    uninstall_chaos()
    assert ([[(p.pod.name, p.node_name, p.reason, p.message) for p in b]
             for b in got]
            == [[(p.pod.name, p.node_name, p.reason, p.message) for p in b]
                for b in want])
    assert pb.transitions == jb.transitions
    assert [t for t, _ in pb.transitions] == ["open", "half_open", "close"]
    fallbacks = (port_register().backend_route.values
                 .get("breaker_fallback", 0)
                 - routes_before.get("breaker_fallback", 0))
    # dispatches 0 and 1 faulted, 2 denied, 4 corrupted silently
    assert fallbacks == 4


def test_gang_feed_behind_the_breaker():
    """Gang feeds go through schedule_with_gangs behind the same breaker."""
    faults = {0: "exception", 1: "corrupt_silent"}
    jsnap, jpods = gang_workload(jax_api, jax_mark_gang)
    want = jax_run(jpods, jsnap, backend="jax",
                   chaos_plan=_device_plan(jax_plan, faults, "all", 1, 1))
    psnap, ppods = gang_workload(port_api, mark_gang)
    got = run_simulation(ppods, psnap, backend="torch", device="cpu",
                         chaos_plan=_device_plan(port_plan, faults, "all",
                                                 1, 1))
    assert split(got) == split(want)
    assert got.chaos_summary == want.chaos_summary
    assert got.chaos_summary["breaker_transitions"]


def test_pod_priority_returns_before_the_seam():
    """As in the JAX package, PodPriority on the device runs the hybrid
    before the seam is armed: a device plan reaches neither."""
    faults = {0: "exception"}
    jsnap, jpods = workload(jax_api, 3, 6)
    want = jax_run(jpods, jsnap, backend="jax", enable_pod_priority=True,
                   chaos_plan=_device_plan(jax_plan, faults, "all"))
    psnap, ppods = workload(port_api, 3, 6)
    got = run_simulation(ppods, psnap, backend="torch", device="cpu",
                         enable_pod_priority=True,
                         chaos_plan=_device_plan(port_plan, faults, "all"))
    assert split(got) == split(want)
    assert (getattr(got, "chaos_summary", None)
            == getattr(want, "chaos_summary", None))
    assert port_backend._CHAOS["breaker"] is None


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_real_errors_raise_under_chaos(monkeypatch, route):
    """Only DeviceFault reaches the breaker: any other error of a kernel or
    the scan raises, and the host never answers for it."""
    import tpusim_torch.backend as mod

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(mod, "fast_scan" if route == "kernel"
                        else "schedule_scan", broken)
    psnap, ppods = divergent(port_api)
    install_chaos(port_plan.DeviceFaultPlan(faults={5: "exception"},
                                            failure_threshold=1))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        TorchBackend(device="cpu", route=route).schedule(ppods, psnap)
    assert port_backend._CHAOS["breaker"].transitions == []


# --- the CLI ---------------------------------------------------------------


def _cli_both(capsys, args):
    rc_want = jax_main(args + ["--backend", "reference"])
    want = capsys.readouterr()
    rc_got = port_main(args + ["--backend", "reference"])
    got = capsys.readouterr()
    assert rc_got == rc_want
    assert report_lines(got.out) == report_lines(want.out)
    return rc_got, got


@pytest.mark.parametrize("seed", [4, 9])
def test_cli_chaos_seed(capsys, tmp_path, seed):
    podspec = tmp_path / "pods.json"
    podspec.write_text(json.dumps([{
        "name": "web", "num": 6,
        "pod": {"metadata": {"name": "web"},
                "spec": {"containers": [{"resources": {"requests": {
                    "cpu": "400m", "memory": "1Gi"}}}]}}}]))
    rc, got = _cli_both(capsys, ["--podspec", str(podspec),
                                 "--synthetic-nodes", "4",
                                 "--chaos-seed", str(seed)])
    assert rc == 0
    assert "Chaos: " in got.out


def test_cli_chaos_plan_and_errors(capsys, tmp_path):
    podspec = tmp_path / "pods.json"
    podspec.write_text(json.dumps([{
        "name": "web", "num": 5,
        "pod": {"metadata": {"name": "web"},
                "spec": {"containers": [{"resources": {"requests": {
                    "cpu": "500m"}}}]}}}]))
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 3, "churn": [
        {"at": 1, "action": "node_delete", "target": "node-0"},
        {"at": 2, "action": "pod_evict", "target": "default/web-4"}],
        "fabric": {"dup": [1]}}))
    rc, got = _cli_both(capsys, ["--podspec", str(podspec),
                                 "--synthetic-nodes", "3",
                                 "--chaos-plan", str(plan)])
    assert rc == 0 and "[seed 3]" in got.out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"device": {"faults": {"0": "melt"}}}))
    args = ["--podspec", str(podspec), "--synthetic-nodes", "3",
            "--chaos-plan", str(bad)]
    assert jax_main(args) == 2
    want = capsys.readouterr().err
    assert port_main(args) == 2
    assert capsys.readouterr().err == want
