"""The fast matrix of the fault fuzz (tests/test_chaos_fuzz.py) on the port,
against the JAX package, on the CPU.

Seeded adversarial plans against the port's simulator must keep the
end-state invariants (no pod lost, no double bind, no bind to a deleted
node, no partial gang, fabric reconvergence) and give the JAX package's
split and chaos summary; device-fault plans on backend "torch" must give
the host's placements; seeded process crashes of a stream must recover to
the uninterrupted chain. A failing seed replays byte for byte from
random_plan(seed, ...). Tolerance: exact.
"""

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.chaos import random_plan as jax_random_plan
from tpusim.gang.group import mark_gang as jax_mark_gang
from tpusim.jaxe.backend import uninstall_chaos as jax_uninstall
from tpusim.simulator import run_simulation as jax_run

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.backend import TorchBackend, install_chaos, uninstall_chaos
from tpusim_torch.chaos import DeviceFaultPlan, FaultPlan, random_plan
from tpusim_torch.chaos.engine import ProcessCrash
from tpusim_torch.chaos.plan import random_crash_plan
from tpusim_torch.framework.metrics import register
from tpusim_torch.gang.group import mark_gang
from tpusim_torch.simulator import run_simulation, run_stream_simulation
from test_torch_chaos import gang_workload, workload
from test_torch_simulator import split

pytestmark = pytest.mark.chaos_fuzz


@pytest.fixture(autouse=True)
def _no_chaos_seam():
    uninstall_chaos()
    jax_uninstall()
    yield
    uninstall_chaos()
    jax_uninstall()


def assert_clean(seed, plan, status):
    assert status.chaos_violations == [], (
        f"seed {seed}: invariant violation(s) {status.chaos_violations} "
        f"under plan {plan.to_json()} summary {status.chaos_summary}")
    placed = {p.key() for p in status.successful_pods}
    failed = {p.key() for p in status.failed_pods}
    assert not placed & failed, f"seed {seed}: pods both placed and failed"


def seeded(build, seed, **plan_kw):
    snap, pods = build(port_api)
    plan = random_plan(seed, [n.name for n in snap.nodes],
                       [p.key() for p in pods], attempts=len(pods) + 4,
                       **plan_kw)
    status = run_simulation(pods, snap, backend="reference",
                            chaos_plan=plan)
    jsnap, jpods = build(jax_api)
    want = jax_run(jpods, jsnap, backend="reference",
                   chaos_plan=jax_random_plan(
                       seed, [n.name for n in jsnap.nodes],
                       [p.key() for p in jpods], attempts=len(jpods) + 4,
                       **plan_kw))
    assert split(status) == split(want)
    assert status.chaos_summary == want.chaos_summary
    assert_clean(seed, plan, status)
    return plan, status


@pytest.mark.parametrize("seed", [0, 13, 42])
def test_fuzz_churn_invariants(seed):
    seeded(workload, seed)


@pytest.mark.parametrize("seed", [3, 11])
def test_fuzz_all_nodes_killable(seed):
    seeded(lambda api: workload(api, 3, 5), seed, keep_nodes=0)


@pytest.mark.parametrize("seed", [2, 7, 13])
def test_fuzz_gang_churn_invariants(seed):
    _, status = seeded(lambda api: gang_workload(
        api, mark_gang if api is port_api else jax_mark_gang), seed)
    bound = [p for p in status.successful_pods if p.name.startswith("g-")]
    assert len(bound) in (0, 4)


def test_fuzz_replay_is_deterministic():
    plan_a, status_a = seeded(workload, 42)
    plan_b, status_b = seeded(workload, 42)
    assert plan_a == plan_b
    assert status_a.chaos_summary == status_b.chaos_summary
    assert split(status_a) == split(status_b)


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("faults", [
    {0: "exception"}, {0: "corrupt_invalid"}, {0: "corrupt_silent"},
    {0: "exception", 1: "exception"}])
def test_fuzz_device_faults_host_parity(route, faults):
    """A faulted device run emits the clean host run's placements: the
    breaker and verify="all"."""
    snap, pods = workload(port_api, 3, 6)
    expected = run_simulation(pods, snap, backend="reference")
    status = run_simulation(pods, snap, backend="torch", device="cpu",
                            route=route,
                            chaos_plan=FaultPlan(seed=0, device=DeviceFaultPlan(
                                faults=faults, failure_threshold=2,
                                cooldown=1)))
    assert status.chaos_violations == []
    assert (sorted((p.key(), p.spec.node_name)
                   for p in status.successful_pods)
            == sorted((p.key(), p.spec.node_name)
                      for p in expected.successful_pods))
    assert ({p.key() for p in status.failed_pods}
            == {p.key() for p in expected.failed_pods})


def test_fuzz_breaker_cycle_visible_in_counters():
    reg = register()
    before = dict(reg.breaker_transitions.values)
    snap, pods = workload(port_api, 3, 6)
    breaker = install_chaos(DeviceFaultPlan(
        faults={0: "exception", 1: "exception"}, failure_threshold=2,
        cooldown=1))
    backend = TorchBackend(device="cpu")
    for _ in range(4):
        placements = backend.schedule(pods, snap)
        assert all(p.node_name or p.reason == "Unschedulable"
                   for p in placements)
    uninstall_chaos()
    assert [t for t, _ in breaker.transitions] == ["open", "half_open",
                                                   "close"]
    after = reg.breaker_transitions.values
    for transition in ("open", "half_open", "close"):
        assert after.get(transition, 0) == before.get(transition, 0) + 1
    assert reg.breaker_state.value == 0.0  # ends closed


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_fuzz_crash_recovery_seeded(tmp_path, pipeline):
    shape = dict(num_nodes=10, cycles=8, arrivals=6, node_flap_every=3,
                 seed=5, checkpoint_every=2, pipeline=pipeline, device="cpu")
    base = run_stream_simulation(checkpoint_dir=str(tmp_path / "base"),
                                 **shape)
    for seed in range(3):
        plan = random_crash_plan(seed, 8)
        d = str(tmp_path / f"s{seed}")
        try:
            out = run_stream_simulation(checkpoint_dir=d, chaos_plan=plan,
                                        **shape)
            # an events crash on a cycle without events never fires
            assert out["fold_chain"] == base["fold_chain"], (seed, plan)
            continue
        except ProcessCrash:
            pass
        out = run_stream_simulation(checkpoint_dir=d, recover=True, **shape)
        assert out["fold_chain"] == base["fold_chain"], (seed, plan)
        assert out["recovery_violations"] == [], (seed, plan)
        assert out["restages"].get("recovered") == 1, (seed, plan)
