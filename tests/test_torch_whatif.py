"""The port's batched what-if (tpusim_torch.whatif.run_what_if) against the
JAX package's run_what_if on the CPU: the same placements and FitError text,
scenario by scenario, on both of the port's routes (the fast loop of
fast_scan calls, here the kernel's plain version, and the batched scan),
with heterogeneous scenarios, pod groups and inter-pod terms, policies,
count mode and ServiceAffinity, then validation, routing and the CLI.

A scenario's result does not depend on the batch it rides in (the unifier's
padding never fires), so the JAX package runs every default-provider
scenario of this file in one call, a compile of its batched program being
several seconds on a CPU; each policy adds one more call.
"""

import collections
import json

import numpy as np
import pytest
import torch

import tpusim.api.snapshot as jax_api
import tpusim.api.types as jax_types
from tpusim.engine.policy import decode_policy as jax_decode
from tpusim.jaxe.whatif import run_what_if as jax_run_what_if

import tpusim_torch.api.snapshot as port_api
import tpusim_torch.api.types as port_types
from tpusim_torch import scan, whatif
from tpusim_torch.engine.policy import decode_policy as port_decode
from tpusim_torch.whatif import run_what_if

APIS = {"jax": (jax_api, jax_types), "port": (port_api, port_types)}


def scenario(pkg, seed, num_nodes, num_pods):
    """tests/test_whatif.py's scenario: taints, zone selectors, random
    byte-granular memory (past the kernel's int32 plan)."""
    api, _ = APIS[pkg]
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(num_nodes):
        taints = ([{"key": "dedicated", "value": "batch",
                    "effect": "NoSchedule"}] if i % 4 == 0 else None)
        nodes.append(api.make_node(
            f"s{seed}-n{i}", milli_cpu=int(rng.choice([2000, 4000, 8000])),
            memory=int(rng.choice([4, 8, 16])) * 1024**3,
            labels={"zone": f"z{i % 3}"}, taints=taints))
    pods = []
    for i in range(num_pods):
        kwargs = {}
        if i % 3 == 0:
            kwargs["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                      "value": "batch", "effect": "NoSchedule"}]
        if i % 5 == 0:
            kwargs["node_selector"] = {"zone": f"z{i % 3}"}
        pods.append(api.make_pod(f"s{seed}-p{i}",
                                 milli_cpu=int(rng.randint(100, 1500)),
                                 memory=int(rng.randint(2**20, 2**30)),
                                 **kwargs))
    return api.ClusterSnapshot(nodes=nodes), pods


def counts_scenario(pkg):
    snap, pods = scenario(pkg, 3, 6, 8)
    pods.append(APIS[pkg][0].make_pod("impossible", milli_cpu=10**9,
                                      memory=2**50))
    return snap, pods


def fast_scenario(pkg, seed):
    """tests/test_whatif.py TestFastLoop's scenarios: bucketed memory, so
    the kernel's int32 plan takes them."""
    api, _ = APIS[pkg]
    rng = np.random.RandomState(100 + seed)
    nodes = [api.make_node(f"f{seed}-n{i}",
                           milli_cpu=int(rng.choice([2000, 4000])),
                           memory=int(rng.choice([4, 8])) * 1024**3,
                           labels={"zone": f"z{i % 3}"})
             for i in range(10 + seed)]
    pods = [api.make_pod(f"f{seed}-p{i}",
                         milli_cpu=int(rng.choice([100, 400, 900])),
                         memory=int(rng.choice([64, 256, 1024])) * 1024 * 1024,
                         node_selector=({"zone": f"z{i % 3}"}
                                        if i % 5 == 0 else None))
             for i in range(25)]
    return api.ClusterSnapshot(nodes=nodes), pods


def port_pod(api, name, port, milli_cpu=100):
    return api.Pod.from_obj({
        "metadata": {"name": name, "namespace": "default", "uid": name,
                     "labels": {}},
        "spec": {"containers": [{
            "name": "c", "ports": [{"hostPort": port}],
            "resources": {"requests": {"cpu": f"{milli_cpu}m"}}}]},
        "status": {}})


def group_scenario(pkg, seed, num_nodes, num_pods):
    """tests/test_whatif.py's group-bound scenario: Services and spreading,
    inter-pod (anti)affinity, host ports, volumes; bucketed memory."""
    api, types = APIS[pkg]
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"g{seed}-n{i}",
                           milli_cpu=int(rng.choice([4000, 8000])),
                           memory=int(rng.choice([8, 16])) * 1024**3,
                           labels={"zone": f"z{i % 2}",
                                   "kubernetes.io/hostname": f"g{seed}-n{i}"})
             for i in range(num_nodes)]
    services = [types.Service.from_obj(
        {"metadata": {"name": f"g{seed}-svc{k}", "namespace": "default"},
         "spec": {"selector": {"app": f"a{k}"}}}) for k in range(2)]
    placed = [api.make_pod(f"g{seed}-seed", milli_cpu=100,
                           node_name=f"g{seed}-n0", phase="Running",
                           labels={"app": "a0"})]
    pods = []
    for i in range(num_pods):
        kwargs = {"labels": {"app": f"a{i % 2}"}}
        if i % 4 == 0:
            kwargs["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": f"a{i % 2}"}},
                    "topologyKey": "zone"}]}}
        elif i % 4 == 2:
            kwargs["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": f"a{i % 2}"}},
                    "topologyKey": "kubernetes.io/hostname"}]}}
        if i % 5 == 0:
            kwargs["volumes"] = [api.make_pod_volume(
                "d", source={"gcePersistentDisk": {"pdName": f"pd{i % 3}"}})]
        pods.append(api.make_pod(f"g{seed}-p{i}",
                                 milli_cpu=int(rng.choice([100, 300, 900])),
                                 memory=int(rng.choice([64, 256])) * 2**20,
                                 **kwargs))
    pods.append(port_pod(types, f"g{seed}-port0", 9090))
    pods.append(port_pod(types, f"g{seed}-port1", 9090))
    return api.ClusterSnapshot(nodes=nodes, pods=placed,
                               services=services), pods


def ineligible_scenarios(pkg):
    """The fast scenarios with scenario 1 swapped for one whose memory is
    byte-granular: plan_fast refuses it."""
    out = [fast_scenario(pkg, s) for s in range(3)]
    out[1] = scenario(pkg, 60, 8, 12)
    return out


# every default-provider scenario set of this file
SETS = {
    "hetero": lambda pkg: [scenario(pkg, 0, 12, 9), scenario(pkg, 1, 7, 14),
                           scenario(pkg, 2, 20, 5)],
    "counts": lambda pkg: [counts_scenario(pkg)],
    "fast": lambda pkg: [fast_scenario(pkg, s) for s in range(3)],
    "ineligible": ineligible_scenarios,
    "groups": lambda pkg: [group_scenario(pkg, 40, 12, 14),
                           group_scenario(pkg, 41, 8, 10)],
}


def placements_key(placements):
    return [(p.pod.name, p.node_name, p.message) for p in placements]


def results_key(results):
    return [(placements_key(r.placements), r.scheduled, r.unschedulable)
            for r in results]


@pytest.fixture(scope="module")
def jax_sets():
    """The JAX package's results for every set of SETS, from one call."""
    names = sorted(SETS)
    scenarios, spans = [], {}
    for name in names:
        part = SETS[name]("jax")
        spans[name] = (len(scenarios), len(scenarios) + len(part))
        scenarios.extend(part)
    results = results_key(jax_run_what_if(scenarios))
    return {name: results[lo:hi] for name, (lo, hi) in spans.items()}


def port_run(scenarios, **kwargs):
    return run_what_if(scenarios, device="cpu", **kwargs)


def count_fast_scans(monkeypatch):
    calls = []
    real = whatif.fast_scan
    monkeypatch.setattr(whatif, "fast_scan",
                        lambda plan, **kw: calls.append(1) or real(plan, **kw))
    return calls


def forbid_fast_scan(monkeypatch):
    monkeypatch.setattr(
        whatif, "fast_scan", lambda plan, **kw: (_ for _ in ()).throw(
            AssertionError("the fast loop must not run")))


@pytest.mark.parametrize("route", ["scan", "auto"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_sets_match_jax(jax_sets, name, route, monkeypatch):
    calls = count_fast_scans(monkeypatch)
    got = results_key(port_run(SETS[name]("port"), route=route))
    assert got == jax_sets[name]
    # the fast loop runs exactly where every scenario's plan is accepted
    fast = route == "auto" and name in ("fast", "groups")
    assert len(calls) == (len(got) if fast else 0)


def test_all_sets_in_one_batch_match_jax(jax_sets):
    """Every set at once through the batched scan: pod groups, inter-pod
    terms and MaxPD compiled in for every scenario, ragged node, pod and
    signature axes."""
    names = sorted(SETS)
    scenarios = [s for name in names for s in SETS[name]("port")]
    got = results_key(port_run(scenarios, route="scan"))
    assert got == [r for name in names for r in jax_sets[name]]


def test_counts(jax_sets):
    [result] = port_run(SETS["counts"]("port"))
    assert result.total == 9 and result.unschedulable >= 1
    impossible = result.placements[-1]
    assert impossible.reason == "Unschedulable"
    assert "Insufficient cpu" in impossible.message


def test_ineligible_scenario_keeps_the_batched_scan(monkeypatch):
    forbid_fast_scan(monkeypatch)
    results = port_run(SETS["ineligible"]("port"))
    assert len(results) == 3


def test_kernel_route_raises_with_the_refused_scenario():
    with pytest.raises(NotImplementedError, match=r"scenario 1: "):
        port_run(SETS["ineligible"]("port"), route="kernel")


def test_kernel_error_raises(monkeypatch):
    """A fault of the fast loop's kernel raises: no scenario falls back to
    the batched scan (the JAX package's fast loop falls back instead)."""
    def broken(plan, **kw):
        raise RuntimeError("fastscan kernel launch failed: CUDA error 700")

    monkeypatch.setattr(whatif, "fast_scan", broken)
    monkeypatch.setattr(whatif, "build_program", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("fell back to the scan")))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port_run(SETS["fast"]("port"))


def test_provider_validation():
    with pytest.raises(KeyError):
        port_run([scenario("port", 0, 3, 2)], provider="NoSuchProvider")


def test_route_validation():
    with pytest.raises(ValueError, match="unknown route"):
        port_run([scenario("port", 0, 3, 2)], route="fastest")


def test_empty_scenario_list_rejected():
    with pytest.raises(ValueError, match="at least one"):
        port_run([])


def test_zero_node_scenario_rejected_with_index():
    empty = (port_api.ClusterSnapshot(nodes=[]),
             [port_api.make_pod("lonely", milli_cpu=100)])
    scenarios = [scenario("port", 30, 8, 5), empty, scenario("port", 31, 6, 4)]
    with pytest.raises(ValueError, match=r"scenario 1: .*zero-node"):
        port_run(scenarios)
    with pytest.raises(ValueError, match=r"scenario 0: .*zero-node"):
        port_run([empty, empty])


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_what_if([scenario("port", 0, 3, 2)])


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_fast_loop_matches_batched_scan(seed, monkeypatch):
    """Random eligible batches: the fast loop equals the batched scan."""
    import random

    rng = random.Random(7000 + seed)
    scenarios = []
    for s in range(rng.randint(2, 4)):
        nodes = [port_api.make_node(f"z{seed}-{s}-n{i}",
                                    milli_cpu=rng.choice([1000, 2000, 4000]),
                                    memory=rng.choice([2, 4, 8]) * 1024**3,
                                    pods=rng.choice([4, 110]),
                                    labels={"zone": f"z{i % 2}"})
                 for i in range(rng.randint(3, 8))]
        pods = [port_api.make_pod(f"z{seed}-{s}-p{i}",
                                  milli_cpu=rng.randrange(1, 10) * 100,
                                  memory=rng.randrange(1, 8) * 256 * 2**20,
                                  node_selector=({"zone": f"z{i % 3}"}
                                                 if rng.random() < 0.3
                                                 else None))
                for i in range(rng.randint(8, 20))]
        scenarios.append((port_api.ClusterSnapshot(nodes=nodes), pods))
    calls = count_fast_scans(monkeypatch)
    fast = results_key(port_run(scenarios, route="auto"))
    assert len(calls) == len(scenarios)
    assert fast == results_key(port_run(scenarios, route="scan"))


# ---- policies: each its own JAX call --------------------------------------

LABEL_POLICY = {
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "PodFitsResources"},
                   {"name": "NeedsDisk", "argument": {"labelsPresence": {
                       "labels": ["disktype"], "presence": True}}}],
    "priorities": [{"name": "MostRequestedPriority", "weight": 2}]}
ACA_POLICY = {"kind": "Policy", "apiVersion": "v1",
              "predicates": [{"name": "PodFitsResources"}], "priorities": [],
              "alwaysCheckAllPredicates": True}
SA_POLICY = {
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "PodFitsResources"},
                   {"name": "ByZone", "argument": {"serviceAffinity": {
                       "labels": ["zone"]}}}],
    "priorities": [{"name": "SpreadByZone", "weight": 2, "argument": {
        "serviceAntiAffinity": {"label": "zone"}}}]}
GENERAL_POLICY = {
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "GeneralPredicates"},
                   {"name": "PodToleratesNodeTaints"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                   {"name": "NodeAffinityPriority", "weight": 2}]}


def label_scenarios(pkg):
    api, _ = APIS[pkg]
    out = []
    for s in range(3):
        nodes = [api.make_node(f"s{s}-n{i}", milli_cpu=2000 + 1000 * s,
                               labels={"disktype": "ssd"} if i % 2 == 0
                               else None)
                 for i in range(4 + s)]
        pods = [api.make_pod(f"s{s}-p{i}", milli_cpu=700) for i in range(6)]
        out.append((api.ClusterSnapshot(nodes=nodes), list(reversed(pods))))
    return out


def aca_scenarios(pkg):
    api, _ = APIS[pkg]
    small = api.ClusterSnapshot(nodes=[api.make_node(f"a{i}", milli_cpu=100)
                                       for i in range(2)])
    big = api.ClusterSnapshot(nodes=[api.make_node(f"b{i}", milli_cpu=100)
                                     for i in range(5)])
    pod = api.make_pod("p", milli_cpu=5000)
    return [(small, [pod]), (big, [pod])]


def sa_scenarios(pkg):
    api, types = APIS[pkg]
    svc = types.Service.from_obj({"metadata": {"name": "db",
                                               "namespace": "default"},
                                  "spec": {"selector": {"app": "db"}}})
    out = []
    for s in range(3):
        nodes = [api.make_node(f"s{s}n{i}", milli_cpu=6000,
                               labels={"zone": f"z{i % (2 + s)}"})
                 for i in range(4 + s)]
        seed = api.make_pod(f"s{s}-seed", milli_cpu=100, node_name=f"s{s}n0",
                            phase="Running", labels={"app": "db"})
        pods = [api.make_pod(f"s{s}-p{i}", milli_cpu=300,
                             labels={"app": "db"} if i % 2 == 0 else None)
                for i in range(6)]
        out.append((api.ClusterSnapshot(nodes=nodes, pods=[seed],
                                        services=[svc]),
                    list(reversed(pods))))
    return out


def general_scenarios(pkg):
    api, _ = APIS[pkg]
    rng = np.random.RandomState(0)
    out = []
    for s_i in range(3):
        nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=16 * 1024**3)
                 for i in range(10 + s_i)]
        pods = [api.make_pod(f"p{i}", milli_cpu=int(rng.choice([500, 1000])),
                             memory=2**28) for i in range(80)]
        out.append((api.ClusterSnapshot(nodes=nodes), pods))
    return out


POLICY_CASES = {
    "labels": (LABEL_POLICY, label_scenarios),
    "count_mode_padding": (ACA_POLICY, aca_scenarios),
    "service_affinity": (SA_POLICY, sa_scenarios),
    "general": (GENERAL_POLICY, general_scenarios),
}


@pytest.fixture(scope="module")
def jax_policy_results():
    cache = {}

    def get(name):
        if name not in cache:
            policy, build = POLICY_CASES[name]
            cache[name] = results_key(jax_run_what_if(
                build("jax"), policy=jax_decode(policy)))
        return cache[name]

    return get


@pytest.mark.parametrize("route", ["scan", "auto"])
@pytest.mark.parametrize("name", sorted(POLICY_CASES))
def test_policy_matches_jax(jax_policy_results, name, route):
    policy, build = POLICY_CASES[name]
    got = results_key(port_run(build("port"), policy=port_decode(policy),
                               route=route))
    assert got == jax_policy_results(name)


def test_count_mode_padding_nodes_stay_invisible(jax_policy_results):
    """A 2-node scenario batched with a 5-node one reports reasons over its
    own 2 nodes: the padded nodes count in no reason (count mode sums every
    failing stage)."""
    policy, build = POLICY_CASES["count_mode_padding"]
    results = port_run(build("port"), policy=port_decode(policy),
                       route="scan")
    msg_small = results[0].placements[0].message
    assert msg_small.startswith("0/2 nodes are available")
    assert "2 Insufficient cpu" in msg_small and "5 " not in msg_small
    assert "Insufficient pods" not in msg_small
    assert results_key(results) == jax_policy_results("count_mode_padding")


def test_general_policy_takes_the_fast_loop(monkeypatch):
    policy, build = POLICY_CASES["general"]
    calls = count_fast_scans(monkeypatch)
    port_run(build("port"), policy=port_decode(policy))
    assert len(calls) == 3


def test_rejects_host_bound_policy():
    from tpusim_torch.engine.policy import ExtenderConfig, Policy

    policy = Policy(extender_configs=[ExtenderConfig(
        url_prefix="http://x", filter_verb="filter")])
    snap = port_api.ClusterSnapshot(nodes=[port_api.make_node(
        "n1", milli_cpu=1000)])
    with pytest.raises(NotImplementedError, match="host-bound"):
        port_run([(snap, [port_api.make_pod("p", milli_cpu=10)])],
                 policy=policy)


# ---- the batched scan alone -----------------------------------------------

def test_batched_step_launches_the_same_operations_whatever_s():
    """One step of the batched scan dispatches the same operations at S = 2
    and S = 6, a few copies more than at S = 1 (where a reshape across the
    scenario axis stays a view), and maps no operation over scenarios one
    by one (vmap's fallback would warn)."""
    import warnings

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    def step_ops(scenarios):
        config, staged = whatif._prepare_host_batch(
            scenarios, "DefaultProvider", 10, None)
        per = whatif._unify_batch([(s.statics, s.carry, s.xs)
                                   for s in staged])
        program = scan.BatchedScan(config, *whatif.stage_batch(
            *whatif._stack_host(per), "cpu"))
        with warnings.catch_warnings(), Count() as count:
            warnings.simplefilter("error")
            program._steps.step()
        return count.ops

    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        groups = SETS["groups"]("port")
        one, two, six = (step_ops(groups[:1]), step_ops(groups),
                         step_ops(groups * 3))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert two == six
    views = {"aten.view.default", "aten._unsafe_view.default"}
    assert set(one - two) <= views
    assert set(two - one) <= views | {"aten.clone.default"}
    assert (two - one)["aten.clone.default"] <= 8


def test_batched_program_reloads_and_reruns():
    """A built program over new contents of its buffers gives what a new
    program gives: load copies, never rebinds."""
    scenarios = [fast_scenario("port", 0), fast_scenario("port", 0),
                 fast_scenario("port", 1), scenario("port", 5, 10, 25)]
    config, staged = whatif._prepare_host_batch(scenarios, "DefaultProvider",
                                                10, None)
    per = whatif._unify_batch([(s.statics, s.carry, s.xs) for s in staged])
    trees_a = whatif.stage_batch(*whatif._stack_host(per[:2]), "cpu")
    trees_b = whatif.stage_batch(*whatif._stack_host(per[2:]), "cpu")
    config_a = config_b = config
    program = scan.BatchedScan(config_a, *trees_a)
    first = [t.clone() for t in program.run()]
    program.load(*trees_b)
    got = [t.clone() for t in program.run()]
    want = scan.schedule_scan_batched(config_b, *trees_b)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    program.load(*trees_a)
    assert all(torch.equal(a, b) for a, b in zip(program.run(), first))


# ---- the CLI --------------------------------------------------------------

PODSPEC = [{"name": "w", "num": 5, "pod": {"metadata": {"name": "w"},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {
                "cpu": "500m", "memory": "128Mi"}}}]}}}]


def test_cli_what_if_matches_jax(tmp_path, capsys):
    from tpusim.cli import main as jax_main

    from tpusim_torch.cli import main as port_main

    manifest = []
    for s in range(3):
        snap, _ = scenario("port", 100 + s, 6 + s, 0)
        snap_path = tmp_path / f"snap{s}.json"
        snap.save(str(snap_path))
        podspec = tmp_path / f"pods{s}.json"
        spec = json.loads(json.dumps(PODSPEC))
        spec[0]["num"] = 4 + 3 * s
        podspec.write_text(json.dumps(spec))
        manifest.append({"snapshot": str(snap_path), "podspec": str(podspec)})
    mpath = tmp_path / "manifest.json"
    mpath.write_text(json.dumps(manifest))

    def scenario_lines(text):
        return [line for line in text.splitlines()
                if line.startswith("scenario")]

    assert port_main(["--what-if", str(mpath), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jax_main(["--what-if", str(mpath)]) == 0
    jax_out = capsys.readouterr().out
    assert scenario_lines(port_out) == scenario_lines(jax_out)
    assert len(scenario_lines(port_out)) == 3
    assert "3 scenarios, " in port_out


def test_cli_what_if_rejects_a_bad_manifest(tmp_path, capsys):
    from tpusim_torch.cli import main as port_main

    mpath = tmp_path / "manifest.json"
    mpath.write_text("[]")
    assert port_main(["--what-if", str(mpath), "--device", "cpu"]) == 2
    assert "invalid what-if manifest" in capsys.readouterr().err
