"""The port's host compile and int32 plan against the JAX package's: the same
arrays on the same workload, and the same refusals."""

import dataclasses

import numpy as np
import pytest

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.jaxe import fastscan as jfs  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import config as pconfig  # noqa: E402
from tpusim_torch import fastplan as pfp  # noqa: E402
from tpusim_torch import state as pstate  # noqa: E402
from tpusim_torch.workloads import (  # noqa: E402
    build_workload,
    random_workload,
    uniform_workload,
)


def both_plans(build, most_requested=False):
    """(jax compiled, jax cols, jax plan-or-reason, port ...) for one
    workload built once per package."""
    out = []
    for api, st, cfg_for, plan_fast in (
            (jax_api, jstate,
             lambda c, m: jk.config_for(
                 [c], m, jstate.NUM_FIXED_BITS + len(c.scalar_names)),
             jfs.plan_fast),
            (port_api, pstate, pconfig.config_for, pfp.plan_fast)):
        snapshot, pods = build(api)
        compiled, cols = st.compile_cluster(snapshot, pods)
        config = cfg_for(compiled, most_requested)
        out.append((compiled, cols, plan_fast(config, compiled, cols)))
    return out


WORKLOADS = {
    "random0": lambda api: random_workload(0, 40, 120, api=api),
    "random_scalars": lambda api: random_workload(1, 50, 140, num_scalars=2,
                                                  infeasible=True, api=api),
    "config3_small": lambda api: build_workload(300, 60, api=api),
    "config4_small": lambda api: build_workload(300, 60, affinity=True,
                                                api=api),
    "uniform": lambda api: uniform_workload(200, 30, api=api),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_compile_cluster_matches(name):
    (jc, jcols, _), (pc, pcols, _) = both_plans(WORKLOADS[name])
    assert pc.scalar_names == jc.scalar_names
    assert pc.node_index == jc.node_index
    assert pc.statics.names == jc.statics.names
    for part in ("statics", "tables", "dynamic"):
        for f in dataclasses.fields(getattr(pc, part)):
            if f.name == "names":
                continue
            got = getattr(getattr(pc, part), f.name)
            want = getattr(getattr(jc, part), f.name)
            assert np.array_equal(got, want), f"{part}.{f.name}"
    for f in dataclasses.fields(pcols):
        assert np.array_equal(getattr(pcols, f.name),
                              getattr(jcols, f.name)), f.name


@pytest.mark.parametrize("name,most_requested", [
    (n, m) for n in sorted(WORKLOADS) for m in (False, True)])
def test_plan_fast_matches(name, most_requested):
    (_, _, (jplan, jwhy)), (_, _, (pplan, pwhy)) = both_plans(
        WORKLOADS[name], most_requested)
    assert jplan is not None and pplan is not None, (jwhy, pwhy)
    for f in dataclasses.fields(pplan):
        got, want = getattr(pplan, f.name), getattr(jplan, f.name)
        if isinstance(got, np.ndarray):
            assert got.dtype == np.int32, f.name
            assert np.array_equal(got, want), f.name
        else:
            assert got == want, f.name
    # the dict hand-over the tests use gives the same plan back
    again = pfp.plan_from_numpy(dataclasses.asdict(jplan))
    for f in dataclasses.fields(pplan):
        got = getattr(again, f.name)
        want = getattr(pplan, f.name)
        assert (np.array_equal(got, want) if isinstance(want, np.ndarray)
                else got == want), f.name


def _with_ports(api):
    snapshot, pods = random_workload(2, 10, 20, api=api)
    pods.append(api.Pod.from_obj({
        "metadata": {"name": "ports"},
        "spec": {"containers": [{"name": "c", "ports": [
            {"hostPort": 8080, "containerPort": 80}]}]}}))
    return snapshot, pods


def _with_interpod(api):
    snapshot, pods = random_workload(3, 10, 20, api=api)
    pods.append(api.make_pod("anti", milli_cpu=100, labels={"app": "web"},
                             affinity={"podAntiAffinity": {
                                 "requiredDuringSchedulingIgnoredDuringExecution": [
                                     {"labelSelector": {"matchLabels": {"app": "web"}},
                                      "topologyKey": "kubernetes.io/hostname"}]}}))
    return snapshot, pods


def _with_services(api):
    snapshot, pods = random_workload(4, 10, 20, api=api)
    snapshot.services.append(api.Service.from_obj(
        {"metadata": {"name": "svc"}, "spec": {"selector": {"app": "web"}}}))
    return snapshot, pods


def _with_volumes(api):
    snapshot, pods = random_workload(5, 10, 20, api=api)
    pods.append(api.make_pod("vol", milli_cpu=100, volumes=[
        {"name": "d", "gcePersistentDisk": {"pdName": "disk-a"}}]))
    return snapshot, pods


def assert_plans_equal(got, want):
    """Every field of the port's plan equals the same field of `want`."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, f.name
            assert a.dtype == np.int32, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("build,feature", [
    (_with_ports, "host ports"),
    (_with_interpod, "inter-pod"),
    (_with_services, "services"),
    (_with_volumes, "pod volumes"),
])
def test_group_workloads_are_refused(build, feature):
    """No group workload is refused any more (the name is historical): host
    ports, services, volumes and inter-pod (anti)affinity run on the group
    and inter-pod variants the port carries. Its plan equals the JAX
    package's, field for field, and so does the plan handed over in dict
    form."""
    (_, _, (jplan, jwhy)), (_, _, (pplan, pwhy)) = both_plans(build)
    assert jplan is not None, jwhy
    assert pplan is not None, pwhy
    assert (pplan.num_groups > 0 or pplan.has_maxpd or pplan.has_vol_zone)
    assert pplan.has_interpod == (feature == "inter-pod")
    assert_plans_equal(pplan, jplan)
    assert_plans_equal(pfp.plan_from_numpy(dataclasses.asdict(jplan)), pplan)


def test_scalar_budget_refusal_matches():
    def build(api):
        nodes = [api.make_node(f"n{i}", scalars={f"example.com/r{s}": 4
                                                for s in range(7)})
                 for i in range(3)]
        return api.ClusterSnapshot(nodes=nodes), [api.make_pod("p", 100)]

    (_, _, (jplan, jwhy)), (_, _, (pplan, pwhy)) = both_plans(build)
    assert jplan is None and pplan is None
    assert pwhy == jwhy


def test_int32_bound_refusal_matches():
    def build(api):
        nodes = [api.make_node("n0", milli_cpu=4001, memory=2**40 + 1)]
        return api.ClusterSnapshot(nodes=nodes), [api.make_pod("p", 1, 1)]

    (_, _, (jplan, jwhy)), (_, _, (pplan, pwhy)) = both_plans(build)
    assert jplan is None and pplan is None
    assert pwhy == jwhy
