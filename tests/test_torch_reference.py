"""The port's host route (tpusim_torch.backends.ReferenceBackend and the
engine under it) against the JAX package's ReferenceBackend: the same
placement hash and byte-identical messages on the parity builds of
tests/test_torch_backend.py, the random group, inter-pod and policy
workloads, and the upstream compatibility policies, under DefaultProvider
and TalkintDataProvider; then every registered predicate's fit and reasons,
and every priority's map/reduce scores, pod by node on random workloads,
with tolerance 0 (all of them are integers or strings).
"""

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.backends import ReferenceBackend as JaxReference
from tpusim.backends import placement_hash as jax_hash
from tpusim.engine import providers as jax_providers
from tpusim.engine import resources as jax_resources
from tpusim.engine import volume as jax_volume
from tpusim.engine.policy import decode_policy as jax_decode

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.backend import TorchBackend
from tpusim_torch.backends import ReferenceBackend, get_backend, placement_hash
from tpusim_torch.engine import providers as port_providers
from tpusim_torch.engine import resources as port_resources
from tpusim_torch.engine import volume as port_volume
from tpusim_torch.engine.policy import decode_policy as port_decode
from tpusim_torch.workloads import (
    build_workload,
    random_group_workload,
    random_interpod_workload,
    random_policy,
    random_policy_workload,
)
from test_torch_backend import ORIGINAL, PARITY
from test_torch_policy import COMPAT, compat_build

PROVIDERS = ["DefaultProvider", "TalkintDataProvider"]


def assert_same(port, ref):
    assert [(p.pod.name, p.node_name, p.reason, p.message) for p in port] \
        == [(r.pod.name, r.node_name, r.reason, r.message) for r in ref]
    assert placement_hash(port) == jax_hash(ref)


def run_both(build, provider="DefaultProvider", policy=None):
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    ref = JaxReference(provider=provider,
                       policy=policy and jax_decode(policy)
                       ).schedule(jpods, jsnap)
    port = ReferenceBackend(provider=provider,
                            policy=policy and port_decode(policy)
                            ).schedule(ppods, psnap)
    assert_same(port, ref)
    return port


@pytest.mark.parametrize("provider", PROVIDERS)
@pytest.mark.parametrize("build", PARITY + ORIGINAL,
                         ids=[b.__name__ for b in PARITY + ORIGINAL])
def test_parity_builds(build, provider):
    run_both(build, provider)


GROUP_FEATURES = ["ports", "services", "disk", "vol_zone", "maxpd"]


@pytest.mark.parametrize("provider", PROVIDERS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("feature", GROUP_FEATURES + ["all"])
def test_random_group_workloads(feature, seed, provider):
    flags = ({f: True for f in GROUP_FEATURES} if feature == "all"
             else {feature: True})
    port = run_both(lambda api: random_group_workload(
        seed, 60, 24, api=api, **flags), provider)
    assert any(p.scheduled for p in port) and not all(
        p.scheduled for p in port)


@pytest.mark.parametrize("provider", PROVIDERS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interpod_workloads(seed, provider):
    run_both(lambda api: random_interpod_workload(
        seed, 60, 30, services=seed == 1, ports=seed == 2, api=api),
        provider)


@pytest.mark.parametrize("interpod", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_policy_workloads(seed, interpod):
    policy = random_policy(seed, count_mode=seed == 1, ports_alias=seed == 2,
                           noexec=seed == 0, sa_entries=1 + seed % 2)
    run_both(lambda api: random_policy_workload(seed, 60, 24,
                                                interpod=interpod, api=api),
             policy=policy)


@pytest.mark.parametrize("version", sorted(COMPAT))
def test_compat_policies(version):
    run_both(compat_build, policy=COMPAT[version])


def test_get_backend():
    assert isinstance(get_backend("reference"), ReferenceBackend)
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("jax")


# ---------------------------------------------------------------------------
# predicate by predicate, priority by priority
# ---------------------------------------------------------------------------


def every_plugin_policy(registry):
    """A Policy naming every registered predicate and priority, plus one of
    each parameterized kind (ServiceAffinity, LabelsPresence,
    ServiceAntiAffinity, LabelPreference)."""
    preds = sorted(set(registry.fit_predicates)
                   | set(registry.fit_predicate_factories))
    prios = sorted(registry.priority_factories)
    return {"kind": "Policy",
            "predicates": [{"name": n} for n in preds] + [
                {"name": "SameRegion", "argument": {
                    "serviceAffinity": {"labels": ["region"]}}},
                {"name": "HasFoo", "argument": {"labelsPresence": {
                    "labels": ["foo"], "presence": True}}}],
            "priorities": [{"name": n, "weight": 1} for n in prios] + [
                {"name": "SpreadZones", "weight": 2, "argument": {
                    "serviceAntiAffinity": {"label": "zone"}}},
                {"name": "PreferBar", "weight": 1, "argument": {
                    "labelPreference": {"label": "bar", "presence": True}}}]}


def plugin_engine(providers, resources, volume, decode, snapshot):
    """The scheduler of every_plugin_policy over `snapshot`, as the host
    route assembles it (volume scheduling on, the ResourceLimitsPriority
    gate applied so that its priority is registered), and its node
    infos."""
    registry = providers.default_registry()
    providers.apply_feature_gates(registry, {
        "ResourceLimitsPriorityFunction": True})
    infos = resources.new_node_info_map(snapshot.nodes, snapshot.pods)
    binder = volume.VolumeBinder(snapshot.pvs, snapshot.pvcs,
                                 snapshot.storage_classes, enabled=True)
    placed = [p for p in snapshot.pods if p.spec.node_name]
    args = providers.PluginFactoryArgs(
        pod_lister=lambda: list(placed),
        service_lister=lambda: list(snapshot.services),
        node_info_getter=infos.get,
        pvc_getter=binder.get_pvc, pv_getter=binder.get_pv,
        storage_class_getter=binder.get_class, volume_binder=binder,
        volume_scheduling_enabled=True,
        hard_pod_affinity_symmetric_weight=10)
    policy = decode(every_plugin_policy(registry))
    return providers.create_from_config(policy, args, registry=registry), infos


def outcome(fn, *args):
    """fn's result, or its exception's type name and text."""
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001 (the two engines must agree)
        return (type(exc).__name__, str(exc))


def plugin_results(api, providers, resources, volume, decode, build):
    snapshot, pods = build(api)
    sched, infos = plugin_engine(providers, resources, volume, decode,
                                 snapshot)
    nodes = snapshot.nodes
    fits = {}
    for pod in pods:
        meta = sched.predicate_meta_producer(pod, infos)
        for name, pred in sorted(sched.predicates.items()):
            for node in nodes:
                got = outcome(pred, pod, meta, infos[node.name])
                if isinstance(got, tuple) and len(got) == 2 \
                        and isinstance(got[1], list):
                    got = (got[0], [r.get_reason() for r in got[1]])
                fits[(pod.name, name, node.name)] = got
    scores = {}
    for pod in pods:
        meta = sched.priority_meta_producer(pod)
        for config in sched.prioritizers:
            if config.function is not None:
                result = outcome(config.function, pod, infos, nodes)
            else:
                result = [config.map_fn(pod, meta, infos[n.name])
                          for n in nodes]
                if config.reduce_fn is not None:
                    config.reduce_fn(pod, meta, infos, result)
            if isinstance(result, list):
                result = [(h.host, h.score) for h in result]
            scores[(pod.name, config.name)] = (config.weight, result)
    return fits, scores


PLUGIN_BUILDS = {
    "groups": lambda api: random_policy_workload(3, 16, 12, api=api),
    "interpod": lambda api: random_policy_workload(4, 16, 12, interpod=True,
                                                   api=api),
    "compat": lambda api: (compat_build(api)[0], compat_build(api)[1][:12]),
}


@pytest.mark.parametrize("build", sorted(PLUGIN_BUILDS))
def test_every_predicate_and_priority(build):
    build = PLUGIN_BUILDS[build]
    jfits, jscores = plugin_results(jax_api, jax_providers, jax_resources,
                                    jax_volume, jax_decode, build)
    pfits, pscores = plugin_results(port_api, port_providers, port_resources,
                                    port_volume, port_decode, build)
    assert pfits == jfits
    assert pscores == jscores
    # every predicate both passed and failed somewhere, and every priority
    # scored some pod on some node
    by_pred = {}
    for (_, name, _), got in pfits.items():
        by_pred.setdefault(name, set()).add(got[0] if isinstance(got[0], bool)
                                            else "raised")
    assert len(by_pred) >= 20
    assert {name for name, seen in by_pred.items() if True in seen} \
        == set(by_pred)
    assert len({name for _, name in pscores}) >= 12


# ---------------------------------------------------------------------------
# the host route against the device routes: FitError text is built by
# FitError.error() on the host and by format_fit_error on the card
# ---------------------------------------------------------------------------

SPLIT_ROUTES = {
    "config4_slice": (lambda api: build_workload(300, 8, affinity=True,
                                                 api=api), None),
    "groups": (lambda api: random_group_workload(
        0, 60, 24, api=api, **{f: True for f in GROUP_FEATURES}), None),
    "interpod": (lambda api: random_interpod_workload(0, 60, 30, api=api),
                 None),
    "policy": (lambda api: random_policy_workload(0, 60, 24, interpod=True,
                                                  api=api),
               random_policy(0, noexec=True)),
}


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("name", sorted(SPLIT_ROUTES))
def test_host_route_matches_device_routes(name, route):
    build, policy = SPLIT_ROUTES[name]
    snapshot, pods = build(port_api)
    host = ReferenceBackend(policy=policy and port_decode(policy)).schedule(
        [p.copy() for p in pods], snapshot)
    backend = TorchBackend(device="cpu", route=route, fallback="error",
                           policy=policy and port_decode(policy))
    device = backend.schedule([p.copy() for p in pods], snapshot)
    assert backend.last_route == route
    assert [(p.pod.name, p.node_name, p.reason, p.message) for p in device] \
        == [(p.pod.name, p.node_name, p.reason, p.message) for p in host]
    assert any(p.scheduled for p in host) and len({
        p.message for p in host if not p.scheduled}) > 1
