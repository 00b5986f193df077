"""The port's pod-group variants (host ports, services, pod volumes) against
the JAX package: the same group tables and int32 plan, bit-equal scans with
the presence and used-volume carries (XLA scan, and once the Pallas kernel
in interpret mode), the same placements and FitError text as JaxBackend and
ReferenceBackend, and the same budget refusals. Everything is an integer,
so every comparison is exact (tolerance 0).

Workloads are built from a seed through either package's API module. A
CUDA-marked test holds the kernel's group variant against its plain version
when a card is present.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.backends import ReferenceBackend  # noqa: E402
from tpusim.backends import placement_hash as jax_hash  # noqa: E402
from tpusim.jaxe import fastscan as jfs  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402
from tpusim.jaxe.backend import JaxBackend  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import config as pconfig  # noqa: E402
from tpusim_torch import fastplan as pfp  # noqa: E402
from tpusim_torch import state as pstate  # noqa: E402
from tpusim_torch.backend import TorchBackend, placement_hash  # noqa: E402
from tpusim_torch.fastscan import (  # noqa: E402
    DevicePlan,
    carry_tensors,
    fast_scan,
    pod_matrix,
)
from tpusim_torch.kernels.fastscan import (  # noqa: E402
    fastscan_chunk,
    fastscan_chunk_plain,
)
from tpusim_torch.state import (  # noqa: E402
    BIT_DISK_CONFLICT,
    BIT_HOST_PORTS,
    BIT_MAX_VOLUME_COUNT,
    BIT_VOLUME_ZONE_CONFLICT,
    NUM_FIXED_BITS,
)
from tpusim_torch.workloads import (  # noqa: E402
    groups_workload,
    random_group_workload,
)

ALL = dict(ports=True, services=True, disk=True, vol_zone=True, maxpd=True)
FEATURES = {
    "ports": dict(ports=True),
    "services_zones": dict(services=True),
    "disk": dict(disk=True),
    "vol_zone": dict(vol_zone=True),
    "maxpd": dict(maxpd=True),
    "combined": ALL,
}


def random_build(name, seed=3, num_pods=120, num_nodes=80):
    return lambda api: random_group_workload(seed, num_pods, num_nodes,
                                             api=api, **FEATURES[name])


BUILDS = {name: random_build(name) for name in FEATURES}
BUILDS["groups_workload"] = lambda api: groups_workload(2_000, 500, api=api)


def both(build, most_requested=False):
    """[(compiled, cols, (plan, why)) for the JAX package, then the port]."""
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


def assert_plans_equal(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, f.name
            assert a.dtype == np.int32, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# (a) group tables and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_group_tables_and_plan_match(name):
    (jc, jcols, (jplan, jwhy)), (pc, pcols, (pplan, pwhy)) = both(BUILDS[name])
    for f in dataclasses.fields(pc.groups):
        assert np.array_equal(getattr(pc.groups, f.name),
                              getattr(jc.groups, f.name)), f.name
    for flag in ("has_ports", "has_services", "has_interpod",
                 "has_disk_conflict", "has_maxpd", "has_vol_zone",
                 "maxpd_limits", "n_zone_doms", "unsupported"):
        assert getattr(pc, flag) == getattr(jc, flag), flag
    assert np.array_equal(pcols.group_id, jcols.group_id)
    assert jplan is not None and pplan is not None, (jwhy, pwhy)
    assert_plans_equal(pplan, jplan)
    assert_plans_equal(pfp.plan_from_numpy(dataclasses.asdict(jplan)), pplan)
    assert pc.groups.presence.sum() > 0   # running pods seed the presence


def test_feature_flags_follow_the_workload():
    want = {"ports": ("has_ports",), "services_zones": ("has_services",),
            "disk": ("has_disk_conflict", "has_maxpd"),
            "vol_zone": ("has_vol_zone",), "maxpd": ("has_maxpd",)}
    flags = ("has_ports", "has_services", "has_disk_conflict", "has_maxpd",
             "has_vol_zone")
    for name, on in want.items():
        _, (pc, _, (plan, _)) = both(BUILDS[name])
        assert {f for f in flags if getattr(pc, f)} == set(on), name
        # vol-zone- and MaxPD-only plans carry group ids but no presence
        assert (plan.num_groups == 0) == (name in ("vol_zone", "maxpd"))
        assert plan.gid is not None


# ---------------------------------------------------------------------------
# (b) the plain chunk against the JAX XLA scan, whole carry included
# ---------------------------------------------------------------------------

CARRY_FIELDS = ("used_cpu", "used_mem", "used_gpu", "used_eph",
                "nonzero_cpu", "nonzero_mem", "pod_count")


def xla_case(build, most_requested):
    """(JAX plan, XLA final carry, choices, counts, advanced)."""
    snapshot, pods = build(jax_api)
    compiled, cols = jstate.compile_cluster(snapshot, pods)
    assert not compiled.unsupported
    config = jk.config_for([compiled], most_requested=most_requested,
                           num_reason_bits=NUM_FIXED_BITS
                           + len(compiled.scalar_names))
    plan, why = jfs.plan_fast(config, compiled, cols)
    assert plan is not None, why
    carry, choices, counts, advanced = jk.schedule_scan(
        config, jk.carry_init(compiled), jk.statics_to_device(compiled),
        jk.pod_columns_to_device(cols))
    return (plan, carry, np.asarray(choices), np.asarray(counts),
            np.asarray(advanced))


def assert_carry_matches_xla(plan, carry_out, xla):
    n = plan.num_nodes
    gcds = dict(zip(CARRY_FIELDS, (*plan.gcds, plan.gcds[0], plan.gcds[1], 1)))
    for i, name in enumerate(CARRY_FIELDS):
        want = np.asarray(getattr(xla, name)).astype(np.int64)
        got = carry_out.rows[i].cpu().numpy().reshape(-1)
        assert np.array_equal(got[:n], want // gcds[name]), name
        assert not got[n:].any(), f"{name}: pad nodes were bound"
    assert int(carry_out.misc.reshape(-1)[0]) == int(np.asarray(xla.rr))
    if plan.num_groups:
        pres = np.asarray(xla.presence)
        got = carry_out.pres.cpu().numpy()
        assert np.array_equal(got[:pres.shape[0], :n], pres)
        assert not got[pres.shape[0]:].any() and not got[:, n:].any()
    else:
        assert carry_out.pres is None
    if plan.has_maxpd:
        uv = np.asarray(xla.used_vols).T.astype(np.int32)
        got = carry_out.uv.cpu().numpy()
        assert np.array_equal(got[:plan.n_vols, :n], uv[:plan.n_vols])
        assert not got[plan.n_vols:].any() and not got[:, n:].any()
    else:
        assert carry_out.uv is None


def run_against_xla(build, most_requested, chunk=7):
    plan, xcarry, xch, xcnt, xadv = xla_case(build, most_requested)
    port_plan = pfp.plan_from_numpy(dataclasses.asdict(plan))
    ch, cnt, adv, carry = fast_scan(port_plan, chunk=chunk, device="cpu",
                                    return_carry=True)
    assert np.array_equal(ch, xch)
    assert np.array_equal(cnt, xcnt)
    assert np.array_equal(adv, xadv)
    assert_carry_matches_xla(plan, carry, xcarry)
    assert 0 < int((ch >= 0).sum()) < len(ch)   # both outcomes exercised
    return plan, ch, cnt


@pytest.mark.parametrize("name,most_requested", [
    ("ports", False), ("services_zones", False), ("services_zones", True),
    ("disk", False), ("vol_zone", True), ("maxpd", False),
    ("combined", False), ("combined", True)])
def test_plain_chunk_matches_xla_scan(name, most_requested):
    run_against_xla(random_build(name, seed=5), most_requested)


def test_feature_reasons_reach_the_histogram(monkeypatch):
    """Pods that fit nowhere because of ports, disks, volume zones or MaxPD
    report those reasons, bit-equal to the XLA scan: a small cluster with
    a MaxPD limit of 1 (KUBE_MAX_PD_VOLS)."""
    monkeypatch.setenv("KUBE_MAX_PD_VOLS", "1")
    build = lambda api: random_group_workload(  # noqa: E731
        19, 240, 10, api=api, **ALL)
    plan, _, cnt = run_against_xla(build, False)
    assert plan.maxpd_limits == (1, 1, 1)
    for bit in (BIT_HOST_PORTS, BIT_DISK_CONFLICT, BIT_MAX_VOLUME_COUNT,
                BIT_VOLUME_ZONE_CONFLICT):
        assert cnt[:, bit].any(), bit


@pytest.mark.parametrize("limit", ["1", "2"])
def test_low_maxpd_limit_matches_xla(monkeypatch, limit):
    monkeypatch.setenv("KUBE_MAX_PD_VOLS", limit)
    build = lambda api: random_group_workload(  # noqa: E731
        6, 150, 20, api=api, maxpd=True, disk=True)
    plan, _, cnt = run_against_xla(build, True)
    assert plan.maxpd_limits == (int(limit),) * 3
    assert cnt[:, BIT_MAX_VOLUME_COUNT].any()


def test_chunking_ghosts_and_resume_are_invisible(monkeypatch):
    plan, xcarry, xch, xcnt, xadv = xla_case(random_build("combined", 7),
                                             False)
    port_plan = pfp.plan_from_numpy(dataclasses.asdict(plan))
    monkeypatch.setenv("TPUSIM_FAST_SYNC_EVERY", "1")
    # 120 pods in launches of 50: the last launch is 20 pods and 30 ghosts
    ghosted = fast_scan(port_plan, chunk=50, device="cpu", return_carry=True)
    head = fast_scan(port_plan, chunk=16, stop=37, device="cpu",
                     return_carry=True)
    tail = fast_scan(port_plan, chunk=16, start=37, device="cpu",
                     carry_in=head[3], return_carry=True)
    for got in (ghosted[:3], tuple(np.concatenate([h, t])
                                   for h, t in zip(head[:3], tail[:3]))):
        assert np.array_equal(got[0], xch)
        assert np.array_equal(got[1], xcnt)
        assert np.array_equal(got[2], xadv)
    for carry in (ghosted[3], tail[3]):
        assert_carry_matches_xla(plan, carry, xcarry)


# ---------------------------------------------------------------------------
# (c) the Pallas kernel itself, interpret mode
# ---------------------------------------------------------------------------


def test_plain_chunk_matches_pallas_interpret():
    """One all-combined case against the Pallas kernel (interpret mode):
    choices, counts, advanced, every carry row, presence, used volumes and
    rr bit-equal."""
    plan, *_ = xla_case(random_build("combined", seed=8, num_pods=16,
                                     num_nodes=40), True)
    assert plan.num_groups and plan.has_maxpd and plan.has_vol_zone
    jch, jcnt, jadv, jcarry = jfs.fast_scan(plan, interpret=True,
                                            return_carry=True)
    port_plan = pfp.plan_from_numpy(dataclasses.asdict(plan))
    ch, cnt, adv, carry = fast_scan(port_plan, device="cpu",
                                    return_carry=True)
    assert np.array_equal(ch, np.asarray(jch))
    assert np.array_equal(cnt, np.asarray(jcnt))
    assert np.array_equal(adv, np.asarray(jadv))
    for i in range(7):
        assert np.array_equal(carry.rows[i].numpy(),
                              np.asarray(jcarry.rows[i])), i
    assert np.array_equal(carry.pres.numpy(), np.asarray(jcarry.pres))
    assert np.array_equal(carry.uv.numpy(), np.asarray(jcarry.uv))
    assert int(carry.misc[0, 0]) == int(np.asarray(jcarry.misc)[0, 0])


# ---------------------------------------------------------------------------
# (d) TorchBackend against JaxBackend and ReferenceBackend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("provider", ["DefaultProvider", "TalkintDataProvider"])
@pytest.mark.parametrize("name", sorted(FEATURES))
def test_backend_parity_with_jax_and_reference(name, provider):
    build = random_build(name, seed=9, num_pods=80, num_nodes=30)
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    ref = ReferenceBackend(provider=provider).schedule(jpods, jsnap)
    jx = JaxBackend(provider=provider, fallback="error").schedule(jpods, jsnap)
    port = TorchBackend(provider=provider, device="cpu",
                        fallback="error").schedule(ppods, psnap)
    assert [(p.pod.name, p.node_name, p.reason, p.message) for p in port] \
        == [(r.pod.name, r.node_name, r.reason, r.message) for r in ref]
    assert placement_hash(port) == jax_hash(ref) == jax_hash(jx)
    assert any(p.scheduled for p in port) and not all(
        p.scheduled for p in port)


def test_groups_workload_end_to_end():
    """groups_workload(2_000, 500) through the port and the JAX XLA scan:
    the same placements, choices and FitError text."""
    jsnap, jpods = groups_workload(2_000, 500, api=jax_api)
    psnap, ppods = groups_workload(2_000, 500)
    jx = JaxBackend(fallback="error").schedule(jpods, jsnap)
    backend = TorchBackend(device="cpu", fallback="error")
    port = backend.schedule(ppods, psnap)
    assert placement_hash(port) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]
    index = {n.name: i for i, n in enumerate(jsnap.nodes)}
    choices = np.array([index[p.node_name] if p.node_name else -1 for p in jx],
                       dtype=np.int32)
    assert np.array_equal(backend.last_choices, choices)


def test_interpod_workload_still_raises():
    """A group workload with one inter-pod pod (required hostname
    anti-affinity) runs through the port's inter-pod variant: the same
    placements and FitError text as JaxBackend. The cluster keeps its
    hostname domains within the kernel's budget (63 nodes or fewer)."""
    def build(api):
        snapshot, pods = random_group_workload(3, 120, 40, api=api, **ALL)
        pods.append(api.make_pod(
            "anti", milli_cpu=100, labels={"app": "a0"},
            affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "a0"}},
                     "topologyKey": "kubernetes.io/hostname"}]}}))
        return snapshot, pods

    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    jx = JaxBackend(fallback="error").schedule(jpods, jsnap)
    port = TorchBackend(device="cpu", fallback="error").schedule(ppods, psnap)
    assert placement_hash(port) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]
    assert any(p.scheduled for p in port) and not all(
        p.scheduled for p in port)


# ---------------------------------------------------------------------------
# (e) budget refusals, word for word the JAX package's
# ---------------------------------------------------------------------------


def _zone_blend_overflow(api):
    # 2,000 pods a node, 20 nodes a zone: the blend's products pass int32
    # while the balanced-allocation products (1-core, 1 GiB units) do not
    nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=8 * 1024**3,
                           pods=2_000,
                           labels={"failure-domain.beta.kubernetes.io/zone":
                                   f"z{i % 2}"})
             for i in range(40)]
    svc = api.Service.from_obj({"metadata": {"name": "s"},
                                "spec": {"selector": {"app": "a"}}})
    pods = [api.make_pod(f"p{i}", milli_cpu=1000, memory=1024**3,
                         labels={"app": "a"})
            for i in range(3)]
    return api.ClusterSnapshot(nodes=nodes, services=[svc]), pods


def _many_groups(api):
    # 40 Services over 40 apps: 44 merged groups, past the default 32
    snapshot, pods = random_group_workload(4, 80, 20, api=api, ports=True)
    snapshot.services = [api.Service.from_obj(
        {"metadata": {"name": f"s{a}"}, "spec": {"selector": {"app": f"x{a}"}}})
        for a in range(40)]
    pods += [api.make_pod(f"x{a}", milli_cpu=100, labels={"app": f"x{a}"})
             for a in range(40)]
    return snapshot, pods


def _many_volumes(api):
    # 40 Azure disk ids, past the default MaxPD budget of 32
    snapshot, pods = random_group_workload(4, 40, 20, api=api)
    pods += [api.make_pod(f"v{v}", milli_cpu=100, volumes=[
        api.make_pod_volume("d", source={"azureDisk": {
            "diskName": f"disk-{v}", "diskURI": f"u{v}"}})])
        for v in range(40)]
    return snapshot, pods


@pytest.mark.parametrize("env,build,reason", [
    ({}, _many_groups, "44 pod groups exceed"),
    ({}, _many_volumes, "40 MaxPD volume ids exceed"),
    ({"TPUSIM_FAST_MAX_GROUPS": "4"}, BUILDS["combined"], "pod groups exceed"),
    ({"TPUSIM_FAST_MAX_ZONES": "2"}, BUILDS["services_zones"],
     "zone domains exceed"),
    ({}, _zone_blend_overflow, "zone-blend products exceed int32"),
    ({"TPUSIM_FAST_MAX_VOLS": "2"}, BUILDS["maxpd"], "MaxPD volume ids exceed"),
])
def test_plan_budget_refusals_match(monkeypatch, env, build, reason):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    (_, _, (jplan, jwhy)), (_, _, (pplan, pwhy)) = both(build)
    assert jplan is None and pplan is None
    assert pwhy == jwhy and reason in pwhy
    snapshot, pods = build(port_api)
    with pytest.raises(NotImplementedError, match=reason):
        TorchBackend(device="cpu", route="kernel").schedule(pods, snapshot)
    backend = TorchBackend(device="cpu")
    backend.schedule(pods, snapshot)
    assert (backend.last_route, backend.last_route_reason) == ("scan", pwhy)


@pytest.mark.parametrize("env,build", [
    ({"TPUSIM_MAX_GROUPS": "2"}, BUILDS["combined"]),
    ({"TPUSIM_MAX_RAW_GROUPS": "3"}, BUILDS["ports"]),
    ({"TPUSIM_MAX_VOLUME_IDS": "1"}, BUILDS["maxpd"]),
])
def test_unsupported_compile_raises_with_jax_reason(monkeypatch, env, build):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    (jc, _, _), (pc, _, _) = both(build)
    assert pc.unsupported and pc.unsupported == jc.unsupported
    jsnap, jpods = build(jax_api)
    with pytest.raises(NotImplementedError) as jerr:
        JaxBackend(fallback="error").schedule(jpods, jsnap)
    psnap, ppods = build(port_api)
    with pytest.raises(NotImplementedError) as perr:
        TorchBackend(device="cpu", fallback="error").schedule(ppods, psnap)
    detail = str(jerr.value).split(": ", 1)[1]
    assert str(perr.value).split(": ", 1)[1] == detail
    # the default backend runs the workload on the host route, placed as
    # the JAX package's backend places it on its reference fallback
    jx = JaxBackend(fallback="reference").schedule(jpods, jsnap)
    backend = TorchBackend(device="cpu")
    port = backend.schedule(ppods, psnap)
    assert (backend.last_route, backend.last_route_reason) == \
        ("reference", detail)
    assert placement_hash(port) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]
    assert any(p.scheduled for p in port)


def test_unresolvable_claim_with_zones_is_unsupported():
    def build(api):
        snapshot, pods = random_group_workload(2, 20, 10, api=api,
                                               vol_zone=True)
        pods.append(api.make_pod("lost", milli_cpu=100, volumes=[
            api.make_pod_volume("z", pvc="missing")]))
        return snapshot, pods

    (jc, _, _), (pc, _, _) = both(build)
    assert pc.unsupported == jc.unsupported
    assert "unresolvable PersistentVolumeClaim" in pc.unsupported[0]


# ---------------------------------------------------------------------------
# (f) the CUDA kernel's group variant against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,most_requested", [
    ("combined", False), ("combined", True), ("maxpd", False),
    ("vol_zone", True)])
def test_cuda_group_kernel_matches_plain(monkeypatch, name, most_requested):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    monkeypatch.setenv("KUBE_MAX_PD_VOLS", "2")
    plan, *_ = xla_case(random_build(name, seed=12, num_pods=96,
                                     num_nodes=300), most_requested)
    port_plan = pfp.plan_from_numpy(dataclasses.asdict(plan))
    outs = {}
    for dev in ("cpu", "cuda"):
        d = torch.device(dev)
        dp = DevicePlan(port_plan, d)
        carry, misc = carry_tensors(pfp.init_carry(port_plan), d)
        pods = torch.from_numpy(pod_matrix(port_plan, 0, 96, 96)).to(d)
        run = fastscan_chunk_plain if dev == "cpu" else fastscan_chunk
        res = run(pods, dp.statics, dp.tables, carry, misc, dp.alloc_scalar,
                  port_plan.num_scalars, NUM_FIXED_BITS, most_requested,
                  dp.groups)
        outs[dev] = [t.cpu() for t in (*res, carry, misc)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)
