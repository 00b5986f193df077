"""The port's inter-pod (anti)affinity (Variant 3) against the JAX package:
the same group tables and int32 plan, bit-equal scans with the presence and
presence_dom carries (XLA scan, and once the Pallas kernel in interpret
mode), the same placements and FitError text as JaxBackend and
ReferenceBackend, and the same refusals. Everything is an integer, so every
comparison is exact (tolerance 0).

Workloads are built from a seed through either package's API module. The
CUDA kernel's inter-pod instantiation is held against its plain version in
tests/test_torch_interpod_cuda.py, which needs only the port.
"""

import dataclasses

import numpy as np
import pytest

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
from tpusim_torch.fastscan import fast_scan  # noqa: E402
from tpusim_torch.state import (  # noqa: E402
    BIT_AFFINITY_NOT_MATCH,
    BIT_AFFINITY_RULES,
    BIT_ANTI_AFFINITY_RULES,
    BIT_EXISTING_ANTI_AFFINITY,
    NUM_FIXED_BITS,
    reason_strings,
)
from tpusim_torch.workloads import (  # noqa: E402
    interpod_workload,
    random_interpod_workload,
)

IP_BITS = (BIT_AFFINITY_NOT_MATCH, BIT_EXISTING_ANTI_AFFINITY,
           BIT_AFFINITY_RULES, BIT_ANTI_AFFINITY_RULES)
REQUIRED = "requiredDuringSchedulingIgnoredDuringExecution"
PREFERRED = "preferredDuringSchedulingIgnoredDuringExecution"


def random_build(seed, num_pods=150, num_nodes=30, services=False,
                 ports=False):
    return lambda api: random_interpod_workload(
        seed, num_pods, num_nodes, services=services, ports=ports, api=api)


BUILDS = {
    "plain": random_build(0),
    "services": random_build(1, services=True),
    "ports": random_build(2, ports=True),
    "services_ports": random_build(3, services=True, ports=True),
    "hostname_63_nodes": random_build(4, num_pods=100, num_nodes=63),
    "interpod_workload": lambda api: interpod_workload(2_000, 500, api=api),
}


def both(build, most_requested=False, hard_weight=10):
    """[(compiled, cols, (plan, why)) for the JAX package, then the port]."""
    out = []
    for api, st, cfg_for, plan_fast in (
            (jax_api, jstate,
             lambda c: jk.config_for(
                 [c], most_requested,
                 jstate.NUM_FIXED_BITS + len(c.scalar_names),
                 hard_weight=hard_weight),
             jfs.plan_fast),
            (port_api, pstate,
             lambda c: pconfig.config_for(c, most_requested, hard_weight),
             pfp.plan_fast)):
        snapshot, pods = build(api)
        compiled, cols = st.compile_cluster(snapshot, pods)
        out.append((compiled, cols, plan_fast(cfg_for(compiled), compiled,
                                              cols)))
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
def test_interpod_tables_and_plan_match(name):
    (jc, jcols, (jplan, jwhy)), (pc, pcols, (pplan, pwhy)) = both(BUILDS[name])
    for f in dataclasses.fields(pc.groups):
        assert np.array_equal(getattr(pc.groups, f.name),
                              getattr(jc.groups, f.name)), f.name
    for flag in ("has_ports", "has_services", "has_interpod",
                 "has_disk_conflict", "has_maxpd", "has_vol_zone",
                 "n_topo_doms", "n_zone_doms", "unsupported"):
        assert getattr(pc, flag) == getattr(jc, flag), flag
    assert pc.has_interpod
    assert np.array_equal(pcols.group_id, jcols.group_id)
    assert jplan is not None and pplan is not None, (jwhy, pwhy)
    assert_plans_equal(pplan, jplan)
    assert_plans_equal(pfp.plan_from_numpy(dataclasses.asdict(jplan)), pplan)
    assert pplan.has_interpod and pplan.presence_dom.sum() > 0


def test_random_workload_reaches_every_term_case():
    """The random workload carries what the kernel must handle: an
    empty-key term on each side, a first pod matching its own affinity
    term, a pod that exists but lies in no domain, hostname, zone and rack
    keys, and negative preferred weights."""
    (_, _, _), (pc, _, (plan, _)) = both(BUILDS["plain"])
    gt = pc.groups
    assert gt.aff_err.any() and gt.aff_self.any() and gt.aff_unplaced.any()
    assert (gt.anti_valid & gt.anti_empty).any()
    assert gt.aff_hostname.any() or gt.anti_hostname.any()
    assert plan.n_topo_keys == 3 and (gt.pref_w < 0).any()


# ---------------------------------------------------------------------------
# (b) the plain chunk against the JAX XLA scan, whole carry included
# ---------------------------------------------------------------------------

CARRY_FIELDS = ("used_cpu", "used_mem", "used_gpu", "used_eph",
                "nonzero_cpu", "nonzero_mem", "pod_count")


def xla_case(build, most_requested, hard_weight=10):
    """(JAX plan, XLA final carry, choices, counts, advanced)."""
    snapshot, pods = build(jax_api)
    compiled, cols = jstate.compile_cluster(snapshot, pods)
    assert not compiled.unsupported
    config = jk.config_for([compiled], most_requested=most_requested,
                           num_reason_bits=NUM_FIXED_BITS
                           + len(compiled.scalar_names),
                           hard_weight=hard_weight)
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
    pres = np.asarray(xla.presence)
    got = carry_out.pres.cpu().numpy()
    assert np.array_equal(got[:pres.shape[0], :n], pres)
    assert not got[pres.shape[0]:].any() and not got[:, n:].any()
    pd = np.asarray(xla.presence_dom)
    g, k, d = pd.shape
    got = carry_out.pd.cpu().numpy()
    assert np.array_equal(got[:g * k, :d], pd.reshape(g * k, d))
    assert not got[g * k:].any() and not got[:, d:].any()


def run_against_xla(build, most_requested, hard_weight=10, chunk=64):
    plan, xcarry, xch, xcnt, xadv = xla_case(build, most_requested,
                                             hard_weight)
    port_plan = pfp.plan_from_numpy(dataclasses.asdict(plan))
    ch, cnt, adv, carry = fast_scan(port_plan, chunk=chunk, device="cpu",
                                    return_carry=True)
    assert np.array_equal(ch, xch)
    assert np.array_equal(cnt, xcnt)
    assert np.array_equal(adv, xadv)
    assert_carry_matches_xla(plan, carry, xcarry)
    assert 0 < int((ch >= 0).sum()) < len(ch)   # both outcomes exercised
    return plan, ch, cnt


@pytest.mark.parametrize("name,most_requested,hard_weight", [
    ("plain", False, 10), ("plain", True, 1), ("services", True, 100),
    ("ports", False, 1), ("services_ports", True, 10),
    ("hostname_63_nodes", False, 100)])
def test_plain_chunk_matches_xla_scan(name, most_requested, hard_weight):
    _, _, cnt = run_against_xla(BUILDS[name], most_requested, hard_weight)
    assert cnt[:, BIT_AFFINITY_NOT_MATCH].any()


def test_chunking_ghosts_and_resume_are_invisible(monkeypatch):
    plan, xcarry, xch, xcnt, xadv = xla_case(random_build(7, num_pods=120),
                                             False, 100)
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


def tiny_interpod(api):
    """8 nodes over 3 zones and 2 racks, 2 running pods, 16 pods to place
    with required and preferred terms on the zone, rack and hostname keys,
    the last one needing a pod no one runs: 6 merged groups."""
    nodes = [api.make_node(f"n{i}", milli_cpu=(2000, 4000)[i % 2],
                           memory=4 * 1024**3,
                           labels={"zone": f"z{i % 3}", "rack": f"r{i % 2}"})
             for i in range(8)]

    def term(app, key):
        return {"labelSelector": {"matchLabels": {"app": app}},
                "topologyKey": key}

    kinds = [
        None,
        {"podAntiAffinity": {REQUIRED: [term("a0", "kubernetes.io/hostname")]}},
        {"podAffinity": {REQUIRED: [term("a1", "zone")],
                         PREFERRED: [{"weight": -50,
                                      "podAffinityTerm": term("a0", "rack")}]}},
        {"podAntiAffinity": {PREFERRED: [
            {"weight": 10, "podAffinityTerm": term("a1", "zone")}]}},
    ]

    def pod(name, app, kind, **kw):
        if kinds[kind]:
            kw["affinity"] = kinds[kind]
        return api.make_pod(name, milli_cpu=700, memory=2**28,
                            labels={"app": app}, **kw)

    existing = [pod("e0", "a0", 1, node_name="n0", phase="Running"),
                pod("e1", "a1", 3, node_name="n5", phase="Running")]
    pods = [pod(f"p{i}", ("a0", "a1")[i % 2], (i * 3) % 4) for i in range(15)]
    pods.append(api.make_pod("lost", milli_cpu=100, labels={"app": "x"},
                             affinity={"podAffinity": {
                                 REQUIRED: [term("nobody", "zone")]}}))
    return api.ClusterSnapshot(nodes=nodes, pods=existing), pods


def test_plain_chunk_matches_pallas_interpret():
    """One small case against the Pallas kernel (interpret mode): choices,
    counts, advanced, every carry row, presence, presence_dom and rr
    bit-equal."""
    plan, *_ = xla_case(tiny_interpod, True)
    assert plan.has_interpod and plan.num_groups <= 8
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
    assert np.array_equal(carry.pd.numpy(), np.asarray(jcarry.pd))
    assert int(carry.misc[0, 0]) == int(np.asarray(jcarry.misc)[0, 0])
    assert 0 < int((ch >= 0).sum()) < len(ch)


# ---------------------------------------------------------------------------
# (d) TorchBackend against JaxBackend and ReferenceBackend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("provider,hard_weight,seed", [
    ("DefaultProvider", 10, 0), ("TalkintDataProvider", 1, 2),
    ("DefaultProvider", 100, 4)])
def test_backend_parity_with_jax_and_reference(provider, hard_weight, seed):
    build = random_build(seed, num_pods=80, num_nodes=24, services=True)
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    ref = ReferenceBackend(
        provider=provider,
        hard_pod_affinity_symmetric_weight=hard_weight).schedule(jpods, jsnap)
    jx = JaxBackend(provider=provider, fallback="error",
                    hard_pod_affinity_symmetric_weight=hard_weight
                    ).schedule(jpods, jsnap)
    port = TorchBackend(provider=provider, device="cpu", fallback="error",
                        hard_pod_affinity_symmetric_weight=hard_weight
                        ).schedule(ppods, psnap)
    assert [(p.pod.name, p.node_name, p.reason, p.message) for p in port] \
        == [(r.pod.name, r.node_name, r.reason, r.message) for r in ref]
    assert placement_hash(port) == jax_hash(ref) == jax_hash(jx)
    assert any(p.scheduled for p in port) and not all(
        p.scheduled for p in port)


def test_every_interpod_reason_reaches_the_fit_error():
    """Pods that fit nowhere for inter-pod reasons report each of the four
    reasons, byte-identical to JaxBackend's text."""
    jsnap, jpods = random_build(0, num_pods=80, num_nodes=24)(jax_api)
    psnap, ppods = random_build(0, num_pods=80, num_nodes=24)(port_api)
    jx = JaxBackend(fallback="error").schedule(jpods, jsnap)
    port = TorchBackend(device="cpu", fallback="error").schedule(ppods, psnap)
    assert [p.message for p in port] == [p.message for p in jx]
    text = " ".join(p.message for p in port)
    strings = reason_strings(())
    for bit in IP_BITS:
        assert strings[bit] in text, strings[bit]


# ---------------------------------------------------------------------------
# (e) refusals, word for word the JAX package's
# ---------------------------------------------------------------------------


def _pods_with_terms(api, terms_of, num_nodes=6, num_pods=4, weight=None):
    nodes = [api.make_node(f"n{i}", labels={"zone": f"z{i % 2}"})
             for i in range(num_nodes)]
    pods = []
    for i in range(num_pods):
        terms = terms_of(i)
        if weight is None:
            aff = {"podAffinity": {REQUIRED: terms}}
        else:
            aff = {"podAffinity": {PREFERRED: [
                {"weight": weight, "podAffinityTerm": t} for t in terms]}}
        pods.append(api.make_pod(f"p{i}", milli_cpu=100, labels={"app": "a"},
                                 affinity=aff))
    return api.ClusterSnapshot(nodes=nodes), pods


def _term(key, app="a"):
    return {"labelSelector": {"matchLabels": {"app": app}},
            "topologyKey": key}


def _five_keys(api):
    return _pods_with_terms(api, lambda i: [_term(f"key{i}")], num_pods=5)


def _hostname_70_nodes(api):
    return _pods_with_terms(
        api, lambda i: [_term("kubernetes.io/hostname")], num_nodes=70)


def _five_terms(api):
    return _pods_with_terms(
        api, lambda i: [_term("zone", f"a{t}") for t in range(5)])


def _weight_mass(api):
    return _pods_with_terms(api, lambda i: [_term("zone")], num_pods=40,
                            weight=5_000_000)


@pytest.mark.parametrize("build,reason", [
    (_five_keys, "5 topology keys exceed the fast-path budget"),
    (_hostname_70_nodes, "71 topology domains exceed the fast-path budget"),
    (_five_terms, "5 inter-pod terms exceed the fast-path budget"),
    (_weight_mass, "inter-pod priority counts exceed int32"),
])
def test_interpod_budget_refusals_match(build, reason):
    (_, _, (jplan, jwhy)), (_, _, (pplan, pwhy)) = both(build)
    assert jplan is None and pplan is None
    assert pwhy == jwhy and reason in pwhy
    snapshot, pods = build(port_api)
    with pytest.raises(NotImplementedError) as err:
        TorchBackend(device="cpu", route="kernel").schedule(pods, snapshot)
    assert str(err.value) == f"torch backend: {jwhy}"
    backend = TorchBackend(device="cpu")
    backend.schedule(pods, snapshot)
    assert (backend.last_route, backend.last_route_reason) == ("scan", jwhy)


@pytest.mark.parametrize("weight", [0, 101])
def test_hard_weight_outside_its_range_raises(weight):
    with pytest.raises(ValueError) as jerr:
        JaxBackend(hard_pod_affinity_symmetric_weight=weight)
    with pytest.raises(ValueError) as perr:
        TorchBackend(device="cpu", hard_pod_affinity_symmetric_weight=weight)
    assert str(perr.value) == str(jerr.value)
