"""The port's scheduler policies (Variant 5) against the JAX package: the same
compiled policy, policy tables, group tables and int32 plan, bit-equal scans
with the ServiceAffinity locks in the misc carry (the XLA scan, and once the
Pallas kernel in interpret mode), the same placements and FitError text as
JaxBackend and ReferenceBackend, and the same refusals. Everything is an
integer, so every comparison is exact (tolerance 0).

Workloads are built from a seed through either package's API module. The
CUDA kernel's policy instantiations are held against their plain version in
tests/test_torch_policy_cuda.py, which needs only the port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.backends import ReferenceBackend  # noqa: E402
from tpusim.backends import placement_hash as jax_hash  # noqa: E402
from tpusim.engine.policy import decode_policy as jax_decode  # noqa: E402
from tpusim.jaxe import fastscan as jfs  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import policyc as jpc  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402
from tpusim.jaxe.backend import JaxBackend  # noqa: E402
from tpusim.simulator import run_simulation as jax_run  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import cli  # noqa: E402
from tpusim_torch import config as pconfig  # noqa: E402
from tpusim_torch import fastplan as pfp  # noqa: E402
from tpusim_torch import policyc as ppc  # noqa: E402
from tpusim_torch import state as pstate  # noqa: E402
from tpusim_torch import workloads as W  # noqa: E402
from tpusim_torch.backend import TorchBackend, placement_hash  # noqa: E402
from tpusim_torch.engine.policy import PolicyError  # noqa: E402
from tpusim_torch.engine.policy import decode_policy as port_decode  # noqa: E402
from tpusim_torch.fastscan import fast_scan  # noqa: E402
from tpusim_torch.simulator import run_simulation  # noqa: E402
from tpusim_torch.state import NUM_FIXED_BITS  # noqa: E402
from test_torch_backend import forbid_host_route  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "compat_policies.json")) as _f:
    COMPAT = json.load(_f)
MB = 1024 * 1024


def compat_cluster(api):
    """tests/test_jax_policy.py's compat_cluster through `api`: region,
    zone, foo and bar labels, a Service, labelled running pods and node
    images."""
    nodes = []
    for i in range(9):
        labels = {"region": f"r{i % 2}", "zone": f"z{i % 3}"}
        if i % 3 != 2:
            labels["foo"] = "x"
        if i % 2 == 0:
            labels["bar"] = "y"
        node = api.make_node(f"n{i}", milli_cpu=[2000, 4000, 8000][i % 3],
                             memory=16 * 1024**3, labels=labels)
        if i % 2 == 1:
            obj = node.to_obj()
            obj.setdefault("status", {})["images"] = [
                {"names": [f"img-{i % 3}:v1"], "sizeBytes": 400 * MB}]
            node = api.Node.from_obj(obj)
        nodes.append(node)
    services = [api.Service.from_obj({
        "metadata": {"name": "svc0", "namespace": "default"},
        "spec": {"selector": {"app": "app0"}}})]
    placed = [api.make_pod(f"placed-{i}", milli_cpu=200, memory=128 * MB,
                           node_name=f"n{i % 9}", phase="Running",
                           labels={"app": f"app{i % 2}"}) for i in range(4)]
    return api.ClusterSnapshot(nodes=nodes, pods=placed, services=services)


def compat_workload(api, k=70):
    """tests/test_jax_policy.py's compat_workload through `api`."""
    pods = []
    for i in range(k):
        kw = {}
        if i % 5 == 0:
            kw["node_selector"] = {"region": f"r{i % 2}"}
        p = api.make_pod(f"pod-{i}", milli_cpu=[100, 400, 900][i % 3],
                         memory=[64, 256][i % 2] * MB,
                         labels={"app": f"app{i % 2}"} if i % 3 else None,
                         **kw)
        if i % 4 == 0:
            obj = p.to_obj()
            obj["spec"]["containers"][0]["image"] = f"img-{i % 3}:v1"
            p = api.Pod.from_obj(obj)
        pods.append(p)
    return pods


def compat_build(api):
    return compat_cluster(api), compat_workload(api)


# ---- the policy shapes of tests/test_jax_policy.py, each with its world ----


def _lp(name, labels, presence=True):
    return {"name": name, "argument": {"labelsPresence": {
        "labels": labels, "presence": presence}}}


def _sa(name, labels):
    return {"name": name, "argument": {"serviceAffinity": {"labels": labels}}}


def _prio(name, weight):
    return {"name": name, "weight": weight}


def _policy(preds, prios=None, **kw):
    out = {"kind": "Policy", "predicates": [
        p if isinstance(p, dict) else {"name": p} for p in preds]}
    if prios is not None:
        out["priorities"] = prios
    out.update(kw)
    return out


SHAPES = {
    "count_mode_two_labels": _policy(
        [_lp("LblA", ["x"]), _lp("LblB", ["y"])], [],
        alwaysCheckAllPredicates=True),
    "count_mode_general_and_part": _policy(
        ["GeneralPredicates", "PodFitsResources"], [],
        alwaysCheckAllPredicates=True),
    "count_mode_unschedulable": _policy(
        ["CheckNodeUnschedulable", "PodFitsResources"], [],
        alwaysCheckAllPredicates=True),
    "no_execute": _policy(
        ["PodFitsResources", "PodToleratesNodeNoExecuteTaints"],
        [_prio("LeastRequestedPriority", 1)]),
    "no_execute_count_mode": _policy(
        ["PodToleratesNodeTaints", "PodToleratesNodeNoExecuteTaints",
         "PodFitsResources"], [], alwaysCheckAllPredicates=True),
    "ports_alias": _policy(
        ["PodFitsPorts", "PodFitsResources"],
        [_prio("LeastRequestedPriority", 1)]),
    "ports_fixed_slot": _policy(
        ["PodFitsHostPorts", "PodFitsResources"],
        [_prio("LeastRequestedPriority", 1)]),
    "multi_sa": _policy(
        [_sa("SA-One", ["zone"]), _sa("SA-Two", ["rack"]),
         "PodFitsResources"], [_prio("LeastRequestedPriority", 1)]),
    "hard_weight_override": {"kind": "Policy",
                             "hardPodAffinitySymmetricWeight": 50},
    "duplicates_last_wins": _policy(
        ["PodFitsResources"], [_prio("LeastRequestedPriority", 1),
                               _prio("LeastRequestedPriority", 7)]),
    "label_under_standard_name": _policy(
        [_lp("HostName", ["disktype"]), "PodToleratesNodeTaints"], []),
}


def _port_pod(api, name, port, **kw):
    obj = api.make_pod(name, **kw).to_obj()
    obj["spec"]["containers"][0]["ports"] = [{"containerPort": port,
                                              "hostPort": port}]
    return api.Pod.from_obj(obj)


def shape_world(name, api):
    """A small world on which SHAPES[name] decides placements and reasons:
    nodes missing labels, a cordoned node, NoExecute and NoSchedule taints,
    a host-port conflict, zone and rack ServiceAffinity with a seed pod."""
    if name.startswith("count_mode"):
        nodes = [api.make_node("n0", milli_cpu=100),
                 api.make_node("n1", labels={"x": "1"}),
                 api.make_node("cordoned", unschedulable=True)]
        return api.ClusterSnapshot(nodes=nodes), [
            api.make_pod(f"p{i}", milli_cpu=(100, 500)[i % 2])
            for i in range(4)]
    if name.startswith("no_execute"):
        nodes = [api.make_node("evict", milli_cpu=8000, taints=[
                     {"key": "k", "value": "v", "effect": "NoExecute"}]),
                 api.make_node("soft", milli_cpu=2000, taints=[
                     {"key": "k", "value": "v", "effect": "NoSchedule"}])]
        tol = [{"key": "k", "operator": "Equal", "value": "v",
                "effect": "NoExecute"}]
        pods = [api.make_pod(f"p{i}", milli_cpu=400) for i in range(3)]
        pods.append(api.make_pod("tolerant", milli_cpu=400, tolerations=tol))
        return api.ClusterSnapshot(nodes=nodes), pods
    if name.startswith("ports"):
        nodes = [api.make_node("tiny", milli_cpu=300),
                 api.make_node("roomy", milli_cpu=8000)]
        seeds = [_port_pod(api, "seed", 7070, milli_cpu=200,
                           node_name=node, phase="Running")
                 for node in ("tiny", "roomy")]
        pods = [_port_pod(api, "p", 7070, milli_cpu=200),
                api.make_pod("free", milli_cpu=50)]
        return api.ClusterSnapshot(nodes=nodes, pods=seeds), pods
    if name == "multi_sa":
        nodes = [api.make_node(f"n{i}", milli_cpu=9000, labels={
            "zone": z, "rack": r}) for i, (z, r) in enumerate(
                (("z1", "r1"), ("z1", "r2"), ("z2", "r3")))]
        svc = api.Service.from_obj({
            "metadata": {"name": "db", "namespace": "default"},
            "spec": {"selector": {"app": "db"}}})
        seed = api.make_pod("seed", milli_cpu=100, node_name="n0",
                            phase="Running", labels={"app": "db"})
        pods = [api.make_pod(f"db{i}", milli_cpu=200, labels={"app": "db"})
                for i in range(3)]
        return api.ClusterSnapshot(nodes=nodes, pods=[seed],
                                   services=[svc]), pods
    nodes = []
    for i in range(6):
        labels = {"zone": f"z{i % 2}"}
        if i % 2 == 0:
            labels["disktype"] = "ssd"
        nodes.append(api.make_node(
            f"n{i}", milli_cpu=[2000, 4000, 8000][i % 3],
            memory=16 * 1024**3, labels=labels,
            taints=[{"key": "k", "value": "v", "effect": "NoSchedule"}]
            if i == 5 else None))
    pods = [api.make_pod(f"p{i}", milli_cpu=[300, 900, 1800][i % 3],
                         memory=(256 + 128 * (i % 5)) * MB,
                         node_selector={"disktype": "ssd"} if i % 4 == 0
                         else None) for i in range(12)]
    return api.ClusterSnapshot(nodes=nodes), pods


# ---------------------------------------------------------------------------
# (a) compile_policy, policy tables, group tables and plans
# ---------------------------------------------------------------------------

POLICIES = {**{f"compat_{v}": p for v, p in COMPAT.items()}, **SHAPES}
CP_FIELDS = ("hard_weight", "label_rows", "label_prios", "saa_entries",
             "sa_entries", "unsupported")


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_compile_policy_matches(name):
    want = jpc.compile_policy(jax_decode(POLICIES[name]))
    got = ppc.compile_policy(port_decode(POLICIES[name]))
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
    for f in CP_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert not got.unsupported


def test_embedded_compat_policies_are_upstream():
    for version, policy in W.COMPAT_POLICIES.items():
        assert policy == COMPAT[version], version


def plan_case(build, policy, api, st, cfg_for, plan_fast, pc):
    """(compiled, cols, ptabs, (plan, why)) of one package."""
    cp = pc.compile_policy((jax_decode if pc is jpc else port_decode)(policy))
    ps = cp.spec
    need_noexec = (ps.pred_keys is not None and
                   "PodToleratesNodeNoExecuteTaints" in ps.pred_keys)
    need_saa = bool(ps.saa_weights) or ps.sa_enabled
    snapshot, pods = build(api)
    compiled, cols = st.compile_cluster(snapshot, pods,
                                        need_noexec=need_noexec,
                                        need_saa=need_saa)
    config = dataclasses.replace(cfg_for(compiled, cp.hard_weight or 10),
                                 policy=ps)
    ptabs = pc.build_policy_tables(cp, snapshot, pods, compiled, cols)
    if cp.saa_entries:
        config = dataclasses.replace(config, n_saa_doms=ptabs.n_saa_doms)
    return compiled, cols, ptabs, plan_fast(config, compiled, cols,
                                            ptabs=ptabs)


def both(build, policy, most_requested=False):
    """plan_case for the JAX package, then for the port."""
    return (plan_case(build, policy, jax_api, jstate,
                      lambda c, hw: jk.config_for(
                          [c], most_requested,
                          jstate.NUM_FIXED_BITS + len(c.scalar_names),
                          hard_weight=hw),
                      jfs.plan_fast, jpc),
            plan_case(build, policy, port_api, pstate,
                      lambda c, hw: pconfig.config_for(c, most_requested, hw),
                      pfp.plan_fast, ppc))


def assert_plans_equal(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, f.name
            assert a.dtype == np.int32, f.name
            assert np.array_equal(a, b), f.name
        elif f.name == "policy":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name


def random_build(seed, num_pods=120, num_nodes=40, interpod=False):
    return lambda api: W.random_policy_workload(seed, num_pods, num_nodes,
                                                interpod=interpod, api=api)


RANDOM = {
    "count_noexec_alias": (40, dict(count_mode=True, noexec=True,
                                    ports_alias=True)),
    "two_sa_no_ebs": (41, dict(sa_entries=2, maxpd_off=(0,))),
    "parts_count_mode": (42, dict(general=False, count_mode=True)),
    "two_sa_noexec_parts": (43, dict(sa_entries=2, noexec=True,
                                     general=False)),
    "alias_ebs_only": (44, dict(ports_alias=True, maxpd_off=(1, 2))),
}
PLANS = {**{f"compat_{v}": (compat_build, COMPAT[v]) for v in COMPAT},
         **{k: (random_build(seed), W.random_policy(seed, **kw))
            for k, (seed, kw) in RANDOM.items()},
         "interpod_1.9": (random_build(45, interpod=True),
                          W.COMPAT_POLICIES["1.9"]),
         "policy_workload": (lambda api: W.policy_workload(300, 60, api=api),
                             W.COMPAT_POLICIES["1.2"])}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_policy_tables_and_plan_match(name):
    build, policy = PLANS[name]
    (jc, jcols, jt, (jplan, jwhy)), (pc, pcols, pt, (pplan, pwhy)) = both(
        build, policy)
    for f in dataclasses.fields(pc.groups):
        a, b = getattr(pc.groups, f.name), getattr(jc.groups, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for flag in ("has_noexec_table", "has_saa_table", "unsupported"):
        assert getattr(pc, flag) == getattr(jc, flag), flag
    assert np.array_equal(pc.tables.taint_ok_noexec, jc.tables.taint_ok_noexec)
    for col in ("group_id", "img_id", "sa_self_id"):
        assert np.array_equal(getattr(pcols, col), getattr(jcols, col)), col
    for f in dataclasses.fields(pt):
        a, b = getattr(pt, f.name), getattr(jt, f.name)
        assert np.array_equal(a, b), f.name
    assert jplan is not None and pplan is not None, (jwhy, pwhy)
    assert_plans_equal(pplan, jplan)
    assert_plans_equal(pfp.plan_from_numpy(dataclasses.asdict(jplan)), pplan)
    assert pplan.policy is not None


# ---------------------------------------------------------------------------
# (b) the plain chunk against the JAX XLA scan, locks included
# ---------------------------------------------------------------------------

CARRY_FIELDS = ("used_cpu", "used_mem", "used_gpu", "used_eph",
                "nonzero_cpu", "nonzero_mem", "pod_count")


def xla_case(build, policy):
    """(JAX plan, XLA final carry, choices, counts, advanced), the scan fed
    the policy tables as JaxBackend feeds them."""
    jc, jcols, jt, (plan, why) = both(build, policy)[0]
    assert plan is not None, why
    cp = jpc.compile_policy(jax_decode(policy))
    config = dataclasses.replace(
        jk.config_for([jc], False, NUM_FIXED_BITS + len(jc.scalar_names),
                      hard_weight=cp.hard_weight or 10),
        policy=cp.spec, n_saa_doms=jt.n_saa_doms if cp.saa_entries else 1)
    statics = jk._tree_to_device(jk.statics_to_host(jc)._replace(
        label_ok=jt.label_ok, label_prio=jt.label_prio,
        image_score=jt.image_score, saa_dom=jt.saa_dom, sa_pin=jt.sa_pin,
        sa_val=jt.sa_val))
    carry = jk.carry_init(jc)
    if cp.spec.sa_enabled:
        carry = carry._replace(sa_lock=jt.sa_lock_init)
    carry, choices, counts, advanced = jk.schedule_scan(
        config, carry, statics, jk.pod_columns_to_device(jcols))
    return (plan, carry, np.asarray(choices), np.asarray(counts),
            np.asarray(advanced))


def assert_carry_matches_xla(plan, carry_out, xla):
    n = plan.num_nodes
    gcds = dict(zip(CARRY_FIELDS, (*plan.gcds, plan.gcds[0], plan.gcds[1], 1)))
    for i, name in enumerate(CARRY_FIELDS):
        want = np.asarray(getattr(xla, name)).astype(np.int64)
        got = carry_out.rows[i].cpu().numpy().reshape(-1)
        assert np.array_equal(got[:n], want // gcds[name]), name
    misc = carry_out.misc.reshape(-1).cpu().numpy()
    assert int(misc[0]) == int(np.asarray(xla.rr))
    if plan.sa_lock_init is not None:
        lock = np.asarray(xla.sa_lock)
        assert np.array_equal(misc[1:1 + len(lock)], lock)
    if plan.num_groups:
        pres = np.asarray(xla.presence)
        got = carry_out.pres.cpu().numpy()
        assert np.array_equal(got[:pres.shape[0], :n], pres)
    if plan.has_interpod:
        pd = np.asarray(xla.presence_dom)
        g, k, d = pd.shape
        assert np.array_equal(carry_out.pd.cpu().numpy()[:g * k, :d],
                              pd.reshape(g * k, d))


@pytest.mark.parametrize("name", ["compat_1.0", "compat_1.2", "compat_1.9",
                                  *sorted(RANDOM), "interpod_1.9",
                                  "policy_workload"])
def test_plain_chunk_matches_xla_scan(name):
    build, policy = PLANS[name]
    plan, xcarry, xch, xcnt, xadv = xla_case(build, policy)
    port_plan = pfp.plan_from_numpy(dataclasses.asdict(plan))
    ch, cnt, adv, carry = fast_scan(port_plan, chunk=64, device="cpu",
                                    return_carry=True)
    assert np.array_equal(ch, xch)
    assert np.array_equal(cnt, xcnt)
    assert np.array_equal(adv, xadv)
    assert_carry_matches_xla(plan, carry, xcarry)
    assert int((ch >= 0).sum()) > 0


def test_random_plans_reach_every_stage():
    """Between them the random plans run every opcode of the stage
    program, count mode, two ServiceAffinity entries, a disabled MaxPD type
    and a ServiceAffinity lock taken at a bind."""
    from tpusim_torch.fastscan import DevicePlan

    ops, seen = set(), set()
    for name in (*RANDOM, "interpod_1.9"):
        build, policy = PLANS[name]
        plan = both(build, policy)[1][3][0]
        dp = DevicePlan(plan, "cpu")
        ops |= {op for op, _ in dp.pol.program}
        if plan.policy.always_check_all:
            seen.add("count_mode")
        if len(plan.policy.sa_slots) == 2:
            seen.add("two_sa")
        if not all(plan.maxpd_enabled):
            seen.add("maxpd_off")
        if plan.policy.ports_slots:
            seen.add("ports_alias")
        _, _, _, carry = fast_scan(plan, device="cpu", return_carry=True)
        lanes = carry.misc.reshape(-1)[1:1 + len(plan.sa_lock_init)].numpy()
        if ((lanes >= 0) & (plan.sa_lock_init == -1)).any():
            seen.add("bind_lock")
    from tpusim_torch.kernels.fastscan import NUM_OPS

    assert ops == set(range(NUM_OPS))
    assert seen == {"count_mode", "two_sa", "maxpd_off", "ports_alias",
                    "bind_lock"}


# ---------------------------------------------------------------------------
# (c) the Pallas kernel itself, interpret mode
# ---------------------------------------------------------------------------


def test_plain_chunk_matches_pallas_interpret():
    """Policy 1.1 on the compat workload (ServiceAffinity, ServiceAnti-
    Affinity, a label row and the label priority) against the Pallas
    kernel in interpret mode: choices, counts, advanced, every carry row,
    presence and the misc row with its locks bit-equal."""
    plan = both(compat_build, COMPAT["1.1"])[0][3][0]
    assert plan.sa_val_tbl is not None and plan.saa_dom_tbl is not None
    assert plan.label_tbl is not None and plan.label_prio_row is not None
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
    assert np.array_equal(carry.misc.numpy(), np.asarray(jcarry.misc))
    assert 0 < int((ch >= 0).sum()) < len(ch)


# ---------------------------------------------------------------------------
# (d) TorchBackend against JaxBackend and ReferenceBackend
# ---------------------------------------------------------------------------

BACKEND_CASES = {**{f"compat_{v}": (compat_build, COMPAT[v]) for v in COMPAT},
                 **{name: (lambda api, name=name: shape_world(name, api),
                           policy) for name, policy in SHAPES.items()}}


@pytest.mark.parametrize("name", sorted(BACKEND_CASES))
def test_backend_parity_with_jax_and_reference(name):
    build, policy = BACKEND_CASES[name]
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    ref = ReferenceBackend(policy=jax_decode(policy)).schedule(jpods, jsnap)
    jx = JaxBackend(fallback="error", policy=jax_decode(policy)).schedule(
        jpods, jsnap)
    port = TorchBackend(device="cpu", policy=port_decode(policy),
                        fallback="error").schedule(ppods, psnap)
    assert [(p.pod.name, p.node_name, p.reason, p.message) for p in port] \
        == [(r.pod.name, r.node_name, r.reason, r.message) for r in ref]
    assert placement_hash(port) == jax_hash(ref) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]


def test_run_simulation_and_cli_take_a_policy(tmp_path, capsys, monkeypatch):
    forbid_host_route(monkeypatch)
    jstatus = jax_run(compat_workload(jax_api), compat_cluster(jax_api),
                      backend="jax", policy=jax_decode(COMPAT["1.2"]))
    status = run_simulation(compat_workload(port_api),
                            compat_cluster(port_api), device="cpu",
                            policy=port_decode(COMPAT["1.2"]))
    for attr in ("successful_pods", "failed_pods"):
        assert [(p.name, p.spec.node_name) for p in getattr(status, attr)] \
            == [(p.name, p.spec.node_name) for p in getattr(jstatus, attr)]
    assert status.stop_reason == jstatus.stop_reason
    podspec = tmp_path / "pods.json"
    podspec.write_text(json.dumps([{"name": "small", "num": 3, "pod": {
        "metadata": {"labels": {"app": "web"}},
        "spec": {"containers": [{"name": "c", "resources": {
            "requests": {"cpu": "1", "memory": "1Gi"}}}]}}}]))
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps(SHAPES["duplicates_last_wins"]))
    configmap = tmp_path / "configmap.json"
    configmap.write_text(json.dumps({"kind": "ConfigMap", "data": {
        "policy.cfg": json.dumps(SHAPES["ports_alias"])}}))
    base = ["--podspec", str(podspec), "--synthetic-nodes", "4",
            "--device", "cpu", "--quiet"]
    assert cli.main(base + ["--scheduler-policy-file", str(policy)]) == 0
    assert "3 pod(s) scheduled" in capsys.readouterr().out
    assert cli.main(base + ["--scheduler-policy-configmap-file",
                            str(configmap)]) == 0
    assert "3 pod(s) scheduled" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "Scheduler"}))
    assert cli.main(base + ["--scheduler-policy-file", str(bad)]) == 2
    assert "invalid scheduler policy" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# (e) refusals, word for word the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [
    _policy(["Bogus"]), _policy([], [_prio("Bogus", 1)])])
def test_unknown_names_raise_the_same_key_error(policy):
    with pytest.raises(KeyError) as jerr:
        jpc.compile_policy(jax_decode(policy))
    with pytest.raises(KeyError) as perr:
        ppc.compile_policy(port_decode(policy))
    assert str(perr.value) == str(jerr.value)


def drop_node_transport(name):
    """An in-process filter extender that drops node `name`."""
    def send(verb, args):
        assert verb == "filter"
        items = [n for n in args["nodes"]["items"]
                 if n["metadata"]["name"] != name]
        return {"nodes": {"items": items},
                "failedNodes": {name: "dropped by the extender"}}
    return send


def test_extenders_and_hard_weight_refuse_alike():
    ext = _policy(["PodFitsResources"], [], extenders=[
        {"urlPrefix": "http://extender", "filterVerb": "filter"}])
    snap, pods = compat_build(jax_api)
    with pytest.raises(NotImplementedError) as jerr:
        JaxBackend(fallback="error", policy=jax_decode(ext)).schedule(pods,
                                                                      snap)
    psnap, ppods = compat_build(port_api)
    with pytest.raises(NotImplementedError) as perr:
        TorchBackend(device="cpu", policy=port_decode(ext),
                     fallback="error").schedule(ppods, psnap)
    assert str(perr.value) == str(jerr.value).replace("jax backend",
                                                      "torch backend")
    # the default backend runs the extender policy on the host route, as
    # the JAX package's backend does on its reference fallback
    dropped = psnap.nodes[0].name
    jx = JaxBackend(policy=jax_decode(ext),
                    extender_transport=drop_node_transport(dropped)
                    ).schedule(pods, snap)
    backend = TorchBackend(device="cpu", policy=port_decode(ext),
                           extender_transport=drop_node_transport(dropped))
    port = backend.schedule(ppods, psnap)
    assert backend.last_route == "reference"
    assert backend.last_route_reason == str(perr.value).split(": ", 1)[1]
    assert placement_hash(port) == jax_hash(jx)
    assert [p.message for p in port] == [p.message for p in jx]
    assert dropped not in {p.node_name for p in port}
    assert any(p.scheduled for p in port)
    heavy = {"kind": "Policy", "hardPodAffinitySymmetricWeight": 101}
    with pytest.raises(ValueError) as jerr:
        jpc.compile_policy(jax_decode(heavy))
    with pytest.raises(ValueError) as perr:
        TorchBackend(device="cpu", policy=port_decode(heavy))
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(PolicyError):
        port_decode({"kind": "Scheduler"})


THREE_LABEL_SA = _policy([_sa("Wide", ["region", "zone", "foo"]),
                          "PodFitsResources"], [])


@pytest.mark.parametrize("env,policy,reason", [
    ("TPUSIM_FAST_MAX_SA_SEGS=1", COMPAT["1.2"],
     "ServiceAffinity lock segments"),
    ("TPUSIM_FAST_MAX_SA_SEGS=2", THREE_LABEL_SA,
     "ServiceAffinity entry labels"),
    ("TPUSIM_FAST_MAX_ZONES=2", COMPAT["1.2"],
     "ServiceAntiAffinity label domains"),
    ("TPUSIM_FAST_MAX_GROUPS=1", COMPAT["1.0"], "pod groups exceed"),
])
def test_budget_refusals_match(monkeypatch, env, policy, reason):
    monkeypatch.setenv(*env.split("="))
    (_, _, _, (jplan, jwhy)), (_, _, _, (pplan, pwhy)) = both(
        compat_build, policy)
    assert jplan is None and pplan is None
    assert pwhy == jwhy and reason in pwhy
    psnap, ppods = compat_build(port_api)
    with pytest.raises(NotImplementedError) as err:
        TorchBackend(device="cpu", policy=port_decode(policy),
                     route="kernel").schedule(ppods, psnap)
    assert str(err.value) == f"torch backend: {jwhy}"
    backend = TorchBackend(device="cpu", policy=port_decode(policy))
    backend.schedule(ppods, psnap)
    assert (backend.last_route, backend.last_route_reason) == ("scan", jwhy)


def test_plan_without_tables_refuses_alike():
    (jc, jcols, _, _), (pc, pcols, _, _) = both(compat_build, COMPAT["1.1"])
    cp = ppc.compile_policy(port_decode(COMPAT["1.1"]))
    jcp = jpc.compile_policy(jax_decode(COMPAT["1.1"]))
    jconfig = dataclasses.replace(
        jk.config_for([jc], False, NUM_FIXED_BITS), policy=jcp.spec)
    pconfig_ = dataclasses.replace(pconfig.config_for(pc, False),
                                   policy=cp.spec)
    assert pfp.plan_fast(pconfig_, pc, pcols) == jfs.plan_fast(
        jconfig, jc, jcols)
