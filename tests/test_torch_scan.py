"""The port's exact sequential scan (tpusim_torch.scan) against the JAX
package's XLA scan (tpusim.jaxe.kernels.schedule_scan) on the CPU: the same
choices, reason counts, advanced flags and final carry, bit for bit, on
random workloads of every feature, under policies, and on plans the fused
kernel's int32 plan refuses. Everything is an integer (the float64 counts
are integer-valued), so every comparison is exact (tolerance 0).

Each package compiles its own copy of a workload, built from a seed through
its own API module.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.engine.policy import decode_policy as jax_decode  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import policyc as jpc  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import scan  # noqa: E402
from tpusim_torch import workloads as W  # noqa: E402
from tpusim_torch.backend import compile_inputs  # noqa: E402
from tpusim_torch.engine.policy import decode_policy as port_decode  # noqa: E402
from tpusim_torch.fastplan import plan_fast  # noqa: E402
from tpusim_torch.policyc import compile_policy  # noqa: E402

NOEXEC = "PodToleratesNodeNoExecuteTaints"


def jax_scan(build, policy=None, most_requested=False, hard_weight=10):
    """The JAX package's XLA scan on the workload: (final carry, choices,
    counts, advanced) as numpy arrays, the policy's rows grafted as its
    backend grafts them."""
    snapshot, pods = build(jax_api)
    cp = jpc.compile_policy(jax_decode(policy)) if policy else None
    ps = cp.spec if cp is not None else None
    compiled, cols = jstate.compile_cluster(
        snapshot, pods,
        need_noexec=ps is not None and ps.pred_keys is not None
        and NOEXEC in ps.pred_keys,
        need_saa=ps is not None and (bool(ps.saa_weights) or ps.sa_enabled))
    if cp is not None and cp.hard_weight is not None:
        hard_weight = cp.hard_weight
    config = jk.config_for([compiled], most_requested,
                           jstate.NUM_FIXED_BITS + len(compiled.scalar_names),
                           hard_weight=hard_weight)
    statics = jk.statics_to_host(compiled)
    carry = jk.carry_init_host(compiled)
    if cp is not None:
        config = dataclasses.replace(config, policy=ps)
        ptabs = jpc.build_policy_tables(cp, snapshot, pods, compiled, cols)
        if cp.saa_entries:
            config = dataclasses.replace(config, n_saa_doms=ptabs.n_saa_doms)
        statics = statics._replace(
            label_ok=ptabs.label_ok, label_prio=ptabs.label_prio,
            image_score=ptabs.image_score, saa_dom=ptabs.saa_dom,
            sa_pin=ptabs.sa_pin, sa_val=ptabs.sa_val)
        if ps.sa_enabled:
            carry = carry._replace(sa_lock=ptabs.sa_lock_init)
    xs = jk.pod_columns_to_host(cols)
    out = jk.schedule_scan(config, jk._tree_to_device(carry),
                           jk._tree_to_device(statics),
                           jk._tree_to_device(xs))
    final, rest = out[0], out[1:]
    return ({k: np.asarray(v) for k, v in final._asdict().items()},
            *(np.asarray(a) for a in rest))


def port_scan(build, policy=None, most_requested=False, hard_weight=10):
    """The port's scan on the CPU: (final carry, choices, counts, advanced)
    as numpy arrays, and plan_fast's verdict on the same compile."""
    snapshot, pods = build(port_api)
    cp = compile_policy(port_decode(policy)) if policy else None
    config, compiled, cols, ptabs = compile_inputs(
        snapshot, pods, most_requested, hard_weight, cp)
    plan, why = plan_fast(config, compiled, cols, ptabs)
    carry, statics, xs = scan.scan_inputs(config, compiled, cols, ptabs,
                                          "cpu")
    final, choices, counts, advanced = scan.schedule_scan(config, carry,
                                                          statics, xs)
    return ({k: v.numpy() for k, v in final._asdict().items()},
            choices.numpy(), counts.numpy(), advanced.numpy()), (plan, why)


def assert_scans_equal(got, want):
    (gc, *gout), (wc, *wout) = got, want
    for name, g, w in zip(("choices", "counts", "advanced"), gout, wout):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert set(gc) == set(wc)
    for name in wc:
        assert gc[name].dtype == wc[name].dtype, name
        assert np.array_equal(gc[name], wc[name]), name


def check(build, policy=None, most_requested=False, hard_weight=10,
          refused=None):
    """The port's scan bit-equal to the JAX scan; `refused`, when given, a
    text plan_fast's refusal must hold (None: the kernel takes the plan)."""
    got, (plan, why) = port_scan(build, policy, most_requested, hard_weight)
    want = jax_scan(build, policy, most_requested, hard_weight)
    assert_scans_equal(got, want)
    if refused is None:
        assert plan is not None, why
    else:
        assert plan is None and refused in why, why
    choices = got[1]
    assert 0 < int((choices >= 0).sum()) < len(choices)   # both outcomes
    return got


# ---------------------------------------------------------------------------
# (a) random workloads of every feature, on plans the kernel also takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,num_scalars,most_requested", [
    (0, 0, False), (1, 2, True), (2, 1, False)])
def test_random_workload(seed, num_scalars, most_requested):
    check(lambda api: W.random_workload(seed, 200, 50, num_scalars=num_scalars,
                                        infeasible=True, api=api),
          most_requested=most_requested)


@pytest.mark.parametrize("seed,features,most_requested", [
    (20, dict(ports=True, services=True, disk=True, vol_zone=True,
              maxpd=True), False),
    (21, dict(services=True, maxpd=True), True),
])
def test_random_group_workload(seed, features, most_requested):
    got = check(lambda api: W.random_group_workload(seed, 200, 60, api=api,
                                                    **features),
                most_requested=most_requested)
    assert got[0]["presence"].sum() > 0


@pytest.mark.parametrize("seed,kw,hard_weight", [
    (30, dict(), 10),
    (31, dict(services=True, ports=True), 1),
    (32, dict(services=True), 100),
])
def test_random_interpod_workload(seed, kw, hard_weight):
    """Hostname, zone and rack keys, empty keys, unplaced pods and negative
    weights, on 45 nodes (the kernel's domain budget holds)."""
    got = check(lambda api: W.random_interpod_workload(seed, 200, 45, api=api,
                                                       **kw),
                most_requested=seed % 2 == 1, hard_weight=hard_weight)
    assert got[0]["presence_dom"].sum() > 0


@pytest.mark.parametrize("policy", [
    W.COMPAT_POLICIES["1.2"],
    W.random_policy(40, count_mode=True, noexec=True, ports_alias=True,
                    sa_entries=2)], ids=["1.2", "count_mode"])
def test_random_policy_workload(policy):
    got = check(lambda api: W.random_policy_workload(40, 200, 50, api=api),
                policy)
    assert (got[0]["sa_lock"] >= 0).any()


# ---------------------------------------------------------------------------
# (b) plans past the kernel's int32 plan: the scan's own ground
# ---------------------------------------------------------------------------


def _byte_memory(api):
    """random_workload with memory requests that are not a multiple of any
    common unit: the gcd reduction leaves byte units, past int32."""
    snapshot, pods = W.random_workload(3, 200, 50, infeasible=True, api=api)
    out = []
    for i, pod in enumerate(pods):
        obj = pod.to_obj()
        req = obj["spec"]["containers"][0].setdefault(
            "resources", {}).setdefault("requests", {})
        req["memory"] = str(int(req.get("memory", "0")) + 1 + i % 7)
        out.append(api.Pod.from_obj(obj))
    return snapshot, out


def _many_zones(api):
    """Services over 20 failure-domain zones, past the kernel's 16."""
    snapshot, pods = W.random_group_workload(24, 200, 60, services=True,
                                             api=api)
    for i, node in enumerate(snapshot.nodes):
        node.metadata.labels[W.ZONE_LABEL] = f"z{i % 20}"
    return snapshot, pods


def _stacked_policy(api):
    """The policy workload with its running pods stacked on one node: under
    1.2 the BalancedResourceAllocation products, weighted 2, pass int32."""
    snapshot, pods = W.policy_workload(200, 50, api=api)
    snapshot.pods = [W._pod_with(api, p, node_name="node-1")
                     for p in W.groups_workload(2_000, 50, api=api)[0].pods]
    return snapshot, pods


@pytest.mark.parametrize("build,policy,reason", [
    (_byte_memory, None, "memory values exceed int32"),
    (lambda api: W.random_interpod_workload(33, 200, 70, services=True,
                                            api=api),
     None, "71 topology domains exceed"),
    (_many_zones, None, "21 zone domains exceed"),
    (_stacked_policy, W.COMPAT_POLICIES["1.2"],
     "balanced-allocation product exceeds int32"),
], ids=["byte_memory", "hostname_70_nodes", "many_zones", "stacked_1.2"])
def test_plans_the_kernel_refuses(build, policy, reason):
    check(build, policy, refused=reason)


# ---------------------------------------------------------------------------
# (c) the exact 128-bit balanced score
# ---------------------------------------------------------------------------


def balanced_reference(rc, rm, ac, am):
    if ac == 0 or rc >= ac or am == 0 or rm >= am:
        return 0
    num, den = abs(rc * am - rm * ac), ac * am
    return sum(1 for t in range(10) if t * den >= 10 * num)


VALUE = hst.one_of(hst.integers(0, 2**62), hst.integers(0, 2**33),
                   hst.integers(0, 40))


@settings(max_examples=300, deadline=None)
@given(hst.lists(hst.tuples(VALUE, VALUE, VALUE, VALUE), min_size=1,
                 max_size=16))
def test_balanced_score_is_exact(rows):
    rc, rm, ac, am = (torch.tensor(col, dtype=torch.int64)
                      for col in zip(*rows))
    got = scan._balanced_score(rc, rm, ac, am).tolist()
    assert got == [balanced_reference(*r) for r in rows]


def test_balanced_score_at_the_boundaries():
    """Scores exactly on a unit boundary (t * den == 10 * num) and pairs whose
    products differ past 2^64."""
    big = 2**62 - 1
    rows = [(1, 1, 10, 10), (3, 7, 10, 10), (big // 2, big // 4, big, big),
            (big - 1, 1, big, big), (5, 2**61, 10, 2**62), (0, 0, 1, 1),
            (2**40, 2**20, 2**41, 2**60)]
    rc, rm, ac, am = (torch.tensor(col, dtype=torch.int64)
                      for col in zip(*rows))
    assert scan._balanced_score(rc, rm, ac, am).tolist() == \
        [balanced_reference(*r) for r in rows]
