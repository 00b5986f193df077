"""The port's chunked exact scan (tpusim_torch.scan.schedule_scan_chunked)
against the JAX package's (tpusim.jaxe.kernels.schedule_scan_chunked) on the
CPU, bit for bit: choices, reason counts, advanced flags and every field of
the final carry, with a ragged last chunk, a chunk equal to the pod count and
a chunk that divides it; then against the port's own unchunked scan on plans
of every feature, TorchBackend's TPUSIM_SCAN_CHUNK routing, and the host
trees, axis registries, node padding and config union the what-if unifier
shares with it, each against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.engine.policy import decode_policy as jax_decode  # noqa: E402
from tpusim.jaxe import kernels as jk  # noqa: E402
from tpusim.jaxe import policyc as jpc  # noqa: E402
from tpusim.jaxe import sharding as jsh  # noqa: E402
from tpusim.jaxe import state as jstate  # noqa: E402
from tpusim.jaxe.backend import JaxBackend  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import backend as port_backend  # noqa: E402
from tpusim_torch import scan, sharding  # noqa: E402
from tpusim_torch import workloads as W  # noqa: E402
from tpusim_torch.backend import TorchBackend, compile_inputs  # noqa: E402
from tpusim_torch.config import config_for  # noqa: E402
from tpusim_torch.engine.policy import decode_policy as port_decode  # noqa: E402
from tpusim_torch.policyc import compile_policy  # noqa: E402
from tpusim_torch.state import compile_cluster  # noqa: E402

NUM_PODS, NUM_NODES = 1_200, 30


def config4_slice(api):
    """Config 4's shape (node-affinity pins, taints) cut to 1,200 pods on
    30 nodes: both placed and failed pods."""
    return W.build_workload(NUM_PODS, NUM_NODES, affinity=True, seed=7,
                            api=api)


@pytest.fixture(scope="module")
def jax_compile():
    snapshot, pods = config4_slice(jax_api)
    compiled, cols = jstate.compile_cluster(snapshot, pods)
    config = jk.config_for([compiled], False, jstate.NUM_FIXED_BITS
                           + len(compiled.scalar_names))
    return config, compiled, cols


@pytest.fixture(scope="module")
def port_compile():
    snapshot, pods = config4_slice(port_api)
    return compile_inputs(snapshot, pods)


def jax_chunked(jax_compile, chunk):
    config, compiled, cols = jax_compile
    carry, choices, counts, advanced = jk.schedule_scan_chunked(
        config, jk._tree_to_device(jk.carry_init_host(compiled)),
        jk._tree_to_device(jk.statics_to_host(compiled)),
        jk.pod_columns_to_host(cols), chunk)
    return ({k: np.asarray(v) for k, v in carry._asdict().items()},
            np.asarray(choices), np.asarray(counts), np.asarray(advanced))


def port_chunked(inputs, chunk):
    config, compiled, cols, ptabs = inputs
    carry, statics, xs = scan.scan_inputs(config, compiled, cols, ptabs,
                                          "cpu", host_pods=True)
    final, choices, counts, advanced = scan.schedule_scan_chunked(
        config, carry, statics, xs, chunk)
    return ({k: v.numpy() for k, v in final._asdict().items()},
            choices, counts, advanced)


def port_unchunked(inputs):
    config, compiled, cols, ptabs = inputs
    carry, statics, xs = scan.scan_inputs(config, compiled, cols, ptabs,
                                          "cpu")
    final, *out = scan.schedule_scan(config, carry, statics, xs)
    return ({k: v.numpy() for k, v in final._asdict().items()},
            *(t.numpy() for t in out))


def assert_equal(got, want):
    (gc, *gout), (wc, *wout) = got, want
    for name, g, w in zip(("choices", "counts", "advanced"), gout, wout):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert set(gc) == set(wc)
    for name in wc:
        assert gc[name].dtype == wc[name].dtype, name
        assert np.array_equal(gc[name], wc[name]), name


@pytest.mark.parametrize("chunk", [512, NUM_PODS, 500],
                         ids=["ragged", "one_chunk", "exact"])
def test_chunked_matches_jax(jax_compile, port_compile, chunk):
    got = port_chunked(port_compile, chunk)
    assert_equal(got, jax_chunked(jax_compile, chunk))
    choices = got[1]
    assert choices.shape == (NUM_PODS,)
    assert 0 < int((choices >= 0).sum()) < NUM_PODS


def test_chunked_matches_unchunked(port_compile):
    assert_equal(port_chunked(port_compile, 333), port_unchunked(port_compile))


POLICY_1_2 = W.COMPAT_POLICIES["1.2"]


@pytest.mark.parametrize("build,policy", [
    (lambda api: W.random_interpod_workload(30, 200, 45, services=True,
                                            ports=True, api=api), None),
    (lambda api: W.random_group_workload(20, 200, 60, ports=True,
                                         services=True, disk=True,
                                         vol_zone=True, maxpd=True, api=api),
     None),
    (lambda api: W.random_policy_workload(40, 200, 50, api=api), POLICY_1_2),
], ids=["interpod", "groups", "policy_1.2"])
def test_chunked_carries_every_field_across_chunks(build, policy):
    """presence, presence_dom, used volumes and ServiceAffinity locks cross
    chunk boundaries untouched (chunks of 37 pods, the last one ragged)."""
    snapshot, pods = build(port_api)
    cp = compile_policy(port_decode(policy)) if policy else None
    inputs = compile_inputs(snapshot, pods, compiled_policy=cp)
    got = port_chunked(inputs, 37)
    assert_equal(got, port_unchunked(inputs))
    assert got[0]["presence"].sum() > 0


def test_pad_infeasible_rows_matches_jax(jax_compile, port_compile):
    xs_port = scan.pod_columns_to_host(port_compile[2])
    xs_jax = jk.pod_columns_to_host(jax_compile[2])
    got = scan.pad_infeasible_rows(xs_port, 13)
    want = jk.pad_infeasible_rows(xs_jax, 13)
    for name, g, w in zip(scan.PodX._fields, got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w), name
    assert scan.pad_infeasible_rows(xs_port, 0) is xs_port


# ---- TorchBackend's routing -------------------------------------------------

def test_backend_routes_big_batches_through_the_chunked_scan(monkeypatch):
    """route="scan" hands a batch past TPUSIM_SCAN_CHUNK pods to the chunked
    scan, placements and FitError text identical to the unchunked run and
    to the JAX package's backend."""
    snapshot, pods = W.build_workload(900, 20, affinity=True, seed=7,
                                      api=port_api)
    calls = []
    real = port_backend.schedule_scan_chunked
    monkeypatch.setattr(port_backend, "schedule_scan_chunked",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    monkeypatch.delenv("TPUSIM_SCAN_CHUNK", raising=False)
    unchunked = TorchBackend(device="cpu", route="scan").schedule(
        pods, snapshot)
    assert calls == []
    monkeypatch.setenv("TPUSIM_SCAN_CHUNK", "256")
    chunked = TorchBackend(device="cpu", route="scan").schedule(
        pods, snapshot)
    assert calls == [256]
    key = [(p.pod.name, p.node_name, p.message) for p in chunked]
    assert key == [(p.pod.name, p.node_name, p.message) for p in unchunked]
    jsnap, jpods = W.build_workload(900, 20, affinity=True, seed=7,
                                    api=jax_api)
    monkeypatch.delenv("TPUSIM_SCAN_CHUNK")
    want = JaxBackend(fallback="error").schedule(jpods, jsnap)
    assert key == [(p.pod.name, p.node_name, p.message) for p in want]
    assert any(p.message for p in chunked)


@pytest.mark.parametrize("setting", ["900", "0", "many"])
def test_backend_keeps_one_dispatch_within_the_chunk(setting, monkeypatch):
    """A chunk equal to the pod count, 0, or a setting that is no integer
    (the default, 131072) keeps the single dispatch."""
    snapshot, pods = W.build_workload(900, 20, seed=7, api=port_api)
    monkeypatch.setenv("TPUSIM_SCAN_CHUNK", setting)
    monkeypatch.setattr(port_backend, "schedule_scan_chunked", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("chunked")))
    backend = TorchBackend(device="cpu", route="scan")
    backend.schedule(pods, snapshot)
    assert backend.last_route == "scan"


# ---- what the unifier shares with the chunked scan --------------------------

@pytest.mark.parametrize("name", ["STATICS_AXES", "CARRY_AXES", "PODX_AXES",
                                  "PAD_FILLS"])
def test_axis_registries_match_jax(name):
    assert getattr(scan, name) == getattr(jk, name)


def _policy_compiles():
    """(port compiled, cols, ptabs), (JAX compiled, cols, ptabs) of the
    policy workload under policy 1.2 (ServiceAffinity locks, label rows)."""
    out = []
    for api, decode, pc, compile_ in (
            (port_api, port_decode, None, compile_cluster),
            (jax_api, jax_decode, jpc, jstate.compile_cluster)):
        snapshot, pods = W.random_policy_workload(40, 120, 30, api=api)
        if pc is None:
            from tpusim_torch import policyc as pc
        cp = pc.compile_policy(decode(POLICY_1_2))
        ps = cp.spec
        compiled, cols = compile_(
            snapshot, pods, need_noexec=ps.pred_keys is not None
            and "PodToleratesNodeNoExecuteTaints" in ps.pred_keys,
            need_saa=bool(ps.saa_weights) or ps.sa_enabled)
        ptabs = pc.build_policy_tables(cp, snapshot, pods, compiled, cols)
        out.append((compiled, cols, ptabs))
    return out


def test_host_trees_match_jax():
    """statics_to_host (with the policy's rows), carry_init_host (with its
    locks) and pod_columns_to_host give the JAX package's arrays."""
    (pc, pcols, ptabs), (jc, jcols, jtabs) = _policy_compiles()
    want_st = jk.statics_to_host(jc)._replace(
        label_ok=jtabs.label_ok, label_prio=jtabs.label_prio,
        image_score=jtabs.image_score, saa_dom=jtabs.saa_dom,
        sa_pin=jtabs.sa_pin, sa_val=jtabs.sa_val)
    want_ca = jk.carry_init_host(jc)._replace(sa_lock=jtabs.sa_lock_init)
    for got, want in ((scan.statics_to_host(pc, ptabs), want_st),
                      (scan.carry_init_host(pc, ptabs.sa_lock_init), want_ca),
                      (scan.pod_columns_to_host(pcols),
                       jk.pod_columns_to_host(jcols))):
        assert type(got)._fields == type(want)._fields
        for name, g, w in zip(type(got)._fields, got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_pad_node_axis_matches_jax():
    (pc, _, ptabs), (jc, _, jtabs) = _policy_compiles()
    n = len(pc.statics.names)
    got = sharding.pad_node_axis(scan.statics_to_host(pc, ptabs),
                                 scan.carry_init_host(pc), n + 5)
    want = jsh.pad_node_axis(jk.statics_to_host(jc)._replace(
        label_ok=jtabs.label_ok, label_prio=jtabs.label_prio,
        image_score=jtabs.image_score, saa_dom=jtabs.saa_dom,
        sa_pin=jtabs.sa_pin, sa_val=jtabs.sa_val), jk.carry_init_host(jc),
        n + 5)
    assert got[2] == want[2] == n
    for g_tree, w_tree in zip(got[:2], want[:2]):
        for name, g, w in zip(type(g_tree)._fields, g_tree, w_tree):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got[0].cond_fail_bits[n:].tolist() == [1 << 62] * 5
    unpadded = sharding.pad_node_axis(got[0], got[1], n + 5)
    assert unpadded[0] is got[0] and unpadded[2] == n + 5


def test_config_for_a_list_matches_jax():
    """The union config over scenarios of different features; one scenario
    gives what config_for gave before."""
    builds = [lambda api: W.random_interpod_workload(30, 60, 20, api=api),
              lambda api: W.random_group_workload(20, 60, 20, maxpd=True,
                                                  vol_zone=True, api=api),
              lambda api: W.random_workload(0, 60, 20, api=api)]
    ports, jaxes = [], []
    for build in builds:
        ports.append(compile_cluster(*build(port_api))[0])
        jaxes.append(jstate.compile_cluster(*build(jax_api))[0])
    for lo, hi in ((0, 3), (1, 3), (2, 3), (0, 1)):
        got = config_for(ports[lo:hi], True, hard_weight=7)
        want = jk.config_for(jaxes[lo:hi], True, 30, hard_weight=7)
        for field in dataclasses.fields(got):
            assert getattr(got, field.name) == getattr(want, field.name), \
                field.name
    assert config_for(ports[0], False) == config_for([ports[0]], False)
