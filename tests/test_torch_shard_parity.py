"""The port's node-sharded scan route (scan.sharded_scan_fn, the backend's
TPUSIM_SHARDS decision) at k = 2 and 4 gloo ranks on the CPU, against the
port's single-device scan and the JAX package's unsharded schedule_scan.

Each k runs every case in one spawn of k ranks (tests/torch_shard_workers
.parity_rank); a module-scoped fixture gathers the ranks' results and the
parametrised tests read them. On every plan family (provider, pod groups,
MaxPD, inter-pod, two policies without ServiceAffinity) the choices, reason
counts and advanced flags of every rank, and the final carry put back
together from the ranks' blocks, are bit-equal to both; so is the chunked
route. The backend's placement hash and FitError text equal the single-
device route's and the JAX backend's, with the tpusim_shard_* gauges and
spans set. Each declined batch is counted under its reason, unset, 1, 0 and
garbage TPUSIM_SHARDS build no mesh, and a rank whose host picture differs
makes every rank raise. Tolerance: exact (integer arrays and texts equal).
"""

import os

import pytest

from tpusim.backends import placement_hash as jax_hash
from tpusim.engine.policy import decode_policy as jax_decode
from tpusim.jaxe.backend import JaxBackend

import tpusim.api.snapshot as jax_api
import tpusim_torch.api.snapshot as port_api
from tpusim_torch import sharding
from tpusim_torch.backend import TorchBackend, placement_hash
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.framework.metrics import register
from test_torch_scan import assert_scans_equal, jax_scan
import torch_shard_workers as SW

SHARDS = (2, 4)
CASES = sorted(SW.scan_cases())


@pytest.fixture(scope="module")
def ranks():
    """k -> the k ranks' parity results (one spawn each, both at once)."""
    return sharding.run_ranks_each(SW.parity_rank, SHARDS, timeout=240)


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_scan_is_the_single_device_scan(ranks, name, k):
    build, policy = SW.scan_cases()[name]
    got = SW.gathered([r["scan"][name] for r in ranks[k]])
    assert_scans_equal(got, SW.single_scan(name))
    assert_scans_equal(got, jax_scan(build, policy))
    assert 0 < int((got[1] >= 0).sum()) < len(got[1])   # both outcomes


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", ["provider", "interpod"])
def test_sharded_chunked_scan(ranks, name, k):
    """Chunks of 20 pods (the last padded with rows that fit nowhere)."""
    got = SW.gathered([r["chunked"][name] for r in ranks[k]])
    assert_scans_equal(got, SW.single_scan(name, chunk=20))
    assert_scans_equal(got, SW.single_scan(name))


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("name", ["provider", "policy"])
def test_sharded_backend(ranks, name, k, monkeypatch):
    build, policy = SW.scan_cases()[name]
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    psnap, ppods = build(port_api)
    single = TorchBackend(route="scan", device="cpu", policy=(
        decode_policy(policy) if policy else None)).schedule(ppods, psnap)
    jsnap, jpods = build(jax_api)
    monkeypatch.setenv("TPUSIM_FAST", "0")
    jx = JaxBackend(policy=jax_decode(policy) if policy else None
                    ).schedule(jpods, jsnap)
    errors = [(p.pod.name, p.message) for p in single if not p.node_name]
    assert errors and [(p.pod.name, p.message) for p in jx
                       if not p.node_name] == errors
    per = -(-SW.NODES // k)
    for got in (r["backend"][name] for r in ranks[k]):
        assert got["hash"] == placement_hash(single) == jax_hash(jx)
        assert got["errors"] == errors
        assert got["route"] == "scan"
        assert got["shard_count"] == k
        assert got["occupancy"] == {
            str(r): float(min(per, SW.NODES - r * per)) for r in range(k)}
        assert got["bytes"] == float(SW.PODS * (12 + k) * 8 * k)
        assert got["fallback"] == {}
        assert got["spans"] == ["shard:scan", "shard:stage"]


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("reason", ["service_affinity", "explain_lanes",
                                    "device_count"])
def test_declined_batches_are_counted(ranks, reason, k):
    for got in (r["fallback"] for r in ranks[k]):
        assert got[reason] == (1, "scan")


@pytest.mark.parametrize("k", SHARDS)
def test_ranks_that_disagree_raise(ranks, k):
    for got in (r["doctored"] for r in ranks[k]):
        assert got is not None and "host pictures differ" in got


@pytest.mark.parametrize("value", [None, "1", "0", "garbage"])
def test_single_device_values_build_no_mesh(value, monkeypatch):
    """No group exists in this process: a mesh build would raise."""
    if value is None:
        monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    else:
        monkeypatch.setenv("TPUSIM_SHARDS", value)
    build, _ = SW.scan_cases()["provider"]
    snap, pods = build(port_api)
    m = register()
    before = dict(m.shard_fallback.values)
    meshes = dict(sharding._MESHES)
    backend = TorchBackend(route="scan", device="cpu")
    placements = backend.schedule(pods, snap)
    assert backend.last_route == "scan"
    assert sharding._MESHES == meshes
    assert m.shard_fallback.values == before
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    assert placement_hash(placements) == placement_hash(
        TorchBackend(route="scan", device="cpu").schedule(pods, snap))


@pytest.mark.parametrize("reason,setup", [
    ("device_count", "plain"), ("service_affinity", "sa_policy"),
    ("explain_lanes", "explain")])
def test_fallback_without_a_group(reason, setup, monkeypatch):
    """TPUSIM_SHARDS=2 with no process group: each reason counted once, a
    trace instant written, the single-device scan's placements."""
    from tpusim_torch import workloads as W
    from tpusim_torch.obs import provenance
    from tpusim_torch.obs import recorder as flight

    snap, pods = W.random_policy_workload(42, 24, 11, api=port_api)
    policy = (decode_policy(W.random_policy(42, sa_entries=1))
              if setup == "sa_policy" else None)
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    want = placement_hash(TorchBackend(route="scan", device="cpu",
                                       policy=policy).schedule(pods, snap))
    monkeypatch.setenv("TPUSIM_SHARDS", "2")
    m = register()
    before = m.shard_fallback.get(reason)
    rec = flight.install(flight.FlightRecorder())
    if setup == "explain":
        provenance.install(provenance.ProvenanceLog(top_k=2))
    try:
        backend = TorchBackend(route="scan", device="cpu", policy=policy)
        got = placement_hash(backend.schedule(pods, snap))
    finally:
        flight.uninstall()
        provenance.uninstall()
    assert m.shard_fallback.get(reason) == before + 1
    assert got == want and backend.last_route == "scan"
    assert [ev for ev in list(rec.events)
            if ev["name"] == "fallback:shard_" + reason]
    assert os.environ["TPUSIM_SHARDS"] == "2"
