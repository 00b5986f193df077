"""The port's decision provenance and explain lanes (tpusim_torch/obs/
provenance.py, the scan's explain lanes, the backend's reroute, the CLI's
--explain-out, --explain-top-k and `explain`) against the JAX package's, on
the CPU.

The same feeds, built through either package's API module, run through
JaxBackend (its XLA scan) and TorchBackend(device="cpu") with a
ProvenanceLog installed in each package. The records must be equal once
the time stamp `ts` is dropped, and nothing else: seq, source, cycle, pod,
placed, node, reason, the FitError message and every top-k row with its
node, score and score parts. The parts of a row sum to its score exactly.
Tolerance: exact (integers and strings).
"""

import io
import json
from contextlib import redirect_stdout

import pytest

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim import cli as jax_cli  # noqa: E402
from tpusim.backends import ReferenceBackend as JaxReference  # noqa: E402
from tpusim.backends import get_backend  # noqa: E402
from tpusim.engine.policy import decode_policy as jax_decode  # noqa: E402
from tpusim.gang import group as jax_group  # noqa: E402
from tpusim.obs import provenance as jprov  # noqa: E402
from tpusim.serve import ScenarioFleet as JaxFleet  # noqa: E402
from tpusim.serve import WhatIfRequest as JaxRequest  # noqa: E402
from tpusim.simulator import run_simulation as jax_run  # noqa: E402
from tpusim.simulator import run_stream_simulation as jax_stream  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch import cli  # noqa: E402
from tpusim_torch import workloads as W  # noqa: E402
from tpusim_torch.backend import TorchBackend, placement_hash  # noqa: E402
from tpusim_torch.engine.policy import decode_policy as port_decode  # noqa: E402
from tpusim_torch.framework.metrics import register  # noqa: E402
from tpusim_torch.gang import group as port_group  # noqa: E402
from tpusim_torch.obs import analytics  # noqa: E402
from tpusim_torch.obs import provenance  # noqa: E402
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest  # noqa: E402
from tpusim_torch.simulator import run_simulation  # noqa: E402
from tpusim_torch.simulator import run_stream_simulation  # noqa: E402
from test_torch_backend import forbid_host_route  # noqa: E402
from test_torch_policy import COMPAT, compat_build  # noqa: E402

TIER1_VERSIONS = ["1.1", "1.9"]
CAP = 1 << 20


@pytest.fixture(autouse=True)
def _clean_logs():
    provenance.uninstall()
    jprov.uninstall()
    analytics.uninstall()
    yield
    provenance.uninstall()
    jprov.uninstall()
    analytics.uninstall()


def no_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def capture_jax(fn, top_k=0):
    """The JAX package's records of fn() (ts dropped), and its value."""
    log = jprov.install(jprov.ProvenanceLog(capacity=CAP, top_k=top_k))
    try:
        value = fn()
        return no_ts(log.tail(CAP)), value
    finally:
        jprov.uninstall()


def capture_port(fn, top_k=0):
    """The port's records of fn() (ts dropped), and its value."""
    log = provenance.install(provenance.ProvenanceLog(capacity=CAP,
                                                      top_k=top_k))
    try:
        value = fn()
        return no_ts(log.tail(CAP)), value
    finally:
        provenance.uninstall()


def both_backends(build, policy=None, top_k=0, route="auto",
                  provider="DefaultProvider"):
    """(JAX records, port records, port backend) of one schedule call on
    the feed build(api) makes."""
    jsnap, jpods = build(jax_api)
    psnap, ppods = build(port_api)
    want, _ = capture_jax(lambda: get_backend(
        "jax", provider=provider,
        policy=policy and jax_decode(policy)).schedule(jpods, jsnap), top_k)
    backend = TorchBackend(device="cpu", route=route, fallback="error",
                           provider=provider,
                           policy=policy and port_decode(policy))
    got, _ = capture_port(lambda: backend.schedule(ppods, psnap), top_k)
    return want, got, backend


# ---- failure text on both routes -----------------------------------------


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("version", TIER1_VERSIONS)
def test_failure_text_matches_host_fiterror(version, route, monkeypatch):
    """Failure records on the kernel and the scan route carry the host's
    FitError.Error() text, and every record equals the JAX package's."""
    forbid_host_route(monkeypatch)
    policy = COMPAT[version]
    jsnap, jpods = compat_build(jax_api)
    host = {p.pod.metadata.name: p.message for p in JaxReference(
        policy=jax_decode(policy)).schedule(list(jpods), jsnap)
        if not p.node_name}
    want, got, backend = both_backends(compat_build, policy, route=route)
    assert backend.last_route == route
    assert host, f"policy {version}: the feed produced no failure"
    failures = {r["pod"].split("/", 1)[1]: r["message"]
                for r in got if not r["placed"]}
    assert failures == host
    assert got == want
    for rec in got:
        json.dumps(rec)


def test_provenance_off_hashes_unchanged():
    """Scheduling with a log, lanes included, places as without one, and
    nothing installs itself."""
    snapshot, pods = compat_build(port_api)
    policy = port_decode(COMPAT["1.1"])
    assert provenance.get_log() is None
    assert provenance.requested_top_k() == 0
    off = TorchBackend(device="cpu", policy=policy).schedule(pods, snapshot)
    assert provenance.get_log() is None
    records, on = capture_port(lambda: TorchBackend(
        device="cpu", policy=policy).schedule(pods, snapshot), top_k=3)
    assert placement_hash(on) == placement_hash(off)
    assert len(records) == len(pods)


# ---- the explain lanes ----------------------------------------------------


def tie_build(api):
    """Eight identical nodes and identical pods: every score ties."""
    snapshot = api.synthetic_cluster(8, milli_cpu=4000, memory=8 * 1024**3)
    pods = [api.make_pod(f"tie-{i}", milli_cpu=500, memory=256 * 1024**2)
            for i in range(40)]
    return snapshot, pods


LANE_CASES = {
    "ties": (tie_build, None, "DefaultProvider"),
    "ties_most_requested": (tie_build, None, "ClusterAutoscalerProvider"),
    "compat_1.1": (compat_build, COMPAT["1.1"], "DefaultProvider"),
    "compat_1.2": (compat_build, COMPAT["1.2"], "DefaultProvider"),
    "compat_1.9": (compat_build, COMPAT["1.9"], "DefaultProvider"),
    "interpod": (lambda api: W.interpod_workload(120, 24, api=api), None,
                 "DefaultProvider"),
    "groups": (lambda api: W.groups_workload(120, 24, api=api), None,
               "DefaultProvider"),
}


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_top_k_records_equal_jax(name, top_k):
    """Top-k rows (ties listed lower node index first, as jax.lax.top_k
    lists them) equal the JAX package's; each row's parts sum to its score,
    rows run best first, and the bound node tops its rows when listed."""
    build, policy, provider = LANE_CASES[name]
    want, got, backend = both_backends(build, policy, top_k=top_k,
                                       provider=provider)
    assert backend.last_route == "scan"
    assert got == want
    placed = [r for r in got if r["placed"]]
    assert placed and all(r["top_k"] for r in placed)
    winners = 0
    for rec in placed:
        rows = rec["top_k"]
        assert len(rows) <= top_k
        scores = [row["score"] for row in rows]
        assert scores == sorted(scores, reverse=True)
        for row in rows:
            assert sum(row["parts"].values()) == row["score"], (rec, row)
        if rec["node"] in {row["node"] for row in rows}:
            winners += 1
            assert {row["node"]: row["score"] for row in rows}[
                rec["node"]] == rows[0]["score"]
    assert winners


def test_top_k_past_the_node_count_pads_and_drops():
    """k past the feasible nodes: padding rows never reach a record, and
    k is cut to the node count as the JAX backend cuts it."""
    want, got, _ = both_backends(compat_build, COMPAT["1.9"], top_k=50)
    assert got == want
    assert max(len(r.get("top_k", ())) for r in got) <= 9


def test_kernel_route_raises_with_lanes_or_analytics(monkeypatch):
    """route="kernel" never reroutes: explain lanes or an installed
    analytics plane raise, with the reason."""
    snapshot, pods = tie_build(port_api)
    provenance.install(provenance.ProvenanceLog(top_k=2))
    with pytest.raises(NotImplementedError, match="explain lanes"):
        TorchBackend(device="cpu", route="kernel").schedule(pods, snapshot)
    provenance.uninstall()
    analytics.install(analytics.ClusterAnalytics())
    with pytest.raises(NotImplementedError, match="cluster analytics"):
        TorchBackend(device="cpu", route="kernel").schedule(pods, snapshot)
    analytics.uninstall()
    # failures-only provenance stays on the kernel
    provenance.install(provenance.ProvenanceLog(top_k=0))
    backend = TorchBackend(device="cpu", route="kernel")
    backend.schedule(pods, snapshot)
    assert backend.last_route == "kernel"


def test_auto_reroute_counts_the_jax_keys():
    """route="auto" takes the scan under explain lanes (key "explain") and
    under the analytics plane (the JAX package's message, key "other"),
    each counted in tpusim_fast_fallback_total."""
    snapshot, pods = tie_build(port_api)
    counter = register().fast_fallback
    before = dict(counter.values)
    provenance.install(provenance.ProvenanceLog(top_k=2))
    backend = TorchBackend(device="cpu")
    backend.schedule(pods, snapshot)
    assert backend.last_route == "scan"
    assert "explain lanes" in backend.last_route_reason
    provenance.uninstall()
    analytics.install(analytics.ClusterAnalytics())
    backend.schedule(pods, snapshot)
    assert backend.last_route == "scan"
    analytics.uninstall()
    after = counter.values
    assert after.get("explain", 0) == before.get("explain", 0) + 1
    assert after.get("other", 0) == before.get("other", 0) + 1


def test_chunked_batch_with_lanes_takes_the_whole_scan(monkeypatch):
    """A batch past TPUSIM_SCAN_CHUNK with explain lanes runs the whole
    scan (the chunked one carries no lanes), counted under "explain", and
    records what the JAX package records."""
    monkeypatch.setenv("TPUSIM_SCAN_CHUNK", "16")
    counter = register().fast_fallback
    before = counter.values.get("explain", 0)
    want, got, backend = both_backends(tie_build, top_k=2, route="scan")
    assert got == want
    assert counter.values.get("explain", 0) == before + 1


# ---- the other sources ----------------------------------------------------


def test_explain_restages_stream_only_at_cold_start():
    """A pure-churn stream with a log armed restages only at its cold
    start; its records (stream, with cycles) equal the JAX package's."""
    kw = dict(num_nodes=12, cycles=6, arrivals=6, evict_fraction=0.25,
              seed=3)
    want, jout = capture_jax(lambda: jax_stream(**kw))
    got, out = capture_port(lambda: run_stream_simulation(device="cpu",
                                                          **kw))
    assert out["restages"] == {"cold_start": 1}
    assert out["placement_chain"] == jout["placement_chain"]
    assert got == want
    assert any(r["source"] == "stream" for r in got)
    assert all("cycle" in r for r in got if r["source"].startswith("stream"))


@pytest.mark.parametrize("kw,sources", [
    (dict(pipeline=True), {"stream"}),
    (dict(whatif_every=2, whatif_pods=4), {"stream", "overlay"}),
    (dict(gang_size=3, gang_count=1), {"stream-gang", "backend"}),
], ids=["pipelined", "overlays", "gangs"])
def test_stream_records_equal_jax(kw, sources):
    """Pipelined cycles, overlay queries and gang cycles: the same records
    (sources stream, overlay, stream-gang, and backend for the gang
    cycles' ungrouped segments) as the JAX package's."""
    kw = dict(num_nodes=12, cycles=6, arrivals=6, evict_fraction=0.25,
              seed=5, **kw)
    want, jout = capture_jax(lambda: jax_stream(**kw))
    got, out = capture_port(lambda: run_stream_simulation(device="cpu",
                                                          **kw))
    assert out["placement_chain"] == jout["placement_chain"]
    assert got == want
    assert {r["source"] for r in got} == sources


def test_serve_records_equal_jax():
    """A serve fleet's decoded requests land as source "serve"."""
    def load(api, fleet_cls, request_cls):
        snapshot, pods = W.build_workload(60, 12, seed=17, api=api)
        fleet = fleet_cls(bucket_size=2, flush_after_s=60.0)
        fleet.register_snapshot("base", snapshot)
        return fleet.run([request_cls(pods=pods[:n], snapshot_ref="base",
                                      cache_key=f"r{n}")
                          for n in (10, 25, 40)])

    want, jresp = capture_jax(lambda: load(jax_api, JaxFleet, JaxRequest))
    got, resp = capture_port(lambda: load(
        port_api, lambda **kw: ScenarioFleet(device="cpu", **kw),
        WhatIfRequest))
    assert all(r.ok for r in resp) and all(r.ok for r in jresp)
    assert {r["source"] for r in got} == {"serve"}
    assert got == want


def gang_feed(api, grp):
    pods = [api.make_pod(f"solo-{i}", milli_cpu=500) for i in range(6)]
    for g, size in (("big", 12), ("ok", 3)):
        for i in range(size):
            pods.append(grp.mark_gang(api.make_pod(
                f"{g}-{i}", milli_cpu=1500), g))
    return pods


def test_gang_records_equal_jax(monkeypatch):
    """A gang feed through run_simulation: the gangs' members as source
    "gang", the ungrouped segments as "backend", as the JAX package."""
    forbid_host_route(monkeypatch)
    want, _ = capture_jax(lambda: jax_run(
        gang_feed(jax_api, jax_group), jax_api.synthetic_cluster(
            4, milli_cpu=4000, memory=16 * 1024**3), backend="jax"))
    got, _ = capture_port(lambda: run_simulation(
        gang_feed(port_api, port_group), port_api.synthetic_cluster(
            4, milli_cpu=4000, memory=16 * 1024**3), device="cpu"))
    assert {r["source"] for r in got} == {"gang", "backend"}
    assert got == want


def test_reference_and_no_node_records_equal_jax(monkeypatch):
    """A workload the compile sends to the host route records as source
    "reference"; a batch on no nodes records as "backend"."""
    monkeypatch.setenv("TPUSIM_MAX_GROUPS", "2")

    def build(api):
        return W.groups_workload(40, 8, api=api)

    want, _ = capture_jax(lambda: get_backend("jax").schedule(
        *reversed(build(jax_api))))
    backend = TorchBackend(device="cpu")
    got, _ = capture_port(lambda: backend.schedule(*reversed(build(
        port_api))))
    assert backend.last_route == "reference"
    assert {r["source"] for r in got} == {"reference"}
    assert got == want

    empty = port_api.ClusterSnapshot(nodes=[])
    got, _ = capture_port(lambda: TorchBackend(device="cpu").schedule(
        tie_build(port_api)[1][:3], empty))
    want, _ = capture_jax(lambda: get_backend("jax").schedule(
        tie_build(jax_api)[1][:3], jax_api.ClusterSnapshot(nodes=[])))
    assert {r["source"] for r in got} == {"backend"}
    assert got == want


# ---- the JSON-lines file and the CLI ---------------------------------------


def test_jsonl_roundtrip(tmp_path):
    """--explain-out: close() writes one JSON object a decision, read back
    in sequence order, equal to the ring."""
    path = tmp_path / "explain.jsonl"
    log = provenance.install(provenance.ProvenanceLog(path=str(path),
                                                      top_k=2))
    snapshot, pods = compat_build(port_api)
    TorchBackend(device="cpu").schedule(pods, snapshot)
    in_memory = log.tail(limit=4096)
    provenance.uninstall()
    on_disk = list(provenance.read_jsonl(str(path)))
    assert len(on_disk) == len(pods)
    assert [r["seq"] for r in on_disk] == list(range(len(pods)))
    assert on_disk == in_memory


EXPLAIN_ARGS = [[], ["--summary"], ["--failed"], ["--placed", "--limit", "3"],
                ["--json"], ["--pod", "pod-1"], ["--source", "backend"],
                ["--failed", "--placed"]]


def run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_explain_cli_byte_equal(tmp_path):
    """`explain` prints what the JAX command prints on the same file, for
    every filter and mode."""
    path = str(tmp_path / "explain.jsonl")
    provenance.install(provenance.ProvenanceLog(path=path, top_k=3))
    snapshot, pods = compat_build(port_api)
    TorchBackend(device="cpu", policy=port_decode(COMPAT["1.9"])).schedule(
        pods, snapshot)
    provenance.uninstall()
    for argv in EXPLAIN_ARGS:
        got = run_cli(cli.main, ["explain", path] + argv)
        want = run_cli(jax_cli.main, ["explain", path] + argv)
        assert got == want, argv
    rc, _ = run_cli(cli.main, ["explain", str(tmp_path / "missing.jsonl")])
    assert rc == 2


def test_cli_explain_out_and_top_k(tmp_path):
    """The main command's --explain-out with --explain-top-k on the card's
    entry point (here the CPU): one record a pod, equal to the JAX
    command's but for the pods' generated names."""
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([
        {"name": "A", "num": 6, "pod": {"spec": {"containers": [{
            "resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}]}}},
        {"name": "B", "num": 4, "pod": {"spec": {"containers": [{
            "resources": {"requests": {"cpu": "3", "memory": "2Gi"}}}]}}}]))
    files = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, ["--backend", "jax"])):
        out = str(tmp_path / f"{name}.jsonl")
        rc, _ = run_cli(main, ["--podspec", str(spec), "--synthetic-nodes",
                               "3", "--explain-out", out,
                               "--explain-top-k", "2"] + extra)
        assert rc == 0
        files[name] = [{k: v for k, v in r.items() if k not in ("ts", "pod")}
                       for r in provenance.read_jsonl(out)]
    assert len(files["port"]) == 10
    assert files["port"] == files["jax"]
    assert provenance.get_log() is None
