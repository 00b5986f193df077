"""The port's cluster analytics plane (tpusim_torch/obs/analytics.py and
scan.analytics_reduce) against the JAX package's, on the CPU.

The reduction must equal its numpy mirror host_reduce and the JAX
package's analytics_reduce on the same columns, field by field, the order
of the packed top-k keys included (ties broken by node index). With the
plane installed, placements, stream chains and restage classes must stay
as without it, every kept sample must verify against host_reduce, and the
decoded samples (time stamps dropped) must equal the JAX package's on the
same feeds: the backend (provider and policy), the stream synchronous and
pipelined, and serve's pre-bind samples. Tolerance: exact; the ratios are
derived from equal integers by the same expressions.
"""

import numpy as np
import pytest
import torch

from tpusim.jaxe import ensure_x64

ensure_x64()

import tpusim.api.snapshot as jax_api  # noqa: E402
from tpusim.backends import get_backend  # noqa: E402
from tpusim.engine.policy import decode_policy as jax_decode  # noqa: E402
from tpusim.jaxe.kernels import AnalyticsIn as JaxIn  # noqa: E402
from tpusim.jaxe.kernels import analytics_reduce as jax_reduce  # noqa: E402
from tpusim.obs import analytics as janalytics  # noqa: E402
from tpusim.serve import ScenarioFleet as JaxFleet  # noqa: E402
from tpusim.serve import WhatIfRequest as JaxRequest  # noqa: E402
from tpusim.simulator import run_stream_simulation as jax_stream  # noqa: E402

import tpusim_torch.api.snapshot as port_api  # noqa: E402
from tpusim_torch.backend import TorchBackend, placement_hash  # noqa: E402
from tpusim_torch.engine.policy import decode_policy as port_decode  # noqa: E402
from tpusim_torch.framework.metrics import register  # noqa: E402
from tpusim_torch.obs import analytics  # noqa: E402
from tpusim_torch.scan import AnalyticsIn, analytics_reduce  # noqa: E402
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest  # noqa: E402
from tpusim_torch.simulator import run_stream_simulation  # noqa: E402

FIELDS = ("alloc", "used", "free_sum", "free_max", "headroom_nodes",
          "feasible_nodes", "valid_nodes", "hot_keys", "cold_keys")
POLICY = {"apiVersion": "v1", "kind": "Policy",
          "predicates": [{"name": "PodFitsResources"}],
          "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}


@pytest.fixture(autouse=True)
def _clean_analytics():
    analytics.uninstall()
    janalytics.uninstall()
    analytics.reset_compile_costs()
    yield
    analytics.uninstall()
    janalytics.uninstall()


def _snapshot(api, n=6):
    nodes = [api.make_node(f"n{i}", milli_cpu=4000 + 500 * i,
                           memory=2**33 + i * 2**30) for i in range(n)]
    return api.ClusterSnapshot(nodes=nodes)


def _pods(api, k=12):
    return [api.make_pod(f"p{i}", milli_cpu=100 * (1 + i % 5),
                         memory=(1 + i % 3) * 2**27) for i in range(k)]


def _random_cols(rng, n):
    def col(lo, hi):
        return rng.integers(lo, hi, size=n).astype(np.int64)

    return dict(alloc_cpu=col(0, 8000), alloc_mem=col(0, 2**34),
                alloc_gpu=col(0, 8), alloc_eph=col(0, 2**30),
                allowed_pods=col(0, 110),
                # oversubscribed cpu: free clamps at 0
                used_cpu=rng.integers(0, 12000, size=n).astype(np.int64),
                used_mem=col(0, 2**34), used_gpu=col(0, 8),
                used_eph=col(0, 2**30), pod_count=col(0, 120))


def _tie_cols(n):
    same = np.full(n, 4000, dtype=np.int64)
    return dict(alloc_cpu=same.copy(), alloc_mem=same * 2**20,
                alloc_gpu=np.zeros(n, np.int64), alloc_eph=same.copy(),
                allowed_pods=np.full(n, 110, np.int64),
                used_cpu=same // 2, used_mem=same * 2**19,
                used_gpu=np.zeros(n, np.int64), used_eph=same // 4,
                pod_count=np.full(n, 7, np.int64))


def three_ways(cols, n_valid, k):
    """(port stats, host_reduce, JAX stats) on the same columns."""
    got = analytics_reduce(AnalyticsIn(**{
        f: torch.from_numpy(v) for f, v in cols.items()}), n_valid, k)
    host = analytics.host_reduce(AnalyticsIn(**cols), n_valid, k)
    want = jax_reduce(JaxIn(**cols), np.int64(n_valid), k=k)
    return got, host, want


def assert_equal_stats(got, host, want):
    for field in FIELDS:
        g = getattr(got, field).numpy()
        assert g.dtype == np.int64, field
        assert np.array_equal(g, host[field]), field
        assert np.array_equal(g, np.asarray(getattr(want, field))), field


@pytest.mark.parametrize("n,n_valid,k", [
    (1, 1, 1), (4, 4, 2), (16, 16, 8), (16, 9, 8), (32, 32, 40),
    (8, 0, 3),   # every node padding: every key invalid
])
def test_reduce_matches_numpy_and_jax(n, n_valid, k):
    rng = np.random.default_rng(n * 1000 + n_valid * 10 + k)
    kk = max(1, min(k, n))
    assert_equal_stats(*three_ways(_random_cols(rng, n), n_valid, kk))


@pytest.mark.parametrize("n_valid", [12, 7])
def test_reduce_matches_on_ties(n_valid):
    """Equal utilization everywhere: the order falls to the index term, so
    the device's top-k and numpy's sort agree, node 0 first both ways."""
    got, host, want = three_ways(_tie_cols(12), n_valid, 5)
    assert_equal_stats(got, host, want)
    decoded = analytics.decode_stats(got)
    assert decoded == janalytics.decode_stats(want)
    assert decoded["hot_nodes"][0]["node"] == 0
    assert decoded["cold_nodes"][0]["node"] == 0
    assert len(decoded["hot_nodes"]) == min(5, n_valid)


def test_decode_stats_equal_jax():
    rng = np.random.default_rng(3)
    got, _, want = three_ways(_random_cols(rng, 10), 10, 4)
    names = [f"n{i}" for i in range(10)]
    decoded = analytics.decode_stats(got, names)
    assert decoded == janalytics.decode_stats(want, names)
    assert decoded["nodes"]["valid"] == 10
    assert set(decoded["resources"]) == set(analytics.RESOURCES)
    for res in decoded["resources"].values():
        assert res["free"] >= 0 and res["largest_free"] >= 0
        assert 0.0 <= res["fragmentation"] <= 1.0
    assert 0 < len(decoded["hot_nodes"]) <= 4
    assert all(e["node"] in names for e in decoded["hot_nodes"])


# ---- zero cost when off, and the same placements when on ------------------


def test_disabled_is_noop():
    assert analytics.get() is None
    before = register().analytics_samples.value
    analytics.capture(None, None, 0, "test")
    assert register().analytics_samples.value == before


def no_ts(samples):
    return [{k: v for k, v in s.items() if k != "ts"} for s in samples]


def install_both(**kw):
    kw.setdefault("keep_inputs", True)
    kw.setdefault("sample_interval_s", 0.0)
    return (analytics.install(analytics.ClusterAnalytics(**kw)),
            janalytics.install(janalytics.ClusterAnalytics(**kw)))


@pytest.mark.parametrize("policy", [None, POLICY], ids=["provider", "policy"])
def test_backend_hash_invariance_and_parity(policy):
    """The backend with the plane on places as with it off, on the scan
    route, and its samples verify and equal the JAX backend's."""
    psnap, ppods = _snapshot(port_api), _pods(port_api)
    off = placement_hash(TorchBackend(
        device="cpu", policy=policy and port_decode(policy)).schedule(
            [p.copy() for p in ppods], psnap))
    log, jlog = install_both()
    backend = TorchBackend(device="cpu",
                           policy=policy and port_decode(policy))
    on = placement_hash(backend.schedule([p.copy() for p in ppods], psnap))
    get_backend("jax", policy=policy and jax_decode(policy)).schedule(
        _pods(jax_api), _snapshot(jax_api))
    assert on == off
    assert backend.last_route == "scan"
    assert log.verify_against_host() == []
    assert [s.source for s in log.samples()] == ["backend"]
    assert no_ts(log.series()) == no_ts(jlog.series())


def _stream(run, **kw):
    return run(num_nodes=16, cycles=6, arrivals=16, evict_fraction=0.25,
               seed=7, **kw)


def port_stream(**kw):
    return _stream(run_stream_simulation, device="cpu", **kw)


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
def test_stream_hash_invariance_and_parity(pipeline):
    off = port_stream()
    assert off["restages"] == {"cold_start": 1}
    log, jlog = install_both()
    on = port_stream(pipeline=pipeline)
    jout = _stream(jax_stream, pipeline=pipeline)
    assert on["placement_chain"] == off["placement_chain"] \
        == jout["placement_chain"]
    # the reduction reads the resident carry: pure churn still restages
    # only at the cold start
    assert on["restages"] == {"cold_start": 1}
    assert log.verify_against_host() == []
    assert {s.source for s in log.samples()} == {"stream"}
    assert len(log.samples()) == 6
    assert no_ts(log.series()) == no_ts(jlog.series())
    assert on["analytics"]["enabled"] and on["analytics"]["latest"]


def test_serve_capture_parity():
    """Serve's samples are pre-bind, of each entry's staged columns, the
    padded nodes masked."""
    log, jlog = install_both()
    fleet = ScenarioFleet(bucket_size=2, flush_after_s=60.0, device="cpu")
    [resp] = fleet.run([WhatIfRequest(pods=_pods(port_api, 5),
                                      snapshot=_snapshot(port_api),
                                      cache_key="t-analytics")])
    [jresp] = JaxFleet(bucket_size=2, flush_after_s=60.0).run([JaxRequest(
        pods=_pods(jax_api, 5), snapshot=_snapshot(jax_api),
        cache_key="t-analytics")])
    assert resp.ok and jresp.ok
    assert log.verify_against_host() == []
    assert {s.source for s in log.samples()} == {"serve"}
    assert no_ts(log.series()) == no_ts(jlog.series())


def test_serve_padded_nodes_are_masked():
    """Two scenarios of different node counts in one bucket: the smaller
    one is padded on the node axis, and its sample counts only its own
    nodes."""
    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0))
    fleet = ScenarioFleet(bucket_size=2, flush_after_s=0.05, device="cpu")
    resps = fleet.run([
        WhatIfRequest(pods=_pods(port_api, 5), snapshot=_snapshot(port_api, n),
                      cache_key=f"pad-{n}") for n in (6, 3)])
    assert all(r.ok for r in resps)
    assert log.verify_against_host() == []
    valid = sorted(s["nodes"]["valid"] for s in log.series())
    assert valid == [3, 6]


def test_sample_throttle():
    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=3600.0))
    port_stream()
    # a whole session under a one-hour interval lands the first capture
    assert len(log.samples()) == 1


def test_ring_bounded():
    log = analytics.install(analytics.ClusterAnalytics(
        capacity=4, sample_interval_s=0.0))
    port_stream()
    assert len(log.samples()) == 4
    assert log.snapshot()["samples"] == 6
    assert len(log.series(limit=3)) == 3
    assert log.latest()["source"] == "stream"


def test_jsonl_export_roundtrip(tmp_path):
    path = str(tmp_path / "analytics.jsonl")
    jpath = str(tmp_path / "jax.jsonl")
    analytics.install(analytics.ClusterAnalytics(path=path,
                                                 sample_interval_s=0.0))
    janalytics.install(janalytics.ClusterAnalytics(path=jpath,
                                                   sample_interval_s=0.0))
    port_stream()
    _stream(jax_stream)
    analytics.uninstall()  # close() flushes
    janalytics.uninstall()
    records = list(analytics.read_jsonl(path))
    assert len(records) == 6
    for rec in records:
        assert rec["source"] == "stream"
        assert set(rec["resources"]) == set(analytics.RESOURCES)
    assert [r["seq"] for r in records] == list(range(6))
    assert no_ts(records) == no_ts(janalytics.read_jsonl(jpath))


# ---- device residency and compile accounting ------------------------------


def test_hbm_sources_and_compile_counters():
    class Owner:
        pass

    owner = Owner()
    analytics.register_hbm_source("test_component", owner,
                                  lambda o: (1234, 2))
    snap = analytics.hbm_snapshot()
    assert snap["test_component"]["bytes"] >= 1234
    assert "compiled_executables" in snap
    del owner  # held weakly: the source drops out, and nothing raises
    assert "test_component" not in analytics.hbm_snapshot()

    analytics.note_compile("testsite", "sig-a", 1500.0)
    analytics.note_compile("testsite", "sig-a", 500.0)
    analytics.note_compile("testsite", "sig-b", 100.0)
    comp = analytics.compile_snapshot()["testsite"]
    assert comp["traces"] == 3
    assert comp["total_us"] == pytest.approx(2100.0)
    assert comp["signatures"]["sig-a"]["traces"] == 2


def test_sites_register_sources_and_compiles():
    """The backend and a stream's restage note their compiles, under the
    JAX package's sites and signatures; a live stream session and a serve
    executor show as residency sources with their bytes."""
    from tpusim_torch.serve.executor import ServeExecutor
    from tpusim_torch.stream import StreamSession

    TorchBackend(device="cpu").schedule(_pods(port_api), _snapshot(port_api))
    session = StreamSession(_snapshot(port_api), device="cpu")
    session.schedule(_pods(port_api, 4))
    executor = ServeExecutor(device="cpu")
    comp = analytics.compile_snapshot()
    assert set(comp["backend"]["signatures"]) == {"nodes=6"}
    assert set(comp["stream_restage"]["signatures"]) == {
        "plan=None/nodes=6"}
    snap = analytics.hbm_snapshot()
    assert snap["stream_twin"]["entries"] == 1
    assert snap["stream_twin"]["bytes"] == analytics.tree_nbytes(
        (session.device.statics, session.device.carry)) > 0
    assert snap["serve_staged"]["entries"] == 0
    assert snap["serve_device_batches"]["entries"] == 0
    del executor


def test_tree_nbytes_never_reads_the_data():
    arr = np.zeros((4, 4), dtype=np.int64)
    assert analytics.tree_nbytes((arr, [arr], {"x": arr})) == 3 * 128
    assert analytics.tree_nbytes(None) == 0
    # a meta tensor has a shape and no data: any read would raise
    meta = torch.empty((5, 3), dtype=torch.int32, device="meta")
    assert analytics.tree_nbytes((meta, {"a": [meta]})) == 2 * 60


def test_refresh_gauges_and_cli_metrics(tmp_path):
    """The CLI's teardown folds the last sample into the tpusim_cluster_*
    gauges before --metrics-out is written."""
    import io
    from contextlib import redirect_stdout

    from tpusim_torch import cli

    prom = tmp_path / "m.prom"
    out = tmp_path / "a.jsonl"
    register().reset()
    with redirect_stdout(io.StringIO()):
        rc = cli.main(["stream", "--synthetic-nodes", "12", "--cycles", "3",
                       "--arrivals", "6", "--device", "cpu",
                       "--analytics-out", str(out),
                       "--metrics-out", str(prom)])
    assert rc == 0
    text = prom.read_text()
    assert "tpusim_cluster_nodes 12" in text
    assert 'tpusim_cluster_utilization_ratio{resource="cpu"}' in text
    assert 'tpusim_hbm_cache_entries{component="compiled_executables"}' \
        in text
    assert list(analytics.read_jsonl(str(out)))
    assert analytics.get() is None
