"""Serve's live twins on the port against the JAX package, after the
live-twin cases of tests/test_serve.py: a request naming a StreamSession
attached to the fleet (ScenarioFleet.attach_stream) is answered by an overlay
query on the twin's resident carry, with the JAX fleet's placement hash and
the hash of a staged run_what_if on the twin's live picture; the second
query is warm; a forced restage and a plan mismatch go the staged path,
counted; detaching restores the ref lookup; `serve --attach-stream` through
the CLI. Also the serve metric cases of tests/test_serve.py (the queue-depth
gauge and the tpusim_serve_* families).
"""

import json
import pathlib
import re

import numpy as np
import pytest

import tpusim.api.snapshot as jax_api
from tpusim.backends import placement_hash as jax_placement_hash
from tpusim.cli import main as jax_main
from tpusim.serve import ScenarioFleet as JaxFleet
from tpusim.serve import WhatIfRequest as JaxRequest
from tpusim.stream import ChurnLoadGen as JaxLoadGen
from tpusim.stream import StreamSession as JaxSession

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.backends import placement_hash
from tpusim_torch.cli import main
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.framework.metrics import register
from tpusim_torch.serve import (
    REJECT_UNKNOWN_SNAPSHOT,
    AdmissionQueue,
    ScenarioFleet,
    WhatIfRequest,
)
from tpusim_torch.stream import ChurnLoadGen, StreamSession
from tpusim_torch.whatif import run_what_if

APIS = {"jax": jax_api, "port": port_api}


@pytest.fixture(autouse=True)
def _fresh_registry():
    register().reset()
    yield
    register().reset()


def scenario(pkg, seed: int, num_nodes: int = 4, num_pods: int = 3):
    api = APIS[pkg]
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"s{seed}-n{i}",
                           milli_cpu=int(rng.choice([2000, 4000, 8000])),
                           memory=int(rng.choice([4, 8])) * 1024**3)
             for i in range(num_nodes)]
    pods = [api.make_pod(f"s{seed}-p{i}",
                         milli_cpu=int(rng.randint(100, 1500)),
                         memory=int(rng.randint(2**20, 2**30)))
            for i in range(num_pods)]
    return api.ClusterSnapshot(nodes=nodes), pods


def _warm_twin(pkg="port", num_nodes=8, cycles=3, seed=11):
    if pkg == "jax":
        session = JaxSession(jax_api.synthetic_cluster(num_nodes))
        gen = JaxLoadGen(jax_api.synthetic_cluster(num_nodes), seed=seed,
                         arrivals=8, evict_fraction=0.25)
    else:
        session = StreamSession(port_api.synthetic_cluster(num_nodes),
                                device="cpu")
        gen = ChurnLoadGen(port_api.synthetic_cluster(num_nodes), seed=seed,
                           arrivals=8, evict_fraction=0.25)
    for c in range(cycles):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
    return session


def staged_hash(session, pods):
    [result] = run_what_if([(session.inc.to_snapshot(), pods)], device="cpu")
    return placement_hash(result.placements)


def jax_twin_hash(seed, query_seed, **kw):
    """The JAX fleet's answer for the same twin and query."""
    session = _warm_twin("jax", seed=seed)
    fleet = JaxFleet(bucket_size=1, flush_after_s=60.0)
    fleet.attach_stream(session, ref="live")
    _, pods = scenario("jax", query_seed)
    fut = fleet.submit(JaxRequest(pods=pods, snapshot_ref="live", **kw))
    fleet.drain()
    resp = fut.result()
    assert resp.ok
    return jax_placement_hash(resp.result.placements), fleet.executor.stats


class TestLiveTwin:
    def test_overlay_parity_and_warm_second_query(self):
        session = _warm_twin()
        fleet = ScenarioFleet(bucket_size=4, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(session, ref="live")
        _, pods = scenario("port", 41)
        want = staged_hash(session, pods)
        carry = [t.clone() for t in session.device.carry]
        cold = fleet.submit(WhatIfRequest(pods=pods, snapshot_ref="live"))
        fleet.drain()
        resp = cold.result()
        assert resp.ok and not resp.compile_cache_hit
        assert placement_hash(resp.result.placements) == want
        assert want == jax_twin_hash(11, 41)[0]
        warm = fleet.submit(WhatIfRequest(pods=pods, snapshot_ref="live"))
        fleet.drain()
        resp2 = warm.result()
        assert resp2.ok and resp2.compile_cache_hit
        assert placement_hash(resp2.result.placements) == want
        assert fleet.executor.stats["overlay_hits"] == 2
        assert fleet.executor.stats["overlay_fallbacks"] == 0
        # the queries leave the resident carry bit-equal
        for before, after in zip(carry, session.device.carry):
            assert torch_equal(before, after)
        m = register()
        assert m.serve_dispatch.get("overlay") == 2
        assert m.overlay_queries.get("resident") == 2
        assert m.overlay_latency.count == 2
        assert m.serve_request_latency.count == 2

    def test_forced_restage_falls_back_to_staged_path(self):
        session = _warm_twin(seed=12)
        fleet = ScenarioFleet(bucket_size=1, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(session, ref="live")
        session.force_restage("test_fallback")
        _, pods = scenario("port", 42)
        want = staged_hash(session, pods)
        fut = fleet.submit(WhatIfRequest(pods=pods, snapshot_ref="live"))
        fleet.drain()
        resp = fut.result()
        # the staged path answered on the twin's SAME live host picture
        assert resp.ok
        assert placement_hash(resp.result.placements) == want
        assert fleet.executor.stats["overlay_fallbacks"] >= 1
        assert fleet.executor.stats["overlay_hits"] == 0
        assert register().overlay_fallback.get("forced_restage") == 1

    def test_plan_mismatch_routes_around_overlay(self):
        session = _warm_twin(seed=13)
        fleet = ScenarioFleet(bucket_size=1, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(session, ref="live")
        raw = json.loads((pathlib.Path(__file__).parent /
                          "compat_policies.json").read_text())["1.0"]
        _, pods = scenario("port", 43)
        fut = fleet.submit(WhatIfRequest(pods=pods, snapshot_ref="live",
                                         policy=decode_policy(raw)))
        fleet.drain()
        resp = fut.result()
        assert resp.ok  # staged on the live picture, twin untouched
        assert fleet.executor.stats["overlay_hits"] == 0
        assert fleet.executor.stats["overlay_fallbacks"] == 1
        assert register().overlay_fallback.get("plan_mismatch") == 1
        from tpusim.engine.policy import decode_policy as jax_decode

        want, jstats = jax_twin_hash(13, 43, policy=jax_decode(raw))
        assert placement_hash(resp.result.placements) == want
        assert jstats["overlay_hits"] == 0

    def test_detach_twin_restores_ref_lookup(self):
        session = _warm_twin(seed=14)
        fleet = ScenarioFleet(bucket_size=1, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(session, ref="live")
        fleet.executor.detach_twin("live")
        _, pods = scenario("port", 44)
        fut = fleet.submit(WhatIfRequest(pods=pods, snapshot_ref="live"))
        fleet.drain()
        assert fut.result().rejected == REJECT_UNKNOWN_SNAPSHOT
        assert register().serve_rejected.get(REJECT_UNKNOWN_SNAPSHOT) == 1

    def test_overlay_spans(self):
        from tpusim_torch.obs import recorder as flight

        session = _warm_twin(seed=15)
        fleet = ScenarioFleet(bucket_size=1, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(session, ref="live")
        _, pods = scenario("port", 45)
        rec = flight.install(flight.FlightRecorder())
        try:
            fut = fleet.submit(WhatIfRequest(pods=pods, snapshot_ref="live"))
            fleet.drain()
        finally:
            flight.uninstall()
        assert fut.result().ok
        names = [e["name"] for e in rec.events]
        for expected in ("serve:admit", "serve:overlay", "stream_commit",
                         "overlay_scan", "overlay_rollback",
                         "overlay_decode", "serve:overlay_resolve"):
            assert expected in names, expected
        overlay = [e for e in rec.events if e["name"] == "serve:overlay"]
        # the instant inside the span, then the span, both stamped with the
        # request's trace context (the JAX package stamps them too)
        assert [e["ph"] for e in overlay] == ["i", "X"]
        stamp = {"trace_id": overlay[1]["args"]["trace_id"],
                 "span_id": overlay[1]["args"]["span_id"]}
        assert overlay[1]["args"] == {"ref": "live", "path": "resident",
                                      **stamp}
        assert overlay[0]["args"] == {"path": "resident", "ref": "live",
                                      "pods": 3, **stamp}


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def _serve_podspec(tmp_path):
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([{
        "name": "q", "num": 6,
        "pod": {"metadata": {"name": "q"},
                "spec": {"containers": [{"resources": {"requests": {
                    "cpu": "250m", "memory": "256Mi"}}}]}}}]))
    return spec


def test_cli_serve_attach_stream(tmp_path, capsys):
    spec = _serve_podspec(tmp_path)
    args = ["serve", "--synthetic-nodes", "8", "--podspec", str(spec),
            "--requests", "6", "--attach-stream", "--stream-cycles", "3",
            "--warm-repeats", "1", "--quiet"]
    metrics = tmp_path / "m.prom"
    trace = tmp_path / "t.json"
    assert main(args + ["--device", "cpu", "--metrics-out", str(metrics),
                        "--trace-out", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "overlay: 12 served from the resident twin, 0 staged fallbacks" \
        in out
    assert re.search(r"cold: 6/6 ok .* compile_cache_hit \d+/6", out)
    text = metrics.read_text()
    assert 'tpusim_overlay_queries_total{path="resident"} 12' in text
    assert 'tpusim_serve_dispatch_total{path="overlay"} 12' in text
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"serve:admit", "serve:overlay", "overlay_scan"} <= names
    assert jax_main(args) == 0
    jax_out = capsys.readouterr().out
    assert "overlay: 12 served from the resident twin, 0 staged fallbacks" \
        in jax_out


def test_depth_gauge_tracks_transitions():
    q = AdmissionQueue(maxsize=4)
    q.put("a"), q.put("b")
    assert register().serve_queue_depth.value == 2
    q.pop()
    assert register().serve_queue_depth.value == 1


def test_serve_metric_families_exposed():
    snap, pods = scenario("port", 33)
    ScenarioFleet(bucket_size=2, flush_after_s=60.0, device="cpu").run(
        [WhatIfRequest(pods=pods, snapshot=snap)])
    m = register()
    text = m.expose()
    for family in ("tpusim_serve_queue_depth",
                   "tpusim_serve_batch_occupancy",
                   "tpusim_serve_request_latency_microseconds",
                   "tpusim_serve_dispatch_total"):
        assert family in text, family
    assert m.serve_batch_occupancy.count == 1
    assert m.serve_request_latency.count == 1
    assert m.serve_dispatch.get("cold") == 1
