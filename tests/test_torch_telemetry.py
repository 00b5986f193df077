"""The port's live telemetry plane (obs/slo.py, obs/tracectx.py,
obs/server.py, the recorder's trace stamp, the seams in the stream runtime,
run_stream_simulation, the backend and serve, and the CLI's top) against the
JAX package's, on the CPU.

- SloTracker: one latency sequence through both trackers: the verdict
  counts, the burn rate after every cycle, the burn_start/burn_end
  instants, reset.
- tracectx: start() is None without a recorder, children share the trace,
  the wire form round-trips, malformed stamps read as None, activate
  nests.
- A traced run_stream_simulation(device="cpu"), synchronous and pipelined,
  under one counting id source: every event's (name, trace_id, span_id)
  and the exemplars on the exposition equal the JAX package's, and the
  export passes tools/trace_lint.py; tracing leaves the chain as it was.
- Serve: tests/test_trace.py's overlay-hit and staged-fallback cases and
  its lint-clean export (the breaker case waits for the chaos module).
- The server on 127.0.0.1 (a port the OS picks): /metrics byte-equal to
  register().expose(), /healthz the JAX package's keys and values, the
  disabled bodies of /analytics and /debug/trace, 404, parse_listen.
- top: _render_top byte-equal to the JAX function on the same bodies, an
  unreachable endpoint rc 2 on both.
Tolerance: exact.
"""

import contextlib
import importlib.util
import io
import itertools
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpusim import cli as jax_cli
from tpusim.framework.metrics import register as jax_register
from tpusim.obs import recorder as jax_flight
from tpusim.obs import server as jax_server
from tpusim.obs import slo as jax_slo
from tpusim.obs import tracectx as jax_tracectx
from tpusim.simulator import run_stream_simulation as jax_stream

from tpusim_torch import cli
from tpusim_torch.api.snapshot import (
    ClusterSnapshot,
    make_node,
    make_pod,
    synthetic_cluster,
)
from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import analytics, server, slo, tracectx
from tpusim_torch.obs import recorder as flight
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import ChurnLoadGen, StreamSession

JAX = (jax_flight, jax_tracectx, jax_slo, jax_register)
PORT = (flight, tracectx, slo, register)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def traced(pkg):
    """A recorder with a counting id source installed on `pkg`."""
    rec_mod, tc, _, reg = pkg
    reg().reset()
    counter = itertools.count(1)
    tc.set_id_source(lambda: f"{next(counter):016x}")
    rec = rec_mod.install(rec_mod.FlightRecorder(process_name="test"))
    try:
        yield rec
    finally:
        rec_mod.uninstall()
        tc.set_id_source(None)


@pytest.fixture(autouse=True)
def _clean():
    yield
    flight.uninstall()
    slo.uninstall()
    analytics.uninstall()
    tracectx.set_id_source(None)


# --- the SLO tracker -------------------------------------------------------

_RNG = np.random.RandomState(13)
# quiet stretches under the 1,100 us target around two bursts over it, so
# the burn rate crosses the alert both ways twice
LATENCIES = [float(x) for n, lo, hi in ((50, 300, 1_100), (20, 1_100, 9_000),
                                        (60, 300, 1_100), (5, 1_200, 2_000),
                                        (60, 300, 1_100))
             for x in _RNG.randint(lo, hi, size=n)]


def _slo_story(pkg):
    rec_mod, _, slo_mod, reg = pkg
    with traced(pkg) as rec:
        tracker = slo_mod.install(slo_mod.SloTracker(1_100.0, window=32))
        burns = []
        for i, us in enumerate(LATENCIES):
            slo_mod.observe_cycle("stream_scan" if i % 3 else "pipelined",
                                  us)
            burns.append(tracker.burn_rate)
        counts = (reg().slo_cycles.get("ok"), reg().slo_cycles.get("breach"),
                  reg().slo_burn_rate.value, reg().slo_target.value)
        tracker.reset()
        after_reset = (tracker.burn_rate, reg().slo_burn_rate.value)
        slo_mod.uninstall()
        instants = [(e["name"], e["args"]) for e in rec.events
                    if e["name"].startswith("slo:")]
    return burns, counts, after_reset, instants, reg().slo_target.value


def test_slo_tracker_matches_jax():
    got = _slo_story(PORT)
    assert got == _slo_story(JAX)
    burns, counts, _, instants, target_after = got
    assert counts[0] and counts[1] and max(burns) > 1.0
    assert [name for name, _ in instants] == [
        "slo:burn_start", "slo:burn_end"] * 2
    assert target_after == 0.0


def test_slo_tracker_refuses_bad_arguments_and_idles_without_install():
    for kwargs in ({"target_us": 0}, {"target_us": 1, "objective": 1.0}):
        with pytest.raises(ValueError):
            slo.SloTracker(**kwargs)
    register().reset()
    slo.observe_cycle("stream_scan", 10.0)  # no tracker: a None check
    assert register().slo_cycles.get("ok") == 0


# --- trace context ---------------------------------------------------------

def test_tracectx_semantics():
    assert tracectx.start() is None  # no recorder: nothing allocated
    with tracectx.activate(None) as ctx:
        assert ctx is None and tracectx.current() is None
    with traced(PORT):
        root = tracectx.start()
        child = tracectx.start(parent=root)
        assert (root.trace_id, root.span_id) == ("0000000000000001",
                                                 "0000000000000002")
        assert (child.trace_id, child.parent_id) == (root.trace_id,
                                                     root.span_id)
        with tracectx.activate(root):
            with tracectx.activate(child):
                assert tracectx.current() is child
            assert tracectx.current() is root
        assert tracectx.current() is None
        wire = child.to_wire()
        back = tracectx.TraceContext.from_wire(wire)
        assert (back.trace_id, back.span_id) == (child.trace_id,
                                                 child.span_id)
        for bad in (None, [], {"tid": 1, "sid": "x"}, {"tid": "x"}):
            assert tracectx.TraceContext.from_wire(bad) is None
        token = tracectx.attach(root)
        tracectx.detach(token)
        assert tracectx.current() is None
    tracectx.set_id_source(None)
    ids = {tracectx._next_id() for _ in range(4)}
    assert len(ids) == 4 and all(len(i) == 16 for i in ids)


def test_recorder_stamps_the_active_context():
    with traced(PORT) as rec:
        with tracectx.activate(tracectx.start()):
            with flight.span("a"):
                pass
            flight.instant("b")
            flight.flow_start("c", "f1", site="serve")
            flight.flow_end("c", "f1")
        flight.instant("outside")
    stamped = {e["name"]: (e.get("args") or {}).get("trace_id")
               for e in rec.events}
    assert stamped == {"a": "0000000000000001", "b": "0000000000000001",
                       "c": "0000000000000001", "outside": None}
    assert register().trace_flows.get("serve") == 1


# --- a traced stream against the JAX package's -----------------------------

CELL = dict(num_nodes=8, cycles=4, arrivals=6, evict_fraction=0.25, seed=3)
# the spans the port records around its own host work and the JAX package
# does not (tests/test_torch_stream_spans.py holds them)
PORT_ONLY = {"stream_route", "commit_gather", "stream_pack",
             "stream_foldback"}


def _events(rec):
    return [(e["name"], (e.get("args") or {}).get("trace_id"),
             (e.get("args") or {}).get("span_id")) for e in rec.events]


def _exemplar_series(text):
    """The exposition lines with an exemplar, their values dropped."""
    import re

    return [re.sub(r" \S+ # (\{[^}]*\}) \S+$", r" # \1", line)
            for line in text.splitlines() if "trace_id=" in line]


@pytest.mark.parametrize("pipeline", [False, True])
def test_traced_stream_matches_jax(pipeline):
    with traced(JAX) as jrec:
        want = jax_stream(pipeline=pipeline, **CELL)
    jax_text = jax_register().expose()
    with traced(PORT) as rec:
        got = run_stream_simulation(device="cpu", pipeline=pipeline, **CELL)
    text = register().expose()
    port, jax = _events(rec), _events(jrec)
    # every event of the JAX package's, in order, with its trace and span
    # ids; beside them only the port's own spans
    assert {e[0] for e in port} - {e[0] for e in jax} == PORT_ONLY
    assert [e for e in port if e[0] not in PORT_ONLY] == jax
    assert _exemplar_series(text) == _exemplar_series(jax_text)
    assert _exemplar_series(text)
    assert got["placement_chain"] == want["placement_chain"]
    lint = _load_tool("trace_lint")
    doc = json.loads(rec.to_chrome_json())
    assert lint.lint_trace(doc) == []
    assert lint.lint_exemplars(doc, text) == []
    # one trace a driver cycle, its ingest and its dispatch on it
    per_trace = {}
    for name, tid, _ in _events(rec):
        if tid is not None:
            per_trace.setdefault(tid, []).append(name)
    cycles = [n for n in per_trace.values() if "stream_ingest" in n]
    assert len(cycles) == CELL["cycles"]
    assert all(n.count("device_dispatch") == 1 for n in cycles)


def test_tracing_leaves_the_chain_unchanged():
    register().reset()
    off = run_stream_simulation(device="cpu", **CELL)
    with traced(PORT):
        on = run_stream_simulation(device="cpu", **CELL)
    assert on["fold_chain"] == off["fold_chain"] and off["fold_chain"]


# --- serve traces (tests/test_trace.py) -----------------------------------

def _scenario(seed, num_nodes=4, num_pods=3):
    rng = np.random.RandomState(seed)
    nodes = [make_node(f"t{seed}-n{i}",
                       milli_cpu=int(rng.choice([2000, 4000, 8000])),
                       memory=int(rng.choice([4, 8])) * 1024 ** 3)
             for i in range(num_nodes)]
    pods = [make_pod(f"t{seed}-p{i}", milli_cpu=int(rng.randint(100, 1500)),
                     memory=int(rng.randint(2 ** 20, 2 ** 30)))
            for i in range(num_pods)]
    return ClusterSnapshot(nodes=nodes), pods


def _warm_twin(num_nodes=8, cycles=3, seed=11):
    session = StreamSession(synthetic_cluster(num_nodes), device="cpu")
    gen = ChurnLoadGen(synthetic_cluster(num_nodes), seed=seed, arrivals=8,
                       evict_fraction=0.25)
    for c in range(cycles):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
    return session


def _named(rec, name, ph=None):
    return [e for e in rec.events if e.get("name") == name
            and (ph is None or e.get("ph") == ph)]


def test_overlay_hit_path_is_one_connected_trace():
    twin = _warm_twin()
    with traced(PORT) as rec:
        slo.install(slo.SloTracker(60e6))
        fleet = ScenarioFleet(bucket_size=4, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(twin, ref="live")
        request = WhatIfRequest(pods=_scenario(41, num_nodes=8)[1],
                                snapshot_ref="live")
        fut = fleet.submit(request)
        fleet.drain()
        assert fut.result().ok
        judged = register().slo_cycles.get("ok")
    [ov] = _named(rec, "serve:overlay", ph="X")
    assert ov["args"]["path"] == "resident"
    trace_id = ov["args"]["trace_id"]
    assert trace_id == request.trace.trace_id
    assert any(e["args"].get("trace_id") == trace_id
               for e in _named(rec, "serve:admit"))
    [resolve] = _named(rec, "serve:overlay_resolve")
    assert resolve["args"]["trace_id"] == trace_id
    s = [e for e in rec.events if e.get("ph") == "s"]
    f = [e for e in rec.events if e.get("ph") == "f"]
    assert [e["id"] for e in s] == [f"{trace_id}:q"]
    assert {e["id"] for e in s} == {e["id"] for e in f}
    assert judged == 1
    assert f'trace_id="{trace_id}"' in register().expose()


def test_staged_fallback_keeps_the_request_context():
    session = _warm_twin(seed=12)
    with traced(PORT) as rec:
        fleet = ScenarioFleet(bucket_size=1, flush_after_s=60.0,
                              device="cpu")
        fleet.attach_stream(session, ref="live")
        session.force_restage("trace_fallback_test")
        fut = fleet.submit(WhatIfRequest(pods=_scenario(42, num_nodes=8)[1],
                                         snapshot_ref="live"))
        fleet.drain()
        assert fut.result().ok
    [ov] = _named(rec, "serve:overlay", ph="X")
    assert ov["args"]["path"] == "fallback"
    trace_id = ov["args"]["trace_id"]
    for name in ("serve:stage", "serve:decode", "serve:dispatch"):
        assert any(e.get("args", {}).get("trace_id") == trace_id
                   for e in _named(rec, name)), name
    s = {e["id"] for e in rec.events if e.get("ph") == "s"}
    f = {e["id"] for e in rec.events if e.get("ph") == "f"}
    assert s == f == {f"{trace_id}:q", f"{trace_id}:b"}


def test_serve_trace_exports_lint_clean():
    with traced(PORT) as rec:
        fleet = ScenarioFleet(bucket_size=2, flush_after_s=60.0,
                              device="cpu")
        snap, pods = _scenario(44)
        responses = fleet.run([WhatIfRequest(pods=pods, snapshot=snap)
                               for _ in range(3)])
    assert all(r.ok for r in responses)
    assert _load_tool("trace_lint").lint_trace(
        json.loads(rec.to_chrome_json())) == []


def test_untraced_serve_sets_no_context():
    register().reset()
    fleet = ScenarioFleet(bucket_size=2, flush_after_s=60.0, device="cpu")
    snap, pods = _scenario(45)
    request = WhatIfRequest(pods=pods, snapshot=snap)
    assert fleet.run([request])[0].ok
    assert getattr(request, "trace", None) is None
    assert "trace_id" not in register().expose()


# --- the server --------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def test_server_endpoints():
    # /healthz reports each package's process-wide replication role: start
    # both from none, whatever a test before this one in the process left
    from tpusim.stream import replicate as jax_replicate
    from tpusim_torch.stream import replicate

    for mod in (replicate, jax_replicate):
        mod.set_role("none")
        mod._set_state(replication_lag_records=0, last_shipped_seq=-1)
    register().reset()
    run_stream_simulation(device="cpu", **CELL)
    srv = server.start_server("127.0.0.1:0")
    try:
        status, ctype, body = _get(srv.url + "/metrics")
        assert (status, ctype) == (200, server.METRICS_CONTENT_TYPE)
        assert body.decode() == register().expose()
        assert _get(srv.url + "/debug/trace")[::2] == (200, (json.dumps(
            {"dropped": 0, "dropped_by_category": {}, "enabled": False,
             "events": []}, sort_keys=True) + "\n").encode())
        status, _, body = _get(srv.url + "/analytics")
        doc = json.loads(body)
        assert status == 200 and not doc["enabled"]
        assert set(doc) == {"enabled", "hbm", "compile"}
        assert _get(srv.url + "/debug/provenance")[::2] == (200, b"[]\n")
        assert _get(srv.url + "/nope")[::2] == (404, b"not found\n")
        status, _, body = _get(srv.url + "/healthz")
        health = json.loads(body)
    finally:
        srv.stop()
    jax_register().reset()
    # the same run publishes the same stream chain head on both sides
    jax_stream(**CELL)
    jax_status, jax_health = jax_server.health_payload()
    assert status == jax_status == 200
    assert sorted(health) == sorted(jax_health)
    assert health == jax_health
    assert (health["status"], health["role"]) == ("ok", "none")


def test_server_serves_live_trace_and_analytics():
    with traced(PORT):
        log = analytics.install(analytics.ClusterAnalytics(
            sample_interval_s=0.0))
        srv = server.start_server(":0")
        try:
            run_stream_simulation(device="cpu", **CELL)
            trace = json.loads(_get(srv.url + "/debug/trace?limit=5")[2])
            body = json.loads(_get(srv.url + "/analytics?limit=2")[2])
            bad = _get(srv.url + "/analytics?limit=x")[0]
        finally:
            srv.stop()
    assert trace["enabled"] and len(trace["events"]) == 5
    assert body["enabled"] and body["samples"] == CELL["cycles"]
    assert [r["seq"] for r in body["series"]] == [2, 3]
    assert body["latest"] == log.latest() and bad == 200


@pytest.mark.parametrize("spec,want", [
    ("127.0.0.1:9100", ("127.0.0.1", 9100)), (":9100", ("127.0.0.1", 9100)),
    ("9100", ("127.0.0.1", 9100)), ("[::1]:80", ("[::1]", 80)),
    (" 0.0.0.0:0 ", ("0.0.0.0", 0))])
def test_parse_listen_matches_jax(spec, want):
    assert server.parse_listen(spec) == jax_server.parse_listen(spec) == want


def test_parse_listen_refuses_what_jax_refuses():
    for spec in ("host:port", "x"):
        for mod in (server, jax_server):
            with pytest.raises(ValueError):
                mod.parse_listen(spec)


# --- top -------------------------------------------------------------------

def _top_bodies():
    log = analytics.ClusterAnalytics(sample_interval_s=0.0)
    analytics.install(log)
    try:
        run_stream_simulation(device="cpu", **CELL)
        live = json.loads(json.dumps(log.snapshot(), sort_keys=True))
    finally:
        analytics.uninstall()
    live["hbm"] = {"stream_twin": {"bytes": 3 * 1024 ** 2 + 17,
                                   "entries": 1, "tenants": {}},
                   "tiny": {"bytes": 12, "entries": 2, "tenants": {}}}
    live["compile"] = {"stream_restage": {"traces": 2,
                                          "total_us": 1_234_567.0}}
    waiting = {"enabled": True, "samples": 0, "latest": None}
    return {"live": live, "waiting": waiting, "disabled": {"enabled": False},
            "cold": dict(live, latest=dict(live["latest"], cycle=None,
                                           hot_nodes=[], cold_nodes=[]))}


def test_render_top_matches_jax():
    for name, body in _top_bodies().items():
        assert cli._render_top(body, "http://h:1") == \
            jax_cli._render_top(body, "http://h:1"), name
    assert [cli._fmt_bytes(n) for n in (0, 1023, 1024, 5 * 2 ** 30)] == \
        [jax_cli._fmt_bytes(n) for n in (0, 1023, 1024, 5 * 2 ** 30)]


def test_top_against_a_live_endpoint_and_unreachable():
    analytics.install(analytics.ClusterAnalytics(sample_interval_s=0.0))
    srv = server.start_server("127.0.0.1:0")
    try:
        run_stream_simulation(device="cpu", **CELL)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["top", srv.url, "--once"])
        raw = io.StringIO()
        with contextlib.redirect_stdout(raw):
            rc_json = cli.main(["top", f":{srv.address[1]}", "--json"])
    finally:
        srv.stop()
    assert rc == rc_json == 0
    assert f"nodes: {CELL['num_nodes']} valid" in out.getvalue()
    assert json.loads(raw.getvalue())["enabled"]
    for main in (cli.main, jax_cli.main):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(["top", "127.0.0.1:1", "--once"]) == 2
        assert "cannot reach http://127.0.0.1:1/analytics" in err.getvalue()
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(["top", "bad:endpoint"]) == 2


# --- the CLI's live plane ----------------------------------------------------

def test_stream_listen_and_slo_flags(tmp_path, capsys):
    path = tmp_path / "m.prom"
    rc = cli.main(["stream", "--synthetic-nodes", "8", "--cycles", "3",
                   "--arrivals", "4", "--device", "cpu", "--listen",
                   "127.0.0.1:0", "--slo-target-ms", "60000",
                   "--metrics-out", str(path)])
    err = capsys.readouterr().err
    assert rc == 0
    assert err.startswith("telemetry: listening on http://127.0.0.1:")
    text = path.read_text()
    assert 'tpusim_slo_cycles_total{verdict="ok"} 3' in text
    # teardown disarmed everything
    assert slo.get_tracker() is None and analytics.get() is None


def test_serve_listen_flag(tmp_path, capsys):
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([{"name": "q", "num": 4, "pod": make_pod(
        "q", milli_cpu=250, memory=256 * 2 ** 20).to_obj()}]))
    rc = cli.main(["serve", "--synthetic-nodes", "8", "--podspec", str(spec),
                   "--requests", "4", "--warm-repeats", "0", "--device",
                   "cpu", "--listen", ":0", "--slo-target-ms", "60000",
                   "--quiet"])
    captured = capsys.readouterr()
    assert rc == 0 and "telemetry: listening on" in captured.err
    assert captured.out.startswith("cold: 4/4 ok")
