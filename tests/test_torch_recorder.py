"""The port's flight recorder (tpusim_torch.obs.recorder) against the JAX
package's, after tests/test_recorder.py: the span and instant export shape,
the Chrome and JSONL exports, the shared no-op span when no recorder is
installed, and, under one injected clock, the ordered span names,
categories and argument keys of a run equal to the JAX package's: on the
host route and on the torch backend's kernel and scan routes (the JAX
package's fused kernel in Pallas interpret mode and its XLA scan), the
route instants read through ROUTE_MAP. The CLI's --trace-out is valid
Chrome JSON and is refused with --what-if; a recorder changes no placement.

The AUTO verify-then-trust cases of tests/test_recorder.py have no
counterpart: the port has no such seam.
"""

import itertools
import json

import numpy as np
import pytest

import tpusim.api.snapshot as jax_api
from tpusim.framework.metrics import register as jax_register
from tpusim.obs import recorder as jax_flight
from tpusim.simulator import run_simulation as jax_run_simulation

import tpusim_torch.api.snapshot as port_api
from tpusim_torch import cli
from tpusim_torch.backends import placement_hash
from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import recorder as flight
from tpusim_torch.obs.recorder import NOOP_SPAN, FlightRecorder
from tpusim_torch.simulator import run_simulation

# the JAX package's route names for each of the port's TorchBackend routes
ROUTE_MAP = {"fastscan": "kernel", "fastscan_interpret": "kernel",
             "xla_scan": "scan", "xla_chunked": "scan",
             "reference_fallback": "reference"}


def _clock():
    """Deterministic 1 ms-step clock."""
    return itertools.count(0.0, 0.001).__next__


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    yield
    flight.uninstall()
    jax_flight.uninstall()
    register().reset()
    jax_register().reset()


def _cluster(api, memory=2**20):
    nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=2**33)
             for i in range(3)]
    pods = [api.make_pod(f"p{i}", milli_cpu=100, memory=memory)
            for i in range(4)]
    return api.ClusterSnapshot(nodes=nodes), pods


class TestFlightRecorder:
    def test_span_event_shape(self):
        recs = {}
        for k, mod in (("port", flight), ("jax", jax_flight)):
            rec = mod.FlightRecorder(clock=_clock())
            with rec.span("predicates") as sp:
                sp.set("nodes", 3)
            recs[k] = list(rec.events)
        assert recs["port"] == recs["jax"] == [{
            "name": "predicates", "cat": "host", "ph": "X",
            "ts": 1000.0, "dur": 1000.0, "pid": 1, "tid": 1,
            "args": {"nodes": 3},
        }]

    def test_device_category_track_and_instant(self):
        rec = FlightRecorder(clock=_clock())
        rec.span("device_dispatch", "device", "cpu").end()
        rec.instant("route:scan", "device", {"pods": 4})
        assert [e["tid"] for e in rec.events] == [2, 2]
        inst = rec.events[1]
        assert inst["ph"] == "i" and inst["s"] == "g"
        # a device span on the CPU carries no CUDA-event time
        assert "args" not in rec.events[0]
        rec.span("odd", "mystery").end()
        assert rec.events[2]["tid"] == 4
        meta = [e for e in rec.to_chrome()["traceEvents"] if e["ph"] == "M"]
        assert [m["args"]["name"] for m in meta[1:]] == [
            "host", "device", "tool", "mystery"]

    def test_add_span_uses_explicit_readings(self):
        rec = FlightRecorder(clock=_clock())
        t0, t1 = rec.clock(), rec.clock()
        rec.add_span("queue_wait", "host", t0, t1, {"pod": "default/p0"})
        assert rec.events[0]["ts"] == 1000.0
        assert rec.events[0]["dur"] == 1000.0

    def test_chrome_export_metadata(self):
        docs = {}
        for k, mod in (("port", flight), ("jax", jax_flight)):
            rec = mod.FlightRecorder(clock=_clock())
            rec.span("x").end()
            rec.flow_start("hand", "f1")
            rec.flow_end("hand", "f1")
            docs[k] = rec.to_chrome_json()
        assert docs["port"] == docs["jax"]
        doc = json.loads(docs["port"])
        assert doc["displayTimeUnit"] == "ms"
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert meta[0]["args"]["name"] == "tpusim"
        assert [m["args"]["name"] for m in meta[1:]] == ["host", "device",
                                                         "tool"]

    def test_jsonl_export(self):
        texts = {}
        for k, mod in (("port", flight), ("jax", jax_flight)):
            rec = mod.FlightRecorder(clock=_clock())
            rec.span("a").end()
            rec.instant("b")
            texts[k] = rec.to_jsonl()
        text = texts["port"]
        assert text == texts["jax"]
        assert text.endswith("\n")
        lines = text.splitlines()
        assert len(lines) == 2
        assert json.loads(lines[0])["name"] == "a"

    def test_write_dispatches_on_extension(self, tmp_path):
        rec = FlightRecorder(clock=_clock())
        rec.span("a").end()
        chrome, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
        rec.write(str(chrome))
        rec.write(str(jsonl))
        assert "traceEvents" in json.loads(chrome.read_text())
        assert json.loads(jsonl.read_text().splitlines()[0])["name"] == "a"


class TestDisabledPath:
    def test_span_is_shared_noop_when_uninstalled(self):
        assert flight.get_recorder() is None
        sp = flight.span("pod_attempt")
        assert sp is NOOP_SPAN
        assert sp is flight.span("anything_else")
        assert sp is flight.span("device_dispatch", "device", "cpu")
        assert not sp  # falsy: call sites skip label construction
        sp.set("k", "v")
        sp.end()
        with flight.span("x"):
            pass
        flight.instant("y")  # no-op, no error
        flight.note_route("scan", 4)  # counts, records nothing
        assert register().backend_route.get("scan") == 1

    def test_install_uninstall(self):
        rec = flight.install(FlightRecorder(clock=_clock()))
        assert flight.get_recorder() is rec
        assert flight.span("a")  # truthy live span
        flight.uninstall()
        assert flight.get_recorder() is None
        assert flight.span("a") is NOOP_SPAN


def _run_port(backend, route="auto", memory=2**20):
    snapshot, pods = _cluster(port_api, memory)
    rec = flight.install(FlightRecorder(clock=_clock()))
    try:
        status = run_simulation(pods, snapshot, backend=backend,
                                device="cpu", route=route)
    finally:
        flight.uninstall()
    assert len(status.successful_pods) == 4
    return rec


def _run_jax(backend, monkeypatch=None, fast=None, memory=2**20):
    if fast is not None:
        monkeypatch.setenv("TPUSIM_FAST", fast)
        if fast == "1":
            monkeypatch.setenv("TPUSIM_FAST_INTERPRET", "1")
    snapshot, pods = _cluster(jax_api, memory)
    rec = jax_flight.install(jax_flight.FlightRecorder(clock=_clock()))
    try:
        status = jax_run_simulation(pods, snapshot, backend=backend)
    finally:
        jax_flight.uninstall()
    assert len(status.successful_pods) == 4
    return rec


def structure(rec, port: bool = False):
    """(name, category, phase, argument keys) of each event in order, the
    JAX package's route names read as the port's."""
    out = []
    for e in rec.events:
        name = e["name"]
        if name.startswith("route:") and not port:
            name = "route:" + ROUTE_MAP[name[len("route:"):]]
        out.append((name, e["cat"], e["ph"],
                    tuple(sorted((e.get("args") or {}).keys()))))
    return out


class TestGoldens:
    def test_reference_backend_span_mix(self):
        rec = _run_port("reference")
        names = [e["name"] for e in rec.events]
        for expected in ["queue_wait", "pod_attempt", "schedule",
                         "predicates", "priorities", "select_host",
                         "assume", "bind"]:
            assert expected in names, f"missing host span {expected}"
        assert names.count("pod_attempt") == 4
        outcome = [e["args"]["outcome"] for e in rec.events
                   if e["name"] == "pod_attempt"]
        assert outcome == ["bound"] * 4

    def test_reference_backend_equals_jax(self):
        port = _run_port("reference").to_chrome_json()
        assert port == _run_port("reference").to_chrome_json()
        # the same clock readings in the same order: the whole trace is
        # byte-equal to the JAX package's
        assert port == _run_jax("reference").to_chrome_json()

    def test_torch_backend_device_spans(self):
        rec = _run_port("torch")
        by_cat = {}
        for e in rec.events:
            by_cat.setdefault(e["cat"], []).append(e["name"])
        assert "backend_schedule" in by_cat["host"]
        assert "compile_cluster" in by_cat["host"]
        assert "decode_placements" in by_cat["host"]
        assert "device_dispatch" in by_cat["device"]
        assert "route:kernel" in by_cat["device"]
        assert rec.to_chrome_json() == _run_port("torch").to_chrome_json()

    @pytest.mark.parametrize("route,fast,memory", [
        ("scan", "0", 2**20),
        # a byte-granular pod memory the int32 plan refuses: the refusal
        # instant, then the scan
        ("auto", "1", 2**20 + 1),
    ])
    def test_torch_scan_route_structure_equals_jax(self, monkeypatch, route,
                                                   fast, memory):
        port = structure(_run_port("torch", route, memory), port=True)
        want = structure(_run_jax("jax", monkeypatch, fast, memory))
        assert port == want
        names = [s[0] for s in port]
        assert "route:scan" in names
        assert any(n.startswith("fallback:") for n in names) == \
            (route == "auto")
        if route == "auto":
            assert register().fast_fallback.get("int32_overflow") == 1

    def test_torch_kernel_route_structure_equals_jax(self, monkeypatch):
        """The JAX package's fused kernel in Pallas interpret mode (the
        opt-in, so no verify-then-trust instants)."""
        port = structure(_run_port("torch", "kernel"), port=True)
        assert port == structure(_run_jax("jax", monkeypatch, "1"))
        assert ("route:kernel", "device", "i", ("pods",)) in port
        assert ("device_dispatch", "device", "X",
                ("pods", "route", "sig")) in port

    def test_recorder_changes_no_placement(self):
        for backend, route in (("reference", "auto"), ("torch", "kernel"),
                               ("torch", "scan")):
            snapshot, pods = _cluster(port_api)
            plain = run_simulation(pods, snapshot, backend=backend,
                                   device="cpu", route=route)
            snapshot, pods = _cluster(port_api)
            flight.install(FlightRecorder())
            try:
                traced = run_simulation(pods, snapshot, backend=backend,
                                        device="cpu", route=route)
            finally:
                flight.uninstall()
            split = lambda s: ([(p.name, p.spec.node_name)  # noqa: E731
                                for p in s.successful_pods],
                               [p.name for p in s.failed_pods])
            assert split(traced) == split(plain)

    def test_preemption_and_gang_spans(self):
        """The hybrid's compile and dispatch spans and its victim-path
        instant, and the gang driver's admission span and note."""
        from tpusim_torch.gang.group import (
            GANG_MIN_AVAILABLE_ANNOTATION,
            GANG_NAME_ANNOTATION,
        )

        node = port_api.make_node("n0", milli_cpu=1000, memory=2**30)
        victim = port_api.make_pod("victim", milli_cpu=900, memory=1,
                                   node_name="n0", phase="Running")
        victim.spec.priority = 0
        contender = port_api.make_pod("contender", milli_cpu=900, memory=1)
        contender.spec.priority = 100
        rec = flight.install(FlightRecorder(clock=_clock()))
        try:
            status = run_simulation(
                [contender], port_api.ClusterSnapshot(nodes=[node],
                                                      pods=[victim]),
                enable_pod_priority=True, device="cpu")
            assert [p.name for p in status.preempted_pods] == ["victim"]
            members = []
            for i in range(2):
                pod = port_api.make_pod(f"g{i}", milli_cpu=100, memory=1)
                pod.metadata.annotations = {GANG_NAME_ANNOTATION: "team",
                                            GANG_MIN_AVAILABLE_ANNOTATION: "2"}
                members.append(pod)
            run_simulation(members, port_api.synthetic_cluster(3),
                           device="cpu")
        finally:
            flight.uninstall()
        names = [e["name"] for e in rec.events]
        for expected in ("compile_cluster", "device_dispatch", "gang:admit",
                         "backend_schedule"):
            assert expected in names, expected
        # the victims are picked on the device, or by the host pipeline
        # under its preempt span
        assert ("victim:device" in names
                or {"victim:host", "preempt", "preempt_candidates"}
                <= set(names))
        m = register()
        assert m.preemption_attempts.value == 1
        assert m.gang_admitted.value == 1
        assert m.gang_size.count == 1


def _podspec(tmp_path):
    spec = tmp_path / "podspec.json"
    spec.write_text(json.dumps([{
        "name": "quickstart", "num": 4,
        "pod": {"metadata": {"name": "quickstart"},
                "spec": {"containers": [{"resources": {"requests": {
                    "cpu": "500m", "memory": "512Mi"}}}]}}}]))
    return spec


class TestChromeValidity:
    @pytest.mark.parametrize("backend", ["reference", "torch"])
    def test_cli_trace_artifact_is_valid_chrome_json(self, tmp_path, capsys,
                                                     backend):
        trace = tmp_path / "trace.json"
        metrics = tmp_path / "metrics.prom"
        rc = cli.main(["--podspec", str(_podspec(tmp_path)),
                       "--synthetic-nodes", "3", "--backend", backend,
                       "--device", "cpu", "--trace-out", str(trace),
                       "--metrics-out", str(metrics)])
        assert rc == 0
        doc = json.load(trace.open())
        assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
        for ev in doc["traceEvents"]:
            assert ev["ph"] in ("X", "i", "M", "s", "f")
            assert "ts" in ev and "pid" in ev
            if ev["ph"] == "X":
                assert ev["dur"] >= 0
        names = {e["name"] for e in doc["traceEvents"]}
        if backend == "reference":
            assert {"pod_attempt", "schedule", "bind"} <= names
        else:
            assert {"compile_cluster", "device_dispatch",
                    "decode_placements", "backend_schedule"} <= names
        text = metrics.read_text()
        assert text.endswith("\n")
        assert "scheduler_e2e_scheduling_latency_microseconds" in text
        assert flight.get_recorder() is None

    def test_trace_out_rejected_with_what_if(self, tmp_path, capsys):
        rc = cli.main(["--what-if", str(tmp_path / "w.yaml"),
                       "--trace-out", str(tmp_path / "t.json")])
        assert rc == 2
        assert "--what-if" in capsys.readouterr().err

    def test_metrics_out_families(self, tmp_path, capsys):
        """--metrics-out after a torch run exposes the scheduler_* and
        tpusim_backend_* families with the run's counts."""
        metrics = tmp_path / "metrics.prom"
        rc = cli.main(["--podspec", str(_podspec(tmp_path)),
                       "--synthetic-nodes", "3", "--device", "cpu",
                       "--metrics-out", str(metrics), "--quiet"])
        assert rc == 0
        text = metrics.read_text()
        assert "scheduler_e2e_scheduling_latency_microseconds_count 1" in text
        assert 'tpusim_backend_route_total{route="kernel"} 1' in text
        assert "tpusim_backend_compile_latency_microseconds_count 1" in text


def test_torch_placements_equal_jax_with_recorders():
    """A recorder on each side changes nothing the JAX package holds the
    port to: the placement hashes of the traced runs agree."""
    from tpusim.backends import placement_hash as jax_placement_hash
    from tpusim.jaxe.backend import JaxBackend

    from tpusim_torch.backend import TorchBackend

    snapshot, pods = _cluster(port_api)
    jsnap, jpods = _cluster(jax_api)
    flight.install(FlightRecorder())
    jax_flight.install(jax_flight.FlightRecorder())
    try:
        got = TorchBackend(device="cpu").schedule(pods, snapshot)
        want = JaxBackend().schedule(jpods, jsnap)
    finally:
        flight.uninstall()
        jax_flight.uninstall()
    assert placement_hash(got) == jax_placement_hash(want)
    assert np.all(np.asarray([p.node_name for p in got]) != "")
