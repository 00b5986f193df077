"""The port's metrics registry (tpusim_torch.framework.metrics) against the
JAX package's, after tests/test_metrics.py: every case feeds the same
observations to both registries and holds their exposition text equal, byte
for byte, besides the case's own checks (metric names of metrics.go:29-113,
ExponentialBuckets(1000, 2, 15), the exposition format, label escaping, the
snapshot shape, the metrics lint) and the observation seams of the port's
host orchestrator.
"""

import re
import sys
import threading

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.framework import metrics as jax_metrics
from tpusim.simulator import run_simulation as jax_run_simulation

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.framework import metrics as port_metrics
from tpusim_torch.simulator import run_simulation

MODULES = {"jax": jax_metrics, "port": port_metrics}


def both(feed):
    """Feed the same observations to a fresh registry of each package and
    return the port's, once their expositions are equal."""
    regs = {k: m.SchedulerMetrics() for k, m in MODULES.items()}
    for k, reg in regs.items():
        feed(reg, MODULES[k])
    assert regs["port"].expose() == regs["jax"].expose()
    return regs["port"]


@pytest.fixture(autouse=True)
def _fresh_default_registries():
    jax_metrics.register().reset()
    port_metrics.register().reset()
    yield
    jax_metrics.register().reset()
    port_metrics.register().reset()


class TestPrimitives:
    def test_exponential_buckets(self):
        assert port_metrics.exponential_buckets(1000, 2, 4) == \
            [1000, 2000, 4000, 8000]
        assert port_metrics.exponential_buckets(1000, 2, 15) == \
            jax_metrics.exponential_buckets(1000, 2, 15)

    def test_histogram_observe_and_expose(self):
        def feed(m, _mod):
            m.binding_latency.observe(1500)   # falls into le=2000 and above
            m.binding_latency.observe(500)    # falls into every bucket

        m = both(feed)
        assert m.binding_latency.count == 2
        text = m.expose()
        assert ('scheduler_binding_latency_microseconds_bucket{le="1000"} 1'
                in text)
        assert ('scheduler_binding_latency_microseconds_bucket{le="2000"} 2'
                in text)
        assert "scheduler_binding_latency_microseconds_count 2" in text

    def test_counter_and_gauge(self):
        def feed(m, _mod):
            m.preemption_attempts.inc()
            m.preemption_attempts.inc()
            m.preemption_victims.set(3)

        text = both(feed).expose()
        assert "scheduler_total_preemption_attempts 2" in text
        assert "scheduler_pod_preemption_victims 3" in text

    def test_metric_names_match_reference(self):
        text = both(lambda m, _mod: None).expose()
        for name in [
            "scheduler_e2e_scheduling_latency_microseconds",
            "scheduler_scheduling_algorithm_latency_microseconds",
            "scheduler_scheduling_algorithm_predicate_evaluation",
            "scheduler_scheduling_algorithm_priority_evaluation",
            "scheduler_scheduling_algorithm_preemption_evaluation",
            "scheduler_binding_latency_microseconds",
            "scheduler_pod_preemption_victims",
            "scheduler_total_preemption_attempts",
        ]:
            assert f"# TYPE {name} " in text


def _counts(reg):
    """The registry's snapshot with the walltime sums dropped: what two
    runs of the same workload must agree on."""
    out = {}
    for name, value in reg.snapshot().items():
        if isinstance(value, dict) and "count" in value:
            out[name] = value["count"]
        elif isinstance(value, dict) and value and all(
                isinstance(v, dict) for v in value.values()):
            out[name] = {k: v["count"] for k, v in value.items()}
        else:
            out[name] = value
    return out


class TestObservationSeams:
    def test_simulation_observes_phases(self):
        for api, run in ((jax_api, jax_run_simulation),
                         (port_api, run_simulation)):
            nodes = [api.make_node(f"n{i}", milli_cpu=4000, memory=2**33)
                     for i in range(3)]
            pods = [api.make_pod(f"p{i}", milli_cpu=100, memory=1)
                    for i in range(4)]
            run(pods, api.ClusterSnapshot(nodes=nodes), backend="reference")
        m = port_metrics.register()
        assert m.scheduling_algorithm_latency.count == 4
        assert m.predicate_evaluation.count == 4
        assert m.priority_evaluation.count == 4
        assert m.binding_latency.count == 4
        assert m.e2e_scheduling_latency.count == 4
        assert (m.e2e_scheduling_latency.total
                >= m.scheduling_algorithm_latency.total)
        assert _counts(m) == _counts(jax_metrics.register())

    def test_preemption_metrics(self):
        for api, run in ((jax_api, jax_run_simulation),
                         (port_api, run_simulation)):
            node = api.make_node("n0", milli_cpu=1000, memory=2**30)
            victim = api.make_pod("victim", milli_cpu=900, memory=1,
                                  node_name="n0", phase="Running")
            victim.spec.priority = 0
            contender = api.make_pod("contender", milli_cpu=900, memory=1)
            contender.spec.priority = 100
            run([contender], api.ClusterSnapshot(nodes=[node],
                                                 pods=[victim]),
                backend="reference", enable_pod_priority=True)
        m = port_metrics.register()
        assert m.preemption_attempts.value >= 1
        assert m.preemption_evaluation.count >= 1
        assert m.preemption_victims.value == 1
        assert _counts(m) == _counts(jax_metrics.register())


# Prometheus text exposition format: HELP/TYPE comment lines, then samples
# `name{label="value"} number`.
_PROM_LINE = re.compile(
    r"^(?:"
    r"# HELP [a-zA-Z_:][a-zA-Z0-9_:]* \S.*"
    r"|# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (?:counter|gauge|histogram|summary|untyped)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(?:\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\\\n]*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\\n]*")*\})?'
    r" (?:[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|[-+]?Inf|NaN)"
    r")$"
)


class TestExposition:
    def test_gauge_set_is_locked(self):
        g = port_metrics.Gauge("g", "h")
        threads = [threading.Thread(target=lambda v=v: [g.set(v)
                                                        for _ in range(200)])
                   for v in (1.0, 2.0, 3.0, 4.0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert g.value in (1.0, 2.0, 3.0, 4.0)

    def test_expose_registration_order(self):
        m = both(lambda m, _mod: None)
        typed = [line.split()[2] for line in m.expose().splitlines()
                 if line.startswith("# TYPE ")]
        assert typed == [metric.name for metric in m._all()]
        assert typed == [metric.name for metric
                         in jax_metrics.SchedulerMetrics()._all()]
        assert typed.index("scheduler_binding_latency_microseconds") \
            < typed.index("tpusim_backend_compile_latency_microseconds")

    def test_expose_golden_text_format(self):
        def feed(m, _mod):
            m.binding_latency.observe(1500)
            m.preemption_victims.set(2)
            m.preemption_attempts.inc()
            m.backend_route.inc("fastscan", 3)
            m.backend_auto_transitions.inc("verify_pass")

        text = both(feed).expose()
        assert text.endswith("\n")
        assert not text.endswith("\n\n")
        for line in text.splitlines():
            assert _PROM_LINE.match(line), \
                f"malformed exposition line: {line!r}"
        assert 'tpusim_backend_route_total{route="fastscan"} 3' in text
        assert ('tpusim_backend_auto_transitions_total'
                '{transition="verify_pass"} 1') in text

    def test_labeled_counter(self):
        lines = {}
        for k, mod in MODULES.items():
            c = mod.LabeledCounter("x_total", "help", "route")
            c.inc("b")
            c.inc("a", 2)
            c.inc("b")
            assert c.get("a") == 2
            assert c.get("b") == 2
            assert c.get("missing") == 0
            lines[k] = c.expose()
            assert lines[k][2:] == ['x_total{route="a"} 2',
                                    'x_total{route="b"} 2']
            c.reset()
            assert c.get("a") == 0
            assert c.expose() == ["# HELP x_total help",
                                  "# TYPE x_total counter"]
        assert lines["port"] == lines["jax"]

    def test_snapshot_shape(self):
        snaps = {}
        for k, mod in MODULES.items():
            m = mod.SchedulerMetrics()
            assert m.snapshot() == {}
            m.binding_latency.observe(1500)
            m.backend_route.inc("xla_scan")
            m.preemption_attempts.inc()
            snaps[k] = m.snapshot()
        snap = snaps["port"]
        assert snap == snaps["jax"]
        assert snap["scheduler_binding_latency_microseconds"] == {
            "count": 1, "sum": 1500}
        assert snap["tpusim_backend_route_total"] == {"xla_scan": 1.0}
        assert snap["scheduler_total_preemption_attempts"] == 1.0
        assert "scheduler_pod_preemption_victims" not in snap


def _populate(m, _mod=None):
    m.binding_latency.observe(1500)
    m.backend_route.inc("xla_scan", 2)
    m.stream_cycle_latency.observe("stream_scan", 900)
    m.slo_cycles.inc("ok")
    m.slo_burn_rate.set(0.25)
    m.stream_chain_head.set_info(head="abc123", cycle="7")
    m.obs_dropped_events.inc("host", 3)


class TestExpositionConformance:
    def test_every_family_has_help_and_type(self):
        m = both(_populate)
        text = m.expose()
        for metric in m._all():
            assert f"# HELP {metric.name} " in text, metric.name
            assert f"# TYPE {metric.name} " in text, metric.name

    def test_no_duplicate_families(self):
        m = both(lambda m, _mod: None)
        names = [metric.name for metric in m._all()]
        assert len(names) == len(set(names))
        typed = [line.split()[2] for line in m.expose().splitlines()
                 if line.startswith("# TYPE ")]
        assert len(typed) == len(set(typed))

    def test_histograms_emit_cumulative_inf_bucket(self):
        m = both(_populate)
        text = m.expose()
        assert ('scheduler_binding_latency_microseconds_bucket'
                '{le="+Inf"} 1') in text
        assert "scheduler_binding_latency_microseconds_count 1" in text
        assert ('tpusim_stream_cycle_latency_us_bucket'
                '{path="stream_scan",le="+Inf"} 1') in text
        h = m.binding_latency
        assert h.bucket_counts == sorted(h.bucket_counts)

    def test_label_value_escaping(self):
        esc = port_metrics.escape_label_value
        assert esc('a"b') == 'a\\"b'
        assert esc("a\\b") == "a\\\\b"
        assert esc("a\nb") == "a\\nb"
        samples = {}
        for k, mod in MODULES.items():
            c = mod.LabeledCounter("x_total", "h", "reason")
            c.inc('quo"te\nnl\\bs')
            samples[k] = c.expose()[2]
        assert samples["port"] == samples["jax"] == \
            'x_total{reason="quo\\"te\\nnl\\\\bs"} 1'
        assert "\n" not in samples["port"]

    def test_snapshot_matches_expose_values(self):
        m = both(_populate)
        text = m.expose()
        snap = m.snapshot()
        jm = jax_metrics.SchedulerMetrics()
        _populate(jm)
        assert snap == jm.snapshot()
        for name, value in snap.items():
            if isinstance(value, dict) and "count" in value:
                assert f"{name}_count {value['count']}" in text
            elif isinstance(value, dict):
                for label, child in value.items():
                    if isinstance(child, dict):  # labeled histogram
                        assert (f'{name}_count{{'
                                in text and f"}} {child['count']}" in text)
                    elif isinstance(child, str):  # info gauge labels
                        assert f'{label}="{child}"' in text
                    else:  # labeled counter
                        assert f'"{label}"}} {child:g}' in text
            else:
                assert f"{name} {value:g}" in text

    def test_info_gauge(self):
        lines = {}
        for k, mod in MODULES.items():
            g = mod.InfoGauge("y_info", "h")
            assert g.expose() == ["# HELP y_info h", "# TYPE y_info gauge"]
            g.set_info(head="aa", cycle="3")
            assert g.expose()[2] == 'y_info{cycle="3",head="aa"} 1'
            g.set_info(head="bb", cycle="4")  # replaces, never accumulates
            lines[k] = g.expose()
        assert lines["port"] == lines["jax"]
        assert len(lines["port"]) == 3
        assert lines["port"][2] == 'y_info{cycle="4",head="bb"} 1'

    def test_metrics_lint_clean(self, monkeypatch):
        """tools/metrics_lint.py over the port's registry: the lint reads
        the metric classes from the module it imports, so the port's module
        stands in for it while the lint runs."""
        import importlib.util
        import os

        spec = importlib.util.spec_from_file_location(
            "metrics_lint", os.path.join(os.path.dirname(__file__),
                                         os.pardir, "tools",
                                         "metrics_lint.py"))
        lint = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(lint)
        monkeypatch.setitem(sys.modules, "tpusim.framework.metrics",
                            port_metrics)
        assert lint.lint_registry(port_metrics.SchedulerMetrics()) == []
        bad = port_metrics.SchedulerMetrics()
        bad._reg(port_metrics.Gauge("tpusim_bad_total",
                                    "gauge posing as a counter"))
        assert lint.lint_registry(bad)


class TestFlightRecorderRing:
    def test_ring_bounds_events_and_counts_drops(self):
        from tpusim_torch.obs.recorder import FlightRecorder

        rec = FlightRecorder(max_events=4)
        for i in range(10):
            rec.instant(f"e{i}", "host")
        assert len(rec.events) == 4
        assert rec.dropped == 6
        assert rec.dropped_by_category == {"host": 6}
        assert [e["name"] for e in rec.events] == ["e6", "e7", "e8", "e9"]
        assert port_metrics.register().obs_dropped_events.get("host") == 6

    def test_default_capacity_is_large(self):
        from tpusim.obs.recorder import FlightRecorder as JaxRecorder

        from tpusim_torch.obs.recorder import FlightRecorder

        rec = FlightRecorder()
        assert rec.max_events == FlightRecorder.DEFAULT_MAX_EVENTS \
            == JaxRecorder.DEFAULT_MAX_EVENTS
        rec.instant("e", "host")
        assert rec.dropped == 0
