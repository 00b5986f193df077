"""Scheduler metrics: per-phase latency histograms and preemption counters.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/metrics/metrics.go:25-113 —
Prometheus histograms with ExponentialBuckets(1000, 2, 15) (microseconds,
smallest bucket 1ms) under the "scheduler" subsystem, observed at
scheduler.go:425,452-457,492 and core/generic_scheduler.go:148,154,163. The
reference registers these but never serves them; here the registry is
in-process and dumps in Prometheus text exposition format for the same
scrape shape.

The port keeps the JAX package's registry family for family: the same
names, help texts, label names and registration order, so one exposition
reads the same from either package. Families whose modules the port does
not carry yet (replication, tenancy) stay registered and unobserved, which
is what the JAX package exposes while those modules sit idle. On the card the whole filter, score, select and bind step is one
fused kernel, so the torch backend observes per-batch dispatch walltime
into the algorithm histograms rather than per-phase host time.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

SCHEDULER_SUBSYSTEM = "scheduler"


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    """prometheus.ExponentialBuckets."""
    return [start * factor**i for i in range(count)]


def escape_label_value(value: str) -> str:
    """Prometheus text-exposition label-value escaping (exposition format
    spec): backslash, double-quote, and line-feed must be escaped or a
    scraper mis-parses the sample line."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Histogram:
    def __init__(self, name: str, help_text: str, buckets: List[float]):
        self.name = name
        self.help = help_text
        self.buckets = sorted(buckets)
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.total = 0.0
        # OpenMetrics exemplar: the last (trace_id, value) observed with a
        # trace attached; None until a traced observation lands, so default
        # expositions are byte-identical to the pre-exemplar format
        self.exemplar: Optional[tuple] = None
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.bucket_counts[i] += 1
            if exemplar is not None:
                self.exemplar = (exemplar, value)

    def reset(self) -> None:
        with self._lock:
            self.bucket_counts = [0] * len(self.buckets)
            self.count = 0
            self.total = 0.0
            self.exemplar = None

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        # bucket_counts are already cumulative (observe() increments every
        # bucket whose bound covers the value)
        for bound, bucket_count in zip(self.buckets, self.bucket_counts):
            lines.append(f'{self.name}_bucket{{le="{bound:g}"}} {bucket_count}')
        inf = f'{self.name}_bucket{{le="+Inf"}} {self.count}'
        if self.exemplar is not None:
            trace_id, value = self.exemplar
            inf += (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
                    f'{value:g}')
        lines.append(inf)
        lines.append(f"{self.name}_sum {self.total:g}")
        lines.append(f"{self.name}_count {self.count}")
        return lines


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0

    def expose(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} counter",
                f"{self.name} {self.value:g}"]


class Gauge:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0

    def expose(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {self.value:g}"]


class LabeledCounter:
    """A counter family with one label dimension (prometheus CounterVec).

    Used by the `tpusim_backend_*` families where the interesting fact is
    *which* path/transition fired, not just how often anything did.
    """

    def __init__(self, name: str, help_text: str, label: str):
        self.name = name
        self.help = help_text
        self.label = label
        self.values: Dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, label_value: str, amount: float = 1.0) -> None:
        with self._lock:
            self.values[label_value] = self.values.get(label_value, 0.0) + amount

    def get(self, label_value: str) -> float:
        with self._lock:
            return self.values.get(label_value, 0.0)

    def reset(self) -> None:
        with self._lock:
            self.values.clear()

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self.values.items())
        for label_value, value in items:
            lines.append(f'{self.name}{{{self.label}='
                         f'"{escape_label_value(label_value)}"}} {value:g}')
        return lines


class LabeledHistogram:
    """A histogram family with one label dimension (prometheus
    HistogramVec). Child histograms are created lazily on first observe —
    the stream runtime's per-path cycle latency is the first user."""

    def __init__(self, name: str, help_text: str, label: str,
                 buckets: List[float]):
        self.name = name
        self.help = help_text
        self.label = label
        self.buckets = sorted(buckets)
        self.children: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def observe(self, label_value: str, value: float,
                exemplar: Optional[str] = None) -> None:
        with self._lock:
            child = self.children.get(label_value)
            if child is None:
                child = Histogram(
                    f'{self.name}{{{self.label}="{label_value}"}}',
                    self.help, self.buckets)
                self.children[label_value] = child
        child.observe(value, exemplar)

    def get(self, label_value: str) -> Optional[Histogram]:
        with self._lock:
            return self.children.get(label_value)

    def reset(self) -> None:
        with self._lock:
            self.children.clear()

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(self.children.items())
        for label_value, child in items:
            pair = f'{self.label}="{escape_label_value(label_value)}"'
            for bound, bucket_count in zip(child.buckets,
                                           child.bucket_counts):
                lines.append(f'{self.name}_bucket{{{pair},le="{bound:g}"}} '
                             f'{bucket_count}')
            inf = f'{self.name}_bucket{{{pair},le="+Inf"}} {child.count}'
            if child.exemplar is not None:
                trace_id, value = child.exemplar
                inf += (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
                        f'{value:g}')
            lines.append(inf)
            lines.append(f'{self.name}_sum{{{pair}}} {child.total:g}')
            lines.append(f'{self.name}_count{{{pair}}} {child.count}')
        return lines


class LabeledGauge:
    """A gauge family with one label dimension (prometheus GaugeVec).

    First users: the cluster analytics plane's per-resource
    utilization/fragmentation ratios and per-component device memory
    residency. The label must stay bounded: tools/metrics_lint.py enforces
    an allowlist of label names with finite value sets."""

    def __init__(self, name: str, help_text: str, label: str):
        self.name = name
        self.help = help_text
        self.label = label
        self.values: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, label_value: str, value: float) -> None:
        with self._lock:
            self.values[label_value] = value

    def get(self, label_value: str) -> float:
        with self._lock:
            return self.values.get(label_value, 0.0)

    def reset(self) -> None:
        with self._lock:
            self.values.clear()

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self.values.items())
        for label_value, value in items:
            lines.append(f'{self.name}{{{self.label}='
                         f'"{escape_label_value(label_value)}"}} {value:g}')
        return lines


class InfoGauge:
    """An info-style gauge (prometheus *_info convention): constant value 1
    with the interesting facts carried as label values. Setting it replaces
    the label set, so exactly one sample is exposed at a time — scrapes see
    the CURRENT chain head / build info, never a history."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.labels: Dict[str, str] = {}
        self.value = 0.0  # 1.0 once set; 0 families are skipped by snapshot
        self._lock = threading.Lock()

    def set_info(self, **labels: str) -> None:
        with self._lock:
            self.labels = {k: str(v) for k, v in labels.items()}
            self.value = 1.0

    def reset(self) -> None:
        with self._lock:
            self.labels = {}
            self.value = 0.0

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            if self.value:
                pairs = ",".join(
                    f'{k}="{escape_label_value(v)}"'
                    for k, v in sorted(self.labels.items()))
                lines.append(f"{self.name}{{{pairs}}} {self.value:g}")
        return lines


_LATENCY_BUCKETS = exponential_buckets(1000, 2, 15)


class SchedulerMetrics:
    """The metric set of metrics/metrics.go:29-91, names preserved, plus
    the `tpusim_backend_*` families for the device engine."""

    def __init__(self):
        s = SCHEDULER_SUBSYSTEM
        self._registry: List = []
        self.e2e_scheduling_latency = self._reg(Histogram(
            f"{s}_e2e_scheduling_latency_microseconds",
            "E2e scheduling latency (scheduling algorithm + binding)",
            _LATENCY_BUCKETS))
        self.scheduling_algorithm_latency = self._reg(Histogram(
            f"{s}_scheduling_algorithm_latency_microseconds",
            "Scheduling algorithm latency", _LATENCY_BUCKETS))
        self.predicate_evaluation = self._reg(Histogram(
            f"{s}_scheduling_algorithm_predicate_evaluation",
            "Scheduling algorithm predicate evaluation duration",
            _LATENCY_BUCKETS))
        self.priority_evaluation = self._reg(Histogram(
            f"{s}_scheduling_algorithm_priority_evaluation",
            "Scheduling algorithm priority evaluation duration",
            _LATENCY_BUCKETS))
        self.preemption_evaluation = self._reg(Histogram(
            f"{s}_scheduling_algorithm_preemption_evaluation",
            "Scheduling algorithm preemption evaluation duration",
            _LATENCY_BUCKETS))
        self.binding_latency = self._reg(Histogram(
            f"{s}_binding_latency_microseconds", "Binding latency",
            _LATENCY_BUCKETS))
        self.preemption_victims = self._reg(Gauge(
            f"{s}_pod_preemption_victims",
            "Number of selected preemption victims"))
        self.preemption_attempts = self._reg(Counter(
            f"{s}_total_preemption_attempts",
            "Total preemption attempts in the cluster till now"))
        # device-engine telemetry (no reference analog; new families)
        self.backend_compile_latency = self._reg(Histogram(
            "tpusim_backend_compile_latency_microseconds",
            "Jax backend cluster compile (interning + device tables) walltime",
            _LATENCY_BUCKETS))
        self.backend_dispatch_latency = self._reg(Histogram(
            "tpusim_backend_dispatch_latency_microseconds",
            "Jax backend device dispatch walltime per batch or chunk",
            _LATENCY_BUCKETS))
        self.backend_route = self._reg(LabeledCounter(
            "tpusim_backend_route_total",
            "Scheduling batches by execution route", "route"))
        self.backend_auto_transitions = self._reg(LabeledCounter(
            "tpusim_backend_auto_transitions_total",
            "Fast-path AUTO verify-then-trust state transitions",
            "transition"))
        self.backend_victim_path = self._reg(LabeledCounter(
            "tpusim_backend_victim_path_total",
            "Preemption victim-selection path per attempt", "path"))
        self.fast_fallback = self._reg(LabeledCounter(
            "tpusim_fast_fallback_total",
            "Pallas fast-path plan rejections by blocker class", "reason"))
        # node-sharded route telemetry: the TPUSIM_SHARDS mesh
        # shape, real (non-padding) nodes owned per shard, the estimated
        # cross-shard collective payload of the last sharded dispatch, and
        # batches the route declined, by blocker class
        self.shard_count = self._reg(Gauge(
            "tpusim_shard_count",
            "Node-mesh shards in the active sharded scan route (0 = off)"))
        self.shard_node_occupancy = self._reg(LabeledGauge(
            "tpusim_shard_node_occupancy",
            "Real (non-padding) nodes owned by each node-mesh shard",
            "shard"))
        self.shard_collective_bytes = self._reg(Gauge(
            "tpusim_shard_collective_bytes",
            "Estimated cross-shard collective payload of the last sharded "
            "dispatch"))
        self.shard_fallback = self._reg(LabeledCounter(
            "tpusim_shard_fallback_total",
            "TPUSIM_SHARDS batches the sharded route declined, by blocker "
            "class", "reason"))
        # chaos-engine telemetry: injected faults by kind, watch
        # buffer overflows by resource, and the dispatch circuit breaker
        self.fault_injected = self._reg(LabeledCounter(
            "tpusim_fault_injected_total",
            "Chaos faults injected, by fault kind", "kind"))
        self.watch_overflow = self._reg(LabeledCounter(
            "tpusim_watch_overflow_total",
            "Watch streams terminated on buffer overflow (410 Gone analog)",
            "resource"))
        self.breaker_transitions = self._reg(LabeledCounter(
            "tpusim_breaker_transitions_total",
            "Device-dispatch circuit breaker transitions", "transition"))
        self.breaker_state = self._reg(Gauge(
            "tpusim_breaker_state",
            "Device-dispatch breaker state (0 closed, 0.5 half-open, 1 open)"))
        # scenario-fleet serving telemetry: the what-if capacity
        # service — admission queue, shape-class buckets, dispatch cache
        self.serve_queue_depth = self._reg(Gauge(
            "tpusim_serve_queue_depth",
            "What-if requests admitted and waiting to be bucketed"))
        self.serve_batch_occupancy = self._reg(Histogram(
            "tpusim_serve_batch_occupancy",
            "Real (non-ghost) scenarios per dispatched bucket",
            [1, 2, 4, 8, 16, 32, 64]))
        self.serve_request_latency = self._reg(Histogram(
            "tpusim_serve_request_latency_microseconds",
            "Admission to decoded-result latency per what-if request",
            _LATENCY_BUCKETS))
        self.serve_rejected = self._reg(LabeledCounter(
            "tpusim_serve_rejected_total",
            "What-if requests rejected at admission, by reason", "reason"))
        self.serve_dispatch = self._reg(LabeledCounter(
            "tpusim_serve_dispatch_total",
            "Bucket dispatches by warm-executable-cache outcome", "path"))
        # streaming-runtime telemetry: the device-resident cluster
        # path — every residency miss routed through a full restage is
        # classified by cause, and cycles split by execution path so an
        # O(delta) steady state is visible as stream_scan dominating
        self.stream_restage = self._reg(LabeledCounter(
            "tpusim_stream_restage_total",
            "Stream-runtime full restages of device-resident state, by cause",
            "reason"))
        self.stream_cycles = self._reg(LabeledCounter(
            "tpusim_stream_cycles_total",
            "Stream-runtime scheduling cycles, by execution path", "path"))
        # stream v2 telemetry: per-path cycle latency plus the
        # pipelining health gauges — depth (0 sync, 1 one cycle in flight)
        # and the fraction of a cycle's host decode that overlapped device
        # execution instead of blocking on it
        self.stream_cycle_latency = self._reg(LabeledHistogram(
            "tpusim_stream_cycle_latency_us",
            "Stream-runtime cycle walltime by execution path",
            "path", _LATENCY_BUCKETS))
        self.stream_pipeline_depth = self._reg(Gauge(
            "tpusim_stream_pipeline_depth",
            "Cycles in flight on the stream pipeline (0 = synchronous)"))
        self.stream_overlap_fraction = self._reg(Gauge(
            "tpusim_stream_overlap_fraction",
            "Fraction of the last pipelined fold that did not block on the "
            "device (1.0 = decode fully hidden behind device execution)"))
        # crash-recovery telemetry: the WAL + checkpoint layer
        # for the device-resident twin, and the serve fleet's degraded
        # modes under chaos
        self.recovery_checkpoint_latency = self._reg(Histogram(
            "tpusim_recovery_checkpoint_latency_microseconds",
            "Host-snapshot checkpoint walltime (device_get + atomic write)",
            _LATENCY_BUCKETS))
        self.recovery_replay_latency = self._reg(Histogram(
            "tpusim_recovery_replay_latency_microseconds",
            "Crash-recovery walltime: checkpoint load + WAL tail replay",
            _LATENCY_BUCKETS))
        self.recovery_wal_records = self._reg(Gauge(
            "tpusim_recovery_wal_records",
            "Records in the stream write-ahead journal"))
        self.serve_retry = self._reg(LabeledCounter(
            "tpusim_serve_retry_total",
            "Serve-fleet dispatch retries, by fault reason", "reason"))
        self.serve_degraded = self._reg(LabeledCounter(
            "tpusim_serve_degraded_total",
            "Serve-fleet requests answered via a degraded path", "path"))
        # observability plane: bounded flight recorder, SLO
        # tracking against a configurable per-cycle latency target, and the
        # recovery chain head published for /healthz continuity checks
        self.obs_dropped_events = self._reg(LabeledCounter(
            "tpusim_obs_dropped_events_total",
            "Flight-recorder events dropped by the bounded ring buffer, "
            "by span category", "category"))
        # fleet-wide distributed tracing: cross-boundary flow
        # events and the bounded /debug/trace ring
        self.trace_flows = self._reg(LabeledCounter(
            "tpusim_trace_flows_total",
            "Cross-boundary trace flow starts (Chrome 's' phase) emitted, "
            "by boundary site", "site"))
        self.trace_ring_events = self._reg(Gauge(
            "tpusim_trace_ring_events",
            "Events currently held in the flight-recorder ring served by "
            "/debug/trace"))
        self.slo_target = self._reg(Gauge(
            "tpusim_slo_cycle_latency_target_microseconds",
            "Configured per-cycle latency SLO target (0 = no SLO armed)"))
        self.slo_cycles = self._reg(LabeledCounter(
            "tpusim_slo_cycles_total",
            "Scheduling cycles judged against the latency SLO target",
            "verdict"))
        self.slo_burn_rate = self._reg(Gauge(
            "tpusim_slo_burn_rate",
            "Windowed error-budget burn rate (breach fraction over the "
            "window divided by the SLO's error budget; 1.0 = burning "
            "exactly at budget)"))
        self.stream_chain_head = self._reg(InfoGauge(
            "tpusim_stream_chain_head_info",
            "Current placement-chain head of the stream WAL (labels: head, "
            "cycle) — proves WAL/chain continuity without reading the "
            "checkpoint dir"))
        self.recovery_last_checkpoint_timestamp = self._reg(Gauge(
            "tpusim_recovery_last_checkpoint_timestamp_seconds",
            "Unix time of the last completed stream checkpoint"))
        self.provenance_records = self._reg(Counter(
            "tpusim_provenance_records_total",
            "Decision-provenance records captured into the explanation ring"))
        # cluster analytics plane: fleet-level aggregates reduced
        # on-device from the resident twin, plus HBM residency and
        # compile-cost accounting — refreshed at scrape time by
        # the analytics plane's refresh_gauges()
        self.cluster_utilization = self._reg(LabeledGauge(
            "tpusim_cluster_utilization_ratio",
            "Requested / allocatable per resource across valid nodes "
            "(latest analytics sample)", "resource"))
        self.cluster_fragmentation = self._reg(LabeledGauge(
            "tpusim_cluster_fragmentation_ratio",
            "1 - largest-free-slot / total-free per resource (0 = all free "
            "capacity on one node, 1 = fully shredded)", "resource"))
        self.cluster_feasible_nodes = self._reg(Gauge(
            "tpusim_cluster_feasible_nodes",
            "Nodes with free cpu AND memory AND pod slots in the latest "
            "analytics sample"))
        self.cluster_nodes = self._reg(Gauge(
            "tpusim_cluster_nodes",
            "Valid nodes covered by the latest analytics sample"))
        self.analytics_samples = self._reg(Counter(
            "tpusim_analytics_samples_total",
            "On-device analytics reductions captured into the ring"))
        self.hbm_resident_bytes = self._reg(LabeledGauge(
            "tpusim_hbm_resident_bytes",
            "Bytes held resident per component (device twin, staged LRU, "
            "batched device trees)", "component"))
        self.hbm_cache_entries = self._reg(LabeledGauge(
            "tpusim_hbm_cache_entries",
            "Entries held per cache component (staged scenarios, device "
            "batches, compiled executables)", "component"))
        self.compile_traces = self._reg(LabeledCounter(
            "tpusim_compile_traces_total",
            "Cumulative compiles/retraces by observation site", "site"))
        self.compile_cost = self._reg(LabeledCounter(
            "tpusim_compile_cost_us_total",
            "Cumulative compile walltime by observation site", "site"))
        self.gang_admitted = self._reg(Counter(
            "tpusim_gang_admitted_total",
            "Pod groups admitted all-or-nothing (>= min-available placed)"))
        self.gang_rejected = self._reg(LabeledCounter(
            "tpusim_gang_rejected_total",
            "Pod groups rejected whole with one shared FitError", "reason"))
        self.gang_partial_rollback = self._reg(Counter(
            "tpusim_gang_partial_rollback_total",
            "Partially-bound gangs rolled back to zero members (commit "
            "failure, preemption release, or chaos node loss)"))
        self.gang_size = self._reg(Histogram(
            "tpusim_gang_size",
            "Members per admitted-or-rejected pod group",
            [1, 2, 4, 8, 16, 32, 64]))
        # replicated control plane: WAL shipping to a hot
        # standby, per-cycle chain cross-checks, and chaos-driven leader
        # failover with an end-to-end RTO
        self.replication_lag_records = self._reg(Gauge(
            "tpusim_replication_lag_records",
            "WAL records appended on the leader but not yet acked by the "
            "follower"))
        self.replication_lag_bytes = self._reg(Gauge(
            "tpusim_replication_lag_bytes",
            "WAL bytes durable on the leader but not yet acked by the "
            "follower"))
        self.replication_lag_seconds = self._reg(Gauge(
            "tpusim_replication_lag_seconds",
            "Age of the oldest unacked WAL record on the ship queue "
            "(0 = follower fully caught up)"))
        self.replication_last_shipped_seq = self._reg(Gauge(
            "tpusim_replication_last_shipped_seq",
            "Highest replication sequence number handed to the wire "
            "(-1 = nothing shipped yet)"))
        self.replication_ship_latency = self._reg(Histogram(
            "tpusim_replication_ship_latency_microseconds",
            "Append-to-ack walltime per shipped WAL record",
            _LATENCY_BUCKETS))
        self.replication_apply_latency = self._reg(Histogram(
            "tpusim_replication_apply_latency_microseconds",
            "Receive-to-applied walltime per record on the follower twin",
            _LATENCY_BUCKETS))
        self.replication_promotions = self._reg(Counter(
            "tpusim_replication_promotions_total",
            "Followers promoted to leader (successful failovers)"))
        self.replication_divergence = self._reg(Counter(
            "tpusim_replication_divergence_total",
            "Per-cycle placement-hash chain cross-check failures on a "
            "follower (any value > 0 latches promotion refusal)"))
        self.replication_rto_seconds = self._reg(Gauge(
            "tpusim_replication_rto_seconds",
            "End-to-end recovery time objective of the last failover: "
            "leader-death detection to promoted-and-serving"))
        self.replication_role = self._reg(InfoGauge(
            "tpusim_replication_role_info",
            "Replication role of this process (labels: role = "
            "leader|follower|candidate|none)"))
        # live-twin overlay queries: what-if scenarios answered
        # against the device-resident carry behind a journal mark, plus the
        # multi-tenant residency ledger that evicts cold twins to their
        # checkpoints under HBM pressure
        self.overlay_queries = self._reg(LabeledCounter(
            "tpusim_overlay_queries_total",
            "What-if queries answered by a resident twin overlay "
            "(path = resident|follower)", "path"))
        self.overlay_fallback = self._reg(LabeledCounter(
            "tpusim_overlay_fallback_total",
            "Overlay-ineligible what-if queries routed to the staged path, "
            "by refusal reason", "reason"))
        self.overlay_latency = self._reg(Histogram(
            "tpusim_overlay_latency_microseconds",
            "Route-to-rollback walltime per resident-twin overlay query",
            _LATENCY_BUCKETS))
        self.tenant_evictions = self._reg(LabeledCounter(
            "tpusim_tenant_evictions_total",
            "Tenant twins evicted to their checkpoint directory", "reason"))
        self.tenant_restores = self._reg(Counter(
            "tpusim_tenant_restores_total",
            "Tenant twins restored on demand from checkpoint + WAL tail"))
        self.tenant_resident_bytes = self._reg(LabeledGauge(
            "tpusim_tenant_resident_bytes",
            "HBM bytes held by each tenant's resident twin (0 = evicted)",
            "tenant"))
        self.tenant_restore_latency = self._reg(Histogram(
            "tpusim_tenant_restore_latency_microseconds",
            "Checkpoint-load + WAL-tail-replay walltime per tenant restore",
            _LATENCY_BUCKETS))
        self.tenant_resident_twins = self._reg(Gauge(
            "tpusim_tenant_resident_twins",
            "Tenant twins currently resident in HBM (admitted - evicted)"))
        # one lock for whole-registry reads: /metrics and snapshot() see a
        # single consistent exposition even while runtime threads observe
        self._read_lock = threading.Lock()

    def _reg(self, metric):
        self._registry.append(metric)
        return metric

    def _all(self):
        return list(self._registry)

    def reset(self) -> None:
        for metric in self._all():
            metric.reset()

    def expose(self) -> str:
        """Prometheus text exposition format (the scrape body the reference
        would have served had it started its metrics server). Families are
        emitted in registration order; the registry-level lock makes one
        scrape a consistent snapshot relative to another reader."""
        lines: List[str] = []
        with self._read_lock:
            for metric in self._all():
                lines.extend(metric.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """Compact JSON-able snapshot of every non-empty family; embedded
        in BENCH records so trajectory files say which path produced each
        number."""
        out: Dict[str, object] = {}
        with self._read_lock:
            for metric in self._all():
                if isinstance(metric, Histogram):
                    if metric.count:
                        out[metric.name] = {"count": metric.count,
                                            "sum": round(metric.total, 3)}
                elif isinstance(metric, LabeledHistogram):
                    if metric.children:
                        out[metric.name] = {
                            label: {"count": child.count,
                                    "sum": round(child.total, 3)}
                            for label, child in sorted(
                                metric.children.items())}
                elif isinstance(metric, (LabeledCounter, LabeledGauge)):
                    if metric.values:
                        out[metric.name] = dict(sorted(metric.values.items()))
                elif isinstance(metric, InfoGauge):
                    if metric.value:
                        out[metric.name] = dict(sorted(metric.labels.items()))
                else:
                    if metric.value:
                        out[metric.name] = metric.value
        return out


# module-level default registry, mirroring the Go package-level metrics +
# metrics.Register() sync.Once (metrics.go:95-109)
_default: Optional[SchedulerMetrics] = None
_default_lock = threading.Lock()


def register() -> SchedulerMetrics:
    global _default
    with _default_lock:
        if _default is None:
            _default = SchedulerMetrics()
        return _default


def since_in_microseconds(start: float) -> float:
    """metrics.go SinceInMicroseconds; start is a time.perf_counter() value."""
    return (time.perf_counter() - start) * 1e6
