"""The readers of the twin's host spans and of the kernel count, and the
profiled stretch on the recorder's clock (portbench/align.py), on fixed
readings and synthetic profiler events."""

import pytest

from portbench import align, run, trace


def _cycle(pods=64):
    """One steady cycle's spans, in the order the recorder ends them (µs)."""
    return [
        {"name": "stream_ingest", "ph": "X", "dur": 300.0,
         "args": {"events": 64}},
        {"name": "stream_route", "ph": "X", "dur": 900.0,
         "args": {"pods": pods}},
        {"name": "commit_gather", "ph": "X", "dur": 250.0,
         "args": {"rows": 120}},
        {"name": "stream_commit", "ph": "X", "dur": 800.0},
        {"name": "stream_pack", "ph": "X", "dur": 600.0,
         "args": {"pods": pods}},
        {"name": "device_dispatch", "ph": "X", "dur": 26000.0,
         "args": {"pods": pods, "device_us": 25600.0}},
        {"name": "decode_placements", "ph": "X", "dur": 4000.0},
        {"name": "stream_foldback", "ph": "X", "dur": 1200.0,
         "args": {"bound": pods}},
    ]


def test_host_span_readers():
    r = run.Readings(spans=_cycle() * 2, cycles=2,
                     cycle_walls_s=[0.0345, 0.0345])
    read = lambda name: run.load_reader(name)(r)  # noqa: E731
    assert read("ingest_ms") == pytest.approx(0.3)
    assert read("batch_ms") == pytest.approx(1.5)
    assert read("commit_host_ms") == pytest.approx(0.25)
    assert read("foldback_ms") == pytest.approx(1.2)
    # 34.5 ms a cycle less 0.8 + 26 + 4 ms of commit, dispatch and decode:
    # the four host spans and 0.45 ms outside every span
    assert read("host_ms") == pytest.approx(3.7)
    assert read("commit_ms") == pytest.approx(0.8)


def test_kernels_per_pod_counts_the_profiled_cycles():
    # cycles 0-3 decide 8 pods each, 4-9 (the profiled stretch) 64, the
    # last one 16
    spans = sum((_cycle(8) for _ in range(4)), []) \
        + _cycle() * 6 + _cycle(16)
    r = run.Readings(spans=spans, cycles=11,
                     profile={"kernels": 87_614, "busy_s": 0.1,
                              "window_s": 0.2})
    assert run.load_reader("scan_kernels_per_pod")(r) == pytest.approx(
        87_614 / 384)
    # a window that ends inside the stretch: its cycles alone
    r.cycles = 7
    r.spans = spans[:8 * 7]
    assert run.load_reader("scan_kernels_per_pod")(r) == pytest.approx(
        87_614 / 192)


def test_new_readers_read_nothing_without_their_spans():
    """The parent's program records none of the spans: its traced run's
    line leaves these metrics out."""
    old = [ev for ev in _cycle() * 12 if ev["name"] in (
        "stream_commit", "device_dispatch", "decode_placements")]
    for r in (run.Readings(),
              run.Readings(spans=old, cycles=12, cycle_walls_s=[0.03] * 12,
                           profile={"kernels": 1000, "busy_s": 0.1,
                                    "window_s": 0.2})):
        for name in ("ingest_ms", "batch_ms", "commit_host_ms",
                     "foldback_ms", "scan_kernels_per_pod"):
            assert run.load_reader(name)(r) is None, name


# -- the aligned stretch ----------------------------------------------------

T0 = 1_760_000_000_000_000.0   # the profiler's clock: absolute µs


def _dev(name, ts, dur, cat="kernel", corr=None):
    ev = {"name": name, "ph": "X", "cat": cat, "ts": T0 + ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(name, ts, corr):
    return {"name": name, "ph": "X", "cat": "cuda_runtime", "ts": T0 + ts,
            "dur": 3.0, "args": {"correlation": corr}}


# a clock sync's warm fill at 0 and its two read fills at 5 and 8, a run of
# kernels, a 100 µs gap, a copy, a 7 µs gap, a kernel, a 120 µs gap, the
# closing clock sync's fills at 300, 340, 370 and 400
EVENTS = [
    _dev("fill<float>", 0.0, 2.0, corr=1),
    _dev("fill<float>", 5.0, 1.0, corr=2),
    _dev("fill<float>", 8.0, 1.0, corr=3),
    _dev("k1<long>", 10.0, 20.0, corr=4),
    _dev("k2", 35.0, 15.0, corr=5),
    _dev("Memcpy HtoD (Pageable -> Device)", 150.0, 10.0, "gpu_memcpy", 6),
    _dev("k3", 167.0, 13.0, corr=7),
    _dev("fill<float>", 300.0, 1.0, corr=8),
    _dev("fill<float>", 340.0, 1.0, corr=9),
    _dev("fill<float>", 370.0, 1.0, corr=10),
    _dev("fill<float>", 400.0, 1.0, corr=11),
    _launch("cudaLaunchKernel", 5.0, 4),
    _launch("cudaGraphLaunch", 31.0, 5),
    _launch("cudaMemcpyAsync", 120.0, 6),
    _launch("cudaGraphLaunch", 162.0, 7),
]
ANCHOR = 5_000.0
# the readings before the two read fills: the second launch was the faster
# (its latency is taken for none), so recorder time is profiler time +
# (ANCHOR - T0)
READINGS = [ANCHOR + 5.0 - 9.0, ANCHOR + 8.0]
END_READINGS = [ANCHOR + 330.0, ANCHOR + 358.0, ANCHOR + 395.0]


def _span(name, start, end, **args):
    """A recorder span from profiler offsets."""
    ev = {"name": name, "ph": "X", "ts": ANCHOR + start, "dur": end - start}
    if args:
        ev["args"] = args
    return ev


SPANS = [
    _span("stream_route", 52.0, 90.0, pods=64),
    _span("device_dispatch", 95.0, 200.0, pods=64),
    _span("shard:scan", 100.0, 140.0),
    _span("stream_foldback", 260.0, 300.0, bound=64),
]


def test_offset_from_the_fastest_fill():
    assert align.offset_us(EVENTS, READINGS) == ANCHOR - T0
    assert align.offset_us(EVENTS, list(reversed(READINGS))) == \
        ANCHOR - T0 + 3.0
    assert align.offset_us(EVENTS[:2], READINGS) is None
    assert align.offset_us([], READINGS) is None


def test_gaps_split_at_the_spans_and_the_total_kept():
    off = align.offset_us(EVENTS, READINGS)
    got = align.split_gaps(EVENTS, SPANS, off)
    old = trace.read_profile(EVENTS)
    assert got["busy_s"] == old["busy_s"]
    assert got["window_s"] == old["window_s"]
    # the idle total is read_profile's to the µs
    assert got["idle_s"] == pytest.approx(old["window_s"] - old["busy_s"],
                                          abs=1e-12)
    gaps = dict(got["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(got["idle_s"], abs=1e-12)
    # 50-150: 52-90 in stream_route, 95-100 and 140-150 in device_dispatch,
    # 100-140 in its inner shard:scan, 50-52 and 90-95 in no span
    assert gaps["in stream_route"] == pytest.approx(38e-6)
    assert gaps["in shard:scan"] == pytest.approx(40e-6)
    # 180-300: 180-200 in device_dispatch, 260-300 in stream_foldback,
    # 200-260 in no span; then 301-340, 341-370 and 371-400 in none
    assert gaps["in device_dispatch"] == pytest.approx(35e-6)
    assert gaps["in stream_foldback"] == pytest.approx(40e-6)
    assert gaps["host, before Memcpy HtoD (Pageable -> Device)"] == \
        pytest.approx(7e-6)
    assert gaps["host, before fill"] == pytest.approx(157e-6)
    # 2-5, 6-8, 9-10, 30-35 and 160-167 are launch latencies
    assert gaps["between kernels (gap < 10 us)"] == pytest.approx(18e-6)
    # each span's wall inside the stretch, 0-401
    assert dict(got["span_walls"]) == pytest.approx({
        "stream_route": 38e-6, "device_dispatch": 105e-6,
        "shard:scan": 40e-6, "stream_foldback": 40e-6})
    old_gaps = dict(old["idle_gaps"])
    assert old_gaps["host, before Memcpy HtoD (Pageable -> Device)"] == \
        pytest.approx(100e-6)


def test_no_span_keeps_the_old_labels():
    off = align.offset_us(EVENTS, READINGS)
    got = align.split_gaps(EVENTS, [], off)
    old = trace.read_profile(EVENTS)
    assert sorted(got["idle_gaps"]) == sorted(old["idle_gaps"])


def test_kernels_by_their_launch_and_by_their_start():
    off = align.offset_us(EVENTS, READINGS)
    got = align.dispatch_kernels(EVENTS, SPANS, off)
    # the graph launched at 162, inside device_dispatch: k3 alone; the copy
    # is no kernel, k2's launch at 31 is outside every span
    assert got == {"kernels": 1, "pods": 64, "spans": 1,
                   "attributed_by": "launch", "kernels_in_stretch": 10,
                   "wall_us": 105.0, "device_us": 0.0}
    no_runtime = [ev for ev in EVENTS if ev["cat"] != "cuda_runtime"]
    got = align.dispatch_kernels(no_runtime, SPANS, off)
    assert got["attributed_by"] == "start" and got["kernels"] == 1
    assert align.dispatch_kernels(EVENTS, SPANS[:1], off) is None


def test_drift_at_the_closing_sync():
    off = align.offset_us(EVENTS, READINGS)
    # the closing sync's fills started 10, 12 and 5 µs after their readings
    assert align.drift_us(EVENTS, off, END_READINGS) == pytest.approx(10.0)
    # a fill the profiler lost moves its reading alone
    lost = [ev for ev in EVENTS if ev["ts"] != T0 + 400.0]
    assert align.drift_us(lost, off, END_READINGS) == pytest.approx(10.0)
    # clocks 2 ms apart by the far end
    assert align.drift_us(EVENTS, off - 2000.0, END_READINGS) == \
        pytest.approx(-1958.0)
    assert align.drift_us([], off, END_READINGS) is None
