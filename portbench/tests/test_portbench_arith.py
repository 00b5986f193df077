"""The arithmetic of the metrics: the 95th percentile over every sample,
the rate over the window, and the readers over spans and a profile."""

import numpy as np
import pytest

from portbench import run, trace


@pytest.mark.parametrize("n", [1, 2, 7, 100, 333])
def test_percentile_is_numpys(n):
    rng = np.random.default_rng(n)
    values = list(rng.exponential(30.0, size=n))
    assert run.percentile(values, 95) == pytest.approx(
        float(np.percentile(values, 95)), rel=1e-12)


def _readings(**kw):
    spans = [
        {"name": "stream_commit", "ph": "X", "dur": 800.0},
        {"name": "statics_commit", "ph": "X", "dur": 200.0},
        {"name": "device_dispatch", "ph": "X", "dur": 30000.0,
         "args": {"pods": 64, "device_us": 25600.0}},
        {"name": "decode_placements", "ph": "X", "dur": 2000.0},
    ] * 2
    r = run.Readings(spans=spans, cycles=2, cycle_walls_s=[0.035, 0.037],
                     restages={"cold_start": 0}, **kw)
    return r


def test_span_readers():
    r = _readings(step_bytes=1_000_000,
                  peak={"hbm_bytes_per_s": 3.35e12})
    read = lambda name: run.load_reader(name)(r)  # noqa: E731
    assert read("scan_us_per_pod") == pytest.approx(400.0)
    assert read("commit_ms") == pytest.approx(1.0)
    assert read("decode_ms") == pytest.approx(2.0)
    # 36 ms a cycle less 1 + 30 + 2 ms of spans
    assert read("host_ms") == pytest.approx(3.0)
    assert read("restages") == 0.0
    least = 1e6 / 3.35e12
    assert read("scan_step_roofline") == pytest.approx(
        100 * least / 400e-6)


def test_readers_return_nothing_without_their_source():
    r = run.Readings()
    for name in ("scan_us_per_pod", "scan_step_roofline", "device_idle_pct",
                 "commit_ms", "decode_ms", "host_ms", "restages"):
        assert run.load_reader(name)(r) is None, name


def test_profile_union_and_idle_gaps():
    events = [
        {"name": "cpu_op", "ph": "X", "cat": "cpu_op", "ts": 0.0,
         "dur": 500.0},
        {"name": "marker<float>", "ph": "X", "cat": "kernel", "ts": 0.0,
         "dur": 1.0},
        {"name": "k1<long>", "ph": "X", "cat": "kernel", "ts": 5.0,
         "dur": 10.0},
        {"name": "k2", "ph": "X", "cat": "kernel", "ts": 12.0, "dur": 8.0},
        {"name": "Memcpy HtoD", "ph": "X", "cat": "gpu_memcpy", "ts": 40.0,
         "dur": 10.0},
        {"name": "k1<long>", "ph": "X", "cat": "kernel", "ts": 55.0,
         "dur": 5.0},
        {"name": "marker<float>", "ph": "X", "cat": "kernel", "ts": 99.0,
         "dur": 1.0},
    ]
    p = trace.read_profile(events)
    # busy [0, 1] + [5, 20] + [40, 50] + [55, 60] + [99, 100] of [0, 100]
    assert p["busy_s"] == pytest.approx(32e-6)
    assert p["window_s"] == pytest.approx(100e-6)
    assert p["device_ops"][0] == ["k1<long>", pytest.approx(15e-6)]
    idle = dict(p["idle_gaps"])
    # gaps of 4 and 5 µs wait on the next kernel of a run, 20 µs on the
    # copy, 39 µs on the marker
    assert idle["between kernels (gap < 10 us)"] == pytest.approx(9e-6)
    assert idle["host, before Memcpy HtoD"] == pytest.approx(20e-6)
    assert idle["host, before marker"] == pytest.approx(39e-6)
    assert p["kernels"] == 5
    r = run.Readings(profile=p)
    assert run.load_reader("device_idle_pct")(r) == pytest.approx(68.0)


def test_profile_without_device_work_reads_nothing():
    events = [{"name": "cpu_op", "ph": "X", "cat": "cpu_op", "ts": 0.0,
               "dur": 10.0}]
    assert trace.read_profile(events) is None
