"""The recorder's clock and the profiler's on the card (skips without one):
five fills, each launched after a span around 2 ms of host work, start on
the recorder's clock after their span's end, the soonest within 100 µs of
it, and a second clock sync reads the first's offset to within 50 µs.

The host spins: a thread that sleeps wakes late, and its next launch
starts some 150 µs after it asked (an H100 host under the profiler). A
single launch after a span can still start 100-200 µs after it when the
shared host holds the thread up, so the bound is on the soonest of five;
a fault of the alignment moves all five alike.
"""

import time

import pytest

from portbench import align

SPANS = 5


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _spin(seconds):
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


@pytest.mark.cuda
def test_a_kernel_after_a_span_lands_after_it(card):
    import torch

    from portbench.run import _profile_events
    from tpusim_torch.obs import recorder

    rec = recorder.FlightRecorder()
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    # the profiler's first session loads CUPTI, and the recorder's first
    # span its trace contexts: both before the session that is read
    with torch.profiler.profile(activities=cuda):
        with rec.span("warm"):
            rec.sync_device_clock("cuda")
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=cuda) as prof:
        marker = rec.sync_device_clock("cuda")
        for i in range(SPANS):
            with rec.span("host_work"):
                _spin(0.002)
            marker.fill_(-1.0 - i)
            _spin(0.001)
        rec.sync_device_clock("cuda", align.END)
        torch.cuda.synchronize()
    events = _profile_events(prof)
    off = align.offset_us(events, rec.anchors[align.ANCHOR])
    ends = [ev["ts"] + ev["dur"] for ev in rec.events
            if ev["name"] == "host_work"]
    n = 1 + recorder.CLOCK_FILLS
    kernels = sorted(float(ev["ts"]) + off for ev in events
                     if ev.get("cat") == "kernel")
    assert len(kernels) == 2 * n + SPANS
    late = [k - end for k, end in zip(kernels[n:n + SPANS], ends)]
    assert min(late) >= 0.0 and min(late) <= 100.0, late
    assert abs(align.drift_us(events, off, rec.anchors[align.END])) < 50.0
