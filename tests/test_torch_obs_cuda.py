"""The flight recorder's device spans on the card: a device_dispatch span of
TorchBackend.schedule carries its CUDA-event time, read when the trace is
exported and no longer than the span's wall; recording adds no
synchronize inside schedule (torch.cuda.synchronize and
torch.cuda.Event.synchronize counted with patched functions, the same with
the recorder as without it); and the placements are the same with the
recorder installed.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py

Without a card every case skips.
"""

import json

import pytest
import torch

from tpusim_torch import workloads as W
from tpusim_torch.backend import TorchBackend
from tpusim_torch.backends import placement_hash
from tpusim_torch.obs import recorder as flight


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    yield
    flight.uninstall()


def _traced(route, rec=None):
    snapshot, pods = W.build_workload(2048, 500, seed=31)
    if rec is not None:
        flight.install(rec)
    try:
        placements = TorchBackend(route=route, fallback="error").schedule(
            pods, snapshot)
    finally:
        flight.uninstall()
    return placement_hash(placements)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_cuda_device_span_time_resolved_at_export(route):
    need_card()
    _traced(route)  # build the kernels and programs outside the trace
    rec = flight.FlightRecorder()
    _traced(route, rec)
    # nothing is read before the export
    dispatch = [e for e in rec.events if e["name"] == "device_dispatch"]
    assert len(dispatch) == 1
    assert "device_us" not in dispatch[0]["args"]
    doc = json.loads(rec.to_chrome_json())
    [ev] = [e for e in doc["traceEvents"] if e["name"] == "device_dispatch"]
    assert ev["cat"] == "device"
    assert 0 < ev["args"]["device_us"] <= ev["dur"]
    assert ev["args"]["route"] == route


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_cuda_recording_adds_no_synchronize(route, monkeypatch):
    need_card()
    _traced(route)
    calls = {"device": 0, "event": 0}
    real_sync = torch.cuda.synchronize
    real_event_sync = torch.cuda.Event.synchronize

    def sync(*args, **kw):
        calls["device"] += 1
        return real_sync(*args, **kw)

    def event_sync(self):
        calls["event"] += 1
        return real_event_sync(self)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_sync)
    plain = _traced(route)
    without = dict(calls)
    calls.update(device=0, event=0)
    rec = flight.FlightRecorder()
    traced = _traced(route, rec)
    assert calls == without
    assert traced == plain
    # the export is where the recorder waits for the device
    rec.to_chrome()
    assert calls["event"] == without["event"] + 1
