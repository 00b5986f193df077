"""The live telemetry plane on the card: the telemetry server scraped from a
thread while pipelined stream cycles run, every /analytics sample it served
equal to host_reduce of the inputs the capture kept (the handler's decode
waits on the sample's capture event, never on the device); /healthz and
/metrics answer throughout; a handler never synchronizes the device
(torch.cuda.synchronize counted with a patched function); and the chain is
the same with the plane armed as without it.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_telemetry_cuda.py

Without a card every case skips.
"""

import json
import threading
import time
import urllib.request

import pytest
import torch

from tpusim_torch.obs import analytics
from tpusim_torch.obs.server import start_server
from tpusim_torch.scan import AnalyticsStats
from tpusim_torch.simulator import run_stream_simulation

CELL = dict(num_nodes=1_000, cycles=24, arrivals=64, evict_fraction=0.25,
            seed=9)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_cuda_scraped_samples_equal_host_reduce(pipeline, monkeypatch):
    need_card()
    want = run_stream_simulation(device="cuda", pipeline=pipeline, **CELL)
    syncs = []
    real_sync = torch.cuda.synchronize

    def counted(*args, **kwargs):
        syncs.append(threading.current_thread().name)
        return real_sync(*args, **kwargs)

    log = analytics.install(analytics.ClusterAnalytics(
        keep_inputs=True, sample_interval_s=0.0))
    server = start_server("127.0.0.1:0")
    served, statuses = [], []
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            for path in ("/analytics?limit=8", "/healthz", "/metrics"):
                status, body = _get(server.url + path)
                statuses.append(status)
                if path.startswith("/analytics"):
                    served.extend(json.loads(body)["series"])
            stop.wait(0.01)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    scraper = threading.Thread(target=scrape, name="scraper", daemon=True)
    try:
        scraper.start()
        got = run_stream_simulation(device="cuda", pipeline=pipeline, **CELL)
        time.sleep(0.05)
    finally:
        stop.set()
        scraper.join(timeout=30)
        server.stop()
        analytics.uninstall()
    assert got["placement_chain"] == want["placement_chain"]
    assert served and set(statuses) == {200}
    assert not [name for name in syncs if name != "MainThread"]
    by_seq = {s.seq: s for s in log.samples()}
    for rec in served:
        sample = by_seq[rec["seq"]]
        expect = json.loads(json.dumps(analytics.decode_stats(
            AnalyticsStats(**analytics.host_reduce(
                sample.inputs, sample.n_valid, sample.k)), sample.names)))
        assert {k: v for k, v in rec.items()
                if k not in ("seq", "ts", "source", "cycle")} == expect
