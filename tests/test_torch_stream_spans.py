"""The spans around the streaming twin's host work
(tpusim_torch/stream/runtime.py), on the CPU, under an injected clock.

- A steady cycle emits stream_ingest, stream_route, commit_gather,
  stream_commit, stream_pack, device_dispatch, decode_placements and
  stream_foldback, in that order, as siblings, with their arguments, each
  stamped with the cycle's trace id.
- A restage cycle's stream_route carries its reason.
- The pipelined path folds its binds back under stream_foldback, from
  _fold_binds, stamped with the dispatching cycle's trace.
- StreamSession.ingest emits stream_ingest with the events it applied.
- With no recorder every new call site gets the shared no-op span, and the
  placements and the fold chain are those of a traced run.
- FlightRecorder.sync_device_clock pins its readings as an anchor, one
  before each fill it launches after the first, and exports them.
Tolerance: exact.
"""

import itertools

import pytest

from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
from tpusim_torch.backends import placement_hash
from tpusim_torch.framework import events as watch_events
from tpusim_torch.framework.store import ADDED
from tpusim_torch.obs import recorder as flight
from tpusim_torch.obs import tracectx
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import ChurnLoadGen, StreamSession

NODES, ARRIVALS, CYCLES = 8, 6, 5
CYCLE_SPANS = ("stream_ingest", "stream_route", "commit_gather",
               "stream_commit", "stream_pack", "device_dispatch",
               "decode_placements", "stream_foldback")
# the spans this file is about, with the argument each carries
NEW_SPANS = {"stream_ingest": "events", "stream_route": "pods",
             "commit_gather": "rows", "stream_pack": "pods",
             "stream_foldback": "bound"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    flight.uninstall()
    tracectx.set_id_source(None)


def _install():
    ticks = itertools.count()
    ids = itertools.count(1)
    tracectx.set_id_source(lambda: f"{next(ids):016x}")
    return flight.install(flight.FlightRecorder(
        clock=lambda: next(ticks) * 1e-6))


def _drive(pipelined=False, cycles=CYCLES, before=None):
    """A twin under churn, each cycle under a trace context of its own as
    run_stream_simulation opens one. Returns the session, the placements
    in emission order, each cycle's trace id (None untraced) and its
    events. before(session, cycle) runs ahead of each cycle."""
    session = StreamSession(synthetic_cluster(NODES), device="cpu")
    gen = ChurnLoadGen(synthetic_cluster(NODES), seed=5, arrivals=ARRIVALS,
                       evict_fraction=0.25)
    out, traces, evs = [], [], []
    for c in range(cycles):
        if before is not None:
            before(session, c)
        if pipelined:
            gen.note_bound(session.poll_placed())
        ctx = tracectx.start()
        traces.append(ctx.trace_id if ctx is not None else None)
        evs.append(gen.events(c))
        with tracectx.activate(ctx):
            session.apply_events(evs[-1])
            if pipelined:
                prev = session.schedule_pipelined(gen.batch())
                if prev is not None:
                    out.append(prev)
            else:
                out.append(session.schedule(gen.batch()))
                gen.note_bound(out[-1])
    if pipelined:
        out.append(session.flush())
    return session, out, traces, evs


def _by_trace(rec, names):
    spans = {}
    for e in rec.events:
        if e["ph"] == "X" and e["name"] in names:
            spans.setdefault(e["args"]["trace_id"], []).append(e)
    return spans


def test_a_steady_cycle_emits_its_spans_in_order():
    rec = _install()
    session, out, traces, evs = _drive()
    assert session.restage_counts == {"cold_start": 1}
    spans = _by_trace(rec, CYCLE_SPANS)
    assert set(spans) == set(traces)
    for c in range(1, CYCLES):
        cycle = spans[traces[c]]
        assert tuple(e["name"] for e in cycle) == CYCLE_SPANS, c
        # siblings: each ends before the next begins
        for a, b in zip(cycle, cycle[1:]):
            assert a["ts"] + a["dur"] <= b["ts"], (c, a["name"], b["name"])
        args = {e["name"]: e["args"] for e in cycle}
        assert args["stream_ingest"]["events"] == len(evs[c]) > 0
        assert args["stream_route"]["pods"] == ARRIVALS
        assert "reason" not in args["stream_route"]
        assert args["stream_pack"]["pods"] == ARRIVALS
        assert args["commit_gather"]["rows"] > 0
        assert args["stream_foldback"]["bound"] == sum(
            1 for pl in out[c] if pl.node_name) > 0
        for name, key in NEW_SPANS.items():
            assert set(args[name]) - {"reason"} == {key, "trace_id",
                                                    "span_id"}, name


def test_a_restage_cycle_routes_with_its_reason():
    rec = _install()

    def force(session, cycle):
        if cycle == 3:
            session.force_restage("forced_for_test")

    session, _out, traces, _evs = _drive(before=force)
    assert session.restage_counts == {"cold_start": 1, "forced_for_test": 1}
    routes = {e["args"]["trace_id"]: e["args"] for e in rec.events
              if e["name"] == "stream_route"}
    assert routes[traces[0]]["reason"] == "cold_start"
    assert routes[traces[3]]["reason"] == "forced_for_test"
    assert all("reason" not in routes[traces[c]] for c in (1, 2, 4))
    # a restage commits nothing: its rows are staged whole
    gathers = _by_trace(rec, ("commit_gather",))
    assert traces[0] not in gathers and traces[3] not in gathers


def test_the_pipelined_fold_back_runs_under_its_cycle(monkeypatch):
    rec = _install()
    inside = []
    fold = StreamSession._fold_binds

    def spy(self, p):
        before = len(rec.events)
        fold(self, p)
        inside.extend(e["name"] for e in list(rec.events)[before:])

    monkeypatch.setattr(StreamSession, "_fold_binds", spy)
    session, out, traces, _evs = _drive(pipelined=True)
    assert session.path_counts["pipelined"] == CYCLES - 1
    folds = _by_trace(rec, ("stream_foldback",))
    # one fold-back a cycle, under the cycle that dispatched it: the cold
    # start's from the synchronous path, every other one from _fold_binds
    assert {t: len(f) for t, f in folds.items()} == {t: 1 for t in traces}
    assert inside.count("stream_foldback") == CYCLES - 1
    bound = [sum(1 for pl in placements if pl.node_name)
             for placements in out]
    assert [folds[t][0]["args"]["bound"] for t in traces] == bound


def test_ingest_emits_its_span():
    session = StreamSession(synthetic_cluster(4), device="cpu")
    buf = watch_events.WatchBuffer(maxsize=8, resource="pods")
    buf.emit(ADDED, make_pod("a", node_name="node-0"))
    buf.emit(ADDED, make_pod("b", node_name="node-1"))
    rec = _install()
    assert session.ingest(buf) == 2
    [ev] = [e for e in rec.events if e["name"] == "stream_ingest"]
    assert ev["args"] == {"events": 2}


@pytest.mark.parametrize("pipelined", [False, True])
def test_untraced_spans_are_the_noop_and_change_nothing(monkeypatch,
                                                        pipelined):
    seen = []
    span = flight.span

    def spy(name, cat="host", device=None):
        sp = span(name, cat, device)
        seen.append((name, sp))
        return sp

    monkeypatch.setattr(flight, "span", spy)
    _s, off, _t, _e = _drive(pipelined)
    got = {name for name, _sp in seen}
    assert set(NEW_SPANS) <= got
    assert all(sp is flight.NOOP_SPAN for _name, sp in seen)
    _install()
    _s, on, _t, _e = _drive(pipelined)
    assert [placement_hash(p) for p in on] == \
        [placement_hash(p) for p in off]
    flight.uninstall()
    cell = dict(num_nodes=NODES, cycles=CYCLES, arrivals=ARRIVALS,
                evict_fraction=0.25, seed=9, pipeline=pipelined,
                device="cpu")
    untraced = run_stream_simulation(**cell)
    _install()
    traced = run_stream_simulation(**cell)
    assert traced["fold_chain"] == untraced["fold_chain"]
    assert traced["placement_chain"] == untraced["placement_chain"]


def test_device_clock_sync_pins_a_reading_before_each_fill():
    ticks = itertools.count()
    rec = flight.FlightRecorder(clock=lambda: next(ticks) * 1e-6)
    marker = rec.sync_device_clock("cpu")
    assert marker.shape == (1,)
    assert float(marker) == flight.CLOCK_FILLS - 1
    readings = rec.anchors["device_sync_us"]
    assert readings == [float(i) for i in range(1, flight.CLOCK_FILLS + 1)]
    rec.sync_device_clock("cpu", "device_sync_end_us")
    assert rec.to_chrome()["otherData"]["anchors"] == {
        "device_sync_us": readings,
        "device_sync_end_us": [float(i) for i in range(
            flight.CLOCK_FILLS + 1, 2 * flight.CLOCK_FILLS + 1)]}
