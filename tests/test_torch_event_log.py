"""Event-log replay on the port against the JAX package, after
tests/test_event_log.py: a run over (snapshot + watch-event log) equals a
fresh run over the equivalent snapshot and the JAX package's replay, on the
host route and on the torch backend's kernel and scan routes; the log
reader's objects and error text equal the JAX package's; the preemption
hybrid reuses the replay's IncrementalCluster; the CLI's --event-log and
--v 5; and backend "auto" sized after the fold.
"""

import json
import logging

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.api.types import Service as JaxService
from tpusim.cli import main as jax_main
from tpusim.framework.events import WatchEvent as JaxWatchEvent
from tpusim.framework.events import load_event_log as jax_load_event_log
from tpusim.simulator import run_simulation as jax_run_simulation

import tpusim_torch.api.snapshot as port_api
from tpusim_torch import delta
from tpusim_torch.api.types import Service
from tpusim_torch.cli import main
from tpusim_torch.framework.events import WatchEvent, load_event_log
from tpusim_torch.framework.store import ADDED, DELETED, MODIFIED
from tpusim_torch.simulator import run_simulation

# (backend, route) of the port: the host orchestrator and the torch
# backend's two device routes
ENGINES = [("reference", "auto"), ("torch", "kernel"), ("torch", "scan")]


def frame(event_type: str, obj) -> str:
    return WatchEvent(event_type, obj).to_frame()


def write_log(tmp_path, frames, name="events.jsonl"):
    path = tmp_path / name
    path.write_text("\n".join(frames) + "\n")
    return str(path)


def make_events_and_equivalent(api=port_api, service_cls=Service):
    """Start: 2 nodes, 1 placed pod. Events: add node n3, delete node n1,
    grow n2's capacity, delete the placed pod, add a placed pod on n3,
    add a service. Returns (base_snapshot, events, equivalent_snapshot)."""
    n1 = api.make_node("n1", milli_cpu=2000)
    n2 = api.make_node("n2", milli_cpu=2000)
    n2_big = api.make_node("n2", milli_cpu=8000)
    n3 = api.make_node("n3", milli_cpu=4000)
    placed = api.make_pod("placed", milli_cpu=500, node_name="n1",
                          phase="Running")
    placed2 = api.make_pod("placed2", milli_cpu=1000, node_name="n3",
                           phase="Running", labels={"app": "web"})
    svc = service_cls.from_obj({
        "metadata": {"name": "web", "namespace": "default"},
        "spec": {"selector": {"app": "web"}}})
    base = api.ClusterSnapshot(nodes=[n1, n2], pods=[placed])
    events = [
        (ADDED, n3),
        (DELETED, n1),
        (MODIFIED, n2_big),
        (DELETED, placed),
        (ADDED, placed2),
        (ADDED, svc),
    ]
    equivalent = api.ClusterSnapshot(nodes=[n2_big, n3], pods=[placed2],
                                     services=[svc])
    return base, events, equivalent


def placements_sig(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods])


def _jax_replay(n_pods=8, **kw):
    base, events, _ = make_events_and_equivalent(jax_api, JaxService)
    pods = [jax_api.make_pod(f"new-{i}", milli_cpu=900) for i in range(n_pods)]
    return jax_run_simulation(pods, base, backend="jax", events=events, **kw)


@pytest.mark.parametrize("backend,route", ENGINES)
def test_event_replay_equals_fresh_snapshot(backend, route):
    base, events, equivalent = make_events_and_equivalent()
    pods = [port_api.make_pod(f"new-{i}", milli_cpu=900) for i in range(8)]
    replayed = run_simulation([p.copy() for p in pods], base,
                              backend=backend, events=events, device="cpu",
                              route=route)
    fresh = run_simulation([p.copy() for p in pods], equivalent,
                           backend=backend, device="cpu", route=route)
    assert placements_sig(replayed) == placements_sig(fresh) \
        == placements_sig(_jax_replay())
    assert all(p.spec.node_name != "n1" for p in replayed.successful_pods)


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_event_replay_workload_equals_jax(route):
    """The seeded event-log workload (config 3 with nodes added, deleted
    and grown and placed pods added and deleted): the replay equals the
    JAX package's and a port run on the folded snapshot."""
    from tpusim_torch import workloads

    snapshot, pods, events = workloads.event_log_workload(600, 60)
    got = run_simulation(pods, snapshot, events=events, device="cpu",
                         route=route)
    folded = delta.IncrementalCluster(snapshot)
    folded.apply_events(events)
    fresh = run_simulation(pods, folded.to_snapshot(), device="cpu",
                           route=route)
    jsnap, jpods, jevents = workloads.event_log_workload(600, 60,
                                                         api=jax_api)
    want = jax_run_simulation(jpods, jsnap, backend="jax", events=jevents)
    assert placements_sig(got) == placements_sig(fresh) \
        == placements_sig(want)
    assert len(events) == 6 + 3 + 3 + 12 + 2


def test_load_event_log_roundtrip(tmp_path):
    base, events, _ = make_events_and_equivalent()
    path = write_log(tmp_path, [frame(t, o) for t, o in events])
    loaded = load_event_log(path)
    assert [(t, type(o).__name__, getattr(o, "name", ""))
            for t, o in loaded] == \
           [(t, type(o).__name__, getattr(o, "name", ""))
            for t, o in events]
    # the JAX package reads the same file into the same objects, and both
    # write the same frames
    jax_loaded = jax_load_event_log(path)
    assert [(t, o.to_obj()) for t, o in loaded] == \
        [(t, o.to_obj()) for t, o in jax_loaded]
    assert [frame(t, o) for t, o in loaded] == \
        [JaxWatchEvent(t, o).to_frame() for t, o in jax_loaded]


@pytest.mark.parametrize("text,match", [
    ('{"type": "Added", "object": {"kind": "Widget"}}\n',
     "unsupported object kind"),
    ('{"type": "Exploded", "object": {"kind": "Pod"}}\n',
     "unknown event type"),
    ("not json\n", "not JSON"),
    ('{"type": "Added", "object": [1]}\n', "must be a JSON object"),
])
def test_load_event_log_rejects_garbage(tmp_path, text, match):
    path = tmp_path / "bad.jsonl"
    path.write_text(text)
    with pytest.raises(ValueError, match=match) as port_err:
        load_event_log(str(path))
    with pytest.raises(ValueError) as jax_err:
        jax_load_event_log(str(path))
    assert str(port_err.value) == str(jax_err.value)


def _pod_spec_file(tmp_path, num, milli_cpu, api=port_api):
    spec = tmp_path / "pod.json"
    spec.write_text(json.dumps([{
        "name": "w", "num": num,
        "pod": api.make_pod("w", milli_cpu=milli_cpu).to_obj()}]))
    return spec


@pytest.mark.parametrize("backend", ["torch", "reference"])
def test_cli_event_log_replay(tmp_path, capsys, backend):
    base, events, equivalent = make_events_and_equivalent()
    snap_file = tmp_path / "snap.json"
    base.save(str(snap_file))
    log_file = write_log(tmp_path, [frame(t, o) for t, o in events])
    spec = _pod_spec_file(tmp_path, 6, 900)

    rc = main(["--podspec", str(spec), "--snapshot", str(snap_file),
               "--event-log", log_file, "--backend", backend,
               "--device", "cpu", "--quiet"])
    assert rc == 0
    replay_out = capsys.readouterr().out

    fresh_file = tmp_path / "fresh.json"
    equivalent.save(str(fresh_file))
    rc = main(["--podspec", str(spec), "--snapshot", str(fresh_file),
               "--backend", backend, "--device", "cpu", "--quiet"])
    assert rc == 0
    fresh_out = capsys.readouterr().out

    rc = jax_main(["--podspec", str(spec), "--snapshot", str(snap_file),
                   "--event-log", log_file, "--backend", "jax", "--quiet"])
    assert rc == 0
    jax_out = capsys.readouterr().out
    # identical scheduled/unschedulable counts (the timing differs)
    counts = [out.strip().splitlines()[0].split("[")[0]
              for out in (replay_out, fresh_out, jax_out)]
    assert counts[0] == counts[1] == counts[2]
    assert counts[0].startswith("6 pod(s) scheduled")


def test_cli_event_log_invalid(tmp_path, capsys):
    spec = _pod_spec_file(tmp_path, 1, 100)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("nope\n")
    args = ["--podspec", str(spec), "--synthetic-nodes", "2",
            "--event-log", str(bad)]
    assert main(args + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "invalid event log" in err
    assert jax_main(args) == 2
    assert capsys.readouterr().err == err


def test_cli_event_log_refused_with_what_if(tmp_path, capsys):
    rc = main(["--what-if", str(tmp_path / "w.json"),
               "--event-log", str(tmp_path / "e.jsonl")])
    assert rc == 2
    assert "--event-log cannot be combined" in capsys.readouterr().err


class _Probe(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("backend", ["torch", "reference", "auto"])
def test_cli_v5(tmp_path, capsys, backend):
    """--v 5 turns on the tpusim_torch loggers' DEBUG level (the host
    engine's per-node score dump on the host route) and, on a run that
    uses the device routes, the note that the dump is host-only."""
    spec = _pod_spec_file(tmp_path, 1, 1000)
    target = logging.getLogger("tpusim_torch.engine.generic_scheduler")
    probe = _Probe()
    target.addHandler(probe)
    args = ["--podspec", str(spec), "--synthetic-nodes", "2", "--backend",
            backend, "--device", "cpu", "--quiet"]
    try:
        assert main(list(args)) == 0
        assert not any("=> Score" in m for m in probe.messages)
        assert "per-node score dump" not in capsys.readouterr().err
        assert main(args + ["--v", "5"]) == 0
        err = capsys.readouterr().err
        on_device = backend == "torch"  # auto: 1 pod x 2 nodes, the host
        assert ("per-node score dump (--v 5)" in err) == on_device
        assert any("=> Score" in m for m in probe.messages) != on_device
    finally:
        target.removeHandler(probe)
        logging.getLogger("tpusim_torch").setLevel(logging.NOTSET)


def test_auto_is_sized_after_the_fold(tmp_path, capsys, monkeypatch):
    """backend "auto" counts the nodes an event log adds: 2 pods on 1 seed
    node stay on the host under a threshold of 8 pod x node pairs, and the
    same pods after a log adding 4 nodes go to the device routes; the --v 5
    note follows the same sizing."""
    monkeypatch.setenv("TPUSIM_AUTO_THRESHOLD", "8")
    seen = []
    import tpusim_torch.simulator as sim

    real = sim.ClusterCapacity.run

    def spy(self):
        seen.append("reference")
        return real(self)

    monkeypatch.setattr(sim.ClusterCapacity, "run", spy)
    base = port_api.ClusterSnapshot(nodes=[port_api.make_node("n0")])
    events = [(ADDED, port_api.make_node(f"m{i}")) for i in range(4)]
    pods = [port_api.make_pod(f"p{i}", milli_cpu=100) for i in range(2)]
    run_simulation([p.copy() for p in pods], base, backend="auto",
                   device="cpu")
    assert seen == ["reference"]
    status = run_simulation([p.copy() for p in pods], base, backend="auto",
                            events=events, device="cpu")
    assert seen == ["reference"]  # the device routes ran
    assert len(status.successful_pods) == 2

    snap_file = tmp_path / "snap.json"
    base.save(str(snap_file))
    log_file = write_log(tmp_path, [frame(t, o) for t, o in events])
    spec = _pod_spec_file(tmp_path, 2, 100)
    try:
        for extra, note in (([], False), (["--event-log", log_file], True)):
            assert main(["--podspec", str(spec), "--snapshot",
                         str(snap_file), "--backend", "auto", "--device",
                         "cpu", "--quiet", "--v", "5"] + extra) == 0
            err = capsys.readouterr().err
            assert ("per-node score dump (--v 5)" in err) == note
    finally:
        logging.getLogger("tpusim_torch").setLevel(logging.NOTSET)


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_event_replay_feeds_preemption_hybrid(route, monkeypatch):
    """The IncrementalCluster of a replay is handed to the preemption
    hybrid, and the run equals the host orchestrator on the equivalent
    snapshot, a fresh-snapshot hybrid run and the JAX package's replay."""
    import tpusim_torch.preempt as preempt

    handed = []
    real = preempt.run_with_preemption

    def spy(*args, **kw):
        handed.append(kw.get("incremental"))
        return real(*args, **kw)

    monkeypatch.setattr(preempt, "run_with_preemption", spy)

    def feed(api, service_cls):
        base, events, equivalent = make_events_and_equivalent(api,
                                                              service_cls)

        def prio(pod, value):
            pod.spec.priority = value
            return pod

        extra_placed = [prio(api.make_pod(
            f"low-{i}", milli_cpu=(6000 if i == 0 else 3000),
            node_name=("n2" if i == 0 else "n3"), phase="Running"), 0)
            for i in range(2)]
        events = events + [(ADDED, p) for p in extra_placed]
        equivalent.pods = equivalent.pods + extra_placed
        pods = [prio(api.make_pod(f"hi-{i}", milli_cpu=2500), 100)
                for i in range(2)]
        return base, events, equivalent, pods

    base, events, equivalent, pods = feed(port_api, Service)
    replayed = run_simulation([p.copy() for p in pods], base, events=events,
                              enable_pod_priority=True, device="cpu",
                              route=route)
    assert isinstance(handed[0], delta.IncrementalCluster)
    ref = run_simulation([p.copy() for p in pods], equivalent,
                         backend="reference", enable_pod_priority=True)
    fresh = run_simulation([p.copy() for p in pods], equivalent,
                           enable_pod_priority=True, device="cpu",
                           route=route)
    jbase, jevents, _, jpods = feed(jax_api, JaxService)
    want = jax_run_simulation([p.copy() for p in jpods], jbase,
                              backend="jax", events=jevents,
                              enable_pod_priority=True)
    assert placements_sig(replayed) == placements_sig(ref) \
        == placements_sig(fresh) == placements_sig(want)
    assert sorted(p.name for p in replayed.preempted_pods) \
        == sorted(p.name for p in ref.preempted_pods) \
        == sorted(p.name for p in want.preempted_pods)
    assert replayed.preempted_pods
