"""The port's watch fabric (framework/events.py WatchBuffer, restclient.py,
reflector.py, fake.py; IncrementalCluster.ingest; StreamSession.ingest,
watch and sync) against the JAX package's, on the CPU.

Every case of tests/test_restclient.py runs on both packages over the same
seeded store: the list and get bodies and the watch frames must be equal
(JSON for JSON, wire frame for wire frame), the errors too. Then the
WatchBuffer's overflow and close, a reflector's relist diff, the
quickstart fed through the fabric alone (equal to the direct path), the
overflow -> relist -> watch_expired restage on device="cpu" with the JAX
package's placement hash, and config 9's churn fed only through the
fabric (chip_smoke.watch_stream) with the node watch torn mid-run, whose
chains must equal the JAX package's and the golden that chip_smoke.py
holds. Tolerance: exact.
"""

import json
import types

import pytest

import tpusim.api.snapshot as jax_api
import tpusim.api.types as jax_types
import tpusim.backends as jax_backends
import tpusim.framework.events as jax_events
import tpusim.framework.reflector as jax_reflector
import tpusim.framework.restclient as jax_rc
import tpusim.framework.store as jax_store
import tpusim.stream as jax_stream
from tpusim.framework.metrics import register as jax_register
from tpusim.jaxe.delta import IncrementalCluster as JaxIncremental

import chip_smoke
import tpusim_torch.api.snapshot as port_api
import tpusim_torch.api.types as port_types
import tpusim_torch.framework.events as port_events
import tpusim_torch.framework.reflector as port_reflector
import tpusim_torch.framework.restclient as port_rc
import tpusim_torch.framework.store as port_store
from tpusim_torch.delta import IncrementalCluster
from tpusim_torch.framework.fake import FakeResourceStore
from tpusim_torch.framework.metrics import register

JAX = types.SimpleNamespace(api=jax_api, types=jax_types, store=jax_store,
                            events=jax_events, restclient=jax_rc,
                            reflector=jax_reflector, stream=jax_stream,
                            backends=jax_backends)
PORT = types.SimpleNamespace(reflector=port_reflector,
                             **vars(chip_smoke.port_watch_modules()))


def seeded(pkg):
    """tests/test_restclient.py's seeded store, with either package."""
    rt = pkg.types.ResourceType
    store = pkg.store.ResourceStore()
    client = pkg.restclient.FakeRESTClient(store)
    store.add(rt.NODES, pkg.api.make_node("n1", milli_cpu=1000))
    store.add(rt.NODES, pkg.api.make_node("n2", milli_cpu=2000))
    store.add(rt.PODS, pkg.api.make_pod("running", milli_cpu=100,
                                        node_name="n1", phase="Running"))
    store.add(rt.PODS, pkg.api.make_pod("pending", milli_cpu=100))
    store.add(rt.PODS, pkg.api.make_pod(
        "other-ns", milli_cpu=100, namespace="kube-system", node_name="n2",
        phase="Running"))
    store.add(rt.SERVICES, pkg.types.Service.from_obj(
        {"metadata": {"name": "web", "namespace": "default"},
         "spec": {"selector": {"app": "web"}}}))
    return store, client


def outcome(fn):
    """A call's body, or its ApiError's code and wire object."""
    try:
        return ("ok", fn())
    except (jax_rc.ApiError, port_rc.ApiError) as exc:
        return ("error", exc.code, exc.to_obj())


# --- list and get (restclient_test.go), body for body ---------------------

REQUESTS = {
    "list_pods": lambda c: c.get().resource("pods").do(),
    "list_pods_namespaced":
        lambda c: c.get().namespace("kube-system").resource("pods").do(),
    "selector_phase": lambda c: c.get().resource("pods")
        .field_selector("status.phase=Running").do(),
    "selector_node": lambda c: c.get().resource("pods")
        .field_selector("spec.nodeName=n1").do(),
    "selector_negated": lambda c: c.get().resource("pods")
        .field_selector("spec.nodeName!=,status.phase=Running").do(),
    "selector_negated_alone": lambda c: c.get().resource("pods")
        .field_selector("spec.nodeName!=n1").do(),
    "selector_double_equals": lambda c: c.get().resource("pods")
        .field_selector("metadata.namespace==kube-system").do(),
    "get_pod": lambda c: c.get().namespace("default").resource("pods")
        .name("running").do(),
    "get_node": lambda c: c.get().resource("nodes").name("n2").do(),
    "get_404": lambda c: c.get().namespace("default").resource("pods")
        .name("ghost").do(),
    "status_subresource": lambda c: c.get().namespace("default")
        .resource("pods").name("running").sub_resource("status").do(),
    "unknown_resource": lambda c: c.handle("/widgets"),
    "bad_path": lambda c: c.handle("/pods/x/status/extra"),
    "watch_path_on_get": lambda c: c.handle("/watch/pods"),
    "list_services": lambda c: c.get().resource("services").do(),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_request_bodies_match_jax(name):
    call = REQUESTS[name]
    want = outcome(lambda: call(seeded(JAX)[1]))
    got = outcome(lambda: call(seeded(PORT)[1]))
    assert got == want


def test_negated_selector_excludes_the_match():
    _, client = seeded(PORT)
    body = client.get().resource("pods").field_selector(
        "spec.nodeName!=n1").do()
    assert sorted(i["metadata"]["name"] for i in body["items"]) == \
        ["other-ns", "pending"]


def test_field_selector_and_url_match_jax():
    for pkg in (JAX, PORT):
        with pytest.raises(pkg.restclient.ApiError):
            pkg.restclient.FieldSelector("notaterm")
    for pkg in (JAX, PORT):
        _, client = seeded(pkg)
        req = client.get().namespace("ns1").resource("pods").name("p") \
            .sub_resource("status")
        assert req.url() == "/namespaces/ns1/pods/p/status"
        assert client.get().resource("nodes").url(watch=True) == \
            "/watch/nodes"


def test_decode_list_round_trips():
    for pkg in (JAX, PORT):
        _, client = seeded(pkg)
        pods = pkg.restclient.decode_list(client.get().resource("pods").do(),
                                          pkg.types.ResourceType.PODS)
        assert sorted(p.name for p in pods) == ["other-ns", "pending",
                                                "running"]
        assert all(isinstance(p, pkg.types.Pod) for p in pods)


# --- the watch fabric (watch_test.go), frame for frame ---------------------

def frames(buf):
    return [ev.to_frame() for ev in buf]


def _watch_stream(pkg):
    store, client = seeded(pkg)
    rt, api = pkg.types.ResourceType, pkg.api
    buf = client.get().resource("nodes").watch()
    out = frames(buf)
    store.add(rt.NODES, api.make_node("n3"))
    n3 = api.make_node("n3", unschedulable=True)
    store.update(rt.NODES, n3)
    store.delete(rt.NODES, n3)
    return out + frames(buf)


def _watch_selector(pkg):
    store, client = seeded(pkg)
    rt, api = pkg.types.ResourceType, pkg.api
    buf = client.get().resource("pods") \
        .field_selector("spec.nodeName=n1").watch()
    out = frames(buf)
    store.add(rt.PODS, api.make_pod("new-on-n1", node_name="n1"))
    store.add(rt.PODS, api.make_pod("new-on-n2", node_name="n2"))
    return out + frames(buf)


def _watch_namespaced(pkg):
    store, client = seeded(pkg)
    rt, api = pkg.types.ResourceType, pkg.api
    buf = client.get().namespace("kube-system").resource("pods").watch()
    out = frames(buf)
    store.add(rt.PODS, api.make_pod("p2", namespace="kube-system"))
    store.add(rt.PODS, api.make_pod("p3", namespace="default"))
    return out + frames(buf)


def _watch_services(pkg):
    _, client = seeded(pkg)
    return frames(client.get().resource("services").watch())


def _watch_shared(pkg):
    _, client = seeded(pkg)
    a = client.get().resource("pods").watch()
    b = client.get().resource("pods").watch()
    c = client.get().resource("pods").field_selector(
        "spec.nodeName=n1").watch()
    return [a is b, c is a]


def _watch_close(pkg):
    store, client = seeded(pkg)
    buf = client.get().resource("pods").watch()
    out = frames(buf)
    client.close()
    store.add(pkg.types.ResourceType.PODS, pkg.api.make_pod("late"))
    return out + frames(buf) + [buf.closed]


def _watch_bad_path(pkg):
    _, client = seeded(pkg)
    return outcome(lambda: client.handle_watch("/watch/pods/x"))


WATCHES = {"stream": _watch_stream, "selector": _watch_selector,
           "namespaced": _watch_namespaced, "services": _watch_services,
           "shared": _watch_shared, "close": _watch_close,
           "bad_path": _watch_bad_path}


@pytest.mark.parametrize("name", sorted(WATCHES))
def test_watch_frames_match_jax(name):
    assert WATCHES[name](PORT) == WATCHES[name](JAX)


def test_watch_frame_wire_shape():
    _, client = seeded(PORT)
    frame = json.loads(client.get().resource("services").watch()
                       .read(timeout=0).to_frame())
    assert (frame["type"], frame["object"]["kind"],
            frame["object"]["metadata"]["name"]) == ("Added", "Service",
                                                     "web")


# --- WatchBuffer overflow and close ---------------------------------------

def _overflow(pkg, reg):
    reg().reset()
    buf = pkg.events.WatchBuffer(maxsize=2, resource="nodes")
    for name in ("a", "b", "c", "d"):
        buf.emit(pkg.store.ADDED, pkg.api.make_node(name))
    out = [buf.closed, buf.error.code, str(buf.error)]
    with pytest.raises(pkg.events.WatchExpiredError):
        buf.read(timeout=0)
    with pytest.raises(pkg.events.WatchExpiredError):
        buf.drain()  # every later read fails too
    return out + [reg().watch_overflow.get("nodes")]


def _close_drains(pkg, reg):
    buf = pkg.events.WatchBuffer(maxsize=4, resource="pods")
    buf.emit(pkg.store.ADDED, pkg.api.make_pod("x"))
    buf.close_with_error(pkg.events.WatchExpiredError("torn"))
    first = [ev.to_frame() for ev in buf.drain()]  # the frame that survived
    with pytest.raises(pkg.events.WatchExpiredError):
        buf.drain()
    buf2 = pkg.events.WatchBuffer(resource="pods")
    buf2.emit(pkg.store.ADDED, pkg.api.make_pod("y"))
    buf2.close()
    buf2.emit(pkg.store.ADDED, pkg.api.make_pod("z"))  # after close: dropped
    return first + frames(buf2) + [buf2.read(timeout=0)]


def _watch_resource(pkg, reg):
    store = pkg.store.ResourceStore()
    rt = pkg.types.ResourceType
    store.add(rt.NODES, pkg.api.make_node("n1"))
    buf = pkg.events.watch_resource(store, rt.NODES)
    store.add(rt.NODES, pkg.api.make_node("n2"))
    return frames(buf) + [pkg.events.DEFAULT_WATCH_BUFFER_SIZE]


BUFFERS = {"overflow": _overflow, "close": _close_drains,
           "watch_resource": _watch_resource}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_watch_buffer_matches_jax(name):
    assert BUFFERS[name](PORT, register) == BUFFERS[name](JAX, jax_register)


# --- the reflector's relist -------------------------------------------------

def _relist(pkg):
    """A reflector on nodes whose stream overflows after three changes: the
    relist's synthetic diff (DELETED, ADDED, MODIFIED), the known map, the
    hook's ordinal, and a drain past the relist."""
    store = pkg.store.ResourceStore()
    rt, api = pkg.types.ResourceType, pkg.api
    for name in ("n1", "n2", "n3"):
        store.add(rt.NODES, api.make_node(name))
    client = pkg.restclient.FakeRESTClient(store)
    seen, hooks = [], []
    r = pkg.reflector.Reflector(
        client, rt.NODES, handler=lambda t, o: seen.append((t, o.name)),
        on_relist=hooks.append)
    first = r.sync()
    key = (rt.NODES.value, "", "")
    selector, _ = client._watchers[key]
    small = pkg.events.WatchBuffer(maxsize=2, resource="nodes")
    client._watchers[key] = (selector, small)
    r._buf = small
    store.delete(rt.NODES, api.make_node("n1"))
    store.add(rt.NODES, api.make_node("n4"))
    store.update(rt.NODES, api.make_node("n2", unschedulable=True))
    applied = r.sync()
    store.add(rt.NODES, api.make_node("n5"))
    after = r.sync()
    return [first, applied, after, r.relists, hooks, seen,
            sorted(r.known)]


def test_reflector_relist_matches_jax():
    got, want = _relist(PORT), _relist(JAX)
    assert got == want
    assert got[3] == 1 and got[1] == 3  # one relist, a diff of three


def test_fake_store_reads_and_ignores_writes():
    store = FakeResourceStore(nodes_data=lambda: [port_api.make_node("n1")])
    rt = port_types.ResourceType
    assert [n.name for n in store.list(rt.NODES)] == ["n1"]
    assert store.get(rt.NODES, "n1")[1] and not store.get(rt.NODES, "x")[1]
    store.add(rt.NODES, port_api.make_node("n2"))
    assert store.resources() == [rt.NODES] and len(store.list(rt.NODES)) == 1


# --- IncrementalCluster.ingest ---------------------------------------------

def _ingest(pkg, inc_cls):
    store = pkg.store.ResourceStore()
    rt, api = pkg.types.ResourceType, pkg.api
    for i in range(3):
        store.add(rt.NODES, api.make_node(f"n{i}", milli_cpu=2000))
    inc = inc_cls()
    nodes = pkg.events.watch_resource(store, rt.NODES)
    pods = pkg.events.watch_resource(store, rt.PODS)
    counts = [inc.ingest(nodes)]
    store.add(rt.PODS, api.make_pod("p", milli_cpu=500, node_name="n1",
                                    phase="Running"))
    store.delete(rt.NODES, api.make_node("n2"))
    counts += [inc.ingest(pods), inc.ingest(nodes)]
    snap = inc.to_snapshot()
    return counts, json.dumps(snap.to_obj(), sort_keys=True)


def test_incremental_ingest_matches_jax():
    got = _ingest(PORT, IncrementalCluster)
    assert got == _ingest(JAX, JaxIncremental)
    assert got[0] == [3, 1, 1]


# --- the quickstart through the fabric (tests/test_watch_fabric.py:120) ----

QUICKSTART = json.dumps([
    {"name": "A", "num": 10, "pod": {"spec": {"containers": [{"resources": {
        "requests": {"cpu": "1", "memory": "1"}}}]}}},
    {"name": "B", "num": 10, "pod": {"spec": {"containers": [{"resources": {
        "requests": {"cpu": "100", "memory": "1000"}}}]}}}])


def _quickstart(watched):
    """The port's host orchestrator on the quickstart, directly or with
    its cache fed only through the REST client's watch streams."""
    from tpusim_torch.api.podspec import (
        expand_simulation_pods,
        parse_simulation_pods,
    )
    from tpusim_torch.engine.cache import SchedulerCache
    from tpusim_torch.simulator import ClusterCapacity, SchedulerServerConfig

    nodes = port_api.synthetic_cluster(4, milli_cpu=4000,
                                       memory=16 * 1024 ** 3).nodes
    pods = expand_simulation_pods(parse_simulation_pods(QUICKSTART),
                                  deterministic_ids=True)
    cc = ClusterCapacity(SchedulerServerConfig(), pods, scheduled_pods=[],
                         nodes=nodes)
    seen = []
    if not watched:
        cc.run()
    else:
        rt = port_types.ResourceType
        cc.resource_store.unregister_event_handler(rt.PODS, cc._on_pod_event)
        cc.resource_store.unregister_event_handler(rt.NODES,
                                                   cc._on_node_event)
        cc.cache = SchedulerCache()
        client = port_rc.FakeRESTClient(cc.resource_store)
        node_watch = client.get().resource("nodes").watch()
        pod_watch = client.get().resource("pods").watch()

        def drain():
            for ev in node_watch:
                seen.append(("nodes", ev.type))
                cc._on_node_event(ev.type, ev.object)
            for ev in pod_watch:
                seen.append(("pods", ev.type))
                cc._on_pod_event(ev.type, ev.object)

        drain()
        pod = cc._next_pod()
        outcome_ = "run"
        while pod is not None:
            drain()
            outcome_ = cc._schedule_one(pod)
            drain()
            pod = cc._next_pod()
        cc.status.stop_reason = cc.STOP_REASONS[outcome_]
        cc.close()
        client.close()
    status = cc.status
    view = {"success": [(p.name, p.spec.node_name, p.status.phase)
                        for p in status.successful_pods],
            "failed": [(p.name, p.status.conditions[-1].message)
                       for p in status.failed_pods],
            "stop": status.stop_reason}
    return view, seen


def test_quickstart_through_the_fabric_equals_direct_path():
    direct, _ = _quickstart(False)
    watched, seen = _quickstart(True)
    assert watched == direct
    assert len(watched["success"]) == 10 and len(watched["failed"]) == 10
    assert seen.count(("nodes", port_store.ADDED)) == 4
    assert seen.count(("pods", port_store.MODIFIED)) == 10


# --- the stream: overflow -> relist -> watch_expired restage ---------------

def _stream_overflow(pkg, session_kw, reg):
    reg().reset()
    rt, api = pkg.types.ResourceType, pkg.api
    snap = api.synthetic_cluster(4, milli_cpu=4000, memory=16 * 1024 ** 3)
    store = pkg.store.ResourceStore()
    for n in snap.nodes:
        store.add(rt.NODES, n)
    client = pkg.restclient.FakeRESTClient(store)
    session = pkg.stream.StreamSession(**session_kw)
    reflector = session.watch(client, rt.NODES)
    out = [session.sync()]

    def batch(tag, n=8):
        return [api.make_pod(f"{tag}-{i}", milli_cpu=100, memory=256 << 20)
                for i in range(n)]

    hashes = [pkg.backends.placement_hash(session.schedule(batch(t)))
              for t in ("cold", "warm")]
    key = (rt.NODES.value, "", "")
    selector, _ = client._watchers[key]
    small = pkg.events.WatchBuffer(maxsize=2, resource=rt.NODES.value)
    client._watchers[key] = (selector, small)
    reflector._buf = small
    name = snap.nodes[0].name
    for unsched in (True, False, True):
        node, _ = store.get(rt.NODES, name)
        node = node.copy()
        node.spec.unschedulable = unsched
        store.update(rt.NODES, node)
    out += [small.closed, session.sync(), reflector.relists]
    got = session.schedule(batch("post"))
    hashes.append(pkg.backends.placement_hash(got))
    client.close()
    return out + [hashes, dict(session.restage_counts),
                  dict(session.path_counts),
                  all(pl.node_name != name for pl in got),
                  reg().watch_overflow.get("nodes")]


def test_stream_watch_overflow_relists_and_restages_like_jax():
    got = _stream_overflow(PORT, {"device": "cpu"}, register)
    assert got == _stream_overflow(JAX, {}, jax_register)
    assert got[:4] == [4, True, 1, 1]
    assert got[5]["watch_expired"] == 1 and got[-1] == 1


def test_stream_ingest_torn_buffer_forces_restage():
    from tpusim_torch.stream import StreamSession

    session = StreamSession(port_api.synthetic_cluster(4), device="cpu")
    buf = port_events.WatchBuffer(maxsize=1, resource="pods")
    buf.emit(port_store.ADDED, port_api.make_pod("a", node_name="node-0"))
    assert session.ingest(buf) == 1
    buf.emit(port_store.ADDED, port_api.make_pod("b"))
    buf.emit(port_store.ADDED, port_api.make_pod("c"))  # overflows
    with pytest.raises(port_events.WatchExpiredError):
        session.ingest(buf)
    session.schedule([port_api.make_pod("d", milli_cpu=100)])
    assert session.restage_counts == {"watch_expired": 1}


# --- config 9 through the fabric alone (chip_smoke phase 30c) --------------

def test_config9_watch_cpu_shape_matches_jax_and_golden():
    params, chain, fold = chip_smoke.WATCH_STREAM["cpu"]
    register().reset()
    jax_register().reset()
    want = chip_smoke.watch_stream(JAX, **params)
    got = chip_smoke.watch_stream(PORT, device="cpu", **params)
    keys = ("placement_chain", "fold_chain", "decisions", "scheduled",
            "relists", "restages", "paths", "nodes")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert (got["placement_chain"], got["fold_chain"]) == (chain, fold)
    assert got["restages"] == {"cold_start": 1, "watch_expired": 1}
    assert register().watch_overflow.get("nodes") == 1


def test_watch_fed_stream_equals_direct_feed_without_a_tear():
    from tpusim_torch.simulator import run_stream_simulation

    params = dict(num_nodes=24, cycles=6, arrivals=16, evict_fraction=0.25,
                  seed=9)
    got = chip_smoke.watch_stream(PORT, device="cpu", **params)
    want = run_stream_simulation(device="cpu", **params)
    assert (got["placement_chain"], got["fold_chain"]) == (
        want["placement_chain"], want["fold_chain"])
    assert got["restages"] == {"cold_start": 1} and got["relists"] == 0
