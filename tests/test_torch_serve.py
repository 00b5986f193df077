"""The port's scenario fleet (tpusim_torch.serve) on the CPU: shape classes
against the JAX package's, the batcher and the admission queue, and the
fleet end to end, its placement hashes equal to the JAX package's
run_what_if on the same scenarios (full buckets, ghost-padded partial ones,
warm repeats), with deadlines, shedding, shutdown, worker death and a device
error, after tests/test_serve.py and tests/test_serve_chaos.py.

A scenario's result does not depend on the batch it rides in, so the JAX
package schedules every scenario of this file in one run_what_if call.
"""

import threading
import time

import numpy as np
import pytest

import tpusim.api.snapshot as jax_api
from tpusim.backends import placement_hash as jax_placement_hash
from tpusim.jaxe.whatif import run_what_if as jax_run_what_if
from tpusim.serve import ScenarioFleet as JaxFleet
from tpusim.serve import WhatIfRequest as JaxRequest
from tpusim.serve.request import _budget as jax_budget

import tpusim_torch.api.snapshot as port_api
from tpusim_torch import scan, whatif
from tpusim_torch.backends import placement_hash
from tpusim_torch.serve import (
    REJECT_DEADLINE,
    REJECT_INVALID,
    REJECT_QUEUE_FULL,
    REJECT_SHED,
    REJECT_SHUTDOWN,
    REJECT_UNKNOWN_SNAPSHOT,
    AdmissionQueue,
    PendingEntry,
    ScenarioFleet,
    ShapeClass,
    ShapeClassBatcher,
    WhatIfRequest,
)
from tpusim_torch.serve.request import _budget
from tpusim_torch.whatif import compile_count

APIS = {"jax": jax_api, "port": port_api}


def scenario(pkg, seed: int, num_nodes: int = 4, num_pods: int = 3):
    api = APIS[pkg]
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"s{seed}-n{i}",
                           milli_cpu=int(rng.choice([2000, 4000, 8000])),
                           memory=int(rng.choice([4, 8])) * 1024**3)
             for i in range(num_nodes)]
    pods = [api.make_pod(f"s{seed}-p{i}",
                         milli_cpu=int(rng.randint(100, 1500)),
                         memory=int(rng.randint(2**20, 2**30)))
            for i in range(num_pods)]
    return api.ClusterSnapshot(nodes=nodes), pods


# every scenario whose hash a test checks: (seed, nodes, pods)
SHAPES = [(10, 4, 3), (11, 4, 3), (12, 4, 3), (20, 4, 3), (21, 4, 3),
          (30, 4, 3), (32, 4, 3), (50, 6, 5), (51, 5, 7), (52, 8, 8)]


@pytest.fixture(scope="module")
def jax_hashes():
    """placement_hash of the JAX package's run_what_if, per shape."""
    results = jax_run_what_if([scenario("jax", *s) for s in SHAPES])
    return {s: jax_placement_hash(r.placements)
            for s, r in zip(SHAPES, results)}


def fleet(**kwargs):
    return ScenarioFleet(device="cpu", **kwargs)


def request(seed, num_nodes=4, num_pods=3, **kwargs):
    snap, pods = scenario("port", seed, num_nodes, num_pods)
    return WhatIfRequest(pods=pods, snapshot=snap, **kwargs)


# ---- shape classes ----------------------------------------------------------

def test_budget_matches_jax():
    sizes = list(range(0, 70)) + [100, 1000, 1025, 2000]
    assert [_budget(n) for n in sizes] == [jax_budget(n) for n in sizes]
    assert [_budget(n) for n in (1, 3, 4, 5, 8, 9, 100)] == \
        [4, 4, 4, 8, 8, 16, 128]


@pytest.mark.parametrize("shape", [(1, 3, 3), (2, 9, 17), (3, 1, 4)])
def test_shape_class_matches_jax(shape):
    port_sc = fleet().executor.stage(request(*shape))[1]
    snap, pods = scenario("jax", *shape)
    jax_sc = JaxFleet().executor.stage(JaxRequest(pods=pods,
                                                  snapshot=snap))[1]
    assert (port_sc.n_nodes, port_sc.n_pods, port_sc.axes) == \
        (jax_sc.n_nodes, jax_sc.n_pods, jax_sc.axes)


def test_same_class_across_sizes_within_budget():
    f = fleet()
    classes = {f.executor.stage(request(1, n, p))[1]
               for n, p in ((3, 3), (4, 4), (3, 4))}
    assert len(classes) == 1
    (sc,) = classes
    assert sc.n_nodes == 4 and sc.n_pods == 4


def test_shape_class_deterministic():
    f = fleet()
    sc_a = f.executor.stage(request(2))[1]
    sc_b = f.executor.stage(request(2))[1]
    assert sc_a == sc_b and hash(sc_a) == hash(sc_b)


# ---- the batcher (host only: fake entries, an injected clock) ----------------

SC_A = ShapeClass(n_nodes=4, n_pods=4, axes=())
SC_B = ShapeClass(n_nodes=8, n_pods=4, axes=())


def _entry(shape_class, plan_sig="sig", at=0.0):
    return PendingEntry(request=WhatIfRequest(pods=[port_api.make_pod("x")]),
                        staged=None, future=None, admitted_at=at,
                        shape_class=shape_class, plan_sig=plan_sig)


def test_batcher_fills_bucket_in_arrival_order():
    batcher = ShapeClassBatcher(bucket_size=3, clock=lambda: 0.0)
    entries = [_entry(SC_A) for _ in range(3)]
    assert batcher.add(entries[0]) is None
    assert batcher.add(entries[1]) is None
    bucket = batcher.add(entries[2])
    assert bucket is not None and bucket.entries == entries
    assert bucket.ghosts == 0 and batcher.pending() == 0


def test_batcher_distinct_keys_do_not_share_buckets():
    batcher = ShapeClassBatcher(bucket_size=2, clock=lambda: 0.0)
    assert batcher.add(_entry(SC_A)) is None
    assert batcher.add(_entry(SC_B)) is None
    assert batcher.add(_entry(SC_A, plan_sig="other")) is None
    assert batcher.pending() == 3
    full = batcher.add(_entry(SC_A))
    assert full is not None and full.key == (SC_A, "sig")


def test_batcher_deadline_flush_under_injected_clock():
    t = [0.0]
    batcher = ShapeClassBatcher(bucket_size=4, flush_after_s=0.5,
                                clock=lambda: t[0])
    batcher.add(_entry(SC_A, at=0.0))
    t[0] = 0.2
    batcher.add(_entry(SC_A, at=0.2))
    assert batcher.due() == []
    assert batcher.next_deadline() == pytest.approx(0.5)
    t[0] = 0.49
    assert batcher.due() == []
    t[0] = 0.5  # the oldest entry's deadline, not the newest's
    [bucket] = batcher.due()
    assert len(bucket.entries) == 2 and bucket.ghosts == 2
    assert batcher.due() == [] and batcher.next_deadline() is None


def test_batcher_flush_all_drains_everything():
    batcher = ShapeClassBatcher(bucket_size=4, clock=lambda: 0.0)
    batcher.add(_entry(SC_A))
    batcher.add(_entry(SC_B))
    assert len(batcher.flush_all()) == 2 and batcher.pending() == 0


def test_batcher_rejects_an_empty_bucket_size():
    with pytest.raises(ValueError, match="at least 1"):
        ShapeClassBatcher(bucket_size=0)


# ---- the admission queue ----------------------------------------------------

def test_queue_bounded_put_pop():
    q = AdmissionQueue(maxsize=2)
    assert q.put("a") and q.put("b")
    assert not q.put("c")  # full: reject, never block
    assert q.pop() == "a" and q.pop() == "b" and q.pop() is None


def test_queue_close_rejects_new_but_drains_held():
    q = AdmissionQueue(maxsize=4)
    q.put("a")
    q.close()
    assert not q.put("b")
    assert q.closed and q.pop() == "a" and len(q) == 0


def test_queue_pop_timed_wait_survives_racing_consumer():
    """A notify taken by a racing popper must not end a timed wait that
    has time left."""
    q = AdmissionQueue(8)
    got = []
    waiter = threading.Thread(target=lambda: got.append(q.pop(timeout=5.0)))
    waiter.start()
    time.sleep(0.05)
    for i in range(20):
        q.put(i)
        if q.pop(timeout=0.01) is None:
            break  # the waiter won one: it has its item
        time.sleep(0.002)
    if not got:
        q.put("final")
    waiter.join(timeout=10)
    assert got and got[0] is not None


def test_queue_pop_timeout_expires_only_at_the_deadline():
    q = AdmissionQueue(4)
    start = time.monotonic()
    assert q.pop(timeout=0.2) is None
    assert time.monotonic() - start >= 0.19
    assert q.pop() is None


def test_queue_offer_sheds_strictly_lower_priority_only():
    q = AdmissionQueue(2)
    q.put("a", priority=1)
    q.put("b", priority=0)
    assert q.offer("c", priority=0) == (False, None)
    admitted, victim = q.offer("d", priority=1)
    assert admitted and victim == "b"
    assert q.offer("e", priority=1) == (False, None)
    assert q.pop() == "a" and q.pop() == "d"


# ---- the fleet end to end -------------------------------------------------

def test_full_bucket_matches_jax(jax_hashes):
    shapes = [(10, 4, 3), (11, 4, 3)]
    responses = fleet(bucket_size=2, flush_after_s=60.0).run(
        [request(*s) for s in shapes])
    for resp, shape in zip(responses, shapes):
        assert resp.ok, resp.error
        assert resp.bucket_real == 2 and resp.bucket_ghosts == 0
        assert placement_hash(resp.result.placements) == jax_hashes[shape]


def test_ghost_padded_partial_bucket_matches_and_never_leaks(jax_hashes):
    req = request(12)
    [resp] = fleet(bucket_size=2, flush_after_s=60.0).run([req])
    assert resp.ok and resp.bucket_real == 1 and resp.bucket_ghosts == 1
    assert [p.pod.name for p in resp.result.placements] == \
        [p.name for p in req.pods]
    assert placement_hash(resp.result.placements) == jax_hashes[(12, 4, 3)]


def test_mixed_sizes_in_one_class_match_jax(jax_hashes):
    """Three shapes of one class (node and pod budgets 8) in one
    ghost-padded bucket of four: node and pod padding."""
    shapes = [(50, 6, 5), (51, 5, 7), (52, 8, 8)]
    responses = fleet(bucket_size=4, flush_after_s=60.0).run(
        [request(*s) for s in shapes])
    assert [(r.bucket_real, r.bucket_ghosts) for r in responses] == \
        [(3, 1)] * 3
    for resp, shape in zip(responses, shapes):
        assert resp.ok, resp.error
        assert placement_hash(resp.result.placements) == jax_hashes[shape]


def test_warm_repeat_builds_no_program(jax_hashes):
    shapes = [(20, 4, 3), (21, 4, 3)]
    f = fleet(bucket_size=2, flush_after_s=60.0)

    def load():
        return [request(*s, cache_key=f"k{i}") for i, s in enumerate(shapes)]

    cold = f.run(load())
    assert all(r.ok for r in cold) and not any(r.compile_cache_hit
                                               for r in cold)
    before = compile_count()
    warm = f.run(load())
    assert compile_count() == before, "a warm repeat built a program"
    assert all(r.compile_cache_hit for r in warm)
    stats = f.executor.stats
    assert stats["staged_hits"] >= 2 and stats["device_batch_hits"] >= 1
    assert stats["warm_hits"] == 1 and stats["traces"] == 1
    for a, b, shape in zip(cold, warm, shapes):
        assert placement_hash(a.result.placements) == \
            placement_hash(b.result.placements) == jax_hashes[shape]


def test_warm_program_takes_a_new_bucket_of_its_class(jax_hashes):
    """A second bucket of the same class, other content, no cache keys:
    the built program reloads its buffers and answers right."""
    f = fleet(bucket_size=2, flush_after_s=60.0)
    f.run([request(10), request(11)])
    before = compile_count()
    responses = f.run([request(20), request(21)])
    assert compile_count() == before
    assert all(r.compile_cache_hit for r in responses)
    assert [placement_hash(r.result.placements) for r in responses] == \
        [jax_hashes[(20, 4, 3)], jax_hashes[(21, 4, 3)]]


def test_snapshot_ref_and_rejections(jax_hashes):
    snap, pods = scenario("port", 30)
    f = fleet(bucket_size=2, flush_after_s=60.0)
    f.register_snapshot("base", snap)
    ok, missing, no_pods, no_nodes, neither = f.run([
        WhatIfRequest(pods=pods, snapshot_ref="base"),
        WhatIfRequest(pods=pods, snapshot_ref="nope"),
        WhatIfRequest(pods=[], snapshot_ref="base"),
        WhatIfRequest(pods=pods, snapshot=port_api.ClusterSnapshot(nodes=[])),
        WhatIfRequest(pods=pods),
    ])
    assert ok.ok and placement_hash(ok.result.placements) == \
        jax_hashes[(30, 4, 3)]
    assert missing.rejected == REJECT_UNKNOWN_SNAPSHOT
    assert no_pods.rejected == REJECT_INVALID
    assert no_nodes.rejected == REJECT_INVALID and "zero-node" in no_nodes.error
    assert neither.rejected == REJECT_INVALID


def test_queue_full_rejects_at_submit():
    f = fleet(bucket_size=4, flush_after_s=60.0, max_queue=2)
    futures = [f.submit(request(31)) for _ in range(3)]
    overflow = [fu for fu in futures if fu.done()]
    assert len(overflow) == 1
    assert overflow[0].result().rejected == REJECT_QUEUE_FULL
    f.drain()
    accepted = [fu.result() for fu in futures
                if fu.result().rejected is None]
    assert len(accepted) == 2 and all(r.ok for r in accepted)


def test_deadline_flush_with_injected_clock(jax_hashes):
    t = [0.0]
    f = fleet(bucket_size=4, flush_after_s=0.5, clock=lambda: t[0])
    future = f.submit(request(32))
    f.pump()
    assert not future.done()
    t[0] = 0.49
    f.pump()
    assert not future.done()
    t[0] = 0.51
    f.pump()
    resp = future.result()
    assert resp.ok and resp.bucket_ghosts == 3
    assert placement_hash(resp.result.placements) == jax_hashes[(32, 4, 3)]


def test_fleet_sheds_lowest_priority_on_saturation():
    f = fleet(bucket_size=2, max_queue=2)
    low = [f.submit(request(0, priority=0)) for _ in range(2)]
    flat = f.submit(request(0, priority=0))
    assert flat.result(timeout=5).rejected == REJECT_QUEUE_FULL
    high = f.submit(request(0, priority=1))
    assert low[0].result(timeout=5).rejected == REJECT_SHED
    f.drain()
    assert low[1].result(timeout=5).ok
    assert high.result(timeout=5).ok


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def test_deadline_expires_in_queue_before_staging():
    clock = Clock()
    f = fleet(bucket_size=2, clock=clock, deadline_s=5.0)
    aged = f.submit(request(1))
    patient = f.submit(request(1, deadline_s=100.0))
    clock.advance(10.0)
    f.drain()
    assert aged.result(timeout=5).rejected == REJECT_DEADLINE
    assert patient.result(timeout=5).ok


def test_deadline_expires_waiting_for_bucket_siblings():
    clock = Clock()
    f = fleet(bucket_size=2, clock=clock, deadline_s=5.0, flush_after_s=60.0)
    f1 = f.submit(request(2))
    f.pump()
    clock.advance(10.0)
    f2 = f.submit(request(2))
    f.pump()
    assert f1.result(timeout=5).rejected == REJECT_DEADLINE
    r2 = f2.result(timeout=5)
    assert r2.ok and r2.result is not None and r2.bucket_ghosts == 1


def test_stop_sweeps_dead_worker_leftovers():
    f = fleet(bucket_size=4, flush_after_s=60.0)
    futures = [f.submit(request(3)) for _ in range(3)]
    f._process_guarded(f.queue.pop())   # one entry waits in an open bucket
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    f._thread = dead  # the worker died without draining
    f.stop()
    for fu in futures:
        assert fu.done() and fu.result().rejected == REJECT_SHUTDOWN
    late = f.submit(request(3))
    assert late.result(timeout=5).rejected == REJECT_SHUTDOWN


def test_worker_thread_answers_and_stops_clean():
    f = fleet(bucket_size=2).start()
    with pytest.raises(RuntimeError, match="already started"):
        f.start()
    futures = [f.submit(request(3)) for _ in range(5)]
    f.stop()
    results = [fu.result(timeout=5) for fu in futures]
    assert all(r.ok or r.rejected == REJECT_SHUTDOWN for r in results)
    assert any(r.ok for r in results)


def test_worker_death_requeues_at_most_once(monkeypatch):
    f = fleet(bucket_size=1)
    calls = {"n": 0}
    orig = f.executor.stage

    def flaky(req):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("worker died mid-stage")
        return orig(req)

    monkeypatch.setattr(f.executor, "stage", flaky)
    fu = f.submit(request(6))
    f.drain()
    assert fu.result(timeout=5).ok and calls["n"] == 2


def test_worker_death_twice_resolves_with_error(monkeypatch):
    f = fleet(bucket_size=1)
    monkeypatch.setattr(
        f.executor, "stage",
        lambda req: (_ for _ in ()).throw(RuntimeError("boom")))
    fu = f.submit(request(6))
    f.drain()
    r = fu.result(timeout=5)
    assert r.error is not None and "boom" in r.error and r.result is None


def test_device_error_resolves_the_bucket_with_the_error(monkeypatch):
    """A fault of the batched program resolves every future of its bucket
    with the error; nothing answers on the host."""
    def broken(self):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(scan.BatchedScan, "run", broken)
    f = fleet(bucket_size=2, flush_after_s=60.0)
    responses = f.run([request(10), request(11), request(12)])
    for r in responses:
        assert not r.ok and r.result is None and r.rejected is None
        assert "illegal memory access" in r.error
    assert f.executor.stats["dispatches"] == 2


def test_unknown_provider_raises():
    with pytest.raises(KeyError):
        ScenarioFleet(provider="NoSuchProvider", device="cpu")


def test_policy_requests_share_a_bucket_and_match_what_if():
    """Requests under one policy object stage once and bucket together;
    their placements equal the port's run_what_if under the policy."""
    from tpusim_torch.engine.policy import decode_policy

    policy = decode_policy({
        "kind": "Policy", "apiVersion": "v1",
        "predicates": [{"name": "PodFitsResources"}],
        "priorities": [{"name": "MostRequestedPriority", "weight": 1}]})
    shapes = [(40, 4, 3), (41, 4, 3)]
    f = fleet(bucket_size=2, flush_after_s=60.0)
    responses = f.run([request(*s, policy=policy) for s in shapes])
    want = whatif.run_what_if([scenario("port", *s) for s in shapes],
                              policy=policy, device="cpu", route="scan")
    for resp, w in zip(responses, want):
        assert resp.ok and resp.bucket_ghosts == 0
        assert placement_hash(resp.result.placements) == \
            placement_hash(w.placements)


def test_host_bound_policy_is_rejected_unsupported():
    from tpusim_torch.engine.policy import ExtenderConfig, Policy

    policy = Policy(extender_configs=[ExtenderConfig(
        url_prefix="http://x", filter_verb="filter")])
    [resp] = fleet().run([request(1, policy=policy)])
    assert resp.rejected == "unsupported" and "host-bound" in resp.error


# ---- the CLI ----------------------------------------------------------------

def test_cli_serve(tmp_path, capsys):
    import json

    from tpusim_torch.cli import main

    podspec = tmp_path / "pods.json"
    podspec.write_text(json.dumps([{"name": "w", "num": 6, "pod": {
        "metadata": {"name": "w"}, "spec": {"containers": [{
            "name": "c", "resources": {"requests": {
                "cpu": "500m", "memory": "128Mi"}}}]}}}]))
    rc = main(["serve", "--synthetic-nodes", "4", "--podspec", str(podspec),
               "--requests", "6", "--bucket-size", "2", "--device", "cpu",
               "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("cold: 6/6 ok (0 rejected, 0 failed)")
    assert lines[1].startswith("warm 1: 6/6 ok")
    assert "compile_cache_hit 6/6" in lines[1]
    assert lines[2].startswith("fleet: ")


def test_cli_serve_needs_nodes(tmp_path, capsys):
    from tpusim_torch.cli import main

    podspec = tmp_path / "pods.json"
    podspec.write_text("[]")
    assert main(["serve", "--podspec", str(podspec), "--device", "cpu"]) == 2
    assert "no cluster nodes" in capsys.readouterr().err
