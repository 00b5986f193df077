"""The port's IncrementalCluster (tpusim_torch/delta.py) against the JAX
package's (tpusim/jaxe/delta.py) under Node, Service, PersistentVolume and
PersistentVolumeClaim events and the delta journal, on the CPU.

One seeded event sequence runs on both packages' clusters; after each step
the compiled columns of the same pod batch must be equal (every array
bit-equal, every flag equal), with and without the NoExecute and
ServiceAffinity tables a policy asks for, and equal to a fresh
compile_cluster of the port's own snapshot (the equivalence contract). The
journals (touched node rows, presence cells, label- and taint-only nodes)
must be equal too, and the mark brackets behave as the JAX package's.
"""

import pytest

import tpusim.api.snapshot as jax_api
import tpusim.api.types as jax_types
from tpusim.framework import store as jax_store
from tpusim.jaxe.delta import IncrementalCluster as JaxIncremental

import tpusim_torch.api.snapshot as port_api
import tpusim_torch.api.types as port_types
from tpusim_torch import state as pstate
from tpusim_torch.delta import IncrementalCluster
from tpusim_torch.framework import store as port_store
from tpusim_torch.workloads import build_workload
from test_torch_preempt import assert_cols_equal, assert_compiled_equal

JAX = (jax_api, jax_types, jax_store, JaxIncremental)
PORT = (port_api, port_types, port_store, IncrementalCluster)


def steps(api, types, store):
    """The event sequence, as (label, [(event type, object)]) steps, on a
    12-node slice of config 4's shape; returns (snapshot, feed, steps)."""
    snapshot, pods = build_workload(60, 12, affinity=True, seed=11, api=api)
    feed = pods[30:]
    nodes = snapshot.nodes

    def relabel(i, **labels):
        node = nodes[i].copy()
        node.metadata.labels = {**node.metadata.labels, **labels}
        return node

    def taint(i):
        node = nodes[i].copy()
        node.spec.taints = [types.Taint(key="dedicated", value="batch",
                                        effect="NoSchedule")]
        return node

    def bind(pod, node):
        bound = pod.copy()
        bound.spec.node_name = node
        return bound

    bigger = api.make_node(nodes[0].name, milli_cpu=64000,
                           labels=dict(nodes[0].metadata.labels))
    svc = types.Service.from_obj({"metadata": {"name": "web"},
                                  "spec": {"selector": {"app": "web"}}})
    web = [bind(p, nodes[i % 12].name) for i, p in enumerate(pods[:6])]
    for p in web:
        p.metadata.labels = {"app": "web"}
    pv = api.make_pv("pv-0", labels={
        "failure-domain.beta.kubernetes.io/zone": "z1"},
        source={"gcePersistentDisk": {"pdName": "d0"}})
    pvc = api.make_pvc("claim-0", volume_name="pv-0")
    out = [
        ("bind", [(store.ADDED, p) for p in web]),
        ("label only", [(store.MODIFIED, relabel(3, tier="gold"))]),
        ("taint only", [(store.MODIFIED, taint(5))]),
        ("node added", [(store.ADDED, api.make_node(
            "extra-0", milli_cpu=8000, labels={"tier": "gold"}))]),
        ("node resized", [(store.MODIFIED, bigger)]),
        ("node deleted", [(store.DELETED, nodes[2])]),
        ("service added", [(store.ADDED, svc)]),
        ("pv and pvc added", [(store.ADDED, pv), (store.ADDED, pvc)]),
        ("evict", [(store.DELETED, web[0]), (store.DELETED, web[3])]),
        ("pvc and service deleted", [(store.DELETED, pvc),
                                     (store.DELETED, svc)]),
        ("pv deleted", [(store.DELETED, pv)]),
    ]
    return snapshot, feed, out


def journal(inc):
    return (set(inc._journal_nodes), set(inc._journal_presence),
            set(inc._journal_node_columns))


@pytest.mark.parametrize("need", [(False, False), (True, True)],
                         ids=["provider", "policy_tables"])
def test_events_match_jax_after_every_step(need):
    jsnap, jfeed, jsteps = steps(*JAX[:3])
    psnap, pfeed, psteps = steps(*PORT[:3])
    jinc, pinc = JaxIncremental(jsnap), IncrementalCluster(psnap)
    need_noexec, need_saa = need
    for (label, jev), (_, pev) in zip(jsteps, psteps):
        jinc.apply_events(jev)
        pinc.apply_events(pev)
        assert journal(pinc) == journal(jinc), label
        assert pinc._groups_dirty == jinc._groups_dirty, label
        if label in ("label only", "taint only"):
            assert pinc._journal_node_columns, label
        jc, jcols = jinc.compile(jfeed, need_noexec=need_noexec,
                                 need_saa=need_saa)
        pc, pcols = pinc.compile(pfeed, need_noexec=need_noexec,
                                 need_saa=need_saa)
        assert_compiled_equal(pc, jc)
        assert_cols_equal(pcols, jcols)
        assert (pc.has_noexec_table, pc.has_saa_table) == need
        fc, fcols = pstate.compile_cluster(pinc.to_snapshot(), pfeed,
                                           need_noexec=need_noexec,
                                           need_saa=need_saa)
        assert_compiled_equal(pc, fc)
        assert_cols_equal(pcols, fcols)
        assert pinc.drain_column_journal() == jinc.drain_column_journal()
        assert [n.name for n in pinc.nodes] == [n.name for n in jinc.nodes]
    assert "extra-0" in pinc._node_index and len(pinc.nodes) == 12


def test_journal_brackets_match_jax():
    results = []
    for api, types, store, cls in (JAX, PORT):
        snap, feed, _ = steps(api, types, store)
        inc = cls(snap)
        inc.compile(feed)
        inc.drain_journal()

        def bind(pod, i):
            b = pod.copy()
            b.spec.node_name = inc.nodes[i].name
            inc.apply(store.ADDED, b)

        bind(feed[0], 1)
        mark = inc.journal_mark()
        with pytest.raises(RuntimeError, match="exclusive"):
            inc.journal_mark()
        bind(feed[1], 4)
        bind(feed[2], 7)
        grown = journal(inc)
        inc.journal_rollback(mark)
        rolled = journal(inc)
        inc.journal_mark()
        bind(feed[3], 9)
        inc.journal_release()
        released = journal(inc)
        drained = inc.drain_journal()
        cols = inc.drain_column_journal()
        group_ok = inc.assign_group_ids(inc._batch_columns(feed[4:8])[0],
                                        feed[4:8])
        results.append((grown, rolled, released, drained, cols, group_ok,
                        journal(inc)))
    assert results[0] == results[1]
    grown, rolled, released, drained, _, group_ok, empty = results[1]
    assert grown[0] == {1, 4, 7} and rolled[0] == {1}
    assert released[0] == {1, 9} and drained[0] == {1, 9}
    assert group_ok and empty == (set(), set(), set())
