"""The port's mesh layer (tpusim_torch/sharding.py) against the JAX
package's (tpusim/jaxe/sharding.py) on the same inputs, on the CPU.

The factoring errors word for word; mesh_kind on both kinds and its error;
match_partition_rules, scenario_specs and the node, scenario and snapshot
shardings as partition specs (the port's tuples against the JAX
PartitionSpecs); pad_node_axis and pad_carry_node_axis array for array; and
in one spawn of 4 gloo ranks, the meshes make_mesh and make_scenario_mesh
build and each rank's blocks from shard_for_mesh against the shards the
JAX package places on a 4-device mesh (the virtual CPU devices).
Tolerance: exact.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import tpusim.api.snapshot as jax_api
from tpusim.jaxe import ensure_x64
from tpusim.jaxe import kernels as jk
from tpusim.jaxe import sharding as js
from tpusim.jaxe import state as jstate

from tpusim_torch import scan, sharding
import torch_shard_workers as SW

ensure_x64()
WORLD = 4


def as_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("n,snap", [(8, 3), (6, 4), (4, 0), (5, 2), (7, 7 * 2)])
def test_make_mesh_factoring_error(n, snap):
    with pytest.raises(ValueError) as want:
        js.make_mesh(n, snap=snap)
    with pytest.raises(ValueError) as got:
        sharding.make_mesh(devices=list(range(n)), snap=snap)
    assert str(got.value) == str(want.value)
    assert "valid snap counts" in str(got.value)


@pytest.mark.parametrize("n,scenario", [(8, 3), (6, 4), (7, 2), (8, 16)])
def test_make_scenario_mesh_factoring_error(n, scenario):
    with pytest.raises(ValueError) as want:
        js.make_scenario_mesh(n, scenario=scenario)
    with pytest.raises(ValueError) as got:
        sharding.make_scenario_mesh(devices=list(range(n)),
                                    scenario=scenario)
    assert str(got.value) == str(want.value)


def test_mesh_kind_error():
    names = ("data", "model")
    with pytest.raises(ValueError) as want:
        js.mesh_kind(Mesh(np.array(jax.devices()[:4]).reshape(2, 2), names))
    with pytest.raises(ValueError) as got:
        sharding.mesh_kind(SimpleNamespace(mesh_dim_names=names))
    assert str(got.value) == str(want.value)


RULES = [
    ((r"^statics/alloc", ("node",)), (r"/presence", (None, "node"))),
    ((r"cpu$", ("snap", "node")), (r".*", ("scenario",))),
    (),
]


@pytest.mark.parametrize("rules", RULES, ids=["prefix", "catchall", "none"])
@pytest.mark.parametrize("prefix", ["", "statics", "carry"])
def test_match_partition_rules(rules, prefix):
    fields = list(scan.STATICS_AXES) + list(scan.CARRY_AXES)
    want = js.match_partition_rules(
        [(pat, jax.sharding.PartitionSpec(*spec)) for pat, spec in rules],
        fields, prefix)
    got = sharding.match_partition_rules(rules, fields, prefix)
    assert got == {k: as_tuple(v) for k, v in want.items()}


def test_scenario_specs_and_shardings():
    for got, want in zip(sharding.scenario_specs(), js.scenario_specs()):
        assert type(got).__name__ == type(want).__name__
        assert tuple(got) == tuple(as_tuple(s) for s in want)
    mesh = js.make_scenario_mesh(4)
    port_mesh = SimpleNamespace(mesh_dim_names=("scenario", "node"))
    for got, want in zip(sharding.scenario_shardings(port_mesh),
                         js.scenario_shardings(mesh)):
        assert [s.spec for s in got] == [as_tuple(w.spec) for w in want]
        assert all(s.mesh is port_mesh for s in got)


def test_node_and_snap_shardings():
    mesh = js.make_mesh(4, snap=2)
    port_mesh = SimpleNamespace(mesh_dim_names=("snap", "node"))
    for got, want in zip(sharding.node_shardings(port_mesh),
                         js.node_shardings(mesh)):
        assert type(got).__name__ == type(want).__name__
        assert [s.spec for s in got] == [as_tuple(w.spec) for w in want]
    got, want = sharding.snap_shardings(port_mesh), js.snap_shardings(mesh)
    for g, w in zip(got[:2], want[:2]):
        assert [s.spec for s in g] == [as_tuple(x.spec) for x in w]
    assert got[2].spec == as_tuple(want[2].spec)


def jax_host_inputs(name):
    build, _policy = SW.scan_cases()[name]
    snapshot, pods = build(jax_api)
    compiled, cols = jstate.compile_cluster(snapshot, pods)
    return (jk.statics_to_host(compiled), jk.carry_init_host(compiled),
            jk.pod_columns_to_host(cols))


def assert_trees_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(want._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("n_shards", [2, 4, 8, 37])
def test_pad_node_axis(n_shards):
    _config, carry, statics, _xs = SW.host_inputs("groups")
    jst, jca, _jxs = jax_host_inputs("groups")
    st, ca, n = sharding.pad_node_axis(statics, carry, n_shards)
    wst, wca, wn = js.pad_node_axis(jst, jca, n_shards)
    assert n == wn == SW.NODES
    assert_trees_equal(st, wst)
    assert_trees_equal(ca, wca)
    assert_trees_equal(sharding.pad_carry_node_axis(carry, n_shards),
                       js.pad_carry_node_axis(jca, n_shards))


def test_stage_tree_whole():
    _config, carry, statics, xs = SW.host_inputs("groups")
    for tree, index in ((statics, True), (carry, False), (xs, True)):
        got = sharding.stage_tree(tree, None, "cpu", index=index)
        want = scan.tree_to(tree, "cpu", index=index)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.equal(w)


@pytest.fixture(scope="module")
def ranks():
    return sharding.run_ranks(SW.mesh_rank, WORLD, timeout=120)


@pytest.mark.parametrize("name,kind,names,shape", [
    ("node", "snap", ("snap", "node"), (1, 4)),
    ("snap2", "snap", ("snap", "node"), (2, 2)),
    ("scenario", "scenario", ("scenario", "node"), (4, 1)),
    ("scenario2", "scenario", ("scenario", "node"), (2, 2)),
    ("first2", "snap", ("snap", "node"), (1, 2)),
])
def test_meshes(ranks, name, kind, names, shape):
    jax_mesh = {"node": js.make_mesh(4), "snap2": js.make_mesh(4, snap=2),
                "scenario": js.make_scenario_mesh(4),
                "scenario2": js.make_scenario_mesh(4, scenario=2),
                "first2": js.make_mesh(2)}[name]
    assert js.mesh_kind(jax_mesh) == kind
    assert tuple(jax_mesh.axis_names) == names
    assert tuple(jax_mesh.devices.shape) == shape
    for rank, got in enumerate(ranks):
        g_kind, g_names, g_shape, coord = got["meshes"][name]
        assert (g_kind, g_names, g_shape) == (kind, names, shape)
        if rank < int(np.prod(shape)):
            assert tuple(coord) == tuple(
                int(c) for c in np.argwhere(
                    np.arange(int(np.prod(shape))).reshape(shape) == rank)[0])
        assert got["cached"]


@pytest.mark.parametrize("tree", ["statics", "carry", "xs"])
def test_shard_for_mesh_blocks(ranks, tree):
    """Each rank's block is the shard the JAX package places on the device
    at its node coordinate of a (1, 4) mesh."""
    mesh = js.make_mesh(WORLD)
    st, ca, xs = js.shard_for_mesh(mesh, *jax_host_inputs("groups"))
    which = {"statics": (0, st), "carry": (1, ca), "xs": (2, xs)}[tree]
    devices = list(mesh.devices.reshape(-1))
    for rank, got in enumerate(ranks):
        block = got["blocks"][which[0]]
        for name, arr in which[1]._asdict().items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[rank])
            want = np.asarray(shard.data)
            assert block[name].shape == want.shape, name
            assert np.array_equal(block[name], want), name
