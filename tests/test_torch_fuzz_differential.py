"""The cross-feature placement differential (tests/test_fuzz_differential.py)
on the port, on the CPU: its generators' seeded clusters and feeds on the
provider, policy, preemption and volume-with-scalar-resources axes, each
run through the port's routes "auto", "scan" and "reference", must place
byte-identically to the JAX package's reference orchestrator (placements,
FitError messages and preemptions: the JAX file's `sig`).

The feeds are built once with the JAX package's API and handed to the port
as objects (to_obj/from_obj; a policy field by field), so both packages
read the same cluster. Ten seeds an axis run in tier-1.

The sharded leg: one spawn of 2 gloo ranks runs every provider-axis seed
on the scan route with TPUSIM_SHARDS=2 (the node-sharded scan), against
the same reference. The hybrid mesh leg, as the JAX file's: one spawn of
2 gloo ranks runs preemption-axis seeds through the preemption hybrid on a
1 x 2 node mesh (run_with_preemption(mesh=)), against the same reference.
Tolerance: exact.
"""

import dataclasses
import random

import pytest

from tpusim.simulator import run_simulation as jax_run

import tpusim_torch.engine.policy as port_policy
from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod
from tpusim_torch.simulator import run_simulation
from tpusim_torch.sharding import run_ranks
from test_fuzz_differential import (
    PROVIDERS,
    random_cluster,
    random_pods,
    random_policy,
    random_volume_cluster,
    random_volume_pods,
    sig,
)
import torch_mesh_workers as MW
import torch_shard_workers as SW

SEEDS = 10
ROUTES = ("auto", "scan", "reference")


def to_port_policy(obj):
    """A JAX package Policy (a tree of dataclasses) as the port's."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(port_policy, type(obj).__name__)
        return cls(**{f.name: to_port_policy(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port_policy(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_port_policy(v) for k, v in obj.items()}
    return obj


def feed(axis, seed):
    """(JAX snapshot, JAX pods, run_simulation keywords) of the axis's
    seed, drawn as the JAX file draws it."""
    if axis == "provider":
        rng = random.Random(1000 + seed)
        snapshot = random_cluster(rng)
        pods = random_pods(rng, rng.randint(20, 30))
        return snapshot, pods, {"provider": rng.choice(PROVIDERS)}
    if axis == "policy":
        rng = random.Random(2000 + seed)
        snapshot = random_cluster(rng)
        pods = random_pods(rng, rng.randint(15, 25))
        return snapshot, pods, {"policy": random_policy(rng)}
    if axis == "preemption":
        rng = random.Random(3000 + seed)
        snapshot = random_cluster(rng)
        for p in snapshot.pods:
            p.spec.priority = rng.randint(0, 5)
        pods = random_pods(rng, rng.randint(15, 20))
        for p in pods:
            p.spec.priority = rng.randint(0, 10)
        return snapshot, pods, {"enable_pod_priority": True}
    rng = random.Random(4000 + seed)
    snapshot = random_volume_cluster(rng)
    pods = random_volume_pods(rng, rng.randint(12, 20), len(snapshot.pvcs))
    return snapshot, pods, {}


def port_feed(snapshot, pods, kw):
    kw = dict(kw)
    if "policy" in kw:
        kw["policy"] = to_port_policy(kw["policy"])
    return (ClusterSnapshot.from_obj(snapshot.to_obj()),
            [Pod.from_obj(p.to_obj()) for p in pods], kw)


@pytest.mark.parametrize("seed", range(SEEDS))
@pytest.mark.parametrize("axis", ["provider", "policy", "preemption",
                                  "volume_scalar"])
def test_fuzz_parity(axis, seed, monkeypatch):
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    snapshot, pods, kw = feed(axis, seed)
    want = sig(jax_run(list(pods), snapshot, backend="reference", **kw))
    for route in ROUTES:
        psnap, ppods, pkw = port_feed(snapshot, pods, kw)
        if route == "reference":
            status = run_simulation(ppods, psnap, backend="reference", **pkw)
        else:
            status = run_simulation(ppods, psnap, backend="torch",
                                    device="cpu", route=route, **pkw)
        assert sig(status) == want, f"{axis} seed {seed} route {route}"


@pytest.fixture(scope="module")
def sharded():
    """Every provider-axis seed through the 2-rank sharded scan route."""
    feeds = []
    for seed in range(SEEDS):
        snapshot, pods, kw = feed("provider", seed)
        feeds.append((snapshot.to_obj(), [p.to_obj() for p in pods],
                      kw["provider"]))
    return run_ranks(SW.differential_rank, 2, (feeds,), timeout=180)


@pytest.mark.parametrize("seed", range(SEEDS))
def test_fuzz_provider_parity_sharded(sharded, seed):
    snapshot, pods, kw = feed("provider", seed)
    want = sig(jax_run(list(pods), snapshot, backend="reference", **kw))
    for rank in sharded:
        placed, failed, preempted, batches = rank[seed]
        assert (placed, failed, preempted) == tuple(want), f"seed {seed}"
        assert batches >= 1


# seeds 2, 3 and 6 preempt; 4 fails pods without a victim
HYBRID_SEEDS = (2, 3, 4, 6)


@pytest.fixture(scope="module")
def hybrid_mesh():
    """Preemption-axis seeds through the hybrid on a 2-rank node mesh."""
    feeds = []
    for seed in HYBRID_SEEDS:
        snapshot, pods, _ = feed("preemption", seed)
        feeds.append((snapshot.to_obj(), [p.to_obj() for p in pods]))
    return run_ranks(MW.hybrid_rank, 2, (feeds,), timeout=180)


@pytest.mark.parametrize("seed", HYBRID_SEEDS)
def test_fuzz_preemption_parity_on_a_node_mesh(hybrid_mesh, seed):
    snapshot, pods, kw = feed("preemption", seed)
    want = sig(jax_run(list(pods), snapshot, backend="reference", **kw))
    for rank in hybrid_mesh:
        got = rank[HYBRID_SEEDS.index(seed)]
        assert got == tuple(want), f"seed {seed}"
    assert want[1] and (want[2] or seed == 4)
