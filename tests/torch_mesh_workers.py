"""What the ranks of the scenario-mesh tests run (tests/test_torch_scenario_
mesh.py, tests/test_torch_scenario_mesh_cuda.py and the hybrid leg of
tests/test_torch_fuzz_differential.py): module-level functions that
sharding.run_ranks spawns by name, one process a rank under a gloo group.
They import the port alone and return plain values; the parent test holds
them against the single-device runs of the port and of the JAX package.

The scenario builders take a package name ("port" or "jax") and build the
same cluster with that package's API; only the parent asks for "jax".
The scenarios are the JAX package's mesh tests': tests/test_whatif.py's
provider and ServiceAffinity scenarios and tests/multihost_worker.py's
group-bound one.
"""

from __future__ import annotations

import os
import time

import numpy as np


def _apis(pkg: str):
    if pkg == "jax":
        import tpusim.api.snapshot as api
        import tpusim.api.types as types
    else:
        import tpusim_torch.api.snapshot as api
        import tpusim_torch.api.types as types
    return api, types


def scenario(pkg, seed, num_nodes, num_pods):
    """tests/test_whatif.py's scenario: taints, zone selectors, random
    byte-granular memory."""
    api, _ = _apis(pkg)
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(num_nodes):
        taints = ([{"key": "dedicated", "value": "batch",
                    "effect": "NoSchedule"}] if i % 4 == 0 else None)
        nodes.append(api.make_node(
            f"s{seed}-n{i}", milli_cpu=int(rng.choice([2000, 4000, 8000])),
            memory=int(rng.choice([4, 8, 16])) * 1024**3,
            labels={"zone": f"z{i % 3}"}, taints=taints))
    pods = []
    for i in range(num_pods):
        kwargs = {}
        if i % 3 == 0:
            kwargs["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                      "value": "batch", "effect": "NoSchedule"}]
        if i % 5 == 0:
            kwargs["node_selector"] = {"zone": f"z{i % 3}"}
        pods.append(api.make_pod(f"s{seed}-p{i}",
                                 milli_cpu=int(rng.randint(100, 1500)),
                                 memory=int(rng.randint(2**20, 2**30)),
                                 **kwargs))
    return api.ClusterSnapshot(nodes=nodes), pods


def _port_pod(types, name, port, milli_cpu=100):
    return types.Pod.from_obj({
        "metadata": {"name": name, "namespace": "default", "uid": name,
                     "labels": {}},
        "spec": {"containers": [{
            "name": "c", "ports": [{"hostPort": port}],
            "resources": {"requests": {"cpu": f"{milli_cpu}m"}}}]},
        "status": {}})


def group_scenario(pkg, seed):
    """tests/multihost_worker.py's group-bound scenario: Services and
    spreading, inter-pod (anti)affinity, host ports and volumes, so the
    collectives cover the presence scatters and topology-domain sums."""
    api, types = _apis(pkg)
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"s{seed}-n{i}",
                           milli_cpu=int(rng.choice([2000, 4000])),
                           memory=int(rng.choice([4, 8])) * 1024**3,
                           labels={"zone": f"z{i % 3}",
                                   "kubernetes.io/hostname": f"s{seed}-n{i}"})
             for i in range(10)]
    services = [types.Service.from_obj(
        {"metadata": {"name": f"s{seed}-svc", "namespace": "default"},
         "spec": {"selector": {"app": "a0"}}})]
    placed = [api.make_pod(f"s{seed}-seed", milli_cpu=100,
                           node_name=f"s{seed}-n0", phase="Running",
                           labels={"app": "a0"})]
    pods = []
    for i in range(20):
        kwargs = {"labels": {"app": f"a{i % 2}"}}
        if i % 4 == 0:
            kwargs["node_selector"] = {"zone": f"z{i % 3}"}
        if i % 5 == 1:
            kwargs["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": "a0"}},
                    "topologyKey": "zone"}]}}
        elif i % 5 == 3:
            kwargs["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": f"a{i % 2}"}},
                    "topologyKey": "kubernetes.io/hostname"}]}}
        if i % 6 == 2:
            kwargs["volumes"] = [api.make_pod_volume(
                "d", source={"gcePersistentDisk": {"pdName": f"pd{i // 6}"}})]
        pods.append(api.make_pod(f"s{seed}-p{i}",
                                 milli_cpu=int(rng.randint(100, 1500)),
                                 memory=int(rng.randint(2**20, 2**30)),
                                 **kwargs))
    pods.append(_port_pod(types, f"s{seed}-pp0", 9090))
    pods.append(_port_pod(types, f"s{seed}-pp1", 9090))
    return api.ClusterSnapshot(nodes=nodes, pods=placed,
                               services=services), pods


# tests/test_whatif.py's ServiceAffinity policy, as the policy file's JSON
SA_POLICY = {
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "ByZone", "argument": {"serviceAffinity": {
        "labels": ["zone"]}}}, {"name": "PodFitsResources"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}


def sa_scenario(pkg, seed):
    """tests/test_whatif.py's ServiceAffinity scenario: a seed pod of the
    service locks the zone its later pods must follow."""
    api, types = _apis(pkg)
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"s{seed}-n{i}", milli_cpu=6000,
                           labels={"zone": f"z{i % 3}"}) for i in range(9)]
    svc = types.Service.from_obj(
        {"metadata": {"name": f"s{seed}-db", "namespace": "default"},
         "spec": {"selector": {"app": "db"}}})
    placed = [api.make_pod(f"s{seed}-seeddb", milli_cpu=100,
                           node_name=f"s{seed}-n{seed % 3}",
                           phase="Running", labels={"app": "db"})]
    pods = [api.make_pod(f"s{seed}-p{i}",
                         milli_cpu=int(rng.randint(100, 800)),
                         labels={"app": "db" if i % 2 else "web"})
            for i in range(10)]
    return api.ClusterSnapshot(nodes=nodes, pods=placed,
                               services=[svc]), pods


def provider_scenarios(pkg):
    """tests/test_whatif.py's three mesh scenarios; the second ends with
    its test_counts pod, bigger than every node, so a FitError text is
    compared."""
    out = [scenario(pkg, 10, 16, 10), scenario(pkg, 11, 9, 6),
           scenario(pkg, 12, 24, 12)]
    out[1][1].append(_apis(pkg)[0].make_pod("impossible", milli_cpu=10**9,
                                            memory=2**50))
    return out


# name -> (scenarios(pkg), policy JSON or None). "provider" has 3
# scenarios, so a mesh of 2 rows pads one replica.
WHATIF_CASES = {
    "provider": (provider_scenarios, None),
    "groups": (lambda pkg: [group_scenario(pkg, s) for s in (1, 2, 3)],
               None),
    "service_affinity": (lambda pkg: [sa_scenario(pkg, 50),
                                      sa_scenario(pkg, 51)], SA_POLICY),
}

# the layouts each rank count runs: (kind, rows, node ranks)
MESHES = {2: (("scenario", 2, 1), ("snap", 2, 1), ("snap", 1, 2)),
          4: (("scenario", 4, 1), ("scenario", 2, 2), ("snap", 2, 2))}


def mesh_name(kind, rows, nodes) -> str:
    return f"{kind} {rows}x{nodes}"


def policy_of(policy_json, pkg="port"):
    if policy_json is None:
        return None
    if pkg == "jax":
        from tpusim.engine.policy import decode_policy
    else:
        from tpusim_torch.engine.policy import decode_policy
    return decode_policy(policy_json)


def results_key(results):
    """Every scenario's placements (pod, node, FitError text) and counts."""
    return [([(p.pod.name, p.node_name, p.message) for p in r.placements],
             r.scheduled, r.unschedulable) for r in results]


def single_what_if(name, device="cpu"):
    """The port's single-device run_what_if of a case, batched scan."""
    from tpusim_torch.whatif import run_what_if

    build, policy = WHATIF_CASES[name]
    return results_key(run_what_if(build("port"), policy=policy_of(policy),
                                   device=device, route="scan"))


def build_mesh(kind, rows, nodes, device="cpu"):
    from tpusim_torch import sharding

    dtype = "cuda" if device == "cuda" else "cpu"
    if kind == "snap":
        return sharding.make_mesh(rows * nodes, snap=rows, device_type=dtype)
    return sharding.make_scenario_mesh(rows * nodes, scenario=rows,
                                       device_type=dtype)


def _what_ifs(world, device="cpu"):
    """Every case on every layout of this rank count: (results, the
    programs built a layout by kind, the node all_reduces a layout)."""
    from tpusim_torch import scan, whatif

    out, built, collectives = {}, {}, {}
    for layout in MESHES[world]:
        mesh = build_mesh(*layout, device=device)
        before = dict(whatif._COMPILE_COUNTS)
        c0 = scan.collective_count()
        for name, (build, policy) in WHATIF_CASES.items():
            out[(name, mesh_name(*layout))] = results_key(whatif.run_what_if(
                build("port"), policy=policy_of(policy), mesh=mesh,
                device=device))
        built[mesh_name(*layout)] = {
            k: whatif._COMPILE_COUNTS[k] - before[k] for k in before}
        collectives[mesh_name(*layout)] = scan.collective_count() - c0
    return out, built, collectives


def _multihost(device="cpu"):
    """run_what_if_multihost with two ranks a machine (LOCAL_WORLD_SIZE=2):
    the group-bound scenarios."""
    from tpusim_torch.whatif import run_what_if_multihost

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        build, _ = WHATIF_CASES["groups"]
        return results_key(run_what_if_multihost(build("port"),
                                                 device=device))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


# the hybrid's workload: tests/test_jax_preempt.py's priority-banded one,
# cut from 400 pods on 10 nodes to 100 on 4 (3 preempted)
HYBRID_FEED = (100, 4, 41)


def hybrid_feed(pkg, num_pods=HYBRID_FEED[0], num_nodes=HYBRID_FEED[1],
                seed=HYBRID_FEED[2]):
    from tpusim_torch import workloads

    api, _ = _apis(pkg)
    return workloads.build_workload(num_pods, num_nodes, priorities=True,
                                    seed=seed, api=api)


def status_sig(status):
    """A Status's placements, failures with their FitError text, preempted
    pods and stop reason."""
    return {
        "success": [(p.name, p.spec.node_name)
                    for p in status.successful_pods],
        "failed": [(p.name, p.status.conditions[-1].message
                    if p.status.conditions else "")
                   for p in status.failed_pods],
        "preempted": sorted(p.name for p in status.preempted_pods),
        "stop": status.stop_reason,
    }


def single_hybrid(feed=HYBRID_FEED, device="cpu", victims="auto"):
    from tpusim_torch.preempt import run_with_preemption

    snap, pods = hybrid_feed("port", *feed)
    return status_sig(run_with_preemption(pods, snap, device=device,
                                          victims=victims))


def _hybrid(feeds, device="cpu", victims="auto"):
    """The hybrid on a 1 x world node mesh, each feed: its status and the
    hybrid's counts (the re-arms and chunks that ran on the mesh)."""
    from tpusim_torch import sharding
    from tpusim_torch.preempt import HYBRID_STATS, run_with_preemption

    mesh = sharding.make_mesh(device_type="cuda" if device == "cuda"
                              else "cpu")
    out = []
    for feed in feeds:
        snap, pods = hybrid_feed("port", *feed)
        before = dict(HYBRID_STATS)
        sig = status_sig(run_with_preemption(pods, snap, device=device,
                                             mesh=mesh, victims=victims))
        out.append((sig, {k: HYBRID_STATS[k] - before.get(k, 0)
                          for k in ("route_scan", "route_kernel", "rearms",
                                    "scan_calls")}))
    return out


def serve_scenario(pkg, seed, num_nodes=4, num_pods=3):
    """tests/test_serve.py's scenario."""
    api, _ = _apis(pkg)
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"s{seed}-n{i}",
                           milli_cpu=int(rng.choice([2000, 4000])),
                           memory=int(rng.choice([4, 8])) * 1024**3)
             for i in range(num_nodes)]
    pods = [api.make_pod(f"s{seed}-p{i}",
                         milli_cpu=int(rng.randint(100, 1500)),
                         memory=int(rng.randint(1, 512)) * 2**20)
            for i in range(num_pods)]
    return api.ClusterSnapshot(nodes=nodes), pods


SERVE_SEEDS = (40, 41, 42)


def serve_hashes(pkg="port", seeds=SERVE_SEEDS):
    """The single-device placement hash of each serve scenario."""
    if pkg == "jax":
        from tpusim.backends import get_backend, placement_hash

        backend = get_backend("jax")
    else:
        from tpusim_torch.backends import placement_hash
        from tpusim_torch.backend import TorchBackend

        backend = TorchBackend(device="cpu")
    return [placement_hash(backend.schedule(pods, snap))
            for snap, pods in (serve_scenario(pkg, s) for s in seeds)]


def _responses(responses):
    from tpusim_torch.backends import placement_hash

    return [(r.ok, r.bucket_real, r.bucket_ghosts, r.compile_cache_hit,
             placement_hash(r.result.placements) if r.ok else r.error)
            for r in responses]


def _serve(world, device="cpu"):
    """A scenario fleet on a world x 1 scenario mesh: a bucket size that
    does not divide over the ranks refused, then a cold and a warm pass of
    3 real scenarios in a bucket of 8 (5 ghosts), and the programs each
    pass built on this rank."""
    from tpusim_torch import sharding, whatif
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    mesh = sharding.make_scenario_mesh(
        device_type="cuda" if device == "cuda" else "cpu")
    out = {}
    try:
        ScenarioFleet(bucket_size=6 if world == 4 else 3, mesh=mesh,
                      device=device)
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    fleet = ScenarioFleet(bucket_size=8, flush_after_s=60.0, mesh=mesh,
                          device=device)
    for label in ("cold", "warm"):
        before = whatif.compile_count()
        requests = [WhatIfRequest(pods=p, snapshot=s, cache_key=f"q{i}")
                    for i, (s, p) in enumerate(
                        serve_scenario("port", seed) for seed in SERVE_SEEDS)]
        out[label] = _responses(fleet.run(requests))
        out[label + "_built"] = whatif.compile_count() - before
    fleet.stop()
    out["dispatches"] = fleet.executor.stats["dispatches"]
    return out


class SkewedClock:
    """A clock far ahead of time.monotonic that jumps a minute a read, so
    any partial bucket of its own would be due at once."""

    def __init__(self):
        self.t = time.monotonic() + 1e6

    def __call__(self):
        self.t += 60.0
        return self.t


def skewed_seeds(world):
    """A full bucket of `world` scenarios and one more."""
    return tuple(range(60, 61 + world))


def _skewed_serve(rank, world, device="cpu"):
    """Ranks past 0 run a skewed clock; rank 0's buckets (a full bucket of
    `world` and a partial one of 1, flushed at the drain) still decide
    what every rank dispatches."""
    from tpusim_torch import sharding
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    mesh = sharding.make_scenario_mesh(
        device_type="cuda" if device == "cuda" else "cpu")
    clock = SkewedClock() if rank > 0 else time.monotonic
    fleet = ScenarioFleet(bucket_size=world, flush_after_s=3600.0, mesh=mesh,
                          clock=clock, device=device)
    requests = [WhatIfRequest(pods=p, snapshot=s)
                for s, p in (serve_scenario("port", seed)
                             for seed in skewed_seeds(world))]
    responses = _responses(fleet.run(requests))
    fleet.stop()
    return {"responses": responses,
            "dispatches": fleet.executor.stats["dispatches"]}


def faulted_seeds(world):
    """Two full buckets of `world` scenarios."""
    return tuple(range(70, 70 + 2 * world))


def _faulted_serve(rank, world, device="cpu"):
    """Two fleet runs of two full buckets each on a world x 1 scenario
    mesh. In the first, rank 0's program build raises once, after it sent
    the first bucket; in the second, rank 1's does. Each run's first bucket
    fails on rank 0 (its members answer with the error) and its second
    runs, no rank waiting on another; rank 1's second run() raises its own
    error once rank 0's run ends."""
    import torch.distributed as dist

    from tpusim_torch import sharding
    from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

    mesh = sharding.make_scenario_mesh(
        device_type="cuda" if device == "cuda" else "cpu")
    fleet = ScenarioFleet(bucket_size=world, flush_after_s=3600.0, mesh=mesh,
                          device=device)
    executor = fleet.executor
    real = executor._program

    def failing_on(failing_rank):
        armed = [dist.get_rank() == failing_rank]

        def program(*args, **kwargs):
            if armed[0]:
                armed[0] = False
                raise RuntimeError(f"injected build failure on rank "
                                   f"{failing_rank}")
            return real(*args, **kwargs)
        return program

    out = {}
    for failing_rank in (0, 1):
        executor._program = failing_on(failing_rank)
        requests = [WhatIfRequest(pods=p, snapshot=s)
                    for s, p in (serve_scenario("port", seed)
                                 for seed in faulted_seeds(world))]
        try:
            out[failing_rank] = _responses(fleet.run(requests))
        except RuntimeError as exc:
            out[failing_rank] = str(exc)
    fleet.stop()
    out["dispatches"] = executor.stats["dispatches"]
    return out


def _disagreeing(rank, device="cpu"):
    """Rank 1's scenarios carry one pod more: every rank raises."""
    from tpusim_torch import sharding
    from tpusim_torch.whatif import run_what_if

    build, _ = WHATIF_CASES["provider"]
    scenarios = build("port")
    if rank == 1:
        scenarios[0][1].append(scenarios[0][1][0].copy())
    mesh = sharding.make_scenario_mesh(
        device_type="cuda" if device == "cuda" else "cpu")
    try:
        run_what_if(scenarios, mesh=mesh, device=device)
    except RuntimeError as exc:
        return str(exc)
    return None


def _refusals(world):
    """The mesh errors that need a group: route "kernel" on a what-if and a
    hybrid mesh, a snap mesh for serve, a scenario mesh for the hybrid, and
    a mesh naming a rank past the group."""
    from types import SimpleNamespace

    import torch

    from tpusim_torch import sharding
    from tpusim_torch.preempt import run_with_preemption
    from tpusim_torch.serve import ServeExecutor
    from tpusim_torch.whatif import run_what_if

    build, _ = WHATIF_CASES["provider"]
    snap_mesh = sharding.make_mesh()
    scen_mesh = sharding.make_scenario_mesh()
    far = SimpleNamespace(mesh_dim_names=("snap", "node"),
                          mesh=torch.tensor([[0, world + 3]]))
    hsnap, hpods = hybrid_feed("port", 20, 4, 1)
    calls = {
        "whatif_kernel": lambda: run_what_if(build("port"), mesh=snap_mesh,
                                             device="cpu", route="kernel"),
        "hybrid_kernel": lambda: run_with_preemption(
            hpods, hsnap, device="cpu", route="kernel", mesh=snap_mesh),
        "hybrid_scenario_mesh": lambda: run_with_preemption(
            hpods, hsnap, device="cpu", mesh=scen_mesh),
        "serve_snap_mesh": lambda: ServeExecutor(mesh=snap_mesh,
                                                 device="cpu"),
        "far_rank": lambda: run_what_if(build("port"), mesh=far,
                                        device="cpu"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def _vmapped_collectives(world):
    """One vmapped node reduction of a [3, 4, 2] batch: the sums and maxima
    it returns, and the all_reduces it issued (through scan's counter)."""
    import torch

    from tpusim_torch import scan, sharding

    mesh = sharding.make_mesh()
    shard = scan.mesh_shard(mesh, 2)._replace(vmapped=True)
    x = torch.arange(24, dtype=torch.int64).reshape(3, 4, 2) + 100 * \
        torch.distributed.get_rank()
    out = {}
    for op, fn in (("sum", scan._ax_sum), ("max", scan._ax_max)):
        c0 = scan.collective_count()
        got = torch.func.vmap(lambda t: fn(t.sum(1), shard))(x)
        out[op] = (got.tolist(), scan.collective_count() - c0)
    c0 = scan.collective_count()
    scan._ax_sum(x.sum(2), shard._replace(vmapped=False))
    out["plain"] = scan.collective_count() - c0
    return out


def scenario_mesh_rank(rank, world, device="cpu"):
    """Every scenario-mesh case of one rank count, on one rank."""
    out = {}
    out["whatif"], out["built"], out["collectives"] = _what_ifs(world, device)
    if world == 4:
        out["multihost"] = _multihost(device)
    if world == 2:
        out["hybrid"] = _hybrid([HYBRID_FEED], device)
    out["serve"] = _serve(world, device)
    out["skewed"] = _skewed_serve(rank, world, device)
    out["disagree"] = _disagreeing(rank, device)
    if device == "cpu":
        out["faulted"] = _faulted_serve(rank, world, device)
        out["refusals"] = _refusals(world)
        out["vmapped"] = _vmapped_collectives(world)
    return out


def hybrid_rank(rank, world, feeds):
    """The hybrid mesh leg of the fuzz differential: each feed (snapshot
    and pods as objects) through run_with_preemption on a node mesh of
    every rank: (placements, failures with their text, preempted pods)."""
    from tpusim_torch import sharding
    from tpusim_torch.api.snapshot import ClusterSnapshot
    from tpusim_torch.api.types import Pod
    from tpusim_torch.preempt import run_with_preemption

    mesh = sharding.make_mesh()
    out = []
    for snap_obj, pod_objs in feeds:
        sig = status_sig(run_with_preemption(
            [Pod.from_obj(o) for o in pod_objs],
            ClusterSnapshot.from_obj(snap_obj), device="cpu", mesh=mesh))
        out.append((sig["success"], sig["failed"], sig["preempted"]))
    return out
