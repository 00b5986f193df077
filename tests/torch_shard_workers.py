"""What the ranks of the node-sharded tests run (tests/test_torch_shard_*.py,
tests/test_torch_fuzz_differential.py): module-level functions that
sharding.run_ranks spawns by name, one process a rank under a gloo group.
They import the port alone and return numpy arrays and plain values; the
parent test holds them against the single-device route and the JAX
package. The workloads are tpusim_torch.workloads builders, which take
either package's API module.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np

NODES = 37    # a node count no shard count of the tests divides
PODS = 48


def scan_cases():
    """name -> (build(api) -> (snapshot, pods), policy dict or None): the
    plan families of the sharded scan's parity tests."""
    from tpusim_torch import workloads as W

    return {
        "provider": (lambda api: W.random_workload(
            0, PODS, NODES, num_scalars=1, infeasible=True, api=api), None),
        "groups": (lambda api: W.random_group_workload(
            20, PODS, NODES, ports=True, services=True, disk=True,
            vol_zone=True, api=api), None),
        "maxpd": (lambda api: W.random_group_workload(
            21, PODS, NODES, services=True, maxpd=True, api=api), None),
        "interpod": (lambda api: W.random_interpod_workload(
            31, PODS, NODES, services=True, ports=True, api=api), None),
        "policy": (lambda api: W.random_policy_workload(
            40, PODS, NODES, api=api), W.random_policy(
                40, count_mode=True, noexec=True, ports_alias=True,
                sa_entries=0)),
        "policy_interpod": (lambda api: W.random_policy_workload(
            41, PODS, NODES, interpod=True, api=api), W.random_policy(
                41, sa_entries=0)),
    }


def host_inputs(name):
    """The port's (config, carry, statics, xs) host trees of a scan case."""
    import tpusim_torch.api.snapshot as api
    from tpusim_torch import scan
    from tpusim_torch.backend import compile_inputs
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.policyc import compile_policy

    build, policy = scan_cases()[name]
    snapshot, pods = build(api)
    cp = compile_policy(decode_policy(policy)) if policy else None
    config, compiled, cols, ptabs = compile_inputs(snapshot, pods, False, 10,
                                                   cp)
    return (config,) + scan.scan_inputs_host(config, compiled, cols, ptabs)


def _numpy(tree):
    return {k: v.cpu().numpy() for k, v in tree._asdict().items()}


def single_scan(name, device="cpu", chunk=0):
    """The port's single-device scan of a case: (final carry, choices,
    counts, advanced) as numpy."""
    from tpusim_torch import scan

    config, carry, statics, xs = host_inputs(name)
    carry = scan.tree_to(carry, device)
    statics = scan.tree_to(statics, device, index=True)
    if chunk:
        final, *out = scan.schedule_scan_chunked(config, carry, statics, xs,
                                                 chunk)
    else:
        final, *out = scan.schedule_scan(config, carry, statics,
                                         scan.tree_to(xs, device, index=True))
    return (_numpy(final),
            *(o if isinstance(o, np.ndarray) else o.cpu().numpy()
              for o in out))


def gathered(results, n_real=NODES):
    """The ranks' sharded_scan results as one single-device result: (final
    carry put back together from the ranks' blocks, choices, counts,
    advanced). The outputs and the carry's replicated fields must be the
    same on every rank."""
    from tpusim_torch import scan

    out0, carry0 = results[0]
    for out, carry in results[1:]:
        for a, b in zip(out, out0):
            assert np.array_equal(a, b)
        for name, axes in scan.CARRY_AXES.items():
            if "node" not in axes:
                assert np.array_equal(carry[name], carry0[name]), name
    final = {}
    for name, axes in scan.CARRY_AXES.items():
        if "node" in axes:
            ax = axes.index("node")
            whole = np.concatenate([c[name] for _, c in results], axis=ax)
            final[name] = np.take(whole, np.arange(n_real), axis=ax)
        else:
            final[name] = carry0[name]
    return (final, *out0)


def sharded_scan(name, chunk=0, device="cpu"):
    """The node-sharded scan of a case on this rank: (choices, counts,
    advanced, this rank's final carry block)."""
    from tpusim_torch import scan, sharding

    config, carry, statics, xs = host_inputs(name)
    mesh = sharding.make_mesh(device_type=sharding.shard_device(device).type)
    st, ca, xs_d = sharding.shard_for_mesh(mesh, statics, carry, xs, device)
    fn = scan.sharded_scan_fn(replace(config, shard_axis="node"), mesh,
                              chunk=chunk)
    final, *out = fn(ca, st, xs if chunk else xs_d)
    out = [np.asarray(o) if isinstance(o, np.ndarray) else o.cpu().numpy()
           for o in out]
    return out, _numpy(final)


def backend_case(name, device="cpu", analytics_k=0):
    """TorchBackend(route="scan") on a case: the placement hash, the failed
    pods' FitError texts, the route and the tpusim_shard_* observations;
    with analytics_k > 0 an installed analytics plane's decoded sample and
    its check against host_reduce."""
    import tpusim_torch.api.snapshot as api
    from tpusim_torch.backend import TorchBackend, placement_hash
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import analytics
    from tpusim_torch.obs import recorder as flight

    build, policy = scan_cases()[name]
    snapshot, pods = build(api)
    backend = TorchBackend(route="scan", device=device,
                           policy=decode_policy(policy) if policy else None)
    m = register()
    fallback_before = dict(m.shard_fallback.values)
    rec = flight.install(flight.FlightRecorder())
    plane = None
    if analytics_k:
        plane = analytics.install(analytics.ClusterAnalytics(
            keep_inputs=True, sample_interval_s=0.0, top_k=analytics_k))
    try:
        placements = backend.schedule(pods, snapshot)
        sample = plane.latest() if plane is not None else None
        problems = plane.verify_against_host() if plane is not None else []
    finally:
        flight.uninstall()
        if plane is not None:
            analytics.uninstall()
    spans = sorted({ev["name"] for ev in list(rec.events)
                    if ev["name"].startswith("shard:")})
    if sample is not None:
        sample.pop("ts", None)
        sample.pop("seq", None)
    return {
        "hash": placement_hash(placements),
        "errors": [(p.pod.name, p.message) for p in placements
                   if not p.node_name],
        "route": backend.last_route,
        "shard_count": m.shard_count.value,
        "occupancy": dict(m.shard_node_occupancy.values),
        "bytes": m.shard_collective_bytes.value,
        "fallback": {k: v - fallback_before.get(k, 0)
                     for k, v in m.shard_fallback.values.items()
                     if v != fallback_before.get(k, 0)},
        "spans": spans,
        "sample": sample,
        "problems": problems,
    }


def doctored_backend(rank, name="provider", device="cpu"):
    """backend_case with rank 1's first pod asking for one more millicpu:
    the ranks' host digests differ, so every rank must raise."""
    import tpusim_torch.api.snapshot as api
    from tpusim_torch.backend import TorchBackend

    build, _ = scan_cases()[name]
    snapshot, pods = build(api)
    if rank == 1:
        obj = pods[0].to_obj()
        req = obj["spec"]["containers"][0].setdefault(
            "resources", {}).setdefault("requests", {})
        req["cpu"] = "1001m"
        pods[0] = api.Pod.from_obj(obj)
    try:
        TorchBackend(route="scan", device=device).schedule(pods, snapshot)
    except RuntimeError as exc:
        return str(exc)
    return None


def fallback_cases(device="cpu"):
    """The batches the sharded route declines inside a group: a
    ServiceAffinity policy, explain lanes, and a shard count the group's
    world size is not. reason -> (counted, route taken)."""
    import tpusim_torch.api.snapshot as api
    from tpusim_torch import workloads as W
    from tpusim_torch.backend import TorchBackend
    from tpusim_torch.engine.policy import decode_policy
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.obs import provenance

    snapshot, pods = W.random_policy_workload(42, 24, 11, api=api)
    m = register()
    out = {}

    def counted(reason, run):
        before = m.shard_fallback.values.get(reason, 0)
        backend = run()
        out[reason] = (m.shard_fallback.values.get(reason, 0) - before,
                       backend.last_route)

    def sa_policy():
        b = TorchBackend(route="scan", device=device, policy=decode_policy(
            W.random_policy(42, sa_entries=1)))
        b.schedule(pods, snapshot)
        return b

    def explain():
        provenance.install(provenance.ProvenanceLog(top_k=2))
        try:
            b = TorchBackend(route="scan", device=device)
            b.schedule(pods, snapshot)
        finally:
            provenance.uninstall()
        return b

    def world_mismatch():
        shards = os.environ["TPUSIM_SHARDS"]
        os.environ["TPUSIM_SHARDS"] = str(int(shards) + 1)
        try:
            b = TorchBackend(route="scan", device=device)
            b.schedule(pods, snapshot)
        finally:
            os.environ["TPUSIM_SHARDS"] = shards
        return b

    counted("service_affinity", sa_policy)
    counted("explain_lanes", explain)
    counted("device_count", world_mismatch)
    return out


# --- gang feeds (tests/test_gang.py's, as tests/test_torch_gang_driver.py)


def _cluster(api, num_nodes=6, racks=True, zones=False):
    nodes = []
    for i in range(num_nodes):
        labels = {}
        if racks:
            labels["topology.kubernetes.io/rack"] = f"rack-{i // 2}"
        if zones:
            labels["failure-domain.beta.kubernetes.io/region"] = "r1"
            labels["failure-domain.beta.kubernetes.io/zone"] = f"z{i // 3}"
        nodes.append(api.make_node(f"node-{i}", milli_cpu=4000,
                                   labels=labels))
    return api.ClusterSnapshot(nodes=nodes, pods=[])


def _gang(api, grp, name, size, milli_cpu=1000, min_available=0):
    return [grp.mark_gang(api.make_pod(f"{name}-{i}", milli_cpu=milli_cpu),
                          name, min_available=min_available)
            for i in range(size)]


GANG_FEEDS = {
    "mixed": lambda api, grp: (
        [api.make_pod("s0", milli_cpu=100)] + _gang(api, grp, "g", 4)
        + [api.make_pod(f"s{i}", milli_cpu=100) for i in (1, 2)]
        + _gang(api, grp, "big", 8, milli_cpu=3900), _cluster(api)),
    "min_available": lambda api, grp: (
        _gang(api, grp, "part", 8, milli_cpu=3900, min_available=4),
        _cluster(api)),
    "rank_aware": lambda api, grp: (
        _gang(api, grp, "g", 4, milli_cpu=500),
        _cluster(api, num_nodes=11, racks=True, zones=True)),
}


def gang_split(name, device="cpu"):
    """A gang feed through run_simulation(backend="torch", route="scan"):
    (placed (pod, node), failed (pod, message)) and the shard:gang_lanes
    spans recorded."""
    import tpusim_torch.api.snapshot as api
    from tpusim_torch.gang import group as grp
    from tpusim_torch.obs import recorder as flight
    from tpusim_torch.simulator import run_simulation

    pods, snapshot = GANG_FEEDS[name](api, grp)
    rec = flight.install(flight.FlightRecorder())
    try:
        status = run_simulation(pods, snapshot, backend="torch",
                                device=device, route="scan")
    finally:
        flight.uninstall()
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods],
            sum(ev["name"] == "shard:gang_lanes" for ev in list(rec.events)))


def lanes_and_reduce(seed, device="cpu"):
    """gang_lanes_sharded and analytics_reduce_sharded on a case's inputs,
    each with the whole padded result every rank gets."""
    import torch

    from tpusim_torch import scan, sharding

    config, carry, statics, xs = host_inputs("groups")
    mesh = sharding.make_mesh(device_type=sharding.shard_device(device).type)
    st, ca, xs_d = sharding.shard_for_mesh(mesh, statics, carry, xs, device)
    members = scan.PodX(*(col[:5] for col in xs_d))
    feasible, score = scan.gang_lanes_sharded(
        replace(config, shard_axis="node"), mesh, ca, st, members)
    rng = np.random.RandomState(seed)
    n_local = st.alloc_cpu.shape[0]
    # random columns over the whole padded axis, this rank's block reduced
    cols = [rng.randint(0, 1000, size=n_local * mesh.size(1))
            for _ in scan.AnalyticsIn._fields]
    lo = mesh.get_local_rank("node") * n_local
    inp = scan.AnalyticsIn(*(torch.tensor(c[lo:lo + n_local],
                                          device=st.alloc_cpu.device)
                             for c in cols))
    stats = {k: scan.analytics_reduce_sharded(mesh, inp, NODES - 2, k)
             for k in (1, 3, NODES - 2)}
    return (feasible.cpu().numpy(), score.cpu().numpy(), cols,
            {k: [t.cpu().numpy() for t in s] for k, s in stats.items()})


# --- the rank entry points ----------------------------------------------


def parity_rank(rank, world, device="cpu"):
    """Everything tests/test_torch_shard_parity.py holds, on one rank."""
    os.environ["TPUSIM_SHARDS"] = str(world)
    out = {"scan": {name: sharded_scan(name, device=device)
                    for name in scan_cases()}}
    out["chunked"] = {name: sharded_scan(name, chunk=20, device=device)
                      for name in ("provider", "interpod")}
    out["backend"] = {name: backend_case(name, device=device)
                      for name in ("provider", "policy")}
    out["fallback"] = fallback_cases(device)
    out["doctored"] = doctored_backend(rank, device=device)
    return out


def reduce_rank(rank, world, device="cpu"):
    """Everything tests/test_torch_shard_reduce.py holds, on one rank."""
    os.environ["TPUSIM_SHARDS"] = str(world)
    return {
        "analytics": {k: backend_case("groups", device=device, analytics_k=k)
                      for k in (1, 4)},
        "gang": {name: gang_split(name, device=device)
                 for name in GANG_FEEDS},
        "direct": lanes_and_reduce(7, device=device),
    }


def differential_rank(rank, world, feeds):
    """tests/test_torch_fuzz_differential.py's sharded leg: each provider
    feed (obj dicts of its snapshot and pods, and the provider) through
    run_simulation(backend="torch", route="scan") with TPUSIM_SHARDS set:
    its signature as the test takes it, and the batches it ran on the
    sharded scan."""
    from tpusim_torch.api.snapshot import ClusterSnapshot
    from tpusim_torch.api.types import Pod
    from tpusim_torch.framework.metrics import register
    from tpusim_torch.simulator import run_simulation

    os.environ["TPUSIM_SHARDS"] = str(world)
    routes = register().backend_route
    out = []
    for snap_obj, pod_objs, provider in feeds:
        before = routes.get("scan_sharded")
        status = run_simulation(
            [Pod.from_obj(o) for o in pod_objs],
            ClusterSnapshot.from_obj(snap_obj), provider=provider,
            backend="torch", device="cpu", route="scan")
        out.append(([(p.name, p.spec.node_name)
                     for p in status.successful_pods],
                    [(p.name, p.status.conditions[-1].message
                      if p.status.conditions else "")
                     for p in status.failed_pods],
                    sorted(p.name for p in status.preempted_pods),
                    routes.get("scan_sharded") - before))
    return out


def mesh_rank(rank, world):
    """tests/test_torch_sharding.py's mesh layer on one rank: the kinds and
    shapes of the meshes make_mesh and make_scenario_mesh build, this
    rank's coordinates, and its staged blocks of the "groups" case."""
    from tpusim_torch import sharding

    meshes = {
        "node": sharding.make_mesh(),
        "snap2": sharding.make_mesh(snap=2),
        "scenario": sharding.make_scenario_mesh(),
        "scenario2": sharding.make_scenario_mesh(scenario=2),
        "first2": sharding.make_mesh(2),
    }
    out = {"meshes": {}}
    for name, mesh in meshes.items():
        out["meshes"][name] = (
            sharding.mesh_kind(mesh), tuple(mesh.mesh_dim_names),
            tuple(mesh.mesh.shape), mesh.get_coordinate())
    # a mesh is built once: the same request gives the same object
    out["cached"] = sharding.make_mesh() is meshes["node"]
    _config, carry, statics, xs = host_inputs("groups")
    st, ca, xs_d = sharding.shard_for_mesh(meshes["node"], statics, carry,
                                           xs, "cpu")
    out["blocks"] = (_numpy(st), _numpy(ca), _numpy(xs_d))
    return out


CUDA_CASES = ("provider", "interpod", "policy")


def cuda_rank(rank, world):
    """tests/test_torch_shard_cuda.py on one rank: every rank on the one
    card (cuda:(LOCAL_RANK mod device_count)) under the gloo group."""
    os.environ["TPUSIM_SHARDS"] = str(world)
    return {
        "scan": {name: sharded_scan(name, device="cuda")
                 for name in CUDA_CASES},
        "chunked": sharded_scan("provider", chunk=20, device="cuda"),
        "backend": backend_case("provider", device="cuda"),
        "analytics": backend_case("groups", device="cuda", analytics_k=4),
        "gang": gang_split("rank_aware", device="cuda"),
    }
