"""Benchmark-shaped workloads, seed for seed the ones the reference benchmark
builds (the placement goldens depend on it), plus random group-free
workloads for kernel checks.

`api` is the module whose make_node / make_pod / ClusterSnapshot build the
objects: the port's own snapshot module by default; a caller may pass another
implementation's to build the same workload for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _api(api):
    if api is None:
        from tpusim_torch.api import snapshot as api
    return api


def build_workload(num_pods: int, num_nodes: int, affinity: bool = False,
                   seed: int = 12345, api=None):
    """Config-3 shape: heterogeneous nodes (taint slice, zone labels) + Zipf
    pods; affinity=True adds the config-4 node-affinity slice."""
    api = _api(api)
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(num_nodes):
        shape = i % 3
        milli_cpu = [4000, 8000, 16000][shape]
        memory = [8, 16, 32][shape] * 1024**3
        taints = None
        if i % 10 == 0:
            taints = [{"key": "dedicated", "value": "batch", "effect": "NoSchedule"}]
        nodes.append(api.make_node(f"node-{i}", milli_cpu=milli_cpu, memory=memory,
                                   pods=110, labels={"zone": f"z{i % 4}"},
                                   taints=taints))

    cpu_buckets = np.array([50, 100, 250, 500, 1000, 2000, 4000])
    mem_buckets = np.array([64, 128, 256, 512, 1024, 2048, 4096]) * 2**20
    weights = 1.0 / np.arange(1, len(cpu_buckets) + 1) ** 1.1
    weights /= weights.sum()
    cpu_idx = rng.choice(len(cpu_buckets), size=num_pods, p=weights)
    mem_idx = rng.choice(len(mem_buckets), size=num_pods, p=weights)
    tolerate = rng.rand(num_pods) < 0.1
    want_zone = rng.randint(0, 8, size=num_pods) if affinity else None

    pods = []
    for i in range(num_pods):
        kwargs = {}
        if tolerate[i]:
            kwargs["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                      "value": "batch", "effect": "NoSchedule"}]
        if affinity and want_zone[i] < 4:
            # config 4: half the pods pin a zone via required node affinity
            kwargs["affinity"] = {"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "zone", "operator": "In",
                         "values": [f"z{want_zone[i]}"]}]}]}}}
        pods.append(api.make_pod(f"p-{i}", milli_cpu=int(cpu_buckets[cpu_idx[i]]),
                                 memory=int(mem_buckets[mem_idx[i]]), **kwargs))
    return api.ClusterSnapshot(nodes=nodes), pods


def uniform_workload(num_pods: int, num_nodes: int, api=None):
    api = _api(api)
    nodes = [api.make_node(f"node-{i}", milli_cpu=4000, memory=16 * 1024**3)
             for i in range(num_nodes)]
    pods = [api.make_pod(f"p-{i}", milli_cpu=1000, memory=1 * 2**30)
            for i in range(num_pods)]
    return api.ClusterSnapshot(nodes=nodes), pods


SCALAR_NAMES = ("example.com/fpga", "example.com/nic")


def random_workload(seed: int, num_pods: int, num_nodes: int,
                    num_scalars: int = 0, infeasible: bool = False, api=None):
    """A random group-free workload that reaches every stage of the kernel:
    node conditions, cordons, pod-count / cpu / memory / gpu / scalar
    exhaustion, hostname pins (some dangling), selectors (some never
    matching), required and preferred node affinity, NoSchedule and
    PreferNoSchedule taints with tolerations, memory/disk pressure,
    best-effort pods and running pods in the initial state. infeasible=True
    adds pods no node can hold."""
    api = _api(api)
    rng = np.random.RandomState(seed)
    scal = SCALAR_NAMES[:num_scalars]
    nodes = []
    for i in range(num_nodes):
        taints = []
        if i % 3 == 0:
            taints.append({"key": "dedicated", "value": "batch",
                           "effect": "NoSchedule"})
        if i % 5 == 1:
            taints.append({"key": "soft", "value": "x",
                           "effect": "PreferNoSchedule"})
        node = api.make_node(
            f"n{i}", milli_cpu=int(rng.choice([500, 1000, 2000, 4000])),
            memory=int(rng.choice([1, 2, 4, 8])) * 1024**3,
            pods=int(rng.choice([3, 8, 20])),
            gpus=int(rng.choice([0, 0, 2])),
            labels={"zone": f"z{i % 3}", "disk": "ssd" if i % 2 else "hdd"},
            taints=taints or None, unschedulable=(i % 13 == 0),
            ready=(i % 17 != 3),
            scalars={s: int(rng.randint(0, 4)) for s in scal})
        ready = node.status.conditions[0]
        if i % 11 == 4:
            node.status.conditions.append(dataclasses.replace(
                ready, type="MemoryPressure", status="True"))
        if i % 19 == 7:
            node.status.conditions.append(dataclasses.replace(
                ready, type="DiskPressure", status="True"))
        nodes.append(node)
    running = [api.make_pod(f"r{i}", milli_cpu=300, memory=2**28,
                            node_name=f"n{int(rng.randint(num_nodes))}",
                            phase="Running")
               for i in range(max(num_nodes // 4, 1))]
    pods = []
    for i in range(num_pods):
        kw = {}
        if i % 5 == 0:
            kw["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                  "value": "batch", "effect": "NoSchedule"}]
        if i % 7 == 3:
            kw["tolerations"] = (kw.get("tolerations") or []) + [
                {"key": "soft", "operator": "Exists",
                 "effect": "PreferNoSchedule"}]
        if i % 4 == 0:
            kw["node_selector"] = {"zone": f"z{i % 4}"}  # z3 never matches
        if i % 9 == 0:
            kw["node_name"] = f"n{int(rng.randint(num_nodes + 5))}"
        if i % 6 == 1:
            kw["affinity"] = {"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "disk", "operator": "In",
                         "values": ["ssd"]}]}]}}}
        if i % 6 == 2:
            kw["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": int(rng.randint(1, 20)), "preference": {
                        "matchExpressions": [{"key": "zone", "operator": "In",
                                              "values": ["z1"]}]}},
                    {"weight": 3, "preference": {"matchExpressions": [
                        {"key": "disk", "operator": "Exists"}]}}]}}
        if i % 13 == 0:
            pods.append(api.make_pod(f"p{i}", **kw))  # best-effort
            continue
        big = infeasible and i % 10 == 5
        if scal and i % 3 == 0:
            kw["scalars"] = {s: int(rng.randint(1, 3)) for s in scal}
        pods.append(api.make_pod(
            f"p{i}", milli_cpu=(8000 if big else int(rng.randint(1, 25)) * 100),
            memory=int(rng.randint(1, 24)) * 2**27,
            gpus=int(rng.choice([0, 0, 0, 1])), **kw))
    return api.ClusterSnapshot(nodes=nodes, pods=running), pods
