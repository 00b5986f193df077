"""Benchmark-shaped workloads, seed for seed the ones the reference benchmark
builds (the placement goldens depend on it), the groups workload (config 3
with Services, host ports and pod volumes), the inter-pod workload (config 3
with pod (anti)affinity on zone and rack keys), the policy workload (the
groups workload under the upstream 1.2 scheduler Policy), the hostname
workload (config 3 with the documentation's two-tier hostname terms), the
streaming cells' cluster and policy (bench configs 10 and 13), plus random
workloads and policies for kernel checks.

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


TOLERATION = {"key": "dedicated", "operator": "Equal", "value": "batch",
              "effect": "NoSchedule"}


def _config3_nodes(api, num_nodes: int, labels) -> list:
    """Config 3's nodes: three shapes and a 10% taint slice; `labels(i)` is
    node i's labels."""
    nodes = []
    for i in range(num_nodes):
        shape = i % 3
        taints = None
        if i % 10 == 0:
            taints = [{"key": "dedicated", "value": "batch", "effect": "NoSchedule"}]
        nodes.append(api.make_node(
            f"node-{i}", milli_cpu=[4000, 8000, 16000][shape],
            memory=[8, 16, 32][shape] * 1024**3, pods=110, labels=labels(i),
            taints=taints))
    return nodes


def _config3_requests(rng, num_pods: int):
    """Config 3's pod draws from `rng`: Zipf cpu and memory requests and the
    10% of pods that tolerate the taint slice, as (milli_cpu, memory,
    tolerate) arrays."""
    cpu_buckets = np.array([50, 100, 250, 500, 1000, 2000, 4000])
    mem_buckets = np.array([64, 128, 256, 512, 1024, 2048, 4096]) * 2**20
    weights = 1.0 / np.arange(1, len(cpu_buckets) + 1) ** 1.1
    weights /= weights.sum()
    cpu_idx = rng.choice(len(cpu_buckets), size=num_pods, p=weights)
    mem_idx = rng.choice(len(mem_buckets), size=num_pods, p=weights)
    tolerate = rng.rand(num_pods) < 0.1
    return cpu_buckets[cpu_idx], mem_buckets[mem_idx], tolerate


def build_workload(num_pods: int, num_nodes: int, affinity: bool = False,
                   seed: int = 12345, api=None, priorities: bool = False):
    """Config-3 shape: heterogeneous nodes (taint slice, zone labels) + Zipf
    pods; affinity=True adds the config-4 node-affinity slice; priorities=True
    adds the config-6 priority bands (60% band 0, 30% band 500, 10% band
    1000, drawn pod by pod after the other columns, so the other columns do
    not move): saturation makes late high-priority pods preempt earlier
    ones."""
    api = _api(api)
    rng = np.random.RandomState(seed)
    nodes = _config3_nodes(api, num_nodes, lambda i: {"zone": f"z{i % 4}"})
    milli_cpu, memory, tolerate = _config3_requests(rng, num_pods)
    want_zone = rng.randint(0, 8, size=num_pods) if affinity else None

    pods = []
    for i in range(num_pods):
        kwargs = {}
        if tolerate[i]:
            kwargs["tolerations"] = [TOLERATION]
        if affinity and want_zone[i] < 4:
            # config 4: half the pods pin a zone via required node affinity
            kwargs["affinity"] = {"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "zone", "operator": "In",
                         "values": [f"z{want_zone[i]}"]}]}]}}}
        pod = api.make_pod(f"p-{i}", milli_cpu=int(milli_cpu[i]),
                           memory=int(memory[i]), **kwargs)
        if priorities:
            pod.spec.priority = int(rng.choice([0, 500, 1000],
                                               p=[0.6, 0.3, 0.1]))
        pods.append(pod)
    return api.ClusterSnapshot(nodes=nodes), pods


ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
NUM_APPS = 10        # app=a0..a9: a0..a7 have Services, a8 host ports, a9 disks


def _with_host_port(api, pod, port: int):
    """`pod` with its container asking for hostPort `port`."""
    obj = pod.to_obj()
    obj["spec"]["containers"][0]["ports"] = [
        {"containerPort": port, "hostPort": port}]
    return api.Pod.from_obj(obj)


def groups_workload(num_pods: int, num_nodes: int, seed: int = 12345,
                    api=None):
    """Config 3 with pod groups: config 3's nodes (three shapes, a 10% taint
    slice) labelled over 4 failure-domain zones, 8 Services selecting
    app=a0..a7, and config 3's Zipf pods labelled app=a0..a9. About 5% of
    the pods (app=a8) ask for hostPort 8080 or 9090; about 3% (app=a9) mount
    a disk: most one of 4 AWS EBS volumes (NoDiskConflict, MaxPD), the rest
    a claim bound to an EBS volume in zone z1 (NoVolumeZoneConflict). About
    num_pods/50 running pods seed the presence, some of them with host
    ports."""
    api = _api(api)
    rng = np.random.RandomState(seed)
    nodes = _config3_nodes(api, num_nodes, lambda i: {
        "zone": f"z{i % 4}", ZONE_LABEL: f"z{i % 4}"})
    services = [api.Service.from_obj({"metadata": {"name": f"svc-a{a}"},
                                      "spec": {"selector": {"app": f"a{a}"}}})
                for a in range(8)]
    pv = api.make_pv("pv-z1", labels={ZONE_LABEL: "z1"}, source={
        "awsElasticBlockStore": {"volumeID": "vol-z1"}})
    pvc = api.make_pvc("data-z1", volume_name="pv-z1")

    milli_cpu, memory, tolerate = _config3_requests(rng, num_pods)
    kind = rng.rand(num_pods)        # < 0.05 host port, < 0.08 disk
    app = rng.randint(0, 8, size=num_pods)
    pick = rng.randint(0, 5, size=num_pods)  # port or disk choice

    def make(name, i, app_id, **kw):
        if tolerate[i]:
            kw["tolerations"] = [TOLERATION]
        return api.make_pod(name, milli_cpu=int(milli_cpu[i]),
                            memory=int(memory[i]),
                            labels={"app": f"a{app_id}"}, **kw)

    pods = []
    for i in range(num_pods):
        if kind[i] < 0.05:
            pods.append(_with_host_port(api, make(f"p-{i}", i, 8),
                                        (8080, 9090)[pick[i] % 2]))
        elif kind[i] < 0.08:
            vol = (api.make_pod_volume("data", pvc="data-z1") if pick[i] == 4
                   else api.make_pod_volume("data", source={
                       "awsElasticBlockStore": {"volumeID": f"vol-{pick[i]}"}}))
            pods.append(make(f"p-{i}", i, 9, volumes=[vol]))
        else:
            pods.append(make(f"p-{i}", i, int(app[i])))

    running = []
    for r in range(max(num_pods // 50, 1)):
        i = int(rng.randint(num_pods))     # borrow a pod's request shape
        node = f"node-{int(rng.randint(num_nodes))}"
        app_id = int(rng.randint(0, 9))
        pod = make(f"r-{r}", i, app_id, node_name=node, phase="Running")
        if app_id == 8:
            pod = _with_host_port(api, pod, (8080, 9090)[r % 2])
        running.append(pod)
    return api.ClusterSnapshot(nodes=nodes, pods=running, services=services,
                               pvs=[pv], pvcs=[pvc]), pods


RACK_LABEL = "rack"
NUM_RACKS = 50


def _term(app: str, key: str) -> dict:
    return {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}


def _preferred(weight: int, app: str, key: str) -> dict:
    return {"weight": weight, "podAffinityTerm": _term(app, key)}


def _interpod_affinity(app_id: int):
    """The inter-pod terms of interpod_workload's app a<app_id>."""
    app = f"a{app_id}"
    if app_id <= 3:   # Deployment replicas spread over zones
        return {"podAntiAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                _preferred(50, app, ZONE_LABEL)]}}
    if app_id == 4:   # a stateful store: one replica per rack
        return {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                _term(app, RACK_LABEL)]}}
    if app_id == 5:   # a web tier beside the store, spread over racks
        return {"podAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [
                        _term("a4", ZONE_LABEL)]},
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        _preferred(10, app, RACK_LABEL)]}}
    if app_id == 6:   # workers near the web tier
        return {"podAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                _preferred(10, "a5", ZONE_LABEL)]}}
    return None


def _interpod_apps(u: np.ndarray) -> np.ndarray:
    """App ids from uniform draws: a0-a3 60%, a4 0.5%, a5 10%, a6 10%,
    a7-a9 the rest."""
    return np.select(
        [u < 0.6, u < 0.605, u < 0.705, u < 0.805],
        [(u / 0.15).astype(np.int64), 4, 5, 6],
        7 + np.minimum(((u - 0.805) / 0.065).astype(np.int64), 2))


def interpod_workload(num_pods: int, num_nodes: int, seed: int = 12345,
                      api=None):
    """Config 3 with inter-pod (anti)affinity: config 3's nodes (three
    shapes, a 10% taint slice) labelled over 4 zones (`zone` and the
    failure-domain label) and 50 racks of contiguous nodes, and config 3's
    Zipf pods labelled app=a0..a9:
      a0-a3 (~60%) Deployment replicas, preferred anti-affinity to their own
                   app on the zone key, weight 50;
      a4 (~0.5%)   a stateful store, required anti-affinity to a4 on the
                   rack key (one a4 pod a rack);
      a5 (~10%)    a web tier, required affinity to a4 on the zone key and
                   preferred anti-affinity to a5 on the rack key, weight 10;
      a6 (~10%)    workers, preferred affinity to a5 on the zone key,
                   weight 10;
      a7-a9        no terms.
    About num_pods/50 running pods with the same labels and terms, every
    hundredth of them an a4 pod, seed the presence. The terms key on zone
    and rack, never on the hostname: a hostname key has a domain per node,
    past the kernel's 64-domain budget on a real cluster."""
    api = _api(api)
    rng = np.random.RandomState(seed)
    nodes = _config3_nodes(api, num_nodes, lambda i: {
        "zone": f"z{i % 4}", ZONE_LABEL: f"z{i % 4}",
        RACK_LABEL: f"r{i * NUM_RACKS // num_nodes}"})
    milli_cpu, memory, tolerate = _config3_requests(rng, num_pods)
    apps = _interpod_apps(rng.rand(num_pods))

    def make(name, i, app_id, **kw):
        if tolerate[i]:
            kw["tolerations"] = [TOLERATION]
        affinity = _interpod_affinity(app_id)
        if affinity:
            kw["affinity"] = affinity
        return api.make_pod(name, milli_cpu=int(milli_cpu[i]),
                            memory=int(memory[i]),
                            labels={"app": f"a{app_id}"}, **kw)

    pods = [make(f"p-{i}", i, int(apps[i])) for i in range(num_pods)]
    running = []
    for r in range(max(num_pods // 50, 1)):
        i = int(rng.randint(num_pods))     # borrow a pod's request shape
        node = f"node-{int(rng.randint(num_nodes))}"
        app_id = 4 if r % 100 == 0 else int(_interpod_apps(rng.rand(1))[0])
        running.append(make(f"r-{r}", i, app_id, node_name=node,
                            phase="Running"))
    return api.ClusterSnapshot(nodes=nodes, pods=running), pods


HOSTNAME_LABEL = "kubernetes.io/hostname"
_REQUIRED = "requiredDuringSchedulingIgnoredDuringExecution"
_PREFERRED = "preferredDuringSchedulingIgnoredDuringExecution"
NUM_TIERS = 20       # Deployments of each tier


def hostname_workload(num_pods: int, num_nodes: int, seed: int = 12345,
                      api=None):
    """Config 3's nodes and pod requests with the two-tier pattern of the
    Kubernetes documentation ("Assigning Pods to Nodes", More practical
    use-cases: redis-cache and web-store on topologyKey
    kubernetes.io/hostname), at 20 Deployments a tier:
      ~40% store-<d> cache replicas, required anti-affinity to their own
           app on the hostname key (one replica a node);
      ~40% web-store-<d> replicas, required anti-affinity to their own app
           and required affinity to store-<d> on the hostname key (beside
           a cache replica, one a node);
      ~20% app=batch pods with no terms.
    A hostname key has a topology domain per node, so the fused kernel's
    64-domain budget refuses this plan on any real cluster; it runs on the
    scan route."""
    api = _api(api)
    rng = np.random.RandomState(seed)
    nodes = _config3_nodes(api, num_nodes, lambda i: {
        "zone": f"z{i % 4}", HOSTNAME_LABEL: f"node-{i}"})
    milli_cpu, memory, tolerate = _config3_requests(rng, num_pods)
    tier = rng.rand(num_pods)
    deploy = rng.randint(0, NUM_TIERS, size=num_pods)

    pods = []
    for i in range(num_pods):
        kw = {}
        if tolerate[i]:
            kw["tolerations"] = [TOLERATION]
        store = f"store-{deploy[i]}"
        if tier[i] < 0.4:
            app = store
            kw["affinity"] = {"podAntiAffinity": {
                _REQUIRED: [_term(app, HOSTNAME_LABEL)]}}
        elif tier[i] < 0.8:
            app = f"web-store-{deploy[i]}"
            kw["affinity"] = {
                "podAntiAffinity": {_REQUIRED: [_term(app, HOSTNAME_LABEL)]},
                "podAffinity": {_REQUIRED: [_term(store, HOSTNAME_LABEL)]}}
        else:
            app = "batch"
        pods.append(api.make_pod(f"p-{i}", milli_cpu=int(milli_cpu[i]),
                                 memory=int(memory[i]), labels={"app": app},
                                 **kw))
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


def random_group_workload(seed: int, num_pods: int, num_nodes: int,
                          ports: bool = False, services: bool = False,
                          disk: bool = False, vol_zone: bool = False,
                          maxpd: bool = False, api=None):
    """random_workload (with infeasible pods) plus the pod-group features
    asked for, on new and running pods alike. A pod takes at most one
    feature, so the merged groups stay within the kernel's budget:
      ports     hostPort 8080, 8080 on a host IP, or 8081/UDP (15%);
      services  zone labels on most nodes and three Services, two of which
                can select the same pod;
      disk      AWS EBS, GCE PD (one read-only) or RBD volumes (20%;
                NoDiskConflict; EBS and GCE PD also count for MaxPD);
      vol_zone  claims bound to volumes labelled z1 or z1__z2 (15%), with
                zone labels on most nodes (NoVolumeZoneConflict);
      maxpd     one or two of three Azure disks (25%; MaxPD only: Azure
                disks never conflict).
    Pods with a feature are labelled app=a0; the rest app=a0..a4, some
    tier=web."""
    api = _api(api)
    snapshot, pods = random_workload(seed, num_pods, num_nodes,
                                     infeasible=True, api=api)
    rng = np.random.RandomState(seed + 1000)
    if services or vol_zone:
        for i, node in enumerate(snapshot.nodes):
            if i % 5 != 0:   # every fifth node has no zone
                node.metadata.labels[ZONE_LABEL] = f"z{i % 3}"
    if services:
        snapshot.services = [api.Service.from_obj(
            {"metadata": {"name": name}, "spec": {"selector": sel}})
            for name, sel in (("svc-a0", {"app": "a0"}),
                              ("svc-a1", {"app": "a1"}),
                              ("svc-web", {"tier": "web"}))]
    if vol_zone:
        snapshot.pvs = [api.make_pv("pv-z1", labels={ZONE_LABEL: "z1"}),
                        api.make_pv("pv-z12", labels={ZONE_LABEL: "z1__z2"})]
        snapshot.pvcs = [api.make_pvc("c-z1", volume_name="pv-z1"),
                         api.make_pvc("c-z12", volume_name="pv-z12")]
    disks = [{"awsElasticBlockStore": {"volumeID": "vol-0"}},
             {"awsElasticBlockStore": {"volumeID": "vol-1"}},
             {"gcePersistentDisk": {"pdName": "pd-0"}},
             {"gcePersistentDisk": {"pdName": "pd-0", "readOnly": True}},
             {"gcePersistentDisk": {"pdName": "pd-1"}},
             {"rbd": {"monitors": ["m1"], "pool": "p", "image": "i0"}}]
    host_ports = [{"hostPort": 8080},
                  {"hostPort": 8080, "hostIP": "10.0.0.1"},
                  {"hostPort": 8081, "protocol": "UDP"}]

    def decorate(pod):
        obj = pod.to_obj()
        labels = obj["metadata"].setdefault("labels", {})
        labels["app"] = f"a{rng.randint(5)}"
        if rng.rand() < 0.3:
            labels["tier"] = "web"
        r, pick = rng.rand(), int(rng.randint(6))
        vols = []
        if ports and r < 0.15:
            obj["spec"]["containers"][0]["ports"] = [
                {"containerPort": 80, **host_ports[pick % 3]}]
        elif disk and 0.15 <= r < 0.35:
            vols = [api.make_pod_volume("d", source=disks[pick])]
        elif vol_zone and 0.35 <= r < 0.5:
            vols = [api.make_pod_volume("z", pvc=("c-z1", "c-z12")[pick % 2])]
        elif maxpd and 0.5 <= r < 0.75:
            ids = [pick % 3] + ([(pick + 1) % 3] if pick >= 3 else [])
            vols = [api.make_pod_volume(f"a{v}", source={"azureDisk": {
                "diskName": f"az-{v}", "diskURI": f"u{v}"}}) for v in ids]
        else:
            return api.Pod.from_obj(obj)
        obj["metadata"]["labels"] = {"app": "a0"}
        if vols:
            obj["spec"]["volumes"] = vols
        return api.Pod.from_obj(obj)

    snapshot.pods = [decorate(p) for p in snapshot.pods]
    return snapshot, [decorate(p) for p in pods]


INTERPOD_KEYS = ("zone", RACK_LABEL, HOSTNAME_LABEL)


def random_interpod_workload(seed: int, num_pods: int, num_nodes: int,
                             services: bool = False, ports: bool = False,
                             api=None):
    """random_workload (with infeasible pods) plus inter-pod (anti)affinity.
    Nodes get a rack label (missing on every seventh node). New and running
    pods are labelled app=a0..a2 and take one of five term sets drawn per
    seed, or none: required affinity or anti-affinity with one or two terms,
    some with preferred terms beside them, or preferred terms alone, with
    raw weights -50, -1, 1, 10 or 100, selecting app a0 or a1 on the zone,
    rack or hostname key. Besides:
      app=solo pods need a pod of their own app in their rack (the first one
        matches its own term and may go anywhere);
      one pod has a required affinity term with an empty topologyKey, which
        fails it everywhere;
      a running pod's required anti-affinity term with an empty topologyKey
        selects app=lone, so app=lone pods fit nowhere;
      a snapshot pod (app=cache) names a node the cluster does not have: it
        counts as a matching pod that exists but lies in no domain, so the
        app=web pods, which need a cache pod in their zone, fit nowhere.
    services adds zone labels and Services selecting a0 and a1; ports gives
    15% of the new pods (app=a0, no terms) a host port. The merged groups
    stay under 32 and, up to 63 nodes, the domains under 64."""
    api = _api(api)
    snapshot, pods = random_workload(seed, num_pods, num_nodes,
                                     infeasible=True, api=api)
    rng = np.random.RandomState(seed + 2000)
    for i, node in enumerate(snapshot.nodes):
        if i % 7 != 6:
            node.metadata.labels[RACK_LABEL] = f"r{i % 4}"
        if services and i % 5 != 0:
            node.metadata.labels[ZONE_LABEL] = f"z{i % 3}"
    if services:
        snapshot.services = [api.Service.from_obj(
            {"metadata": {"name": f"svc-{a}"}, "spec": {"selector": {"app": a}}})
            for a in ("a0", "a1")]

    def term(app=None, key=None):
        return {"labelSelector": {"matchLabels": {
                    "app": app or ("a0", "a1")[rng.randint(2)]}},
                "topologyKey": (INTERPOD_KEYS[rng.randint(3)] if key is None
                                else key)}

    def preferred():
        return [{"weight": int(rng.choice([-50, -1, 1, 10, 100])),
                 "podAffinityTerm": term()}
                for _ in range(rng.randint(1, 3))]

    def term_set():
        r = rng.rand()
        kind = "podAffinity" if r < 0.3 or r >= 0.8 else "podAntiAffinity"
        if r >= 0.55:
            return {kind: {_PREFERRED: preferred()}}
        aff = {kind: {_REQUIRED: [term() for _ in range(rng.randint(1, 3))]}}
        if rng.rand() < 0.4:
            aff[kind][_PREFERRED] = preferred()
        return aff

    menu = [term_set() for _ in range(5)]

    def decorate(pod, app=None, affinity=None, host_port=False):
        obj = pod.to_obj()
        obj["metadata"]["labels"] = {"app": app or f"a{rng.randint(3)}"}
        if host_port:
            obj["spec"]["containers"][0]["ports"] = [
                {"containerPort": 80, "hostPort": 8080 + rng.randint(2)}]
        elif affinity is None:
            pick = rng.randint(len(menu) + 2)
            affinity = menu[pick] if pick < len(menu) else None
        if affinity:
            obj["spec"]["affinity"] = affinity
        return api.Pod.from_obj(obj)

    snapshot.pods = [decorate(p) for p in snapshot.pods]
    snapshot.pods[0] = decorate(snapshot.pods[0], app="a2", affinity={
        "podAntiAffinity": {_REQUIRED: [term("lone", "")]}})
    snapshot.pods.append(api.make_pod("unplaced", milli_cpu=100,
                                      labels={"app": "cache"},
                                      node_name="gone-node", phase="Running"))
    out = []
    for i, pod in enumerate(pods):
        if i % 31 == 5:
            out.append(decorate(pod, app="solo", affinity={"podAffinity": {
                _REQUIRED: [term("solo", RACK_LABEL)]}}))
        elif i % 37 == 11:
            out.append(decorate(pod, app="web", affinity={"podAffinity": {
                _REQUIRED: [term("cache", "zone")]}}))
        elif i % 53 == 8:
            out.append(decorate(pod, app="lone", affinity={}))
        elif i == 2:
            out.append(decorate(pod, affinity={"podAffinity": {
                _REQUIRED: [term(key="")]}}))
        elif ports and rng.rand() < 0.15:
            out.append(decorate(pod, app="a0", host_port=True))
        else:
            out.append(decorate(pod))
    return snapshot, out


# Two of the versioned scheduler Policies of upstream kube-scheduler's
# compatibility test (test/integration/scheduler/compatibility_test.go,
# TestCompatibility_v1_Scheduler, the "1.2" and "1.9" cases), as
# engine.policy.decode_policy takes them.
COMPAT_POLICIES = {
    "1.2": {
        "kind": "Policy", "apiVersion": "v1",
        "predicates": [
            {"name": "MatchNodeSelector"}, {"name": "PodFitsResources"},
            {"name": "PodFitsHostPorts"}, {"name": "HostName"},
            {"name": "NoDiskConflict"}, {"name": "NoVolumeZoneConflict"},
            {"name": "MaxEBSVolumeCount"}, {"name": "MaxGCEPDVolumeCount"},
            {"name": "MaxAzureDiskVolumeCount"},
            {"name": "TestServiceAffinity", "argument": {
                "serviceAffinity": {"labels": ["region"]}}},
            {"name": "TestLabelsPresence", "argument": {
                "labelsPresence": {"labels": ["foo"], "presence": True}}}],
        "priorities": [
            {"name": "EqualPriority", "weight": 2},
            {"name": "NodeAffinityPriority", "weight": 2},
            {"name": "ImageLocalityPriority", "weight": 2},
            {"name": "LeastRequestedPriority", "weight": 2},
            {"name": "BalancedResourceAllocation", "weight": 2},
            {"name": "SelectorSpreadPriority", "weight": 2},
            {"name": "TestServiceAntiAffinity", "weight": 3, "argument": {
                "serviceAntiAffinity": {"label": "zone"}}},
            {"name": "TestLabelPreference", "weight": 4, "argument": {
                "labelPreference": {"label": "bar", "presence": True}}}]},
    "1.9": {
        "kind": "Policy", "apiVersion": "v1",
        "predicates": [
            {"name": "MatchNodeSelector"}, {"name": "PodFitsResources"},
            {"name": "PodFitsHostPorts"}, {"name": "HostName"},
            {"name": "NoDiskConflict"}, {"name": "NoVolumeZoneConflict"},
            {"name": "PodToleratesNodeTaints"},
            {"name": "CheckNodeMemoryPressure"},
            {"name": "CheckNodeDiskPressure"},
            {"name": "CheckNodeCondition"},
            {"name": "MaxEBSVolumeCount"}, {"name": "MaxGCEPDVolumeCount"},
            {"name": "MaxAzureDiskVolumeCount"},
            {"name": "MatchInterPodAffinity"},
            {"name": "GeneralPredicates"}, {"name": "CheckVolumeBinding"},
            {"name": "TestServiceAffinity", "argument": {
                "serviceAffinity": {"labels": ["region"]}}},
            {"name": "TestLabelsPresence", "argument": {
                "labelsPresence": {"labels": ["foo"], "presence": True}}}],
        "priorities": [
            {"name": "EqualPriority", "weight": 2},
            {"name": "ImageLocalityPriority", "weight": 2},
            {"name": "LeastRequestedPriority", "weight": 2},
            {"name": "BalancedResourceAllocation", "weight": 2},
            {"name": "SelectorSpreadPriority", "weight": 2},
            {"name": "NodePreferAvoidPodsPriority", "weight": 2},
            {"name": "NodeAffinityPriority", "weight": 2},
            {"name": "TaintTolerationPriority", "weight": 2},
            {"name": "InterPodAffinityPriority", "weight": 2},
            {"name": "MostRequestedPriority", "weight": 2}]},
}

# Bench config 10's scheduler policy (bench.py _POLICY_STREAM_DOC): a
# selector, a taint, ServiceAffinity, label-presence, ServiceAntiAffinity
# and label-preference tables all resident, so the streaming twin's statics
# commit covers every policy-derived column family.
STREAM_POLICY = {
    "apiVersion": "v1", "kind": "Policy",
    "predicates": [
        {"name": "MatchNodeSelector"},
        {"name": "PodFitsResources"},
        {"name": "PodToleratesNodeTaints"},
        {"name": "TestServiceAffinity",
         "argument": {"serviceAffinity": {"labels": ["region"]}}},
        {"name": "TestLabelsPresence",
         "argument": {"labelsPresence": {"labels": ["foo"],
                                         "presence": True}}},
    ],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "zone-spread", "weight": 2,
         "argument": {"serviceAntiAffinity": {"label": "zone"}}},
        {"name": "bar-pref", "weight": 1,
         "argument": {"labelPreference": {"label": "bar",
                                          "presence": True}}},
    ],
}


def racked_cluster(num_nodes: int, api=None):
    """Bench config 13's cluster: synthetic_cluster(num_nodes), racks of 16
    nodes (topology.kubernetes.io/rack)."""
    snapshot = _api(api).synthetic_cluster(num_nodes)
    for i, node in enumerate(snapshot.nodes):
        node.metadata.labels["topology.kubernetes.io/rack"] = f"rack-{i // 16}"
    return snapshot


MB = 1024 * 1024
# container images, sizes spread over ImageLocalityPriority's 23 MB-1 GB
# scoring range (image_locality.go)
IMAGES = tuple((f"registry.example.com/app-{k}:v1", size * MB) for k, size in
               enumerate((25, 60, 120, 200, 350, 500, 750, 950)))


def _node_with(api, node, labels: dict, images=(), taints=()):
    """`node` with `labels` added, `images` (names) listed in its status
    and `taints` appended."""
    obj = node.to_obj()
    obj["metadata"].setdefault("labels", {}).update(labels)
    if images:
        sizes = dict(IMAGES)
        obj.setdefault("status", {})["images"] = [
            {"names": [name], "sizeBytes": sizes[name]} for name in images]
    if taints:
        obj.setdefault("spec", {}).setdefault("taints", []).extend(taints)
    return api.Node.from_obj(obj)


def _pod_with(api, pod, image: str = "", selector=None, tolerations=(),
              labels=None, node_name: str = ""):
    """`pod` running `image`, with `selector` added to its nodeSelector,
    `tolerations` to its tolerations and `labels` to its labels, bound to
    `node_name` if given."""
    obj = pod.to_obj()
    if labels:
        obj["metadata"].setdefault("labels", {}).update(labels)
    spec = obj["spec"]
    if node_name:
        spec["nodeName"] = node_name
    if image:
        spec["containers"][0]["image"] = image
    if selector:
        spec.setdefault("nodeSelector", {}).update(selector)
    if tolerations:
        spec.setdefault("tolerations", []).extend(tolerations)
    return api.Pod.from_obj(obj)


def policy_workload(num_pods: int, num_nodes: int, seed: int = 12345,
                    api=None):
    """The groups workload's cluster and pods for COMPAT_POLICIES["1.2"]:
    every node also carries `zone` (its failure-domain zone), `region` (two
    regions over the four zones), `foo` on two nodes in three and `bar` on
    every other node; half the nodes list two or three of the 8 IMAGES.
    Every pod runs one of the IMAGES, and about 10% pin a region by
    nodeSelector. Under 1.2 that is ServiceAffinity on region, label
    presence on foo, ServiceAntiAffinity on zone, LabelPreference on bar and
    ImageLocality beside the groups workload's Services, host ports and
    volumes. The running pods are spread over distinct nodes: where they
    stack, the plan's bound on BalancedResourceAllocation's products
    weighted 2 (10 * 2 * cpu bound * memory bound < 2^31, with the nonzero
    requests already on a node as the per-pod bound) refuses 1.2 at 5,000
    nodes."""
    api = _api(api)
    snapshot, pods = groups_workload(num_pods, num_nodes, seed=seed, api=api)
    rng = np.random.RandomState(seed + 4000)
    nodes = []
    for i, node in enumerate(snapshot.nodes):
        labels = {"zone": f"z{i % 4}", "region": f"r{(i % 4) // 2}"}
        if i % 3 != 2:
            labels["foo"] = "x"
        if i % 2 == 0:
            labels["bar"] = "y"
        images = ()
        if i % 2 == 1:
            picks = rng.choice(len(IMAGES), size=2 + rng.randint(2),
                               replace=False)
            images = [IMAGES[k][0] for k in sorted(picks)]
        nodes.append(_node_with(api, node, labels, images))
    snapshot.nodes = nodes
    stride = max(num_nodes // max(len(snapshot.pods), 1), 1)
    snapshot.pods = [
        _pod_with(api, pod, node_name=f"node-{r * stride % num_nodes}")
        for r, pod in enumerate(snapshot.pods)]
    image = rng.randint(len(IMAGES), size=len(pods))
    pin = rng.rand(len(pods)) < 0.1
    region = rng.randint(2, size=len(pods))
    out = [_pod_with(api, pod, IMAGES[image[j]][0],
                     {"region": f"r{region[j]}"} if pin[j] else None)
           for j, pod in enumerate(pods)]
    return snapshot, out


POLICY_PREDICATES = (
    "CheckNodeUnschedulable", "HostName", "PodFitsHostPorts",
    "MatchNodeSelector", "PodFitsResources", "NoDiskConflict",
    "PodToleratesNodeTaints", "NoVolumeZoneConflict",
    "CheckNodeMemoryPressure", "CheckNodeDiskPressure", "CheckVolumeBinding")
POLICY_PRIORITIES = (
    "LeastRequestedPriority", "MostRequestedPriority",
    "BalancedResourceAllocation", "NodeAffinityPriority",
    "TaintTolerationPriority", "NodePreferAvoidPodsPriority",
    "SelectorSpreadPriority", "ImageLocalityPriority", "EqualPriority")
MAXPD_PREDICATES = ("MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
                    "MaxAzureDiskVolumeCount")
SA_LABELS = (["region"], ["zone"], ["region", "zone"])
NO_EXECUTE = {"key": "evict", "value": "x", "effect": "NoExecute"}


def random_policy(seed: int, count_mode: bool = False, general: bool = True,
                  ports_alias: bool = False, noexec: bool = False,
                  sa_entries: int = 1, maxpd_off=()) -> dict:
    """A random scheduler Policy as decode_policy takes it: each standard
    predicate of POLICY_PREDICATES with probability 0.7, GeneralPredicates
    when `general`, the MaxPD types not in `maxpd_off`, the NoExecute taint
    predicate when `noexec`, the 1.0 PodFitsPorts alias when `ports_alias`;
    one or two label-presence predicates (under an ordering name or one that
    sorts to the tail), `sa_entries` ServiceAffinity predicates; each
    priority of POLICY_PRIORITIES with probability 0.7 and a weight of 1-5,
    one or two ServiceAntiAffinity priorities and a label preference;
    alwaysCheckAllPredicates when `count_mode`."""
    rng = np.random.RandomState(seed + 3000)
    preds = [{"name": n} for n in POLICY_PREDICATES if rng.rand() < 0.7]
    if general:
        preds.append({"name": "GeneralPredicates"})
    preds += [{"name": n} for t, n in enumerate(MAXPD_PREDICATES)
              if t not in maxpd_off]
    if noexec:
        preds.append({"name": "PodToleratesNodeNoExecuteTaints"})
    if ports_alias:
        preds.append({"name": "PodFitsPorts"})
    label_names = ("CheckNodeLabelPresence", "HostName", "LabelsFoo")
    preds.append({"name": label_names[rng.randint(3)], "argument": {
        "labelsPresence": {"labels": ["foo"], "presence": True}}})
    if rng.rand() < 0.5:
        preds.append({"name": "ZzLabelsBar", "argument": {"labelsPresence": {
            "labels": ["bar"], "presence": False}}})
    sa_names = ("CheckServiceAffinity", "AffinityA", "ZzAffinity")
    for e in range(sa_entries):
        preds.append({"name": sa_names[(e + rng.randint(3)) % 3], "argument": {
            "serviceAffinity": {"labels": SA_LABELS[(e + seed) % 3]}}})
    prios = [{"name": n, "weight": int(rng.randint(1, 6))}
             for n in POLICY_PRIORITIES if rng.rand() < 0.7]
    for e, label in enumerate(("zone", "region")[:1 + rng.randint(2)]):
        prios.append({"name": f"Spread{e}", "weight": int(rng.randint(1, 4)),
                      "argument": {"serviceAntiAffinity": {"label": label}}})
    prios.append({"name": "PreferBar", "weight": int(rng.randint(1, 4)),
                  "argument": {"labelPreference": {"label": "bar",
                                                   "presence": True}}})
    return {"kind": "Policy", "apiVersion": "v1", "predicates": preds,
            "priorities": prios, "alwaysCheckAllPredicates": count_mode,
            "hardPodAffinitySymmetricWeight": int(rng.choice([0, 1, 50]))}


def _policy_labels(api, snapshot, pods, rng, fresh: bool = False):
    """Policy labels, images and NoExecute taints on a random workload's
    nodes, images, region pins and NoExecute tolerations on its pods:
    `zone` z0-z2 and `region` r0-r1 (each missing on some nodes), `foo` on
    two nodes in three, `bar` on every other node, two of the IMAGES on
    every other node, a NoExecute taint on every seventh node, an image on
    every pod, a region pin on one pod in ten, the toleration on one in
    three; with `fresh`, a Service selecting the label fresh=1 that the new
    pods labelled just app=a2 carry and no running pod does (its
    ServiceAffinity lock is taken at a bind)."""
    nodes = []
    for i, node in enumerate(snapshot.nodes):
        labels = {}
        if i % 6 != 5:
            labels["zone"] = f"z{i % 3}"
        if i % 7 != 3:
            labels["region"] = f"r{i % 2}"
        if i % 3 != 2:
            labels["foo"] = "x"
        if i % 2 == 0:
            labels["bar"] = "y"
        images = ([IMAGES[k][0] for k in sorted(
            rng.choice(len(IMAGES), size=2, replace=False))]
            if i % 2 else ())
        nodes.append(_node_with(api, node, labels, images,
                                [NO_EXECUTE] if i % 7 == 0 else ()))
    snapshot.nodes = nodes
    if fresh:
        snapshot.services = list(snapshot.services) + [api.Service.from_obj(
            {"metadata": {"name": "svc-fresh"},
             "spec": {"selector": {"fresh": "1"}}})]
    tol = {"key": "evict", "operator": "Exists", "effect": "NoExecute"}
    out = []
    for pod in pods:
        r = rng.rand()
        out.append(_pod_with(
            api, pod, IMAGES[rng.randint(len(IMAGES))][0],
            {"region": f"r{rng.randint(2)}"} if r < 0.1 else None,
            [tol] if r > 0.66 else (),
            {"fresh": "1"} if fresh and pod.metadata.labels == {"app": "a2"}
            else None))
    return snapshot, out


def random_policy_workload(seed: int, num_pods: int, num_nodes: int,
                           interpod: bool = False, api=None):
    """A small random workload for policy plans: random_group_workload with
    every pod-group feature and a bind-locked Service (or
    random_interpod_workload with Services and host ports when `interpod`)
    plus _policy_labels."""
    api = _api(api)
    if interpod:
        snapshot, pods = random_interpod_workload(
            seed, num_pods, num_nodes, services=True, ports=True, api=api)
    else:
        snapshot, pods = random_group_workload(
            seed, num_pods, num_nodes, ports=True, services=True, disk=True,
            vol_zone=True, maxpd=True, api=api)
    return _policy_labels(api, snapshot, pods,
                          np.random.RandomState(seed + 5000),
                          fresh=not interpod)


def cluster_hazard_cases() -> dict:
    """Small plans for what the fast-scan kernel's thread-block cluster
    must get right, by name: (workload function, Policy dict or None,
    most_requested, hard_weight, kernel variant). At 400-500 nodes (Npad
    512) a cluster of 16 CTAs takes 32 nodes each and the last slabs hold
    only pad nodes; at 130 nodes (Npad 256) the last CTA of 4 holds only pad
    nodes and 16 CTAs do not fit; at 60 nodes (Npad 128) 4 CTAs at most.
    Between them: identical nodes, whose ties span every slab and whose
    round-robin pick walks into the last CTA; pods no node holds (the
    reason histogram, in count mode too) beside CTAs with and without a
    feasible node; binds in one CTA that the next pod's inter-pod phase or
    ServiceAffinity lock reads in another."""
    return {
        "uniform_ties_400": (lambda: uniform_workload(300, 400), None,
                             False, 10, "group_free"),
        "infeasible_130": (lambda: random_workload(5, 300, 130,
                                                   num_scalars=1,
                                                   infeasible=True),
                           None, True, 10, "group_free"),
        "groups_400": (lambda: random_group_workload(
            6, 300, 400, ports=True, services=True, disk=True,
            vol_zone=True, maxpd=True), None, False, 10, "groups"),
        "interpod_500": (lambda: interpod_workload(600, 500), None, True, 10,
                         "interpod"),
        "interpod_60": (lambda: random_interpod_workload(
            7, 300, 60, services=True, ports=True), None, False, 100,
            "interpod"),
        "policy_count_400": (lambda: random_policy_workload(8, 300, 400),
                             random_policy(8, count_mode=True, sa_entries=2),
                             False, 10, "policy"),
        "policy_interpod_400": (lambda: random_policy_workload(
            13, 300, 400, interpod=True), COMPAT_POLICIES["1.9"], False, 10,
            "policy_interpod"),
        "policy_interpod_60": (lambda: random_policy_workload(
            9, 300, 60, interpod=True), COMPAT_POLICIES["1.9"], False, 10,
            "policy_interpod"),
    }
