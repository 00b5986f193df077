"""Gang feeds: the JAX package admits a pod group all or nothing. The
port's host route (run_simulation(backend="reference")) does the same; its
device routes have no gang driver yet, so run_simulation and the CLI on
backend "torch" refuse a feed that holds one instead of placing the members
pod by pod.

The feed: 3 nodes of 4 CPUs and one 4-member gang of 3-CPU pods. Only 3
members fit (one a node), so the gang as a whole does not.
"""

import json

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.simulator import run_simulation as jax_run_simulation

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.cli import main as port_main
from tpusim_torch.gang import GANG_NAME_ANNOTATION, gang_name, has_gangs
from tpusim_torch.simulator import run_simulation
from test_torch_backend import forbid_host_route

FIT_TEXT = 'pod group "g1" requires 4/4 members, only 3 fit jointly'


def gang_feed(api):
    pods = []
    for i in range(4):
        pod = api.make_pod(f"g1-{i}", milli_cpu=3000)
        pod.metadata.annotations[GANG_NAME_ANNOTATION] = "g1"
        pods.append(pod)
    return api.synthetic_cluster(3, milli_cpu=4000), pods


@pytest.mark.parametrize("backend", ["jax", "reference"])
def test_jax_package_fails_the_whole_gang(backend):
    snapshot, pods = gang_feed(jax_api)
    status = jax_run_simulation(pods, snapshot, backend=backend)
    assert not status.successful_pods and len(status.failed_pods) == 4
    for pod in status.failed_pods:
        assert FIT_TEXT in pod.status.conditions[-1].message


def test_detector():
    snapshot, pods = gang_feed(port_api)
    assert [gang_name(p) for p in pods] == ["g1"] * 4
    assert has_gangs(pods) and not has_gangs([port_api.make_pod("solo")])
    assert not has_gangs(snapshot.pods)


@pytest.mark.parametrize("route", ["auto", "kernel", "scan"])
def test_run_simulation_refuses_a_gang_feed(route, monkeypatch):
    snapshot, pods = gang_feed(port_api)
    with pytest.raises(NotImplementedError, match="pod groups") as err:
        run_simulation(pods, snapshot, device="cpu", route=route)
    assert "g1" in str(err.value)
    # a gang-free feed of the same pods still runs, pod by pod, on the
    # device routes
    for pod in pods:
        pod.metadata.annotations.clear()
    with monkeypatch.context() as patch:
        forbid_host_route(patch)
        status = run_simulation(pods, snapshot, device="cpu", route=route)
    assert len(status.successful_pods) == 3
    # the host route admits the gang all or nothing, like the JAX package's
    snapshot, pods = gang_feed(port_api)
    status = run_simulation(pods, snapshot, backend="reference")
    assert not status.successful_pods and len(status.failed_pods) == 4
    for pod in status.failed_pods:
        assert FIT_TEXT in pod.status.conditions[-1].message


def test_cli_refuses_a_gang_podspec(tmp_path, capsys):
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([{"name": "g1", "num": 4, "pod": {
        "metadata": {"annotations": {GANG_NAME_ANNOTATION: "g1"}},
        "spec": {"containers": [{"resources": {"requests": {
            "cpu": "3"}}}]}}}]))
    rc = port_main(["--podspec", str(spec), "--synthetic-nodes", "3",
                    "--synthetic-milli-cpu", "4000", "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 2
    assert "pod groups" in out.err and "g1" in out.err
    assert "Successful Pods" not in out.out and "scheduled" not in out.out
