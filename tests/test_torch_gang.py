"""Gang feeds: the JAX package admits a pod group all or nothing, and so
does the port, on its host route (run_simulation(backend="reference")) and
on its device routes (run_simulation and the CLI on backend "torch", through
the gang driver), with the JAX package's placements and FitError text.

The feed: 3 nodes of 4 CPUs and one 4-member gang of 3-CPU pods. Only 3
members fit (one a node), so the gang as a whole does not. (The two tests
named "refuses" held the port's refusal of such a feed before it had a gang
driver; they now hold its admission against the JAX package's.)
"""

import json
import re

import pytest

import tpusim.api.snapshot as jax_api
from tpusim.cli import main as jax_main
from tpusim.simulator import run_simulation as jax_run_simulation

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.cli import main as port_main
from tpusim_torch.gang import GANG_NAME_ANNOTATION, gang_name, has_gangs
from tpusim_torch.simulator import run_simulation
from test_torch_backend import forbid_host_route

FIT_TEXT = 'pod group "g1" requires 4/4 members, only 3 fit jointly'
# the summary line's engine and timing, which differ between the packages
ENGINE = re.compile(r"\[[^\]]*backend[^\]]*\]")


def report_lines(out):
    return [ENGINE.sub("", line) for line in out.splitlines()]


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


def split(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods])


@pytest.mark.parametrize("route", ["auto", "kernel", "scan"])
def test_run_simulation_refuses_a_gang_feed(route, monkeypatch):
    # the device routes admit the gang all or nothing, through the gang
    # driver, with the JAX package's split and text
    want = split(jax_run_simulation(*reversed(gang_feed(jax_api)),
                                    backend="jax"))
    snapshot, pods = gang_feed(port_api)
    with monkeypatch.context() as patch:
        forbid_host_route(patch)
        status = run_simulation(pods, snapshot, device="cpu", route=route)
    assert split(status) == want
    assert not status.successful_pods and len(status.failed_pods) == 4
    for pod in status.failed_pods:
        assert FIT_TEXT in pod.status.conditions[-1].message
    # a gang-free feed of the same pods runs pod by pod
    for pod in pods:
        pod.metadata.annotations.clear()
    with monkeypatch.context() as patch:
        forbid_host_route(patch)
        status = run_simulation(pods, snapshot, device="cpu", route=route)
    assert len(status.successful_pods) == 3
    # the host route admits the gang as the device routes do
    snapshot, pods = gang_feed(port_api)
    assert split(run_simulation(pods, snapshot, backend="reference")) == want


def test_cli_refuses_a_gang_podspec(tmp_path, capsys):
    # the CLI on backend torch admits the gang with the JAX package's report
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps([{"name": "g1", "num": 4, "pod": {
        "metadata": {"annotations": {GANG_NAME_ANNOTATION: "g1"}},
        "spec": {"containers": [{"resources": {"requests": {
            "cpu": "3"}}}]}}}]))
    argv = ["--podspec", str(spec), "--synthetic-nodes", "3",
            "--synthetic-milli-cpu", "4000"]
    assert jax_main(argv + ["--backend", "jax"]) == 0
    want = report_lines(capsys.readouterr().out)
    assert port_main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert report_lines(out.out) == want
    assert "0 pod(s) scheduled, 4 unschedulable" in out.out
