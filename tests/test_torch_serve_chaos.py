"""The port's chaos-hardened serve fleet (tpusim_torch/serve/) against the
JAX package's (tpusim/serve/), on the CPU.

Under the same device-fault plan both fleets must answer every request the
same way: the placement hashes, each response's `degraded` field, and the
moves of tpusim_serve_retry_total{reason} and
tpusim_serve_degraded_total{path}. Covered: an injected fault retried to a
clean answer under the injected clock, a corrupt_invalid caught by the
structural checks, a corrupt_silent caught by host verification, a breaker
storm answered by the host pipeline, seeded fault storms, a worker death,
and the `serve --chaos-plan` command. An error that is not a DeviceFault
still fails its bucket under chaos. Tolerance: exact.
"""

import json

import numpy as np
import pytest

import tpusim.api.snapshot as jax_api
from tpusim.backends import placement_hash as jax_hash
from tpusim.chaos import ChaosClock as JaxClock
from tpusim.chaos import DeviceFaultPlan as JaxDevicePlan
from tpusim.cli import main as jax_main
from tpusim.framework.metrics import register as jax_register
from tpusim.jaxe.backend import install_chaos as jax_install
from tpusim.jaxe.backend import uninstall_chaos as jax_uninstall
from tpusim.serve import ScenarioFleet as JaxFleet
from tpusim.serve import WhatIfRequest as JaxRequest

import tpusim_torch.api.snapshot as port_api
from tpusim_torch.backend import install_chaos, uninstall_chaos
from tpusim_torch.backends import placement_hash
from tpusim_torch.chaos import ChaosClock, DeviceFaultPlan
from tpusim_torch.cli import main as port_main
from tpusim_torch.framework.metrics import register
from tpusim_torch.serve import ScenarioFleet, WhatIfRequest

PORT = (port_api, ScenarioFleet, WhatIfRequest, ChaosClock, DeviceFaultPlan,
        install_chaos, uninstall_chaos, register, placement_hash)
JAX = (jax_api, JaxFleet, JaxRequest, JaxClock, JaxDevicePlan, jax_install,
       jax_uninstall, jax_register, jax_hash)


@pytest.fixture(autouse=True)
def _no_chaos_seam():
    uninstall_chaos()
    jax_uninstall()
    yield
    uninstall_chaos()
    jax_uninstall()


def scenario(api, seed, num_nodes=4, num_pods=3):
    rng = np.random.RandomState(seed)
    nodes = [api.make_node(f"c{seed}-n{i}",
                           milli_cpu=int(rng.choice([2000, 4000, 8000])),
                           memory=int(rng.choice([4, 8])) * 1024**3)
             for i in range(num_nodes)]
    pods = [api.make_pod(f"c{seed}-p{i}",
                         milli_cpu=int(rng.randint(100, 1500)),
                         memory=int(rng.randint(2**20, 2**30)))
            for i in range(num_pods)]
    return api.ClusterSnapshot(nodes=nodes), pods


def divergent(api, tag):
    """Every placement on a node index > 0, so corrupt_silent's rotation
    always changes the answer."""
    nodes = [api.make_node(f"{tag}-n0", milli_cpu=500, memory=1024**3)]
    nodes += [api.make_node(f"{tag}-n{i}", milli_cpu=4000 * i,
                            memory=8 * 1024**3) for i in (1, 2, 3)]
    pods = [api.make_pod(f"{tag}-p{i}", milli_cpu=800 + i * 100,
                         memory=1024**3) for i in range(3)]
    return api.ClusterSnapshot(nodes=nodes), pods


def fleet_run(pkg, build, plan, **fleet_kw):
    """One fleet under `plan` (None: no chaos): each response's hash and
    degraded field, the counters' moves, the breaker and the clock."""
    api, fleet_cls, req_cls, clock_cls, plan_cls, install, uninstall, reg, \
        hash_fn = pkg
    requests = [req_cls(pods=pods, snapshot=snap)
                for snap, pods in build(api)]
    m = reg()
    before = (dict(m.serve_retry.values), dict(m.serve_degraded.values))
    breaker = install(plan_cls(**plan)) if plan is not None else None
    clock = clock_cls()
    try:
        kw = dict(bucket_size=2, clock=clock, **fleet_kw)
        if fleet_cls is ScenarioFleet:
            kw["device"] = "cpu"
        fleet = fleet_cls(**kw)
        futures = [fleet.submit(r) for r in requests]
        fleet.drain()
        fleet.stop()
        responses = [f.result() for f in futures]
    finally:
        uninstall()
    moved = tuple({k: v - old.get(k, 0) for k, v in fam.values.items()
                   if v != old.get(k, 0)}
                  for fam, old in ((m.serve_retry, before[0]),
                                   (m.serve_degraded, before[1])))
    answers = [(hash_fn(r.result.placements) if r.ok else None,
                r.degraded, r.rejected, r.error is not None)
               for r in responses]
    return answers, moved, (breaker.transitions if breaker else None), \
        clock.now


def both(build, plan, **fleet_kw):
    want = fleet_run(JAX, build, plan, **fleet_kw)
    got = fleet_run(PORT, build, plan, **fleet_kw)
    assert got == want
    clean = fleet_run(PORT, build, None, **fleet_kw)
    return got, clean


def seeds(*s):
    return lambda api: [scenario(api, i) for i in s]


def test_injected_fault_retries_to_clean_parity():
    (answers, moved, _, now), (clean, _, _, _) = both(
        seeds(10, 11), dict(faults={0: "exception"}, failure_threshold=3,
                            cooldown=2))
    assert answers == clean
    assert moved[0] == {"device_fault": 1} and moved[1] == {}
    assert now > 0  # the retry backed off under the clock


def test_corrupt_invalid_detected_structurally_then_retried():
    (answers, moved, _, _), (clean, _, _, _) = both(
        seeds(12, 13), dict(faults={0: "corrupt_invalid"},
                            failure_threshold=3, cooldown=2))
    assert answers == clean
    assert moved[0] == {"device_fault": 1}


def test_corrupt_silent_caught_by_host_verification():
    (answers, moved, _, _), (clean, _, _, _) = both(
        lambda api: [divergent(api, "vd")] * 2,
        dict(faults={0: "corrupt_silent"}, failure_threshold=3, cooldown=2))
    assert [a[0] for a in answers] == [a[0] for a in clean]
    assert all(a[1] == "verify_divergence" for a in answers)
    assert moved[1] == {"verify_divergence": 1}


def test_breaker_storm_degrades_to_host_answers():
    (answers, moved, trail, _), (clean, _, _, _) = both(
        seeds(14, 15, 16, 17),
        dict(faults={i: "exception" for i in range(1000)},
             failure_threshold=1, cooldown=1_000_000))
    assert [a[0] for a in answers] == [a[0] for a in clean]
    assert all(a[1] == "breaker_open" for a in answers)
    assert moved[1] == {"breaker_open": 2}  # two buckets of two
    assert [t for t, _ in trail] == ["open"]


def test_retry_exhausted():
    (answers, moved, _, _), (clean, _, _, _) = both(
        seeds(18, 19), dict(faults={i: "exception" for i in range(3)},
                            failure_threshold=10, cooldown=1))
    assert [a[0] for a in answers] == [a[0] for a in clean]
    assert all(a[1] == "retry_exhausted" for a in answers)
    assert moved == ({"device_fault": 2}, {"retry_exhausted": 1})


@pytest.mark.parametrize("seed", range(4))
def test_serve_fault_storms(seed):
    """Seeded storms with deadlines and a bounded queue: every future
    resolves, and every answer, degraded path and counter move equals the
    JAX package's."""
    kinds = ["exception", "corrupt_invalid", "corrupt_silent"]
    rng = np.random.RandomState(seed)
    faults = {int(i): kinds[int(rng.randint(len(kinds)))]
              for i in range(12) if rng.rand() < 0.5}
    (answers, _, _, _), (clean, _, _, _) = both(
        seeds(*range(8)), dict(faults=faults, failure_threshold=2,
                               cooldown=2),
        deadline_s=500.0, max_queue=8)
    for got, want in zip(answers, clean):
        if got[0] is not None:
            assert got[0] == want[0]


def test_real_errors_fail_the_bucket_under_chaos(monkeypatch):
    """Only DeviceFault is retried: another error of the program fails its
    bucket's requests with the error, no host answer, no retry."""
    import tpusim_torch.serve.executor as executor

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(executor, "build_program", broken)
    m = register()
    before = dict(m.serve_retry.values)
    install_chaos(DeviceFaultPlan(faults={}, failure_threshold=1))
    snap, pods = scenario(port_api, 20)
    fleet = ScenarioFleet(bucket_size=2, clock=ChaosClock(), device="cpu")
    [r] = fleet.run([WhatIfRequest(pods=pods, snapshot=snap)])
    assert not r.ok and "illegal memory access" in r.error
    assert r.degraded is None
    assert dict(m.serve_retry.values) == before


def test_worker_death_counted(monkeypatch):
    snap, pods = scenario(port_api, 21)
    fleet = ScenarioFleet(bucket_size=1, device="cpu")
    calls = {"n": 0}
    real = fleet._process

    def dies_once(*args):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("worker died")
        return real(*args)

    monkeypatch.setattr(fleet, "_process", dies_once)
    before = register().serve_retry.get("worker_death")
    [r] = fleet.run([WhatIfRequest(pods=pods, snapshot=snap)])
    assert r.ok
    assert register().serve_retry.get("worker_death") == before + 1


def test_serve_cli_chaos_plan(tmp_path, capsys):
    podspec = tmp_path / "pods.json"
    podspec.write_text(json.dumps([{
        "name": "web", "num": 6,
        "pod": {"metadata": {"name": "web"},
                "spec": {"containers": [{"resources": {"requests": {
                    "cpu": "500m", "memory": "1Gi"}}}]}}}]))
    plan = tmp_path / "storm.json"
    plan.write_text(json.dumps({"device": {
        "faults": {str(i): "exception" for i in range(64)},
        "failure_threshold": 1, "cooldown": 100000}}))
    args = ["serve", "--synthetic-nodes", "8", "--podspec", str(podspec),
            "--requests", "6", "--bucket-size", "2", "--chaos-plan",
            str(plan), "--quiet", "--warm-repeats", "0"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert port_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    line = [x for x in got.splitlines() if x.startswith("cold:")][0]
    assert "6/6 ok (0 rejected, 0 failed, 6 degraded)" in line
    assert line.split(",")[0] == [x for x in want.splitlines()
                                  if x.startswith("cold:")][0].split(",")[0]
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    args[args.index(str(plan))] = str(bad)
    assert jax_main(args) == 2
    want_err = capsys.readouterr().err
    assert port_main(args + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == want_err
