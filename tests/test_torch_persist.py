"""The port's durability of the streaming twin (tpusim_torch/stream/
persist.py: the WAL, checkpoints and crash recovery, and the device chaos
of the stream runtime) against the JAX package's, on the CPU.

On the same seeded runs the port's WAL must equal the JAX package's line
for line and its checkpoint.json key for key, apart from the plan's repr,
the device image's file name and the shard layout. A crash at each of the
four CRASH_POINTS, at checkpoint cadences 1 and 5, in the synchronous and
the pipelined driver, must recover to the uninterrupted run's fold chain,
as must a crash directory the JAX package wrote. Device faults in a stream
must give the JAX package's chains, paths, restages and breaker trail.
Tolerance: exact (files, hashes and counts equal).

One case is not held to the JAX package: a pipelined crash before the emit
record of the cycle in flight at the last checkpoint. The JAX package's
recovery loses that cycle (test_pipelined_in_flight_cycle_recovers), the
port's recovers it.
"""

import json
import os
import shutil

import pytest

from tpusim.chaos.engine import ProcessCrash as JaxCrash
from tpusim.chaos.plan import ChurnEvent as JaxEvent
from tpusim.chaos.plan import DeviceFaultPlan as JaxDevicePlan
from tpusim.chaos.plan import FaultPlan as JaxPlan
from tpusim.cli import main as jax_main
from tpusim.jaxe.backend import uninstall_chaos as jax_uninstall
from tpusim.simulator import run_stream_simulation as jax_stream
from tpusim.stream.persist import read_wal as jax_read_wal
from tpusim.stream.persist import tail_wal as jax_tail_wal

from tpusim_torch.backend import uninstall_chaos
from tpusim_torch.chaos.engine import ProcessCrash, audit_failover
from tpusim_torch.chaos.plan import ChurnEvent, DeviceFaultPlan, FaultPlan
from tpusim_torch.cli import main as port_main
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import (
    CRASH_POINTS,
    PersistError,
    chain_fold,
    read_wal,
    tail_wal,
)

CYCLES = 8
SHAPE = dict(num_nodes=12, cycles=CYCLES, arrivals=8, evict_fraction=0.25,
             node_flap_every=3, seed=5)
# the keys a checkpoint of the port may write otherwise: the plan's repr,
# the device image named after it, and the (absent) shard layout
CK_OWN = ("plan_sig", "device_npz", "shard_layout")


@pytest.fixture(autouse=True)
def _no_chaos_seam():
    uninstall_chaos()
    jax_uninstall()
    yield
    uninstall_chaos()
    jax_uninstall()


def port_run(ckdir, **kw):
    kw.setdefault("checkpoint_every", 2)
    return run_stream_simulation(checkpoint_dir=str(ckdir), device="cpu",
                                 **SHAPE, **kw)


def jax_run(ckdir, **kw):
    kw.setdefault("checkpoint_every", 2)
    return jax_stream(checkpoint_dir=str(ckdir), **SHAPE, **kw)


def crash(plans, at, point):
    return plans[0](seed=5, churn=[plans[1](at=at, action="process_crash",
                                            target=point)])


PORT = (FaultPlan, ChurnEvent)
JAX = (JaxPlan, JaxEvent)


def wal_lines(ckdir):
    with open(os.path.join(ckdir, "wal.jsonl")) as f:
        return f.read().splitlines()


def checkpoint(ckdir):
    with open(os.path.join(ckdir, "checkpoint.json")) as f:
        ck = json.load(f)
    for key in CK_OWN:
        ck.pop(key)
    return ck


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """The uninterrupted runs of both packages, one a driver."""
    out = {}
    for pipeline in (False, True):
        jd = tmp_path_factory.mktemp(f"jax-{pipeline}")
        pd = tmp_path_factory.mktemp(f"port-{pipeline}")
        out[pipeline] = (jax_run(jd, pipeline=pipeline),
                         port_run(pd, pipeline=pipeline), jd, pd)
    return out


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
def test_wal_and_checkpoint_equal(baselines, pipeline):
    want, got, jd, pd = baselines[pipeline]
    assert wal_lines(pd) == wal_lines(jd)
    assert checkpoint(pd) == checkpoint(jd)
    for key in ("fold_chain", "placement_chain", "wal_records",
                "checkpoints", "wal_chain", "paths", "restages", "commits"):
        assert got[key] == want[key], key
    assert got["wal_chain"] == got["fold_chain"]
    records = [r for _, r in read_wal(str(pd / "wal.jsonl"))[0]]
    assert {"batch", "bind", "emit"} <= {r["k"] for r in records}
    chain = ""
    for r in records:
        if r["k"] == "emit":
            chain = chain_fold(chain, r["h"])
    assert chain == got["fold_chain"]


def test_fsync_stamp(tmp_path):
    want = jax_run(tmp_path / "j", fsync_every=3, checkpoint_every=4)
    got = port_run(tmp_path / "p", fsync_every=3, checkpoint_every=4)
    assert got["fold_chain"] == want["fold_chain"]
    ck = checkpoint(tmp_path / "p")
    assert ck == checkpoint(tmp_path / "j")
    assert ck["durability"] == {"mode": "fsync", "fsync_every": 3}
    assert checkpoint(tmp_path / "p")["device_bound"] == ck["bound_pods"]


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("cadence", [1, 5])
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_recovery_chain(tmp_path, baselines, pipeline, cadence,
                              point):
    """The crash run's WAL equals the JAX package's up to the crash; the
    port's recovery gives the uninterrupted chain, the recovery restage
    classified once."""
    want, base, _jd, _pd = baselines[pipeline]
    assert base["fold_chain"] == want["fold_chain"]
    with pytest.raises(JaxCrash):
        jax_run(tmp_path / "j", pipeline=pipeline, checkpoint_every=cadence,
                chaos_plan=crash(JAX, 4, point))
    with pytest.raises(ProcessCrash):
        port_run(tmp_path / "p", pipeline=pipeline,
                 checkpoint_every=cadence, chaos_plan=crash(PORT, 4, point))
    assert wal_lines(tmp_path / "p") == wal_lines(tmp_path / "j")
    assert checkpoint(tmp_path / "p") == checkpoint(tmp_path / "j")
    out = port_run(tmp_path / "p", pipeline=pipeline,
                   checkpoint_every=cadence, recover=True)
    assert out["recovered"]
    assert out["fold_chain"] == base["fold_chain"]
    assert out["recovery_violations"] == []
    assert out["restages"].get("recovered") == 1
    assert out["resume_cycle"] <= CYCLES
    # no cycle's bind is journaled twice (a crash between a cycle's bind
    # and emit records re-decides it against its durable bind record)
    assert audit_failover(read_wal(str(tmp_path / "p" / "wal.jsonl"))[0]) == []


@pytest.mark.parametrize("pipeline,point,cadence", [
    (False, "bind", 2), (False, "emit", 1), (True, "events", 5),
    (True, "emit", 2)])
def test_jax_written_crash_recovers_in_the_port(tmp_path, baselines,
                                                pipeline, point, cadence):
    want, _, _jd, _pd = baselines[pipeline]
    with pytest.raises(JaxCrash):
        jax_run(tmp_path / "j", pipeline=pipeline, checkpoint_every=cadence,
                chaos_plan=crash(JAX, 5, point))
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    jax_out = jax_run(tmp_path / "j", pipeline=pipeline,
                      checkpoint_every=cadence, recover=True)
    out = port_run(tmp_path / "p", pipeline=pipeline,
                   checkpoint_every=cadence, recover=True)
    assert out["fold_chain"] == jax_out["fold_chain"] == want["fold_chain"]
    for key in ("resume_cycle", "recomputed_cycles", "recovery_violations",
                "checkpoints", "restages", "paths"):
        assert out[key] == jax_out[key], key
    jax_wal, port_wal = wal_lines(tmp_path / "j"), wal_lines(tmp_path / "p")
    jax_audit = audit_failover(jax_read_wal(str(tmp_path / "j" / "wal.jsonl"))[0])
    assert audit_failover(read_wal(str(tmp_path / "p" / "wal.jsonl"))[0]) == []
    if point == "bind":
        # a crash after the bind record: the JAX recovery journals that
        # cycle's bind a second time, the port's adopts the durable one. The
        # port's WAL is the JAX WAL less exactly that duplicate line
        dup = [i for i, line in enumerate(jax_wal)
               if line in jax_wal[:i] and json.loads(line)["k"] == "bind"]
        assert len(dup) == 1
        assert port_wal == jax_wal[:dup[0]] + jax_wal[dup[0] + 1:]
        assert out["wal_records"] == jax_out["wal_records"] - 1
        assert jax_audit and all("bind entries" in v for v in jax_audit)
    else:
        assert port_wal == jax_wal
        assert out["wal_records"] == jax_out["wal_records"]
        assert jax_audit == []


def test_pipelined_in_flight_cycle_recovers(tmp_path):
    """A pipelined checkpoint is cut while the next cycle is in flight, so
    that cycle's batch record lies before the checkpoint's offset. A crash
    before its emit record: the JAX package's recovery never re-decides
    that cycle (on this feed its chain differs from the uninterrupted
    run's), the port's does."""
    shape = dict(num_nodes=12, cycles=CYCLES, arrivals=6, seed=3,
                 pipeline=True, checkpoint_every=1)
    want = jax_stream(checkpoint_dir=str(tmp_path / "base"), **shape)
    with pytest.raises(JaxCrash):
        jax_stream(checkpoint_dir=str(tmp_path / "j"),
                   chaos_plan=crash(JAX, 4, "batch"), **shape)
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    jax_out = jax_stream(checkpoint_dir=str(tmp_path / "j"), recover=True,
                         **shape)
    out = run_stream_simulation(checkpoint_dir=str(tmp_path / "p"),
                                recover=True, device="cpu", **shape)
    assert jax_out["fold_chain"] != want["fold_chain"]
    assert jax_out["recomputed_cycles"] == [4]
    assert out["fold_chain"] == want["fold_chain"]
    assert out["recomputed_cycles"] == [3, 4]
    assert out["recovery_violations"] == []


def test_recovered_run_crashes_and_recovers_again(tmp_path, baselines):
    _, base, _jd, _pd = baselines[False]
    with pytest.raises(ProcessCrash):
        port_run(tmp_path, chaos_plan=crash(PORT, 3, "bind"))
    with pytest.raises(ProcessCrash):
        port_run(tmp_path, recover=True, chaos_plan=crash(PORT, 6, "emit"))
    out = port_run(tmp_path, recover=True)
    assert out["fold_chain"] == base["fold_chain"]
    assert out["recovery_violations"] == []


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("verify", ["all", "probe"])
def test_stream_device_chaos(tmp_path, pipeline, verify):
    """Device faults in a journaled stream: the breaker's host answers,
    classified restages and the WAL equal the JAX package's; a chaos seam
    runs the pipelined driver synchronously."""
    faults = {1: "exception", 3: "corrupt_invalid", 5: "corrupt_silent",
              9: "exception"}
    want = jax_run(tmp_path / "j", pipeline=pipeline,
                   chaos_plan=JaxPlan(seed=0, device=JaxDevicePlan(
                       faults=faults, failure_threshold=1, cooldown=1,
                       verify=verify)))
    got = port_run(tmp_path / "p", pipeline=pipeline,
                   chaos_plan=FaultPlan(seed=0, device=DeviceFaultPlan(
                       faults=faults, failure_threshold=1, cooldown=1,
                       verify=verify)))
    for key in ("fold_chain", "placement_chain", "paths", "restages",
                "breaker_transitions", "commits", "wal_records"):
        assert got[key] == want[key], key
    assert got["breaker_transitions"]
    assert "pipelined" not in got["paths"]
    assert wal_lines(tmp_path / "p") == wal_lines(tmp_path / "j")


def test_torn_line_policy(tmp_path, baselines):
    _, _, _jd, pd = baselines[False]
    path = tmp_path / "wal.jsonl"
    shutil.copy(pd / "wal.jsonl", path)
    whole, violations = read_wal(str(path))
    assert violations == []
    with open(path, "a") as f:
        f.write('{"k":"emit","c":99,')  # the crash mid-append
    assert read_wal(str(path)) == jax_read_wal(str(path))
    reread, violations = read_wal(str(path))
    assert violations == [] and reread == whole
    got = tail_wal(str(path), whole[3][0])
    assert got == jax_tail_wal(str(path), whole[3][0])
    assert got[2] < os.path.getsize(path)
    torn = tmp_path / "torn.jsonl"
    with open(torn, "w") as f:
        f.write(json.dumps({"k": "batch", "c": 0, "pods": []}) + "\n")
        f.write('{"k":"bind","c":0,\n')  # torn but NOT final: corruption
        f.write(json.dumps({"k": "emit", "c": 0, "h": "x", "n": 0,
                            "s": 0}) + "\n")
    assert read_wal(str(torn)) == jax_read_wal(str(torn))
    assert read_wal(str(torn))[1]


def test_validation_errors_word_for_word(tmp_path):
    cases = [
        dict(chaos_plan=JAX), dict(recover=True),
        dict(recover=True, verify=True, checkpoint_dir=str(tmp_path)),
        dict(chaos_plan="churn")]
    for case in cases:
        jkw, pkw = dict(case), dict(case)
        if case.get("chaos_plan") is JAX:
            jkw["chaos_plan"] = crash(JAX, 1, "emit")
            pkw["chaos_plan"] = crash(PORT, 1, "emit")
        elif case.get("chaos_plan") == "churn":
            jkw["chaos_plan"] = JaxPlan(seed=0, churn=[JaxEvent(
                at=1, action="node_delete", target="node-0")])
            pkw["chaos_plan"] = FaultPlan(seed=0, churn=[ChurnEvent(
                at=1, action="node_delete", target="node-0")])
        with pytest.raises(ValueError) as want:
            jax_stream(num_nodes=8, cycles=2, arrivals=4, **jkw)
        jax_uninstall()
        with pytest.raises(ValueError) as got:
            run_stream_simulation(num_nodes=8, cycles=2, arrivals=4,
                                  device="cpu", **pkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(PersistError) as got:
        port_run(tmp_path / "nothing-here", recover=True)
    assert "no checkpoint/WAL pair to recover from" in str(got.value)


def test_stream_cli_crash_and_recover(tmp_path, capsys):
    plan = tmp_path / "crash.json"
    plan.write_text(json.dumps({"seed": 5, "churn": [
        {"at": 6, "action": "process_crash", "target": "bind"}]}))
    common = ["--synthetic-nodes", "8", "--cycles", "10", "--arrivals", "6",
              "--checkpoint-every", "3"]
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        ck = str(tmp_path / name)
        assert main(["stream", *common, "--checkpoint-dir", ck,
                     "--chaos-plan", str(plan), *extra]) == 3
        err = capsys.readouterr().err
        assert "crashed: chaos: injected process crash after the bind " \
               "record of cycle 6" in err
        assert f"stream --checkpoint-dir {ck} --recover" in err
        assert main(["stream", *common, "--checkpoint-dir", ck, "--recover",
                     "--json", *extra]) == 0
        outs[name] = json.loads(capsys.readouterr().out)
        clean = str(tmp_path / (name + "-clean"))
        assert main(["stream", *common, "--checkpoint-dir", clean, "--json",
                     *extra]) == 0
        outs[name + "-clean"] = json.loads(capsys.readouterr().out)
    for key in ("fold_chain", "resume_cycle", "recomputed_cycles",
                "recovery_violations", "restages", "paths", "checkpoints",
                "recovered"):
        assert outs["port"][key] == outs["jax"][key], key
    # the crash fell after cycle 6's bind record: the JAX recovery journals
    # that bind a second time, the port's adopts it
    assert outs["port"]["wal_records"] == outs["jax"]["wal_records"] - 1
    assert audit_failover(read_wal(str(tmp_path / "port" / "wal.jsonl"))[0]) \
        == []
    assert outs["port"]["fold_chain"] == outs["port-clean"]["fold_chain"]
    assert outs["port-clean"]["fold_chain"] == outs["jax-clean"]["fold_chain"]
