"""Crash recovery of the port's streaming twin under random crashes, on the
CPU: every run must recover to the uninterrupted run's fold chain with a
clean journal audit (chaos.engine.audit_failover: no pod lost, no double
bind, no bind outside its batch, and so no cycle's bind journaled twice).

The fixed cases are feeds on which recovery once journaled a durable bind
a second time: a crash between a cycle's bind and emit records re-decides
the cycle, and the re-decision must adopt the durable bind record instead
of appending another. Two are pipelined feeds whose cycle in flight at the
last checkpoint had its bind durable; on the third the JAX package's
recovery journals the duplicate too. The random campaign varies nodes,
cycles, arrivals, evictions, flaps, the driver and the checkpoint cadence,
and crashes each run at a random cycle and CRASH_POINTS point; seeds 0-9
run in tier-1, 10-119 are marked slow. A failing seed replays from
`campaign(seed)`. Tolerance: exact (chains and audits equal).
"""

import random

import pytest

from tpusim.chaos.engine import audit_failover as jax_audit_failover
from tpusim.chaos.plan import ChurnEvent as JaxEvent
from tpusim.chaos.plan import FaultPlan as JaxPlan
from tpusim.jaxe.backend import uninstall_chaos as jax_uninstall
from tpusim.simulator import run_stream_simulation as jax_stream
from tpusim.stream.persist import read_wal as jax_read_wal

from tpusim_torch.backend import uninstall_chaos
from tpusim_torch.chaos.engine import ProcessCrash, audit_failover
from tpusim_torch.chaos.plan import ChurnEvent, FaultPlan
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import CRASH_POINTS, read_wal

TIER1_SEEDS = 10
ALL_SEEDS = 120


@pytest.fixture(autouse=True)
def _no_chaos_seam():
    uninstall_chaos()
    jax_uninstall()
    yield
    uninstall_chaos()
    jax_uninstall()


def crash_plan(at, point):
    return FaultPlan(seed=5, churn=[ChurnEvent(at=at, action="process_crash",
                                               target=point)])


def audit(ckdir):
    return audit_failover(read_wal(str(ckdir / "wal.jsonl"))[0])


def crash_and_recover(tmp_path, shape, at, point):
    """(uninterrupted run, crash run or None if the crash never fired,
    recovered run) of the port on `shape`."""
    base = run_stream_simulation(checkpoint_dir=str(tmp_path / "base"),
                                 device="cpu", **shape)
    ck = str(tmp_path / "crash")
    try:
        out = run_stream_simulation(checkpoint_dir=ck, device="cpu",
                                    chaos_plan=crash_plan(at, point), **shape)
        return base, out, None   # an events crash on a cycle without events
    except ProcessCrash:
        pass
    rec = run_stream_simulation(checkpoint_dir=ck, device="cpu",
                                recover=True, **shape)
    return base, None, rec


FIXED = {
    # pipelined: the cycle in flight at the last checkpoint had its bind
    # record durable when the process died
    "pipelined-bind": (dict(num_nodes=20, cycles=10, arrivals=6,
                            evict_fraction=0.0, seed=24, checkpoint_every=1,
                            pipeline=True), 3, "bind"),
    "pipelined-events": (dict(num_nodes=23, cycles=10, arrivals=15,
                              evict_fraction=0.25, seed=11,
                              checkpoint_every=2, pipeline=True), 7,
                         "events"),
    # synchronous, where the JAX package's recovery journals the bind twice
    "sync-bind": (dict(num_nodes=16, cycles=8, arrivals=16,
                       node_flap_every=3, seed=5, checkpoint_every=5), 4,
                  "bind"),
}


@pytest.mark.parametrize("name", sorted(FIXED))
def test_durable_bind_is_adopted(tmp_path, name):
    shape, at, point = FIXED[name]
    base, fired_not, rec = crash_and_recover(tmp_path, shape, at, point)
    assert fired_not is None, "the crash must fire"
    assert rec["fold_chain"] == base["fold_chain"]
    assert rec["recovery_violations"] == []
    assert rec["recomputed_cycles"] == [at if point == "bind" else at - 1]
    assert audit(tmp_path / "crash") == []
    if name == "sync-bind":
        # the same crash and recovery in the JAX package: its chain is
        # right, its audit finds the duplicate the port no longer writes
        jd = str(tmp_path / "jax")
        with pytest.raises(Exception):
            jax_stream(checkpoint_dir=jd, chaos_plan=JaxPlan(
                seed=5, churn=[JaxEvent(at=at, action="process_crash",
                                        target=point)]), **shape)
        jax_rec = jax_stream(checkpoint_dir=jd, recover=True, **shape)
        assert jax_rec["fold_chain"] == rec["fold_chain"]
        found = jax_audit_failover(jax_read_wal(jd + "/wal.jsonl")[0])
        assert found and all("bind entries" in v for v in found)


def campaign(seed: int):
    """The seed's (shape, crash cycle, crash point)."""
    rng = random.Random(seed)
    cycles = rng.randint(4, 10)
    shape = dict(num_nodes=rng.randint(8, 24), cycles=cycles,
                 arrivals=rng.randint(4, 16),
                 evict_fraction=rng.choice([0.0, 0.25]),
                 node_flap_every=rng.choice([0, 3]),
                 seed=rng.randint(0, 99),
                 checkpoint_every=rng.choice([1, 2, 3, 5]),
                 pipeline=rng.random() < 0.5)
    return shape, rng.randint(1, cycles - 1), rng.choice(CRASH_POINTS)


@pytest.mark.parametrize("seed", [
    s if s < TIER1_SEEDS else pytest.param(s, marks=pytest.mark.slow)
    for s in range(ALL_SEEDS)])
def test_random_crash_recovers(tmp_path, seed):
    shape, at, point = campaign(seed)
    base, clean, rec = crash_and_recover(tmp_path, shape, at, point)
    if clean is not None:
        assert clean["fold_chain"] == base["fold_chain"], (seed, shape)
        assert audit(tmp_path / "crash") == [], (seed, shape)
        return
    assert rec["fold_chain"] == base["fold_chain"], (seed, shape, at, point)
    assert rec["recovery_violations"] == [], (seed, shape, at, point)
    # the recovered session restages once, at the first cycle it decides
    # (a re-decided crash tail or a cycle left to run), if there is one
    decides = bool(rec["recomputed_cycles"]) or \
        rec["resume_cycle"] < shape["cycles"]
    assert rec["restages"].get("recovered", 0) == int(decides), \
        (seed, shape, at, point)
    assert audit(tmp_path / "crash") == [], (seed, shape, at, point)
