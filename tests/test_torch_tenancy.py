"""The port's multi-tenant residency ledger (tpusim_torch/stream/tenancy.py)
against the JAX package's, on the CPU.

Every case of tests/test_tenancy.py runs on both packages in lockstep:
the same tenants, seeds and touches. A twin's bytes differ between the
packages (the port's statics hold int64 index tensors), so each ledger's
budget is set as a multiple of ITS OWN twin's measured bytes, as
tests/test_tenancy.py does; the eviction sequence, the restores, the
residency after every step and each tenant's chain head after every
eviction and restore must then be equal. Tolerance: exact.
"""

from types import SimpleNamespace

import pytest

from tpusim.api.snapshot import synthetic_cluster as jax_cluster
from tpusim.backends import placement_hash as jax_hash
from tpusim.chaos.engine import ProcessCrash as JaxCrash
from tpusim.framework.metrics import register as jax_register
from tpusim.jaxe.whatif import run_what_if as jax_what_if
from tpusim.obs import analytics as jax_analytics
from tpusim.stream import ChurnLoadGen as JaxGen
from tpusim.stream import ResidencyBudget as JaxBudget
from tpusim.stream import StreamPersistence as JaxPersistence
from tpusim.stream import StreamSession as JaxSession

from tpusim_torch.api.snapshot import synthetic_cluster
from tpusim_torch.backends import placement_hash
from tpusim_torch.chaos.engine import ProcessCrash
from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import analytics
from tpusim_torch.stream import (
    ChurnLoadGen,
    ResidencyBudget,
    StreamPersistence,
    StreamSession,
)
from tpusim_torch.whatif import run_what_if

NODES = 8
ARRIVALS = 8
HUGE = 1 << 40

PORT = SimpleNamespace(
    name="port", cluster=synthetic_cluster, gen=ChurnLoadGen,
    budget=lambda b: ResidencyBudget(b, device="cpu"),
    session=lambda snap: StreamSession(snap, device="cpu"),
    persistence=StreamPersistence, crash=ProcessCrash,
    what_if=lambda sc: run_what_if(sc, device="cpu"), hash=placement_hash,
    register=register, analytics=analytics)
JAX = SimpleNamespace(
    name="jax", cluster=jax_cluster, gen=JaxGen, budget=JaxBudget,
    session=JaxSession, persistence=JaxPersistence, crash=JaxCrash,
    what_if=jax_what_if, hash=jax_hash, register=jax_register,
    analytics=jax_analytics)


def _gen(pkg, seed=3):
    return pkg.gen(pkg.cluster(NODES), seed=seed, arrivals=ARRIVALS,
                   evict_fraction=0.25)


def _drive(budget, name, gen, cycles, start=0):
    for c in range(start, cycles):
        budget.session(name).apply_events(gen.events(c))
        gen.note_bound(budget.schedule(name, gen.batch()))


def _admit(pkg, budget, name, tmp_path):
    budget.admit(name, pkg.cluster(NODES),
                 directory=str(tmp_path / pkg.name / name),
                 checkpoint_every=2)


def _state(budget):
    """What the two packages' ledgers must agree on after a step."""
    return ({n: budget.resident(n) for n in budget.tenants()},
            {n: budget.chain(n) for n in budget.tenants()},
            {n: (t.evictions, t.restores)
             for n, t in budget._tenants.items()})


def _reference_heads(pkg, directory, cycles, seed=3):
    """persist.chain after each cycle of an uninterrupted run: the oracle
    the ledger's round trips are held to."""
    session = pkg.session(pkg.cluster(NODES))
    persist = pkg.persistence(str(directory), checkpoint_every=2)
    persist.attach(session)
    gen = _gen(pkg, seed)
    heads = []
    for c in range(cycles):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
        heads.append(persist.chain)
    persist.close()
    return heads


def test_evict_restore_round_trip_chain_intact(tmp_path):
    heads = _reference_heads(PORT, tmp_path / "ref", 8)
    assert heads == _reference_heads(JAX, tmp_path / "jref", 8)
    logs = {}
    for pkg in (PORT, JAX):
        budget = pkg.budget(HUGE)
        _admit(pkg, budget, "a", tmp_path)
        gen = _gen(pkg)
        log = []
        _drive(budget, "a", gen, 4)
        assert budget.chain("a") == heads[3]
        budget.evict("a")
        assert not budget.resident("a")
        # the durable manifest carries the chain head across the gap
        assert budget.chain("a") == heads[3]
        log.append(_state(budget))
        # session() restores on demand; the resumed run folds on to the
        # uninterrupted run's head
        _drive(budget, "a", gen, 8, start=4)
        log.append(_state(budget))
        assert budget.resident("a")
        assert budget.chain("a") == heads[7]
        t = budget._tenants["a"]
        assert t.evictions == 1 and t.restores == 1
        assert t.session.restage_counts.get("recovered") == 1
        logs[pkg.name] = log
    assert logs["port"] == logs["jax"]


def test_lru_pressure_evicts_coldest(tmp_path):
    logs = {}
    for pkg in (PORT, JAX):
        budget = pkg.budget(HUGE)
        _admit(pkg, budget, "a", tmp_path)
        gen_a = _gen(pkg, 1)
        _drive(budget, "a", gen_a, 1)
        per_twin = budget._tenants["a"].nbytes()
        assert per_twin > 0
        # room for ~1.5 of THIS package's twins: driving the second tenant
        # must push the first (the coldest) out, never the one touched
        budget.budget_bytes = int(per_twin * 1.5)
        before = pkg.register().tenant_evictions.values.get("pressure", 0)
        _admit(pkg, budget, "b", tmp_path)
        gen_b = _gen(pkg, 2)
        log = [_state(budget)]
        _drive(budget, "b", gen_b, 2)
        log.append(_state(budget))
        assert not budget.resident("a")
        assert budget.resident("b")
        assert pkg.register().tenant_evictions.values.get(
            "pressure", 0) == before + 1
        # touching the evicted tenant swings the LRU the other way: the
        # restored twin's bytes land at its first restaged cycle, so the
        # SECOND touch is the one that evicts the now colder tenant
        _drive(budget, "a", gen_a, 3, start=1)
        log.append(_state(budget))
        assert budget.resident("a")
        assert not budget.resident("b")
        assert budget.total_bytes() <= budget.budget_bytes
        logs[pkg.name] = log
    assert logs["port"] == logs["jax"]


def test_restore_on_demand_then_overlay_parity(tmp_path):
    hashes = {}
    for pkg in (PORT, JAX):
        budget = pkg.budget(HUGE)
        _admit(pkg, budget, "a", tmp_path)
        gen = _gen(pkg)
        _drive(budget, "a", gen, 3)
        budget.evict("a")
        # schedule() through the ledger restores transparently (the restage
        # is classified "recovered"); the twin then answers overlay queries
        # with the staged oracle's placement hash
        _drive(budget, "a", gen, 4, start=3)
        qpods = _gen(pkg, 9).batch()[:4]
        placements = budget.overlay_query("a", qpods)
        assert placements is not None, "restored twin refused the overlay"
        [oracle] = pkg.what_if(
            [(budget.session("a").inc.to_snapshot(), qpods)])
        assert pkg.hash(placements) == pkg.hash(oracle.placements)
        hashes[pkg.name] = (pkg.hash(placements), budget.chain("a"))
    assert hashes["port"] == hashes["jax"]


def test_process_crash_recovers_through_ledger(tmp_path):
    """A chaos process_crash mid-run: the tenant's directory is the whole
    twin, and restore() recovers to the last durable cycle's chain head;
    the session schedules again."""
    heads = _reference_heads(PORT, tmp_path / "ref", 3)
    out = {}
    for pkg in (PORT, JAX):
        budget = pkg.budget(HUGE)
        _admit(pkg, budget, "c", tmp_path)
        t = budget._tenants["c"]
        t.persist.arm_crash(2, "emit")
        gen = _gen(pkg)
        with pytest.raises(pkg.crash):
            _drive(budget, "c", gen, 8)
        # the process died: its live session and WAL handle are gone
        t.session = None
        t.persist = None
        assert not budget.resident("c")
        budget.restore("c")
        assert budget.resident("c")
        assert budget.chain("c") == heads[2]
        assert t.restores == 1
        # the recovered twin serves: a fresh batch schedules cleanly
        placements = budget.schedule("c", _gen(pkg, 11).batch()[:4])
        assert len(placements) == 4
        assert t.session.restage_counts.get("recovered") == 1
        out[pkg.name] = (pkg.hash(placements), budget.chain("c"))
    assert out["port"] == out["jax"]


def test_hbm_snapshot_attributes_tenant_bytes(tmp_path):
    budget = ResidencyBudget(HUGE, device="cpu")
    for name in ("x", "y"):
        _admit(PORT, budget, name, tmp_path)
    _drive(budget, "x", _gen(PORT, 4), 1)
    _drive(budget, "y", _gen(PORT, 5), 1)
    snap = analytics.hbm_snapshot()
    tenants = snap["tenant_twin"]["tenants"]
    assert tenants.get("x", 0) > 0 and tenants.get("y", 0) > 0
    assert snap["tenant_twin"]["bytes"] == tenants["x"] + tenants["y"]
    assert tenants["x"] == budget._tenants["x"].nbytes()
    dev_x = budget._tenants["x"].session.device
    budget.evict("x")
    snap = analytics.hbm_snapshot()
    assert snap["tenant_twin"]["tenants"].get("x", 0) == 0
    # an evicted twin gives its tensors and programs back, not only its
    # ledger entry (a caller may still hold the session)
    assert dev_x.statics is None and dev_x.carry is None
    assert dev_x._programs == {}
    # the gauges mirror the ledger
    m = register()
    assert m.tenant_resident_bytes.values.get("x") == 0.0
    assert m.tenant_resident_bytes.values.get("y", 0) > 0
