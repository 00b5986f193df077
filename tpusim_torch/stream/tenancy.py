"""Multi-tenant residency ledger: many live twins, one card's memory.

A serving deployment keeps one device-resident twin a tenant cluster so
overlay what-if queries answer in O(scenario), but device memory is finite:
the ResidencyBudget holds every tenant's footprint under a byte budget by
evicting the coldest twin to its checkpoint directory (stream.persist) and
restoring it on demand in O(WAL tail) through recover_stream_session.
Eviction is a clean handoff, not a loss:

  evict    flush() the pipelined tail -> checkpoint() (the durable manifest
           and the device image) -> close the WAL -> release the twin's
           device memory (DeviceResidentCluster.release: its tensors and
           the graphs bound to them) -> drop the session. The twin's
           placement chain head is in the manifest.
  restore  recover_stream_session on the same directory: the checkpoint
           and a replay of the WAL tail rebuild the host picture; the next
           cycle restages, classified ``recovered``. The chain head folds
           on from exactly where eviction cut it.

A twin's bytes are its resident tensors' (analytics.tree_nbytes of the
statics and carry), so a budget is a multiple of the port's own twin's
bytes: the port's statics hold int64 index tensors, and its twins are not
the JAX package's size. Each tenant registers a ``tenant_twin`` residency
source with its bytes attributed to it (analytics.hbm_snapshot()
["tenant_twin"]["tenants"], tpusim_hbm_resident_bytes), and the ledger's
own families (tpusim_tenant_*) count evictions, restores, the restore
latency and each tenant's resident bytes. Sessions run on ``device``
("cuda" by default, or "cpu").
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.engine.providers import DEFAULT_PROVIDER
from tpusim_torch.framework.metrics import register, since_in_microseconds
from tpusim_torch.obs import analytics
from tpusim_torch.obs import recorder as flight


class TenantTwin:
    """One tenant's slot in the ledger: the live session and persistence
    while resident, the checkpoint directory always. The record is the
    stable owner of the tenant's residency source across evictions and
    restores (analytics holds it weakly, so dropping the ledger drops the
    source)."""

    def __init__(self, name: str, directory: str, provider: str,
                 policy, always_restage: bool, checkpoint_every: int,
                 fsync_every: int, device="cuda"):
        self.name = name
        self.directory = directory
        self.provider = provider
        self.policy = policy
        self.always_restage = always_restage
        self.checkpoint_every = checkpoint_every
        self.fsync_every = fsync_every
        self.device = device
        self.session = None
        self.persist = None
        self.last_used = 0.0
        self.evictions = 0
        self.restores = 0

    @property
    def resident(self) -> bool:
        # the ledger's residency, not the device's: a session restored just
        # now holds host truth and restages its twin at its first cycle
        # (nbytes() is 0 until then)
        return self.session is not None

    def nbytes(self) -> int:
        """Device bytes this tenant holds resident right now."""
        if self.session is None:
            return 0
        dev = self.session.device
        if not dev.valid:
            return 0
        return analytics.tree_nbytes((dev.statics, dev.carry))

    def chain(self) -> str:
        """The tenant's placement chain head: live from the attached
        persistence, or the durable manifest's when evicted."""
        if self.persist is not None:
            return self.persist.chain
        import json
        import os

        from tpusim_torch.stream.persist import StreamPersistence

        path = os.path.join(self.directory, StreamPersistence.CHECKPOINT)
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)["chain"]


class ResidencyBudget:
    """An LRU ledger over tenant twins under a device byte budget. Touching
    a tenant (session()/overlay_query()/schedule()) restores it on demand
    and may evict colder tenants to stay under budget; the toucher itself
    is never its own victim."""

    def __init__(self, budget_bytes: int, *, clock=time.monotonic,
                 device="cuda"):
        self.budget_bytes = int(budget_bytes)
        self._clock = clock
        self.device = device
        self._tenants: Dict[str, TenantTwin] = {}

    # -- admission ---------------------------------------------------------

    def admit(self, name: str, snapshot: Optional[ClusterSnapshot] = None,
              *, directory: str, provider: str = DEFAULT_PROVIDER,
              policy=None, always_restage: bool = False,
              checkpoint_every: int = 0, fsync_every: int = 0):
        """Bring a tenant under the ledger: a fresh StreamSession over its
        snapshot, persistence attached in `directory` (the eviction
        target), and a residency source of its own. Returns the session."""
        if name in self._tenants:
            raise KeyError(f"tenant {name!r} already admitted")
        from tpusim_torch.stream.persist import StreamPersistence
        from tpusim_torch.stream.runtime import StreamSession

        t = TenantTwin(name, directory, provider, policy, always_restage,
                       checkpoint_every, fsync_every, device=self.device)
        t.session = StreamSession(snapshot, provider=provider, policy=policy,
                                  always_restage=always_restage,
                                  device=self.device)
        t.persist = StreamPersistence(directory,
                                      checkpoint_every=checkpoint_every,
                                      fsync_every=fsync_every)
        t.persist.attach(t.session)
        t.last_used = self._clock()
        self._tenants[name] = t
        analytics.register_hbm_source(
            "tenant_twin", t, lambda tw: (tw.nbytes(), 1 if tw.resident
                                          else 0), tenant=name)
        self._enforce(protect=name)
        self._observe()
        return t.session

    def tenants(self) -> List[str]:
        return list(self._tenants)

    def resident(self, name: str) -> bool:
        return self._tenants[name].resident

    def chain(self, name: str) -> str:
        return self._tenants[name].chain()

    def total_bytes(self) -> int:
        return sum(t.nbytes() for t in self._tenants.values())

    # -- the serving surface ----------------------------------------------

    def session(self, name: str):
        """The tenant's live session, restored from its checkpoint and WAL
        tail first if evicted. Touching reorders the LRU and may evict a
        colder tenant to fund the restore."""
        t = self._tenants[name]
        if t.session is None:
            self.restore(name)
        t.last_used = self._clock()
        self._enforce(protect=name)
        self._observe()
        return t.session

    def overlay_query(self, name: str, pods):
        return self.session(name).overlay_query(pods)

    def schedule(self, name: str, pods):
        return self.session(name).schedule(pods)

    # -- eviction / restore ------------------------------------------------

    def evict(self, name: str, reason: str = "manual") -> None:
        """Quiesce and checkpoint the tenant's twin and release its device
        memory: the durable manifest (chain head, WAL offset, host
        snapshot) is the whole twin, and restore() rebuilds the same host
        truth from it."""
        t = self._tenants[name]
        if t.session is None:
            return
        t.session.flush()          # drain a pipelined cycle in flight
        t.persist.checkpoint()
        t.persist.close()
        # invalidate() alone keeps the tensors and graphs for a restage;
        # an evicted twin gives them back
        t.session.device.release()
        t.session = None
        t.persist = None
        t.evictions += 1
        register().tenant_evictions.inc(reason)
        flight.note_route("tenant_evict", 0)
        self._observe()

    def restore(self, name: str) -> None:
        """recover_stream_session over the tenant's directory: the
        checkpoint and a replay of the WAL tail, O(tail), not O(history).
        The session's next cycle restages, classified ``recovered``; the
        chain head continues from the eviction's manifest."""
        t = self._tenants[name]
        if t.session is not None:
            return
        from tpusim_torch.stream.persist import recover_stream_session

        t0 = time.perf_counter()
        session, _report, persist = recover_stream_session(
            t.directory, provider=t.provider, policy=t.policy,
            always_restage=t.always_restage,
            checkpoint_every=t.checkpoint_every, device=t.device)
        t.session = session
        t.persist = persist
        t.restores += 1
        m = register()
        m.tenant_restores.inc()
        m.tenant_restore_latency.observe(since_in_microseconds(t0))
        self._observe()

    def _enforce(self, protect: Optional[str] = None) -> None:
        """Evict coldest first until the ledger fits the budget. The tenant
        being touched is exempt: a single twin over the budget stays
        resident rather than thrashing."""
        while self.total_bytes() > self.budget_bytes:
            victims = sorted(
                (t for t in self._tenants.values()
                 if t.resident and t.name != protect),
                key=lambda t: t.last_used)
            if not victims:
                return
            self.evict(victims[0].name, reason="pressure")

    def _observe(self) -> None:
        m = register()
        resident = 0
        for t in self._tenants.values():
            nbytes = t.nbytes()
            resident += 1 if t.resident else 0
            m.tenant_resident_bytes.set(t.name, float(nbytes))
        m.tenant_resident_twins.set(float(resident))
