"""Bucket executor: staging caches, built programs, device dispatch.

Three caches keep repeat traffic off the slow paths, each a bounded LRU:

  staged scenarios: (cache_key, plan signature) -> host trees; a repeat
      query skips compile_cluster and the policy's tables.
  device batches: a bucket whose every member carries a cache_key keeps its
      stacked device trees; an exact repeat skips padding, stacking and the
      upload.
  programs: (shape class, plan signature, bucket size, config) -> a built
      scan.BatchedScan (its device buffers, its step and, on a CUDA device,
      its captured graph). Every bucket of a class has the same array
      shapes, so a warm dispatch copies the bucket into the program's
      buffers and replays it. whatif.compile_count() counts program builds;
      its delta across a dispatch stamps each response's compile_cache_hit.

One bucket runs as one batched program. Ghost scenarios (replicas of the
bucket's first entry) fill a partial bucket; decode walks only the real
entries. A device error propagates to the fleet, which resolves the
bucket's futures with it: there is no host answer, unless a chaos plan's
device section is installed (backend.install_chaos). Then dispatch() is the
chaos-hardened path: a scripted fault retries with exponential backoff under
the injected clock (tpusim_serve_retry_total{reason}), an open breaker or
exhausted retries answer the bucket by the host pipeline, and a half-open
probe, and every dispatch under verify="all", is checked against the host
pipeline; each host answer is counted (tpusim_serve_degraded_total{path})
and named in last_path, which the fleet copies into every response's
`degraded` field. Only chaos.engine.DeviceFault is retried: any other
error still raises.

Live twins: a StreamSession attached under a snapshot ref (attach_twin)
answers the requests naming that ref by an overlay query on its resident
carry (try_overlay), O(query) a request with no staging. Read replicas
(attach_replica: a stream.replicate.FollowerTwin) answer first, in the
order attached; the twin answers where every replica refuses. Where every
overlay refuses (the request names another plan, or each overlay_query
returns None), the request goes the staged path against the twin's CURRENT
host picture (session.inc.to_snapshot()), counted in
stats["overlay_fallbacks"] and tpusim_overlay_fallback_total{reason}. An
error inside an overlay raises.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpusim_torch import backend as _backend
from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.backend import _KNOWN_PROVIDERS
from tpusim_torch.backends import ReferenceBackend, placement_hash
from tpusim_torch.device import resolve_device
from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import analytics, provenance
from tpusim_torch.obs.recorder import (
    note_serve,
    note_serve_degraded,
    note_serve_retry,
    span,
)
from tpusim_torch.serve.batcher import Bucket
from tpusim_torch.scan import analytics_in
from tpusim_torch.serve.request import (
    REJECT_INVALID,
    REJECT_UNKNOWN_SNAPSHOT,
    REJECT_UNSUPPORTED,
    ServeRejected,
    WhatIfRequest,
    _budget,
    shape_class_for,
)
from tpusim_torch.sharding import pad_node_axis
from tpusim_torch.whatif import (
    WhatIfResult,
    _policy_prep,
    _stack_host,
    _stage_scenario,
    _unify,
    batch_config,
    build_program,
    compile_count,
    decode_one,
    stage_batch,
)


def _twin_session(twin):
    """The StreamSession behind a twin handle (a session itself, or a
    wrapper holding one as `.session`)."""
    return getattr(twin, "session", twin)


class ServeExecutor:
    def __init__(self, provider: str = "DefaultProvider", device="cuda",
                 max_staged: int = 128, max_device_batches: int = 8,
                 max_retries: int = 2, backoff_base_s: float = 0.05,
                 clock=None):
        if provider not in _KNOWN_PROVIDERS:
            raise KeyError(f"plugin {provider!r} has not been registered")
        self.provider = provider
        self.device = resolve_device(device)
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.clock = clock  # a ChaosClock makes the backoff deterministic
        # the degraded path the LAST dispatch took (None: a clean device
        # answer); the fleet copies it into each response's `degraded`
        self.last_path: Optional[str] = None
        self._snapshots: Dict[str, ClusterSnapshot] = {}
        # id(policy) -> (policy, prep): the policy ref keeps the id stable
        self._policies: Dict[int, Tuple[Any, tuple]] = {}
        self._staged: OrderedDict = OrderedDict()  # (key, sig) -> (staged, sc)
        self._max_staged = max_staged
        self._device_batches: OrderedDict = OrderedDict()
        self._max_device_batches = max_device_batches
        # a program holds a bucket's worth of device buffers, as a device
        # batch does: the same bound
        self._programs: OrderedDict = OrderedDict()
        self._warm: set = set()   # bucket keys dispatched before
        # one dispatch at a time: a program's buffers and graph serve one
        # bucket at a time, and a graph is captured and replayed by the
        # thread that holds this lock
        self._lock = threading.Lock()
        # live twins: snapshot_ref -> StreamSession answering what-if
        # requests as overlays on its resident carry, and the FollowerTwin
        # read replicas answering the same ref from a standby's twin
        self._twins: Dict[str, Any] = {}
        self._replicas: Dict[str, List[Any]] = {}
        self._overlay_shapes: Dict[str, set] = {}
        self.stats = {"dispatches": 0, "warm_hits": 0, "traces": 0,
                      "staged_hits": 0, "device_batch_hits": 0,
                      "overlay_hits": 0, "overlay_fallbacks": 0}
        # device residency, polled at snapshot time only; held weakly
        analytics.register_hbm_source(
            "serve_staged", self,
            lambda ex: (sum(analytics.tree_nbytes(
                (s.statics, s.carry, s.xs))
                for s, _sc in ex._staged.values()), len(ex._staged)))
        analytics.register_hbm_source(
            "serve_device_batches", self,
            lambda ex: (sum(analytics.tree_nbytes(built[1:])
                            for built in ex._device_batches.values()),
                        len(ex._device_batches)))

    # -- snapshot registry (the base clusters requests reference) ---------

    def register_snapshot(self, ref: str, snapshot: ClusterSnapshot) -> str:
        self._snapshots[ref] = snapshot
        return ref

    def snapshot_refs(self) -> List[str]:
        return list(self._snapshots)

    # -- live twins: resident-overlay dispatch -----------------------------

    def attach_twin(self, ref: str, session) -> str:
        """Install a live StreamSession as the resident twin behind `ref`:
        requests naming the ref are answered by an overlay query on the
        session's device-resident carry, falling back to staging the
        session's CURRENT host picture where the overlay refuses. The
        session stays owned by its driver: queries interleave with its
        churn cycles without touching its cycle chain."""
        self._twins[ref] = session
        return ref

    def detach_twin(self, ref: str) -> None:
        self._twins.pop(ref, None)
        self._replicas.pop(ref, None)
        self._overlay_shapes.pop(ref, None)

    def attach_replica(self, ref: str, follower) -> None:
        """Route `ref`'s overlay reads through a FollowerTwin replica
        (stream.replicate): a non-diverged standby's twin answers what-if
        queries first, the leader's twin only when every replica refuses.
        A replica's answer trails the leader by the unacked WAL tail:
        bounded staleness, the read replica's contract."""
        self._replicas.setdefault(ref, []).append(follower)

    def _overlay_plan_ok(self, session, request: WhatIfRequest) -> bool:
        # an overlay answer rides the twin's compiled plan; a request naming
        # another policy (or provider) needs the staged path
        if session.provider != self.provider:
            return False
        if request.policy is None:
            return session.policy is None
        return request.policy is session.policy

    def try_overlay(self, request: WhatIfRequest
                    ) -> Optional[Tuple[WhatIfResult, bool, str]]:
        """Answer a request on the live twin behind its snapshot_ref:
        (result, compile_cache_hit, path) with path "follower" (a replica)
        or "resident", or None when no twin is installed, the request pins
        its own plan, or every overlay refuses: the caller falls back to
        stage()."""
        ref = request.snapshot_ref
        if request.snapshot is not None or ref is None:
            return None
        twin = self._twins.get(ref)
        if twin is None:
            return None
        if not request.pods:
            raise ServeRejected(REJECT_INVALID,
                                "request carries an empty pod list")
        candidates = [(f, "follower") for f in self._replicas.get(ref, ())]
        candidates.append((twin, "resident"))
        with span("serve:overlay") as osp:
            if osp:
                osp.set("ref", ref)
            eligible = False
            for target, path in candidates:
                if not self._overlay_plan_ok(_twin_session(target), request):
                    continue
                eligible = True
                placements = target.overlay_query(request.pods)
                if placements is None:
                    continue
                scheduled = sum(1 for p in placements if p.node_name)
                result = WhatIfResult(
                    placements=placements, scheduled=scheduled,
                    unschedulable=len(placements) - scheduled)
                shapes = self._overlay_shapes.setdefault(ref, set())
                shape = (_budget(len(request.pods)), path)
                warm = shape in shapes
                shapes.add(shape)
                self.stats["overlay_hits"] += 1
                self.last_path = None
                register().serve_dispatch.inc("overlay")
                if osp:
                    osp.set("path", path)
                note_serve("overlay", {"path": path, "ref": ref,
                                       "pods": len(request.pods)})
                return result, warm, path
            if osp:
                osp.set("path", "fallback")
            if not eligible:
                register().overlay_fallback.inc("plan_mismatch")
            self.stats["overlay_fallbacks"] += 1
            return None

    # -- staging -----------------------------------------------------------

    def _policy(self, policy) -> tuple:
        if policy is None:
            return (None, False, False, 10)
        hit = self._policies.get(id(policy))
        if hit is not None and hit[0] is policy:
            return hit[1]
        try:
            prep = _policy_prep(policy, 10)
        except NotImplementedError as exc:
            raise ServeRejected(REJECT_UNSUPPORTED, str(exc)) from None
        except ValueError as exc:
            raise ServeRejected(REJECT_INVALID, str(exc)) from None
        self._policies[id(policy)] = (policy, prep)
        return prep

    def _resolve_snapshot(self, request: WhatIfRequest) -> ClusterSnapshot:
        """The base cluster a request runs against: its inline snapshot, a
        live twin's CURRENT host picture or a registered ref. Raises
        ServeRejected when none resolves."""
        if request.snapshot is not None:
            return request.snapshot
        if request.snapshot_ref is not None:
            twin = self._twins.get(request.snapshot_ref)
            if twin is not None:
                # the staged answer for a twin ref runs on the state the
                # overlay would have used: live, not the twin's seed
                return _twin_session(twin).inc.to_snapshot()
            snapshot = self._snapshots.get(request.snapshot_ref)
            if snapshot is None:
                raise ServeRejected(
                    REJECT_UNKNOWN_SNAPSHOT,
                    f"snapshot ref {request.snapshot_ref!r} is not "
                    f"registered (known: {sorted(self._snapshots)})")
            return snapshot
        raise ServeRejected(REJECT_INVALID,
                            "request needs a snapshot or a snapshot_ref")

    def stage(self, request: WhatIfRequest):
        """Resolve and host-stage one request: (staged, shape_class,
        plan_sig, cp, hard_weight). Raises ServeRejected with its reason."""
        if not request.pods:
            raise ServeRejected(REJECT_INVALID,
                                "request carries an empty pod list")
        snapshot = self._resolve_snapshot(request)
        cp, need_noexec, need_saa, hard_weight = self._policy(request.policy)
        # the part of a program's identity a request chooses
        plan_sig = (self.provider, cp.spec if cp is not None else None)
        # a twin ref resolves to a live picture that changes every cycle:
        # its staged trees are never memoized
        live = (request.snapshot is None
                and request.snapshot_ref in self._twins)
        memo_key = ((request.cache_key, plan_sig)
                    if request.cache_key is not None and not live else None)
        if memo_key is not None and memo_key in self._staged:
            staged, shape_class = self._staged[memo_key]
            self._staged.move_to_end(memo_key)
            self.stats["staged_hits"] += 1
            return staged, shape_class, plan_sig, cp, hard_weight
        try:
            staged = _stage_scenario(snapshot, request.pods, cp,
                                     need_noexec, need_saa)
        except ValueError as exc:
            raise ServeRejected(REJECT_INVALID, str(exc)) from None
        except NotImplementedError as exc:
            raise ServeRejected(REJECT_UNSUPPORTED, str(exc)) from None
        shape_class = shape_class_for(staged)
        if memo_key is not None:
            self._staged[memo_key] = (staged, shape_class)
            while len(self._staged) > self._max_staged:
                self._staged.popitem(last=False)
        return staged, shape_class, plan_sig, cp, hard_weight

    # -- dispatch ----------------------------------------------------------

    def _build_device_batch(self, bucket: Bucket):
        """(config, carries, statics_b, xs_b): the bucket padded to its
        shape class, ghost-filled to its size, stacked and uploaded."""
        shape_class, _ = bucket.key
        targets = shape_class.targets
        entries = bucket.entries
        per_scenario = []
        for e in entries:
            statics, carry, xs = _unify(e.staged.statics, e.staged.carry,
                                        e.staged.xs, targets,
                                        shape_class.n_pods)
            statics, carry, _ = pad_node_axis(statics, carry,
                                              shape_class.n_nodes)
            per_scenario.append((carry, statics, xs))
        # ghost scenarios: replicas of the first real entry, never decoded
        while len(per_scenario) < bucket.size:
            per_scenario.append(per_scenario[0])
        config = batch_config(
            [e.staged.compiled for e in entries], self.provider,
            entries[0].cp, entries[0].hard_weight,
            n_saa_doms=max(e.staged.n_saa_doms for e in entries))
        return (config,) + stage_batch(*_stack_host(per_scenario),
                                       self.device)

    def _device_batch(self, bucket: Bucket):
        """((config, device trees), resident): from the device-batch cache
        (resident True) when the whole bucket is cache-keyed and ran
        before."""
        keys = [e.request.cache_key for e in bucket.entries]
        dkey = None
        if all(k is not None for k in keys):
            dkey = (bucket.key, tuple(keys), bucket.size)
            hit = self._device_batches.get(dkey)
            if hit is not None:
                self._device_batches.move_to_end(dkey)
                self.stats["device_batch_hits"] += 1
                return hit, True
        built = self._build_device_batch(bucket)
        if dkey is not None:
            self._device_batches[dkey] = built
            while len(self._device_batches) > self._max_device_batches:
                self._device_batches.popitem(last=False)
        return built, False

    def _program(self, bucket: Bucket, config, carries, statics_b, xs_b):
        """The built program of the bucket's key, size and config, loaded
        with this batch; built (and counted) when the cache lacks it."""
        pkey = (bucket.key, bucket.size, config)
        program = self._programs.get(pkey)
        if program is not None:
            self._programs.move_to_end(pkey)
            program.load(carries, statics_b, xs_b)
            return program
        program = build_program(config, carries, statics_b, xs_b)
        self._programs[pkey] = program
        while len(self._programs) > self._max_device_batches:
            self._programs.popitem(last=False)
        return program

    def _dispatch_once(self, bucket: Bucket, injector=None
                       ) -> Tuple[List[WhatIfResult], bool]:
        """Run one bucket as one batched program: (results aligned with
        bucket.entries, compile_cache_hit). Ghost scenarios and padded pods
        are dropped here.

        injector: an armed chaos DeviceInjector. A scripted exception raises
        before the program runs; a scripted corruption mangles the host
        copies of the outputs, and the structural checks below (active only
        under an injector) turn the detectable kind into a
        DeviceOutputError the breaker absorbs."""
        program_key = bucket.key
        with self._lock, span("serve:dispatch") as sp:
            if sp:
                sp.set("real", len(bucket.entries))
                sp.set("ghosts", bucket.ghosts)
                sp.set("shape", program_key[0].describe())
            self.stats["dispatches"] += 1
            corrupt_kind = (injector.begin_dispatch()
                            if injector is not None else None)
            (config, carries, statics_b, xs_b), resident = \
                self._device_batch(bucket)
            seen = program_key in self._warm
            before = compile_count()
            program_start = time.perf_counter()
            choices_b, counts_b = self._program(
                bucket, config, carries, statics_b, xs_b).run()
            choices_b = choices_b.cpu().numpy()
            counts_b = counts_b.cpu().numpy()
            if corrupt_kind is not None:
                choices_b, counts_b = injector.corrupt(
                    corrupt_kind, choices_b, counts_b)
            if injector is not None:
                # the padded node axis bounds the valid choices; NaN reason
                # counts are never legitimate
                from tpusim_torch.chaos.engine import DeviceOutputError

                if choices_b.size and int(choices_b.max()) >= \
                        program_key[0].n_nodes:
                    raise DeviceOutputError(
                        f"device returned node choice {int(choices_b.max())}"
                        f" >= padded node count {program_key[0].n_nodes}")
                if counts_b.size and np.isnan(
                        np.asarray(counts_b, dtype=float)).any():
                    raise DeviceOutputError(
                        "device returned NaN unschedulability counts")
            built = compile_count() - before
            if built:
                # a cold dispatch's wall bounds its build's cost from above
                analytics.note_compile(
                    "serve",
                    f"{program_key[0].describe()}/plan={program_key[1]}",
                    (time.perf_counter() - program_start) * 1e6,
                    traces=built)
            warm = seen and built == 0
            self._warm.add(program_key)
            self.stats["traces"] += built
            if warm:
                self.stats["warm_hits"] += 1
            path = ("device_cache" if resident and warm
                    else "warm" if warm else "cold")
            register().serve_dispatch.inc(path)
            note_serve("dispatch", {"path": path,
                                    "real": len(bucket.entries),
                                    "ghosts": bucket.ghosts})
        with span("serve:decode"):
            results = [decode_one(e.request.pods, e.staged.compiled,
                                  choices_b[i], counts_b[i])
                       for i, e in enumerate(bucket.entries)]
        if provenance.get_log() is not None:
            for r in results:
                provenance.capture(r.placements, "serve")
        alog = analytics.get()
        if alog is not None:
            # serve samples are pre-bind: the batched program keeps no
            # scenario's final carry, so each sample reduces the entry's
            # staged base columns of the device batch (a program loads
            # them by copy and leaves them as they are); padded nodes past
            # n_valid are masked in the reduction
            a_in = analytics_in(statics_b, carries)
            for i, e in enumerate(bucket.entries):
                names = e.staged.compiled.statics.names
                alog.capture_device(type(a_in)(*(leaf[i] for leaf in a_in)),
                                    len(names), "serve", names=names)
        return results, warm

    # -- the chaos-hardened dispatch ----------------------------------------

    def _host_results(self, bucket: Bucket) -> List[WhatIfResult]:
        """The host pipeline's answer for every real entry of a bucket: the
        degraded path (an open breaker, exhausted retries) and the
        verification oracle. The same placements as the device program."""
        results = []
        for e in bucket.entries:
            snapshot = self._resolve_snapshot(e.request)
            placements = ReferenceBackend(
                provider=self.provider,
                policy=e.request.policy).schedule(e.request.pods, snapshot)
            scheduled = sum(1 for p in placements if p.node_name)
            results.append(WhatIfResult(
                placements=placements, scheduled=scheduled,
                unschedulable=len(placements) - scheduled))
            provenance.capture(placements, "serve_host")
        return results

    def _degraded(self, bucket: Bucket,
                  path: str) -> Tuple[List[WhatIfResult], bool]:
        self.last_path = path
        note_serve_degraded(path, {"real": len(bucket.entries),
                                   "shape": bucket.key[0].describe()})
        return self._host_results(bucket), False

    def _backoff(self, attempts: int) -> None:
        """Exponential backoff between retries: base * 2^(attempt-1). Under
        an injected clock the delay advances simulated time (deterministic
        tests); a wall clock sleeps, capped so a chaos run stays fast."""
        delay = self.backoff_base_s * (2 ** (attempts - 1))
        if self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(delay)
        else:
            time.sleep(min(delay, 0.2))

    def dispatch(self, bucket: Bucket) -> Tuple[List[WhatIfResult], bool]:
        """_dispatch_once behind the process-wide chaos seam
        (backend.install_chaos; a plain call when unarmed). As
        TorchBackend.schedule: a denied or repeatedly faulted bucket is
        answered by the host pipeline (an answer, never a hang), a half-open
        probe, and every dispatch under verify="all", is checked against the
        host pipeline before its results are emitted, and each retry backs
        off exponentially under the injected clock."""
        self.last_path = None
        injector = _backend._CHAOS["injector"]
        breaker = _backend._CHAOS["breaker"]
        if injector is None and breaker is None:
            return self._dispatch_once(bucket, None)
        from tpusim_torch.chaos.engine import DeviceFault

        attempts = 0
        while True:
            if breaker is not None and not breaker.allow():
                return self._degraded(bucket, "breaker_open")
            probing = breaker.probing if breaker is not None else False
            try:
                results, warm = self._dispatch_once(bucket, injector)
            except DeviceFault as exc:
                if breaker is not None:
                    breaker.record_failure(f"{type(exc).__name__}: {exc}")
                attempts += 1
                if attempts > self.max_retries:
                    return self._degraded(bucket, "retry_exhausted")
                note_serve_retry("device_fault",
                                 {"attempt": attempts,
                                  "real": len(bucket.entries),
                                  "error": str(exc)})
                self._backoff(attempts)
                continue
            if breaker is not None and (
                    probing or _backend._CHAOS["verify"] == "all"):
                expected = self._host_results(bucket)
                got = tuple(placement_hash(r.placements) for r in results)
                want = tuple(placement_hash(r.placements) for r in expected)
                if got != want:
                    # silent corruption: in range but wrong; only the host's
                    # placement hashes catch it
                    breaker.record_failure("device/host what-if divergence")
                    self.last_path = "verify_divergence"
                    note_serve_degraded("verify_divergence",
                                        {"real": len(bucket.entries)})
                    return expected, warm
            if breaker is not None:
                breaker.record_success()
            return results, warm
