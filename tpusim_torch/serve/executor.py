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
bucket's futures with it: there is no host answer.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.backend import _KNOWN_PROVIDERS
from tpusim_torch.device import resolve_device
from tpusim_torch.serve.batcher import Bucket
from tpusim_torch.serve.request import (
    REJECT_INVALID,
    REJECT_UNKNOWN_SNAPSHOT,
    REJECT_UNSUPPORTED,
    ServeRejected,
    WhatIfRequest,
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


class ServeExecutor:
    def __init__(self, provider: str = "DefaultProvider", device="cuda",
                 max_staged: int = 128, max_device_batches: int = 8):
        if provider not in _KNOWN_PROVIDERS:
            raise KeyError(f"plugin {provider!r} has not been registered")
        self.provider = provider
        self.device = resolve_device(device)
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
        self.stats = {"dispatches": 0, "warm_hits": 0, "traces": 0,
                      "staged_hits": 0, "device_batch_hits": 0}

    # -- snapshot registry (the base clusters requests reference) ---------

    def register_snapshot(self, ref: str, snapshot: ClusterSnapshot) -> str:
        self._snapshots[ref] = snapshot
        return ref

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
        """The base cluster a request runs against: its inline snapshot or
        a registered ref. Raises ServeRejected when none resolves."""
        if request.snapshot is not None:
            return request.snapshot
        if request.snapshot_ref is not None:
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
        memo_key = ((request.cache_key, plan_sig)
                    if request.cache_key is not None else None)
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
        """(config, device trees): from the device-batch cache when the
        whole bucket is cache-keyed and ran before."""
        keys = [e.request.cache_key for e in bucket.entries]
        dkey = None
        if all(k is not None for k in keys):
            dkey = (bucket.key, tuple(keys), bucket.size)
            hit = self._device_batches.get(dkey)
            if hit is not None:
                self._device_batches.move_to_end(dkey)
                self.stats["device_batch_hits"] += 1
                return hit
        built = self._build_device_batch(bucket)
        if dkey is not None:
            self._device_batches[dkey] = built
            while len(self._device_batches) > self._max_device_batches:
                self._device_batches.popitem(last=False)
        return built

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

    def dispatch(self, bucket: Bucket) -> Tuple[List[WhatIfResult], bool]:
        """Run one bucket as one batched program: (results aligned with
        bucket.entries, compile_cache_hit). Ghost scenarios and padded pods
        are dropped here."""
        program_key = bucket.key
        with self._lock:
            self.stats["dispatches"] += 1
            config, carries, statics_b, xs_b = self._device_batch(bucket)
            seen = program_key in self._warm
            before = compile_count()
            choices_b, counts_b = self._program(
                bucket, config, carries, statics_b, xs_b).run()
            choices_b = choices_b.cpu().numpy()
            counts_b = counts_b.cpu().numpy()
            built = compile_count() - before
            warm = seen and built == 0
            self._warm.add(program_key)
            self.stats["traces"] += built
            if warm:
                self.stats["warm_hits"] += 1
        results = [decode_one(e.request.pods, e.staged.compiled,
                              choices_b[i], counts_b[i])
                   for i, e in enumerate(bucket.entries)]
        return results, warm
