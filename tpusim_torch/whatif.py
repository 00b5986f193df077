"""Multi-snapshot what-if: independent cluster scenarios in one call.

BASELINE.json config 5 (50 snapshots x 20k pods). The reference has no
analog: each run is one process over one snapshot. Here every scenario is
compiled on the host, and then one of two device routes runs:

  * the fast loop: where plan_fast accepts every scenario's plan, one
    fastscan.fast_scan a scenario on the hand-written CUDA kernel (its plain
    version on the CPU);
  * the batched scan: the scenarios unified to one array shape, stacked on
    a leading scenario axis and scheduled in lockstep by
    scan.schedule_scan_batched, every step one set of launches for all S.

Shape unification (host numpy, before the one upload):
  * node axis: padded to the largest scenario's with nodes that are never
    feasible (sharding.pad_node_axis);
  * signature tables, groups, scalar resources: padded on every other named
    axis to the widest scenario's (scan.STATICS_AXES and friends); a
    scenario's reason strings stay its own (the extra bits never fire);
  * pod axis: padded with ghost pods (scan.GHOST_CPU) that fit no node, after
    every real pod, dropped on decode.

route="auto" takes the fast loop when every scenario is eligible and the
batched scan otherwise, "kernel" raises NotImplementedError where any
scenario's plan is refused, "scan" always takes the batched scan. Neither
route falls back to the other: a kernel error raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Pod
from tpusim_torch.backend import (
    _KNOWN_PROVIDERS,
    _MOST_REQUESTED_PROVIDERS,
    ROUTES,
    Placement,
    decode_placements,
    note_fast_fallback,
)
from tpusim_torch.config import config_for
from tpusim_torch.device import resolve_device
from tpusim_torch.fastplan import plan_fast
from tpusim_torch.fastscan import fast_scan
from tpusim_torch.scan import (
    CARRY_AXES,
    GHOST_CPU,
    GRAPH_STEPS,
    PODX_AXES,
    STATICS_AXES,
    BatchedScan,
    Carry,
    PodX,
    Statics,
    carry_init_host,
    pod_columns_to_host,
    statics_to_host,
    tree_to,
)
from tpusim_torch.sharding import pad_node_axis
from tpusim_torch.state import compile_cluster, reason_strings

log = logging.getLogger(__name__)

# batched programs built in this process (BatchedScan: buffers, the step
# and, on a CUDA device, its captured graph); the serve executor's warm
# cache and each response's compile_cache_hit read deltas of it
_COMPILE_COUNTS = {"batched": 0}


def compile_count() -> int:
    """Batched programs built this process (see _COMPILE_COUNTS)."""
    return sum(_COMPILE_COUNTS.values())


def build_program(config, carries: Carry, statics_b: Statics, xs_b: PodX
                  ) -> BatchedScan:
    """A batched program over a stacked device batch, counted."""
    _COMPILE_COUNTS["batched"] += 1
    return BatchedScan(config, carries, statics_b, xs_b,
                       graph_steps=GRAPH_STEPS)


@dataclass
class WhatIfResult:
    """Per-scenario outcome."""

    placements: List[Placement]
    scheduled: int
    unschedulable: int

    @property
    def total(self) -> int:
        return self.scheduled + self.unschedulable


def _pad_axis(a: np.ndarray, axis: int, target: int, fill=0) -> np.ndarray:
    pad = target - a.shape[axis]
    if pad <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def _axis_targets(host_trees) -> dict:
    """Largest size of every named non-node axis across the scenarios'
    (statics, carry, xs) host trees, from the axis registries."""
    targets: dict = {}
    for statics, carry, xs in host_trees:
        trees = [(statics, STATICS_AXES, 0), (carry, CARRY_AXES, 0),
                 (xs, PODX_AXES, 1)]
        for tree, axes_map, offset in trees:
            for name, arr in tree._asdict().items():
                for i, axis in enumerate(axes_map[name]):
                    if axis == "node":
                        continue
                    size = np.asarray(arr).shape[i + offset]
                    targets[axis] = max(targets.get(axis, 0), size)
    return targets


def _unify_tree(tree, axes_map, targets: dict, axis_offset: int = 0) -> dict:
    fields = {}
    for name, arr in tree._asdict().items():
        arr = np.asarray(arr)
        for i, axis in enumerate(axes_map[name]):
            if axis == "node":
                continue
            arr = _pad_axis(arr, i + axis_offset, targets[axis])
        fields[name] = arr
    return fields


def _unify(statics: Statics, carry: Carry, xs: PodX, targets: dict,
           p_max: int) -> Tuple[Statics, Carry, PodX]:
    """Pad the signature, scalar and pod axes of one scenario's host trees
    to the common shape."""
    st_fields = _unify_tree(statics, STATICS_AXES, targets)
    ca_fields = _unify_tree(carry, CARRY_AXES, targets)
    p = np.asarray(xs.req_cpu).shape[0]
    fields = _unify_tree(xs, PODX_AXES, targets, axis_offset=1)
    fields = {k: _pad_axis(v, 0, p_max) for k, v in fields.items()}
    if p_max > p:
        # ghost pods: infeasible everywhere, never advance rr or bind
        fields["req_cpu"] = fields["req_cpu"].copy()
        fields["req_cpu"][p:] = GHOST_CPU
        fields["zero_request"] = fields["zero_request"].copy()
        fields["zero_request"][p:] = False
    return Statics(**st_fields), Carry(**ca_fields), PodX(**fields)


def _policy_prep(policy, hard_pod_affinity_symmetric_weight: int):
    """Compile the batch-wide policy once: (cp, need_noexec, need_saa,
    hard_weight). Shared by run_what_if and the serve executor, which keys
    its programs on cp.spec."""
    cp = None
    if policy is not None:
        from tpusim_torch.policyc import compile_policy

        cp = compile_policy(policy)
        if cp.unsupported:
            detail = "; ".join(sorted(set(cp.unsupported))[:5])
            raise NotImplementedError(
                "what-if batching requires a device-compilable policy; "
                f"host-bound: {detail}")
        if cp.hard_weight is not None:
            hard_pod_affinity_symmetric_weight = cp.hard_weight
    need_noexec = cp is not None and cp.spec.has_noexec
    need_saa = cp is not None and cp.spec.has_services
    return cp, need_noexec, need_saa, hard_pod_affinity_symmetric_weight


@dataclass
class StagedScenario:
    """One scenario compiled to host trees, ready to batch (run_what_if) or
    bucket (tpusim_torch.serve): the unit the serve staging cache holds."""

    compiled: object
    cols: object
    statics: Statics
    carry: Carry
    xs: PodX
    ptabs: object
    n_saa_doms: int


def _stage_scenario(snapshot: ClusterSnapshot, pods: List[Pod], cp,
                    need_noexec: bool, need_saa: bool) -> StagedScenario:
    """Host-stage one (snapshot, pods) scenario: compile_cluster, the
    policy's tables and the host trees. Raises ValueError for a zero-node
    snapshot (there is no node axis to pad onto) and NotImplementedError
    for a scenario the device routes cannot express."""
    if not snapshot.nodes:
        raise ValueError(
            "what-if scenario has a zero-node snapshot: nothing can "
            "schedule; run scenarios against at least one node")
    compiled, cols = compile_cluster(snapshot, pods, need_noexec=need_noexec,
                                     need_saa=need_saa)
    if compiled.unsupported:
        detail = "; ".join(sorted(set(compiled.unsupported))[:5])
        raise NotImplementedError(
            "what-if batching requires device-compilable scenarios; "
            f"unsupported: {detail} (run this scenario on the reference "
            "backend instead)")
    ptabs = None
    n_saa_doms = 1
    sa_lock_init = None
    if cp is not None:
        # one build a scenario feeds the batched statics and the fast
        # loop's plan; it fills cols.img_id and cols.sa_self_id in place
        from tpusim_torch.policyc import build_policy_tables

        ptabs = build_policy_tables(cp, snapshot, pods, compiled, cols)
        sa_lock_init = ptabs.sa_lock_init
        n_saa_doms = ptabs.n_saa_doms
    return StagedScenario(
        compiled=compiled, cols=cols,
        statics=statics_to_host(compiled, ptabs),
        carry=carry_init_host(compiled, sa_lock_init),
        xs=pod_columns_to_host(cols), ptabs=ptabs, n_saa_doms=n_saa_doms)


def batch_config(compiled_list, provider: str, cp, hard_weight: int,
                 n_saa_doms: int):
    """EngineConfig for a batch of compiled scenarios. The reason width
    follows the scalar axis of the unified trees: the widest scenario's in
    run_what_if, the shape class's budget in serve (the extra bits never
    fire)."""
    config = config_for(list(compiled_list),
                        most_requested=provider in _MOST_REQUESTED_PROVIDERS,
                        hard_weight=hard_weight)
    if cp is not None:
        config = replace(config, policy=cp.spec, n_saa_doms=n_saa_doms)
    return config


def _prepare_host_batch(scenarios, provider: str,
                        hard_pod_affinity_symmetric_weight: int, policy):
    """Compile the batch on host numpy: (config, staged scenarios). The
    fast loop reads each scenario's compile directly; only the batched scan
    pays for unifying the trees (_unify_batch). Raises ValueError for input
    that cannot batch (an empty scenario list, a zero-node snapshot, with
    the scenario's index)."""
    if provider not in _KNOWN_PROVIDERS:
        raise KeyError(f"plugin {provider!r} has not been registered")
    if not scenarios:
        raise ValueError(
            "run_what_if needs at least one (snapshot, pods) scenario")
    cp, need_noexec, need_saa, hard_weight = _policy_prep(
        policy, hard_pod_affinity_symmetric_weight)
    staged: List[StagedScenario] = []
    for i, (snapshot, pods) in enumerate(scenarios):
        try:
            staged.append(_stage_scenario(snapshot, pods, cp, need_noexec,
                                          need_saa))
        except ValueError as exc:
            raise ValueError(f"scenario {i}: {exc}") from None
    config = batch_config([s.compiled for s in staged], provider, cp,
                          hard_weight,
                          n_saa_doms=max(s.n_saa_doms for s in staged))
    return config, staged


def _unify_batch(host_trees):
    """Unify and node-pad the scenarios' host trees: one (carry, statics,
    xs) a scenario, all of one shape."""
    targets = _axis_targets(host_trees)
    p_max = max(np.asarray(xs.req_cpu).shape[0] for _, _, xs in host_trees)
    n_max = max(np.asarray(s.alloc_cpu).shape[0] for s, _, _ in host_trees)
    per_scenario = []
    for statics, carry, xs in host_trees:
        statics, carry, xs = _unify(statics, carry, xs, targets, p_max)
        statics, carry, _ = pad_node_axis(statics, carry, n_max)
        per_scenario.append((carry, statics, xs))
    return per_scenario


def _stack_host(per_scenario):
    """Stacked host trees (carries, statics_b, xs_b)."""
    def stack(trees):
        return type(trees[0])(*(np.stack([np.asarray(a) for a in leaves])
                                for leaves in zip(*trees)))

    return (stack([t[0] for t in per_scenario]),
            stack([t[1] for t in per_scenario]),
            stack([t[2] for t in per_scenario]))


def stage_batch(host_carries: Carry, host_statics: Statics, host_xs: PodX,
                device):
    """The stacked host trees on `device` (ids widened to int64, as
    scan.scan_inputs uploads them)."""
    return (tree_to(host_carries, device),
            tree_to(host_statics, device, index=True),
            tree_to(host_xs, device, index=True))


def decode_one(pods: List[Pod], compiled, choices, counts) -> WhatIfResult:
    """Decode one scenario's outputs back to placements, in pod order,
    dropping pod-axis padding."""
    placements = decode_placements(
        pods, choices, counts, compiled.statics.names,
        reason_strings(compiled.scalar_names))
    scheduled = sum(1 for p in placements if p.scheduled)
    return WhatIfResult(placements=placements, scheduled=scheduled,
                        unschedulable=len(pods) - scheduled)


def _decode_batch(scenarios, staged, choices_b, counts_b) -> List[WhatIfResult]:
    return [decode_one(scenarios[b][1], staged[b].compiled, choices_b[b],
                       counts_b[b])
            for b in range(len(scenarios))]


def _fast_plans(config, staged):
    """Every scenario's fast-scan plan, or (None, reason) at the first one
    plan_fast refuses."""
    plans = []
    for b, s in enumerate(staged):
        plan, why = plan_fast(config, s.compiled, s.cols, s.ptabs)
        if plan is None:
            return None, f"scenario {b}: {why}"
        plans.append(plan)
    return plans, ""


def _run_batched(config, staged, device):
    """The batched scan over every staged scenario: (choices [S, P],
    counts [S, P, bits]) as numpy arrays."""
    per_scenario = _unify_batch([(s.statics, s.carry, s.xs) for s in staged])
    carries, statics_b, xs_b = stage_batch(*_stack_host(per_scenario), device)
    choices, counts = build_program(config, carries, statics_b, xs_b).run()
    return choices.cpu().numpy(), counts.cpu().numpy()


def run_what_if(scenarios: Sequence[Tuple[ClusterSnapshot, List[Pod]]],
                provider: str = "DefaultProvider",
                hard_pod_affinity_symmetric_weight: int = 10,
                policy=None, device="cuda",
                route: str = "auto") -> List[WhatIfResult]:
    """Run independent (snapshot, pods) scenarios; one WhatIfResult a
    scenario. Pods are fed in podspec order (callers wanting the reference's
    LIFO order pass the reversed list, as run_simulation does).

    policy: an engine.policy.Policy applied to every scenario; a host-bound
    policy raises NotImplementedError, as there is no per-scenario host
    route. device: "cuda" (the default: the CUDA kernel and the batched scan
    on the card) or "cpu" (their plain versions). route: "auto", "kernel"
    or "scan" (module docstring).

    Raises ValueError for input that cannot batch (an empty scenario list,
    a zero-node snapshot) before any device work."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r} (expected one of "
                         f"{', '.join(ROUTES)})")
    device = resolve_device(device)
    config, staged = _prepare_host_batch(
        scenarios, provider, hard_pod_affinity_symmetric_weight, policy)
    if route != "scan":
        plans, why = _fast_plans(config, staged)
        if plans is not None:
            outs = [fast_scan(plan, device=device) for plan in plans]
            return _decode_batch(scenarios, staged, [o[0] for o in outs],
                                 [o[1] for o in outs])
        if route == "kernel":
            raise NotImplementedError(f"what-if fast loop: {why}")
        note_fast_fallback(why)
        log.info("what-if fast loop ineligible (%s); using the batched scan",
                 why)
    choices_b, counts_b = _run_batched(config, staged, device)
    return _decode_batch(scenarios, staged, choices_b, counts_b)
