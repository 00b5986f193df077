"""The gang driver: all-or-nothing group admission over the scan's lanes.

`schedule_with_gangs` is the one entry point every route calls when a feed
carries gang annotations (run_simulation on backend "torch", the streaming
twin's gang cycle, its verify arm). It splits the feed into ungrouped runs,
scheduled through the backend's unchanged per-pod path, and complete gangs,
each admitted all or nothing by `admit_gang`:

  1. compile the member batch against the live IncrementalCluster and
     evaluate every member's feasibility and score lanes against the SAME
     picture (scan.gang_lanes: the scan's evaluate mapped over the members);
  2. solve the joint placement (gang.kernel.gang_choices: rank-aware greedy
     packing toward the zone and rack domains already holding mates, with a
     capacity re-check as members stack);
  3. if at least `min-available` members placed, apply every bind to the
     cluster inside a journal mark (a failure mid-commit rolls the journal
     back); otherwise reject the WHOLE gang with one shared FitError and no
     bind.

A gang whose members use a feature the compile classifies unsupported takes
a sequential trial through the backend (its host route) instead of step 1-2,
then the same all-or-nothing gate.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Dict, List, Tuple

from tpusim_torch.api.types import Pod
from tpusim_torch.backends import Placement, bind_pod, mark_unschedulable
from tpusim_torch.framework import metrics as _metrics
from tpusim_torch.framework.store import MODIFIED
from tpusim_torch.gang.group import PodGroup, gang_fit_message, split_feed
from tpusim_torch.gang.kernel import gang_choices
from tpusim_torch.gang.oracle import packing_domains
from tpusim_torch.obs import provenance
from tpusim_torch.obs import recorder as flight

log = logging.getLogger(__name__)


def _reject(group: PodGroup, num_nodes: int, placed: int,
            reason: str) -> List[Placement]:
    msg = gang_fit_message(group, num_nodes, placed)
    _metrics.register().gang_rejected.inc(reason)
    flight.note_gang("reject", {"group": group.name, "reason": reason,
                                "placed": placed})
    return [Placement(pod=mark_unschedulable(p, msg),
                      reason="Unschedulable", message=msg)
            for p in group.pods]


def admit_gang(backend, inc, group: PodGroup) -> List[Placement]:
    """All-or-nothing admission of one gang against the live incremental
    cluster. On admission the binds are applied to `inc` inside a journal
    mark; on rejection nothing is applied."""
    m = _metrics.register()
    m.gang_size.observe(len(group.pods))
    members = group.pods
    num_nodes = len(inc.nodes)
    if num_nodes == 0:
        return _reject(group, 0, 0, "no_nodes")
    with flight.span("gang:admit") as sp:
        if sp:
            sp.set("group", group.name)
            sp.set("members", len(members))
        compiled, cols = inc.compile(members)
        if compiled.unsupported:
            choices, node_names = _sequential_trial(backend, inc, members,
                                                    compiled, cols)
        else:
            choices, node_names = _joint_solve(backend, inc, compiled, cols)

    placed = sum(1 for c in choices if c >= 0)
    if placed < group.min_available:
        return _reject(group, num_nodes, placed, "min_available")

    # every placed member binds; a failure mid-loop rolls the journal back,
    # so no partial gang survives in the delta stream
    mark = inc.journal_mark()
    placements: List[Placement] = []
    try:
        for pod, c in zip(members, choices):
            if c >= 0:
                bound = bind_pod(pod, node_names[c])
                inc.apply(MODIFIED, bound)
                placements.append(Placement(pod=bound,
                                            node_name=node_names[c]))
            else:
                # admitted at min-available: the overflow members failed
                # individually, not the gang
                msg = (f"pod group \"{group.name}\" admitted at "
                       f"{placed}/{len(members)}; this member did not fit.")
                placements.append(Placement(
                    pod=mark_unschedulable(pod, msg),
                    reason="Unschedulable", message=msg))
    except Exception:
        inc.journal_rollback(mark)
        m.gang_partial_rollback.inc()
        flight.note_gang("rollback", {"group": group.name})
        raise
    inc.journal_release()
    m.gang_admitted.inc()
    flight.note_gang("admit", {"group": group.name, "placed": placed,
                               "members": len(members)})
    return placements


def _joint_solve(backend, inc, compiled, cols) -> Tuple[List[int], List[str]]:
    """The member lanes and the joint packing on the backend's device.
    Returns (choices, node names in compiled order). The lanes run under the
    provider's predicates and priorities, as the JAX package's driver runs
    them (a backend's policy is not applied to the member lanes)."""
    import torch

    from tpusim_torch.backend import (
        _MOST_REQUESTED_PROVIDERS,
        _shard_count,
        shard_mesh_for,
    )
    from tpusim_torch.config import config_for
    from tpusim_torch.scan import (
        carry_init,
        gang_columns,
        gang_lanes,
        pod_columns_to,
        statics_to,
    )

    device = backend.device
    config = config_for(
        compiled,
        most_requested=backend.provider in _MOST_REQUESTED_PROVIDERS,
        hard_weight=backend.hard_pod_affinity_symmetric_weight)
    statics = statics_to(compiled, device)
    carry = carry_init(compiled, device)
    xs = pod_columns_to(cols, device)
    n_shards = _shard_count()
    mesh = (shard_mesh_for(config, n_shards, device) if n_shards > 1
            else None)
    if mesh is None:
        feasible, score = gang_lanes(config, carry, statics, xs)
    else:
        # the member lanes over the node-sharded columns: each rank's block
        # with the step's collectives, the (member, node) matrix put back
        # together on every rank; padded columns are never feasible, so the
        # real node columns feed the joint solve as the single-device
        # lanes do
        from tpusim_torch.scan import (
            carry_init_host,
            gang_lanes_sharded,
            pod_columns_to_host,
            statics_to_host,
        )
        from tpusim_torch.sharding import shard_for_mesh

        st, ca, xs_r = shard_for_mesh(
            mesh, statics_to_host(compiled), carry_init_host(compiled),
            pod_columns_to_host(cols), device)
        with flight.span("shard:gang_lanes", "device", device) as sp:
            feasible, score = gang_lanes_sharded(
                replace(config, shard_axis="node"), mesh, ca, st, xs_r)
            if sp:
                sp.set("shards", n_shards)
                sp.set("members", int(xs.req_cpu.shape[0]))
        n_nodes = len(compiled.statics.names)
        feasible = feasible[:, :n_nodes].to(device)
        score = score[:, :n_nodes].to(device)

    names = list(compiled.statics.names)
    by_name = {n.metadata.name: n for n in inc.nodes}
    zone_dom, rack_dom, n_zone, n_rack = packing_domains(
        [by_name[name] for name in names])
    gi = gang_columns(statics, carry,
                      torch.as_tensor(zone_dom, device=device),
                      torch.as_tensor(rack_dom, device=device))
    return gang_choices(feasible, score, xs, gi, n_zone, n_rack), names


def _sequential_trial(backend, inc, members: List[Pod], compiled, cols
                      ) -> Tuple[List[int], List[str]]:
    """A gang carrying a feature the compile classifies unsupported: a
    sequential trial through the backend (whose host route resolves it; a
    backend built with fallback="error" raises). Nothing is committed here:
    the caller applies the all-or-nothing gate to the choices."""
    log.warning("gang trial via the sequential path for: %s",
                "; ".join(sorted(set(compiled.unsupported))[:5]))
    names = list(compiled.statics.names)
    index = {name: i for i, name in enumerate(names)}
    trial = backend.schedule(members, inc.to_snapshot(),
                             precompiled=(compiled, cols))
    return [index.get(pl.node_name, -1) if pl.scheduled else -1
            for pl in trial], names


def schedule_with_gangs(backend, inc, pods: List[Pod],
                        source: str = "gang") -> List[Placement]:
    """Schedule a feed that may carry gang annotations: ungrouped runs
    through the backend's per-pod path (backend.schedule with the cluster's
    own compile), each gang by `admit_gang`. Binds are applied to `inc` as
    decisions land, so later segments see earlier placements. Placements
    come back in feed order; the gangs' members go to the provenance log
    under `source` (the ungrouped runs' under the backend's own)."""
    by_key: Dict[Tuple[str, str], Placement] = {}
    gang_placements: List[Placement] = []
    for seg in split_feed(pods):
        if seg.pods is not None:
            snapshot = inc.to_snapshot()
            precompiled = inc.compile(seg.pods) if inc.nodes else None
            pls = backend.schedule(seg.pods, snapshot,
                                   precompiled=precompiled)
            for pl in pls:
                if pl.scheduled:
                    inc.apply(MODIFIED, pl.pod)
        else:
            pls = admit_gang(backend, inc, seg.group)
            gang_placements.extend(pls)
        for pl in pls:
            by_key[(pl.pod.metadata.namespace, pl.pod.metadata.name)] = pl
    if gang_placements:
        provenance.capture(gang_placements, source)
    return [by_key[(p.metadata.namespace, p.metadata.name)] for p in pods]
