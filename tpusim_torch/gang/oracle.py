"""The host oracle of the gang packing solve: the plain numpy version of
scan.gang_select. The same member loop, the same int64 rank key
(packing.encode_gang_rank), the same capacity re-check as members stack onto
a node, over the same domain-id arrays (packing_domains), so the two are
bit-equal by construction and tests compare choices exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from tpusim_torch.api.types import Node
from tpusim_torch.engine.priorities import get_zone_key
from tpusim_torch.packing import encode_gang_rank

# Rack topology labels, checked in order. The upstream scheduler has no
# canonical rack label; the common community spelling comes first, then a
# tpusim-local one.
RACK_LABELS = ("topology.kubernetes.io/rack", "tpusim.io/rack")


def _rack_key(node: Node) -> str:
    labels = node.metadata.labels
    for label in RACK_LABELS:
        value = labels.get(label, "")
        if value:
            return value
    return ""


def packing_domains(nodes: Sequence[Node]) -> Tuple[np.ndarray, np.ndarray,
                                                    int, int]:
    """(zone_dom[N], rack_dom[N], n_zone, n_rack): 1-based interned domain
    ids per node, 0 = no domain, from the node labels. The oracle and the
    device solve receive these exact arrays."""
    zone_ids: dict = {}
    rack_ids: dict = {}
    zone_dom = np.zeros(len(nodes), dtype=np.int32)
    rack_dom = np.zeros(len(nodes), dtype=np.int32)
    for i, node in enumerate(nodes):
        zone = get_zone_key(node)
        if zone:
            zone_dom[i] = zone_ids.setdefault(zone, len(zone_ids) + 1)
        rack = _rack_key(node)
        if rack:
            rack_dom[i] = rack_ids.setdefault(rack, len(rack_ids) + 1)
    return zone_dom, rack_dom, len(zone_ids) + 1, len(rack_ids) + 1


def select_oracle(feasible: np.ndarray, score: np.ndarray,
                  req_cpu: np.ndarray, req_mem: np.ndarray,
                  req_gpu: np.ndarray, req_eph: np.ndarray,
                  zero_request: np.ndarray,
                  alloc_cpu: np.ndarray, alloc_mem: np.ndarray,
                  alloc_gpu: np.ndarray, alloc_eph: np.ndarray,
                  allowed_pods: np.ndarray,
                  used_cpu: np.ndarray, used_mem: np.ndarray,
                  used_gpu: np.ndarray, used_eph: np.ndarray,
                  pod_count: np.ndarray,
                  zone_dom: np.ndarray, rack_dom: np.ndarray,
                  n_zone: int, n_rack: int) -> List[int]:
    """The packing loop in numpy: each member's node index, or -1."""
    m, n = feasible.shape
    gang_cpu = np.zeros(n, dtype=np.int64)
    gang_mem = np.zeros(n, dtype=np.int64)
    gang_gpu = np.zeros(n, dtype=np.int64)
    gang_eph = np.zeros(n, dtype=np.int64)
    gang_pods = np.zeros(n, dtype=np.int64)
    zone_cnt = np.zeros(n_zone, dtype=np.int64)
    rack_cnt = np.zeros(n_rack, dtype=np.int64)
    choices: List[int] = []
    for i in range(m):
        fits = (pod_count + gang_pods + 1) <= allowed_pods
        if not zero_request[i]:
            fits &= alloc_cpu >= used_cpu + gang_cpu + int(req_cpu[i])
            fits &= alloc_mem >= used_mem + gang_mem + int(req_mem[i])
            fits &= alloc_gpu >= used_gpu + gang_gpu + int(req_gpu[i])
            fits &= alloc_eph >= used_eph + gang_eph + int(req_eph[i])
        ok = feasible[i] & fits
        zone_bonus = np.where(zone_dom > 0, zone_cnt[zone_dom], 0)
        rack_bonus = np.where(rack_dom > 0, rack_cnt[rack_dom], 0)
        rank = encode_gang_rank(zone_bonus, rack_bonus,
                                score[i].astype(np.int64), ok)
        choice = int(np.argmax(rank))
        if rank[choice] < 0:
            choices.append(-1)
            continue
        gang_cpu[choice] += int(req_cpu[i])
        gang_mem[choice] += int(req_mem[i])
        gang_gpu[choice] += int(req_gpu[i])
        gang_eph[choice] += int(req_eph[i])
        gang_pods[choice] += 1
        zone_cnt[zone_dom[choice]] += 1
        rack_cnt[rack_dom[choice]] += 1
        choices.append(choice)
    return choices
