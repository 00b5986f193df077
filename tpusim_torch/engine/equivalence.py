"""Equivalence cache: memoized predicate results per equivalence class.

Reference: core/equivalence_cache.go — per-node LRU (100 entries) of
predicate-name -> {equivalence hash -> (fit, reasons)}, where the equivalence
class of a pod is derived from its controller OwnerReferences (pods stamped
from the same template are interchangeable for predicate evaluation), with
invalidation hooks driven by cluster events (factory.go event handlers).

The device routes do not use it: their compile step materializes every
signature×node result up front (state.compile_cluster), which subsumes the
cache. It serves the host route.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from tpusim_torch.api.types import Pod

ALGORITHM_CACHE_SIZE = 100  # equivalence_cache.go: maxCacheEntries


def get_equivalence_hash(pod: Pod, pvc_getter: Callable = None) -> Optional[int]:
    """predicates.EquivalencePodGenerator.getEquivalencePod (utils.go:87-124)
    hashed like getHashEquivalencePod: the equivalence class is the pod's
    CONTROLLER owner reference plus its (unordered) set of resolved PVC UIDs
    — pods stamped from the same template claiming the same PVCs are
    interchangeable for predicate evaluation. No controller reference, or a
    PVC that does not resolve, means no valid class (not cacheable)."""
    for ref in pod.metadata.owner_references:
        if not ref.controller:
            continue
        pvc_set = set()
        for volume in pod.spec.volumes:
            claim = volume.pvc_name
            if claim is None:
                continue
            pvc = pvc_getter(pod.namespace, claim) if pvc_getter else None
            if pvc is None:
                return None  # unresolvable claim: no equivalence class
            pvc_set.add(pvc.metadata.uid or pvc.key())
        # a pod can only belong to one controller
        return hash((ref.api_version, ref.kind, ref.name, ref.uid,
                     frozenset(pvc_set)))
    return None


class _LRU(OrderedDict):
    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def get_entry(self, key):
        if key in self:
            self.move_to_end(key)
            return self[key]
        return None

    def put(self, key, value):
        if key in self:
            self.move_to_end(key)
        self[key] = value
        if len(self) > self.maxsize:
            self.popitem(last=False)


class EquivalenceCache:
    def __init__(self, pvc_getter: Callable = None):
        """pvc_getter: the PVC lister handed to the equivalence-class
        generator (factory.go passes the PVC informer into
        NewEquivalencePodGenerator)."""
        # node name -> LRU(predicate key -> {equiv hash -> (fit, reasons)})
        self._by_node: Dict[str, _LRU] = {}
        self._pvc_getter = pvc_getter
        self.hits = 0
        self.misses = 0

    def get_equivalence_class_hash(self, pod: Pod) -> Optional[int]:
        """getEquivalenceClassInfo via the configured generator."""
        return get_equivalence_hash(pod, self._pvc_getter)

    def lookup(self, node_name: str, predicate_key: str,
               equiv_hash: int) -> Optional[Tuple[bool, list]]:
        node_cache = self._by_node.get(node_name)
        if node_cache is None:
            self.misses += 1
            return None
        pred_map = node_cache.get_entry(predicate_key)
        if pred_map is None or equiv_hash not in pred_map:
            self.misses += 1
            return None
        self.hits += 1
        return pred_map[equiv_hash]

    def update(self, node_name: str, predicate_key: str, equiv_hash: int,
               fit: bool, reasons: list) -> None:
        node_cache = self._by_node.setdefault(node_name, _LRU(ALGORITHM_CACHE_SIZE))
        pred_map = node_cache.get_entry(predicate_key)
        if pred_map is None:
            pred_map = {}
            node_cache.put(predicate_key, pred_map)
        pred_map[equiv_hash] = (fit, list(reasons))

    def run_predicate(self, predicate, predicate_key: str, pod: Pod, meta,
                      node_info, equiv_hash: Optional[int]):
        """RunPredicate: consult the cache, else evaluate and fill."""
        node_name = node_info.node.name if node_info.node is not None else ""
        if equiv_hash is not None and node_name:
            cached = self.lookup(node_name, predicate_key, equiv_hash)
            if cached is not None:
                return cached[0], list(cached[1])
        fit, reasons = predicate(pod, meta, node_info)
        if equiv_hash is not None and node_name:
            self.update(node_name, predicate_key, equiv_hash, fit, reasons)
        return fit, reasons

    # --- invalidation hooks (equivalence_cache.go:126-233) ---

    def invalidate_predicates(self, predicate_keys: List[str]) -> None:
        for node_cache in self._by_node.values():
            for key in predicate_keys:
                node_cache.pop(key, None)

    def invalidate_predicates_on_node(self, node_name: str,
                                      predicate_keys: List[str]) -> None:
        node_cache = self._by_node.get(node_name)
        if node_cache is not None:
            for key in predicate_keys:
                node_cache.pop(key, None)

    def invalidate_all_on_node(self, node_name: str) -> None:
        self._by_node.pop(node_name, None)

    def invalidate_cached_predicate_item_of_all_nodes(
            self, predicate_keys: List[str]) -> None:
        self.invalidate_predicates(predicate_keys)
