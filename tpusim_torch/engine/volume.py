"""Volume model: PV node-affinity checks, PV↔PVC matching, and the
scheduler-side volume binder.

Reference mapping:
  volumeutil.CheckNodeAffinity        (pkg/volume/util/util.go:269-310)
  findMatchingVolume                  (pkg/controller/volume/persistentvolume/index.go:125-255)
  volumeBinder.FindPodVolumes         (pkg/controller/volume/persistentvolume/scheduler_binder.go:126-166)
  volumeBinder.AssumePodVolumes       (scheduler_binder.go:169-218)
  shouldDelayBinding                  (pkg/controller/volume/persistentvolume/pv_controller.go:275-296)

The binder is constructed per simulation run over the snapshot's PV/PVC/
StorageClass lists; Assume mutates the in-memory PV copies (claimRef) so later
pods in the same run see earlier pods' volume consumption — the offline analog
of the pvCache.Assume overlay.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from tpusim_torch.api.types import (
    VOLUME_BINDING_WAIT,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)


class VolumeBinderError(Exception):
    """A hard error from volume processing (Go's non-nil err return): aborts
    scheduling of the pod with the message, it is not a predicate failure."""


def check_node_affinity(pv: PersistentVolume, node_labels: dict) -> bool:
    """volumeutil.CheckNodeAffinity (volume/util/util.go:269-294): the PV's
    required node-affinity terms are ORed; no affinity = unconstrained. A
    term whose selector fails validation returns an ERROR upstream
    ("Failed to parse MatchExpressions") — raised here as VolumeBinderError,
    aborting the pod's scheduling rather than counting as a non-match."""
    terms = pv.node_affinity_terms()
    if terms is None:
        return True
    for term in terms:
        r = term.match_result(node_labels)
        if r is None:
            raise VolumeBinderError(
                "Failed to parse MatchExpressions on PersistentVolume "
                f"{pv.metadata.name}")
        if r:
            return True
    return False


def is_volume_bound_to_claim(pv: PersistentVolume,
                             claim: PersistentVolumeClaim) -> bool:
    """pv_controller.go isVolumeBoundToClaim: claimRef name/namespace match,
    and UID match when the claimRef carries one."""
    ref = pv.claim_ref
    if ref is None:
        return False
    if claim.name != (ref.get("name") or ""):
        return False
    if claim.namespace != (ref.get("namespace") or ""):
        return False
    if ref.get("uid") and claim.metadata.uid and ref["uid"] != claim.metadata.uid:
        return False
    return True


def _check_access_modes(claim: PersistentVolumeClaim,
                        pv: PersistentVolume) -> bool:
    """index.go checkAccessModes: every requested mode must be in the PV's."""
    pv_modes = set(pv.access_modes)
    return all(m in pv_modes for m in claim.access_modes)


def find_matching_volume(claim: PersistentVolumeClaim,
                         volumes: List[PersistentVolume],
                         node, excluded: Dict[str, PersistentVolume],
                         delay_binding: bool) -> Optional[PersistentVolume]:
    """index.go findMatchingVolume:125-255 — prefer a pre-bound PV; otherwise
    the smallest available PV that satisfies size/class/selector/access-modes
    and (scheduler path) the node's labels."""
    smallest: Optional[PersistentVolume] = None
    requested = claim.request_storage
    requested_class = claim.storage_class_name
    selector = claim.selector()

    smallest_capacity = 0
    for pv in volumes:
        if pv.name in excluded:
            continue
        capacity = pv.capacity_storage
        if pv.volume_mode != claim.volume_mode:
            continue
        node_affinity_valid = True
        if node is not None:
            node_affinity_valid = check_node_affinity(
                pv, node.metadata.labels)
        if is_volume_bound_to_claim(pv, claim):
            if capacity < requested:
                continue
            if not node_affinity_valid:
                # prebound PV unusable on this node -> no match at all
                return None
            return pv
        if node is None and delay_binding:
            # PV-controller path: the scheduler will bind delayed claims
            # (index.go:206-211)
            continue
        if pv.claim_ref is not None:
            continue
        if selector is not None and not selector.matches(pv.metadata.labels):
            continue
        if pv.storage_class_name != requested_class:
            continue
        if not node_affinity_valid:
            continue
        if node is not None and not _check_access_modes(claim, pv):
            continue
        if capacity >= requested and (
                smallest is None or capacity < smallest_capacity):
            smallest = pv
            smallest_capacity = capacity
    return smallest


class VolumeBinder:
    """The scheduler_binder.go volumeBinder analog over snapshot lists.

    enabled == the VolumeScheduling feature gate (off by default in the
    reference vintage: CheckVolumeBinding passes trivially and binding-mode
    delays never apply, predicates.go:1587-1589)."""

    def __init__(self, pvs: Optional[List[PersistentVolume]] = None,
                 pvcs: Optional[List[PersistentVolumeClaim]] = None,
                 classes: Optional[List[StorageClass]] = None,
                 enabled: bool = False):
        # PV copies: Assume mutates claimRef without touching snapshot objects
        self._pvs: Dict[str, PersistentVolume] = {
            pv.name: pv.copy() for pv in pvs or []}
        self._pvcs: Dict[str, PersistentVolumeClaim] = {
            pvc.key(): pvc for pvc in pvcs or []}
        self._classes: Dict[str, StorageClass] = {
            sc.name: sc for sc in classes or []}
        self.enabled = enabled
        # FindPodVolumes decisions per (pod key, node name), consumed by Assume
        # (podBindingCache analog)
        self._binding_cache: Dict[Tuple[str, str],
                                  List[Tuple[PersistentVolumeClaim,
                                             PersistentVolume]]] = {}

    # --- lister surface (PluginFactoryArgs hands these to predicates) ---

    def get_pv(self, name: str) -> Optional[PersistentVolume]:
        return self._pvs.get(name)

    def get_pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self._pvcs.get(f"{namespace}/{name}")

    def get_class(self, name: str) -> Optional[StorageClass]:
        return self._classes.get(name)

    def list_pvs(self, storage_class: str = "") -> List[PersistentVolume]:
        """pvCache.ListPVs(storageClassName) — PVs of one class."""
        return [pv for pv in self._pvs.values()
                if pv.storage_class_name == storage_class]

    # --- shouldDelayBinding (pv_controller.go:275-296) ---

    def should_delay_binding(self, pvc: PersistentVolumeClaim) -> bool:
        if not self.enabled:
            return False
        class_name = pvc.storage_class_name
        if not class_name:
            return False
        sc = self._classes.get(class_name)
        if sc is None:
            return False
        mode = sc.volume_binding_mode
        if mode is None:
            raise VolumeBinderError(
                f'VolumeBindingMode not set for StorageClass "{class_name}"')
        return mode == VOLUME_BINDING_WAIT

    # --- FindPodVolumes (scheduler_binder.go:126-166) ---

    def _pod_claims(self, pod: Pod):
        """getPodVolumes: (bound, unbound-delayed, unbound-immediate) PVC lists."""
        bound, unbound, immediate = [], [], []
        for vol in pod.spec.volumes:
            pvc_name = vol.pvc_name
            if pvc_name is None:
                continue
            pvc = self.get_pvc(pod.namespace, pvc_name)
            if pvc is None:
                raise VolumeBinderError(
                    f'error getting PVC "{pvc_name}": not found')
            if pvc.volume_name:
                bound.append(pvc)
            elif self.should_delay_binding(pvc):
                unbound.append(pvc)
            else:
                immediate.append(pvc)
        return bound, unbound, immediate

    def find_pod_volumes(self, pod: Pod, node) -> Tuple[bool, bool]:
        """Returns (unbound_satisfied, bound_satisfied)."""
        unbound_ok = True
        bound_ok = True
        bound, unbound, immediate = self._pod_claims(pod)
        if immediate:
            raise VolumeBinderError("pod has unbound PersistentVolumeClaims")
        for pvc in bound:
            pv = self.get_pv(pvc.volume_name)
            if pv is None:
                raise VolumeBinderError(
                    f'PersistentVolume "{pvc.volume_name}" not found')
            if not check_node_affinity(pv, node.metadata.labels):
                bound_ok = False
                break
        if unbound:
            unbound_ok = self._find_matching_volumes(pod, unbound, node)
        return unbound_ok, bound_ok

    def _find_matching_volumes(self, pod: Pod,
                               claims: List[PersistentVolumeClaim],
                               node) -> bool:
        """scheduler_binder.go findMatchingVolumes:342-377 — smallest-first
        claim order, chosen PVs excluded from later claims."""
        claims = sorted(claims, key=lambda c: c.request_storage)
        chosen: Dict[str, PersistentVolume] = {}
        bindings = []
        for pvc in claims:
            all_pvs = self.list_pvs(pvc.storage_class_name)
            pv = find_matching_volume(pvc, all_pvs, node, chosen,
                                      delay_binding=True)
            if pv is None:
                return False
            chosen[pv.name] = pv
            bindings.append((pvc, pv))
        self._binding_cache[(pod.key(), node.name)] = bindings
        return True

    # --- AssumePodVolumes (scheduler_binder.go:169-218) ---

    def assume_pod_volumes(self, pod: Pod, node_name: str) -> None:
        """Bind the cached per-node decisions into the in-memory PV state so
        subsequent pods see the consumed PVs (pvCache.Assume analog)."""
        for pvc, pv in self._binding_cache.pop((pod.key(), node_name), []):
            live = self._pvs.get(pv.name)
            if live is not None and live.claim_ref is None:
                spec = live.raw.setdefault("spec", {})
                spec["claimRef"] = {"name": pvc.name,
                                    "namespace": pvc.namespace,
                                    "uid": pvc.metadata.uid}
        # decisions for other nodes are stale once the pod is placed
        self._binding_cache = {k: v for k, v in self._binding_cache.items()
                               if k[0] != pod.key()}
