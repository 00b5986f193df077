"""The predicate helpers the cluster compile step evaluates per (signature,
node) cell.

Reference: predicates.go:778-846 (podMatchesNodeLabels +
nodeMatchesNodeSelectorTerms).
"""

from __future__ import annotations

from tpusim_torch.api.types import Node, Pod


def pod_matches_node_labels(pod: Pod, node: Node) -> bool:
    """nodeSelector map AND required node-affinity. Terms are ORed in order;
    an empty term list matches nothing; a term whose selector fails
    validation (match_result None — NodeSelectorRequirementsAsSelector
    error) makes the whole affinity a non-match immediately."""
    if pod.spec.node_selector:
        for k, v in pod.spec.node_selector.items():
            if node.metadata.labels.get(k) != v:
                return False
    affinity = pod.spec.affinity
    if affinity is not None and affinity.node_affinity is not None:
        na = affinity.node_affinity
        if na.required_terms is not None:
            for t in na.required_terms:
                r = t.match_result(node.metadata.labels)
                if r is None:
                    return False  # parse error: "regarding as not match"
                if r:
                    break
            else:
                return False
    return True
