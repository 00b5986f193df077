"""Static engine configuration: the provider's score weights and the
pod-group feature flags of a compiled cluster."""

from __future__ import annotations

from dataclasses import dataclass

from tpusim_torch.state import CompiledCluster

AVOID_PODS_WEIGHT = 10000    # NodePreferAvoidPodsPriority weight (defaults.go)


@dataclass(frozen=True)
class EngineConfig:
    """Static (compile-time) provider configuration."""

    most_requested: bool = False  # LeastRequested -> MostRequested swap (TD/autoscaler)
    # pod-group features — the group-free kernel refuses any of them
    has_ports: bool = False
    has_services: bool = False
    has_interpod: bool = False
    has_volumes: bool = False


def config_for(compiled: CompiledCluster, most_requested: bool) -> EngineConfig:
    return EngineConfig(
        most_requested=most_requested,
        has_ports=compiled.has_ports,
        has_services=compiled.has_services,
        has_interpod=compiled.has_interpod,
        has_volumes=compiled.has_volumes)


def policy_weights(most_requested: bool) -> tuple:
    """The provider's score-component weights (generic_scheduler.go:631-639):
    (least, most, balanced, node_aff, taint, avoid)."""
    w_least, w_most = (0, 1) if most_requested else (1, 0)
    return (w_least, w_most, 1, 1, 1, AVOID_PODS_WEIGHT)
