"""Static engine configuration: the provider's score weights and the
pod-group feature flags of a compiled cluster."""

from __future__ import annotations

from dataclasses import dataclass

from tpusim_torch.engine.predicates import DEFAULT_MAXPD_LIMITS
from tpusim_torch.state import CompiledCluster

AVOID_PODS_WEIGHT = 10000    # NodePreferAvoidPodsPriority weight (defaults.go)


@dataclass(frozen=True)
class EngineConfig:
    """Static (compile-time) provider configuration."""

    most_requested: bool = False  # LeastRequested -> MostRequested swap (TD/autoscaler)
    # pod-group features, compiled in only when the workload needs them
    has_ports: bool = False
    has_services: bool = False
    has_interpod: bool = False
    has_disk_conflict: bool = False
    has_maxpd: bool = False
    has_vol_zone: bool = False
    maxpd_limits: tuple = DEFAULT_MAXPD_LIMITS  # (EBS, GCE PD, AzureDisk)
    hard_weight: int = 10         # HardPodAffinitySymmetricWeight
    n_topo_doms: int = 1          # topology domains incl. the invalid 0 bucket
    n_zone_doms: int = 1          # zone domains incl. the no-zone 0 bucket


def config_for(compiled: CompiledCluster, most_requested: bool,
               hard_weight: int = 10) -> EngineConfig:
    return EngineConfig(
        most_requested=most_requested,
        has_ports=compiled.has_ports,
        has_services=compiled.has_services,
        has_interpod=compiled.has_interpod,
        has_disk_conflict=compiled.has_disk_conflict,
        has_maxpd=compiled.has_maxpd,
        has_vol_zone=compiled.has_vol_zone,
        maxpd_limits=(compiled.maxpd_limits if compiled.has_maxpd
                      else DEFAULT_MAXPD_LIMITS),
        hard_weight=hard_weight,
        n_topo_doms=compiled.n_topo_doms,
        n_zone_doms=compiled.n_zone_doms)


def policy_weights(most_requested: bool) -> tuple:
    """The provider's score-component weights (generic_scheduler.go:631-639):
    (least, most, balanced, node_aff, taint, avoid, spread, interpod)."""
    w_least, w_most = (0, 1) if most_requested else (1, 0)
    return (w_least, w_most, 1, 1, 1, AVOID_PODS_WEIGHT, 1, 1)
