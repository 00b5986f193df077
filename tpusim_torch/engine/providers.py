"""Plugin registry + algorithm providers.

Reference: factory/plugins.go:111-376 (RegisterFitPredicate /
RegisterPriorityFunction2 / RegisterAlgorithmProvider / policy factories) and
algorithmprovider/defaults/defaults.go (DefaultProvider,
ClusterAutoscalerProvider, and the locally-added TalkintDataProvider =
defaults with LeastRequested→MostRequested; defaults.go:33-37,207-217).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from tpusim_torch.engine import predicates as preds
from tpusim_torch.engine import priorities as prios
from tpusim_torch.engine.generic_scheduler import GenericScheduler
from tpusim_torch.engine.priorities import PriorityConfig

DEFAULT_PROVIDER = "DefaultProvider"
CLUSTER_AUTOSCALER_PROVIDER = "ClusterAutoscalerProvider"
TD_PROVIDER = "TalkintDataProvider"

DEFAULT_HARD_POD_AFFINITY_SYMMETRIC_WEIGHT = 1  # schedulerapi default; simulator passes 10

# the DefaultProvider predicate key set (defaults.go:169-205), shared by all
# three shipped providers; module-level so a policy's preemption class
# can be classified without assembling a registry
DEFAULT_PREDICATE_KEYS = frozenset({
    preds.NO_VOLUME_ZONE_CONFLICT_PRED,
    preds.MAX_EBS_VOLUME_COUNT_PRED,
    preds.MAX_GCE_PD_VOLUME_COUNT_PRED,
    preds.MAX_AZURE_DISK_VOLUME_COUNT_PRED,
    preds.MATCH_INTERPOD_AFFINITY_PRED,
    preds.NO_DISK_CONFLICT_PRED,
    preds.GENERAL_PRED,
    preds.CHECK_NODE_MEMORY_PRESSURE_PRED,
    preds.CHECK_NODE_DISK_PRESSURE_PRED,
    preds.CHECK_NODE_CONDITION_PRED,
    preds.POD_TOLERATES_NODE_TAINTS_PRED,
    preds.CHECK_VOLUME_BINDING_PRED,
})


@dataclass
class PluginFactoryArgs:
    """Reference: factory/plugins.go PluginFactoryArgs — the listers handed to
    predicate/priority factories."""

    pod_lister: Callable[[], list] = field(default=lambda: [])
    service_lister: Callable[[], list] = field(default=lambda: [])
    controller_lister: Callable[[], list] = field(default=lambda: [])
    replica_set_lister: Callable[[], list] = field(default=lambda: [])
    stateful_set_lister: Callable[[], list] = field(default=lambda: [])
    node_info_getter: Callable[[str], object] = field(default=lambda name: None)
    # volume listers (factory.go pVLister/pVCLister/storageClassLister) + the
    # scheduler-side binder (factory.go:252-259); None binder = gate off
    pvc_getter: Callable[[str, str], object] = field(default=lambda ns, name: None)
    pv_getter: Callable[[str], object] = field(default=lambda name: None)
    storage_class_getter: Callable[[str], object] = field(default=lambda name: None)
    volume_binder: Optional[object] = None
    volume_scheduling_enabled: bool = False
    hard_pod_affinity_symmetric_weight: int = DEFAULT_HARD_POD_AFFINITY_SYMMETRIC_WEIGHT
    # extended resources ignored in PodFitsResources because an extender
    # manages them (factory.go:984-988)
    ignored_extended_resources: Optional[Set[str]] = None

    def selector_spread(self) -> "prios.SelectorSpread":
        """One shared SelectorSpread per factory args, so the map/reduce fns and
        the priority-metadata pod_selectors can never disagree."""
        if not hasattr(self, "_selector_spread"):
            self._selector_spread = prios.SelectorSpread(
                self.service_lister, self.controller_lister,
                self.replica_set_lister, self.stateful_set_lister)
        return self._selector_spread


@dataclass
class PriorityConfigFactory:
    map_reduce_function: Optional[Callable] = None  # args -> (map_fn, reduce_fn)
    function: Optional[Callable] = None             # args -> legacy function
    weight: int = 1


# plugins.go:476 validName — note the upstream regex requires >= 2 chars
VALID_NAME_RE = re.compile(r"^[a-zA-Z0-9]([-a-zA-Z0-9]*[a-zA-Z0-9])$")
# api/types.go:31-38 — MaxInt is Go's 64-bit int; MaxWeight = MaxInt/MaxPriority
MAX_TOTAL_PRIORITY = 2**63 - 1


def validate_algorithm_name(name: str) -> None:
    """plugins.go:478-482 validateAlgorithmNameOrDie (raises, never dies).
    fullmatch, not match: Python's $ would accept a trailing newline that
    Go's end-of-text anchor rejects."""
    if not VALID_NAME_RE.fullmatch(name):
        raise ValueError(f"algorithm name {name!r} does not match the name "
                         f"validation regex \"{VALID_NAME_RE.pattern}\"")


def validate_selected_configs(configs: List["PriorityConfig"]) -> None:
    """plugins.go:463-474: the summed weight*MaxPriority must not overflow."""
    from tpusim_torch.engine.priorities import MAX_PRIORITY

    total = 0
    for config in configs:
        if config.weight * MAX_PRIORITY > MAX_TOTAL_PRIORITY - total:
            raise ValueError(
                "Total priority of priority functions has overflown")
        total += config.weight * MAX_PRIORITY


class AlgorithmRegistry:
    """One registry instance == the Go package-level registries."""

    def __init__(self):
        self.fit_predicates: Dict[str, Callable] = {}           # name -> fn
        self.fit_predicate_factories: Dict[str, Callable] = {}  # name -> (args -> fn)
        self.mandatory_fit_predicates: Set[str] = set()
        self.priority_factories: Dict[str, PriorityConfigFactory] = {}
        self.providers: Dict[str, tuple[Set[str], Set[str]]] = {}

    # --- registration (plugins.go:111-376) ---

    def register_fit_predicate(self, name: str, fn: Callable) -> str:
        validate_algorithm_name(name)
        self.fit_predicates[name] = fn
        return name

    def register_fit_predicate_factory(self, name: str, factory: Callable) -> str:
        validate_algorithm_name(name)
        self.fit_predicate_factories[name] = factory
        return name

    def register_mandatory_fit_predicate(self, name: str, fn: Callable) -> str:
        validate_algorithm_name(name)
        self.fit_predicates[name] = fn
        self.mandatory_fit_predicates.add(name)
        return name

    def remove_fit_predicate(self, name: str) -> None:
        self.fit_predicates.pop(name, None)
        self.fit_predicate_factories.pop(name, None)
        self.mandatory_fit_predicates.discard(name)

    def register_priority_function2(self, name: str, map_fn, reduce_fn, weight: int) -> str:
        validate_algorithm_name(name)
        self.priority_factories[name] = PriorityConfigFactory(
            map_reduce_function=lambda args: (map_fn, reduce_fn), weight=weight)
        return name

    def register_priority_config_factory(self, name: str,
                                         factory: PriorityConfigFactory) -> str:
        validate_algorithm_name(name)
        self.priority_factories[name] = factory
        return name

    def register_algorithm_provider(self, name: str, predicate_keys: Set[str],
                                    priority_keys: Set[str]) -> str:
        validate_algorithm_name(name)
        self.providers[name] = (set(predicate_keys), set(priority_keys))
        return name

    def get_algorithm_provider(self, name: str) -> tuple[Set[str], Set[str]]:
        if name not in self.providers:
            raise KeyError(f"plugin {name!r} has not been registered")
        return self.providers[name]

    # --- assembly (factory.go CreateFromKeys:1021-1082) ---

    def build_predicates(self, keys: Set[str], args: PluginFactoryArgs) -> Dict[str, Callable]:
        result: Dict[str, Callable] = {}
        for key in set(keys) | self.mandatory_fit_predicates:
            if key in self.fit_predicate_factories:
                result[key] = self.fit_predicate_factories[key](args)
            elif key in self.fit_predicates:
                result[key] = self.fit_predicates[key]
            else:
                raise KeyError(f"invalid predicate key {key!r}")
        return result

    def build_prioritizers(self, keys: Set[str], args: PluginFactoryArgs
                           ) -> List[PriorityConfig]:
        configs = []
        for key in sorted(keys):  # deterministic (Go iterates a map)
            if key not in self.priority_factories:
                raise KeyError(f"invalid priority key {key!r}")
            factory = self.priority_factories[key]
            if factory.function is not None:
                configs.append(PriorityConfig(name=key, weight=factory.weight,
                                              function=factory.function(args)))
            else:
                map_fn, reduce_fn = factory.map_reduce_function(args)
                configs.append(PriorityConfig(name=key, weight=factory.weight,
                                              map_fn=map_fn, reduce_fn=reduce_fn))
        validate_selected_configs(configs)
        return configs


def default_registry() -> AlgorithmRegistry:
    """Reproduces algorithmprovider/defaults/defaults.go init()."""
    r = AlgorithmRegistry()

    # --- predicates (defaults.go:113-178 + init extras) ---
    r.register_fit_predicate_factory(
        preds.NO_VOLUME_ZONE_CONFLICT_PRED,
        lambda args: preds.make_no_volume_zone_conflict_predicate(
            args.pvc_getter, args.pv_getter, args.storage_class_getter,
            volume_scheduling_enabled=args.volume_scheduling_enabled))
    r.register_fit_predicate_factory(
        preds.MAX_EBS_VOLUME_COUNT_PRED,
        lambda args: preds.make_max_pd_volume_count_predicate(
            "EBS", args.pvc_getter, args.pv_getter))
    r.register_fit_predicate_factory(
        preds.MAX_GCE_PD_VOLUME_COUNT_PRED,
        lambda args: preds.make_max_pd_volume_count_predicate(
            "GCE", args.pvc_getter, args.pv_getter))
    r.register_fit_predicate_factory(
        preds.MAX_AZURE_DISK_VOLUME_COUNT_PRED,
        lambda args: preds.make_max_pd_volume_count_predicate(
            "AzureDisk", args.pvc_getter, args.pv_getter))
    r.register_fit_predicate_factory(
        preds.MATCH_INTERPOD_AFFINITY_PRED,
        lambda args: preds.make_pod_affinity_predicate(args.node_info_getter,
                                                       args.pod_lister))
    r.register_fit_predicate(preds.NO_DISK_CONFLICT_PRED, preds.no_disk_conflict)
    r.register_fit_predicate(preds.GENERAL_PRED, preds.general_predicates)
    r.register_fit_predicate(preds.CHECK_NODE_MEMORY_PRESSURE_PRED,
                             preds.check_node_memory_pressure)
    r.register_fit_predicate(preds.CHECK_NODE_DISK_PRESSURE_PRED,
                             preds.check_node_disk_pressure)
    r.register_mandatory_fit_predicate(preds.CHECK_NODE_CONDITION_PRED,
                                       preds.check_node_condition)
    r.register_fit_predicate(preds.POD_TOLERATES_NODE_TAINTS_PRED,
                             preds.pod_tolerates_node_taints)
    r.register_fit_predicate_factory(
        preds.CHECK_VOLUME_BINDING_PRED,
        lambda args: preds.make_check_volume_binding_predicate(args.volume_binder))
    # registered-but-not-default predicates (defaults.go init():60-111)
    r.register_fit_predicate(preds.POD_FITS_RESOURCES_PRED, preds.pod_fits_resources)
    r.register_fit_predicate(preds.HOSTNAME_PRED, preds.pod_fits_host)
    r.register_fit_predicate(preds.POD_FITS_HOST_PORTS_PRED, preds.pod_fits_host_ports)
    # 1.0 backward-compat alias for PodFitsHostPorts (defaults.go:63-65)
    r.register_fit_predicate("PodFitsPorts", preds.pod_fits_host_ports)
    r.register_fit_predicate(preds.MATCH_NODE_SELECTOR_PRED, preds.pod_match_node_selector)
    r.register_fit_predicate(preds.CHECK_NODE_UNSCHEDULABLE_PRED,
                             preds.check_node_unschedulable)
    r.register_fit_predicate(preds.POD_TOLERATES_NODE_NO_EXECUTE_TAINTS_PRED,
                             preds.pod_tolerates_node_no_execute_taints)

    default_predicate_keys = set(DEFAULT_PREDICATE_KEYS)

    # --- priorities (defaults.go:219-259 + init extras) ---
    r.register_priority_config_factory(
        "SelectorSpreadPriority",
        PriorityConfigFactory(
            map_reduce_function=lambda args: _selector_spread_map_reduce(args),
            weight=1))
    r.register_priority_config_factory(
        "InterPodAffinityPriority",
        PriorityConfigFactory(
            function=lambda args: prios.InterPodAffinityPriority(
                args.node_info_getter,
                args.hard_pod_affinity_symmetric_weight).calculate,
            weight=1))
    r.register_priority_function2("LeastRequestedPriority",
                                  prios.least_requested_priority_map, None, 1)
    r.register_priority_function2("BalancedResourceAllocation",
                                  prios.balanced_resource_allocation_map, None, 1)
    r.register_priority_function2("NodePreferAvoidPodsPriority",
                                  prios.calculate_node_prefer_avoid_pods_priority_map,
                                  None, 10000)
    r.register_priority_function2("NodeAffinityPriority",
                                  prios.calculate_node_affinity_priority_map,
                                  prios.calculate_node_affinity_priority_reduce, 1)
    r.register_priority_function2("TaintTolerationPriority",
                                  prios.compute_taint_toleration_priority_map,
                                  prios.compute_taint_toleration_priority_reduce, 1)
    # registered-but-not-default (defaults.go:100-111)
    # 1.0 backward-compat alias: service-only spreading (defaults.go:89-101 —
    # SelectorSpread over the service lister with EMPTY controller/RS/SS
    # listers, unlike SelectorSpreadPriority's fully-wired instance)
    r.register_priority_config_factory(
        "ServiceSpreadingPriority",
        PriorityConfigFactory(
            map_reduce_function=lambda args: _service_spreading_map_reduce(args),
            weight=1))
    r.register_priority_function2("EqualPriority", prios.equal_priority_map, None, 1)
    r.register_priority_function2("ImageLocalityPriority",
                                  prios.image_locality_priority_map, None, 1)
    r.register_priority_function2("MostRequestedPriority",
                                  prios.most_requested_priority_map, None, 1)

    default_priority_keys = {
        "SelectorSpreadPriority",
        "InterPodAffinityPriority",
        "LeastRequestedPriority",
        "BalancedResourceAllocation",
        "NodePreferAvoidPodsPriority",
        "NodeAffinityPriority",
        "TaintTolerationPriority",
    }

    def copy_and_replace(keys: Set[str], what: str, with_: str) -> Set[str]:
        result = set(keys)
        if what in result:
            result.discard(what)
            result.add(with_)
        return result

    # registerAlgorithmProvider (defaults.go:207-217)
    r.register_algorithm_provider(DEFAULT_PROVIDER, default_predicate_keys,
                                  default_priority_keys)
    autoscaler_priorities = copy_and_replace(
        default_priority_keys, "LeastRequestedPriority", "MostRequestedPriority")
    r.register_algorithm_provider(CLUSTER_AUTOSCALER_PROVIDER, default_predicate_keys,
                                  autoscaler_priorities)
    r.register_algorithm_provider(TD_PROVIDER, default_predicate_keys,
                                  autoscaler_priorities)
    return r


KNOWN_FEATURE_GATES = {"TaintNodesByCondition", "ResourceLimitsPriorityFunction",
                       "PodPriority", "VolumeScheduling"}


def parse_feature_gates(spec: str) -> Dict[str, bool]:
    """Parse the kube --feature-gates map flag ("Key=true,Other=false");
    unknown keys and non-boolean values are rejected like
    utilfeature.DefaultFeatureGate.Set does."""
    gates: Dict[str, bool] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        key = key.strip()
        if key not in KNOWN_FEATURE_GATES:
            raise ValueError(f"unrecognized feature gate: {key}")
        if not sep:
            raise ValueError(f"missing bool value for {key}")
        val = val.strip().lower()
        if val not in ("true", "false"):
            raise ValueError(
                f"invalid value of {key}={val}, err: strconv.ParseBool: "
                f"parsing {val!r}: invalid syntax")
        gates[key] = val == "true"
    return gates


def apply_feature_gates(registry: AlgorithmRegistry,
                        gates: Dict[str, bool]) -> None:
    """ApplyFeatureGates (defaults.go:181-205): feature-gate-driven registry
    surgery, run before provider/policy assembly like the scheduler app does.

    TaintNodesByCondition: CheckNodeCondition is removed (from the registry
    AND every provider's key set) and PodToleratesNodeTaints becomes a
    MANDATORY predicate inserted into every provider — fit is then
    determined by whether the pod tolerates all of the node's taints.
    ResourceLimitsPriorityFunction: registers ResourceLimitsPriority at
    weight 1 (registration only — selection still follows the provider or
    policy keys, matching the Go behavior). Both gates default off in this
    k8s vintage."""
    if gates.get("TaintNodesByCondition"):
        registry.remove_fit_predicate(preds.CHECK_NODE_CONDITION_PRED)
        for pred_keys, _pri_keys in registry.providers.values():
            pred_keys.discard(preds.CHECK_NODE_CONDITION_PRED)
        registry.register_mandatory_fit_predicate(
            preds.POD_TOLERATES_NODE_TAINTS_PRED,
            preds.pod_tolerates_node_taints)
        for pred_keys, _pri_keys in registry.providers.values():
            pred_keys.add(preds.POD_TOLERATES_NODE_TAINTS_PRED)
    if gates.get("ResourceLimitsPriorityFunction"):
        registry.register_priority_function2(
            "ResourceLimitsPriority", prios.resource_limits_priority_map,
            None, 1)


def _selector_spread_map_reduce(args: PluginFactoryArgs):
    spread = args.selector_spread()
    return spread.calculate_spread_priority_map, spread.calculate_spread_priority_reduce


def _service_spreading_map_reduce(args: PluginFactoryArgs):
    """ServiceSpreadingPriority (1.0 alias): services only, empty controller/
    ReplicaSet/StatefulSet listers (defaults.go:92-100)."""
    spread = prios.SelectorSpread(args.service_lister)
    return (spread.calculate_spread_priority_map,
            spread.calculate_spread_priority_reduce)


def create_from_provider(provider: str, args: PluginFactoryArgs,
                         registry: Optional[AlgorithmRegistry] = None,
                         always_check_all_predicates: bool = False) -> GenericScheduler:
    """factory.go CreateFromProvider → CreateFromKeys."""
    registry = registry or default_registry()
    pred_keys, pri_keys = registry.get_algorithm_provider(provider)
    return _create_from_keys(registry, pred_keys, pri_keys, args,
                             always_check_all_predicates=always_check_all_predicates)


def _create_from_keys(registry: AlgorithmRegistry, pred_keys: Set[str],
                      pri_keys: Set[str], args: PluginFactoryArgs,
                      extenders: Optional[list] = None,
                      always_check_all_predicates: bool = False) -> GenericScheduler:
    """factory.go CreateFromKeys:1021-1082."""
    weight = args.hard_pod_affinity_symmetric_weight
    if weight < 1 or weight > 100:
        # factory.go:1024-1026: the range is [1, 100]
        raise ValueError(f"invalid hardPodAffinitySymmetricWeight: {weight}, "
                         "must be in the range 1-100")
    predicates = registry.build_predicates(pred_keys, args)
    prioritizers = registry.build_prioritizers(pri_keys, args)

    def priority_meta_producer(pod):
        return prios.get_priority_metadata(pod, args.selector_spread())

    def predicate_meta_producer(pod, node_info_map):
        return preds.get_predicate_metadata(
            pod, node_info_map,
            ignored_extended_resources=args.ignored_extended_resources)

    return GenericScheduler(
        predicates=predicates,
        prioritizers=prioritizers,
        predicate_meta_producer=predicate_meta_producer,
        priority_meta_producer=priority_meta_producer,
        extenders=extenders,
        always_check_all_predicates=always_check_all_predicates,
    )


# ---------------------------------------------------------------------------
# policy-as-data assembly (factory.go CreateFromConfig:933-1000,
# plugins.go RegisterCustomFitPredicate:197-240 /
# RegisterCustomPriorityFunction:302-348)
# ---------------------------------------------------------------------------


def register_custom_fit_predicate(registry: AlgorithmRegistry,
                                  pred_policy) -> str:
    """plugins.go RegisterCustomFitPredicate:197-240: a policy entry either
    instantiates a parameterized predicate (ServiceAffinity / LabelsPresence)
    under the policy's name, or references a pre-registered predicate."""
    arg = pred_policy.argument
    if arg is not None:
        if arg.service_affinity is not None:
            labels = list(arg.service_affinity.labels)
            factory = lambda args: preds.make_service_affinity_predicate(  # noqa: E731
                labels, args.pod_lister, args.service_lister,
                args.node_info_getter)
            return registry.register_fit_predicate_factory(pred_policy.name, factory)
        if arg.labels_presence is not None:
            labels = list(arg.labels_presence.labels)
            presence = arg.labels_presence.presence
            factory = lambda args: preds.make_node_label_presence_predicate(  # noqa: E731
                labels, presence)
            return registry.register_fit_predicate_factory(pred_policy.name, factory)
    if pred_policy.name in registry.fit_predicates \
            or pred_policy.name in registry.fit_predicate_factories:
        return pred_policy.name  # pre-defined predicate requested: reuse
    raise KeyError("Invalid configuration: Predicate type not found for "
                   f"{pred_policy.name}")


def register_custom_priority_function(registry: AlgorithmRegistry,
                                      pri_policy) -> str:
    """plugins.go RegisterCustomPriorityFunction:302-348."""
    arg = pri_policy.argument
    factory: Optional[PriorityConfigFactory] = None
    if arg is not None:
        if arg.service_anti_affinity is not None:
            label = arg.service_anti_affinity.label
            factory = PriorityConfigFactory(
                map_reduce_function=lambda args, label=label:
                    prios.make_service_anti_affinity_priority(
                        args.pod_lister, args.service_lister, label),
                weight=pri_policy.weight)
        elif arg.label_preference is not None:
            label = arg.label_preference.label
            presence = arg.label_preference.presence
            factory = PriorityConfigFactory(
                map_reduce_function=lambda args, label=label, presence=presence:
                    (prios.make_node_label_priority_map(label, presence), None),
                weight=pri_policy.weight)
    elif pri_policy.name in registry.priority_factories:
        existing = registry.priority_factories[pri_policy.name]
        # reuse the registered function, but take the policy's weight
        factory = PriorityConfigFactory(
            map_reduce_function=existing.map_reduce_function,
            function=existing.function, weight=pri_policy.weight)
    if factory is None:
        raise KeyError("Invalid configuration: Priority type not found for "
                       f"{pri_policy.name}")
    return registry.register_priority_config_factory(pri_policy.name, factory)


def create_from_config(policy, args: PluginFactoryArgs,
                       registry: Optional[AlgorithmRegistry] = None,
                       extender_transport=None) -> GenericScheduler:
    """factory.go CreateFromConfig:933-1000.

    policy.predicates None → DefaultProvider predicate keys; [] → mandatory
    only. policy.priorities None → DefaultProvider priority keys; [] → none.
    Extenders are built from ExtenderConfigs; a policy-provided
    HardPodAffinitySymmetricWeight overrides the CLI/config value, and
    AlwaysCheckAllPredicates can only be switched on, never off.
    """
    from tpusim_torch.engine.extender import new_http_extender
    from tpusim_torch.engine.policy import validate_policy

    validate_policy(policy)
    registry = registry or default_registry()

    if policy.predicates is None:
        pred_keys, _ = registry.get_algorithm_provider(DEFAULT_PROVIDER)
    else:
        pred_keys = {register_custom_fit_predicate(registry, p)
                     for p in policy.predicates}
    if policy.priorities is None:
        _, pri_keys = registry.get_algorithm_provider(DEFAULT_PROVIDER)
    else:
        pri_keys = {register_custom_priority_function(registry, p)
                    for p in policy.priorities}

    extenders = [new_http_extender(cfg, transport=extender_transport)
                 for cfg in policy.extender_configs]
    # predicates skip resources ignored by an extender (factory.go:984-988)
    ignored = {r.name for cfg in policy.extender_configs
               for r in cfg.managed_resources if r.ignored_by_scheduler}
    if ignored:
        args.ignored_extended_resources = ignored

    if policy.hard_pod_affinity_symmetric_weight != 0:
        args.hard_pod_affinity_symmetric_weight = \
            policy.hard_pod_affinity_symmetric_weight
    return _create_from_keys(
        registry, pred_keys, pri_keys, args, extenders=extenders,
        always_check_all_predicates=policy.always_check_all_predicates)
