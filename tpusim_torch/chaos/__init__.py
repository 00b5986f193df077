"""Deterministic chaos engine: seeded fault injection across the watch
fabric, the scheduler loop, and the device backend.

The simulator's reference half only ever exercises the happy path — a
frozen snapshot, a cooperative fake apiserver, a scheduler that never
sees a node vanish mid-attempt. This package adds the failure half:

- ``plan``       — the declarative :class:`FaultPlan` (JSON or
                   programmatic) plus the seeded :func:`random_plan`
                   generator used by the fault-fuzz differential tests.
- ``engine``     — :class:`ChaosEngine`: fires scripted cluster churn
                   (node delete/cordon/flap, pod eviction) through the
                   store/watch fabric at pod-attempt boundaries, carries
                   the fabric and device injectors, and audits end-state
                   invariants (no pod lost, no double-bind, no bind to a
                   deleted node).
- ``breaker``    — :class:`CircuitBreaker`: the attempt-counted
                   closed → open → half-open → closed state machine the
                   torch backend wraps around device dispatch.

Everything is deterministic under a fixed seed: the plan is data, the
engine's clock is injected (no wall-clock reads), and the breaker counts
attempts instead of seconds, so a chaos replay is byte-stable.
"""

from tpusim_torch.chaos.breaker import BreakerState, CircuitBreaker
from tpusim_torch.chaos.engine import (
    ChaosClock,
    ChaosEngine,
    DeviceFault,
    DeviceInjector,
    DeviceOutputError,
    FabricInjector,
    InjectedDeviceError,
    check_invariants,
)
from tpusim_torch.chaos.plan import (
    ChurnEvent,
    DeviceFaultPlan,
    FabricFaultPlan,
    FaultPlan,
    load_plan,
    random_plan,
)

__all__ = [
    "BreakerState",
    "ChaosClock",
    "ChaosEngine",
    "ChurnEvent",
    "CircuitBreaker",
    "DeviceFault",
    "DeviceFaultPlan",
    "DeviceInjector",
    "DeviceOutputError",
    "FabricFaultPlan",
    "FabricInjector",
    "FaultPlan",
    "InjectedDeviceError",
    "check_invariants",
    "load_plan",
    "random_plan",
]
