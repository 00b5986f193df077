"""Circuit breaker: closed → open on repeated faults → half-open re-probe
→ closed.

The torch backend wraps device dispatch in one of these while a chaos plan
is installed, so a flaky device (injected faults) degrades to the host
pipeline, counted, and RECOVERS instead of crashing the run. Only
chaos.engine.DeviceFault reaches the breaker: any other error of a kernel
or the scan raises.

Deterministic by construction: state advances on *attempt counts*, never
wall-clock — ``cooldown`` is the number of denied dispatches before a
half-open probe, so a seeded chaos replay walks the identical transition
sequence every run. Every transition lands in the
``tpusim_breaker_transitions_total`` counter family and as a recorder
instant (``breaker:<transition>``) via the ``obs.recorder.note_breaker``
bridge, and the live state is mirrored into the ``tpusim_breaker_state``
gauge (0 closed, 0.5 half-open, 1 open).
"""

from __future__ import annotations

import enum
from typing import Optional


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


_STATE_GAUGE = {BreakerState.CLOSED: 0.0, BreakerState.HALF_OPEN: 0.5,
                BreakerState.OPEN: 1.0}


class CircuitBreaker:
    """Attempt-counted three-state breaker.

    - CLOSED: traffic flows; ``failure_threshold`` CONSECUTIVE failures
      trip it open (any success resets the streak).
    - OPEN: ``allow()`` denies; after ``cooldown`` denials the breaker
      moves to HALF_OPEN.
    - HALF_OPEN: exactly one probe is allowed through; its success closes
      the breaker, its failure reopens (and restarts the cooldown).
    """

    def __init__(self, name: str = "device", failure_threshold: int = 3,
                 cooldown: int = 2):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.denied_since_open = 0
        self.transitions: list = []  # (transition, detail) audit trail

    # -- state machine -----------------------------------------------------

    def _transition(self, state: BreakerState, transition: str,
                    detail: Optional[str] = None) -> None:
        self.state = state
        self.transitions.append((transition, detail or ""))
        from tpusim_torch.obs.recorder import note_breaker

        note_breaker(self.name, transition, _STATE_GAUGE[state], detail)

    def allow(self) -> bool:
        """May the next dispatch go to the device? A denial while OPEN
        counts toward the cooldown; once it elapses the breaker half-opens
        and the NEXT call is the probe."""
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.HALF_OPEN:
            return True  # the probe
        self.denied_since_open += 1
        if self.denied_since_open >= self.cooldown:
            self._transition(BreakerState.HALF_OPEN, "half_open",
                            f"after {self.denied_since_open} denied")
        return False

    @property
    def probing(self) -> bool:
        """True when the next allowed dispatch is the half-open probe (the
        caller must verify its output before trusting it)."""
        return self.state is BreakerState.HALF_OPEN

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state is BreakerState.HALF_OPEN:
            self._transition(BreakerState.CLOSED, "close", "probe passed")

    def record_failure(self, reason: str = "") -> None:
        if self.state is BreakerState.HALF_OPEN:
            self.denied_since_open = 0
            self._transition(BreakerState.OPEN, "reopen",
                            reason or "probe failed")
            return
        self.consecutive_failures += 1
        if (self.state is BreakerState.CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self.denied_since_open = 0
            self._transition(
                BreakerState.OPEN, "open",
                reason or f"{self.consecutive_failures} consecutive faults")

    def reset(self) -> None:
        """Back to pristine CLOSED (test isolation; not a transition)."""
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.denied_since_open = 0
        self.transitions = []
