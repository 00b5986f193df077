"""Per-cycle latency SLO tracking for the always-on runtimes.

A `stream` or `serve` process armed with `--slo-target-ms`
judges every scheduling cycle against the target and publishes the
`tpusim_slo_*` family:

- `tpusim_slo_cycle_latency_target_microseconds` — the configured target
  (0 when no SLO is armed), so a scrape is self-describing.
- `tpusim_slo_cycles_total{verdict=ok|breach}` — cycles under/over target.
- `tpusim_slo_burn_rate` — windowed error-budget burn: the breach
  fraction over the last `window` cycles divided by the SLO's error
  budget (1 - objective). 1.0 means burning exactly at budget; a
  multiwindow alert rule fires on sustained values above ~1.

Burn-rate threshold crossings additionally land as `slo:burn_start` /
`slo:burn_end` instants on the flight recorder, so a trace shows WHEN the
budget started burning next to the cycles that caused it.

Same zero-cost-when-disabled shape as the recorder: `observe_cycle` is a
None-check when no tracker is installed.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional

from tpusim_torch.framework.metrics import register
from tpusim_torch.obs import recorder as flight


class SloTracker:
    """Judge per-cycle latencies against a fixed target.

    target_us: the per-cycle latency objective in microseconds.
    objective: the fraction of cycles that must meet the target
        (error budget = 1 - objective).
    window: cycles of history the burn rate is computed over.
    burn_alert: burn-rate threshold for the recorder instants.
    """

    def __init__(self, target_us: float, objective: float = 0.99,
                 window: int = 512, burn_alert: float = 1.0):
        if target_us <= 0:
            raise ValueError("SLO target must be positive")
        if not 0.0 < objective < 1.0:
            raise ValueError("SLO objective must be in (0, 1)")
        self.target_us = float(target_us)
        self.objective = float(objective)
        self.burn_alert = float(burn_alert)
        self._breaches: Deque[int] = deque(maxlen=max(1, int(window)))
        self._burning = False
        self._lock = threading.Lock()
        register().slo_target.set(self.target_us)

    def reset(self) -> None:
        """Clear the breach window and burn state: a role transition (a
        follower promoted to leader) starts a clean error budget, as the
        replayed cycles were never served to anyone."""
        with self._lock:
            self._breaches.clear()
            self._burning = False
        register().slo_burn_rate.set(0.0)

    @property
    def burn_rate(self) -> float:
        with self._lock:
            if not self._breaches:
                return 0.0
            frac = sum(self._breaches) / len(self._breaches)
        return frac / (1.0 - self.objective)

    def observe(self, path: str, latency_us: float) -> None:
        breach = latency_us > self.target_us
        reg = register()
        reg.slo_cycles.inc("breach" if breach else "ok")
        with self._lock:
            self._breaches.append(1 if breach else 0)
            frac = sum(self._breaches) / len(self._breaches)
            burn = frac / (1.0 - self.objective)
            crossed = None
            if burn >= self.burn_alert and not self._burning:
                self._burning, crossed = True, "burn_start"
            elif burn < self.burn_alert and self._burning:
                self._burning, crossed = False, "burn_end"
        reg.slo_burn_rate.set(burn)
        if crossed is not None:
            flight.note_slo(crossed, {"burn_rate": round(burn, 4),
                                      "path": path,
                                      "target_us": self.target_us})


# -- module-level active tracker (mirrors recorder.install) ---------------

_active: Optional[SloTracker] = None


def install(tracker: SloTracker) -> SloTracker:
    global _active
    _active = tracker
    return tracker


def uninstall() -> None:
    global _active
    _active = None
    register().slo_target.set(0.0)


def get_tracker() -> Optional[SloTracker]:
    return _active


def observe_cycle(path: str, latency_us: float) -> None:
    """Judge one cycle; no-op (a single None-check) when no SLO is armed."""
    tracker = _active
    if tracker is not None:
        tracker.observe(path, latency_us)
