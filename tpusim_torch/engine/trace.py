"""utiltrace analog: named traces with steps, logged when slow.

Reference: vendor/k8s.io/apiserver/pkg/util/trace/trace.go (Trace/Step/
LogIfLong) as used by core/generic_scheduler.go:113-165 — a per-pod
"Scheduling ns/name" trace with steps "Computing predicates", "Prioritizing",
"Selecting host", logged when the total exceeds 100ms with per-step
thresholding (threshold / (len(steps)+1)).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("tpusim_torch.trace")

SLOW_SCHEDULE_THRESHOLD = 0.100  # 100ms (generic_scheduler.go:114)


class Trace:
    def __init__(self, name: str, _now: Callable[[], float] = time.perf_counter):
        self.name = name
        self._now = _now
        self.start_time = _now()
        self.steps: List[Tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((self._now(), msg))

    def total_time(self) -> float:
        return self._now() - self.start_time

    def _format(self, step_threshold: float) -> str:
        end = self._now()
        lines = [f'Trace: "{self.name}" '
                 f"(total time: {(end - self.start_time) * 1000:.1f}ms):"]
        last = self.start_time
        for step_time, msg in self.steps:
            duration = step_time - last
            if step_threshold == 0 or duration > step_threshold:
                lines.append(
                    f"Trace: [{(step_time - self.start_time) * 1000:.1f}ms] "
                    f"[{duration * 1000:.1f}ms] {msg}")
            last = step_time
        duration = end - last
        if step_threshold == 0 or duration > step_threshold:
            lines.append(f"Trace: [{(end - self.start_time) * 1000:.1f}ms] "
                         f"[{duration * 1000:.1f}ms] END")
        return "\n".join(lines)

    def log(self) -> None:
        logger.info(self._format(0))

    def log_if_long(self, threshold: float = SLOW_SCHEDULE_THRESHOLD) -> Optional[str]:
        """Log (and return) the trace when total time exceeds threshold; steps
        below their share (threshold / (steps+1)) are elided (trace.go:79-85)."""
        if self._now() - self.start_time >= threshold:
            step_threshold = threshold / (len(self.steps) + 1)
            text = self._format(step_threshold)
            logger.info(text)
            return text
        return None
