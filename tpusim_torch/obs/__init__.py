"""Observability: flight recorder spans and backend telemetry helpers.

`tpusim_torch.obs.recorder` holds the span and event subsystem; the metric
families it feeds live in `tpusim_torch.framework.metrics`, so the registry
stays the single exposition surface.
"""

from tpusim_torch.obs.recorder import (  # noqa: F401
    FlightRecorder,
    get_recorder,
    install,
    uninstall,
)
