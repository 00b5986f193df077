"""Observability: flight recorder spans and backend telemetry helpers.

`tpusim_torch.obs.recorder` holds the span and event subsystem,
`provenance` the decision records and `analytics` the cluster analytics
plane; the metric families they feed live in
`tpusim_torch.framework.metrics`, so the registry stays the single
exposition surface.
"""

from tpusim_torch.obs import analytics, provenance  # noqa: F401

from tpusim_torch.obs.recorder import (  # noqa: F401
    FlightRecorder,
    get_recorder,
    install,
    uninstall,
)
