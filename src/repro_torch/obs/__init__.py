"""Flight recorder: structured event tracing for scheduler, routers, fleet.

The observability substrate (see ``repro_torch.obs.recorder``): a
zero-overhead-when-off columnar event store capturing every decision
point — arrivals/admissions, dispatch spans, router price vectors,
autoscale events — with three read paths: Chrome ``trace_event`` JSON
(``repro_torch.obs.trace_export``, Perfetto-viewable timelines), windowed
time-series telemetry (``repro_torch.obs.telemetry``).
"""

from repro_torch.obs.recorder import (
    FlightRecorder,
    ReplicaShard,
    dispatch_tap,
    route_price_vector,
)
from repro_torch.obs.telemetry import windowed_series
from repro_torch.obs.trace_export import chrome_trace_events, export_chrome_trace

__all__ = [
    "FlightRecorder",
    "ReplicaShard",
    "chrome_trace_events",
    "dispatch_tap",
    "export_chrome_trace",
    "route_price_vector",
    "windowed_series",
]
