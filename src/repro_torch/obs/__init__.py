"""``repro_torch.obs``: observability for the plan -> sim -> serve stack
(counterpart of ``repro/obs/__init__.py``, DESIGN.md §12).

``metrics``, ``attribution``, ``critpath``, ``timeline`` and ``whatif``
are pure-Python copies of the JAX package's modules: the serving metrics
registry and request spans behind ``Engine.stats()`` and
``ServeSimResult.metrics`` (with the engine==simulator
``assert_serve_parity``), per-resource stall attribution, the causal
critical path, Perfetto timelines of simulator traces, serve results and
recorded kernels, and what-if projections.  ``python -m repro_torch.obs``
renders the text report; it runs on the host only.
"""
from repro_torch.obs.attribution import (INTERCONNECT, AttributionReport,
                                         OpClassBreakdown, attribute,
                                         base_resource, bottleneck_of,
                                         format_report, op_class,
                                         rewrite_stall_by_op)
from repro_torch.obs.critpath import (CritPathReport, compute_slack,
                                      critical_path, format_critpath)
from repro_torch.obs.metrics import (METRICS_SCHEMA_VERSION, Counter, Gauge,
                                     Histogram, MetricsRegistry, RequestSpan,
                                     SPAN_METRICS, assert_serve_parity,
                                     percentile, spans_from_steps, summarize,
                                     summarize_spans)
from repro_torch.obs.timeline import (KIND_COLORS, RESOURCE_ORDER,
                                      TIMELINE_SCHEMA_VERSION, kernel_events,
                                      load_timeline, timeline_from_records,
                                      timeline_from_serve,
                                      timeline_from_sharded,
                                      timeline_from_sim, timeline_from_trace,
                                      trace_events, validate_timeline,
                                      write_timeline)
from repro_torch.obs.whatif import (WhatIfProjection, format_whatif, headroom,
                                    project, run_whatif, whatif_link_bandwidth,
                                    whatif_ping_pong, whatif_resource)

__all__ = [
    "INTERCONNECT", "AttributionReport", "OpClassBreakdown", "attribute",
    "base_resource", "bottleneck_of",
    "format_report", "op_class", "rewrite_stall_by_op",
    "CritPathReport", "compute_slack", "critical_path", "format_critpath",
    "WhatIfProjection", "format_whatif", "headroom", "project",
    "run_whatif", "whatif_link_bandwidth", "whatif_ping_pong",
    "whatif_resource",
    "METRICS_SCHEMA_VERSION", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "RequestSpan", "SPAN_METRICS", "assert_serve_parity",
    "percentile", "spans_from_steps", "summarize", "summarize_spans",
    "KIND_COLORS", "RESOURCE_ORDER", "TIMELINE_SCHEMA_VERSION",
    "kernel_events", "load_timeline", "timeline_from_records",
    "timeline_from_serve", "timeline_from_sharded", "timeline_from_sim",
    "timeline_from_trace", "trace_events", "validate_timeline",
    "write_timeline",
]
