"""obs — the port's telemetry subsystem (the JAX package's ``obs/``).

One layer answering "how fast is this step, what did it build, and
which rank is unhealthy" across the trainer, both servers and the
pipeline, with the JAX package's metric names and event schema:

  registry   thread-safe counters/gauges/histograms + snapshot() and
             Prometheus text
  events     structured JSONL run events + run manifest (size-rotated
             for long-lived servers; readers span segments)
  flops      analytic model FLOPs, the H100's peaks, MFU, card memory
  costs      per-program cost ledger (FlopCounterMode flops, bytes,
             peak memory) + measured per-program MFU
  profile    on-demand torch.profiler captures (/admin/profile,
             --profile-steps) + the `profile` CLI's capture summary
  recompile  build counting: CUDA-graph captures, kernel builds/loads
  heartbeat  per-process liveness records
  telemetry  the facade the training/serving layers talk to; the
             sync-free step clock
  summary    fold a run log into a report (the `telemetry` CLI)
  trace      per-request span trees + x-jg-trace propagation, run-scoped
             request ids, Perfetto export and p99 tail attribution
             (the `trace` CLI)
  aggregate  fleet-wide registry-snapshot merging (counters sum,
             gauges fan out per replica, histograms merge le-exactly)
             behind the fleet /metrics + /healthz rollup
  slo        declarative SLOs with multiwindow burn-rate alerting
             (slo_alert events, slo_burn_rate/slo_budget_remaining)
"""

from .aggregate import (
    FleetMetricsStore,
    FleetMetricsView,
    FleetSnapshot,
    healthz_rollup,
    merge_snapshots,
)
from .costs import CostLedger, extract_costs, get_ledger
from .events import (
    EventLog,
    MANIFEST_KIND,
    SCHEMA_VERSION,
    git_rev,
    load_events,
    read_events,
    utc_now,
)
from .flops import (
    chip_peak,
    chip_peak_bf16,
    dense_macs_per_example,
    device_memory_stats,
    device_peak_flops,
    mfu,
    module_macs_per_example,
    train_step_flops,
)
from .heartbeat import Heartbeat, read_heartbeats
from .profile import (
    ProfileBusyError,
    ProfileManager,
    get_profiler,
    render_capture_summary,
    summarize_capture,
)
from .recompile import RecompileTracker, get_tracker
from .registry import (
    Counter,
    DEFAULT_TIME_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    render_prometheus,
)
from .slo import SLOMonitor, SLOSpec, default_fleet_slos
from .summary import (
    decision_timeline,
    render_decision_timeline,
    render_fleet_table,
    render_table,
    summarize,
    summarize_fleet,
)
from .telemetry import StepClock, Telemetry, peak_for_default_device
from .trace import (
    TRACE_HEADER,
    TraceContext,
    Tracer,
    format_header,
    load_spans,
    mint_context,
    next_request_id,
    parse_header,
    stitch_spans,
    tail_attribution,
    to_chrome_trace,
)

__all__ = [
    "CostLedger",
    "Counter",
    "DEFAULT_TIME_BUCKETS",
    "EventLog",
    "FleetMetricsStore",
    "FleetMetricsView",
    "FleetSnapshot",
    "Gauge",
    "Heartbeat",
    "Histogram",
    "MANIFEST_KIND",
    "MetricsRegistry",
    "ProfileBusyError",
    "ProfileManager",
    "RecompileTracker",
    "SCHEMA_VERSION",
    "SLOMonitor",
    "SLOSpec",
    "StepClock",
    "TRACE_HEADER",
    "Telemetry",
    "TraceContext",
    "Tracer",
    "chip_peak",
    "chip_peak_bf16",
    "decision_timeline",
    "default_fleet_slos",
    "default_registry",
    "dense_macs_per_example",
    "device_memory_stats",
    "device_peak_flops",
    "extract_costs",
    "format_header",
    "get_ledger",
    "get_profiler",
    "get_tracker",
    "git_rev",
    "healthz_rollup",
    "load_events",
    "load_spans",
    "merge_snapshots",
    "mfu",
    "mint_context",
    "module_macs_per_example",
    "next_request_id",
    "parse_header",
    "peak_for_default_device",
    "read_events",
    "read_heartbeats",
    "render_capture_summary",
    "render_decision_timeline",
    "render_fleet_table",
    "render_prometheus",
    "render_table",
    "stitch_spans",
    "summarize",
    "summarize_capture",
    "summarize_fleet",
    "tail_attribution",
    "to_chrome_trace",
    "train_step_flops",
    "utc_now",
]
