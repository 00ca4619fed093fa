"""Serving layer (DESIGN.md §8); torch rendering of ``repro.serving``:
workload-trace record/replay over the port's engine and the paper's
serving metrics (result latency, solution stability, event throughput).

The batched multi-source *state* lives in the engine
(``EngineConfig(sources=...)``, core/engine.py); this package provides the
workload side: the on-disk trace format (shared with the reference, both
ways), the deterministic replayer and the ``ServingReport`` metrics.
"""
from repro_torch.serving.metrics import (ServingReport, churn, pctile,
                                         percentiles)
from repro_torch.serving.replay import replay_trace
from repro_torch.serving.trace import (TRACE_MAGIC, TRACE_VERSION,
                                       ChunkedTraceWriter, ServingTrace,
                                       TraceFormatError, TraceReader,
                                       TraceRecorder, load_trace_or_exit,
                                       open_trace)

__all__ = [
    "ChunkedTraceWriter", "ServingReport", "ServingTrace",
    "TraceFormatError", "TraceReader", "TraceRecorder", "TRACE_MAGIC",
    "TRACE_VERSION", "churn", "load_trace_or_exit", "open_trace", "pctile",
    "percentiles", "replay_trace",
]
