from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .debug import assert_finite_pytree, nan_check
from .logging import MetricsLogger
from .profiling import counters, graph_counts, span, spans, trace_context, write_spans

__all__ = ["latest_checkpoint", "load_checkpoint", "save_checkpoint", "MetricsLogger", "nan_check",
           "assert_finite_pytree", "trace_context", "span", "spans", "counters", "graph_counts", "write_spans"]
