"""Workload / cluster trace generators (paper Appendix H) (port of ``src/repro/traces/__init__.py``)."""
from repro_torch.traces.workload import (  # noqa: F401
    Trace,
    TimestampObservation,
    agentic_traces,
    elastic_cluster_traces,
    motivation_trace_left,
    motivation_trace_right,
    sharegpt_longbench_traces,
    stable_workload_trace,
    volatile_workload_trace,
)
