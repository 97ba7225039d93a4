# The port's continuous-batching serving tier (of repro.launch.service):
# typed request/response API (types.py), admission queue + lanes over
# BatchStepper (scheduler.py), and the open-loop Poisson load generator /
# trace replay harness (loadgen.py).
# GraphService (repro_torch.launch.serve_graph) is the per-graph facade; a
# ContinuousScheduler serves several of them in one process.
from repro_torch.launch.service.types import (
    DEFAULT_CLASSES,
    Admission,
    ClassPolicy,
    QueryFailure,
    QueryRequest,
    QueryResult,
    UpdateRequest,
    UpdateResult,
    default_class_for,
)
from repro_torch.launch.service.scheduler import AdmissionQueue, ContinuousScheduler
from repro_torch.launch.service.loadgen import (
    Trace,
    TraceEvent,
    load_traces,
    poisson_trace,
    replay_continuous,
    replay_fixed,
    save_traces,
    summarize,
)

__all__ = [
    "Admission",
    "AdmissionQueue",
    "ClassPolicy",
    "ContinuousScheduler",
    "DEFAULT_CLASSES",
    "QueryFailure",
    "QueryRequest",
    "QueryResult",
    "Trace",
    "TraceEvent",
    "UpdateRequest",
    "UpdateResult",
    "default_class_for",
    "load_traces",
    "poisson_trace",
    "replay_continuous",
    "replay_fixed",
    "save_traces",
    "summarize",
]
