# repro_torch.launch: the serving tier of the port (repro.launch's
# serve_graph and service; the LM launchers are not ported).  Only the
# dependency-light wire types import eagerly — GraphService and
# ContinuousScheduler resolve lazily so `import repro_torch.launch` stays
# cheap and cycle-free.
from repro_torch.launch.service.types import (
    Admission,
    ClassPolicy,
    QueryRequest,
    QueryResult,
)

__all__ = [
    "Admission",
    "ClassPolicy",
    "ContinuousScheduler",
    "GraphService",
    "QueryRequest",
    "QueryResult",
]

_LAZY = {
    "GraphService": ("repro_torch.launch.serve_graph", "GraphService"),
    "ContinuousScheduler": ("repro_torch.launch.service.scheduler", "ContinuousScheduler"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module 'repro_torch.launch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(entry[0]), entry[1])
