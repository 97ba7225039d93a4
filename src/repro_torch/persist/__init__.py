# Persistent warm-start caches (counterpart of repro.persist): content-
# addressed on-disk storage for everything a Solver otherwise recomputes per
# process — stripe schedules, frontier halo plans and the fitted δ-model —
# plus the production (δ, rounds, time) observation log that online δ
# re-probing refits from.  See persist/keys.py for what makes an entry safe.
from repro_torch.persist.keys import (
    CACHE_FORMAT,
    env_fingerprint,
    epilogue_digest,
    graph_fingerprint,
    plan_shard_fingerprint,
    problem_fingerprint,
    solver_namespace,
    stripe_fingerprint,
)
from repro_torch.persist.store import SolverCache

__all__ = [
    "CACHE_FORMAT",
    "SolverCache",
    "env_fingerprint",
    "epilogue_digest",
    "graph_fingerprint",
    "plan_shard_fingerprint",
    "problem_fingerprint",
    "solver_namespace",
    "stripe_fingerprint",
]
