"""Typed request/response surface of the continuous-batching serving tier.

A copy of ``repro.launch.service.types`` (pure Python and numpy), so the
port imports nothing of ``repro``; ``ClassPolicy.backend`` and
``QueryResult.backend`` name the port's backends (``"kernel"``,
``"torch"``), and ``UpdateRequest.batch`` is the port's
:class:`repro_torch.evolve.EdgeBatch`.

Nothing here imports the solver stack — these are the wire types a client
holds: a :class:`QueryRequest` goes in, an :class:`Admission` comes back
immediately (accepted with an id, or rejected with a reason — that is the
backpressure contract), and a :class:`QueryResult` comes out of
``drain()``/``pump()`` when the query retires from its batch.

Request *classes* decouple scheduling policy from the algorithm: a
:class:`ClassPolicy` names the δ / backend / frontier the class's lane
solves with and the scheduling quantum (``slot_rounds``) at which its lane
retires finished queries and slots in waiting ones.  ``"auto"`` routes
cheap point-lookups (PPR) to the ``"cheap"`` class and whole-graph traversals
(SSSP) to ``"deep"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Admission",
    "ClassPolicy",
    "DEFAULT_CLASSES",
    "QueryFailure",
    "QueryRequest",
    "QueryResult",
    "UpdateRequest",
    "UpdateResult",
    "default_class_for",
]


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One serving query: which algorithm, on which resident graph, from where.

    * ``algo``          — ``"sssp"`` (payload = source vertex), ``"ppr"``
      (payload = seed vertex), or the matrix-frontier algorithms ``"rwr"`` /
      ``"labelprop"`` (payload = the first landmark/anchor vertex; the
      service derives the remaining ``feature_dim - 1`` evenly spaced ones).
    * ``payload``       — the vertex id the query is parameterized by.
    * ``request_class`` — scheduling class name, or ``"auto"`` to route by
      algorithm (PPR → ``"cheap"``, SSSP → ``"deep"``).
    * ``graph``         — tenant name; the scheduler owns several resident
      :class:`~repro_torch.launch.serve_graph.GraphService` solvers in one process.
    * ``deadline_rounds`` — optional round-clock budget: if the query is
      still waiting (queued or in retry backoff) this many rounds after
      submit, it retires as a ``"deadline_exceeded"`` :class:`QueryFailure`
      instead of consuming a slot.  ``None`` = no deadline.
    """

    algo: str
    payload: int
    request_class: str = "auto"
    graph: str = "default"
    deadline_rounds: int | None = None


@dataclasses.dataclass(frozen=True)
class Admission:
    """Immediate answer to ``submit()`` — the backpressure contract.

    ``accepted=False`` always carries a ``reason`` (``"queue_full"``,
    ``"unknown_graph"``, ``"unsupported_algo"``, ``"unknown_class"``,
    ``"payload_out_of_range"``, ``"quota_exceeded"``, ``"lane_open"`` —
    the lane's circuit breaker is cooling down after repeated faults);
    rejection is deterministic in the submit sequence, never a timing
    accident.
    """

    accepted: bool
    request_id: str | None = None
    reason: str | None = None
    queue_depth: int = 0


@dataclasses.dataclass
class QueryResult:
    """One retired query: the answer plus its scheduling history.

    Clock fields are in *rounds* (the scheduler's deterministic virtual
    time); ``latency_s`` is the wall-clock from submit to retirement.
    ``converged=False`` means the round budget ran out — the state is the
    best iterate, flagged, never silently wrong.
    """

    request_id: str
    algo: str
    graph: str
    request_class: str
    payload: int  # the vertex the query was parameterized by
    x: np.ndarray  # (n,) — or (n, F) for matrix algos — frozen at convergence
    rounds: int  # rounds to first convergence (this query alone)
    converged: bool
    residual: float
    delta: int  # δ its lane solved with (class policy applied)
    backend: str  # "kernel" or "torch"
    admit_seq: int  # global admission order (FIFO audit)
    submitted_clock: int  # scheduler clock (rounds) at submit
    admitted_clock: int  # ... at slot-in
    finished_clock: int  # ... at retirement
    latency_s: float = 0.0

    @property
    def queue_rounds(self) -> int:
        """Rounds spent waiting in the admission queue."""
        return self.admitted_clock - self.submitted_clock

    @property
    def service_rounds(self) -> int:
        """Rounds from slot-in to retirement (includes quantum granularity)."""
        return self.finished_clock - self.admitted_clock


@dataclasses.dataclass
class QueryFailure:
    """One admitted query that could **not** be answered — a typed tombstone.

    The no-silent-loss contract: every accepted request retires as exactly
    one :class:`QueryResult` or one :class:`QueryFailure` (collected via
    ``ContinuousScheduler.take_failures()``).  ``reason`` is
    ``"deadline_exceeded"`` (the request's round-clock deadline passed while
    it waited) or ``"retries_exhausted"`` (its lane faulted more than the
    class policy's ``max_retries`` while it was slotted in).
    """

    request_id: str
    algo: str
    graph: str
    request_class: str
    payload: int
    reason: str
    attempts: int  # faulted lane quanta this request was slotted into
    submitted_clock: int  # scheduler clock (rounds) at submit
    failed_clock: int  # ... at retirement-as-failure
    latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class UpdateRequest:
    """One edge-update batch against a resident graph.

    ``batch`` is an :class:`repro_torch.evolve.EdgeBatch` (typed loosely
    here so the wire types stay import-light).  Updates share the admission
    contract with queries — ``submit_update()`` answers immediately with an
    :class:`Admission` (``"unknown_graph"``, ``"payload_out_of_range"``,
    ``"quota_exceeded"`` are the typed rejections) — but travel a separate
    per-graph queue and apply only at a round boundary where the graph's
    lanes are quiescent, so every in-flight query retires against the
    snapshot it was admitted on.
    """

    batch: object
    graph: str = "default"


@dataclasses.dataclass
class UpdateResult:
    """One applied update batch: what changed and when (round clock).

    ``barrier_rounds`` is the deterministic wait between submission and
    application — the rounds the scheduler spent retiring in-flight queries
    on the pre-update snapshot before the graph quiesced.
    """

    request_id: str
    graph: str
    inserted: int
    deleted: int
    reweighted: int
    affected_rows: int  # destination rows whose in-edge lists changed
    submitted_clock: int  # scheduler clock (rounds) at submit_update()
    applied_clock: int  # ... at application (round boundary, lanes quiesced)
    latency_s: float = 0.0

    @property
    def barrier_rounds(self) -> int:
        """Rounds spent waiting for the graph's lanes to quiesce."""
        return self.applied_clock - self.submitted_clock


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """How one request class is solved and scheduled.

    ``delta`` / ``backend`` / ``frontier`` default to the owning service's
    construction values (``None`` = inherit); ``backend`` is one of the
    port's (``"kernel"``: one launch of K1's loop entry a lane quantum on a
    CUDA device; ``"torch"``: the plain loop); ``slot_rounds`` is the lane's
    scheduling quantum — how many rounds run between retire/slot-in
    boundaries.  Small quanta give admission latency and fast retirement at
    the cost of more host sync points; large quanta amortize.

    Fault handling (see the scheduler's retry loop): a lane quantum that
    raises evicts the lane's riders back to the queue head; each rider
    retries up to ``max_retries`` times, waiting
    ``backoff_rounds * 2**(attempt-1)`` rounds of virtual time before
    re-admission, then fails typed (``"retries_exhausted"``).
    ``breaker_threshold`` *consecutive* faulted quanta open the lane's
    circuit breaker: new submits are rejected (``"lane_open"``) for
    ``breaker_cooldown_rounds``, after which the lane half-opens and one
    successful quantum closes it again.
    """

    name: str
    delta: object = None
    backend: str | None = None
    frontier: str | None = None
    slot_rounds: int = 4
    max_rounds: int | None = None
    max_retries: int = 2
    backoff_rounds: int = 2
    breaker_threshold: int = 3
    breaker_cooldown_rounds: int = 32

    def __post_init__(self):
        if self.slot_rounds < 1:
            raise ValueError(f"slot_rounds must be >= 1, got {self.slot_rounds}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_rounds < 0:
            raise ValueError(f"backoff_rounds must be >= 0, got {self.backoff_rounds}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}"
            )
        if self.breaker_cooldown_rounds < 0:
            raise ValueError(
                "breaker_cooldown_rounds must be >= 0, "
                f"got {self.breaker_cooldown_rounds}"
            )


#: Default classes: interactive point lookups vs whole-graph traversals.
#: Both inherit the service's δ/backend; they differ in scheduling quantum —
#: the cheap lane retires (and admits) twice as often as the deep lane.
DEFAULT_CLASSES: dict[str, ClassPolicy] = {
    "cheap": ClassPolicy(name="cheap", slot_rounds=2),
    "deep": ClassPolicy(name="deep", slot_rounds=8),
}

_AUTO_CLASS = {"ppr": "cheap", "rwr": "cheap", "sssp": "deep", "labelprop": "deep"}


def default_class_for(algo: str) -> str:
    """The class ``request_class="auto"`` resolves to for ``algo``."""
    return _AUTO_CLASS.get(algo, "deep")
