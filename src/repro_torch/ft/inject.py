"""Typed, deterministic chaos injection — one harness for every fault site.

A copy of ``repro.ft.inject`` (pure Python), so the port imports nothing of
``repro``.  The port wires the ``persist.write`` and ``persist.read`` sites
(:mod:`repro_torch.persist.store`); the other sites below are the
reference's and come with the port's serving and fault-tolerance modules.

A :class:`FaultPlan` is a list of :class:`FaultSpec` rules evaluated at
instrumented *sites* across the stack.  Sites call :func:`fire` with a site
name and context kwargs; when no plan is active the call is a near-free
no-op (one global read), so production paths carry the hooks permanently.

Instrumented site classes (context keys in parentheses):

==================  =========================================================
``solver.round``    engine host loop / checkpointed solve, once per round
                    boundary (``round`` — rounds already executed, 0-based)
``kernel.dispatch`` ``Solver`` backend dispatch and ``BatchStepper.run``
                    (``backend``, ``frontier``)
``persist.write``   persist-store atomic writes (``key``); I/O kinds
                    ``torn`` / ``corrupt`` / ``eio`` emulate partial, flipped
                    and failed writes
``persist.read``    persist-store loads (``key``)
``ckpt.write``      checkpoint commit (``step``); ``torn`` kills the writer
                    before the ``_COMMITTED`` marker lands
``scheduler.lane``  ``ContinuousScheduler.pump`` per lane quantum
                    (``graph``, ``algo``, ``request_class``)
``train.step``      ``run_training`` step boundary (``step``)
==================  =========================================================

Determinism: specs fire by *visit count* (``at`` / ``every``) or by a seeded
per-visit coin (``p``); both are pure functions of the call sequence, so a
replayed run fires identically.  Every fire is appended to ``plan.events``
— the chaos trace — and plans round-trip through JSON so traces can be
committed (``benchmarks/traces/chaos_smoke.json``).

Faults manifest two ways: ``kind="error"`` raises :class:`InjectedFault`
(a ``RuntimeError`` — recovery machinery must not special-case it), while
the I/O kinds are *returned* to the site, which emulates the corruption
itself (a torn write really leaves truncated bytes on disk).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "active_plan",
    "fire",
    "inject",
]

#: Fault kinds a spec may carry.  "error" raises; the rest are returned to
#: the site for it to emulate (only meaningful at I/O sites).
KINDS = ("error", "torn", "corrupt", "eio")


class InjectedFault(RuntimeError):
    """Raised by a firing ``kind="error"`` spec.

    Subclasses ``RuntimeError`` deliberately: recovery paths (degradation
    ladder, scheduler retry, runner restart) handle it through the same
    ``except Exception`` arms a real kernel/node fault would take.
    """

    def __init__(self, site: str, kind: str = "error", detail: str = ""):
        self.site = site
        self.kind = kind
        msg = f"injected {kind} fault at {site}"
        super().__init__(msg + (f" ({detail})" if detail else ""))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: *where* (site + match) and *when* (at/every/p).

    ``at``     fire on the ``at``-th matching visit (0-based) and the next
               ``times - 1`` matching visits after it.
    ``every``  fire on every ``every``-th matching visit (1-based phase:
               visits ``every-1``, ``2*every-1``, ...), still capped by
               ``times`` unless ``times < 0`` (unlimited).
    ``p``      seeded per-visit probability; combined with the plan seed and
               the spec index so two specs never share a coin stream.
    ``match``  equality filters on the site's context kwargs; a context key
               absent from the call never matches.
    """

    site: str
    kind: str = "error"
    at: int | None = None
    every: int | None = None
    p: float = 0.0
    times: int = 1
    match: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.at is None and self.every is None and self.p == 0.0:
            # bare spec: fire on the first matching visit
            object.__setattr__(self, "at", 0)

    def to_dict(self) -> dict:
        out = {"site": self.site, "kind": self.kind, "times": self.times}
        if self.at is not None:
            out["at"] = self.at
        if self.every is not None:
            out["every"] = self.every
        if self.p:
            out["p"] = self.p
        if self.match:
            out["match"] = dict(self.match)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(
            site=d["site"],
            kind=d.get("kind", "error"),
            at=d.get("at"),
            every=d.get("every"),
            p=float(d.get("p", 0.0)),
            times=int(d.get("times", 1)),
            match=dict(d.get("match", {})),
        )


class _SpecState:
    __slots__ = ("visits", "fires", "rng")

    def __init__(self, seed: int):
        self.visits = 0
        self.fires = 0
        self.rng = random.Random(seed)


class FaultPlan:
    """An ordered set of fault specs with deterministic per-spec counters.

    ``fire(site, **ctx)`` counts the visit on *every* matching spec, then
    fires the first spec that is due: ``kind="error"`` raises
    :class:`InjectedFault`, I/O kinds are returned as a string (``None``
    means no fault).  Thread-safe; counters are plan-local, so a fresh plan
    replays a committed trace from zero.
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs = [
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s) for s in specs
        ]
        self.seed = int(seed)
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._state = [
            _SpecState(hash((self.seed, i)) & 0x7FFFFFFF)
            for i in range(len(self.specs))
        ]

    def fire(self, site: str, **ctx):
        due = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if any(ctx.get(k, _MISS) != v for k, v in spec.match.items()):
                    continue
                st = self._state[i]
                visit = st.visits
                st.visits += 1
                if due is not None:
                    continue  # keep counting visits on later specs
                if spec.times >= 0 and st.fires >= spec.times:
                    continue
                hit = False
                if spec.at is not None:
                    hit = visit >= spec.at
                elif spec.every is not None:
                    hit = (visit + 1) % spec.every == 0
                if spec.p > 0.0 and not hit:
                    hit = st.rng.random() < spec.p
                if hit:
                    st.fires += 1
                    due = (i, spec, visit)
            if due is not None:
                i, spec, visit = due
                self.events.append(
                    {
                        "site": site,
                        "kind": spec.kind,
                        "spec": i,
                        "visit": visit,
                        **{
                            k: v
                            for k, v in ctx.items()
                            if isinstance(v, (str, int, float, bool))
                        },
                    }
                )
        if due is None:
            return None
        _, spec, _ = due
        detail = ", ".join(f"{k}={v!r}" for k, v in sorted(ctx.items()))
        if spec.kind == "error":
            raise InjectedFault(site, spec.kind, detail)
        return spec.kind

    @property
    def fired(self) -> int:
        return len(self.events)

    def sites_fired(self) -> list[str]:
        return sorted({e["site"] for e in self.events})

    def to_json(self) -> dict:
        return {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]}

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls(d.get("specs", ()), seed=int(d.get("seed", 0)))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "FaultPlan":
        return cls.from_json(json.loads(s))


_MISS = object()
_ACTIVE: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def fire(site: str, **ctx):
    """Site hook: evaluate the active plan (no-op when none is installed)."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, **ctx)


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` as the active plan for the dynamic extent."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev
