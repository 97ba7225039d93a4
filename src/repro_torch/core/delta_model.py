"""Analytic δ-selector (beyond paper — their stated future work).

A numpy copy of ``repro.core.delta_model``: ``delta="auto"`` picks the same
δ* as the reference from the same probe round counts.  The cost constants are
still the reference's TPU ones (an H100 cost model is later work).

The paper shows the best δ depends on platform, topology, and algorithm, and
leaves "what buffer size to use" open.  On TPU the commit cost is *explicit*
(a collective), so we can model the total time directly:

    T(δ) = rounds(δ) · [ compute_round + flushes(δ) · (α + P·δ·bytes / β) ]

with α the collective latency, β the ICI bandwidth, flushes(δ) = ⌈B/δ⌉.
``rounds(δ)`` is interpolated from two cheap probes (sync and finest-δ runs on
a sampled subgraph) with the freshness model

    rounds(δ) ≈ r_async + (r_sync − r_async) · log(δ/δ_min) / log(B/δ_min)

(log because information freshness scales with the *number of commit
horizons* per round, which is geometric in δ).  The selector also consumes the
Fig-5 locality fraction: when the access matrix is diagonal-dominant the
freshness term is discounted (delaying can't relieve contention the topology
never creates — paper §IV-C).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.access_matrix import access_matrix, locality_fraction
from repro_torch.graphs.formats import CSRGraph
from repro_torch.graphs.partition import balanced_blocks

__all__ = [
    "DeltaModel",
    "fit_delta_model",
    "refit_delta_model",
    "refit_delta_models",
    "TPUCostParams",
]


@dataclasses.dataclass(frozen=True)
class TPUCostParams:
    """Per-chip TPU v5e constants (same as benchmarks/roofline.py)."""

    peak_flops: float = 197e12  # bf16 FLOP/s
    hbm_bw: float = 819e9  # B/s
    ici_bw: float = 50e9  # B/s per link
    collective_latency_s: float = 1e-6  # α per commit


@dataclasses.dataclass(frozen=True)
class DeltaModel:
    P: int
    B: int  # max block size (elements)
    delta_min: int
    r_sync: int
    r_async: int
    locality: float
    edges: int
    bytes_per_elem: int
    hw: TPUCostParams

    def rounds(self, delta: int) -> float:
        # Exactly the linear-in-(r_sync, r_async) form that
        # refit_delta_model's least squares inverts — any change to the
        # interpolation must go through _freshness_weight or the refit
        # silently fits a different curve than best_delta evaluates.
        w = self._freshness_weight(delta)
        return float(self.r_sync) * (1.0 - w) + float(self.r_async) * w

    def round_cost_s(self, delta: int) -> float:
        hw = self.hw
        compute = 2.0 * self.edges / self.P / hw.peak_flops  # ⊕/⊗ per edge
        mem_bytes = (2 * self.edges + 2 * self.P * self.B) * self.bytes_per_elem
        memory = mem_bytes / self.P / hw.hbm_bw
        flushes = -(-self.B // delta)
        commit = flushes * (
            hw.collective_latency_s + self.P * delta * self.bytes_per_elem / hw.ici_bw
        )
        return compute + memory + commit

    def total_time_s(self, delta: int) -> float:
        return self.rounds(delta) * self.round_cost_s(delta)

    def best_delta(self, grid=None) -> int:
        if grid is None:
            grid = [2**k for k in range(4, 16)]
        grid = [int(min(d, self.B)) for d in grid if d >= self.delta_min] or [self.B]
        return int(min(grid, key=self.total_time_s))

    # ------------------------------------------------------------------ #
    # a JSON-safe dict, as the reference's persist layer stores it
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "P": int(self.P),
            "B": int(self.B),
            "delta_min": int(self.delta_min),
            "r_sync": float(self.r_sync),
            "r_async": float(self.r_async),
            "locality": float(self.locality),
            "edges": int(self.edges),
            "bytes_per_elem": int(self.bytes_per_elem),
            "hw": dataclasses.asdict(self.hw),
        }

    def _freshness_weight(self, delta: int) -> float:
        """w(δ) with rounds(δ) = r_sync·(1 − w) + r_async·w (linear form).

        Diagonal-clustered topologies get little freshness benefit from
        remote commits (paper Fig 5) — ``locality`` discounts the async gain.
        """
        if self.B <= self.delta_min:
            return 0.0
        frac = np.log(max(delta, self.delta_min) / self.delta_min) / np.log(
            self.B / self.delta_min
        )
        frac = float(np.clip(frac, 0.0, 1.0))
        return (1.0 - self.locality) * (1.0 - frac)


def fit_delta_model(
    graph: CSRGraph,
    P: int,
    r_sync: int,
    r_async: int,
    delta_min: int = 128,
    bytes_per_elem: int = 4,
    hw: TPUCostParams | None = None,
) -> DeltaModel:
    """Fit the model from two measured probes (sync & async round counts)."""
    bounds = balanced_blocks(graph, P)
    B = int(np.diff(bounds).max())
    loc = locality_fraction(access_matrix(graph, bounds))
    return DeltaModel(
        P=P,
        B=B,
        delta_min=min(delta_min, B),
        r_sync=r_sync,
        r_async=r_async,
        locality=loc,
        edges=graph.nnz,
        bytes_per_elem=bytes_per_elem,
        hw=hw or TPUCostParams(),
    )


def refit_delta_model(model: DeltaModel, observations) -> DeltaModel:
    """Re-fit ``(r_sync, r_async)`` from production-observed ``(δ, rounds)``.

    The freshness model is *linear* in its two round counts:
    ``rounds(δ) = r_sync·(1 − w) + r_async·w`` with
    ``w(δ) = (1 − locality)·(1 − frac(δ))`` — so observations accumulated from
    real :class:`~repro_torch.core.engine.EngineResult` runs refit by least squares,
    no re-probing solves required.  The current model's own predictions at the
    two anchor points (δ_min and B) join as prior pseudo-observations, keeping
    the fit well-posed from a single observed δ and the migration smooth
    (new data *pulls* the curve rather than replacing it).

    ``observations`` is an iterable of ``(delta, rounds)`` pairs; non-positive
    round counts are discarded.  Returns a new model (the input is frozen);
    topology-derived fields (locality, B, cost params) are unchanged — only
    the round-count curve moves.
    """
    obs = [(int(d), float(r)) for d, r in observations if r > 0]
    anchors = [
        (model.delta_min, model.rounds(model.delta_min)),
        (model.B, model.rounds(model.B)),
    ]
    pts = obs + anchors
    w = np.array([model._freshness_weight(d) for d, _ in pts])
    design = np.stack([1.0 - w, w], axis=1)
    target = np.array([r for _, r in pts])
    (r_sync, r_async), *_ = np.linalg.lstsq(design, target, rcond=None)
    return dataclasses.replace(
        model, r_sync=max(float(r_sync), 1.0), r_async=max(float(r_async), 1.0)
    )


def refit_delta_models(model: DeltaModel, rows) -> dict:
    """Per-regime refits from tagged observation rows.

    ``rows`` are observation dicts, each carrying ``delta``, ``rounds`` and
    ``regime`` (the rows the reference's persistent store logs).  Incremental
    warm restarts converge in far fewer rounds than cold solves at the same δ,
    so one pooled fit would drag the cold curve down and push the incremental
    curve up; instead each regime refits independently, seeded from the same
    base ``model`` (whose anchors keep a sparsely observed regime well-posed).
    Returns ``{regime: refitted_model}`` — only regimes with ≥ 1 usable
    observation appear.
    """
    by_regime: dict[str, list] = {}
    for row in rows:
        by_regime.setdefault(row.get("regime", "cold"), []).append(
            (row["delta"], row["rounds"])
        )
    return {
        regime: refit_delta_model(model, pairs)
        for regime, pairs in by_regime.items()
        if any(r > 0 for _, r in pairs)
    }
