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
