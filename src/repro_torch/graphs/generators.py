"""Deterministic synthetic analogues of the GAP benchmark graphs.

A numpy copy of ``repro.graphs.generators``: the same ``(name, scale,
seed)`` gives the same graph in both packages.

The paper evaluates on the five GAP graphs (Table II): Kron, Urand, Road,
Twitter, Web — up to 4.2 B edges.  This container is laptop-scale, so we
generate topology-faithful synthetic stand-ins that preserve the properties
the paper's analysis hinges on:

* ``kron``    — RMAT/Kronecker, scale-free, *long-range* connections spread
  across the vertex id space (diffuse Fig-5 access matrix).
* ``urand``   — uniform random (Erdős–Rényi-ish), low diameter, no locality.
* ``road``    — 2-D grid mesh: tiny average degree, huge diameter (slow
  information transfer — the paper's explanation for Road's SSSP behaviour).
* ``twitter`` — power-law in-degree (Zipf popularity), asymmetric.
* ``web``     — block-diagonal clustered power-law: ~95 % of edges stay inside
  a contiguous vertex cluster, reproducing the diagonal-clustered access
  matrix of Fig 5 (the topology for which the paper shows delaying does NOT
  help).

All generators are deterministic in ``(name, scale, seed)``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import CSRGraph

__all__ = ["make_graph", "GRAPH_GENERATORS", "pagerank_values", "sssp_values"]


def _dedup(n: int, src: np.ndarray, dst: np.ndarray):
    keep = src != dst  # drop self loops
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    key = np.unique(key)
    return key // n, key % n


def kron(scale: int, efactor: int = 16, seed: int = 7):
    """RMAT with GAP parameters (A=.57, B=.19, C=.19)."""
    n = 1 << scale
    m = n * efactor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    a, b, c = 0.57, 0.19, 0.19
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)
        dst_bit = (((r >= a) & (r < ab)) | (r >= abc)).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    # GAP permutes vertex ids so degree is not correlated with id.
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    src, dst = _dedup(n, src, dst)
    # symmetrize (GAP kron is undirected)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    src, dst = _dedup(n, src, dst)
    return n, src, dst


def urand(scale: int, efactor: int = 16, seed: int = 11):
    n = 1 << scale
    m = n * efactor
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src, dst = _dedup(n, src, dst)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    src, dst = _dedup(n, src, dst)
    return n, src, dst


def road(scale: int, efactor: int = 0, seed: int = 0):
    """2-D grid mesh (row-major ids): degree ≤ 4, diameter 2·side."""
    side = int(np.sqrt(1 << scale))
    n = side * side
    ids = np.arange(n).reshape(side, side)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()])
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()])
    src = np.concatenate([right[0], down[0]])
    dst = np.concatenate([right[1], down[1]])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return n, src, dst


def twitter(scale: int, efactor: int = 16, seed: int = 13):
    """Asymmetric power-law: destinations drawn uniformly, sources Zipf."""
    n = 1 << scale
    m = n * efactor
    rng = np.random.default_rng(seed)
    # Zipf-ranked popularity for in-degree (celebrities get followed).
    ranks = rng.permutation(n)
    popularity = 1.0 / (1.0 + ranks.astype(np.float64))
    popularity /= popularity.sum()
    src = rng.choice(n, size=m, p=popularity)
    dst = rng.integers(0, n, m)
    src, dst = _dedup(n, src, dst)
    return n, src, dst


def web(scale: int, efactor: int = 16, seed: int = 17, locality: float = 0.95):
    """Clustered power-law: contiguous clusters, ~95 % intra-cluster edges.

    Vertex ids are laid out so clusters are contiguous — a blocked contiguous
    partition then assigns a cluster (mostly) to one worker, which reproduces
    the diagonal-dominant access matrix the paper reports for Web (Fig 5).
    """
    n = 1 << scale
    m = n * efactor
    rng = np.random.default_rng(seed)
    n_clusters = max(int(np.sqrt(n) / 4), 8)
    bounds = np.linspace(0, n, n_clusters + 1).astype(np.int64)
    sizes = np.diff(bounds)
    # pick a cluster per edge, weighted by size
    cl = rng.choice(n_clusters, size=m, p=sizes / sizes.sum())
    lo, width = bounds[cl], sizes[cl]
    u = lo + (rng.random(m) ** 2 * width).astype(np.int64)  # skewed in-cluster
    intra = rng.random(m) < locality
    v_in = lo + (rng.random(m) * width).astype(np.int64)
    v_out = rng.integers(0, n, m)
    v = np.where(intra, v_in, v_out)
    src, dst = _dedup(n, u, v)
    return n, src, dst


GRAPH_GENERATORS = {
    "kron": kron,
    "urand": urand,
    "road": road,
    "twitter": twitter,
    "web": web,
}


def pagerank_values(n: int, src: np.ndarray, damping: float = 0.85) -> np.ndarray:
    """Pull edge value for PR: damping / outdeg(src)."""
    outdeg = np.zeros(n, dtype=np.int64)
    np.add.at(outdeg, src, 1)
    return (damping / np.maximum(outdeg[src], 1)).astype(np.float32)


def sssp_values(src: np.ndarray, seed: int = 23) -> np.ndarray:
    """Positive integer weights in [1, 255], as in GAP SSSP inputs."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, size=src.shape[0]).astype(np.int32)


def make_graph(
    name: str,
    scale: int = 14,
    efactor: int = 16,
    seed: int | None = None,
    kind: str = "pagerank",
    damping: float = 0.85,
) -> CSRGraph:
    """Build a named synthetic graph with edge values for ``kind``.

    ``kind``: ``pagerank`` (values = damping/outdeg) | ``sssp`` (int weights)
    | ``unit`` (all-ones).
    """
    gen = GRAPH_GENERATORS[name]
    kwargs = {} if seed is None else {"seed": seed}
    if name == "road":
        n, src, dst = gen(scale, **kwargs)
    else:
        n, src, dst = gen(scale, efactor, **kwargs)
    if kind == "pagerank":
        values = pagerank_values(n, src, damping)
    elif kind == "sssp":
        values = sssp_values(src)
    elif kind == "unit":
        values = np.ones(src.shape[0], dtype=np.float32)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return CSRGraph.from_edges(
        n, src, dst, values, name=f"{name}-s{scale}", dedup=False
    )
