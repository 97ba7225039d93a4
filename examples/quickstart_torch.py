"""Quickstart on the PyTorch/CUDA port: the paper's three disciplines, auto-δ,
a matrix frontier and one evolving-graph step.

Runs PageRank on a synthetic scale-free graph under synchronous (Jacobi),
asynchronous (finest-δ block Gauss–Seidel) and delayed-asynchronous (hybrid
δ) schedules through the wrappers of ``repro_torch.algorithms``, lets
``delta="auto"`` pick δ* from the analytic cost model, and shows a warm
``Solver`` replaying a cached schedule.  A second act runs an (n, F) matrix
frontier (F-class label propagation) through the same engine.  A third
mutates an SSSP graph: ``solve``, then ``resolve(updates=batch)`` (which
applies the batch with ``apply_updates``, patching the cached schedule in
place, and warm-starts from the previous distances), against a cold twin
that applies the same batch and solves from scratch.

Every solve runs on the CUDA card (one launch of the fused loop kernel a
solve) unless ``--device cpu`` asks for the plain PyTorch rounds.

    PYTHONPATH=src python examples/quickstart_torch.py [--scale 13] [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.algorithms import pagerank, sssp
from repro_torch.evolve import EdgeBatch
from repro_torch.graphs.generators import make_graph
from repro_torch.solve import (
    Solver,
    default_landmarks,
    label_propagation_problem,
    pagerank_problem,
    sssp_problem,
)


def _mixed_batch(g, k, rng) -> EdgeBatch:
    """k/2 deletes, k/4 reweights and the rest inserts, weights in [1, 255]."""
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    src = g.indices.astype(np.int64)
    n_del, n_rw = k // 2, k // 4
    pick = rng.choice(g.nnz, size=n_del + n_rw, replace=False)
    keys = set((dst * g.n + src).tolist())
    inserts = []
    while len(inserts) < k - n_del - n_rw:
        s, d = (int(v) for v in rng.integers(0, g.n, size=2))
        if s != d and d * g.n + s not in keys:
            keys.add(d * g.n + s)
            inserts.append((s, d, int(rng.integers(1, 256))))
    return EdgeBatch.from_ops(
        inserts=inserts,
        deletes=[(int(src[e]), int(dst[e])) for e in pick[:n_del]],
        reweights=[(int(src[e]), int(dst[e]), int(rng.integers(1, 256))) for e in pick[n_del:]],
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--device", default=None, help="cpu runs the plain rounds (default: the CUDA card)")
    args = ap.parse_args(argv)
    common = dict(P=args.workers, min_chunk=16, device=args.device)

    g = make_graph("twitter", scale=args.scale, efactor=8, kind="pagerank")
    print(f"graph: {g.stats()}\n")
    print(
        f"{'schedule':14s} {'δ':>6s} {'rounds':>7s} {'flushes':>8s} "
        f"{'flush MiB':>10s} {'total s':>9s}"
    )
    results = {}
    for label, delta in [
        ("sync", "sync"),
        ("delayed", 1024),
        ("delayed", 256),
        ("async", "async"),
        ("auto", "auto"),  # probes sync/async round counts, asks the cost model for δ*
    ]:
        r = pagerank(g, delta=delta, **common)
        results[f"{label}{delta}"] = r
        print(
            f"{label:14s} {r.delta:6d} {r.rounds:7d} {r.flushes:8d} "
            f"{r.flush_bytes / 2**20:10.2f} {r.total_time_s:9.4f}"
        )

    # all schedules converge to the same fixed point
    xs = [r.x for r in results.values()]
    drift = max(np.abs(a - xs[0]).max() for a in xs[1:])
    print(f"\nmax fixed-point drift across schedules: {drift:.2e}")

    # warm cache: a second query on the same (graph, problem, δ) builds no
    # schedule — this is what serving-scale batching rides on.
    solver = Solver(g, pagerank_problem(), n_workers=args.workers, min_chunk=16, device=args.device)
    solver.solve(delta=256)
    builds = solver.stats["schedule_builds"]
    r2 = solver.solve(delta=256)
    assert solver.stats["schedule_builds"] == builds
    print(f"warm replay at δ=256: {r2.total_time_s:.4f} s (schedule builds {builds} — unchanged)")
    print(
        "async converges in fewer rounds; delayed-δ keeps most of that while "
        "cutting flushes by the buffer factor — the paper's hybrid."
    )

    # --- matrix frontier: F classes propagate in ONE solve -----------------
    F = 4
    gw = make_graph("web", scale=args.scale, efactor=8, kind="pagerank")
    lp = Solver(
        gw,
        label_propagation_problem(feature_dim=F),
        n_workers=args.workers,
        min_chunk=16,
        device=args.device,
    )
    r_lp = lp.solve(delta=256)
    labels = np.asarray(r_lp.x)  # (n, F) soft label distributions
    hard = labels.argmax(axis=1)
    anchors = default_landmarks(gw.n, F)
    assert np.array_equal(hard[anchors], np.arange(F)), "anchors must keep labels"
    share = np.bincount(hard, minlength=F) / gw.n
    print(
        f"\nlabelprop (n, {F}) matrix frontier at δ=256: "
        f"{r_lp.rounds} rounds, converged={r_lp.converged}"
    )
    shares = "  ".join(f"{k}:{share[k]:.2f}" for k in range(F))
    print(f"class shares: {shares} — one matrix solve instead of {F} vector solves.")

    # --- evolving graph: solve → apply_updates → resolve ---------------------
    gs = make_graph("kron", scale=args.scale, efactor=8, kind="sssp")
    source = int(np.argmax(gs.out_degree))
    kw = dict(n_workers=args.workers, delta=256, min_chunk=16, device=args.device)
    inc = Solver(gs, sssp_problem(source=source), **kw)
    cold = Solver(gs, sssp_problem(source=source), **kw)
    r0 = inc.solve()
    batch = _mixed_batch(gs, 16, np.random.default_rng(0))
    report = cold.apply_updates(batch)  # the counterfactual: patch, then solve from scratch
    rc = cold.solve()
    builds = inc.stats["schedule_builds"]
    ri = inc.resolve(updates=batch)  # apply the same batch, repair the old distances, re-solve
    assert np.array_equal(ri.x, rc.x), "resolve must equal a cold solve on the mutated graph"
    check = sssp(inc.graph, source=source, delta=256, **common)
    assert np.array_equal(ri.x, check.x)
    print(
        f"\nsssp from {source}: cold solve {r0.rounds} rounds; batch of {batch.size} edge ops "
        f"touched {report.affected_rows.size} rows; resolve {ri.rounds} rounds against "
        f"{rc.rounds} cold, same distances; schedule builds "
        f"{inc.stats['schedule_builds'] - builds} (patched in place)"
    )


if __name__ == "__main__":
    main()
