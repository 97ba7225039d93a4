"""One rank of the port's replicated and batched solves across processes, for
``test_torch_dist_replicated.py``.

Run as ``python tests/torch_dist_replicated_ranks.py --rank R --world 4
--init file:///path/store --out DIR`` in four processes
(``PYTHONPATH=src``): the ranks join one ``gloo`` group and run every case on
the CPU at each width of :data:`WIDTHS` (a width W on the subgroup of ranks
``[0, W)``): the reference's width-invariance cases of
``tests/test_frontier_sharded.py`` (:data:`PROBLEMS` at δ = 48 on the
replicated frontier, whole solves and three rounds; ppr's query on both
frontiers; the batches of ``TestShardedBatch`` on both frontiers, with
compaction and an open batch), ``delta="auto"``, the refusal that still
stands and the paths lifted since (a store, ``apply_updates`` and
``resolve``, with the batches of :func:`update_ops`).  Each rank writes its results to ``DIR/rank<R>.npz``.  It
imports ``torch`` and ``repro_torch`` only; the test holds the results to
``repro``.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np

P = 8
SHARDS = 4  # D of the halo cases: every width divides it
WIDTHS = (1, 2, 4)
PROBLEMS = ("cc", "jacobi", "pagerank", "sssp")
PARITY_DELTA, PARITY_MIN_CHUNK = 48, 16
ROUNDS = 3
PPR_DELTA, PPR_SEED = 64, 5
BATCH_DELTA, BATCH_MIN_CHUNK, BATCH_SOURCES = 32, 8, (0, 7, 33)
PPR_BATCH_SEEDS = (3, 11)
COMPACT_EVERY = 4  # the ppr batch's queries converge at rounds 26 and 29
STEPPER_CAPACITY, STEPPER_QUANTUM, STEPPER_SOURCES = 2, 2, (0, 7, 33, 90)


def jacobi_case_inputs():
    """The reference test's diagonally dominant system (``_jacobi_case``)."""
    rng = np.random.default_rng(0)
    n = 256
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(1, n, rows.shape[0])) % n
    vals = rng.normal(size=rows.shape[0]).astype(np.float32) * 0.1
    diag = np.full(n, 4.0, np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return n, rows, cols, vals, diag, b


def graph_spec(name):
    """``(generator, scale, kind)`` of the reference test's graphs."""
    return {"pr": ("twitter", 9, "pagerank"), "s": ("kron", 8, "sssp"), "u": ("road", 8, "unit")}[name]


def make_graphs(make_graph):
    """The reference test's three graphs through a package's ``make_graph``."""
    out = {}
    for k in ("pr", "s", "u"):
        gen, scale, kind = graph_spec(k)
        kw = {} if gen == "road" else {"efactor": 8}
        out[k] = make_graph(gen, scale=scale, kind=kind, **kw)
    return out


def port_case(name, graphs):
    """The port's ``(graph, problem)`` of a parity case."""
    from repro_torch import solve
    from repro_torch.algorithms.jacobi import jacobi_graph

    if name == "jacobi":
        n, rows, cols, vals, diag, b = jacobi_case_inputs()
        return jacobi_graph(n, rows, cols, vals, diag), solve.jacobi_problem(diag, b)
    return {
        "pagerank": (graphs["pr"], solve.pagerank_problem()),
        "sssp": (graphs["s"], solve.sssp_problem()),
        "cc": (graphs["u"], solve.cc_problem()),
    }[name]


def update_ops(g, seed=26) -> list:
    """Two batches (op lists for ``EdgeBatch.from_ops``), drawn from ``g``
    alone and disjoint, so the second still applies after the first: four
    existing edges deleted and four fresh ones inserted (weights in [1,
    255]) each."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dels = [(int(g.indices[e]), int(dst[e])) for e in rng.choice(g.nnz, size=8, replace=False)]
    present = set((dst * g.n + g.indices).tolist())
    fresh = []
    while len(fresh) < 8:
        s, d = (int(v) for v in rng.integers(0, g.n, size=2))
        if s != d and d * g.n + s not in present:
            present.add(d * g.n + s)
            fresh.append((s, d, int(rng.integers(1, 256))))
    return [{"inserts": fresh[i:i + 4], "deletes": dels[i:i + 4]} for i in (0, 4)]


def key(*parts) -> str:
    return "/".join(str(p) for p in parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.core import engine
    from repro_torch.dist import engine_sharded
    from repro_torch.evolve import EdgeBatch
    from repro_torch.solve import (
        BatchStepper,
        Solver,
        multi_source_x0,
        pagerank_problem,
        ppr_problem,
        ppr_teleport,
        sssp_problem,
    )

    dist.init_process_group(
        "gloo", init_method=a.init, rank=a.rank, world_size=a.world,
        timeout=datetime.timedelta(seconds=120),
    )
    groups = {w: dist.new_group(list(range(w))) for w in WIDTHS}
    from repro_torch.graphs.generators import make_graph

    graphs = make_graphs(make_graph)
    out: dict = {}

    def batch_out(tag, b):
        out[key(tag, "x")] = b.x
        out[key(tag, "rpq")] = b.rounds_per_query
        out[key(tag, "counts")] = np.array([b.rounds, b.flushes, b.flush_bytes, b.compactions])
        out[key(tag, "converged")] = b.converged

    for W in WIDTHS:
        if a.rank >= W:
            continue
        grp = groups[W]
        for name in PROBLEMS:
            g, prob = port_case(name, graphs)
            sv = Solver(g, prob, n_workers=P, delta=PARITY_DELTA, min_chunk=PARITY_MIN_CHUNK, device="cpu", group=grp)
            r = sv.solve()
            tag = key("parity", W, name)
            out[key(tag, "x")] = r.x
            out[key(tag, "counts")] = np.array([r.rounds, r.converged, r.flushes, r.flush_bytes, r.delta, r.P])
            out[key(tag, "residuals")] = np.asarray(r.residuals, np.float64)
            sched, _ = sv.rank_layout()
            out[key(tag, "cells")] = np.array([sched.w0, sched.w1, *sched.src.shape])
            ep = sv.row_update()
            rnd = engine_sharded.replicated_rank_round_fn(sched, sched.rows_all, prob.semiring, ep, sv.group)
            x = engine.extend_frontier(prob.x0(g), prob.semiring, "cpu")
            for i in range(ROUNDS):
                x = rnd(x)
                out[key(tag, "round", i)] = x[:-1].numpy()

        # ppr's query on both frontiers
        sv = Solver(graphs["pr"], ppr_problem(), n_workers=P, delta=PPR_DELTA, min_chunk=PARITY_MIN_CHUNK,
                    n_shards=SHARDS, device="cpu", group=grp)
        q = ppr_teleport(graphs["pr"], [PPR_SEED])[0]
        for frontier in ("replicated", "halo"):
            r = sv.solve(q=q, frontier=frontier)
            out[key("ppr", W, frontier, "x")] = r.x
            out[key("ppr", W, frontier, "counts")] = np.array([r.rounds, r.flushes, r.flush_bytes])

        # the batches of TestShardedBatch, on both frontiers
        gs = graphs["s"]
        sv = Solver(gs, sssp_problem(), n_workers=P, delta=BATCH_DELTA, min_chunk=BATCH_MIN_CHUNK,
                    n_shards=SHARDS, device="cpu", group=grp)
        x0 = multi_source_x0(gs, list(BATCH_SOURCES))
        for frontier in ("replicated", "halo"):
            batch_out(key("batch", W, frontier), sv.solve_batch(x0, frontier=frontier))
            batch_out(key("q1", W, frontier), sv.solve_batch(multi_source_x0(gs, [0]), frontier=frontier))
            r = sv.solve(frontier=frontier)
            out[key("q1", W, frontier, "solve_x")] = r.x
            out[key("q1", W, frontier, "solve_rounds")] = np.array([r.rounds])
            st = BatchStepper(sv, STEPPER_CAPACITY, frontier=frontier)
            pending = list(enumerate(multi_source_x0(gs, list(STEPPER_SOURCES))))
            retired = []
            while pending or st.occupancy:
                while pending and st.free_slots:
                    i, x = pending.pop(0)
                    st.admit(x, tag=i)
                retired += st.run(STEPPER_QUANTUM)
            for rq in retired:
                out[key("stepper", W, frontier, rq.tag, "x")] = rq.x
                out[key("stepper", W, frontier, rq.tag, "rounds")] = np.array([rq.rounds, rq.converged])
        gp = graphs["pr"]
        sv = Solver(gp, ppr_problem(), n_workers=P, delta=PPR_DELTA, min_chunk=PARITY_MIN_CHUNK,
                    n_shards=SHARDS, device="cpu", group=grp)
        qb = ppr_teleport(gp, list(PPR_BATCH_SEEDS))
        x0 = np.tile(np.full(gp.n, 1.0 / gp.n, np.float32), (len(PPR_BATCH_SEEDS), 1))
        for frontier in ("replicated", "halo"):
            batch_out(key("ppr_batch", W, frontier), sv.solve_batch(x0, q=qb, frontier=frontier))
            batch_out(key("compact", W, frontier), sv.solve_batch(x0, q=qb, frontier=frontier,
                                                                   compact_every=COMPACT_EVERY))

        # delta="auto": the probes run replicated across the group
        sv = Solver(gp, pagerank_problem(), n_workers=P, min_chunk=PARITY_MIN_CHUNK, device="cpu", group=grp)
        r = sv.solve()
        out[key("auto", W, "delta")] = np.array([sv.resolve_delta("auto"), r.rounds])
        out[key("auto", W, "x")] = r.x

    # the refusal that still stands and the paths lifted since, on the
    # four-rank group; the lifted paths' answers go under "lifted/<what>"
    g, prob = graphs["s"], sssp_problem()
    refusals = []

    def ran(what, fn):
        r = fn()
        out[key("lifted", what, "x")] = r.x
        out[key("lifted", what, "rounds")] = np.array([r.rounds])
        refusals.append(f"{what}: ran")

    def refused(what, fn, exc):
        try:
            fn()
        except exc as e:
            refusals.append(f"{what}: {type(e).__name__}: {e}")
        else:
            refusals.append(f"{what}: no {exc.__name__}")

    grp = groups[4]
    refused("P % W", lambda: Solver(g, prob, n_workers=6, device="cpu", group=grp), ValueError)
    ran("cache_dir", lambda: Solver(g, prob, n_workers=P, min_chunk=BATCH_MIN_CHUNK, device="cpu", group=grp,
                                    cache_dir=Path(a.out) / "cache").solve(delta=BATCH_DELTA))
    sv = Solver(g, prob, n_workers=P, min_chunk=BATCH_MIN_CHUNK, delta=BATCH_DELTA, device="cpu", group=grp)
    sv.solve()
    batches = [EdgeBatch.from_ops(**o) for o in update_ops(g)]
    ran("apply_updates", lambda: (sv.apply_updates(batches[0]), sv.solve())[1])
    ran("resolve", lambda: sv.resolve(updates=batches[1]))
    out["refusals"] = np.array(refusals)
    out["foreign_modules"] = np.array(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")), dtype=str)

    np.savez(Path(a.out) / f"rank{a.rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
