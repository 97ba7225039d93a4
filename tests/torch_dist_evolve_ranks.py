"""One rank of the port's evolving graphs, store and serving across
processes, for ``test_torch_dist_evolve.py``.

Run as ``python tests/torch_dist_evolve_ranks.py --rank R --world 4 --init
file:///path/store --out DIR`` in four processes (``PYTHONPATH=src``): the
ranks join one ``gloo`` group and run every case on the CPU at each width of
:data:`WIDTHS` (a width W on the subgroup of ranks ``[0, W)``): SSSP, CC and
PageRank ``resolve`` after two random insert-and-delete batches on both
frontiers, the rank's patched cells, a batch that makes a worker of the last
rank outgrow ``M``, a group's store (a cold group, a warm group, a store
shared with a one-process solver in both directions, a restart on the
mutated graph), δ* and a reprobe, and a ``GraphService(group=...)`` (an
update batch between two waves, a continuous replay, a lane fault on one
rank).  Each rank writes its results to ``DIR/rank<R>.npz``.  It imports
``torch`` and ``repro_torch`` only; the test holds the results to ``repro``
and to the port's one-process solver and service.

The cases' inputs (graphs, batches, traces) are made here from seeds with
numpy, so that the test makes the same ones for both packages.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np

P = 8
SHARDS = 4  # D of the halo cases: every width divides it
WIDTHS = (2, 4)
DELTA, MIN_CHUNK = 32, 16
PROBLEMS = ("sssp", "cc", "pagerank")
FRONTIERS = ("replicated", "halo")
BATCH_SEED = 29
INSERTS, DELETES = 6, 6  # a batch's operations (CC: pairs, both directions)
REPROBE_DELTA = 64  # the extra logged solve before the reprobe
SERVE_KW = dict(n_workers=P, delta=DELTA, batch_size=4, min_chunk=8)
SERVE_WAVES = ((0, 7, 33, 90, 130, 200), (5, 7, 61, 250))  # SSSP sources before and after the update
FAULTS = (("fault", "scheduler.lane", "replicated"), ("dispatch_fault", "kernel.dispatch", "halo"))
TRACE_RATE, TRACE_ROUNDS, TRACE_SEED = 0.5, 24, 3


def graph_spec(name):
    """``(generator, scale, kind)`` of a case's graph."""
    return {"sssp": ("kron", 9, "sssp"), "cc": ("kron", 8, "sssp"), "pagerank": ("twitter", 9, "pagerank"),
            "serve": ("kron", 8, "sssp")}[name]


def make_case_graph(name, gen, formats):
    """A case's graph through a package's ``generators`` and ``formats``
    (CC's is the symmetric zero-weight graph of the reference's tests)."""
    gname, scale, kind = graph_spec(name)
    g = gen.make_graph(gname, scale=scale, efactor=8, kind=kind)
    if name != "cc":
        return g
    src, dst = edge_list(g)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return formats.CSRGraph.from_edges(g.n, np.concatenate([src, dst]), np.concatenate([dst, src]),
                                       np.zeros(2 * src.size, dtype=np.int32), name="sym")


def problem_of(name, solve, g):
    """A case's problem from a package's ``solve`` module."""
    if name == "sssp":
        return solve.sssp_problem(source=int(np.argmax(g.out_degree)))
    if name == "cc":
        return solve.cc_problem()
    return solve.pagerank_problem()


def edge_list(g):
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    return g.indices.astype(np.int64), dst


def batch_ops(name, g, seed=BATCH_SEED) -> list:
    """Two batches (dicts of op lists for ``EdgeBatch.from_ops``) of
    INSERTS fresh edges and DELETES existing ones each, disjoint, drawn
    from ``g`` alone so the second still applies after the first (CC's
    in both directions)."""
    rng = np.random.default_rng(seed)
    src, dst = edge_list(g)
    sym = name == "cc"
    cand = np.flatnonzero(src < dst) if sym else np.arange(g.nnz)
    dels = [(int(src[e]), int(dst[e])) for e in rng.choice(cand, size=2 * DELETES, replace=False)]
    present = set((dst * g.n + src).tolist())
    fresh = []
    while len(fresh) < 2 * INSERTS:
        s, d = (int(v) for v in rng.integers(0, g.n, size=2))
        if s == d or d * g.n + s in present or (sym and s * g.n + d in present):
            continue
        present.add(d * g.n + s)
        if sym:
            present.add(s * g.n + d)
        fresh.append((s, d))
    out = []
    for b in range(2):
        de = dels[b * DELETES:(b + 1) * DELETES]
        ins = fresh[b * INSERTS:(b + 1) * INSERTS]
        if name == "sssp":
            vals = [int(v) for v in rng.integers(1, 256, len(ins))]
        else:
            vals = [0 if sym else 0.05] * len(ins)
        ops = [(s, d, v) for (s, d), v in zip(ins, vals)]
        if sym:
            ops += [(d, s, v) for s, d, v in ops]
            de = de + [(d, s) for s, d in de]
        out.append({"inserts": ops, "deletes": de})
    return out


def outgrow_ops(g, bounds, M: int) -> dict:
    """An insert batch that gives the first row of the last worker's block
    ``M + 1`` more in-edges, so that its first cell outgrows ``M`` (the
    last worker is the last rank's at every width)."""
    row = int(bounds[-2])
    have = set(g.indices[g.indptr[row]:g.indptr[row + 1]].tolist()) | {row}
    srcs = [v for v in range(g.n) if v not in have][: M + 1]
    return {"inserts": [(s, row, 7) for s in srcs]}


def serve_update_ops(g) -> dict:
    """The service's update batch: the SSSP batch of ``batch_ops``."""
    return batch_ops("sssp", g, seed=BATCH_SEED + 1)[0]


def key(*parts) -> str:
    return "/".join(str(p) for p in parts)


def result_rows(results) -> dict:
    """QueryResult fields but ``latency_s`` and ``backend``, by request id."""
    import dataclasses

    return {r.request_id: {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
                           if f.name not in ("latency_s", "backend")} for r in results}


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
    from repro_torch import solve
    from repro_torch.evolve import EdgeBatch
    from repro_torch.ft import elastic
    from repro_torch.ft.inject import FaultPlan, FaultSpec, inject
    from repro_torch.graphs import formats, generators
    from repro_torch.launch.serve_graph import GraphService
    from repro_torch.launch.service import QueryRequest, UpdateRequest, poisson_trace, replay_continuous

    dist.init_process_group("gloo", init_method=a.init, rank=a.rank, world_size=a.world,
                            timeout=datetime.timedelta(seconds=120))
    groups = {w: dist.new_group(list(range(w))) for w in WIDTHS}
    out: dict = {}
    objects: dict = {}  # pickled: service records
    graphs = {name: make_case_graph(name, generators, formats) for name in (*PROBLEMS, "serve")}
    root = Path(a.out)

    def solver(name, W, **kw):
        g = graphs[name]
        return solve.Solver(g, problem_of(name, solve, g), n_workers=P, min_chunk=MIN_CHUNK, n_shards=SHARDS,
                            device="cpu", group=groups[W], **{"delta": DELTA, **kw})

    def save(tag, r):
        out[key(tag, "x")] = r.x
        out[key(tag, "counts")] = np.array([r.rounds, r.converged, r.flushes, r.flush_bytes, r.delta])

    for W in WIDTHS:
        if a.rank >= W:
            continue
        barrier = lambda: dist.barrier(group=groups[W])  # noqa: E731
        # resolve after two batches, on both frontiers
        for name in PROBLEMS:
            ops = batch_ops(name, graphs[name])
            for frontier in FRONTIERS:
                sv = solver(name, W, frontier=frontier)
                save(key("cold", W, name, frontier), sv.solve())
                for b, o in enumerate(ops):
                    save(key("resolve", W, name, frontier, b), sv.resolve(updates=EdgeBatch.from_ops(**o)))
                if frontier == "replicated":  # the patched cells
                    cells = sv.rank_layout()[0]
                    tag = key("cells", W, name)
                    for f in ("val", "dst_local", "rows", "row_ptr", "src"):
                        out[key(tag, f)] = getattr(cells, f).numpy()
                    out[key(tag, "meta")] = np.array([cells.w0, cells.w1, cells.M, sv.stats["schedule_builds"]])
                    out[key(tag, "bounds")] = sv.bounds

        # a batch that makes the last rank's worker outgrow M: every rank drops δ
        sv = solver("sssp", W)
        sv.solve()
        M = sv.rank_layout()[0].M
        o = outgrow_ops(graphs["sssp"], sv.bounds, M)
        sv.apply_updates(EdgeBatch.from_ops(**o))
        dropped = DELTA not in sv._rank_cells
        save(key("outgrow", W), sv.resolve(x0=sv._last_x))
        out[key("outgrow", W, "meta")] = np.array([M, dropped, sv.rank_layout()[0].M, sv.stats["schedule_builds"]])

        # the store: a cold group fills it, a warm group builds nothing
        store = root / f"store{W}"
        for phase in ("cold", "warm"):
            sv = solver("pagerank", W, frontier="halo", delta="auto", cache_dir=store)
            save(key("store", W, phase), sv.solve())
            out[key("store", W, phase, "stats")] = np.array([sv.stats[k] for k in STORE_STATS])
            barrier()
        # a one-process solver on the group's store loads its stripes
        if a.rank == 0:
            g = graphs["pagerank"]
            one = solve.Solver(g, problem_of("pagerank", solve, g), n_workers=P, min_chunk=MIN_CHUNK,
                               n_shards=SHARDS, frontier="halo", device="cpu", cache_dir=store)
            save(key("store", W, "one"), one.solve())
            out[key("store", W, "one", "stats")] = np.array([one.stats[k] for k in STORE_STATS])
            # and a store a one-process solver filled serves a group
            solve.Solver(g, problem_of("pagerank", solve, g), n_workers=P, min_chunk=MIN_CHUNK, n_shards=SHARDS,
                         frontier="halo", device="cpu", cache_dir=root / f"one{W}").solve()
        barrier()
        sv = solver("pagerank", W, frontier="halo", delta="auto", cache_dir=root / f"one{W}")
        save(key("store", W, "from_one"), sv.solve())
        out[key("store", W, "from_one", "stats")] = np.array([sv.stats[k] for k in STORE_STATS])
        # updates with a store: the patched stripes reach it, so a fresh group
        # on the mutated graph builds none (equal bounds: partition "equal")
        ops = batch_ops("sssp", graphs["sssp"])
        sv = solver("sssp", W, cache_dir=root / f"mut{W}", partition_method="equal")
        sv.solve()
        sv.resolve(updates=EdgeBatch.from_ops(**ops[0]))
        barrier()
        fresh = solve.Solver(sv.graph, sv.problem, n_workers=P, min_chunk=MIN_CHUNK, n_shards=SHARDS, device="cpu",
                             group=groups[W], delta=DELTA, cache_dir=root / f"mut{W}", partition_method="equal")
        save(key("store", W, "mutated"), fresh.solve())
        out[key("store", W, "mutated", "stats")] = np.array([fresh.stats[k] for k in STORE_STATS])

        # δ*: the probe, two more logged solves and two resolves, then a reprobe
        ops = batch_ops("pagerank", graphs["pagerank"])
        sv = solver("pagerank", W, delta="auto", cache_dir=root / f"auto{W}")
        sv.solve()
        first = sv.resolve_delta("auto")
        sv.solve(delta=REPROBE_DELTA)
        for o in ops:
            sv.resolve(updates=EdgeBatch.from_ops(**o))
        old, new = sv.reprobe_delta()
        barrier()  # the log's rows, as every rank's solves left them
        out[key("auto", W)] = np.array([first, old, new, sv._auto_delta_incremental,
                                        len(sv.persist.load_observations())])

        # serving: two waves of SSSP around an update batch, then a replay
        for frontier in FRONTIERS:
            svc = GraphService(graphs["serve"], algos=("sssp",), frontier=frontier, n_shards=SHARDS,
                               device="cpu", group=groups[W], **SERVE_KW)
            recs = {}
            for wave, sources in enumerate(SERVE_WAVES):
                if a.rank == 0:
                    if wave:
                        svc.submit_update(UpdateRequest(batch=EdgeBatch.from_ops(**serve_update_ops(graphs["serve"]))))
                    for s in sources:
                        svc.submit(QueryRequest(algo="sssp", payload=s))
                recs.update(result_rows(svc.drain()))
            trace = poisson_trace(TRACE_RATE, TRACE_ROUNDS, graphs["serve"].n, seed=TRACE_SEED, mix=(("sssp", 1.0),))
            rep = replay_continuous(svc, trace)
            objects[key("serve", W, frontier)] = {
                "results": recs, "updates": [(u.request_id, u.applied_clock, u.affected_rows)
                                             for u in svc.take_update_results()],
                "replay": {k: v for k, v in rep["report"].items() if k != "wall_s"},
                "replay_results": result_rows(rep["results"]),
                "counters": dict(svc.scheduler.counters), "clock": svc.clock_rounds,
            }
        # a lane fault, or a dispatch fault before the quantum's first
        # gather, on the last rank alone is every rank's
        for name, site, frontier in FAULTS:
            svc = GraphService(graphs["serve"], algos=("sssp",), frontier=frontier, n_shards=SHARDS, device="cpu",
                               group=groups[W], **SERVE_KW)
            plan = FaultPlan([FaultSpec(site=site, at=1)]) if a.rank == W - 1 else FaultPlan([])
            with inject(plan):
                if a.rank == 0:
                    for s in SERVE_WAVES[0]:
                        svc.submit(QueryRequest(algo="sssp", payload=s))
                recs = result_rows(svc.drain())
            objects[key(name, W)] = {"results": recs, "counters": dict(svc.scheduler.counters),
                                     "clock": svc.clock_rounds}

    # what a group refuses, and what only rank 0 takes, on the four ranks
    g = graphs["sssp"]
    refusals = []

    def refused(what, fn, exc):
        try:
            fn()
        except exc as e:
            refusals.append(f"{what}: {type(e).__name__}: {e}")
        else:
            refusals.append(f"{what}: no {exc.__name__}")

    grp = groups[4]
    refused("degrade", lambda: solve.Solver(g, problem_of("sssp", solve, g), n_workers=P, device="cpu",
                                            group=grp, degrade=True), NotImplementedError)
    refused("service degrade", lambda: GraphService(g, device="cpu", group=grp, degrade=True), NotImplementedError)
    sv = solver("sssp", 4)
    refused("checkpointed", lambda: elastic.checkpointed_solve(sv, ckpt_dir=root / "ckpt"), NotImplementedError)
    svc = GraphService(g, algos=("sssp",), device="cpu", group=grp, **SERVE_KW)
    if a.rank:
        refused("submit", lambda: svc.submit(QueryRequest(algo="sssp", payload=0)), ValueError)
    out["refusals"] = np.array(refusals)
    out["foreign_modules"] = np.array(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")), dtype=str)

    np.savez(root / f"rank{a.rank}.npz", **out)
    import pickle

    (root / f"rank{a.rank}.pkl").write_bytes(pickle.dumps(objects))
    dist.barrier()
    dist.destroy_process_group()
    return 0


STORE_STATS = ("solves", "schedule_builds", "plan_builds", "stripe_builds", "stripe_loads", "plan_shard_builds",
               "plan_shard_loads", "cache_loads")

if __name__ == "__main__":
    sys.exit(main())
