"""One rank of the port's halo solves across processes, for ``test_torch_dist.py``.

Run as ``python tests/torch_dist_ranks.py --rank R --world W --init
file:///path/store --out DIR`` in W processes (``PYTHONPATH=src``): the ranks
join one ``gloo`` group, run every case on the CPU (each problem of
:data:`PROBLEMS` at each δ of :data:`DELTAS` on each ``(W, D)`` of
:data:`LAYOUTS`, the quantized PageRank cases of :data:`QUANT`, and the
refusals, of which the lifted ones now run; a case with fewer ranks on the subgroup of ranks ``[0, W)``), and
each writes its results to ``DIR/rank<R>.npz``.  The lifted paths' update
batches come from :func:`update_ops`.  It imports ``torch`` and ``repro_torch``
only; the test holds the results to ``repro`` and to the port's one-process
halo solve.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np

P = 8
MIN_CHUNK = 16
DELTAS = {"sync": "sync", "32": 32, "async": "async"}
# (W, D): the layouts every problem runs on
LAYOUTS = ((2, 4), (4, 4), (4, 8))
PROBLEMS = ("pagerank", "sssp", "cc", "jacobi", "rwr")
# the quantized PageRank cases: (wire, W) at D = 4, δ = 32, solved for at
# most QUANT_MAX_ROUNDS rounds (the wire's noise floors the residual above
# the default tol); and the rounds whose x and ef are saved
QUANT = (("int8", 2), ("fp8", 4))
QUANT_MAX_ROUNDS = 8
QUANT_ROUNDS = 3


def jacobi_inputs():
    """A diagonally dominant system as a graph (the halo tests' recipe)."""
    rng = np.random.default_rng(11)
    n, m = 300, 1500
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.random(rows.size).astype(np.float32)
    diag = (np.bincount(rows, weights=vals, minlength=n) + 1.0).astype(np.float32)
    b = rng.random(n).astype(np.float32)
    w = (-vals / diag[rows]).astype(np.float32)
    return n, cols, rows, w, diag, b


def graph_spec(name):
    """``(generator name, scale, kind)`` of a problem's graph (not jacobi)."""
    return {
        "pagerank": ("twitter", 9, "pagerank"),
        "rwr": ("twitter", 8, "pagerank"),
        "sssp": ("kron", 9, "sssp"),
        "cc": ("kron", 8, "sssp"),
    }[name]


def port_case(name):
    """The port's ``(graph, problem)`` of a case."""
    from repro_torch import solve
    from repro_torch.graphs import formats, generators

    if name == "jacobi":
        n, cols, rows, w, diag, b = jacobi_inputs()
        return formats.CSRGraph.from_edges(n, cols, rows, w, dedup=False), solve.jacobi_problem(diag, b)
    gname, scale, kind = graph_spec(name)
    g = generators.make_graph(gname, scale=scale, efactor=8, kind=kind)
    factory = {"rwr": "rwr_embedding_problem"}.get(name, f"{name}_problem")
    return g, getattr(solve, factory)()


def update_ops(g, seed=25) -> list:
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
    from repro_torch.dist import engine_sharded
    from repro_torch.dist.comm import HaloGroup
    from repro_torch.evolve import EdgeBatch
    from repro_torch.solve import Solver, multi_source_x0

    dist.init_process_group(
        "gloo", init_method=a.init, rank=a.rank, world_size=a.world,
        timeout=datetime.timedelta(seconds=120),
    )
    groups = {w: dist.new_group(list(range(w))) for w in sorted({w for w, _ in LAYOUTS} | {w for _, w in QUANT})}
    out: dict = {}
    graphs = {name: port_case(name) for name in PROBLEMS}

    def layout_shapes(tag, sv, sched, plan, x_loc_shape):
        out[key(tag, "val")] = np.array(sched.val.shape)
        out[key(tag, "row_ptr")] = np.array(sched.row_ptr.shape)
        out[key(tag, "src_loc")] = np.array(plan.src_loc.shape)
        out[key(tag, "recv_idx")] = np.array(plan.recv_idx.shape)
        out[key(tag, "send_idx")] = np.array(plan.send_idx.shape)
        out[key(tag, "x_loc")] = np.array(x_loc_shape)

    for W, D in LAYOUTS:
        if a.rank >= W:
            continue
        grp = groups[W]
        for name in PROBLEMS:
            g, prob = graphs[name]
            for dname, delta in DELTAS.items():
                sv = Solver(g, prob, n_workers=P, min_chunk=MIN_CHUNK, delta=delta, frontier="halo",
                            n_shards=D, device="cpu", group=grp)
                r = sv.solve()
                tag = key("solve", W, D, name, dname)
                out[key(tag, "x")] = r.x
                out[key(tag, "counts")] = np.array([r.rounds, r.converged, r.flushes, r.flush_bytes, r.delta, r.P])
                out[key(tag, "residuals")] = np.asarray(r.residuals, np.float64)
                sched, plan = sv.rank_layout()
                layout_shapes(tag, sv, sched, plan, (plan.d1 - plan.d0, plan.L) + r.x.shape[1:])
                out[key(tag, "shards")] = np.array([sv.group.d0, sv.group.d1])

    # quantized PageRank: whole solves, and the first rounds' x and ef
    g, prob = graphs["pagerank"]
    for wire, W in QUANT:
        if a.rank >= W:
            continue
        grp = groups[W]
        sv = Solver(g, prob, n_workers=P, min_chunk=MIN_CHUNK, delta=32, frontier="halo", n_shards=4,
                    halo_dtype=wire, device="cpu", group=grp, max_rounds=QUANT_MAX_ROUNDS)
        r = sv.solve()
        tag = key("quant", wire, W)
        out[key(tag, "x")] = r.x
        out[key(tag, "counts")] = np.array([r.rounds, r.converged, r.flushes, r.flush_bytes])
        sched, plan = sv.rank_layout()
        x_ext = torch.as_tensor(np.append(prob.x0(g), np.float32(0)).astype(np.float32))
        x_loc = x_ext[plan.gather_index.long()].contiguous()
        ef = torch.zeros((plan.d1 - plan.d0, plan.S, plan.H), dtype=torch.float32)
        rnd = engine_sharded.frontier_rank_round_fn(sched, plan, prob.semiring, sv.row_update(), sv.group, wire)
        for _ in range(QUANT_ROUNDS):
            rnd(x_loc, ef)
        out[key(tag, "x_loc")] = x_loc.numpy()
        out[key(tag, "ef")] = ef.numpy()
        out[key(tag, "shards")] = np.array([plan.d0, plan.d1])

    # refusals, on the four-rank group; the paths a later port lifted run,
    # and their answers are saved under "lifted/<what>"
    g, prob = graphs["sssp"]
    refusals = []

    def refused(what, fn, exc):
        try:
            fn()
        except exc as e:
            refusals.append(f"{what}: {type(e).__name__}: {e}")
        else:
            refusals.append(f"{what}: no {exc.__name__}")

    def ran(what, fn):
        r = fn()
        out[key("lifted", what, "x")] = r.x
        out[key("lifted", what, "rounds")] = np.array([r.rounds])
        refusals.append(f"{what}: ran")

    grp = groups[4]
    refused("D % W", lambda: HaloGroup(grp, 6), ValueError)
    refused("D % W solver", lambda: Solver(g, prob, n_workers=P, frontier="halo", n_shards=2, delta=32,
                                           device="cpu", group=grp), ValueError)
    ran("replicated", lambda: Solver(g, prob, n_workers=P, n_shards=4, device="cpu", group=grp).solve(delta=32))
    ran("cache_dir", lambda: Solver(g, prob, n_workers=P, frontier="halo", n_shards=4, device="cpu", group=grp,
                                    cache_dir=Path(a.out) / "cache").solve(delta=32))
    sv = Solver(g, prob, n_workers=P, min_chunk=MIN_CHUNK, delta=32, frontier="halo", n_shards=4,
                device="cpu", group=grp)
    ran("solve replicated", lambda: sv.solve(frontier="replicated"))
    ran("auto", lambda: sv.solve(delta="auto"))
    ran("batch", lambda: sv.solve_batch(multi_source_x0(g, [0, 3])))
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
