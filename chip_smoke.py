"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure ends the run with a nonzero
exit and no result line.  The full-size graph is generated in a child
process (this script with ``--write-graph``) while phases 1 and 2 run on
smaller graphs:

1. the card's name and power limit; build every CUDA kernel from ``src/``
   (``build/kernels/``, one ``nvcc`` per source, all started together), and
   print each kernel's registers, shared memory and spills as ``ptxas -v``
   reports them.
2. K1 (the fused-round kernel) against its plain PyTorch version, one round
   from the same ``x``, for pagerank (``add_const``), ppr (``add_table``) and
   sssp (``min_old``) at δ = sync, async (128) and 1024, on a small graph and
   at full size, and after phase 3 at every other δ the main path resolved
   (auto's δ*).  int32 must match exactly; float32 must match bit for bit
   against the plain version on the CPU (on CUDA it sums with atomics).
   K2 (the halo round kernel: one launch a round for all D = 4 shards, the
   exchange and the int8/fp8 quantizer inside) likewise, on the stacked
   ``(D, L)`` frontier: ``x_loc`` outside the dump slots and the residuals
   ``ef``, bit for bit, after one f32 round and after three int8 and three
   fp8 rounds (pagerank and ppr; sssp is f32 only), at scale 16 at δ = sync,
   128 and 1024; and at scale 14 the halo kernel solves (f32, int8, fp8)
   must equal the CPU plain halo solves.  K1 and K2 at F = 4 (matrix
   frontiers ``(n + 1, 4)``, K2 on ``(D, L, 4)`` with ``(D, S, H, 4)``
   residuals) likewise, for rwr (``add_table`` over its ``(n + 1, 4)``
   restart table) and labelprop (its anchors, unit edges) on twitter at
   scale 16 at δ = sync and 128, and after phase 3 at scale 22 at sync
   (K2 there on the f32 wire alone).
   K1's batch entry (one launch a round for a batch frontier
   ``(n + 1, Q)+feat``) likewise, one round from the same frontier: ppr
   (``add_table`` over Q = 8 teleports) and multi-source sssp at Q = 8, rwr
   and labelprop at Q = 2, F = 4, at scale 16 (sync, 128) and, after phase
   3, at scale 22 (sync, δ*; rwr and labelprop at sync).
   K1's loop entry (a whole solve, a closed batch or an open batch's
   quantum in one launch) against its plain loops on the CPU
   (``ref.fused_solve_ref``, ``ref.fused_batch_solve_ref``): x bit for bit,
   rounds and ``rounds_per_query`` exactly, a count residual exactly and an
   l1 residual within d·2⁻²⁴ of the float64 sum of the plain round's terms
   (d the kernel's summation depth, ``loop_sum_depth``): PageRank, SSSP,
   rwr (F = 4), ppr (Q = 8) and three quanta of an open ppr batch, to
   convergence at scale 16 (sync, 128), and over a budget of a few rounds
   (``tol = -1``) at scale 22 (sync and, after phase 3, PageRank and SSSP
   at δ*), where SSSP's int32 plain loop runs on the card to convergence
   (min-plus is order-free).
3. the main path, ``Solver(...).solve()`` with ``backend="kernel"`` at sync,
   async, 1024 and auto (twice: cold, then warm): PageRank on ``twitter``
   scale 22 (4.2 M vertices, 64.3 M edges) and SSSP on the same topology
   with SSSP weights, P = 8.  Every launch count is reset before and read
   after: one launch of K1's loop entry a solve (three for the cold auto,
   whose probes solve at sync and async too) and no single-round K1
   launch.  ``total_s`` is the wall time of the whole ``solve()`` call,
   ``loop_s`` the loop's own.  Then each warm solve again in its parts
   (``setup_s``: x0 and the row update's table to the card; ``loop_s``: the
   loop entry and its read-back; ``copy_out_s``: x back to the host),
   beside the same solve through ``engine.host_loop`` over single K1
   launches (K1's count reset before and read after), whose x and rounds
   must be equal.  On a smaller graph the kernel solve must give the plain
   (``backend="torch"``, CPU) solve's rounds and ``x``.
   Then the halo path, ``solve(frontier="halo")`` over D = 4 shards at sync
   and δ*, with K2's launch count reset before and read after, one launch a
   round: f32 must give the replicated solve's ``x``, rounds, flushes and
   flush_bytes exactly; PageRank also runs with int8 and fp8 halos, which
   must converge.  Then K2 against its plain round at full size, at sync
   and δ*, as in phase 2 but one round of each quantized wire.
   Then the matrix path, with both launch counts reset before and read
   after: rwr embeddings (F = 4) and label propagation (F = 4, on the same
   topology with unit edges) on twitter scale 22, each
   replicated (one K1 launch a round) and halo (one K2 launch a round) at
   sync and its own δ* (``delta="auto"``, probed before the count): rwr
   must converge, labelprop runs at most LABELPROP_ROUNDS rounds, both give
   finite ``(n, 4)`` values, and the halo solve must equal the replicated one in
   x, rounds, flushes and flush_bytes; the replicated solve is one loop
   launch, the halo solve one K2 launch a round; then each replicated
   solve through ``engine.host_loop`` over single K1 launches (counted),
   equal in x and rounds.  At scale 14 their kernel solves (replicated and
   halo, async) must equal the CPU plain solves.
   Then the batch path, with the batch entry's launch count reset before
   and read after: ``Solver.solve_batch`` on twitter scale 22 for ppr
   (Q = 8 teleports, one a seed: the 8 vertices of largest out-degree) and
   multi-source sssp from the same 8 vertices, at sync and δ*, and ppr at
   Q = 32 at δ*, each twice (``total_s`` is the second call's wall time,
   beside the caching allocator's device allocations and retries in it);
   ppr at Q = 8 and δ* with ``compact_every = 4``; then a ``BatchStepper``
   at scale 16 (capacity 8, 12 ppr queries admitted two a quantum of 4
   rounds).  One loop launch a compaction chunk and a quantum, and no
   single-round launch; after the count, each batch query's x must equal its
   own kernel ``solve(tol=-1.0, max_rounds=batch.rounds)`` bit for bit,
   ``rounds_per_query`` each single solve's rounds (whose wall times are
   summed beside the batch's), and every retired row of the open batch a
   fresh one-query ``solve_batch``.  Then the ppr batches (Q = 8 at sync,
   Q = 32 at δ*) through ``engine.host_loop`` over single launches of K1's
   batch entry (counted) for the batch's rounds, equal in x.
   Then the evolving-graph path, with the loop entry's count reset before
   and read after: on solvers of its own at δ* on twitter scale 22, SSSP
   takes mixed batches (the recipe of ``benchmarks/incremental.py``: k/2
   deletes, k/4 reweights, the rest inserts, weights in [1, 255]) and
   PageRank mass-conserving deletes (each touched source's surviving
   out-edges reweighted to ``0.85 / outdeg``), k = 64 and 4,096, seeded,
   each batch after the last on the same solver.  Each
   ``resolve(updates=batch)`` must be one loop-entry launch; the patched
   ``row_ptr`` must equal ``_cell_row_ptr`` of the patched ``dst_local``
   (recomputed on the card), and the patched schedule a fresh build of the
   mutated graph with the same bounds and δ (padded to its ``M``); the
   result must equal a cold solve on the mutated graph (bit for bit for
   SSSP, L1 ≤ 20·tol for PageRank); K1's loop entry must equal its plain
   loop on the patched schedule (PageRank over LOOP_BUDGET rounds,
   ``tol = -1``; SSSP to convergence, its plain loop on the card).  Each
   case prints its rounds, ``total_s`` and ``apply_updates_s`` (the host's
   patch and its copies to the card) beside the cold solve's rounds.  At
   scale 16 a halo resolve (f32, D = 4, δ = 128, k = 64) must rebuild its
   plan once, launch K2 once a round and equal the replicated resolve, and
   K2 must equal its plain round over the rebuilt plan.
   Then the restart path: this process fills a fresh store
   (``tempfile.mkdtemp()``, removed at the end) through
   ``Solver(cache_dir=...)``: PageRank at scale 22 with ``delta="auto"``
   (two probes, three schedules built in stripes, all written), a halo
   PageRank at scale 16 (D = 4, auto), and an SSSP solver at scale 16
   with equal bounds whose ``resolve`` of a batch of deletes and reweights
   pushes its patched stripes; then a second process (this script with
   ``--restart-warm``) builds the same solvers on that store, each with
   its launch counts reset before and read after.  Each must build no
   schedule, stripe or plan, run no probe (the δ-model loaded), launch
   K1's loop entry once (K2 once a round on the halo path) and give the
   first process's x bit for bit; the mutated graph's solver must load
   all its stripes.  Prints each process's time to first answer in its
   parts (the graph's hash, the store's ``np.load``, the stripes' digests
   and assembly on the host, the store's writes, the copy to the card,
   the solve), the bytes and files written (the first process's split
   into whole schedules, stripes, whole plans and plan shards) and read,
   the scale-22 schedule's load from its stripes alone beside its whole
   entry's, and the free space before the phase; then K1's loop entry must
   equal its plain loop over the stored schedule, and K2 its plain round
   over the stored plan.
4. K1's time per round at the full-size shapes, at sync, 128, 1024 and
   auto's δ* (CUDA events), beside its byte bound, the same round with no
   edges to walk (barriers, epilogues and publishes alone), the plain round's
   time, and for PageRank ``torch.sparse.mm`` as the library yardstick: at
   sync over the whole matrix (the round's SpMV), at δ* one call over each
   commit step's rows, S calls a round (the step blocks built before
   timing).  K2's time per launch, one launch a round (CUDA events), for
   PageRank at sync, 128, 1024 and δ* and SSSP at sync and δ*, beside the
   host's time issuing that launch, the same steps launched one at a time,
   its bound (``halo_round_bound``), the plain round's time on the card,
   the library yardstick of K1's row at the same δ, the int8 and fp8 wires'
   kernel times, the halo round with its scatter and gather
   (``halo_round_ms``) and K1's round (``k1_round_ms``).  K3 (the ELL SpMV) through its
   entry point ``ops.spmv`` on the full-size graph's ELL (launch count reset
   before and read after), against its plain version, timed beside its byte
   bounds (padded ELL and real edges) and ``torch.sparse.mm``: plus-times at
   F = 1 and 4 and min-plus on the reference's layout (``lane_pad = 128``),
   and plus-times F = 1 on a ``lane_pad = 8`` layout of the same graph,
   which must give the same bits.  K1 and K2 at F = 4 for rwr and
   labelprop at sync and δ*: K1's round and K2's round (f32, and int8)
   beside their bounds (``round_bound``, ``halo_round_bound`` with F), the
   plain rounds on the card, and ``torch.sparse.mm`` of the CSR by the
   ``(n, 4)`` frontier (at δ*, one call a commit step).  K1's batch entry
   at C = Q·F = 8 (ppr and sssp, Q = 8) and 32 (rwr Q = 8 at F = 4, ppr
   Q = 32) at sync and δ*, beside its bound (``round_bound`` with C), its
   plain round on the card, ``torch.sparse.mm`` by the ``(n, C)`` frontier
   (plus-times) and Q single-query K1 launches.  K1's loop entry: its time a
   round (a launch of a fixed number of rounds, ``tol = -1``, over that
   number) at every δ the main path runs, for PageRank and SSSP, beside K1's
   round (``loop_over_k1``), the same loop publishing without its residual
   (``no_residual_ms``), the plain loop's time a round on the card and the
   round's bound; and likewise for rwr at F = 4, a ppr batch of Q = 8
   (sync) and of Q = 32 (δ*).
5. the ``kernels`` line (every kernel's launches on its path must be
   nonzero; ``resolve_launches`` of the loop entry and of K2 are the
   evolving-graph path's, ``restart_launches`` the restart path's second
   process's; K1's single-round entries, which no path launches now, show the
   main path's 0 with ``on_path: false``, the loop entry that superseded
   each, and their launches in phase 3's host-loop comparisons, which must
   be nonzero), the card's name and power limit, and the result line.

It imports neither jax nor the JAX package ``repro``.

    python3 chip_smoke.py --ab OTHER_CHECKOUT [ANOTHER ...]

times the vector kernels (K1 and K2 for PageRank at sync and δ* =
16,384, K1's batch entry at C = 8 and 32 where both checkouts have it, K3
plus-times F = 1), K1's loop entry a round where the checkout has one
(PageRank at sync and δ*, rwr F = 4 and a ppr batch of Q = 8 at sync), and
warm whole solves (PageRank, SSSP, rwr F = 4 and labelprop F = 4 at sync
and δ*, a ppr batch of Q = 8 at δ*) of this checkout and of others (such
as the parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), in turns (the others, this, this, the others in
reverse), each in its own process on the same twitter graph: a comparison
of versions on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12  # H100 SXM int32 (half the f32 FMA rate)
SCALE, EFACTOR, P = 22, 16, 8
SMALL_SCALE = 14
HALO_SCALE = 16  # K2 against its plain version at fine δ
SHARDS = 4  # D: the halo engine's shards, all on the one card
DELTAS = ("sync", 128, 1024)
# The quantized halo's per-round L1 residual stops falling at a floor set by
# the quantization noise, below which its solves cannot converge; phase 3
# prints that floor (the least residual of FLOOR_ROUNDS rounds at the
# problem's own tolerance), and the quantized solves stop at QUANT_TOL,
# above it.
QUANT_TOL = 2e-2
FLOOR_ROUNDS = 40
# labelprop's stopping test (tol 1e-3 on the L1 change summed over all n·F
# values) is not met within its 2,000 rounds on twitter graphs of scale 11
# to 16 (at scale 22 it is, in a few rounds: four anchors move a small share
# of 4.2 M rows), so the smoke caps its solves at this many rounds.
LABELPROP_ROUNDS = 200
# Batches: Q vector queries (ppr, multi-source sssp; the serving default of
# src/repro/launch/serve_graph.py), a wide batch of Q_WIDE, and Q_MATRIX
# matrix queries of F = 4 (rwr, labelprop) in phase 2; the open batch's
# capacity and queries (phase 3, at HALO_SCALE).
BATCH_Q, BATCH_Q_WIDE, BATCH_Q_MATRIX = 8, 32, 2
STEPPER_CAPACITY, STEPPER_QUERIES = 8, 12
# K1's loop entry against its plain loops at full size: rounds a float32
# case runs (the plain loop runs on the host's CPU), and the budget-cut case
# at scale 16.  Phase 4 times a loop launch of LOOP_TIMED_ROUNDS[δ] rounds.
LOOP_BUDGET, LOOP_BUDGET_CUT = 2, 3
LOOP_TIMED_ROUNDS = {"sync": 20, 128: 3, 1024: 8}
LOOP_TIMED_DEFAULT = 16  # δ*
# Evolving graphs (phase 3): edge operations a batch, the batches' seed, and
# the δ of the halo resolve at HALO_SCALE.
EVOLVE_BATCHES = (64, 4096)
EVOLVE_SEED = 22
EVOLVE_HALO_DELTA = 128
# The restart path (phase 3): the second process's time limit.
RESTART_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(nvcc_log: str) -> list[dict]:
    """Registers, shared memory and spills of each kernel in ``ptxas -v``'s log."""
    out, cur = [], None
    for ln in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            base = next(
                (k for k in ("halo_round_kernel", "solve_kernel", "round_kernel", "spmv_tiles") if k in mangled),
                mangled,
            )
            args = re.findall(r"PlusTimes|MinPlus|(?<=Li)\d+(?=E)", mangled.split(base, 1)[-1])
            cur = {"kernel": f"{base}<{','.join(args)}>"}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def top_out_degree(graph, k: int) -> np.ndarray:
    """The ``k`` vertices of largest out-degree (ties by id): the batches'
    seeds and sources."""
    return np.argsort(-graph.out_degree, kind="stable")[:k]


def step_blocks(graph, sched, device) -> list:
    """The rows of each commit step of ``sched`` as a CSR matrix ``(rows, n)``:
    S matrices, whose SpMVs do a round's work as S library calls."""
    indptr = torch.tensor(graph.indptr, device=device)
    indices = torch.tensor(graph.indices.astype(np.int64), device=device)
    values = torch.tensor(graph.values, device=device)
    mats = []
    for s in range(sched.S):
        r = sched.rows[s].reshape(-1)
        r = r[r < graph.n].long()
        counts = indptr[r + 1] - indptr[r]
        crow = torch.zeros(r.numel() + 1, dtype=torch.int64, device=device)
        crow[1:] = counts.cumsum(0)
        pos = torch.repeat_interleave(indptr[r] - crow[:-1], counts)
        pos += torch.arange(pos.numel(), device=device)
        mats.append(torch.sparse_csr_tensor(crow, indices[pos], values[pos], size=(r.numel(), graph.n)))
    return mats


def on(sched, device):
    """``sched`` with its tensors on ``device``."""
    moved = {
        f.name: getattr(sched, f.name).to(device)
        for f in dataclasses.fields(sched)
        if isinstance(getattr(sched, f.name), torch.Tensor)
    }
    return dataclasses.replace(sched, **moved)


def loop_sum_depth(sched, C: int, Q: int, sms: int) -> int:
    """Most float32 additions on any term's way into a query's residual in
    K1's loop entry (``solve_kernel`` in csrc/round_block.cu) over ``sched``
    with C values a row and Q queries, on a grid of at least one block an SM
    (``tile_grid`` at one block an SM gives the fewest lanes, so the most
    terms a lane): a lane's cells of a step (C / Q values each) and one
    addition a step, its block's fold (a tree of 8 levels for one query, a
    query's lanes in lane order for a batch), and the fold over the blocks
    (at most 32 an SM, 256-strided, then a tree of 8 levels).  A sum of
    nonnegative float32 terms along paths of at most d additions is within
    d·2⁻²⁴/(1 − d·2⁻²⁴) of the exact sum, relative."""
    cells = sched.P * sched.delta
    rows = min(max(-(-cells // sms), 8), 256, sched.delta)
    blocks = max(min(sched.P * -(-sched.delta // rows), sms), -(-Q // 256))
    lanes = blocks * 256 // Q  # a query's lanes
    lane = -(-cells // lanes) * (C // Q) + sched.S
    block = 8 if Q == 1 else -(-256 // Q)
    return lane + block + -(-sms * 32 // 256) + 8


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two f32 tensors."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def time_ms(fn, budget_s: float = 0.4, max_iters: int = 50, min_iters: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around a run of calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(min_iters, math.ceil(budget_s * 1e3 / est))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_: float, ops: float, is_f32: bool) -> tuple[float, str]:
    """The least time for ``bytes_`` moved and ``ops`` done, and which binds."""
    byte_s = bytes_ / HBM_BYTES_PER_S
    op_s = ops / (F32_OPS_PER_S if is_f32 else INT32_OPS_PER_S)
    return (max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations")


def round_bound(sched, table, F: int = 1) -> tuple[float, str]:
    """Least time for one round: each real edge's index and value read once,
    the frontier (F values a row; and an epilogue table of F values a row)
    read once and written once."""
    row = 4 * F
    bytes_ = sched.edges * 8 + sched.n_slots * row * (3 if table else 2)
    ops = (2 * sched.edges + sched.n) * F  # ⊗ and ⊕ per edge and feature, an epilogue per value
    return bound_ms(bytes_, ops, sched.val.dtype == torch.float32)


def halo_round_bound(sched, plan, tag: str, wire: str, F: int = 1) -> tuple[float, str]:
    """Least time for one K2 launch over a whole halo round, summed over its
    commit steps and shards.  Per (step, shard): the real edges (local source
    slot and value, 8 B each); each distinct local slot they gather (and,
    for ``min_old`` and ``labelprop``, each real row's ``old`` slot) read
    once, F values each; per chunk row its edge range and local slot read
    once (8 B) and, for ``add_table`` and ``labelprop``, its global id (4 B)
    and table row (4F B); each real row (not the dump) written once.  The
    exchange, per step: ``send_idx`` (D·H) and ``recv_idx`` (D·D·H) read
    once, each real halo slot (a ``recv_idx`` entry other than the dump)
    written once, and for an int8/fp8 wire ``ef`` (D·H·F) read and written
    once.  Operations: ⊗ and ⊕ per real edge and feature and one epilogue
    per chunk row and feature."""
    D, L, H, P_loc, S, M = plan.D, plan.L, plan.H, plan.P_loc, sched.S, sched.M
    dev = plan.src_loc.device
    real = sched.row_ptr[:, :, -1].reshape(S, D, P_loc).permute(1, 0, 2)  # (D, S, P_loc)
    edges = int(real.sum())
    base = (torch.arange(D * S, device=dev, dtype=torch.int64) * L).view(D, S, 1, 1)
    keys = (base + plan.src_loc)[torch.arange(M, device=dev) < real[..., None]]
    live = plan.rows_loc != L - 1
    if tag in ("min_old", "labelprop"):
        keys = torch.cat([keys, (base + plan.rows_loc)[live]])
    distinct = int(torch.unique(keys).numel())
    del keys
    rows = sched.P * sched.delta * S
    per_row = 12 + 4 * F if tag in ("add_table", "labelprop") else 8
    halo_writes = int((plan.recv_idx != L - 1).sum())
    exchange = S * D * H * 4 + S * D * D * H * 4 + halo_writes * 4 * F
    if wire != "f32":
        exchange += S * D * H * 8 * F
    bytes_ = edges * 8 + distinct * 4 * F + rows * per_row + int(live.sum()) * 4 * F + exchange
    return bound_ms(bytes_, (2 * edges + rows) * F, sched.val.dtype == torch.float32)


def edge_list(graph) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int64 of every edge, in CSR order (sorted by dst·n + src)."""
    dst = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(graph.indptr))
    return graph.indices.astype(np.int64), dst


def sssp_event(graph, k: int, rng):
    """A mixed batch of ``k`` edge operations with GAP-style integer weights,
    the recipe (and the draws) of ``benchmarks/incremental.py``'s
    ``_sssp_event``: k/2 deletes and k/4 reweights of distinct existing edges,
    the rest inserts of absent non-loop edges, weights in [1, 255].  Edge
    membership is a search in the sorted CSR keys, not a set of every edge."""
    from repro_torch.evolve import EdgeBatch

    src, dst = edge_list(graph)
    n = graph.n
    n_del, n_rw = k // 2, k // 4
    n_ins = k - n_del - n_rw
    pick = rng.choice(graph.nnz, size=n_del + n_rw, replace=False)
    deletes = [(int(src[e]), int(dst[e])) for e in pick[:n_del]]
    reweights = [(int(src[e]), int(dst[e]), int(rng.integers(1, 256))) for e in pick[n_del:]]
    keys, added, inserts = dst * n + src, set(), []
    while len(inserts) < n_ins:
        s, d = (int(v) for v in rng.integers(0, n, size=2))
        key = d * n + s
        i = int(np.searchsorted(keys, key))
        if s == d or key in added or (i < keys.size and keys[i] == key):
            continue
        added.add(key)
        inserts.append((s, d, int(rng.integers(1, 256))))
    return EdgeBatch.from_ops(inserts=inserts, deletes=deletes, reweights=reweights)


def pagerank_event(graph, k: int, rng, damping: float = 0.85):
    """``k`` mass-conserving deletes, the recipe (and the draws) of
    ``benchmarks/incremental.py``'s ``_pagerank_event``: every touched
    source's surviving out-edges are reweighted to ``damping / outdeg_new``,
    so the graph stays a scaled column-stochastic operator.  Built with array
    operations: a hub's millions of out-edges become one reweight array."""
    from repro_torch.evolve import EdgeBatch

    src, dst = edge_list(graph)
    pick = rng.choice(graph.nnz, size=k, replace=False)
    gone = np.zeros(graph.nnz, dtype=bool)
    gone[pick] = True
    touched = np.zeros(graph.n, dtype=bool)
    touched[src[pick]] = True
    kept = np.flatnonzero(touched[src] & ~gone)
    outdeg = np.bincount(src[kept], minlength=graph.n)
    none = np.zeros(0, dtype=np.int64)
    return EdgeBatch(
        insert_src=none,
        insert_dst=none,
        insert_val=np.zeros(0),
        delete_src=src[pick],
        delete_dst=dst[pick],
        reweight_src=src[kept],
        reweight_dst=dst[kept],
        reweight_val=damping / outdeg[src[kept]],
    )


AB_DELTAS = ("sync", 16384)  # δ* of PageRank and of SSSP on twitter scale 22
AB_REPEATS = 3


def time_vector(graph_npz: str, root: str) -> int:
    """The vector kernels of the checkout at ``root``, timed on the graph in
    ``graph_npz``: K1 and K2 (D = SHARDS) for PageRank at AB_DELTAS, K1's
    batch entry (where the checkout has one) for an add_table batch of C =
    8 and 32 columns at AB_DELTAS, and K3 plus-times F = 1; K1's loop entry
    a round (where the checkout has one; launches of R and 2R rounds at tol
    = -1, the difference over R) for PageRank at AB_DELTAS, rwr (F = 4) and
    a ppr batch of BATCH_Q teleports at sync; then warm whole solves, each
    the least wall time of AB_REPEATS calls after a first one: PageRank,
    SSSP (source: the vertex of largest out-degree), rwr and labelprop (F =
    4; labelprop with unit edges, at most LABELPROP_ROUNDS rounds) at
    AB_DELTAS, and a ppr batch of BATCH_Q teleports at δ*.  Prints one JSON
    object."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.core import engine
    from repro_torch.core.semiring import PLUS_TIMES
    from repro_torch.dist import engine_sharded
    from repro_torch.graphs.formats import CSRGraph
    from repro_torch.graphs.generators import sssp_values
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.round_block import ADD_TABLE, Epilogue
    from repro_torch.solve import (
        Solver,
        label_propagation_problem,
        pagerank_problem,
        ppr_problem,
        ppr_teleport,
        rwr_embedding_problem,
        sssp_problem,
    )

    build.build()
    a = np.load(graph_npz)
    g = CSRGraph(int(a["n"]), a["indptr"], a["indices"], a["values"], name="ab")
    dev = torch.device("cuda", 0)
    pr = Solver(g, pagerank_problem(), n_workers=P)
    ep = pr.row_update()
    x = engine.extend_frontier(np.full(g.n, 1.0 / g.n, np.float32), PLUS_TIMES, dev)
    row = {"root": root}
    for d in AB_DELTAS:
        sched = pr.schedule(d)
        row[f"k1_{d}_ms"] = time_ms(lambda: ops.fused_round(x, sched, PLUS_TIMES, ep))
        plan = engine_sharded.make_frontier_plan(sched, SHARDS)
        x_loc = plan.scatter_x(x)
        row[f"k2_{d}_ms"] = time_ms(lambda: ops.fused_halo_round(x_loc, None, sched, plan, PLUS_TIMES, ep))
        for C in (8, 32) if hasattr(ops, "fused_batch_round") else ():
            X = x[:, None].expand(-1, C).contiguous()
            table = torch.zeros((g.n + 1, C), device=dev)
            table[torch.arange(C, device=dev) * (g.n // C), torch.arange(C, device=dev)] = 0.15
            ep_b = Epilogue(ADD_TABLE, table=table)
            row[f"kb_c{C}_{d}_ms"] = time_ms(lambda: ops.fused_batch_round(X, sched, PLUS_TIMES, ep_b))
            del X, table, ep_b
        del plan, x_loc
    idx, val = (torch.from_numpy(v).to(dev) for v in ops.ell_from_csr(g))
    row["k3_ms"] = time_ms(lambda: ops.spmv(x, idx, val, "plus_times"))
    del idx, val

    seeds = np.argsort(-g.out_degree, kind="stable")[:BATCH_Q]
    ppr = Solver(g, ppr_problem(), n_workers=P)
    rwr = Solver(g, rwr_embedding_problem(), n_workers=P)
    x4 = engine.extend_frontier(rwr.problem.x0(g), PLUS_TIMES, dev)
    sched, ep4 = rwr.schedule("sync"), rwr.row_update()
    row["k1_rwr_f4_sync_ms"] = time_ms(lambda: ops.fused_round(x4, sched, PLUS_TIMES, ep4))
    if hasattr(ops, "fused_solve"):
        from repro_torch.solve.problem import l1_residual

        def loop_ms(solver, d, ep, X, batch=False):
            sched = solver.schedule(d)
            rounds = LOOP_TIMED_ROUNDS.get(d, LOOP_TIMED_DEFAULT)
            loop = ops.fused_batch_solve if batch else ops.fused_solve
            one = time_ms(lambda: loop(X, sched, PLUS_TIMES, ep, l1_residual, -1.0, rounds), 0.3, 8, 2)
            two = time_ms(lambda: loop(X, sched, PLUS_TIMES, ep, l1_residual, -1.0, 2 * rounds), 0.3, 8, 2)
            return (two - one) / rounds

        for d in AB_DELTAS:
            row[f"loop_{d}_ms"] = loop_ms(pr, d, ep, x)
        row["loop_rwr_f4_sync_ms"] = loop_ms(rwr, "sync", ep4, x4)
        ep_b = ppr.batch_row_update(ppr_teleport(g, seeds), BATCH_Q, ())
        X = engine.extend_frontier(np.full((g.n, BATCH_Q), 1.0 / g.n, np.float32), PLUS_TIMES, dev)
        row[f"loop_ppr_q{BATCH_Q}_sync_ms"] = loop_ms(ppr, "sync", ep_b, X, batch=True)
        del X, ep_b
    del x4

    def warm_s(call):
        call()
        walls = []
        for _ in range(AB_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        return min(walls)

    hub = int(np.argmax(g.out_degree))
    ss = Solver(g.with_values(sssp_values(g.indices)), sssp_problem(source=hub), n_workers=P)
    lp = Solver(g, label_propagation_problem(max_rounds=LABELPROP_ROUNDS), n_workers=P)
    for name, solver in (("pagerank", pr), ("sssp", ss), ("rwr", rwr), ("labelprop", lp)):
        for d in AB_DELTAS:
            row[f"solve_{name}_{d}_s"] = warm_s(lambda: solver.solve(delta=d))
            row[f"solve_{name}_{d}_rounds"] = solver.solve(delta=d).rounds
    x0 = np.full((BATCH_Q, g.n), 1.0 / g.n, np.float32)
    qb = ppr_teleport(g, seeds)
    row[f"batch_ppr_q{BATCH_Q}_{AB_DELTAS[-1]}_s"] = warm_s(lambda: ppr.solve_batch(x0, q=qb, delta=AB_DELTAS[-1]))
    print(json.dumps(row), flush=True)
    return 0


def restart_warm(work: str) -> int:
    """The restart path's second process: the solvers that
    ``work/restart.json`` names, each on its graph's ``.npz`` and the store
    at ``work/cache``, each answering its first query with its launch
    counts reset before the constructor and read after the solve.  Times
    the constructor (the graph's hash, the δ-models' load), the schedule's
    load and the solve.  The load splits into ``np.load`` of the store's
    files, the stripes' digests and their assembly on the host, the
    store's writes (a schedule assembled from stripes is saved whole), and
    the rest: the copy to the card and ``row_ptr`` derived there.  On the
    replicated graph it then times the schedule's load from its stripes
    alone, to the card, and checks it against the whole one.  Saves each x
    to ``work/warm_<name>.npy`` and prints one JSON row a solver."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.engine import DeviceSchedule, stripe_schedule_arrays
    from repro_torch.graphs.formats import CSRGraph
    from repro_torch.kernels import build
    from repro_torch.kernels.round_block import fused_halo_round_cuda, fused_round_cuda, fused_solve_cuda
    from repro_torch.persist import store as persist_store
    from repro_torch.solve import Solver, pagerank_problem, sssp_problem
    from repro_torch.solve import solver as solver_mod

    t0 = time.perf_counter()
    torch.cuda.init()
    build.load("round_block")  # built in this checkout by the first process
    setup_s = time.perf_counter() - t0
    timed = {k: {"s": 0.0, "bytes": 0} for k in ("read", "write", "digest", "assemble")}

    def timer(kind, fn, nbytes):
        def wrapped(*a):
            t1 = time.perf_counter()
            out = fn(*a)
            timed[kind]["s"] += time.perf_counter() - t1
            timed[kind]["bytes"] += nbytes(a, out)
            return out
        return wrapped

    persist_store._load_npz = timer(
        "read", persist_store._load_npz, lambda a, out: sum(v.nbytes for v in out.values()) if out else 0)
    persist_store._save_npz = timer(
        "write", persist_store._save_npz, lambda a, out: a[0].stat().st_size if a[0].exists() else 0)
    solver_mod.stripe_fingerprint = timer("digest", solver_mod.stripe_fingerprint, lambda a, out: 0)
    solver_mod.assemble_stripe_schedule = timer(
        "assemble", solver_mod.assemble_stripe_schedule, lambda a, out: out.src.nbytes)
    spec = json.loads((Path(work) / "restart.json").read_text())
    for part in spec:
        t0 = time.perf_counter()
        a = np.load(part["graph"])
        g = CSRGraph(int(a["n"]), a["indptr"], a["indices"], a["values"], name=part["name"])
        graph_s = time.perf_counter() - t0
        problem = pagerank_problem() if part["problem"] == "pagerank" else sssp_problem(source=part["source"])
        for t in timed.values():
            t.update(s=0.0, bytes=0)
        fused_solve_cuda.launches = fused_round_cuda.launches = fused_halo_round_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = Solver(g, problem, n_workers=P, cache_dir=str(Path(work) / "cache"), **part["kw"])
        t1 = time.perf_counter()
        sched = solver.schedule()
        if part["kw"].get("frontier") == "halo":
            solver.frontier_plan(sched)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r = solver.solve()
        t3 = time.perf_counter()
        np.save(Path(work) / f"warm_{part['name']}.npy", r.x)
        row = {
            "name": part["name"],
            "n": g.n,
            "nnz": g.nnz,
            "delta": r.delta,
            "rounds": r.rounds,
            "converged": r.converged,
            "flushes": r.flushes,
            "flush_bytes": r.flush_bytes,
            "time_to_first_answer_s": t3 - t0,
            "construct_s": t1 - t0,
            "load_s": t2 - t1,
            "npz_read_s": timed["read"]["s"],
            "npz_read_bytes": timed["read"]["bytes"],
            "stripe_digest_s": timed["digest"]["s"],
            "host_assemble_s": timed["assemble"]["s"],
            "write_s": timed["write"]["s"],
            "written_bytes": timed["write"]["bytes"],
            "to_card_s": t2 - t1 - sum(t["s"] for t in timed.values()),
            "solve_s": t3 - t2,
            "loop_s": r.total_time_s,
            "graph_load_s": graph_s,
            "process_setup_s": setup_s,
            "stats": solver.stats,
            "probe_model_loaded": solver.delta_model is not None,
            "loop_launches": fused_solve_cuda.launches,
            "k1_launches": fused_round_cuda.launches,
            "k2_launches": fused_halo_round_cuda.launches,
        }
        if part["name"] == "replicated":
            row.update(stripes_only_load(solver, sched, timed, stripe_schedule_arrays, DeviceSchedule))
        print(json.dumps(row), flush=True)
        del solver, sched, g, a
    return 0


def stripes_only_load(solver, whole, timed, stripe_schedule_arrays, DeviceSchedule) -> dict:
    """The restarted solver's schedule loaded from its P stripes alone (no
    whole-schedule entry), as far as the card, without saving it: what a
    store of stripes only would cost its warm first answer.  The result
    must equal the whole entry's schedule."""
    from repro_torch.graphs.formats import assemble_stripe_schedule
    from repro_torch.persist.keys import stripe_fingerprint

    for t in timed.values():
        t.update(s=0.0, bytes=0)
    bounds, graph, pad_val = solver.bounds, solver._sched_graph, solver.problem.semiring.pad_edge_val
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stripes = []
    for w in range(solver.n_workers):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        t1 = time.perf_counter()
        digest = stripe_fingerprint(graph, lo, hi, whole.S, whole.delta, pad_val)
        timed["digest"]["s"] += time.perf_counter() - t1
        stripes.append(solver.persist.load_stripe(digest))
    if any(st is None for st in stripes):
        return {"stripes_only_misses": sum(st is None for st in stripes)}
    t1 = time.perf_counter()
    host = assemble_stripe_schedule(graph, bounds, whole.delta, pad_val, stripes)
    t2 = time.perf_counter()
    sched = DeviceSchedule.from_host_arrays(stripe_schedule_arrays(host), whole.device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {
        "stripes_only_misses": 0,
        "stripes_only_load_s": t3 - t0,
        "stripes_only_npz_read_s": timed["read"]["s"],
        "stripes_only_npz_read_bytes": timed["read"]["bytes"],
        "stripes_only_digest_s": timed["digest"]["s"],
        "stripes_only_assemble_s": t2 - t1,
        "stripes_only_to_card_s": t3 - t2,
        "stripes_only_equal": all(torch.equal(getattr(sched, f), getattr(whole, f))
                                  for f in ("src", "val", "dst_local", "rows", "row_ptr")),
    }


def ab(others: list[str], scale: int) -> int:
    """The vector kernels of this checkout and of ``others`` (other
    checkouts, such as the parent commit's) on one card, in turns: the
    others, this, this, the others in reverse, each in its own process on
    one twitter graph."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.graphs.generators import make_graph

    log(f"[ab] card: {card_line()}")
    t0 = time.perf_counter()
    g = make_graph("twitter", scale=scale, efactor=EFACTOR, kind="pagerank")
    log(f"[ab] twitter s{scale}: n={g.n} nnz={g.nnz}; generated in {time.perf_counter() - t0:.1f} s")
    here = str(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "graph.npz")
        np.savez(npz, n=g.n, indptr=g.indptr, indices=g.indices, values=g.values)
        del g
        turns = [(f"other {o}", o) for o in others]
        for label, root in turns + [("this", here), ("this", here)] + turns[::-1]:
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--time-vector", npz, root],
                capture_output=True, text=True, timeout=900,
            )
            if out.returncode != 0:
                log(out.stderr[-3000:])
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            log(f"[ab] {label} {json.dumps(row)}")
    log(card_line())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=SCALE, help="full-size graph scale")
    ap.add_argument("--ab", nargs="+", metavar="CHECKOUT", help="only time the vector kernels against other checkouts'")
    ap.add_argument("--time-vector", nargs=2, metavar=("GRAPH_NPZ", "CHECKOUT"), help=argparse.SUPPRESS)
    ap.add_argument("--write-graph", nargs=2, metavar=("GRAPH_NPZ", "SCALE"), help=argparse.SUPPRESS)
    ap.add_argument("--restart-warm", metavar="WORK", help=argparse.SUPPRESS)
    args = ap.parse_args()
    scale = args.scale
    if args.write_graph:
        return write_graph(args.write_graph[0], int(args.write_graph[1]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.time_vector:
        return time_vector(*args.time_vector)
    if args.restart_warm:
        return restart_warm(args.restart_warm)
    if args.ab:
        return ab(args.ab, scale)
    # the full-size graph is generated in a child process meanwhile
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "graph.npz")
        gen = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--write-graph", npz, str(scale)])
        try:
            return smoke(scale, gen, npz)
        finally:
            if gen.poll() is None:
                gen.kill()
            gen.wait()


def write_graph(npz: str, scale: int) -> int:
    """Generate the full-size twitter graph (PageRank values) into ``npz``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.graphs.generators import make_graph

    g = make_graph("twitter", scale=scale, efactor=EFACTOR, kind="pagerank")
    np.savez(npz, n=g.n, indptr=g.indptr, indices=g.indices, values=g.values, name=g.name)
    return 0


def smoke(scale: int, gen: subprocess.Popen, npz: str) -> int:
    """Phases 1 to 5; ``gen`` writes the full-size graph into ``npz``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import engine
    from repro_torch.dist import engine_sharded
    from repro_torch.graphs.formats import CSRGraph
    from repro_torch.graphs.generators import make_graph, sssp_values
    from repro_torch.kernels import build, ops, ref, round_block
    from repro_torch.kernels.round_block import (
        Epilogue,
        fused_batch_round_cuda,
        fused_batch_solve_cuda,
        fused_halo_round_cuda,
        fused_round_cuda,
        fused_solve_cuda,
    )
    from repro_torch.kernels.spmv_ell import spmv_ell_cuda
    from repro_torch.persist import store as persist_store
    from repro_torch.solve import (
        BatchStepper,
        Solver,
        label_propagation_problem,
        labelprop_anchors,
        multi_source_x0,
        pagerank_problem,
        ppr_problem,
        ppr_teleport,
        rwr_embedding_problem,
        rwr_restart,
        sssp_problem,
    )
    from repro_torch.core.semiring import PLUS_TIMES
    from repro_torch.solve import batch as solve_batch_module
    from repro_torch.solve.problem import count_changed_residual, l1_residual

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    # ---------------------------------------------------------------- 1 ---
    t0 = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    for name, (secs, _) in build.build().items():
        log(f"[1] built {name}.cu in {secs:.2f} s")
    for name in build.SOURCES:
        build.load(name)
        log(f"[1] ptxas {name}.cu: {json.dumps(ptxas_summary(build.build_log(name)))}")
    log(f"[1] done in {time.perf_counter() - t0:.1f} s")

    def graphs(scale):
        g = make_graph("twitter", scale=scale, efactor=EFACTOR, kind="pagerank")
        # SSSP on the same topology: GAP-style integer weights in [1, 255]
        return g, g.with_values(sssp_values(g.indices), name=f"{g.name}-sssp")

    def problems(g_pr):
        hub = int(np.argmax(g_pr.out_degree))  # most-followed account
        return hub, {
            "pagerank": pagerank_problem(),
            "sssp": sssp_problem(source=hub),
        }, ppr_teleport(g_pr, [hub])[0]

    def matrix_solvers(g):
        """rwr and labelprop at F = 4 (the factories' default) on the twitter
        graph ``g``: labelprop on its topology with unit edges (its
        ``edge_values``), LABELPROP_ROUNDS rounds.  (A web graph of scale 22
        takes over two minutes to generate on the card's host.)"""
        lp = label_propagation_problem(max_rounds=LABELPROP_ROUNDS)
        return {
            "rwr": Solver(g, rwr_embedding_problem(), n_workers=P, n_shards=SHARDS),
            "labelprop": Solver(g, lp, n_workers=P, n_shards=SHARDS),
        }

    # ---------------------------------------------------------------- 2 ---
    max_abs_err = batch_err = 0.0
    compare_launches = 0

    def compare(label, sched, sr, epilogue, x_cpu, batch=False):
        """K1 (or, with ``batch``, its batch entry on an (n + 1, Q)+feat
        frontier) against its plain round, one round from the same x, bit for
        bit."""
        nonlocal max_abs_err, batch_err, compare_launches
        plain, kernel = ref.fused_round_ref, fused_round_cuda
        if batch:
            plain, kernel = ref.fused_batch_round_ref, fused_batch_round_cuda
        dsched = on(sched, dev)
        if x_cpu.dtype == torch.float32:
            want = plain(x_cpu, on(sched, "cpu"), sr, epilogue.to("cpu"))
        else:  # int32 min-plus is order-free: the plain round on the card is exact
            want = plain(x_cpu.to(dev), dsched, sr, epilogue.to(dev)).cpu()
        got = kernel(x_cpu.to(dev), dsched, sr, epilogue.to(dev)).cpu()
        compare_launches += 1
        a, b = got[:-1], want[:-1]
        err = float((a.double() - b.double()).abs().max().item())
        gap = ulp_gap(a, b) if a.dtype == torch.float32 else 0
        if batch:
            batch_err = max(batch_err, err)
        else:
            max_abs_err = max(max_abs_err, err)
        log(
            f"[2] {'batch ' if batch else ''}{label}: x={tuple(x_cpu.shape)} S={sched.S} M={sched.M} "
            f"max_abs_err={err} max_ulp={gap}"
        )
        if not torch.equal(a, b):
            raise AssertionError(f"K1{' (batch entry)' if batch else ''} disagrees with its plain version: {label}")
        return err

    def compare_all(tag, solvers, q, rng, deltas):
        """K1 vs plain for every epilogue; ``deltas[name]`` lists the δ of each
        solver (ppr runs on the pagerank schedules)."""
        pr, ss = solvers["pagerank"], solvers["sssp"]
        x_f = torch.tensor(rng.random(pr.graph.n + 1).astype(np.float32))
        x_i = torch.tensor(rng.integers(0, 5000, ss.graph.n + 1).astype(np.int32))
        x_i[torch.tensor(rng.random(ss.graph.n + 1) < 0.3)] = 2**30 - 1
        ppr_ep = ppr_problem().make_row_update(pr.graph, q, dev)
        for d in deltas["pagerank"]:
            sp = pr.schedule(d)
            compare(f"{tag} pagerank add_const δ={d}", sp, pr.problem.semiring, pr.row_update(), x_f)
            compare(f"{tag} ppr add_table δ={d}", sp, pr.problem.semiring, ppr_ep, x_f)
        for d in deltas["sssp"]:
            compare(f"{tag} sssp min_old δ={d}", ss.schedule(d), ss.problem.semiring, ss.row_update(), x_i)

    halo_err = 0.0

    def compare_halo(label, solver, sched, epilogue, x_cpu, wires=None, quant_rounds=3):
        """K2, one launch a round, against the plain halo round on the
        stacked (D, L) frontier: x_loc outside the dump slots and ef, bit for
        bit; one f32 round, and for plus-times ``quant_rounds`` int8 and fp8
        rounds, each wire (of ``wires``, default all) from the same x and
        zero residuals."""
        nonlocal halo_err, compare_launches
        worst = 0.0
        sr = solver.problem.semiring
        plan = solver.frontier_plan(sched)
        is_f32 = x_cpu.dtype == torch.float32
        # int32 min-plus is order-free: the plain round on the card is exact
        p_dev = "cpu" if is_f32 else dev
        p_sched, p_plan, p_ep = on(sched, p_dev), on(plan, p_dev), epilogue.to(p_dev)
        for wire in (wires or engine_sharded.HALO_DTYPES) if is_f32 else ("f32",):
            feat = tuple(x_cpu.shape[1:])
            want = (p_plan.scatter_x(x_cpu.to(p_dev)), engine_sharded.frontier_ef_init(p_plan, feat))
            got = (plan.scatter_x(x_cpu.to(dev)), engine_sharded.frontier_ef_init(plan, feat))
            for k in range(1 if wire == "f32" else quant_rounds):
                ref.fused_halo_round_ref(*want, p_sched, p_plan, sr, p_ep, wire)
                fused_halo_round_cuda(*got, sched, plan, sr, epilogue.to(dev), wire)
                compare_launches += 1
                a, b = got[0][:, :-1].cpu(), want[0][:, :-1].cpu()
                ea, eb = got[1].cpu(), want[1].cpu()
                err = float((a.double() - b.double()).abs().max().item())
                err = max(err, float((ea.double() - eb.double()).abs().max().item()))
                gap = ulp_gap(a, b) if is_f32 else 0
                halo_err = max(halo_err, err)
                worst = max(worst, err)
                log(
                    f"[2] K2 {label} {wire} round {k + 1}: S={sched.S} D={plan.D} L={plan.L} "
                    f"H={plan.H} max_abs_err={err} max_ulp={gap} ef_max_ulp={ulp_gap(ea, eb)}"
                )
                if not (torch.equal(a, b) and torch.equal(ea, eb)):
                    raise AssertionError(f"K2 disagrees with its plain round: {label} {wire} round {k + 1}")
        return worst

    matrix_err = {"round_block": 0.0, "halo_round": 0.0}

    def compare_matrix(tag, solvers, rng, deltas, wires=None):
        """K1, and K2 on the (D, L, F) layout (one f32 round, three int8 and
        three fp8), at F = 4 against their plain versions, for each matrix
        problem's own row update (rwr: add_table over its (n + 1, 4)
        restart table; labelprop: its anchors) and schedule."""
        for name, solver in solvers.items():
            ep, sr = solver.row_update(), solver.problem.semiring
            for d in deltas:
                sched = solver.schedule(d)
                x = rng.random((solver.graph.n + 1, solver.problem.feature_dim)).astype(np.float32)
                if name == "labelprop":  # rows of zeros: totals of 0 keep old
                    x[rng.random(x.shape[0]) < 0.2] = 0.0
                x = torch.tensor(x)
                label = f"{tag} {name} {ep.tag} F={x.shape[1]} δ={sched.delta}"
                err = compare(label, sched, sr, ep, x)
                matrix_err["round_block"] = max(matrix_err["round_block"], err)
                err = compare_halo(label, solver, sched, ep, x, wires)
                matrix_err["halo_round"] = max(matrix_err["halo_round"], err)

    def compare_halo_all(tag, solvers, q, rng, deltas, quant_rounds=3):
        pr, ss = solvers["pagerank"], solvers["sssp"]
        x_f = torch.tensor(rng.random(pr.graph.n + 1).astype(np.float32))
        x_i = torch.tensor(rng.integers(0, 5000, ss.graph.n + 1).astype(np.int32))
        x_i[torch.tensor(rng.random(ss.graph.n + 1) < 0.3)] = 2**30 - 1
        ppr_ep = ppr_problem().make_row_update(pr.graph, q, dev)
        for d in deltas:
            sp = pr.schedule(d)
            compare_halo(f"{tag} pagerank add_const δ={d}", pr, sp, pr.row_update(), x_f, quant_rounds=quant_rounds)
            compare_halo(f"{tag} ppr add_table δ={d}", pr, sp, ppr_ep, x_f, quant_rounds=quant_rounds)
            compare_halo(f"{tag} sssp min_old δ={d}", ss, ss.schedule(d), ss.row_update(), x_i)

    def compare_batch_all(tag, pr, ss, mats, deltas):
        """The batch entry for ppr (Q = BATCH_Q teleports, on pagerank's
        schedules) and multi-source sssp (Q = BATCH_Q), and rwr and labelprop
        (Q = BATCH_Q_MATRIX, F = 4); ``deltas[name]`` lists each one's δ."""
        g = pr.graph
        ppr_ep = Solver(g, ppr_problem(), n_workers=P).batch_row_update(
            ppr_teleport(g, top_out_degree(g, BATCH_Q)), BATCH_Q, ()
        )
        X = torch.tensor(rng.random((g.n + 1, BATCH_Q)).astype(np.float32))
        for d in deltas["pagerank"]:
            compare(f"{tag} ppr add_table Q={BATCH_Q} δ={d}", pr.schedule(d), pr.problem.semiring, ppr_ep, X, True)
        Xi = torch.tensor(rng.integers(0, 5000, (ss.graph.n + 1, BATCH_Q)).astype(np.int32))
        Xi[torch.tensor(rng.random(Xi.shape) < 0.3)] = 2**30 - 1
        for d in deltas["sssp"]:
            ep = ss.batch_row_update(None, BATCH_Q, ())
            compare(f"{tag} sssp min_old Q={BATCH_Q} δ={d}", ss.schedule(d), ss.problem.semiring, ep, Xi, True)
        for name, solver in mats.items():
            n, F = solver.graph.n, solver.problem.feature_dim
            make = rwr_restart if name == "rwr" else labelprop_anchors
            q = np.stack([make(solver.graph, rng.choice(n, F, replace=False)) for _ in range(BATCH_Q_MATRIX)])
            ep = solver.batch_row_update(q, BATCH_Q_MATRIX, (F,))
            x = rng.random((n + 1, BATCH_Q_MATRIX, F)).astype(np.float32)
            if name == "labelprop":  # rows of zeros: totals of 0 keep old
                x[rng.random(n + 1) < 0.2] = 0.0
            for d in deltas[name]:
                label = f"{tag} {name} {ep.tag} Q={BATCH_Q_MATRIX} F={F} δ={d}"
                compare(label, solver.schedule(d), solver.problem.semiring, ep, torch.tensor(x), True)

    loop_err = {"solve": 0.0, "solve_f4": 0.0, "batch": 0.0}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def compare_loop(label, key, sched, sr, ep, residual, x, tol, max_rounds, batch=False, conv0=None,
                     plain_on_card=False):
        """K1's loop entry (one launch) against its plain loop from the same x:
        x bit for bit; rounds, flags and rounds_per_query exactly; a count
        residual exactly, and an l1 residual within d·2⁻²⁴/(1 − d·2⁻²⁴) of
        the float64 sum of the plain round's float32 terms (the same terms
        as the kernel's), d the kernel's summation depth
        (``loop_sum_depth``).  The plain loop runs on the CPU, or with
        ``plain_on_card`` (int32 min-plus, order-free) on the card.
        Returns the kernel's result."""
        nonlocal compare_launches
        p_dev = dev if plain_on_card else "cpu"
        p_sched, p_ep = on(sched, p_dev), ep.to(p_dev)
        sums = []  # each plain round's float64 sum of its l1 terms, a query

        def l1_f64(x_prev, x_new, dim=None):
            t = (x_new - x_prev).abs().double()
            sums.append(np.atleast_1d((t.sum() if dim is None else t.sum(dim=dim)).cpu().numpy()))
            return residual(x_prev, x_new, dim)

        plain_res = l1_f64 if residual is l1_residual else residual
        Q = x.shape[1] if batch else 1
        if batch:
            want = ref.fused_batch_solve_ref(x.to(p_dev), p_sched, sr, p_ep, plain_res, tol, max_rounds, conv0)
            got = fused_batch_solve_cuda(x.to(dev), on(sched, dev), sr, ep.to(dev), residual, tol, max_rounds, conv0)
        else:
            want = ref.fused_solve_ref(x.to(p_dev), p_sched, sr, p_ep, plain_res, tol, max_rounds)
            got = fused_solve_cuda(x.to(dev), on(sched, dev), sr, ep.to(dev), residual, tol, max_rounds)
        compare_launches += 1
        a, b = got[0][:-1].cpu(), want[0][:-1].cpu()
        err = float((a.double() - b.double()).abs().max().item())
        loop_err[key] = max(loop_err[key], err)
        res_a, res_b = np.atleast_1d(got[1]), np.atleast_1d(want[1])
        fin = np.isfinite(res_b)
        if residual is count_changed_residual:
            rtol, exact = 0.0, res_b.astype(np.float64)
        else:  # each query's residual is that of its last round, or of the round it froze on
            d = loop_sum_depth(sched, int(np.prod(x.shape[1:], dtype=np.int64)), Q, sms)
            rtol = d * 2.0**-24 / (1 - d * 2.0**-24)
            rpq = np.atleast_1d(want[4]) if conv0 is not None else np.zeros(Q, np.int64)
            exact = np.array([sums[k - 1][i] if k > 0 else sums[-1][i] for i, k in enumerate(rpq)]) if sums \
                else np.full(Q, np.inf)
        gap = np.abs(res_a[fin].astype(np.float64) - exact[fin]) / np.maximum(np.abs(exact[fin]), 1e-38)
        same = (
            torch.equal(a, b)
            and got[2] == want[2]
            and np.array_equal(np.atleast_1d(got[3]), np.atleast_1d(want[3]))
            and (not batch or np.array_equal(got[4], want[4]))
            and np.array_equal(np.isfinite(res_a), fin)
            and bool((gap <= rtol).all())
        )
        log(
            f"[2] loop {label}: x={tuple(x.shape)} S={sched.S} rounds={got[2]}/{want[2]} "
            f"converged={np.atleast_1d(got[3]).tolist()} "
            + (f"rounds_per_query={got[4].tolist()} " if batch else "")
            + f"max_abs_err={err} residual_rel_gap={float(gap.max()) if gap.size else 0.0} rtol={rtol}"
        )
        if not same:
            raise AssertionError(f"K1's loop entry disagrees with its plain loop: {label}")
        return got

    def compare_loops(tag, pr, ss, rwr, deltas, budget=None, vector_only=False):
        """The loop entry against its plain loops at ``deltas``: PageRank,
        SSSP, rwr (F = 4) and a ppr batch of Q = BATCH_Q, to convergence, or
        with ``budget`` over that many rounds (tol = -1; SSSP's plain loop on
        the card, to convergence); without a budget also a budget cut
        (PageRank, LOOP_BUDGET_CUT rounds) and three quanta of 4 rounds of an
        open ppr batch whose every third query starts converged.  With
        ``vector_only``, PageRank and SSSP alone."""
        g = pr.graph
        seeds = top_out_degree(g, BATCH_Q)
        ppr_ep = Solver(g, ppr_problem(), n_workers=P).batch_row_update(ppr_teleport(g, seeds), BATCH_Q, ())
        X = engine.extend_frontier(np.full((g.n, BATCH_Q), 1.0 / g.n, np.float32), PLUS_TIMES, "cpu")
        stop = (lambda solver: (-1.0, budget)) if budget else (lambda solver: (solver.tol, solver.max_rounds))
        for d in deltas:
            for name, solver, key in (("pagerank", pr, "solve"), ("rwr", rwr, "solve_f4"))[: 1 if vector_only else 2]:
                sr = solver.problem.semiring
                x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, "cpu")
                compare_loop(f"{tag} {name} δ={d}", key, solver.schedule(d), sr, solver.row_update(),
                             solver.problem.residual, x, *stop(solver))
            sr = ss.problem.semiring
            x = engine.extend_frontier(ss.problem.x0(ss.graph), sr, "cpu")
            compare_loop(f"{tag} sssp δ={d}", "solve", ss.schedule(d), sr, ss.row_update(), ss.problem.residual,
                         x, ss.tol, ss.max_rounds, plain_on_card=budget is not None)
            if vector_only:
                continue
            sp = pr.schedule(d)
            tol, mr = (-1.0, budget) if budget else (pr.tol, pr.max_rounds)
            compare_loop(f"{tag} ppr Q={BATCH_Q} δ={d}", "batch", sp, PLUS_TIMES, ppr_ep, l1_residual, X, tol, mr,
                         batch=True)
            if budget:
                continue
            x = engine.extend_frontier(pr.problem.x0(g), PLUS_TIMES, "cpu")
            compare_loop(f"{tag} pagerank budget cut δ={d}", "solve", sp, PLUS_TIMES, pr.row_update(), l1_residual,
                         x, -1.0, LOOP_BUDGET_CUT)
            Xq, conv = X, np.arange(BATCH_Q) % 3 == 1
            for k in range(3):
                got = compare_loop(f"{tag} open ppr Q={BATCH_Q} quantum {k + 1} δ={d}", "batch", sp, PLUS_TIMES,
                                   ppr_ep, l1_residual, Xq, pr.tol, 4, batch=True, conv0=conv)
                Xq, conv = got[0].cpu(), got[3]

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    sg_pr, sg_ss = graphs(SMALL_SCALE)
    _, s_probs, s_q = problems(sg_pr)
    small = {
        "pagerank": Solver(sg_pr, s_probs["pagerank"], n_workers=P, n_shards=SHARDS),
        "sssp": Solver(sg_ss, s_probs["sssp"], n_workers=P, n_shards=SHARDS),
    }
    compare_all(f"s{SMALL_SCALE}", small, s_q, rng, dict.fromkeys(small, DELTAS))
    log(f"[2] small graphs done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    hg_pr, hg_ss = graphs(HALO_SCALE)
    _, h_probs, h_q = problems(hg_pr)
    mid = {
        "pagerank": Solver(hg_pr, h_probs["pagerank"], n_workers=P, n_shards=SHARDS),
        "sssp": Solver(hg_ss, h_probs["sssp"], n_workers=P, n_shards=SHARDS),
    }
    compare_halo_all(f"s{HALO_SCALE}", mid, h_q, rng, DELTAS)
    mid_mat = matrix_solvers(hg_pr)
    compare_matrix(f"s{HALO_SCALE}", mid_mat, rng, ("sync", 128))
    mid_deltas = dict.fromkeys(("pagerank", "sssp", *mid_mat), ("sync", 128))
    compare_batch_all(f"s{HALO_SCALE}", mid["pagerank"], mid["sssp"], mid_mat, mid_deltas)
    log(f"[2] K2, K1 and K2 at F = 4, K1's batch entry, at s{HALO_SCALE} done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    compare_loops(f"s{HALO_SCALE}", mid["pagerank"], mid["sssp"], mid_mat["rwr"], ("sync", 128))
    del mid, mid_mat
    log(f"[2] K1's loop entry at s{HALO_SCALE} done in {time.perf_counter() - t0:.1f} s")

    # the quantized halo's rounding must not depend on the device
    t0 = time.perf_counter()
    pr = small["pagerank"]
    cpu_pr = Solver(pr.graph, pr.problem, n_workers=P, n_shards=SHARDS, device="cpu")
    for hd in engine_sharded.HALO_DTYPES:
        kw = dict(delta="async", frontier="halo", halo_dtype=hd, tol=QUANT_TOL)
        card_r, cpu_r = pr.solve(**kw), cpu_pr.solve(**kw)
        same = card_r.rounds == cpu_r.rounds and np.array_equal(card_r.x, cpu_r.x)
        log(
            f"[2] s{SMALL_SCALE} pagerank halo {hd} δ={card_r.delta}: kernel vs plain (cpu) "
            f"rounds {card_r.rounds}/{cpu_r.rounds} same={same}"
        )
        if not same:
            raise AssertionError(f"halo kernel solve differs from the plain one: {hd}")
    log(f"[2] s{SMALL_SCALE} halo parity done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    if gen.wait() != 0:
        raise RuntimeError(f"generating the twitter s{scale} graph failed ({gen.returncode})")
    a = np.load(npz)
    g_pr = CSRGraph(int(a["n"]), a["indptr"], a["indices"], a["values"], name=str(a["name"]))
    g_ss = g_pr.with_values(sssp_values(g_pr.indices), name=f"{g_pr.name}-sssp")
    del a
    hub, probs, q = problems(g_pr)
    log(
        f"[2] twitter s{scale}: n={g_pr.n} nnz={g_pr.nnz}, sssp source {hub} "
        f"(out-degree {int(g_pr.out_degree[hub])}); generated beside phases 1 and 2, "
        f"waited {time.perf_counter() - t0:.1f} s for it (total {time.perf_counter() - t_all:.1f} s)"
    )
    t0 = time.perf_counter()
    indeg = np.diff(g_pr.indptr)
    log(
        f"[2] twitter s{scale}: largest in-degree (CSR row) {int(indeg.max())}, "
        f"mean {float(indeg.mean()):.2f}; largest out-degree {int(g_pr.out_degree.max())}"
    )
    full = {
        name: Solver(g, probs[name], n_workers=P, n_shards=SHARDS)
        for name, g in (("pagerank", g_pr), ("sssp", g_ss))
    }
    compare_all(f"s{scale}", full, q, rng, dict.fromkeys(full, DELTAS))
    log(f"[2] full size done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mfull = matrix_solvers(g_pr)
    compare_loops(f"s{scale}", full["pagerank"], full["sssp"], mfull["rwr"], ("sync",), LOOP_BUDGET)
    log(f"[2] K1's loop entry at full size done in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- 3 ---
    t0 = time.perf_counter()
    resolved = {name: set() for name in full}  # every δ the main path ran
    replicated = {}  # (problem, δ) → the replicated solve's result
    fused_round_cuda.launches = 0
    fused_solve_cuda.launches = 0
    for name, solver in full.items():
        # auto twice: the first call also runs the sync and async probes
        # (one loop launch each), fits the δ model and builds δ*'s schedule;
        # the second is warm
        for d in ("sync", "async", 1024, "auto", "auto"):
            before = fused_solve_cuda.launches
            probes = 2 if d == "auto" and solver.delta_model is None else 0
            builds = solver.stats["schedule_builds"]
            t1 = time.perf_counter()
            r = solver.solve(delta=d, backend="kernel")
            secs = time.perf_counter() - t1
            row = {
                "problem": name,
                "graph": solver.graph.name,
                "delta_arg": d,
                "delta": r.delta,
                "S": r.flushes // r.rounds,
                "rounds": r.rounds,
                "converged": r.converged,
                "flushes": r.flushes,
                "flush_bytes": r.flush_bytes,
                "schedule_builds": solver.stats["schedule_builds"] - builds,
                "total_s": secs,
                "loop_s": r.total_time_s,
                "ms_per_round": r.total_time_s / r.rounds * 1e3,
                "residuals": r.residuals,
                "round_times": len(r.round_times_s),
                "launches": fused_solve_cuda.launches - before,
                "probe_launches": probes,
            }
            resolved[name].add(r.delta)
            replicated[(name, r.delta)] = r
            log(f"[3] solve {json.dumps(row)}")
            if row["launches"] != 1 + probes or len(r.residuals) != 1 or r.round_times_s:
                raise AssertionError(f"the solve was not one launch of K1's loop entry: {row}")
            if not (r.converged and np.isfinite(r.x.astype(np.float64)).all()):
                raise AssertionError(f"solve did not converge to finite values: {row}")
    main_launches = fused_solve_cuda.launches
    if main_launches == 0 or fused_round_cuda.launches != 0:
        raise AssertionError(
            f"the main path launched K1's loop entry {main_launches} times and K1 {fused_round_cuda.launches} times"
        )
    log(f"[3] main path: {main_launches} launches of K1's loop entry, 0 of K1; done in {time.perf_counter() - t0:.1f} s")

    # each warm solve in its parts, beside the host loop over single K1 launches
    t0 = time.perf_counter()
    fused_round_cuda.launches = 0
    for name, solver in full.items():
        sr, residual = solver.problem.semiring, solver.problem.residual
        for d in sorted(resolved[name]):
            sched = solver.schedule(d)
            t1 = time.perf_counter()
            warm = solver.solve(delta=d)
            total_s = time.perf_counter() - t1
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x_ext = engine.extend_frontier(solver.problem.x0(solver.graph), sr, dev)
            ep = solver.row_update()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out, res, rounds, converged = ops.fused_solve(x_ext, sched, sr, ep, residual, solver.tol, solver.max_rounds)
            t3 = time.perf_counter()
            x_host = out[:-1].cpu().numpy()
            t4 = time.perf_counter()
            before = fused_round_cuda.launches
            t5 = time.perf_counter()
            host = engine.host_loop(
                lambda x: ops.fused_round(x, sched, sr, ep), sched, sr, x_ext, residual, solver.tol, solver.max_rounds
            )
            host_s = time.perf_counter() - t5
            row = {
                "problem": name,
                "delta": d,
                "S": sched.S,
                "rounds": rounds,
                "total_s": total_s,
                "setup_s": t2 - t1,
                "loop_s": t3 - t2,
                "copy_out_s": t4 - t3,
                "other_s": total_s - (t4 - t1),
                "loop_ms_per_round": (t3 - t2) / rounds * 1e3,
                "host_loop_s": host_s,
                "host_loop_rounds_s": host.total_time_s,
                "host_loop_ms_per_round": host.total_time_s / host.rounds * 1e3,
                "host_over_loop": host_s / (t3 - t2),
                "k1_launches": fused_round_cuda.launches - before,
                "equal": bool(
                    host.rounds == rounds == warm.rounds
                    and np.array_equal(host.x, x_host)
                    and np.array_equal(warm.x, x_host)
                ),
            }
            log(f"[3] loop vs host loop {json.dumps(row)}")
            if not row["equal"] or row["k1_launches"] != host.rounds:
                raise AssertionError(f"the loop entry and the host loop differ: {row}")
    host_launches = fused_round_cuda.launches
    log(f"[3] host loop: {host_launches} K1 launches; done in {time.perf_counter() - t0:.1f} s")

    # K1 vs plain at the δ the main path resolved beyond phase 2's (auto's δ*)
    t0 = time.perf_counter()
    compared = {name: {solver.resolve_delta(d) for d in DELTAS} for name, solver in full.items()}
    extra = {name: sorted(resolved[name] - compared[name]) for name in full}
    compare_all(f"s{scale}", full, q, rng, extra)
    compare_loops(f"s{scale}", full["pagerank"], full["sssp"], mfull["rwr"], extra["pagerank"], LOOP_BUDGET,
                  vector_only=True)
    log(f"[3] K1 and its loop entry vs plain at the main path's other δ {extra}; "
        f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name, solver in small.items():
        card_r = solver.solve(delta="async", backend="kernel")
        plain = Solver(solver.graph, solver.problem, n_workers=P, device="cpu")
        cpu_r = plain.solve(delta="async", backend="torch")
        same = card_r.rounds == cpu_r.rounds and np.array_equal(card_r.x, cpu_r.x)
        log(f"[3] s{SMALL_SCALE} {name} kernel vs plain (cpu): rounds {card_r.rounds}/{cpu_r.rounds} same={same}")
        if not same:
            raise AssertionError(f"kernel solve differs from plain solve: {name}")
    log(f"[3] small parity done in {time.perf_counter() - t0:.1f} s")

    # the halo path: D shards on the card, one K2 launch a round
    t0 = time.perf_counter()
    dstar = {name: solver.resolve_delta("auto") for name, solver in full.items()}
    for name, solver in full.items():  # plans are set-up, built before the count
        for d in ("sync", dstar[name]):
            t1 = time.perf_counter()
            sched = solver.schedule(d)
            plan = solver.frontier_plan(sched)
            # and one round each, so first allocations fall outside the solves
            x = engine.extend_frontier(solver.problem.x0(solver.graph), solver.problem.semiring, dev)
            engine_sharded.frontier_kernel_round_ext_fn(
                sched, plan, solver.problem.semiring, solver.row_update()
            )(x, engine_sharded.frontier_ef_init(plan))
            torch.cuda.synchronize()
            log(
                f"[3] halo plan {name} δ={plan.delta}: built in {time.perf_counter() - t1:.2f} s; "
                f"S={plan.S} D={plan.D} L={plan.L} H={plan.H} "
                f"halo_sizes={plan.halo_sizes.tolist()} "
                f"boundary_entries_per_round={plan.boundary_entries_per_round} "
                f"halo_bytes_per_round={plan.halo_bytes_per_round()} "
                f"replicated_bytes_per_round={plan.replicated_bytes_per_round()}"
            )
    fused_halo_round_cuda.launches = 0
    for name, solver in full.items():
        for d in ("sync", dstar[name]):
            for hd in ("f32", "int8", "fp8") if name == "pagerank" else ("f32",):
                kw = {} if hd == "f32" else {"tol": QUANT_TOL}
                before = fused_halo_round_cuda.launches
                t1 = time.perf_counter()
                r = solver.solve(delta=d, backend="kernel", frontier="halo", halo_dtype=hd, **kw)
                secs = time.perf_counter() - t1
                launches = fused_halo_round_cuda.launches - before
                rep = replicated[(name, r.delta)]
                plan = solver.frontier_plan(solver.schedule(d))
                row = {
                    "problem": name,
                    "halo_dtype": hd,
                    "delta": r.delta,
                    "S": plan.S,
                    "D": plan.D,
                    "rounds": r.rounds,
                    "converged": r.converged,
                    "flushes": r.flushes,
                    "flush_bytes": r.flush_bytes,
                    "total_s": secs,
                    "rounds_s": r.total_time_s,
                    "ms_per_round": r.total_time_s / r.rounds * 1e3,
                    "replicated_ms_per_round": rep.total_time_s / rep.rounds * 1e3,
                    "last_residual": r.residuals[-1],
                    "launches": launches,
                }
                if hd == "f32":
                    row["equals_replicated"] = (
                        (r.rounds, r.flushes, r.flush_bytes) == (rep.rounds, rep.flushes, rep.flush_bytes)
                        and np.array_equal(r.x, rep.x)
                    )
                else:
                    # against the converged f32 answer, and against the f32
                    # halo solve stopped at the same tolerance (what the
                    # quantized wire itself costs)
                    same_tol = solver.solve(delta=d, frontier="halo", tol=QUANT_TOL)
                    for tag, f32 in (("", rep), ("_same_tol", same_tol)):
                        gap = np.abs(r.x.astype(np.float64) - f32.x.astype(np.float64))
                        row[f"max_gap_vs_f32{tag}"] = float(gap.max())
                        row[f"rel_l1_gap_vs_f32{tag}"] = float(gap.sum() / np.abs(f32.x.astype(np.float64)).sum())
                    row["f32_rounds_same_tol"] = same_tol.rounds
                    floor = solver.solve(
                        delta=d, frontier="halo", halo_dtype=hd, max_rounds=FLOOR_ROUNDS
                    )
                    row["residual_floor"] = min(floor.residuals)
                    row["floor_rounds"] = floor.rounds
                log(f"[3] halo solve {json.dumps(row)}")
                if row["launches"] != r.rounds:
                    raise AssertionError(f"the halo solve did not launch K2 once a round: {row}")
                if not (r.converged and np.isfinite(r.x.astype(np.float64)).all()):
                    raise AssertionError(f"halo solve did not converge to finite values: {row}")
                if hd == "f32" and not row["equals_replicated"]:
                    raise AssertionError(f"the f32 halo solve differs from the replicated one: {row}")
    halo_launches = fused_halo_round_cuda.launches
    if halo_launches == 0:
        raise AssertionError("the halo path never launched K2")
    log(f"[3] halo path: {halo_launches} K2 launches; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    # one round of each quantized wire at full size (three at s16)
    compare_halo_all(f"s{scale}", full, q, rng, ["sync"], quant_rounds=1)
    pr = full["pagerank"]
    x_f = torch.tensor(rng.random(pr.graph.n + 1).astype(np.float32))
    for name, solver in full.items():  # at δ*, which may differ per problem
        if name == "pagerank":
            sp = solver.schedule(dstar[name])
            compare_halo(f"s{scale} pagerank add_const δ={sp.delta}", solver, sp, solver.row_update(), x_f,
                         quant_rounds=1)
            ppr_ep = ppr_problem().make_row_update(solver.graph, q, dev)
            compare_halo(f"s{scale} ppr add_table δ={sp.delta}", solver, sp, ppr_ep, x_f, quant_rounds=1)
        else:
            x_i = torch.tensor(rng.integers(0, 5000, solver.graph.n + 1).astype(np.int32))
            x_i[torch.tensor(rng.random(solver.graph.n + 1) < 0.3)] = 2**30 - 1
            sp = solver.schedule(dstar[name])
            compare_halo(f"s{scale} sssp min_old δ={sp.delta}", solver, sp, solver.row_update(), x_i)
    log(f"[3] K2 vs plain at full size done in {time.perf_counter() - t0:.1f} s")

    # the matrix path: rwr and labelprop (F = 4) on the same topology (labelprop
    # with unit edges), replicated (K1) and halo (K2) at sync and δ*
    t0 = time.perf_counter()
    mstar = {}
    for name, solver in mfull.items():  # set-up: the auto probe, schedules, plans
        t1 = time.perf_counter()
        mstar[name] = solver.resolve_delta("auto")
        for d in ("sync", mstar[name]):
            solver.frontier_plan(solver.schedule(d))
        log(f"[3] matrix {name}: δ*={mstar[name]}, probes and plans in {time.perf_counter() - t1:.1f} s")
    fused_round_cuda.launches = 0
    fused_solve_cuda.launches = 0
    fused_halo_round_cuda.launches = 0
    matrix_rows = []
    for name, solver in mfull.items():
        for d in ("sync", mstar[name]):
            rep = None
            for frontier in ("replicated", "halo"):
                before = (fused_solve_cuda.launches, fused_halo_round_cuda.launches, fused_round_cuda.launches)
                t1 = time.perf_counter()
                r = solver.solve(delta=d, frontier=frontier)
                secs = time.perf_counter() - t1
                loops = fused_solve_cuda.launches - before[0]
                k2 = fused_halo_round_cuda.launches - before[1]
                k1 = fused_round_cuda.launches - before[2]
                row = {
                    "problem": name,
                    "F": int(r.x.shape[1]),
                    "frontier": frontier,
                    "delta": r.delta,
                    "S": r.flushes // r.rounds,
                    "rounds": r.rounds,
                    "converged": r.converged,
                    "flushes": r.flushes,
                    "flush_bytes": r.flush_bytes,
                    "total_s": secs,
                    "rounds_s": r.total_time_s,
                    "ms_per_round": r.total_time_s / r.rounds * 1e3,
                    "last_residual": r.residuals[-1],
                    "loop_launches": loops,
                    "k2_launches": k2,
                    "k1_launches": k1,
                }
                if frontier == "replicated":
                    rep = r
                else:
                    row["equals_replicated"] = (
                        (r.rounds, r.flushes, r.flush_bytes) == (rep.rounds, rep.flushes, rep.flush_bytes)
                        and np.array_equal(r.x, rep.x)
                    )
                matrix_rows.append(row)
                log(f"[3] matrix solve {json.dumps(row)}")
                want = (1, 0, 0) if frontier == "replicated" else (0, r.rounds, 0)
                if (loops, k2, k1) != want:
                    raise AssertionError(f"the matrix solve did not launch its kernel as it should: {row}")
                if not (r.x.shape == (solver.graph.n, 4) and np.isfinite(r.x).all()):
                    raise AssertionError(f"matrix solve did not give finite (n, 4) values: {row}")
                if name == "rwr" and not r.converged:
                    raise AssertionError(f"the rwr solve did not converge: {row}")
                if frontier == "halo" and not row["equals_replicated"]:
                    raise AssertionError(f"the f32 halo matrix solve differs from the replicated one: {row}")
    matrix_launches = {"round_block_solve": fused_solve_cuda.launches, "halo_round": fused_halo_round_cuda.launches}
    if min(matrix_launches.values()) == 0 or fused_round_cuda.launches:
        raise AssertionError(f"the matrix path missed a kernel or launched K1: {matrix_launches}")
    log(f"[3] matrix path: {matrix_launches} launches; done in {time.perf_counter() - t0:.1f} s")

    # the replicated matrix solves through the host loop over single K1 launches
    t0 = time.perf_counter()
    fused_round_cuda.launches = 0
    for name, solver in mfull.items():
        sr, residual = solver.problem.semiring, solver.problem.residual
        for d in ("sync", mstar[name]):
            sched = solver.schedule(d)
            rep = solver.solve(delta=d)
            ep = solver.row_update()
            x_ext = engine.extend_frontier(solver.problem.x0(solver.graph), sr, dev)
            host = engine.host_loop(
                lambda x: ops.fused_round(x, sched, sr, ep), sched, sr, x_ext, residual, solver.tol, solver.max_rounds
            )
            equal = host.rounds == rep.rounds and np.array_equal(host.x, rep.x)
            log(
                f"[3] matrix {name} δ={sched.delta}: host loop rounds {host.rounds} in {host.total_time_s:.4f} s, "
                f"loop rounds {rep.rounds} in {rep.total_time_s:.4f} s, equal={equal}"
            )
            if not equal:
                raise AssertionError(f"the matrix loop entry and the host loop differ: {name} δ={d}")
    matrix_launches["round_block"] = fused_round_cuda.launches
    log(f"[3] matrix host loop: {fused_round_cuda.launches} K1 launches; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_matrix(f"s{scale}", mfull, rng, ("sync",), wires=("f32",))  # int8/fp8 at F = 4: s16
    s_mat = matrix_solvers(sg_pr)
    for name, solver in s_mat.items():
        plain = Solver(solver.graph, solver.problem, n_workers=P, n_shards=SHARDS, device="cpu")
        for frontier in ("replicated", "halo"):
            card_r = solver.solve(delta="async", frontier=frontier)
            cpu_r = plain.solve(delta="async", frontier=frontier)
            same = (card_r.rounds, card_r.flush_bytes) == (cpu_r.rounds, cpu_r.flush_bytes) and np.array_equal(
                card_r.x, cpu_r.x
            )
            log(
                f"[3] s{SMALL_SCALE} {name} {frontier} kernel vs plain (cpu): "
                f"rounds {card_r.rounds}/{cpu_r.rounds} same={same}"
            )
            if not same:
                raise AssertionError(f"matrix kernel solve differs from the plain solve: {name} {frontier}")
    log(f"[3] F = 4 kernels vs plain at full size, small parity: done in {time.perf_counter() - t0:.1f} s")

    # the batch path: Solver.solve_batch (one K1 batch launch a round) for ppr
    # and multi-source sssp at Q = BATCH_Q from the vertices of largest
    # out-degree, at sync and δ*, ppr at Q = BATCH_Q_WIDE at δ*, and an open
    # batch (BatchStepper) at HALO_SCALE
    t0 = time.perf_counter()
    ppr = Solver(g_pr, ppr_problem(), n_workers=P)

    def batch_query(name, k):
        """x0 (k, n) and q for the k vertices of largest out-degree."""
        seeds = top_out_degree(g_pr, k)
        if name == "sssp":
            return multi_source_x0(g_ss, seeds), None
        return np.full((k, g_pr.n), 1.0 / g_pr.n, np.float32), ppr_teleport(g_pr, seeds)

    batch_solvers = {"ppr": ppr, "sssp": full["sssp"]}
    batch_cases = [("ppr", BATCH_Q, d, None) for d in ("sync", dstar["pagerank"])]
    batch_cases += [("sssp", BATCH_Q, d, None) for d in ("sync", dstar["sssp"])]
    batch_cases += [("ppr", BATCH_Q_WIDE, dstar["pagerank"], None), ("ppr", BATCH_Q, dstar["pagerank"], 4)]
    for name, _, d, _ in batch_cases:  # set-up: schedules built before the count
        batch_solvers[name].schedule(d)
    st_solver = Solver(hg_pr, ppr_problem(), n_workers=P)
    st_seeds = top_out_degree(hg_pr, STEPPER_QUERIES)
    st_x0 = np.full(hg_pr.n, 1.0 / hg_pr.n, np.float32)
    st_solver.schedule("sync")
    fused_round_cuda.launches = 0
    fused_batch_round_cuda.launches = 0
    fused_batch_solve_cuda.launches = 0
    batch_runs, batch_launches_by_c = [], {}
    for name, Qn, d, every in batch_cases:
        solver = batch_solvers[name]
        x0, qb = batch_query(name, Qn)
        walls = []
        for _ in range(2):  # the second call: every allocation warm
            before = fused_batch_solve_cuda.launches
            mem = torch.cuda.memory_stats()
            t1 = time.perf_counter()
            b = solver.solve_batch(x0, q=qb, delta=d, compact_every=every)
            walls.append(time.perf_counter() - t1)
            # the caching allocator's calls to the device during the batch
            allocs = {k: torch.cuda.memory_stats()[k] - mem[k] for k in ("num_device_alloc", "num_alloc_retries")}
            launches = fused_batch_solve_cuda.launches - before
            chunks = -(-b.rounds // every) if every else 1
            if launches != chunks:
                raise AssertionError(
                    f"batch {name} Q={Qn}: {launches} loop launches for {chunks} chunks of {b.rounds} rounds"
                )
            C = Qn * (b.x.shape[2] if b.x.ndim == 3 else 1)
            batch_launches_by_c[C] = batch_launches_by_c.get(C, 0) + launches
        batch_runs.append((name, Qn, d, every, x0, qb, b, walls, allocs))
    # the open batch: staggered admissions, two a quantum of 4 rounds
    st = BatchStepper(st_solver, capacity=STEPPER_CAPACITY, delta="sync")
    retired, pending = {}, list(range(STEPPER_QUERIES))
    st_before = fused_batch_solve_cuda.launches
    while pending or st.occupancy:
        for _ in range(min(2, st.free_slots, len(pending))):
            i = pending.pop(0)
            st.admit(st_x0, q=ppr_teleport(hg_pr, st_seeds[i : i + 1])[0], tag=i)
        retired.update((r.tag, r) for r in st.run(4))
    st_launches = fused_batch_solve_cuda.launches - st_before
    if st_launches != st.quanta:
        raise AssertionError(f"the open batch ran {st.quanta} quanta in {st_launches} loop launches")
    batch_launches_by_c[STEPPER_CAPACITY] = batch_launches_by_c.get(STEPPER_CAPACITY, 0) + st_launches
    batch_path_launches = fused_batch_solve_cuda.launches
    if fused_round_cuda.launches or fused_batch_round_cuda.launches or batch_path_launches == 0:
        raise AssertionError(
            f"the batch path launched K1 {fused_round_cuda.launches} times, its batch entry "
            f"{fused_batch_round_cuda.launches} times and the loop entry {batch_path_launches} times"
        )
    log(f"[3] batch path: {batch_path_launches} batch loop launches {batch_launches_by_c}; "
        f"done in {time.perf_counter() - t0:.1f} s")

    # each batch query against its own single kernel solve
    t0 = time.perf_counter()
    batch_rows = []
    for name, Qn, d, every, x0, qb, b, walls, allocs in batch_runs:
        solver = batch_solvers[name]
        singles_s, same_x, same_rounds = 0.0, True, True
        for i in range(Qn):
            qi = None if qb is None else qb[i]
            # a compacted query left the batch at the end of its chunk
            left = min(b.rounds, -(-int(b.rounds_per_query[i]) // every) * every) if every else b.rounds
            own = solver.solve(x0[i], q=qi, delta=d, tol=-1.0, max_rounds=left)
            same_x &= np.array_equal(own.x.view(np.int32), b.x[i].view(np.int32))
            t1 = time.perf_counter()
            one = solver.solve(x0[i], q=qi, delta=d)
            singles_s += time.perf_counter() - t1
            same_rounds &= one.converged and one.rounds == b.rounds_per_query[i]
        row = {
            "problem": name,
            "Q": Qn,
            "delta": b.delta,
            "compact_every": every,
            "compactions": b.compactions,
            "S": b.flushes // b.rounds,
            "rounds": b.rounds,
            "rounds_per_query": b.rounds_per_query.tolist(),
            "converged": bool(b.converged.all()),
            "flushes": b.flushes,
            "flush_bytes": b.flush_bytes,
            "total_s_first": walls[0],
            "total_s": walls[1],
            "loop_s": b.total_time_s,
            "ms_per_round": b.total_time_s / b.rounds * 1e3,
            "singles_total_s": singles_s,
            "batch_over_singles": walls[1] / singles_s,
            "device_allocs": allocs["num_device_alloc"],
            "alloc_retries": allocs["num_alloc_retries"],
            "x_equals_own_solves": bool(same_x),
            "rounds_equal_single_solves": bool(same_rounds),
        }
        batch_rows.append(row)
        log(f"[3] batch solve {json.dumps(row)}")
        if not (same_x and same_rounds and row["converged"] and np.isfinite(b.x.astype(np.float64)).all()):
            raise AssertionError(f"a batch query differs from its own solve: {row}")
    for i in range(STEPPER_QUERIES):
        fresh = st_solver.solve_batch(st_x0[None], q=ppr_teleport(hg_pr, st_seeds[i : i + 1]), delta="sync")
        r = retired[i]
        same_x = np.array_equal(r.x.view(np.int32), fresh.x[0].view(np.int32))
        if not (r.converged and r.rounds == fresh.rounds and same_x):
            raise AssertionError(f"open batch row {i} differs from a fresh one-query batch")
    log(
        f"[3] open batch s{HALO_SCALE}: capacity {STEPPER_CAPACITY}, {STEPPER_QUERIES} queries, "
        f"{st.quanta} quanta, {st.rounds_executed} rounds; every retired row equals a fresh one-query "
        f"batch; checks done in {time.perf_counter() - t0:.1f} s"
    )

    # the ppr batches through the host loop over single launches of K1's batch entry
    t0 = time.perf_counter()
    fused_batch_round_cuda.launches = 0
    batch_round_launches_by_c = {}
    for name, Qn, d, every, x0, qb, b, _, _ in batch_runs:
        if name != "ppr" or every or (Qn, d) not in ((BATCH_Q, "sync"), (BATCH_Q_WIDE, dstar["pagerank"])):
            continue
        solver = batch_solvers[name]
        sr, sched = solver.problem.semiring, solver.schedule(d)
        ep = solver.batch_row_update(qb, Qn, ())
        X = engine.extend_frontier(np.moveaxis(x0, 0, 1), sr, dev)
        before = fused_batch_round_cuda.launches
        host = engine.host_loop(
            lambda X: ops.fused_batch_round(X, sched, sr, ep), sched, sr, X, l1_residual, -1.0, b.rounds
        )
        launches = fused_batch_round_cuda.launches - before
        batch_round_launches_by_c[Qn] = batch_round_launches_by_c.get(Qn, 0) + launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        solve_batch_module._to_host(X)  # what a solve_batch's exit copies
        copy_s = time.perf_counter() - t1
        row = {
            "problem": name,
            "Q": Qn,
            "delta": sched.delta,
            "rounds": host.rounds,
            "host_loop_s": host.total_time_s,
            "host_loop_ms_per_round": host.total_time_s / host.rounds * 1e3,
            "batch_loop_ms_per_round": b.total_time_s / b.rounds * 1e3,
            "copy_out_s": copy_s,
            "copy_out_gb_per_s": X[:-1].numel() * X.element_size() / copy_s / 1e9,
            "loop_s_less_copy_out_ms_per_round": (b.total_time_s - copy_s) / b.rounds * 1e3,
            "launches": launches,
            "equal": bool(np.array_equal(host.x.T.view(np.int32), b.x.view(np.int32))),
        }
        log(f"[3] batch host loop {json.dumps(row)}")
        if not row["equal"] or launches != b.rounds:
            raise AssertionError(f"the batch loop entry and the batch host loop differ: {row}")
    log(f"[3] batch host loop: {batch_round_launches_by_c} launches of K1's batch entry; "
        f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_batch_all(
        f"s{scale}", full["pagerank"], full["sssp"], mfull,
        {"pagerank": ("sync", dstar["pagerank"]), "sssp": ("sync", dstar["sssp"]),
         **{name: ("sync",) for name in mfull}},
    )
    log(f"[3] K1's batch entry vs plain at full size done in {time.perf_counter() - t0:.1f} s")

    # the evolving-graph path: resolve(updates=batch) at δ* on solvers of its
    # own (the main path's keep the unmutated graph for phase 4): SSSP takes
    # mixed batches, PageRank mass-conserving deletes; after each resolve a
    # cold solve on the mutated graph over the same patched schedule
    t0 = time.perf_counter()
    fused_round_cuda.launches = 0
    fused_solve_cuda.launches = 0
    evolve_launches, evolve_rows = 0, []
    events = {"sssp": sssp_event, "pagerank": pagerank_event}
    for name, g0 in (("sssp", g_ss), ("pagerank", g_pr)):
        t1 = time.perf_counter()
        inc = Solver(g0, probs[name], n_workers=P, delta=dstar[name])
        sr, residual = inc.problem.semiring, inc.problem.residual
        before = fused_solve_cuda.launches
        r0 = inc.solve()
        evolve_launches += fused_solve_cuda.launches - before
        log(f"[3] evolve {name} δ={r0.delta}: cold solve {r0.rounds} rounds, {r0.total_time_s:.4f} s; "
            f"solver set up and solved in {time.perf_counter() - t1:.1f} s")
        apply_s, patch_s = [], []

        def timed(fn, secs):
            def run(*args):
                t1 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t1)
                return out

            return run

        # resolve applies its batch through apply_updates, which patches the
        # cached schedule through _patch_schedules
        inc.apply_updates = timed(inc.apply_updates, apply_s)
        inc._patch_schedules = timed(inc._patch_schedules, patch_s)
        rng = np.random.default_rng(EVOLVE_SEED)
        for k in EVOLVE_BATCHES:
            t1 = time.perf_counter()
            batch = events[name](inc.graph, k, rng)
            make_s = time.perf_counter() - t1
            builds = inc.stats["schedule_builds"]
            before = fused_solve_cuda.launches
            t1 = time.perf_counter()
            r = inc.resolve(updates=batch)
            total_s = time.perf_counter() - t1
            launches = fused_solve_cuda.launches - before
            report = inc._last_report
            sched = inc.schedule()
            row_ptr_ok = torch.equal(sched.row_ptr, engine._cell_row_ptr(sched.dst_local, sched.delta))
            # the patched schedule against a fresh build of the mutated graph
            # with the pinned bounds, padded to the patched M
            t1 = time.perf_counter()
            fresh = engine.make_schedule(inc._sched_graph, P, sched.delta, sr, bounds=inc.bounds, device=dev)
            pad = sched.M - fresh.M
            fills = {"src": 0, "val": sr.pad_edge_val.item(), "dst_local": sched.delta}
            same_sched = pad >= 0 and all(
                torch.equal(getattr(sched, f), torch.nn.functional.pad(getattr(fresh, f), (0, pad), value=v))
                for f, v in fills.items()
            ) and torch.equal(sched.rows, fresh.rows) and torch.equal(sched.row_ptr, fresh.row_ptr)
            fresh_s = time.perf_counter() - t1
            del fresh
            before = fused_solve_cuda.launches
            t1 = time.perf_counter()
            cold = inc.solve()
            cold_s = time.perf_counter() - t1
            evolve_launches += fused_solve_cuda.launches - before + launches
            gap = float(np.abs(r.x.astype(np.float64) - cold.x.astype(np.float64)).sum())
            if name == "sssp":
                equal = bool(np.array_equal(r.x, cold.x))
            else:
                equal = gap <= 20 * inc.tol
            row = {
                "problem": name,
                "k": k,
                "delta": r.delta,
                "S": sched.S,
                "M": sched.M,
                "inserts": batch.n_inserts,
                "deletes": batch.n_deletes,
                "reweights": batch.n_reweights,
                "affected_rows": int(report.affected_rows.size),
                "touched_workers": int(inc._touched_workers(report.affected_rows).size),
                "schedule_builds": inc.stats["schedule_builds"] - builds,
                "make_batch_s": make_s,
                "apply_updates_s": apply_s[-1],
                "patch_s": patch_s[-1],
                "total_s": total_s,
                "loop_s": r.total_time_s,
                "warm_start_and_rest_s": total_s - apply_s[-1] - r.total_time_s,
                "rounds": r.rounds,
                "converged": r.converged,
                "launches": launches,
                "cold_rounds": cold.rounds,
                "cold_total_s": cold_s,
                "cold_loop_s": cold.total_time_s,
                "rounds_over_cold": r.rounds / cold.rounds,
                "l1_gap_vs_cold": gap,
                "equals_cold": equal,
                "row_ptr_rederived": row_ptr_ok,
                "schedule_equals_fresh_build": same_sched,
                "fresh_build_s": fresh_s,
            }
            evolve_rows.append(row)
            log(f"[3] evolve {json.dumps(row)}")
            log(f"[3] evolve {name} k={k}: rounds {r.rounds} (cold {cold.rounds}), total_s {total_s:.4f}, "
                f"apply_updates_s {apply_s[-1]:.4f}")
            if launches != 1 or not (row_ptr_ok and same_sched and equal and r.converged and cold.converged):
                raise AssertionError(f"the evolving-graph path failed: {row}")
            # K1's loop entry against its plain loop on the patched schedule,
            # over a budget of rounds (SSSP's plain loop on the card, to convergence)
            x = engine.extend_frontier(inc.problem.x0(inc.graph), sr, "cpu")
            if name == "sssp":
                compare_loop(f"s{scale} evolved sssp k={k} δ={sched.delta}", "solve", sched, sr, inc.row_update(),
                             residual, x, inc.tol, inc.max_rounds, plain_on_card=True)
            else:
                compare_loop(f"s{scale} evolved pagerank k={k} δ={sched.delta}", "solve", sched, sr,
                             inc.row_update(), residual, x, -1.0, LOOP_BUDGET)
        del inc
    if evolve_launches == 0 or fused_round_cuda.launches:
        raise AssertionError(
            f"the evolving-graph path launched the loop entry {evolve_launches} times and K1 "
            f"{fused_round_cuda.launches} times"
        )
    log(f"[3] evolving-graph path: {evolve_launches} loop launches, one a resolve and a solve; "
        f"done in {time.perf_counter() - t0:.1f} s")

    # the halo resolve at HALO_SCALE: K2 over a plan rebuilt from the patched
    # schedule, equal to the replicated resolve; then K2 against its plain
    # round on that plan
    t0 = time.perf_counter()
    fused_halo_round_cuda.launches = 0
    evolve_halo_launches = 0
    x_rng = np.random.default_rng(EVOLVE_SEED)
    for name, gh in (("sssp", hg_ss), ("pagerank", hg_pr)):
        replicated_solver = Solver(gh, h_probs[name], n_workers=P, delta=EVOLVE_HALO_DELTA)
        halo = Solver(gh, h_probs[name], n_workers=P, delta=EVOLVE_HALO_DELTA, frontier="halo", n_shards=SHARDS)
        replicated_solver.solve()
        before = fused_halo_round_cuda.launches
        halo.solve()
        evolve_halo_launches += fused_halo_round_cuda.launches - before
        batch = events[name](gh, EVOLVE_BATCHES[0], np.random.default_rng(EVOLVE_SEED))
        plans = halo.stats["plan_builds"]
        before = fused_halo_round_cuda.launches
        t1 = time.perf_counter()
        rh = halo.resolve(updates=batch)
        secs = time.perf_counter() - t1
        k2 = fused_halo_round_cuda.launches - before
        evolve_halo_launches += k2
        rr = replicated_solver.resolve(updates=batch)
        row = {
            "problem": name,
            "scale": HALO_SCALE,
            "k": EVOLVE_BATCHES[0],
            "delta": rh.delta,
            "D": SHARDS,
            "rounds": rh.rounds,
            "replicated_rounds": rr.rounds,
            "total_s": secs,
            "launches": k2,
            "plan_builds": halo.stats["plan_builds"] - plans,
            "equals_replicated": bool(
                (rh.rounds, rh.flushes, rh.flush_bytes) == (rr.rounds, rr.flushes, rr.flush_bytes)
                and np.array_equal(rh.x, rr.x)
            ),
        }
        log(f"[3] evolve halo {json.dumps(row)}")
        if not (row["equals_replicated"] and k2 == rh.rounds and row["plan_builds"] == 1 and rh.converged):
            raise AssertionError(f"the halo resolve failed: {row}")
        sched = halo.schedule()
        if name == "sssp":
            x_i = torch.tensor(x_rng.integers(0, 5000, gh.n + 1).astype(np.int32))
            x_i[torch.tensor(x_rng.random(gh.n + 1) < 0.3)] = 2**30 - 1
            compare_halo(f"s{HALO_SCALE} evolved sssp min_old δ={sched.delta}", halo, sched, halo.row_update(), x_i)
        else:
            x_f = torch.tensor(x_rng.random(gh.n + 1).astype(np.float32))
            compare_halo(f"s{HALO_SCALE} evolved pagerank add_const δ={sched.delta}", halo, sched,
                         halo.row_update(), x_f, quant_rounds=1)
    if evolve_halo_launches == 0:
        raise AssertionError("the halo resolve never launched K2")
    log(f"[3] halo resolve: {evolve_halo_launches} K2 launches; done in {time.perf_counter() - t0:.1f} s")

    # the restart path: this process (cold) fills a fresh store; a second
    # process on the same cache_dir must answer warm: no probe, no schedule,
    # stripe or plan build, one launch of K1's loop entry over a loaded
    # schedule (K2 over a loaded plan on the halo path), x bit for bit this
    # process's.  A miss fails the phase.
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="restart-"))
    save_npz = persist_store._save_npz
    try:
        cache = work / "cache"
        free_before = shutil.disk_usage(work).free
        writes = {"s": 0.0, "bytes": 0, "files": 0}
        kinds = ("schedule", "stripes", "plan", "planshards")
        by_kind = {k: dict(writes) for k in kinds}

        def timed_save(path, arrays):
            t1 = time.perf_counter()
            save_npz(path, arrays)
            dt, nbytes = time.perf_counter() - t1, path.stat().st_size if path.exists() else 0
            kind = path.parent.name if path.parent.name in kinds else "schedule" if path.name.startswith("sched_") else "plan"
            for w in (writes, by_kind[kind]):
                w["s"] += dt
                w["files"] += 1
                w["bytes"] += nbytes

        persist_store._save_npz = timed_save
        fused_solve_cuda.launches = fused_halo_round_cuda.launches = 0
        cold_rows, spec = {}, []
        np.savez(work / "s16.npz", n=hg_pr.n, indptr=hg_pr.indptr, indices=hg_pr.indices, values=hg_pr.values)
        h_hub = int(np.argmax(hg_pr.out_degree))
        for name, graph, problem, kw, npz_path in (
            ("replicated", g_pr, pagerank_problem(), dict(delta="auto"), npz),
            ("halo", hg_pr, pagerank_problem(), dict(delta="auto", frontier="halo", n_shards=SHARDS),
             str(work / "s16.npz")),
        ):
            for w in (writes, *by_kind.values()):
                w.update(s=0.0, bytes=0, files=0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cold = Solver(graph, problem, n_workers=P, cache_dir=str(cache), **kw)
            t2 = time.perf_counter()
            r = cold.solve()
            t3 = time.perf_counter()
            np.save(work / f"cold_{name}.npy", r.x)
            cold_rows[name] = {
                "name": name,
                "n": graph.n,
                "nnz": graph.nnz,
                "delta": r.delta,
                "rounds": r.rounds,
                "time_to_first_answer_s": t3 - t1,
                "construct_s": t2 - t1,
                "solve_s": t3 - t2,
                "write_s": writes["s"],
                "written_bytes": writes["bytes"],
                "written_files": writes["files"],
                "writes_by_kind": {k: dict(w) for k, w in by_kind.items()},
                "stats": dict(cold.stats),
                "result": r,
                "solver": cold,
            }
            spec.append({"name": name, "graph": npz_path, "problem": "pagerank", "kw": kw})
            log(f"[3] restart cold {json.dumps({k: v for k, v in cold_rows[name].items() if k not in ('result', 'solver')})}")
        # an evolving graph: one resolve(updates=...) patches the schedule
        # and pushes its patched stripes (deletes and reweights: no cell
        # outgrows M, so the patch keeps the schedule); a fresh process on
        # the mutated graph (equal bounds) must load every stripe
        kw = dict(delta=EVOLVE_HALO_DELTA, partition_method="equal")
        inc = Solver(hg_ss, h_probs["sssp"], n_workers=P, cache_dir=str(cache), **kw)
        inc.solve()
        batch = sssp_event(hg_ss, EVOLVE_BATCHES[0], np.random.default_rng(EVOLVE_SEED))
        batch = dataclasses.replace(batch, insert_src=batch.insert_src[:0], insert_dst=batch.insert_dst[:0],
                                    insert_val=batch.insert_val[:0])
        builds = inc.stats["schedule_builds"]
        inc.resolve(updates=batch)
        if inc.stats["schedule_builds"] != builds:
            raise AssertionError("the resolve dropped its schedule instead of patching it")
        r_mut = inc.solve()
        g_mut = inc.graph
        np.save(work / "cold_evolved.npy", r_mut.x)
        np.savez(work / "evolved.npz", n=g_mut.n, indptr=g_mut.indptr, indices=g_mut.indices, values=g_mut.values)
        spec.append({"name": "evolved", "graph": str(work / "evolved.npz"), "problem": "sssp",
                     "source": int(np.argmax(hg_pr.out_degree)), "kw": kw})
        log(f"[3] restart evolve s{HALO_SCALE} sssp: resolve of {batch.n_deletes} deletes and "
            f"{batch.n_reweights} reweights touching {inc._touched_workers(inc._last_report.affected_rows).size} "
            f"workers, δ={r_mut.delta}, cold rounds {r_mut.rounds}")
        persist_store._save_npz = save_npz
        cold_launches = (fused_solve_cuda.launches, fused_halo_round_cuda.launches)
        files = [f for f in cache.rglob("*") if f.is_file()]
        store_bytes = sum(f.stat().st_size for f in files)
        (work / "restart.json").write_text(json.dumps(spec))
        log(f"[3] restart store: {store_bytes} bytes in {len(files)} files; free before the phase "
            f"{free_before} bytes ({work}); cold launches: loop entry {cold_launches[0]}, K2 {cold_launches[1]}")

        t1 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--restart-warm", str(work)],
            capture_output=True, text=True, timeout=RESTART_TIMEOUT_S,
        )
        warm_process_s = time.perf_counter() - t1
        if out.returncode != 0:
            log(out.stderr[-4000:])
            raise AssertionError(f"the restart's second process failed ({out.returncode})")
        warm_rows = {row["name"]: row for row in map(json.loads, out.stdout.strip().splitlines())}
        restart_launches = {"loop": 0, "k2": 0}
        restart_rows = []
        for name, warm in warm_rows.items():
            st = warm["stats"]
            same_x = bool(np.array_equal(np.load(work / f"warm_{name}.npy"), np.load(work / f"cold_{name}.npy")))
            halo = name == "halo"
            ok = (
                same_x
                and warm["converged"]
                and st["schedule_builds"] == st["stripe_builds"] == st["plan_builds"] == 0
                and st["plan_shard_builds"] == 0
                and st["solves"] == 1
                and st["cache_loads"] >= 1
                and warm["k1_launches"] == 0
                and (warm["k2_launches"] == warm["rounds"] and warm["loop_launches"] == 0 if halo
                     else warm["loop_launches"] == 1 and warm["k2_launches"] == 0)
                and (name == "evolved" or warm["probe_model_loaded"])
                and (name != "evolved" or st["stripe_loads"] == P)
                and (name != "replicated" or warm["stripes_only_misses"] == 0 and warm["stripes_only_equal"])
            )
            restart_launches["loop"] += warm["loop_launches"]
            restart_launches["k2"] += warm["k2_launches"]
            row = dict(warm, x_equals_cold=same_x)
            if name in cold_rows:
                c = cold_rows[name]
                row.update(
                    cold_time_to_first_answer_s=c["time_to_first_answer_s"],
                    cold_over_warm=c["time_to_first_answer_s"] / warm["time_to_first_answer_s"],
                    cold_rounds=c["rounds"],
                    rounds_equal=c["rounds"] == warm["rounds"],
                )
                ok = ok and row["rounds_equal"]
            restart_rows.append(row)
            log(f"[3] restart warm {json.dumps(row)}")
            if not ok:
                raise AssertionError(f"the restarted process did not answer warm: {row}")
        log(f"[3] restart: second process {warm_process_s:.1f} s in all; time to first answer, cold over warm: "
            + ", ".join(f"{r['name']} {r['cold_over_warm']:.1f}x ({r['cold_time_to_first_answer_s']:.2f} s / "
                        f"{r['time_to_first_answer_s']:.2f} s)" for r in restart_rows if "cold_over_warm" in r))

        # the loaded schedule and plan against the plain versions: K1's loop
        # entry over the schedule the store holds, K2 over its plan
        rc = cold_rows["replicated"]
        loaded = rc["solver"].persist.load_schedule(rc["delta"], rc["solver"].bounds, dev)
        if loaded is None or not torch.equal(loaded.row_ptr, engine._cell_row_ptr(loaded.dst_local, loaded.delta)):
            raise AssertionError("the store's schedule did not load with its row_ptr")
        x = engine.extend_frontier(pagerank_problem().x0(g_pr), PLUS_TIMES, "cpu")
        compare_loop(f"s{scale} restart pagerank loaded δ={loaded.delta}", "solve", loaded, PLUS_TIMES,
                     rc["solver"].row_update(), l1_residual, x, -1.0, LOOP_BUDGET)
        del loaded, x
        hp = Solver(hg_pr, pagerank_problem(), n_workers=P, cache_dir=str(cache), **spec[1]["kw"])
        hsched = hp.schedule()
        x_f = torch.tensor(np.random.default_rng(EVOLVE_SEED).random(hg_pr.n + 1).astype(np.float32))
        compare_halo(f"s{HALO_SCALE} restart pagerank loaded plan δ={hsched.delta}", hp, hsched, hp.row_update(),
                     x_f, quant_rounds=1)
        if hp.stats["plan_builds"] or hp.stats["schedule_builds"] or hp.stats["cache_loads"] < 3:
            raise AssertionError(f"the halo plan did not load: {hp.stats}")
        del hp, hsched, cold_rows, inc
    finally:
        persist_store._save_npz = save_npz
        shutil.rmtree(work, ignore_errors=True)
    log(f"[3] restart path: {restart_launches['loop']} loop-entry and {restart_launches['k2']} K2 launches in the "
        f"second process; done in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- 4 ---
    t0 = time.perf_counter()
    timings = []
    for name, solver in full.items():
        sr, ep = solver.problem.semiring, solver.row_update()
        x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, dev)
        for d in DELTAS + ("auto",):
            sched = solver.schedule(d)
            k_ms = time_ms(lambda: ops.fused_round(x, sched, sr, ep))
            # The same round with every row's edge range emptied: what the S
            # steps' barriers, epilogues and publishes cost without the walk.
            no_edges = dataclasses.replace(sched, row_ptr=torch.zeros_like(sched.row_ptr))
            e_ms = time_ms(lambda: ops.fused_round(x, no_edges, sr, ep))
            plain = engine.round_fn(sched, sr, ep)
            p_ms = time_ms(lambda: plain(x), budget_s=0.2, max_iters=5, min_iters=1)
            b_ms, b_by = round_bound(sched, None)
            lib_ms = None
            if name == "pagerank" and d == "auto":  # S library calls, one a step
                mats = step_blocks(solver.graph, sched, dev)
                if sum(A._nnz() for A in mats) != solver.graph.nnz:
                    raise AssertionError("the step blocks do not cover the matrix once")
                xv = x[:-1].reshape(-1, 1).contiguous()
                lib_ms = time_ms(lambda: [torch.sparse.mm(A, xv) for A in mats])
                del mats
            if name == "pagerank" and d == "sync":
                g = solver.graph
                A = torch.sparse_csr_tensor(
                    torch.tensor(g.indptr, device=dev),
                    torch.tensor(g.indices.astype(np.int64), device=dev),
                    torch.tensor(g.values, device=dev),
                    size=(g.n, g.n),
                )
                xv = x[:-1].reshape(-1, 1).contiguous()
                lib_ms = time_ms(lambda: torch.sparse.mm(A, xv))
                spmv = torch.sparse.mm(A, xv).reshape(-1)
                k_out = ops.fused_round(x, sched, sr, ep)[:-1] - float(ep.const)
                rel = float(((spmv - k_out).abs().max() / spmv.abs().max()).item())
                log(f"[4] sparse.mm vs K1 sync round, max rel diff {rel}")
            row = {
                "problem": name,
                "delta": sched.delta,
                "S": sched.S,
                "M": sched.M,
                "padding_overhead": sched.padding_overhead,
                "ms": k_ms,
                "no_edges_ms": e_ms,
                "walk_ms": k_ms - e_ms,
                "plain_ms": p_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "share_of_bound": b_ms / k_ms,
                "library_ms": lib_ms,
            }
            timings.append(row)
            log(f"[4] timing {json.dumps(row)}")
    torch.cuda.synchronize()
    log(f"[4] K1 done in {time.perf_counter() - t0:.1f} s")

    # K2: one launch a round, all D shards, the exchange inside
    t0 = time.perf_counter()
    halo_timings = []
    k2_cases = [("pagerank", d) for d in ("sync", 128, 1024, dstar["pagerank"])]
    k2_cases += [("sssp", d) for d in ("sync", dstar["sssp"])]
    for name, d in k2_cases:
        solver = full[name]
        sr, ep = solver.problem.semiring, solver.row_update()
        x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, dev)
        sched = solver.schedule(d)
        t1 = time.perf_counter()
        plan = solver.frontier_plan(sched)
        plan_s = time.perf_counter() - t1
        x_loc = plan.scatter_x(x)  # each timed call runs a round in place on it

        def k2(steps=None, wire="f32", ef=None):
            return ops.fused_halo_round(x_loc, ef, sched, plan, sr, ep, wire, steps)

        k_ms = time_ms(k2)
        host = []
        for _ in range(20):  # the host's side of one launch
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            k2()
            host.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        step_ms = time_ms(lambda: [k2((s, s + 1)) for s in range(sched.S)])
        wire_ms = {}
        if name == "pagerank":
            for wire in ("int8", "fp8"):
                ef = engine_sharded.frontier_ef_init(plan)
                wire_ms[wire] = time_ms(lambda: k2(wire=wire, ef=ef))
        x_plain = plan.scatter_x(x)
        p_ms = time_ms(lambda: ref.fused_halo_round_ref(x_plain, None, sched, plan, sr, ep), 0.2, 5, 1)
        del x_plain
        b_ms, b_by = halo_round_bound(sched, plan, ep.tag, "f32")
        rnd = engine_sharded.frontier_kernel_round_ext_fn(sched, plan, sr, ep)
        ef0 = engine_sharded.frontier_ef_init(plan)
        k1 = next(t for t in timings if t["problem"] == name and t["delta"] == sched.delta)
        row = {
            "problem": name,
            "delta": sched.delta,
            "S": sched.S,
            "D": plan.D,
            "H": plan.H,
            "plan_build_s": plan_s,
            "launches_per_round": 1,
            "ms": k_ms,
            "host_ms_per_launch": float(np.median(host)),
            "host_ms_max": float(np.max(host)),
            "one_step_a_launch_ms": step_ms,
            "int8_ms": wire_ms.get("int8"),
            "fp8_ms": wire_ms.get("fp8"),
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "share_of_bound": b_ms / k_ms,
            "library_ms": k1["library_ms"],
            "halo_round_ms": time_ms(lambda: rnd(x, ef0)),
            "k1_round_ms": k1["ms"],
            "k1_bound_ms": k1["bound_ms"],
        }
        row["ms_over_k1"] = row["ms"] / row["k1_round_ms"]
        halo_timings.append(row)
        log(f"[4] K2 timing {json.dumps(row)}")
        del x_loc, rnd, ef0
    torch.cuda.synchronize()
    log(f"[4] K2 done in {time.perf_counter() - t0:.1f} s")

    # K1 and K2 at F = 4: rwr and labelprop at sync and δ*
    t0 = time.perf_counter()
    matrix_timings = []
    for name, solver in mfull.items():
        sr, ep = solver.problem.semiring, solver.row_update()
        edge_values = solver.problem.edge_values  # the graph the schedules are built from
        g = solver.graph.with_values(edge_values(solver.graph)) if edge_values else solver.graph
        x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, dev)
        F = x.shape[1]
        X = x[:-1].contiguous()
        for d in ("sync", mstar[name]):
            sched = solver.schedule(d)
            k1_ms = time_ms(lambda: ops.fused_round(x, sched, sr, ep))
            plain = engine.round_fn(sched, sr, ep)
            p1_ms = time_ms(lambda: plain(x), budget_s=0.2, max_iters=3)
            b1_ms, b1_by = round_bound(sched, True, F)
            if d == "sync":  # one library call over the whole CSR
                A = torch.sparse_csr_tensor(
                    torch.tensor(g.indptr, device=dev),
                    torch.tensor(g.indices.astype(np.int64), device=dev),
                    torch.tensor(g.values, device=dev),
                    size=(g.n, g.n),
                )
                lib_ms = time_ms(lambda: torch.sparse.mm(A, X))
                del A
            else:  # S library calls, one a commit step's rows
                mats = step_blocks(g, sched, dev)
                lib_ms = time_ms(lambda: [torch.sparse.mm(A, X) for A in mats])
                del mats
            plan = solver.frontier_plan(sched)
            x_loc = plan.scatter_x(x)
            k2_ms = time_ms(lambda: ops.fused_halo_round(x_loc, None, sched, plan, sr, ep))
            rnd = engine_sharded.frontier_kernel_round_ext_fn(sched, plan, sr, ep)
            ef0 = engine_sharded.frontier_ef_init(plan, (F,))
            halo_ms = time_ms(lambda: rnd(x, ef0))
            del rnd, ef0
            ef = engine_sharded.frontier_ef_init(plan, (F,))
            int8_ms = time_ms(lambda: ops.fused_halo_round(x_loc, ef, sched, plan, sr, ep, "int8"))
            x_plain = plan.scatter_x(x)
            p2_ms = time_ms(lambda: ref.fused_halo_round_ref(x_plain, None, sched, plan, sr, ep), 0.2, 3)
            b2_ms, b2_by = halo_round_bound(sched, plan, ep.tag, "f32", F)
            del x_loc, x_plain, ef
            row = {
                "problem": name,
                "tag": ep.tag,
                "F": F,
                "delta": sched.delta,
                "S": sched.S,
                "k1_ms": k1_ms,
                "k1_plain_ms": p1_ms,
                "k1_bound_ms": b1_ms,
                "k1_bound_by": b1_by,
                "k1_share_of_bound": b1_ms / k1_ms,
                "library_ms": lib_ms,
                "k2_ms": k2_ms,
                "k2_int8_ms": int8_ms,
                "k2_plain_ms": p2_ms,
                "k2_bound_ms": b2_ms,
                "k2_bound_by": b2_by,
                "k2_share_of_bound": b2_ms / k2_ms,
                "k2_over_k1": k2_ms / k1_ms,
                "halo_round_ms": halo_ms,
            }
            matrix_timings.append(row)
            log(f"[4] F=4 timing {json.dumps(row)}")
    torch.cuda.synchronize()
    log(f"[4] K1 and K2 at F = 4 done in {time.perf_counter() - t0:.1f} s")

    # K1's batch entry at C = 8 and 32: ppr and sssp at Q = BATCH_Q, rwr at
    # Q = BATCH_Q (F = 4), ppr at Q = BATCH_Q_WIDE; at sync and δ*
    t0 = time.perf_counter()
    batch_timings, blocks = [], {}
    rwr = mfull["rwr"]
    cases = [("ppr", ppr, BATCH_Q, dstar["pagerank"]), ("sssp", full["sssp"], BATCH_Q, dstar["sssp"]),
             ("rwr", rwr, BATCH_Q, mstar["rwr"]), ("ppr", ppr, BATCH_Q_WIDE, dstar["pagerank"])]
    for name, solver, Qn, dst in cases:
        sr = solver.problem.semiring
        g = solver.graph
        seeds = top_out_degree(g, Qn)
        if name == "sssp":
            x0, qb = multi_source_x0(g, seeds), None
            single_eps = [Epilogue("min_old")] * Qn
        elif name == "ppr":
            x0, qb = np.full((Qn, g.n), 1.0 / g.n, np.float32), ppr_teleport(g, seeds)
            single_eps = [solver.row_update(qb[i]) for i in range(Qn)]
        else:
            F = solver.problem.feature_dim
            qb = np.stack([rwr_restart(g, seeds[(np.arange(F) + i) % Qn]) for i in range(Qn)])
            x0 = np.full((Qn, g.n, F), 1.0 / g.n, np.float32)
            single_eps = [solver.row_update(qb[i]) for i in range(Qn)]
        feat = tuple(x0.shape[2:])
        ep = solver.batch_row_update(qb, Qn, feat)
        X = engine.extend_frontier(np.moveaxis(x0, 0, 1), sr, dev)
        C = Qn * (feat[0] if feat else 1)
        singles = [X[:, i].contiguous() for i in range(Qn)]
        for d in ("sync", dst):
            sched = solver.schedule(d)
            k_ms = time_ms(lambda: ops.fused_batch_round(X, sched, sr, ep))
            p_ms = time_ms(lambda: ref.fused_batch_round_ref(X, sched, sr, ep), 0.2, 3, 1)
            q_ms = time_ms(lambda: [ops.fused_round(singles[i], sched, sr, single_eps[i]) for i in range(Qn)])
            b_ms, b_by = round_bound(sched, ep.table is not None, C)
            lib_ms = None
            if sr.name == "plus_times":  # one library call a round (sync), or one a commit step
                Xd = X[:-1].reshape(g.n, C).contiguous()
                key = (g.name, sched.delta)
                if key not in blocks:
                    if d == "sync":
                        blocks[key] = [torch.sparse_csr_tensor(
                            torch.tensor(g.indptr, device=dev),
                            torch.tensor(g.indices.astype(np.int64), device=dev),
                            torch.tensor(g.values, device=dev),
                            size=(g.n, g.n),
                        )]
                    else:
                        blocks[key] = step_blocks(g, sched, dev)
                mats = blocks[key]
                lib_ms = time_ms(lambda: [torch.sparse.mm(A, Xd) for A in mats])
                del Xd
            row = {
                "problem": name,
                "tag": ep.tag,
                "Q": Qn,
                "C": C,
                "delta": sched.delta,
                "S": sched.S,
                "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "share_of_bound": b_ms / k_ms,
                "library_ms": lib_ms,
                "q_single_launches_ms": q_ms,
                "q_single_over_batch": q_ms / k_ms,
            }
            batch_timings.append(row)
            log(f"[4] batch timing {json.dumps(row)}")
        del X, singles, ep, single_eps
    del blocks
    torch.cuda.synchronize()
    log(f"[4] K1's batch entry done in {time.perf_counter() - t0:.1f} s")

    # K1's loop entry: a launch of a fixed number of rounds (tol = -1), its
    # time a round beside K1's round at the same δ
    t0 = time.perf_counter()
    loop_timings = []

    def time_loop(label, sched, sr, ep, residual, x, k1_ms, batch=False):
        """The loop's ms a round: launches of R and of 2R rounds, the
        difference over R, so that what a call adds once (the copy of x, the
        state's copy in and read-back, and the card idle while the host
        issues the next call) cancels; that once-a-call part is
        ``call_ms``.  At C = 1 also ``no_residual_ms``: the same loop
        with the publish alone (no read of old values, no residual; the
        wrapper's timing-only residual code), and what the residual adds."""
        rounds = LOOP_TIMED_ROUNDS.get(sched.delta, LOOP_TIMED_DEFAULT)
        if sched.delta == full["pagerank"].block_size:
            rounds = LOOP_TIMED_ROUNDS["sync"]
        loop = ops.fused_batch_solve if batch else ops.fused_solve
        plain = ref.fused_batch_solve_ref if batch else ref.fused_solve_ref
        one = time_ms(lambda: loop(x, sched, sr, ep, residual, -1.0, rounds), 0.3, 8, 2)
        two = time_ms(lambda: loop(x, sched, sr, ep, residual, -1.0, 2 * rounds), 0.3, 8, 2)
        ms = (two - one) / rounds
        p_ms = time_ms(lambda: plain(x, sched, sr, ep, residual, -1.0, 1), 0.2, 3, 1)
        C = int(np.prod(x.shape[1:], dtype=np.int64))
        b_ms, b_by = round_bound(sched, ep.table is not None, C)
        row = {
            "loop": label,
            "delta": sched.delta,
            "S": sched.S,
            "C": C,
            "rounds_a_launch": rounds,
            "ms": ms,
            "call_ms": one - rounds * ms,
            "one_launch_ms_per_round": one / rounds,
            "k1_round_ms": k1_ms,
            "loop_over_k1": ms / k1_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "share_of_bound": b_ms / ms,
        }
        if not batch and C == 1:
            def bare(k):
                return round_block._launch_loop(
                    x, sched, ep, round_block._RESIDUAL_NONE, -1.0, k, np.zeros(1, bool), False, C, C
                )

            one = time_ms(lambda: bare(rounds), 0.3, 8, 2)
            row["no_residual_ms"] = (time_ms(lambda: bare(2 * rounds), 0.3, 8, 2) - one) / rounds
            row["residual_ms"] = ms - row["no_residual_ms"]
            row["no_residual_over_k1"] = row["no_residual_ms"] / k1_ms
        loop_timings.append(row)
        log(f"[4] loop timing {json.dumps(row)}")
        return row

    for name, solver in full.items():
        sr, ep = solver.problem.semiring, solver.row_update()
        x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, dev)
        for d in DELTAS + ("auto",):
            sched = solver.schedule(d)
            k1 = next(t for t in timings if t["problem"] == name and t["delta"] == sched.delta)
            time_loop(name, sched, sr, ep, solver.problem.residual, x, k1["ms"])
    rwr = mfull["rwr"]
    sched = rwr.schedule("sync")
    x = engine.extend_frontier(rwr.problem.x0(rwr.graph), rwr.problem.semiring, dev)
    k1 = next(t for t in matrix_timings if t["problem"] == "rwr" and t["delta"] == sched.delta)
    loop_f4 = time_loop("rwr", sched, rwr.problem.semiring, rwr.row_update(), rwr.problem.residual, x, k1["k1_ms"])
    loop_batch = {}
    for Qn, d in ((BATCH_Q, "sync"), (BATCH_Q_WIDE, dstar["pagerank"])):
        g = ppr.graph
        sched = ppr.schedule(d)
        ep = ppr.batch_row_update(ppr_teleport(g, top_out_degree(g, Qn)), Qn, ())
        X = engine.extend_frontier(np.full((g.n, Qn), 1.0 / g.n, np.float32), PLUS_TIMES, dev)
        kb = next(t for t in batch_timings if t["problem"] == "ppr" and t["Q"] == Qn and t["delta"] == sched.delta)
        loop_batch[Qn] = time_loop(f"ppr Q={Qn}", sched, PLUS_TIMES, ep, l1_residual, X, kb["ms"], batch=True)
        del X, ep
    torch.cuda.synchronize()
    log(f"[4] K1's loop entry done in {time.perf_counter() - t0:.1f} s")

    # K3: the ELL SpMV through its entry point, on the full-size graph's ELL
    t0 = time.perf_counter()
    idx_np, val_np = ops.ell_from_csr(g_pr)
    _, val_ss_np = ops.ell_from_csr(g_ss)
    idx8_np, val8_np = ops.ell_from_csr(g_pr, lane_pad=8)
    log(
        f"[4] ELL of s{scale}: {idx_np.shape} (lane_pad 128, twice) and {idx8_np.shape} "
        f"(lane_pad 8), built in {time.perf_counter() - t0:.1f} s"
    )
    idx = torch.from_numpy(idx_np).to(dev)
    val_pr, val_ss = torch.from_numpy(val_np).to(dev), torch.from_numpy(val_ss_np).to(dev)
    idx8, val8 = torch.from_numpy(idx8_np).to(dev), torch.from_numpy(val8_np).to(dev)
    del idx_np, val_np, val_ss_np, idx8_np, val8_np
    n_slots = g_pr.n + 1
    x_i = torch.tensor(rng.integers(0, 5000, n_slots).astype(np.int32), device=dev)
    x_i[torch.tensor(rng.random(n_slots) < 0.3, device=dev)] = 2**30 - 1
    x_1 = torch.tensor(rng.random(n_slots).astype(np.float32), device=dev)
    cases = {
        "plus_times F=1": (x_1, idx, val_pr, "plus_times"),
        "plus_times F=4": (torch.tensor(rng.random((n_slots, 4)).astype(np.float32), device=dev), idx, val_pr, "plus_times"),
        "min_plus F=1": (x_i, idx, val_ss, "min_plus"),
        "plus_times F=1 lane_pad=8": (x_1, idx8, val8, "plus_times"),
    }
    spmv_ell_cuda.launches = 0
    outs = {label: ops.spmv(*case) for label, case in cases.items()}
    torch.cuda.synchronize()
    k3_launches = spmv_ell_cuda.launches
    if k3_launches != len(cases):
        raise AssertionError(f"ops.spmv launched K3 {k3_launches} times for {len(cases)} calls")
    log(f"[4] K3 path: {k3_launches} launches")
    same_bits = torch.equal(outs["plus_times F=1 lane_pad=8"], outs["plus_times F=1"])
    log(f"[4] K3 plus_times F=1: lane_pad 8 output equals lane_pad 128 output: {same_bits}")
    A = torch.sparse_csr_tensor(
        torch.tensor(g_pr.indptr, device=dev),
        torch.tensor(g_pr.indices.astype(np.int64), device=dev),
        torch.tensor(g_pr.values, device=dev),
        size=(g_pr.n, g_pr.n),
    )
    k3_err, spmv_timings = 0.0, []
    for label, (xx, ii, vv, sr_name) in cases.items():
        rows_, max_deg = ii.shape
        want = ref.spmv_ell_ref(xx, ii, vv, sr_name)
        got = outs[label]
        err = float((got.double() - want.double()).abs().max().item())
        k3_err = max(k3_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K3 disagrees with its plain version: {label} ({err})")
        F = xx.shape[1] if xx.ndim == 2 else 1
        xo_bytes = (n_slots + rows_) * F * 4  # x read once, out written once
        b_pad, by_pad = bound_ms(rows_ * max_deg * 8 + xo_bytes, 2 * rows_ * max_deg * F, sr_name == "plus_times")
        b_real, _ = bound_ms(g_pr.nnz * 8 + xo_bytes, 2 * g_pr.nnz * F, sr_name == "plus_times")
        lib_ms = None
        if sr_name == "plus_times":
            X = xx[:-1].reshape(g_pr.n, F).contiguous()
            lib_ms = time_ms(lambda: torch.sparse.mm(A, X))
            lib = torch.sparse.mm(A, X).reshape(got.shape)
            rel = float(((lib - got).abs().max() / lib.abs().max()).item())
            log(f"[4] sparse.mm vs K3 {label}: max rel diff {rel}")
        row = {
            "case": label,
            "rows": rows_,
            "max_deg": max_deg,
            "F": F,
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.spmv(xx, ii, vv, sr_name)),
            "plain_ms": time_ms(lambda: ref.spmv_ell_ref(xx, ii, vv, sr_name), 0.2, 3),
            "bound_ms": b_pad,
            "bound_by": by_pad,
            "bound_real_edges_ms": b_real,
            "library_ms": lib_ms,
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        spmv_timings.append(row)
        log(f"[4] K3 timing {json.dumps(row)}")
    del idx, val_pr, val_ss, idx8, val8, outs, cases, A
    torch.cuda.synchronize()
    log(f"[4] K3 done in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- 5 ---
    head = next(t for t in timings if t["problem"] == "pagerank" and t["delta"] == full["pagerank"].block_size)
    # K1's single-round entries: no path of the port launches them (phase 3
    # counts 0 on the replicated, matrix and batch paths); their arithmetic
    # runs on every path inside the loop entry, which takes each round's steps
    # through the same step_tiles.  launches is the main path's count; the
    # launches of phase 3's host-loop comparisons stand apart.
    off_path = {
        "round_block": ("round_block_solve", host_launches),
        "round_block_f4": ("round_block_solve_f4", matrix_launches["round_block"]),
        **{
            f"round_block_batch_c{C}": (f"round_block_batch_solve_c{C}", batch_round_launches_by_c.get(C, 0))
            for C in (BATCH_Q, BATCH_Q_WIDE)
        },
    }
    kernels = {
        "kernels": [
            {
                "name": "round_block",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/round_block.cu",
                "replaces": "src/repro/kernels/round_block.py:114",
                "launches": 0,
                "max_abs_err": max_abs_err,
                "ms": head["ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
            },
            {
                "name": "halo_round",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/round_block.cu",
                "replaces": "src/repro/kernels/round_block.py:204",
                "launches": halo_launches,
                "resolve_launches": evolve_halo_launches,
                "max_abs_err": halo_err,
                "ms": halo_timings[0]["ms"],
                "plain_ms": halo_timings[0]["plain_ms"],
                "bound_ms": halo_timings[0]["bound_ms"],
                "bound_by": halo_timings[0]["bound_by"],
                "library_ms": halo_timings[0]["library_ms"],
            },
            {
                "name": "round_block_f4",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/round_block.cu",
                "replaces": "src/repro/kernels/round_block.py:114",
                "launches": 0,
                "max_abs_err": matrix_err["round_block"],
                "ms": matrix_timings[0]["k1_ms"],
                "plain_ms": matrix_timings[0]["k1_plain_ms"],
                "bound_ms": matrix_timings[0]["k1_bound_ms"],
                "bound_by": matrix_timings[0]["k1_bound_by"],
                "library_ms": matrix_timings[0]["library_ms"],
            },
            {
                "name": "halo_round_f4",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/round_block.cu",
                "replaces": "src/repro/kernels/round_block.py:204",
                "launches": matrix_launches["halo_round"],
                "max_abs_err": matrix_err["halo_round"],
                "ms": matrix_timings[0]["k2_ms"],
                "plain_ms": matrix_timings[0]["k2_plain_ms"],
                "bound_ms": matrix_timings[0]["k2_bound_ms"],
                "bound_by": matrix_timings[0]["k2_bound_by"],
                "library_ms": matrix_timings[0]["library_ms"],
            },
            *(
                {
                    "name": f"round_block_batch_c{C}",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/round_block.cu",
                    "replaces": "src/repro/kernels/round_block.py:114",
                    "launches": 0,
                    "max_abs_err": batch_err,
                    "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                }
                for C, row in (
                    (BATCH_Q, batch_timings[0]),  # ppr Q = 8 at sync
                    (BATCH_Q_WIDE, batch_timings[-1]),  # ppr Q = 32 at δ*
                )
            ),
            *(
                {
                    "name": name,
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/round_block.cu",
                    "replaces": "src/repro/kernels/round_block.py:114",
                    "launches": launches,
                    "max_abs_err": loop_err[key],
                    "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": None,  # no PyTorch call runs a solve
                }
                for name, key, launches, row in (
                    ("round_block_solve", "solve", main_launches, loop_timings[0]),  # PageRank at sync
                    ("round_block_solve_f4", "solve_f4", matrix_launches["round_block_solve"], loop_f4),
                    ("round_block_batch_solve_c8", "batch", batch_launches_by_c.get(BATCH_Q, 0), loop_batch[BATCH_Q]),
                    ("round_block_batch_solve_c32", "batch", batch_launches_by_c.get(BATCH_Q_WIDE, 0),
                     loop_batch[BATCH_Q_WIDE]),
                )
            ),
            {
                "name": "spmv_ell",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/spmv_ell.cu",
                "replaces": "src/repro/kernels/spmv_ell.py:56",
                "launches": k3_launches,
                "max_abs_err": k3_err,
                "ms": spmv_timings[0]["ms"],
                "plain_ms": spmv_timings[0]["plain_ms"],
                "bound_ms": spmv_timings[0]["bound_ms"],
                "bound_by": spmv_timings[0]["bound_by"],
                "library_ms": spmv_timings[0]["library_ms"],
            },
        ]
    }
    next(k for k in kernels["kernels"] if k["name"] == "round_block_solve")["resolve_launches"] = evolve_launches
    next(k for k in kernels["kernels"] if k["name"] == "round_block_solve")["restart_launches"] = restart_launches["loop"]
    next(k for k in kernels["kernels"] if k["name"] == "halo_round")["restart_launches"] = restart_launches["k2"]
    for k in kernels["kernels"]:
        if k["name"] in off_path:
            k["on_path"] = False
            k["superseded_by"], k["host_loop_launches"] = off_path[k["name"]]
    unused = [k["name"] for k in kernels["kernels"] if k["launches"] == 0 and k["name"] not in off_path]
    if unused or min(k["host_loop_launches"] for k in kernels["kernels"] if k["name"] in off_path) == 0:
        raise AssertionError(f"kernels never launched on their paths: {unused}, or off them: {off_path}")
    log(f"[5] total {time.perf_counter() - t_all:.1f} s; {compare_launches} comparison launches")
    log(json.dumps(kernels))
    log(card_line())
    result = {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
