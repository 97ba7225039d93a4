"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure ends the run with a nonzero
exit and no result line:

1. the card's name and power limit; build every CUDA kernel from ``src/``
   (``build/kernels/``).
2. K1 (the fused-round kernel) against its plain PyTorch version, one round
   from the same ``x``, for pagerank (``add_const``), ppr (``add_table``) and
   sssp (``min_old``) at δ = sync, async (128) and 1024, on a small graph and
   at full size, and after phase 3 at every other δ the main path resolved
   (auto's δ*).  int32 must match exactly; float32 must match bit for bit
   against the plain version on the CPU (on CUDA it sums with atomics).
3. the main path, ``Solver(...).solve()`` with ``backend="kernel"`` at sync,
   async, 1024 and auto (twice: cold, then warm): PageRank on ``twitter``
   scale 22 (4.2 M vertices, 64.3 M edges) and SSSP on the same topology
   with SSSP weights, P = 8.  ``total_s`` is the wall time of the whole
   ``solve()`` call; ``rounds_s`` the sum of its rounds' times.
   K1's launch count is reset before and read after; it must be nonzero.  On
   a smaller graph the kernel solve must give the plain (``backend="torch"``,
   CPU) solve's rounds and ``x``.
4. K1's time per round at the full-size shapes, at sync, 128, 1024 and
   auto's δ* (CUDA events), beside its byte bound, the same round with no
   edges to walk (barriers, epilogues and publishes alone), the plain round's
   time, and at sync ``torch.sparse.mm`` (the PageRank round's SpMV) as the
   library yardstick.
5. the ``kernels`` line, the card's name and power limit, and the result line.

It imports neither jax nor the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12  # H100 SXM int32 (half the f32 FMA rate)
SCALE, EFACTOR, P = 22, 16, 8
SMALL_SCALE = 14
DELTAS = ("sync", 128, 1024)


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


def on(sched, device):
    """``sched`` with its tensors on ``device``."""
    moved = {
        f.name: getattr(sched, f.name).to(device)
        for f in dataclasses.fields(sched)
        if isinstance(getattr(sched, f.name), torch.Tensor)
    }
    return dataclasses.replace(sched, **moved)


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two f32 tensors."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def time_ms(fn, budget_s: float = 0.4, max_iters: int = 50) -> float:
    """Mean milliseconds per call, CUDA events around a run of calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, math.ceil(budget_s * 1e3 / est))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def round_bound(sched, table) -> tuple[float, str]:
    """Least time for one round: each real edge's index and value read once,
    the frontier (and an epilogue table) read once and written once."""
    itemsize = 4
    frontier = sched.n_slots * itemsize * 2
    bytes_ = sched.edges * 8 + frontier + (sched.n_slots * itemsize if table else 0)
    is_f32 = sched.val.dtype == torch.float32
    ops = 2 * sched.edges + sched.n  # ⊗ and ⊕ per edge, one epilogue per row
    byte_s = bytes_ / HBM_BYTES_PER_S
    op_s = ops / (F32_OPS_PER_S if is_f32 else INT32_OPS_PER_S)
    return (max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=SCALE, help="full-size graph scale")
    scale = ap.parse_args().scale
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import engine
    from repro_torch.graphs.generators import make_graph, sssp_values
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.round_block import fused_round_cuda
    from repro_torch.solve import (
        Solver,
        pagerank_problem,
        ppr_problem,
        ppr_teleport,
        sssp_problem,
    )

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    # ---------------------------------------------------------------- 1 ---
    t0 = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    for name, (secs, nvcc_log) in build.build().items():
        regs = [ln.strip() for ln in nvcc_log.splitlines() if "registers" in ln]
        log(f"[1] built {name}.cu in {secs:.2f} s; ptxas: {regs}")
    for name in build.SOURCES:
        build.load(name)
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

    # ---------------------------------------------------------------- 2 ---
    max_abs_err = 0.0
    compare_launches = 0

    def compare(label, sched, sr, epilogue, x_cpu):
        nonlocal max_abs_err, compare_launches
        dsched = on(sched, dev)
        if x_cpu.dtype == torch.float32:
            want = ref.fused_round_ref(x_cpu, on(sched, "cpu"), sr, epilogue.to("cpu"))
        else:  # int32 min-plus is order-free: the plain round on the card is exact
            want = ref.fused_round_ref(x_cpu.to(dev), dsched, sr, epilogue.to(dev)).cpu()
        got = fused_round_cuda(x_cpu.to(dev), dsched, sr, epilogue.to(dev)).cpu()
        compare_launches += 1
        a, b = got[:-1], want[:-1]
        err = float((a.double() - b.double()).abs().max().item())
        gap = ulp_gap(a, b) if a.dtype == torch.float32 else 0
        max_abs_err = max(max_abs_err, err)
        log(f"[2] {label}: S={sched.S} M={sched.M} max_abs_err={err} max_ulp={gap}")
        if not torch.equal(a, b):
            raise AssertionError(f"K1 disagrees with its plain version: {label}")

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

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    sg_pr, sg_ss = graphs(SMALL_SCALE)
    _, s_probs, s_q = problems(sg_pr)
    small = {
        "pagerank": Solver(sg_pr, s_probs["pagerank"], n_workers=P),
        "sssp": Solver(sg_ss, s_probs["sssp"], n_workers=P),
    }
    compare_all(f"s{SMALL_SCALE}", small, s_q, rng, dict.fromkeys(small, DELTAS))
    log(f"[2] small graphs done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    g_pr, g_ss = graphs(scale)
    hub, probs, q = problems(g_pr)
    log(
        f"[2] twitter s{scale}: n={g_pr.n} nnz={g_pr.nnz}, sssp source {hub} "
        f"(out-degree {int(g_pr.out_degree[hub])}); generated in {time.perf_counter() - t0:.1f} s"
    )
    t0 = time.perf_counter()
    full = {name: Solver(g, probs[name], n_workers=P) for name, g in (("pagerank", g_pr), ("sssp", g_ss))}
    compare_all(f"s{scale}", full, q, rng, dict.fromkeys(full, DELTAS))
    log(f"[2] full size done in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- 3 ---
    t0 = time.perf_counter()
    resolved = {name: set() for name in full}  # every δ the main path ran
    fused_round_cuda.launches = 0
    for name, solver in full.items():
        # auto twice: the first call also runs the sync and async probes,
        # fits the δ model and builds δ*'s schedule; the second is warm
        for d in ("sync", "async", 1024, "auto", "auto"):
            before = fused_round_cuda.launches
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
                "rounds_s": r.total_time_s,
                "ms_per_round": r.total_time_s / r.rounds * 1e3,
                "launches": fused_round_cuda.launches - before,
            }
            resolved[name].add(r.delta)
            log(f"[3] solve {json.dumps(row)}")
            if row["launches"] == 0:
                raise AssertionError(f"the solve never launched K1: {row}")
            if not (r.converged and np.isfinite(r.x.astype(np.float64)).all()):
                raise AssertionError(f"solve did not converge to finite values: {row}")
    main_launches = fused_round_cuda.launches
    if main_launches == 0:
        raise AssertionError("the main path never launched K1")
    log(f"[3] main path: {main_launches} K1 launches; done in {time.perf_counter() - t0:.1f} s")

    # K1 vs plain at the δ the main path resolved beyond phase 2's (auto's δ*)
    t0 = time.perf_counter()
    compared = {name: {solver.resolve_delta(d) for d in DELTAS} for name, solver in full.items()}
    extra = {name: sorted(resolved[name] - compared[name]) for name in full}
    compare_all(f"s{scale}", full, q, rng, extra)
    log(f"[3] K1 vs plain at the main path's other δ {extra}; done in {time.perf_counter() - t0:.1f} s")

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
            p_ms = time_ms(lambda: plain(x), budget_s=0.2, max_iters=5)
            b_ms, b_by = round_bound(sched, None)
            lib_ms = None
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
                "plain_ms": p_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "share_of_bound": b_ms / k_ms,
                "library_ms": lib_ms,
            }
            timings.append(row)
            log(f"[4] timing {json.dumps(row)}")
    torch.cuda.synchronize()
    log(f"[4] done in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- 5 ---
    head = next(t for t in timings if t["problem"] == "pagerank" and t["delta"] == full["pagerank"].block_size)
    kernels = {
        "kernels": [
            {
                "name": "round_block",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/round_block.cu",
                "replaces": "src/repro/kernels/round_block.py:114",
                "launches": main_launches,
                "max_abs_err": max_abs_err,
                "ms": head["ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
            }
        ]
    }
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
