// K1: one full engine round (all S commit steps) in one cooperative launch,
// and K2: a range of commit steps of the halo round, for all D shards, in
// one cooperative launch (second entry point, further down).
//
// Replaces the TPU kernel src/repro/kernels/round_block.py::fused_round_fn_q
// (its pallas_call runs the S steps as a sequential grid with the frontier
// aliased in VMEM).  Here the S steps are a loop inside one persistent
// cooperative launch:
//
//   for s in 0..S-1:
//     every tile of step s (R consecutive local rows of one worker's chunk),
//     one block each:
//       acc[r] = (+) over row r's edges, in edge order, of x[src] (x) val
//       scratch[w, r] = epilogue(old = x[rows[s,w,r]], acc[r], rows[s,w,r])
//     grid.sync()
//     publish scratch into x at rows[s] (dump rows, == n, are skipped)
//     grid.sync()
//
// so step s reads every commit of the steps before it and none of its own:
// the block Gauss-Seidel order of src/repro/core/engine.py::_commit_step.
//
// The frontier is a vector (n+1,) or a matrix (n+1, F), row-major: a
// vertex's F values are one row, and acc, the epilogue and the publish work
// on rows.  Every feature's sum is the vector kernel's sum of that column
// (edge order, one edge weight for all F).  Which code an F reaches:
//   F = 1        the vector kernel's code (kF = 1): 4-B gathers;
//   F = 2, 4, 8  kF = F: one 8-B (F = 2) or 16-B (F = 4; two for F = 8)
//                load a gathered row, the edges staged once for all F,
//                F accumulators in registers;
//   any other F  kF = 0: a loop over blocks of kFeatBlock = 4 columns; each
//                block walks the tile's edges again with scalar gathers and
//                leaves its raw sums in scratch, and the epilogue then runs
//                over the whole row from scratch.  Labelprop at F = 1 runs
//                here too, so the vector build carries no labelprop code.
// The wrapper checks that an F = 2/4/8 frontier (and table) starts at a
// multiple of the vector width; rows then stay aligned.
//
// A batch of Q queries (the query axis that repro/solve/batch.py gets by
// vmapping fused_round_fn_q) runs in the same kernel, entry point
// round_block_batch_launch.  The batch lives on the card vertex-major,
// (n+1, Q)+feat: one row a vertex holding its C = Q*F values contiguous,
// the wrapper's callers transposing only at a batch's entry and exit and
// at a compaction, never per round.  So a gathered source row holds every
// query's values and a tile's edges are staged once for all Q: one schedule,
// one walk of the edges, Q answers.  The TPU kernel, vmapped, keeps
// (Q, n+1) and walks the edges once a query.  Each (row, query, feature)
// is still summed in edge order from the (+)-identity, so every query's
// bits are those of the single-query kernel.  The epilogue sees C columns
// in groups of G: G = F for labelprop, whose total, division and FMA run
// over each query's own F columns (left to right, as for one query), and
// G = C for every other tag, which works column by column (add_const adds
// one constant to all, add_table reads an (n+1, C) table, the Q queries'
// tables side by side, min_old takes each column's old value).  Which
// code a batch's C reaches: as F above for C = 1, 2, 4, 8 and any C not
// listed; C = 16 and 32 have builds of their own (kF = C) whose walk stages
// a tile's edges once and gathers and folds its rows kSubCols = 8 columns
// at a time (two 16-B loads a gathered row a pass, C sums in registers;
// their epilogue operands load after the walk, not beside it, to hold the
// registers down).  The single-query entry point round_block_launch keeps
// its widths (F = 16 runs the feature-block build there).
//
// Epilogues (tags as in repro_torch/kernels/round_block.py::TAG_CODES):
// add_const c + acc, add_table table[row] + acc, min_old min(old, acc), and
// labelprop, label propagation's row update:
//   total = ((acc_0 + acc_1) + acc_2) + ...   (left to right, __fadd_rn)
//   prop_f = total > 0 ? fma(mix, acc_f / total, (1 - mix) * old_f) : old_f
//   new_f  = sum of the anchor row > 0 ? anchor_f : prop_f
// The reference writes mix * (reduced / safe) + (1 - mix) * old; XLA
// contracts that into one FMA (fma(mix, q, fl((1 - mix) * old))), and
// jnp.sum adds F columns left to right, so the finish does the same: an
// IEEE division (__fdiv_rn), the product rounded (__fmul_rn), and one
// __fmaf_rn.  mix and 1 - mix arrive as float32 values rounded from the
// Python doubles.  The build passes --fmad=false, so nothing else fuses.
//
// Bound on the H100: bytes.  A round must read each real edge's src index and
// value once (8 B an edge) and read and write the frontier once (F values a
// row, and an add_table/labelprop table of F values a row once): for twitter
// scale 22 (64.3 M edges, 4.2 M rows) about 0.55 GB at F = 1, 0.16 ms at
// 3.35 TB/s, and 0.65 GB at F = 4 (0.19 ms; 0.72 GB and 0.21 ms with a
// table).  At fine delta the fixed cost of a commit step dominates instead:
// the 2*S grid barriers (8,198 a round at delta = 128) and one step's
// latency chain (PERF.md).  That is this card's form of the paper's
// commit-cost trade-off.
//
// Design: tiles, staged edges, rows folded in order.  The schedule keeps a
// cell's edges grouped by local row with the padding last
// (core/engine.py::_cell_row_ptr), so a tile's edges are the one run
// [row_ptr[r0], row_ptr[r0 + R]) of src and val, and a tile never straddles
// two cells.  The block walks that run kChunk = 1,024 edges at a time
// (stage_fold, which K2 shares):
//   stage  every thread loads 4 of the chunk's src and val (neighbouring
//          threads on neighbouring edges, streamed past L1 with
//          ld.global.cs so they leave it to x), gathers their x rows (4
//          independent loads in flight a thread, not one dependent chain a
//          row), and writes the products (F a row) to shared memory;
//   fold   the thread that owns row r adds the chunk's products of its row
//          in edge order from shared memory, one sum a feature, carrying
//          the sums from chunk to chunk.
// The sum is thus the plain round's (edge order from the (+)-identity, no
// float atomics) bit for bit: plus-times starts at 0.0f with
// __fmul_rn/__fadd_rn (the build passes --fmad=false); min-plus starts at
// int32 max (what an empty jax segment_min reads) and computes
// min(x + val, INT_INF) with a wrapping int32 add.  Each row's epilogue
// operands (the table row, or the old row) are loaded beside its edge range,
// before the walk, not after it.  The price of the order is the fold: one
// thread adds a row's products serially, so a row longer than a chunk (a
// hub's in-edges, on a skewed graph) is folded by one thread over many
// chunks while the block's other threads wait at the barrier; on twitter
// scale 22 no row has more than 38 edges, and the fold is a few percent of
// the walk (PERF.md).  What is left bounds the walk: the random gathers of
// x, each an L2 sector of 32 B where L1 misses (a 4-B value at F = 1, a
// 16-B row at F = 4).
//
// Tile size by delta: a step has P*delta rows.  R is that over the blocks
// that fit on the card at once (clamped to [8, 256] rows), so at delta = 128
// (1,024 rows a step) 128 small tiles spread the step over 128 SMs, and at
// sync and delta* a tile is about one per resident block and step.  The grid
// is at most what is co-resident, which a cooperative launch needs; the
// occupancy query runs once per kernel and device.  The staging buffer is
// static shared memory (kChunk rows of F products), which that query counts
// itself (no dynamic size).
//
// Loads of x go through L1 (ld.global.ca), where the hot sources
// (out-degree up to 2.67 M) stay within a step.  Other blocks write x
// between steps; grid.sync() orders those writes before the next step's
// reads: it is a gpu-scope release (fence, then the barrier's atomic) by
// every writer and an acquire (the fence after the barrier is observed) by
// every reader, and the PTX memory model makes a weak load that follows the
// acquire observe every write that preceded the release.  The hardware keeps
// that promise for L1-cached loads by invalidating L1 at the gpu-scope
// fence.  The card tests and chip_smoke.py check it: K1 equals its plain
// round bit for bit at S > 1 (delta = 1, 7, 128, 301, 1024, 3001, delta*).

#include <cooperative_groups.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int32_t kIntInf = (1 << 30) - 1;
constexpr int32_t kInt32Max = 0x7fffffff;

// Epilogue tags (must match repro_torch/kernels/round_block.py::TAG_CODES).
constexpr int kAddConst = 0;   // c + acc              (pagerank)
constexpr int kAddTable = 1;   // table[row] + acc     (ppr's q, jacobi's b/diag, rwr)
constexpr int kMinOld = 2;     // min(old, acc)        (sssp, cc)
constexpr int kLabelprop = 3;  // the blend above      (label propagation)

// Columns a pass of the walk takes: kF, or kFeatBlock for any other F.
// A wider kF (a batch's C = 16, 32) gathers and stages its columns
// kSubCols at a time within one pass.
constexpr int kFeatBlock = 4;
constexpr int kSubCols = 8;
template <int kF>
constexpr int kPassCols = kF > 0 ? (kF < kSubCols ? kF : kSubCols) : kFeatBlock;

// Vector types of a row's load or store (float and int32 rows alike).
template <class T> struct Vec;
template <> struct Vec<float> { using v2 = float2; using v4 = float4; };
template <> struct Vec<int32_t> { using v2 = int2; using v4 = int4; };

// How a row is read: through L1 (gathers of x), through L2 only (min-plus's
// old, which this step's publish will overwrite), or plainly (tables).
enum Via { kCa, kCg, kPlain };

template <Via kVia, class V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kVia == kCa) return __ldca(p);
  else if constexpr (kVia == kCg) return __ldcg(p);
  else return *p;
}

// Loads N values of a row at p: as vectors when kVec (N = F = 2, 4 or 8,
// p aligned to the vector), else the first fn of them one by one (the rest
// read as zero).
template <int N, bool kVec, Via kVia, class T>
__device__ __forceinline__ void load_row(const T* p, T (&out)[N], int fn) {
  if constexpr (kVec && N == 2) {
    const auto v = ld<kVia>(reinterpret_cast<const typename Vec<T>::v2*>(p));
    out[0] = v.x;
    out[1] = v.y;
  } else if constexpr (kVec && N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const auto v = ld<kVia>(reinterpret_cast<const typename Vec<T>::v4*>(p + j));
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = (kVec || j < fn) ? ld<kVia>(p + j) : T();
  }
}

// Stores the first fn of N values of a row at p (all N, as vectors, when kVec).
template <int N, bool kVec, class T>
__device__ __forceinline__ void store_row(T* p, const T (&v)[N], int fn) {
  if constexpr (kVec && N == 2) {
    typename Vec<T>::v2 w;
    w.x = v[0];
    w.y = v[1];
    *reinterpret_cast<typename Vec<T>::v2*>(p) = w;
  } else if constexpr (kVec && N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      typename Vec<T>::v4 w;
      w.x = v[j];
      w.y = v[j + 1];
      w.z = v[j + 2];
      w.w = v[j + 3];
      *reinterpret_cast<typename Vec<T>::v4*>(p + j) = w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (kVec || j < fn) p[j] = v[j];
    }
  }
}

// Copies a row of F values (kF of them as vectors; F one by one when kF = 0).
template <int kF, class T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int F) {
  if constexpr (kF > 0) {
    T v[kF];
    load_row<kF, true, kPlain>(src, v, kF);
    store_row<kF, true>(dst, v, kF);
  } else {
    for (int f = 0; f < F; ++f) dst[f] = src[f];
  }
}

// The epilogue is split: its operands (the table row, the old row) are
// loaded beside the row's edge range, before the row is summed, and finish()
// applies them to the sums.  finish() takes a row of `cols` values: N when
// N > 0 (registers), else fn (a row in memory; out may be acc), in groups
// of G columns (G divides cols; only labelprop reads G).
struct PlusTimes {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T mul(T x, T a) { return __fmul_rn(x, a); }
  __device__ static T add(T acc, T v) { return __fadd_rn(acc, v); }
  __device__ static bool wants_table(int tag) { return tag == kAddTable || tag == kLabelprop; }
  __device__ static bool wants_old(int tag) { return tag == kLabelprop; }
  __device__ static T blend(T a, T total, T mass, T t, T o, float mix, float one_minus_mix) {
    const T prop = total > 0.0f ? __fmaf_rn(mix, __fdiv_rn(a, total), __fmul_rn(one_minus_mix, o)) : o;
    return mass > 0.0f ? t : prop;
  }
  template <int N>
  __device__ static void finish(int tag, const T* acc, const T* tab, const T* old, T c,
                                float mix, float one_minus_mix, int fn, int G, T* out) {
    const int cols = N > 0 ? N : fn;
    // the vector build (N = 1) leaves labelprop out: an (n+1, 1) labelprop
    // frontier runs the feature-block build (round_block_launch)
    if (N != 1 && tag == kLabelprop) {
      if constexpr (N > 1) {
        // Registers: running sums left to right that restart at each
        // group's first column; then each group's last column's sums, its
        // total and mass, fill the group backwards.  Indices stay static.
        T total[N], mass[N];
        bool last[N];
        int pos = 0;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const bool first = j == 0 || pos == 0;
          total[j] = first ? acc[j] : __fadd_rn(total[j > 0 ? j - 1 : 0], acc[j]);
          mass[j] = first ? tab[j] : __fadd_rn(mass[j > 0 ? j - 1 : 0], tab[j]);
          pos = pos + 1 == G ? 0 : pos + 1;
          last[j] = pos == 0;
        }
#pragma unroll
        for (int j = N - 2; j >= 0; --j) {
          if (!last[j]) {
            total[j] = total[j + 1];
            mass[j] = mass[j + 1];
          }
        }
#pragma unroll
        for (int j = 0; j < N; ++j) out[j] = blend(acc[j], total[j], mass[j], tab[j], old[j], mix, one_minus_mix);
      } else {
        for (int g0 = 0; g0 < cols; g0 += G) {
          T total = acc[g0], mass = tab[g0];
          for (int j = g0 + 1; j < g0 + G; ++j) {
            total = __fadd_rn(total, acc[j]);
            mass = __fadd_rn(mass, tab[j]);
          }
          for (int j = g0; j < g0 + G; ++j) out[j] = blend(acc[j], total, mass, tab[j], old[j], mix, one_minus_mix);
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < cols; ++j) out[j] = tag == kAddConst ? __fadd_rn(c, acc[j]) : __fadd_rn(tab[j], acc[j]);
  }
};

struct MinPlus {
  using T = int32_t;
  __device__ static T zero() { return kInt32Max; }
  __device__ static T mul(T x, T a) {
    const T s = static_cast<T>(static_cast<uint32_t>(x) + static_cast<uint32_t>(a));
    return s < kIntInf ? s : kIntInf;
  }
  __device__ static T add(T acc, T v) { return v < acc ? v : acc; }
  __device__ static bool wants_table(int) { return false; }
  __device__ static bool wants_old(int) { return true; }
  template <int N>
  __device__ static void finish(int, const T* acc, const T*, const T* old, T, float, float,
                                int fn, int, T* out) {
    const int cols = N > 0 ? N : fn;
#pragma unroll
    for (int j = 0; j < cols; ++j) out[j] = acc[j] < old[j] ? acc[j] : old[j];
  }
};

constexpr int kChunk = 1024;  // edges a tile stages at once (4 a thread)
constexpr int kMinTileRows = 8;
constexpr int kMaxDevices = 64;
constexpr int kMaxShards = 64;   // D of a halo launch
constexpr int kMaxScales = 512;  // D * F of a quantized halo launch (a block keeps D*F maxima)
// K2 asks for K1's occupancy: at 76 registers (its f32 build's own choice)
// 3 blocks fit an SM, at 64 four, and the round is faster (PERF.md).  A
// batch's C = 16 and 32 builds hold C sums in registers and ask for one
// block, as K1's batch entry does.
constexpr int kHaloBlocksPerSm = 4;
template <int kF>
constexpr int kHaloMinBlocks = kF > 8 ? 1 : kHaloBlocksPerSm;

// torch.clamp's rule: a NaN passes through (fmaxf and fminf would drop it).
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The tile walk of K1 and K2: the block's tile is the edge run [t0, t1) of
// src and val, grouped by row; this thread's row (if it owns one) is the
// part [e0, e1).  It sums columns [f0, f0 + N) of the gathered rows of x
// (row stride F; N = F when kVec).  The run is staged kChunk edges at a
// time: every thread loads 4 of the chunk's src and val (streamed), gathers
// their x rows through L1 and writes the products to prod (N a row); then
// the thread that owns a row adds the chunk's products of its row in edge
// order, one sum a column, carrying the sums from chunk to chunk.  Leaves
// the sums in acc (the (+)-identity for an empty range).  N above kSubCols
// (kVec) takes each chunk's src and val once and then gathers, stages and
// folds its columns kSubCols at a time.  Every thread of the block must call
// it with the same t0 and t1.
template <class Sr, int N, bool kVec>
__device__ __forceinline__ void stage_fold(
    const typename Sr::T* x, const int32_t* __restrict__ src,
    const typename Sr::T* __restrict__ val, int t0, int t1, int e0, int e1,
    int F, int f0, typename Sr::T* prod, typename Sr::T (&acc)[N]) {
  using T = typename Sr::T;
  constexpr int kPer = kChunk / kThreads;
  constexpr int kSub = N < kSubCols ? N : kSubCols;  // columns staged a pass
  static_assert(N % kSub == 0 && (kVec || N == kSub), "sub-blocks are whole vector rows");
  const int tid = threadIdx.x;
  const int stride = kVec ? N : F;
  const int fn = kVec ? N : min(N, F - f0);
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = Sr::zero();
  for (int cs = t0; cs < t1; cs += kChunk) {
    const int cn = min(kChunk, t1 - cs);
    const int32_t* sp = src + cs + tid;
    const T* vp = val + cs + tid;
    int32_t sv[kPer];
    T vv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k * kThreads + tid < cn) {
        sv[k] = __ldcs(sp + k * kThreads);
        vv[k] = __ldcs(vp + k * kThreads);
      }
    }
#pragma unroll
    for (int b = 0; b < N; b += kSub) {
      T xv[kPer][kSub];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k * kThreads + tid < cn) load_row<kSub, kVec, kCa>(x + sv[k] * stride + f0 + b, xv[k], fn - b);
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k * kThreads + tid < cn) {
          T* pp = prod + (k * kThreads + tid) * kSub;
#pragma unroll
          for (int j = 0; j < kSub; ++j) pp[j] = Sr::mul(xv[k][j], vv[k]);
        }
      }
      __syncthreads();
      const int lo = max(e0, cs);
      const int hi = min(e1, cs + cn);
      for (int e = lo; e < hi; ++e) {
        const T* pp = prod + (e - cs) * kSub;
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[b + j] = Sr::add(acc[b + j], pp[j]);
      }
      __syncthreads();
    }
  }
}

// One tile's rows of one commit step, for K1 and K2's phase A: sums the
// rows' edges over every column and writes each owned row's new value to
// out_row = scratch + (its chunk index) * F.  xg is the frontier the
// gathers read (K2: the shard's); old_row and tab_row are the row's
// operands in x and the table (null where the tag reads none).  kF > 0:
// one pass with kF sums in registers (the operands loaded before the walk
// up to kSubCols columns, after it above); kF = 0: a pass per block of
// kFeatBlock columns, raw sums through out_row, then the finish over it.
// G: the epilogue's group width (finish()).
template <class Sr, int kF>
__device__ __forceinline__ void tile_rows(
    const typename Sr::T* xg, const int32_t* __restrict__ src,
    const typename Sr::T* __restrict__ val, int t0, int t1, bool own, int e0,
    int e1, const typename Sr::T* old_row, const typename Sr::T* tab_row,
    typename Sr::T* out_row, int tag, typename Sr::T c, float mix,
    float one_minus_mix, int F, int G, typename Sr::T* prod) {
  using T = typename Sr::T;
  if constexpr (kF > 0) {
    constexpr bool kEarly = kF <= kSubCols;
    T old[kF], tab[kF], acc[kF];
    if (kEarly && own) {
      if (Sr::wants_old(tag)) load_row<kF, true, kCg>(old_row, old, kF);
      if (Sr::wants_table(tag)) load_row<kF, true, kPlain>(tab_row, tab, kF);
    }
    stage_fold<Sr, kF, true>(xg, src, val, t0, t1, e0, e1, kF, 0, prod, acc);
    if (own) {
      if (!kEarly) {
        if (Sr::wants_old(tag)) load_row<kF, true, kCg>(old_row, old, kF);
        if (Sr::wants_table(tag)) load_row<kF, true, kPlain>(tab_row, tab, kF);
      }
      T out[kF];
      Sr::template finish<kF>(tag, acc, tab, old, c, mix, one_minus_mix, kF, G, out);
      store_row<kF, true>(out_row, out, kF);
    }
  } else {
    for (int f0 = 0; f0 < F; f0 += kFeatBlock) {
      T acc[kFeatBlock];
      stage_fold<Sr, kFeatBlock, false>(xg, src, val, t0, t1, e0, e1, F, f0, prod, acc);
      if (own) store_row<kFeatBlock, false>(out_row + f0, acc, min(kFeatBlock, F - f0));
    }
    if (own) Sr::template finish<0>(tag, out_row, tab_row, old_row, c, mix, one_minus_mix, F, G, out_row);
  }
}

// K1's commit step s: every tile of the step's P * delta chunk rows, each
// block taking tiles blockIdx.x, blockIdx.x + gridDim.x, ..., through
// tile_rows into scratch (F values a chunk row).  round_kernel and
// solve_kernel both run their steps through it, so a round's bits are one.
template <class Sr, int kF>
__device__ __forceinline__ void step_tiles(
    const typename Sr::T* x, typename Sr::T* scratch, const int32_t* __restrict__ src,
    const typename Sr::T* __restrict__ val, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ rows, const typename Sr::T* __restrict__ table,
    typename Sr::T c, float mix, float one_minus_mix, int tag, int s, int P, int M,
    int delta, int R, int F, int G, typename Sr::T* prod) {
  const int tid = threadIdx.x;
  const int tiles_per_cell = (delta + R - 1) / R;
  const long long tiles = static_cast<long long>(P) * tiles_per_cell;
  const long long step_cell = static_cast<long long>(s) * P;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int w = static_cast<int>(t / tiles_per_cell);
    const int r0 = static_cast<int>(t - static_cast<long long>(w) * tiles_per_cell) * R;
    const int rn = min(R, delta - r0);
    const long long cell = step_cell + w;
    const int32_t* ptr = row_ptr + cell * (delta + 1) + r0;
    const int t0 = ptr[0];
    const int t1 = ptr[rn];
    const bool own = tid < rn;
    // this thread's row: its edge range and its epilogue's operands
    const long long i = static_cast<long long>(w) * delta + r0 + tid;
    int e0 = 0, e1 = 0;
    long long at = 0;
    if (own) {
      e0 = ptr[tid];
      e1 = ptr[tid + 1];
      at = static_cast<long long>(rows[step_cell * delta + i]) * F;
    }
    tile_rows<Sr, kF>(x, src + cell * M, val + cell * M, t0, t1, own, e0, e1, x + at,
                      table + at, scratch + i * F, tag, c, mix, one_minus_mix, F, G, prod);
  }
}

template <class Sr, int kF>
__global__ void __launch_bounds__(kThreads)
    round_kernel(typename Sr::T* x, typename Sr::T* scratch,
                 const int32_t* __restrict__ src,
                 const typename Sr::T* __restrict__ val,
                 const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ rows,
                 const typename Sr::T* __restrict__ table, typename Sr::T c,
                 float mix, float one_minus_mix, int tag, int n, int S, int P,
                 int M, int delta, int R, int F_in, int G) {
  using T = typename Sr::T;
  __shared__ __align__(16) T prod[kChunk * kPassCols<kF>];
  cg::grid_group grid = cg::this_grid();
  const int F = kF > 0 ? kF : F_in;
  const long long cells = static_cast<long long>(P) * delta;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int s = 0; s < S; ++s) {
    const long long step_cell = static_cast<long long>(s) * P;
    step_tiles<Sr, kF>(x, scratch, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, s, P,
                       M, delta, R, F, G, prod);
    grid.sync();
    for (long long i = first; i < cells; i += stride) {
      const int row = rows[step_cell * delta + i];
      if (row < n) copy_row<kF>(x + static_cast<long long>(row) * F, scratch + i * F, F);
    }
    grid.sync();
  }
}

// Blocks of `kernel` that fit on the card at once (the most a cooperative
// launch may have), asked once per kernel and device and kept in `cache`.
// An ordinary launch (cooperative = false) asks the same to size its tiles.
cudaError_t resident_blocks(const void* kernel, int* cache, int* blocks, bool cooperative = true) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (cooperative && !coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (*blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

// Rows a tile and blocks of a launch whose commit steps have P * delta rows:
// one tile per resident block and step, within [8, 256] rows (and at most
// delta), and no more blocks than tiles or than fit.
void tile_grid(int P, int delta, int resident, int* R, int* blocks) {
  long long r = (static_cast<long long>(P) * delta + resident - 1) / resident;
  if (r < kMinTileRows) r = kMinTileRows;
  if (r > kThreads) r = kThreads;
  if (r > delta) r = delta;
  *R = static_cast<int>(r);
  long long b = static_cast<long long>(P) * ((delta + r - 1) / r);
  if (b > resident) b = resident;
  *blocks = b < 1 ? 1 : static_cast<int>(b);
}

template <class Sr, int kF>
cudaError_t launch(void* x, void* scratch, const void* src, const void* val,
                   const void* row_ptr, const void* rows, const void* table,
                   double c_in, double mix_in, double one_minus_mix_in, int tag,
                   int n, int S, int P, int M, int delta, int F, int G,
                   cudaStream_t stream) {
  using T = typename Sr::T;
  T* x_p = static_cast<T*>(x);
  T* scratch_p = static_cast<T*>(scratch);
  const int32_t* src_p = static_cast<const int32_t*>(src);
  const T* val_p = static_cast<const T*>(val);
  const int32_t* ptr_p = static_cast<const int32_t*>(row_ptr);
  const int32_t* rows_p = static_cast<const int32_t*>(rows);
  const T* table_p = static_cast<const T*>(table);
  T c = static_cast<T>(c_in);
  float mix = static_cast<float>(mix_in);
  float one_minus_mix = static_cast<float>(one_minus_mix_in);
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&round_kernel<Sr, kF>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  tile_grid(P, delta, resident, &R, &blocks);
  void* args[] = {&x_p, &scratch_p, &src_p, &val_p, &ptr_p, &rows_p,
                  &table_p, &c, &mix, &one_minus_mix, &tag, &n,
                  &S, &P, &M, &delta, &R, &F, &G};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K1's loop entry: rounds until every query's residual is <= tol, or
// max_rounds, in one cooperative launch (entry point round_block_solve_launch).
//
// Replaces the loop around the TPU kernel: src/repro/core/engine.py::
// make_solve_fn_q, a lax.while_loop over fused_round_fn_q that tests an f32
// residual against an f32 tol, and its batch forms in src/repro/solve/batch.py
// (_make_batch_solve_fn, one loop a compaction chunk; _make_open_batch_solve_fn,
// one loop a BatchStepper quantum).  The host reads the result back once.
//
//   do
//     for s in 0..S-1:
//       K1's step (step_tiles: round_kernel's walk, so the same bits);
//       grid.sync()
//       publish: lane l < lanes (lanes = the grid's threads rounded down to
//         a multiple of Q) owns query l % Q's Fq values of the cells l / Q,
//         l / Q + lanes / Q, ... (one query: whole rows, as vectors at
//         C = 2, 4, 8); it adds |new - old| (l1) or (new != old)
//         (count-changed) into its share of the round's residual, old being
//         the value the publish overwrites: each real row is published once
//         a round, so that is the round-start value and no round-start copy
//         of x is kept;
//       grid.sync()   (the last step's: after each block has folded its lanes'
//                      shares into part[q, block], one sum a query)
//     every block folds part[q, 0..blocks) of every query itself, compares
//       the sum, as f32, with float(tol) and updates its own flags
//   while some query is unconverged and rounds < max_rounds
//
// The fold needs no barrier of its own: the last step's grid.sync orders
// every block's part writes before any block reads them, and part is next
// written after round r + 1's first grid.sync, which no block passes before
// every block has folded round r.  Every block adds the same partials in the
// same order, so every block reaches the same sums and the same decision,
// and all leave the loop on the same round.  Each block keeps its own copy of
// the convergence flags (flags[q, block], read and written by that block
// only); block 0 alone writes the out-state (conv, rpq, res, the round count).
//
// Order: a lane adds its values in cell order, a block folds its lanes in a
// fixed tree (one query) or in lane order (a batch), the fold adds the
// blocks' partials in block order, 256-strided, and folds those in a fixed
// tree: the same sum every launch of a grid size.  Count-changed sums are
// integers, exact below 2^24, so SSSP and CC stop on the reference's round.
// An l1 sum adds the same terms in another order than XLA's reduce, so a
// residual within an ulp or so of tol could stop on another round than the
// reference's.
//
// A batch (C = Q * Fq columns, Fq a query's own) keeps one residual a query,
// and a lane's share is its query's.  A closed batch iterates
// every query until all have converged; each query's first-convergence round
// is stamped on the card.  An open batch (freeze) publishes nothing for a
// query converged at the round's start (conv0, or an earlier round of this
// call), so its state and residual stay: queries never share a column, so
// that is the reference's where(frozen, X, X_new).
//
// The loop's state (the round count, a lane's residual share, its cells and
// query, whether it publishes) lives in shared memory and is re-read after
// the barriers, the state's pointers are formed where they are used, and
// the kernel asks for round_kernel's occupancy (kSolveMinBlocks).  A lane
// publishes its cells one after another (a store may alias the next cell's
// loads), so a lane's cells set the publish's time: one query publishes
// whole rows, as round_kernel does, and a batch one query's values of a row
// a lane, Q lanes a row (PERF.md).
// max_rounds <= 0 never launches: the wrapper returns x as it was, with
// res = inf and rounds = 0, as the reference's while-loop does.
//
// state (int32): [0] rounds, then conv (Q; the caller's conv0), rpq (Q) and
// res (Q floats' bits).  part: Q * blocks floats, then Q * blocks int32 flags.
constexpr int kStateHead = 1;
constexpr int kResL1 = 0;       // sum of |new - old|
constexpr int kResChanged = 1;  // count of new != old
constexpr int kResNone = 2;     // none (timing only, C = 1: the publish alone, no read of old; res = 0)

template <class Sr>
__device__ __forceinline__ float residual_term(int kind, typename Sr::T nw, typename Sr::T old) {
  if (kind == kResL1) return fabsf(__fsub_rn(static_cast<float>(nw), static_cast<float>(old)));
  return nw != old ? 1.0f : 0.0f;
}

// Tree-sums red[0..kThreads) into red[0] in a fixed order (every thread calls).
__device__ __forceinline__ void block_tree_sum(float* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int w = kThreads / 2; w > 0; w /= 2) {
    __syncthreads();
    if (tid < w) red[tid] = __fadd_rn(red[tid], red[tid + w]);
  }
  __syncthreads();
}

// Blocks an SM the loop entry asks for: round_kernel's own occupancy
// (ptxas -v: 64 registers at kF = 1 and 2, 77-80 at kF = 4 and 0, 98-128 at
// kF = 8), so that it runs on round_kernel's grid.  Left to itself ptxas
// gives kF = 4 and 0 100-105 registers (a block fewer an SM), and told
// nothing less than one block kF = 1 80 registers (three blocks, against
// four).  Held to round_kernel's occupancy, kF = 1, 2, 4, 16 and 32 spill
// nothing, the plus-times kF = 8 build 4 B and the feature-block builds
// 16-40 B (round_kernel's min-plus one spills 16 B): values that live
// across the step loop.  chip_smoke.py phase 1 prints ptxas -v for every
// build, and phase 4 times the loop a round beside K1's (PERF.md).
template <int kF>
constexpr int kSolveMinBlocks = kF == 1 || kF == 2 ? 4 : kF == 0 || kF == 4 ? 3 : kF == 8 ? 2 : 1;

template <class Sr, int kF>
__global__ void __launch_bounds__(kThreads, kSolveMinBlocks<kF>)
    solve_kernel(typename Sr::T* x, typename Sr::T* scratch,
                 const int32_t* __restrict__ src,
                 const typename Sr::T* __restrict__ val,
                 const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ rows,
                 const typename Sr::T* __restrict__ table, typename Sr::T c,
                 float mix, float one_minus_mix, int tag, int n, int S, int P,
                 int M, int delta, int R, int F_in, int G, int Fq, int kind,
                 float tol, int max_rounds, int freeze, float* part,
                 int32_t* state) {
  using T = typename Sr::T;
  __shared__ __align__(16) T prod[kChunk * kPassCols<kF>];
  __shared__ float lane_res[kThreads];  // this lane's share of the round's residual
  __shared__ int lane_skip[kThreads];   // 1: the lane publishes nothing this round
  __shared__ int lane_cell[kThreads];   // the lane's first cell, lane / Q
  __shared__ int lane_q[kThreads];      // its query, lane % Q
  __shared__ int lane_step;             // cells between its cells, lanes / Q
  __shared__ int round_s;               // rounds done before this one
  __shared__ int block_live;            // 1: some query is unconverged after this round
  cg::grid_group grid = cg::this_grid();
  const int C = kF > 0 ? kF : F_in;  // values a row
  const int tid = threadIdx.x;
  const long long cells = static_cast<long long>(P) * delta;
  {
    const int Q = C / Fq;
    const int lane = blockIdx.x * kThreads + tid;
    lane_cell[tid] = lane / Q;
    lane_q[tid] = lane % Q;
    if (tid == 0) {
      lane_step = gridDim.x * kThreads / Q;
      round_s = 0;
    }
    // this block's flags start as conv0 (block 0 writes conv only after a grid.sync)
    int32_t* flags = reinterpret_cast<int32_t*>(part) + static_cast<long long>(Q) * gridDim.x;
    for (int q = tid; q < Q; q += kThreads) {
      flags[static_cast<long long>(q) * gridDim.x + blockIdx.x] = state[kStateHead + q];
    }
  }
  __syncthreads();
  for (;;) {
    {  // the round's start: this lane's share, and whether it publishes
      const int lane = blockIdx.x * kThreads + tid;
      const int Q = C / Fq;
      const int32_t* flags = reinterpret_cast<const int32_t*>(part) + static_cast<long long>(Q) * gridDim.x;
      lane_res[tid] = 0.0f;
      lane_skip[tid] = lane >= lane_step * Q ||
                       (freeze && flags[static_cast<long long>(lane_q[tid]) * gridDim.x + blockIdx.x]);
    }
    for (int s = 0; s < S; ++s) {
      const long long step_cell = static_cast<long long>(s) * P;
      step_tiles<Sr, kF>(x, scratch, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, s, P,
                         M, delta, R, C, G, prod);
      grid.sync();
      if (!lane_skip[tid]) {  // publish this lane's query's values, and its residual share
        const int col = lane_q[tid] * Fq;
        const int cstride = lane_step;
        const int32_t* rows_s = rows + step_cell * delta;
        float share = 0.0f;
        for (long long i = lane_cell[tid]; i < cells; i += cstride) {
          const int row = rows_s[i];
          if (row < n) {
            T* p = x + static_cast<long long>(row) * C + col;
            const T* v = scratch + i * C + col;
            if constexpr (kF == 1) {  // only the C = 1 build takes kResNone: no other build's code changes
              if (kind == kResNone) {
                *p = *v;
                continue;
              }
            }
            if constexpr (kF > 1 && kF <= 8) {
              if (Fq == kF) {  // one query: the whole row, as vectors
                T old[kF], nw[kF];
                load_row<kF, true, kPlain>(p, old, kF);
                load_row<kF, true, kPlain>(v, nw, kF);
                store_row<kF, true>(p, nw, kF);
#pragma unroll
                for (int j = 0; j < kF; ++j) share = __fadd_rn(share, residual_term<Sr>(kind, nw[j], old[j]));
                continue;
              }
            }
            for (int j = 0; j < Fq; ++j) {
              const T old = p[j];
              const T nw = v[j];
              p[j] = nw;
              share = __fadd_rn(share, residual_term<Sr>(kind, nw, old));
            }
          }
        }
        lane_res[tid] = __fadd_rn(lane_res[tid], share);
      }
      if (s == S - 1) {  // the block's share of each query's residual
        const int Q = C / Fq;
        __syncthreads();
        if (Q == 1) {
          block_tree_sum(lane_res);
          if (tid == 0) part[blockIdx.x] = lane_res[0];
        } else {
          const int lane0 = blockIdx.x * kThreads;
          const int tmax = min(kThreads, max(lane_step * Q - lane0, 0));
          const int base = lane0 % Q;
          for (int q = tid; q < Q; q += kThreads) {  // query q's lanes, in lane order
            float sum = 0.0f;
            for (int t = (q - base + Q) % Q; t < tmax; t += Q) sum = __fadd_rn(sum, lane_res[t]);
            part[static_cast<long long>(q) * gridDim.x + blockIdx.x] = sum;
          }
        }
      }
      grid.sync();
    }
    // the fold, in every block: each query's residual, in block order, then the tree
    const int r = round_s;
    const int Q = C / Fq;
    const int B = gridDim.x;
    if (tid == 0) block_live = 0;
    for (int q = 0; q < Q; ++q) {
      const float* pq = part + static_cast<long long>(q) * B;
      float sum = 0.0f;
      for (int b = tid; b < B; b += kThreads) sum = __fadd_rn(sum, __ldcg(pq + b));
      __syncthreads();  // lane_res is free: the block's shares are in part
      lane_res[tid] = sum;
      block_tree_sum(lane_res);
      if (tid == 0) {
        int32_t* flag = reinterpret_cast<int32_t*>(part) + static_cast<long long>(Q + q) * B + blockIdx.x;
        const float rq = lane_res[0];
        const bool was = *flag != 0;
        if (!(freeze && was)) {
          const bool now = was || rq <= tol;
          if (!now) block_live = 1;
          if (now && !was) *flag = 1;
          if (blockIdx.x == 0) {
            int32_t* conv = state + kStateHead;
            int32_t* rpq = conv + Q;
            reinterpret_cast<float*>(rpq + Q)[q] = rq;
            if (now && !was) {
              conv[q] = 1;
              rpq[q] = r + 1;
            }
          }
        }
      }
    }
    __syncthreads();  // every thread has read round_s; block_live is final
    const bool stop = block_live == 0 || r + 1 >= max_rounds;
    if (tid == 0) round_s = r + 1;
    if (stop) {
      if (blockIdx.x == 0 && tid == 0) state[0] = r + 1;
      return;
    }
  }
}

template <class Sr, int kF>
cudaError_t launch_solve(void* x, void* scratch, const void* src, const void* val,
                         const void* row_ptr, const void* rows, const void* table,
                         double c_in, double mix_in, double one_minus_mix_in, int tag,
                         int n, int S, int P, int M, int delta, int C, int G, int Fq,
                         int kind, double tol_in, int max_rounds, int freeze,
                         void* part, long long part_cap, void* state,
                         cudaStream_t stream) {
  using T = typename Sr::T;
  T* x_p = static_cast<T*>(x);
  T* scratch_p = static_cast<T*>(scratch);
  const int32_t* src_p = static_cast<const int32_t*>(src);
  const T* val_p = static_cast<const T*>(val);
  const int32_t* ptr_p = static_cast<const int32_t*>(row_ptr);
  const int32_t* rows_p = static_cast<const int32_t*>(rows);
  const T* table_p = static_cast<const T*>(table);
  float* part_p = static_cast<float*>(part);
  int32_t* state_p = static_cast<int32_t*>(state);
  T c = static_cast<T>(c_in);
  float mix = static_cast<float>(mix_in);
  float one_minus_mix = static_cast<float>(one_minus_mix_in);
  float tol = static_cast<float>(tol_in);  // the reference's f32 tol
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&solve_kernel<Sr, kF>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  tile_grid(P, delta, resident, &R, &blocks);
  // every query needs a lane: at least Q threads
  const int need = (C / Fq + kThreads - 1) / kThreads;
  if (blocks < need) blocks = need;
  if (blocks > resident || 2 * static_cast<long long>(blocks) * (C / Fq) > part_cap) {
    return cudaErrorInvalidValue;
  }
  void* args[] = {&x_p,   &scratch_p, &src_p, &val_p,  &ptr_p, &rows_p, &table_p,
                  &c,     &mix,       &one_minus_mix,  &tag,   &n,      &S,
                  &P,     &M,         &delta, &R,      &C,     &G,      &Fq,
                  &kind,  &tol,       &max_rounds,     &freeze, &part_p, &state_p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2: the commit steps [s0, s1) of one owner-computes halo round, for all D
// shards, in one cooperative launch.
//
// Replaces the TPU kernel src/repro/kernels/round_block.py::fused_halo_step_fn
// (a one-step pallas_call per shard with the shard's (L,)+feat frontier
// aliased in VMEM and its (H,)+feat boundary rows as a second output)
// together with what src/repro/dist/engine_sharded.py::frontier_pallas_round_fn
// runs between those calls: the all-gather of the boundary rows and, for an
// int8 or fp8 wire, their quantization with error feedback.  On the TPU each
// shard is a device, so the exchange has to leave the kernel and an all-S
// grid per shard cannot keep the reference's order.  Here all D shards are
// stacked (D, L) (a matrix frontier (D, L, F), rows of F values) on one
// card, and a grid barrier orders shard e's step-s reads after shard d's
// step-(s-1) commits exactly as the all-gather does; so one launch runs the
// whole round (the engine asks for [0, S)).
//
//   for s in s0..s1-1:
//     A  every tile of step s over all P = D * P_loc workers (worker w is
//        shard d = w / P_loc's), K1's tile walk (tile_rows) with
//          src    the shard's local slots, src_loc[d, s, w - d * P_loc]
//          gather x_loc[d, slot]
//          operands  table[rows[s, w, r]] (add_table, labelprop) and
//                    x_loc[d, rows_loc[d, s, w - d * P_loc, r]] (min_old,
//                    labelprop)
//        into scratch (P * delta rows), shard d's chunk at d * P_loc * delta
//     grid.sync()
//     B  publish scratch into each shard's owned slots through rows_loc
//        (the dump slot L - 1 is skipped);
//        f32: for every (d, k), the row v = scratch[d's chunk + send_idx[s, d, k]]
//             goes to x_loc[e, recv_idx[s, e, d*H + k]] for every e (dump
//             slots skipped): one gather of v, D independent index loads
//        int8/fp8: want = scratch[...] + ef[d, s, k] for every (d, k) and
//             feature f, and |want| folded into amax[s - s0, d, f]
//             (atomicMax on the bits of a non-negative float; the wrapper
//             zeroes amax): one max-abs scale per shard, step and feature,
//             the reference's per-column scale of an (H, F) block
//     grid.sync()
//     C  (int8/fp8) scale, q, the dequantized value and the new
//        ef[d, s, k, f] for every (d, k, f), the dequantized value written
//        into every receiving shard's halo slot, and into its dump slot
//        where (d, k) is dump_last[s, e], the last entry the plain exchange
//        leaves there; grid.sync()
//
// The dump slot: a padded row (rows == n) publishes to it and a padded
// send_idx entry ships a padded row, so its value reaches a real row only
// through a quantized wire's scale, and only for an epilogue that reads old
// (labelprop: a padded row's total is 0, so it keeps old, the dump's value).
// The plain exchange leaves each dump the last entry sent to it, in (d, k)
// order, as the reference's sequential scatter does; phase C writes that
// entry, so a quantized labelprop round equals its plain version.  The f32
// wire and the publish never write a dump: there its value only ever
// reaches other dumps.
//
// Publishes write owned slots and the exchange writes halo slots, so phase
// B's writes never meet.  The quantizer rounds as the plain version
// (repro_torch/kernels/ref.py::quantize_halo, the reference as XLA compiles
// it) does: scale = fl(max(amax, 1e-30) * fl32(1/qmax)), q = want / scale
// (IEEE division), int8 rounds half to even, clamps to +-127 and goes
// through an integer (so -0 becomes +0), fp8 clamps to +-448 then casts to
// e4m3 (nearest even) and back, the wire's value is fl(q * scale), and
// ef = fma(-q, scale, want): one rounding of want - q * scale.  The padded
// send_idx entries (0, the chunk's first row) take part in the maximum and
// get their own ef, as in the plain version.
// Halo and owned slots written in phase B or C are gathered in the next
// step through L1; the grid barriers order that as in K1 (the memory-order
// note at the top of this file).
//
// Bound on the H100: bytes.  A round reads each real edge's local source
// slot and value once (8 B), each distinct local slot its gathers reach
// (and, for min_old and labelprop, each real row's old slot) once (F values
// each), per chunk row its edge range and local slot (and, for add_table and
// labelprop, its global id and table row), writes each real row once, and
// for the exchange reads send_idx (S * D * H) and recv_idx (S * D * D * H)
// once and writes each real halo slot once; an int8/fp8 wire also reads and
// writes ef once (chip_smoke.py::halo_round_bound).  The halo copies and
// the exchange's indices put it above K1's round bound: on twitter scale 22
// at D = 4 and sync, recv_idx alone is 53 MB beside the edges' 514 MB.  At
// fine delta a step's fixed cost dominates as in K1: two grid barriers a
// step (three with a quantized wire) and the tile prologue, so at delta =
// 128 (S = 4,099) a round holds 8,198 (12,297) barriers.
//
// A cross-card exchange (NCCL, one process per card) would run the same
// kernel one step at a time, s1 = s0 + 1, with the exchange restricted to
// the card's own shards and the all-gather between launches.
// K2's phase A: every tile of commit step s over the launch's P = D * P_loc
// workers (worker w is shard d = w / P_loc's), K1's tile walk (tile_rows)
// with the shard's local slots, into scratch (P * delta rows, shard d's chunk
// at d * P_loc * delta).  The schedule's cells of step s are s * Ps + w (Ps:
// its workers; a rank's pointers start at the launch's first worker), the
// plan's (d * S + s) * P_loc + w - d * P_loc (a rank's start at its first
// shard).  G: the epilogue's group width (finish()).
template <class Sr, int kF>
__device__ __forceinline__ void halo_tiles(
    const typename Sr::T* x, typename Sr::T* scratch, const int32_t* __restrict__ src_loc,
    const typename Sr::T* __restrict__ val, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ rows_loc,
    const typename Sr::T* __restrict__ table, typename Sr::T c, float mix, float one_minus_mix,
    int tag, int s, int S, int P, int Ps, int P_loc, int M, int delta, int R, int F, int G,
    long long shard, typename Sr::T* prod) {
  using T = typename Sr::T;
  const int tid = threadIdx.x;
  const int tiles_per_cell = (delta + R - 1) / R;
  const long long tiles = static_cast<long long>(P) * tiles_per_cell;
  const long long step_cell = static_cast<long long>(s) * Ps;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int w = static_cast<int>(t / tiles_per_cell);
    const int r0 = static_cast<int>(t - static_cast<long long>(w) * tiles_per_cell) * R;
    const int rn = min(R, delta - r0);
    const int d = w / P_loc;
    const long long cell = step_cell + w;  // (s, w) of the schedule
    const long long lcell = (static_cast<long long>(d) * S + s) * P_loc + (w - d * P_loc);
    const T* xd = x + d * shard;
    const int32_t* ptr = row_ptr + cell * (delta + 1) + r0;
    const int t0 = ptr[0];
    const int t1 = ptr[rn];
    const bool own = tid < rn;
    const int r = r0 + tid;
    int e0 = 0, e1 = 0;
    long long at_old = 0, at_tab = 0;
    if (own) {
      e0 = ptr[tid];
      e1 = ptr[tid + 1];
      if (Sr::wants_old(tag)) at_old = static_cast<long long>(rows_loc[lcell * delta + r]) * F;
      if (Sr::wants_table(tag)) at_tab = static_cast<long long>(rows[cell * delta + r]) * F;
    }
    tile_rows<Sr, kF>(xd, src_loc + lcell * M, val + cell * M, t0, t1, own, e0, e1,
                      xd + at_old, table + at_tab,
                      scratch + (static_cast<long long>(w) * delta + r) * F, tag, c, mix,
                      one_minus_mix, F, G, prod);
  }
}

// The quantized wire of one value: want = v + ef against the shard's
// max-abs a, as the plain quantizer rounds (see K2's note): returns q as a
// float and its byte (int8, or e4m3 bits) in *bits, the scale in *scale.
template <int kWire>
__device__ __forceinline__ float quantize_wire(float want, float a, float inv_qmax, float* scale,
                                               uint8_t* bits) {
  constexpr float kQmax = kWire == 1 ? 127.0f : 448.0f;
  *scale = __fmul_rn(a < 1e-30f ? 1e-30f : a, inv_qmax);
  float q = __fdiv_rn(want, *scale);
  if constexpr (kWire == 1) {  // through an integer, as the int8 cast: -0 becomes 0
    const int qi = static_cast<int>(clamp_nan(rintf(q), -kQmax, kQmax));
    *bits = static_cast<uint8_t>(static_cast<int8_t>(qi));
    q = static_cast<float>(qi);
  } else {
    const __nv_fp8_storage_t b = __nv_cvt_float_to_fp8(clamp_nan(q, -kQmax, kQmax), __NV_SATFINITE, __NV_E4M3);
    *bits = static_cast<uint8_t>(b);
    q = __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  }
  return q;
}

template <class Sr, int kWire, int kF>
__global__ void __launch_bounds__(kThreads, kHaloMinBlocks<kF>)
    halo_round_kernel(typename Sr::T* x, float* ef, typename Sr::T* scratch,
                      uint32_t* amax, const int32_t* __restrict__ src_loc,
                      const typename Sr::T* __restrict__ val,
                      const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ rows_loc,
                      const int32_t* __restrict__ send_idx,
                      const int32_t* __restrict__ recv_idx,
                      const int32_t* __restrict__ dump_last,
                      const typename Sr::T* __restrict__ table, typename Sr::T c,
                      float mix, float one_minus_mix, int tag, int s0, int s1,
                      int S, int D, int P_loc, int M, int delta, int L, int H,
                      int R, float inv_qmax, int F_in, int G) {
  using T = typename Sr::T;
  __shared__ __align__(16) T prod[kChunk * kPassCols<kF>];
  __shared__ uint32_t block_max[kWire ? kMaxScales : 1];
  cg::grid_group grid = cg::this_grid();
  const int F = kF > 0 ? kF : F_in;
  const int tid = threadIdx.x;
  const int P = D * P_loc;
  const int dump = L - 1;
  const long long chunk = static_cast<long long>(P_loc) * delta;  // a shard's rows a step
  const long long cells = D * chunk;
  const long long sends = static_cast<long long>(D) * H;  // (d, k)
  const long long shard = static_cast<long long>(L) * F;  // a shard's values
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  for (int s = s0; s < s1; ++s) {
    const int32_t* snd = send_idx + static_cast<long long>(s) * sends;  // (D, H)
    const int32_t* rcv = recv_idx + static_cast<long long>(s) * D * sends;  // (D, D*H)
    // --- A: the step's tiles, all shards
    halo_tiles<Sr, kF>(x, scratch, src_loc, val, row_ptr, rows, rows_loc, table, c, mix, one_minus_mix,
                       tag, s, S, P, P, P_loc, M, delta, R, F, G, shard, prod);
    grid.sync();
    // --- B: publish, then the exchange (f32) or the scales' maxima
    for (long long i = first; i < cells; i += stride) {
      const int d = static_cast<int>(i / chunk);
      const int slot = rows_loc[(static_cast<long long>(d) * S + s) * chunk + (i - d * chunk)];
      if (slot < dump) copy_row<kF>(x + d * shard + static_cast<long long>(slot) * F, scratch + i * F, F);
    }
    if constexpr (kWire == 0) {
      for (long long m = first; m < sends; m += stride) {  // (d, k), to every e
        const int d = static_cast<int>(m / H);
        const T* v = scratch + (d * chunk + snd[m]) * F;
        if constexpr (kF > 0) {  // the row once into registers, then D stores
          T row[kF];
          load_row<kF, true, kPlain>(v, row, kF);
          for (int e = 0; e < D; ++e) {
            const int slot = rcv[e * sends + m];
            if (slot < dump) store_row<kF, true>(x + e * shard + static_cast<long long>(slot) * F, row, kF);
          }
        } else {
          for (int e = 0; e < D; ++e) {
            const int slot = rcv[e * sends + m];
            if (slot < dump) copy_row<kF>(x + e * shard + static_cast<long long>(slot) * F, v, F);
          }
        }
      }
      grid.sync();
    } else {
      const int scales = D * F;  // (d, f) of this step
      for (int j = tid; j < scales; j += kThreads) block_max[j] = 0;
      __syncthreads();
      for (long long m = first; m < sends; m += stride) {  // (d, k)
        const int d = static_cast<int>(m / H);
        const T* v = scratch + (d * chunk + snd[m]) * F;
        const float* efp = ef + ((static_cast<long long>(d) * S + s) * H + (m - d * H)) * F;
#pragma unroll
        for (int f = 0; f < (kF > 0 ? kF : F); ++f) {
          const float want = __fadd_rn(v[f], efp[f]);
          atomicMax(block_max + d * F + f, __float_as_uint(fabsf(want)));
        }
      }
      __syncthreads();
      uint32_t* step_max = amax + static_cast<long long>(s - s0) * scales;
      for (int j = tid; j < scales; j += kThreads) {
        if (block_max[j]) atomicMax(step_max + j, block_max[j]);
      }
      grid.sync();
      // --- C: quantize, keep the residual, ship the dequantized value
      const int32_t* last = dump_last + static_cast<long long>(s) * D;  // (D,)
      for (long long m = first; m < sends; m += stride) {
        const int d = static_cast<int>(m / H);
        const T* v = scratch + (d * chunk + snd[m]) * F;
        float* efp = ef + ((static_cast<long long>(d) * S + s) * H + (m - d * H)) * F;
#pragma unroll
        for (int f = 0; f < (kF > 0 ? kF : F); ++f) {
          const float want = __fadd_rn(v[f], efp[f]);
          const float a = __uint_as_float(__ldcg(step_max + d * F + f));
          float scale;
          uint8_t bits;
          const float q = quantize_wire<kWire>(want, a, inv_qmax, &scale, &bits);
          efp[f] = __fmaf_rn(-q, scale, want);
          const float wire = __fmul_rn(q, scale);
          for (int e = 0; e < D; ++e) {
            const int slot = rcv[e * sends + m];
            if (slot < dump || m == last[e]) x[e * shard + static_cast<long long>(slot) * F + f] = wire;
          }
        }
      }
      grid.sync();
    }
  }
}

template <class Sr, int kWire, int kF>
cudaError_t launch_halo_round(void* x, void* ef, void* scratch, void* amax,
                              const void* src_loc, const void* val,
                              const void* row_ptr, const void* rows,
                              const void* rows_loc, const void* send_idx,
                              const void* recv_idx, const void* dump_last,
                              const void* table, double c_in, double mix_in,
                              double one_minus_mix_in,
                              double inv_qmax_in, int tag, int s0, int s1, int S,
                              int D, int P_loc, int M, int delta, int L, int H,
                              int F, int G, cudaStream_t stream) {
  using T = typename Sr::T;
  T* x_p = static_cast<T*>(x);
  float* ef_p = static_cast<float*>(ef);
  T* scratch_p = static_cast<T*>(scratch);
  uint32_t* amax_p = static_cast<uint32_t*>(amax);
  const int32_t* src_p = static_cast<const int32_t*>(src_loc);
  const T* val_p = static_cast<const T*>(val);
  const int32_t* ptr_p = static_cast<const int32_t*>(row_ptr);
  const int32_t* rows_p = static_cast<const int32_t*>(rows);
  const int32_t* rl_p = static_cast<const int32_t*>(rows_loc);
  const int32_t* snd_p = static_cast<const int32_t*>(send_idx);
  const int32_t* rcv_p = static_cast<const int32_t*>(recv_idx);
  const int32_t* last_p = static_cast<const int32_t*>(dump_last);
  const T* table_p = static_cast<const T*>(table);
  T c = static_cast<T>(c_in);
  float mix = static_cast<float>(mix_in);
  float one_minus_mix = static_cast<float>(one_minus_mix_in);
  float inv_qmax = static_cast<float>(inv_qmax_in);
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&halo_round_kernel<Sr, kWire, kF>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  tile_grid(D * P_loc, delta, resident, &R, &blocks);
  void* args[] = {&x_p,     &ef_p, &scratch_p, &amax_p, &src_p, &val_p,
                  &ptr_p,   &rows_p, &rl_p,    &snd_p,  &rcv_p, &last_p,
                  &table_p, &c,    &mix,       &one_minus_mix,  &tag,  &s0,
                  &s1,      &S,    &D,         &P_loc,  &M,     &delta,
                  &L,       &H,    &R,         &inv_qmax, &F,   &G};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2's rank entries: one rank of a halo solve over processes, each holding a
// contiguous range of the D shards (entry points halo_local_launch and
// halo_recv_launch).  The cross-process form of halo_round_kernel: the
// reference runs fused_halo_step_fn once a shard and a commit step under
// shard_map, with an all_gather of the (H,)+feat boundary rows (for int8 or
// fp8, of the 1-byte values and, in a second all_gather, the per-shard
// scales) between steps (src/repro/dist/engine_sharded.py
// frontier_pallas_round_fn).  The gather leaves the card here
// (torch.distributed, repro_torch/dist/comm.py), so a rank runs one step a
// launch:
//
//   halo_local_kernel, step s of the launch's Dl shards (cooperative):
//     A  halo_round_kernel's phase A over their Dl * P_loc workers
//        (halo_tiles, reading the rank's own schedule cells and plan blocks);
//        grid.sync()
//     B  publish into their owned slots; f32: the send block
//        out[d, k] = scratch[d's chunk + send_idx[s, d, k]];
//        int8/fp8: |want| folded into amax[d, f] as in halo_round_kernel;
//        grid.sync()
//     C  (int8/fp8) q, scale and the new ef[d, s, k, f] as in
//        halo_round_kernel's phase C, q's byte written to out[d, k, f] and
//        the scale (by k = 0) to scales[d, f]
//   halo_recv_kernel, step s, shards [e0, e1) (an ordinary launch): every
//     gathered row m = (d, k) of the (D, H)+feat block, f32 as it is or
//     int8/fp8 as fl(q * scales[d, f]), into x[e, recv_idx[s, e, m]] for
//     each held e; dump slots skipped, but a quantized wire writes the
//     entry dump_last[s, e] names, as phase C does.
//
// So local and receive over all shards [0, D) is one step of
// halo_round_kernel, bit for bit: the same walk, publish, quantizer and
// writes.  On the f32 and int32 wires both take a batch's rows, C = Q * F
// values a row of the (Dl, L, Q)+feat frontier (the epilogue in groups of
// G, as halo_round_batch_launch), so a rank of a halo batch runs them too;
// a quantized wire takes F alone (the reference quantizes no batch).  The scale is a shard's and a step's, so the quantizer needs
// nothing from other ranks.  Bound: a rank's share of K2's bytes (its
// shards' edges, slots, rows and indices) and, for the receive, the D * H
// gathered rows read once and its halo slots written once
// (chip_smoke.py::halo_local_bound, halo_recv_bound).  At one step a launch,
// a round at fine delta pays S launches and S collectives, the cost the
// in-card exchange avoids.
template <class Sr, int kWire, int kF>
__global__ void __launch_bounds__(kThreads, kHaloMinBlocks<kF>)
    halo_local_kernel(typename Sr::T* x, float* ef, typename Sr::T* scratch, uint32_t* amax,
                      void* out, float* scales, const int32_t* __restrict__ src_loc,
                      const typename Sr::T* __restrict__ val,
                      const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ rows_loc,
                      const int32_t* __restrict__ send_idx,
                      const typename Sr::T* __restrict__ table, typename Sr::T c,
                      float mix, float one_minus_mix, int tag, int s, int S, int Dl, int Dp,
                      int Ps, int P_loc, int M, int delta, int L, int H, int R,
                      float inv_qmax, int F_in, int G) {
  using T = typename Sr::T;
  __shared__ __align__(16) T prod[kChunk * kPassCols<kF>];
  __shared__ uint32_t block_max[kWire ? kMaxScales : 1];
  cg::grid_group grid = cg::this_grid();
  const int F = kF > 0 ? kF : F_in;
  const int tid = threadIdx.x;
  const int dump = L - 1;
  const long long chunk = static_cast<long long>(P_loc) * delta;
  const long long cells = Dl * chunk;
  const long long sends = static_cast<long long>(Dl) * H;  // (d, k) of the launch's shards
  const long long shard = static_cast<long long>(L) * F;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const int32_t* snd = send_idx + static_cast<long long>(s) * Dp * H;  // (Dp, H), from the first shard
  // --- A
  halo_tiles<Sr, kF>(x, scratch, src_loc, val, row_ptr, rows, rows_loc, table, c, mix, one_minus_mix,
                     tag, s, S, Dl * P_loc, Ps, P_loc, M, delta, R, F, G, shard, prod);
  grid.sync();
  // --- B: publish, then the send block (f32) or the scales' maxima
  for (long long i = first; i < cells; i += stride) {
    const int d = static_cast<int>(i / chunk);
    const int slot = rows_loc[(static_cast<long long>(d) * S + s) * chunk + (i - d * chunk)];
    if (slot < dump) copy_row<kF>(x + d * shard + static_cast<long long>(slot) * F, scratch + i * F, F);
  }
  if constexpr (kWire == 0) {
    T* o = static_cast<T*>(out);
    for (long long m = first; m < sends; m += stride) {
      const int d = static_cast<int>(m / H);
      copy_row<kF>(o + m * F, scratch + (d * chunk + snd[m]) * F, F);
    }
  } else {
    const int nscales = Dl * F;  // (d, f)
    for (int j = tid; j < nscales; j += kThreads) block_max[j] = 0;
    __syncthreads();
    for (long long m = first; m < sends; m += stride) {
      const int d = static_cast<int>(m / H);
      const T* v = scratch + (d * chunk + snd[m]) * F;
      const float* efp = ef + ((static_cast<long long>(d) * S + s) * H + (m - d * H)) * F;
#pragma unroll
      for (int f = 0; f < (kF > 0 ? kF : F); ++f) {
        atomicMax(block_max + d * F + f, __float_as_uint(fabsf(__fadd_rn(v[f], efp[f]))));
      }
    }
    __syncthreads();
    for (int j = tid; j < nscales; j += kThreads) {
      if (block_max[j]) atomicMax(amax + j, block_max[j]);
    }
    grid.sync();
    // --- C
    uint8_t* o = static_cast<uint8_t*>(out);
    for (long long m = first; m < sends; m += stride) {
      const int d = static_cast<int>(m / H);
      const T* v = scratch + (d * chunk + snd[m]) * F;
      float* efp = ef + ((static_cast<long long>(d) * S + s) * H + (m - d * H)) * F;
#pragma unroll
      for (int f = 0; f < (kF > 0 ? kF : F); ++f) {
        const float want = __fadd_rn(v[f], efp[f]);
        const float a = __uint_as_float(__ldcg(amax + d * F + f));
        float scale;
        uint8_t bits;
        const float q = quantize_wire<kWire>(want, a, inv_qmax, &scale, &bits);
        efp[f] = __fmaf_rn(-q, scale, want);
        o[m * F + f] = bits;
        if (m == static_cast<long long>(d) * H) scales[d * F + f] = scale;
      }
    }
  }
}

template <class T, int kWire, int kF>
__global__ void __launch_bounds__(kThreads)
    halo_recv_kernel(T* x, const void* rows_in, const float* __restrict__ scales,
                     const int32_t* __restrict__ recv_idx, const int32_t* __restrict__ dump_last,
                     int s, int El, int Dp, int D, int L, int H, int F_in) {
  const int F = kF > 0 ? kF : F_in;
  const int dump = L - 1;
  const long long sends = static_cast<long long>(D) * H;  // (d, k), every shard's
  const long long shard = static_cast<long long>(L) * F;
  const int32_t* rcv = recv_idx + static_cast<long long>(s) * Dp * sends;  // (Dp, D*H), from the first shard
  const int32_t* last = dump_last + static_cast<long long>(s) * Dp;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long m = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; m < sends; m += stride) {
    if constexpr (kWire == 0) {
      const T* v = static_cast<const T*>(rows_in) + m * F;
      if constexpr (kF > 0) {  // the row once into registers, then a store a shard
        T row[kF];
        load_row<kF, true, kPlain>(v, row, kF);
        for (int e = 0; e < El; ++e) {
          const int slot = rcv[e * sends + m];
          if (slot < dump) store_row<kF, true>(x + e * shard + static_cast<long long>(slot) * F, row, kF);
        }
      } else {
        for (int e = 0; e < El; ++e) {
          const int slot = rcv[e * sends + m];
          if (slot < dump) copy_row<kF>(x + e * shard + static_cast<long long>(slot) * F, v, F);
        }
      }
    } else {
      const uint8_t* q8 = static_cast<const uint8_t*>(rows_in) + m * F;
      const int d = static_cast<int>(m / H);
      for (int f = 0; f < F; ++f) {
        float q;
        if constexpr (kWire == 1) {
          q = static_cast<float>(static_cast<int8_t>(q8[f]));
        } else {
          q = __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(q8[f]), __NV_E4M3)));
        }
        const float wire = __fmul_rn(q, scales[d * F + f]);
        for (int e = 0; e < El; ++e) {
          const int slot = rcv[e * sends + m];
          if (slot < dump || m == last[e]) x[e * shard + static_cast<long long>(slot) * F + f] = wire;
        }
      }
    }
  }
}

template <class Sr, int kWire, int kF>
cudaError_t launch_halo_local(void* x, void* ef, void* scratch, void* amax, void* out,
                              void* scales, const void* src_loc, const void* val,
                              const void* row_ptr, const void* rows, const void* rows_loc,
                              const void* send_idx, const void* table, double c_in,
                              double mix_in, double one_minus_mix_in, double inv_qmax_in,
                              int tag, int s, int S, int Dl, int Dp, int Ps, int P_loc,
                              int M, int delta, int L, int H, int F, int G, cudaStream_t stream) {
  using T = typename Sr::T;
  T* x_p = static_cast<T*>(x);
  float* ef_p = static_cast<float*>(ef);
  T* scratch_p = static_cast<T*>(scratch);
  uint32_t* amax_p = static_cast<uint32_t*>(amax);
  float* scales_p = static_cast<float*>(scales);
  const int32_t* src_p = static_cast<const int32_t*>(src_loc);
  const T* val_p = static_cast<const T*>(val);
  const int32_t* ptr_p = static_cast<const int32_t*>(row_ptr);
  const int32_t* rows_p = static_cast<const int32_t*>(rows);
  const int32_t* rl_p = static_cast<const int32_t*>(rows_loc);
  const int32_t* snd_p = static_cast<const int32_t*>(send_idx);
  const T* table_p = static_cast<const T*>(table);
  T c = static_cast<T>(c_in);
  float mix = static_cast<float>(mix_in);
  float one_minus_mix = static_cast<float>(one_minus_mix_in);
  float inv_qmax = static_cast<float>(inv_qmax_in);
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&halo_local_kernel<Sr, kWire, kF>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  tile_grid(Dl * P_loc, delta, resident, &R, &blocks);
  void* args[] = {&x_p,   &ef_p,  &scratch_p, &amax_p, &out,    &scales_p, &src_p,
                  &val_p, &ptr_p, &rows_p,    &rl_p,   &snd_p,  &table_p,  &c,
                  &mix,   &one_minus_mix,     &tag,    &s,      &S,        &Dl,
                  &Dp,    &Ps,    &P_loc,     &M,      &delta,  &L,        &H,
                  &R,     &inv_qmax,          &F,      &G};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T, int kWire, int kF>
cudaError_t launch_halo_recv(void* x, const void* rows_in, const void* scales,
                             const void* recv_idx, const void* dump_last, int s, int El,
                             int Dp, int D, int L, int H, int F, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long sends = static_cast<long long>(D) * H;
  long long blocks = (sends + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  halo_recv_kernel<T, kWire, kF><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(x), rows_in, static_cast<const float*>(scales),
      static_cast<const int32_t*>(recv_idx), static_cast<const int32_t*>(dump_last), s, El, Dp, D,
      L, H, F);
  return cudaGetLastError();
}

// K1's rank entries: one rank of a replicated solve over processes, each
// holding a contiguous range [w0, w1) of the P workers and the whole
// frontier (entry points round_block_rank_step_launch and
// round_block_publish_launch).  The cross-process form of round_kernel: the
// reference runs its round under shard_map with the workers split over the
// devices and all-gathers every worker's chunk at each commit
// (src/repro/dist/engine_sharded.py sharded_round_fn_q).  The gather leaves
// the card here (torch.distributed, repro_torch/dist/comm.py), so a rank
// runs a commit step in two launches with the gather between them:
//
//   round_rank_step_kernel, step s of the rank's P_r = w1 - w0 workers:
//     every tile of the step (step_tiles, round_kernel's phase 1 over the
//     rank's (S, P_r, M) cells and (S, P_r, delta) rows), reading the whole
//     x, into out (P_r * delta rows of C values, in chunk order)
//   round_publish_kernel, step s: the gathered (P * delta, C) block of every
//     worker into x at the global rows[s] (dump rows, == n, skipped):
//     round_kernel's phase 2 for one step
//
// One step has no grid-wide barrier inside a launch (the launch boundary
// orders the publish after the step, and the next step after the publish),
// so both are ordinary launches: neither pays a cooperative launch's fixed
// cost.  The walk is step_tiles itself, so the bits are round_kernel's and
// solve_kernel's.  Both take a batch's C = Q * F values a row (the epilogue
// in groups of G, as round_block_batch_launch), so one pair serves single
// solves (C = F) and batches.  Bound: the rank's share of a round's bytes a
// step (its real edges, the x rows they gather, its rows' operands and its
// out rows), and for the publish the block read once and its real rows
// written once (chip_smoke.py::rank_step_bounds).
template <class Sr, int kF>
__global__ void __launch_bounds__(kThreads)
    round_rank_step_kernel(const typename Sr::T* x, typename Sr::T* out,
                           const int32_t* __restrict__ src,
                           const typename Sr::T* __restrict__ val,
                           const int32_t* __restrict__ row_ptr,
                           const int32_t* __restrict__ rows,
                           const typename Sr::T* __restrict__ table, typename Sr::T c,
                           float mix, float one_minus_mix, int tag, int s, int P, int M,
                           int delta, int R, int F_in, int G) {
  using T = typename Sr::T;
  __shared__ __align__(16) T prod[kChunk * kPassCols<kF>];
  const int F = kF > 0 ? kF : F_in;
  step_tiles<Sr, kF>(x, out, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, s, P, M, delta, R, F,
                     G, prod);
}

template <class T, int kF>
__global__ void __launch_bounds__(kThreads)
    round_publish_kernel(T* x, const T* __restrict__ block, const int32_t* __restrict__ rows, int n,
                         long long cells, int C_in) {
  const int C = kF > 0 ? kF : C_in;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < cells; i += stride) {
    const int row = rows[i];
    if (row < n) copy_row<kF>(x + static_cast<long long>(row) * C, block + i * C, C);
  }
}

template <class Sr, int kF>
cudaError_t launch_rank_step(const void* x, void* out, const void* src, const void* val,
                             const void* row_ptr, const void* rows, const void* table, double c_in,
                             double mix_in, double one_minus_mix_in, int tag, int s, int P, int M,
                             int delta, int C, int G, cudaStream_t stream) {
  using T = typename Sr::T;
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&round_rank_step_kernel<Sr, kF>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident, false);
  if (err != cudaSuccess) return err;
  tile_grid(P, delta, resident, &R, &blocks);
  round_rank_step_kernel<Sr, kF><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int32_t*>(src),
      static_cast<const T*>(val), static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(rows),
      static_cast<const T*>(table), static_cast<T>(c_in), static_cast<float>(mix_in),
      static_cast<float>(one_minus_mix_in), tag, s, P, M, delta, R, C, G);
  return cudaGetLastError();
}

template <class T, int kF>
cudaError_t launch_publish(void* x, const void* block, const void* rows, int n, int s, int P, int delta,
                           int C, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long cells = static_cast<long long>(P) * delta;
  long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  round_publish_kernel<T, kF><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(x), static_cast<const T*>(block), static_cast<const int32_t*>(rows) + s * cells, n,
      cells, C);
  return cudaGetLastError();
}

// The kF instantiation that runs a frontier of F values a row with
// epilogue `tag`: kF = F for 1, 2, 4 and 8, the feature-block build
// otherwise, and for labelprop at F = 1 (the vector build leaves it out).
#define DISPATCH_F(F, TAG, CALL)                          \
  switch ((F) == 1 && (TAG) == kLabelprop ? 0 : (F)) {    \
    case 1: CALL(1);                                      \
    case 2: CALL(2);                                      \
    case 4: CALL(4);                                      \
    case 8: CALL(8);                                      \
    default: CALL(0);                                     \
  }

// A batch's: as DISPATCH_F, and kF = C for C = 16 and 32.
#define DISPATCH_C(C, TAG, CALL)                          \
  switch ((C) == 1 && (TAG) == kLabelprop ? 0 : (C)) {    \
    case 1: CALL(1);                                      \
    case 2: CALL(2);                                      \
    case 4: CALL(4);                                      \
    case 8: CALL(8);                                      \
    case 16: CALL(16);                                    \
    case 32: CALL(32);                                    \
    default: CALL(0);                                     \
  }

bool takes(int dtype, int tag, const void* table) {
  if (dtype == 0) return tag == kAddConst || ((tag == kAddTable || tag == kLabelprop) && table != nullptr);
  return dtype == 1 && tag == kMinOld;
}

}  // namespace

// dtype: 0 = float32 plus-times, 1 = int32 min-plus; F: the frontier's
// values a row (1 for a vector).  Returns a cudaError_t.
extern "C" int round_block_launch(int dtype, void* x, void* scratch,
                                  const void* src, const void* val,
                                  const void* row_ptr, const void* rows,
                                  const void* table, double c, double mix,
                                  double one_minus_mix, int tag, int n, int S,
                                  int P, int M, int delta, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || !takes(dtype, tag, table)) return cudaErrorInvalidValue;
#define K1_ARGS x, scratch, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, n, S, P, M, delta, F, F, st
#define K1_PLUS(KF) return launch<PlusTimes, KF>(K1_ARGS)
#define K1_MIN(KF) return launch<MinPlus, KF>(K1_ARGS)
  if (dtype == 0) DISPATCH_F(F, tag, K1_PLUS)
  DISPATCH_F(F, tag, K1_MIN)
#undef K1_MIN
#undef K1_PLUS
#undef K1_ARGS
  return cudaErrorInvalidValue;
}

// K1 over a batch: x and table are (n+1, C) with C = Q * F, the Q queries'
// rows side by side; G = F for labelprop (each query's own columns), C for
// every other tag.  Returns a cudaError_t.
extern "C" int round_block_batch_launch(int dtype, void* x, void* scratch,
                                        const void* src, const void* val,
                                        const void* row_ptr, const void* rows,
                                        const void* table, double c, double mix,
                                        double one_minus_mix, int tag, int n, int S,
                                        int P, int M, int delta, int C, int G,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || G < 1 || C % G != 0 || !takes(dtype, tag, table)) return cudaErrorInvalidValue;
#define KB_ARGS x, scratch, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, n, S, P, M, delta, C, G, st
#define KB_PLUS(KF) return launch<PlusTimes, KF>(KB_ARGS)
#define KB_MIN(KF) return launch<MinPlus, KF>(KB_ARGS)
  if (dtype == 0) DISPATCH_C(C, tag, KB_PLUS)
  DISPATCH_C(C, tag, KB_MIN)
#undef KB_MIN
#undef KB_PLUS
#undef KB_ARGS
  return cudaErrorInvalidValue;
}

// K1's loop entry over C = Q * Fq values a row (Fq: a query's own columns;
// one query: Q = 1, Fq = C; G as for round_block_batch_launch, so a single
// query's F = 16 or 32 takes the batch's builds, whose columns sum in the
// same order), freeze = 1 for an open batch.
// kind: 0 = l1 (float32 only), 1 = count-changed, 2 = none (timing only;
// C = 1 and not labelprop, which take the kF = 1 build).  state and part as in
// solve_kernel (state zeroed but for conv and res, which the caller fills;
// part holds part_cap floats, at least 2 * Q * blocks).  Returns a cudaError_t.
extern "C" int round_block_solve_launch(int dtype, void* x, void* scratch,
                                        const void* src, const void* val,
                                        const void* row_ptr, const void* rows,
                                        const void* table, double c, double mix,
                                        double one_minus_mix, int tag, int n, int S, int P,
                                        int M, int delta, int C, int G, int Fq, int kind,
                                        double tol, int max_rounds, int freeze, void* part,
                                        long long part_cap, void* state, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || G < 1 || C % G != 0 || Fq < 1 || C % Fq != 0 || max_rounds < 1) return cudaErrorInvalidValue;
  if (!takes(dtype, tag, table) || kind < kResL1 || kind > kResNone || (kind == kResL1 && dtype != 0) ||
      (kind == kResNone && (C != 1 || tag == kLabelprop))) {
    return cudaErrorInvalidValue;
  }
#define KS_ARGS                                                                          \
  x, scratch, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, n, S, P, M, delta, \
      C, G, Fq, kind, tol, max_rounds, freeze, part, part_cap, state, st
#define KS_PLUS(KF) return launch_solve<PlusTimes, KF>(KS_ARGS)
#define KS_MIN(KF) return launch_solve<MinPlus, KF>(KS_ARGS)
  if (dtype == 0) DISPATCH_C(C, tag, KS_PLUS)
  DISPATCH_C(C, tag, KS_MIN)
#undef KS_MIN
#undef KS_PLUS
#undef KS_ARGS
  return cudaErrorInvalidValue;
}


// K2.  dtype, tag and F as for round_block_launch; wire: 0 = f32, 1 = int8,
// 2 = fp8 (float32 plus-times only, D * F <= 512 scales a step; ef and amax
// are read only then).  Returns a cudaError_t.
extern "C" int halo_round_launch(int dtype, int wire, void* x, void* ef,
                                 void* scratch, void* amax, const void* src_loc,
                                 const void* val, const void* row_ptr,
                                 const void* rows, const void* rows_loc,
                                 const void* send_idx, const void* recv_idx,
                                 const void* dump_last, const void* table,
                                 double c, double mix,
                                 double one_minus_mix, double inv_qmax, int tag,
                                 int s0, int s1, int S, int D, int P_loc, int M,
                                 int delta, int L, int H, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxShards || F < 1 || s0 < 0 || s1 > S || s0 >= s1) return cudaErrorInvalidValue;
  if (!takes(dtype, tag, table)) return cudaErrorInvalidValue;
  if (wire != 0 && (dtype != 0 || ef == nullptr || amax == nullptr || dump_last == nullptr ||
                    D * F > kMaxScales)) {
    return cudaErrorInvalidValue;
  }
#define K2_ARGS                                                                    \
  x, ef, scratch, amax, src_loc, val, row_ptr, rows, rows_loc, send_idx, recv_idx, \
      dump_last, table, c, mix, one_minus_mix, inv_qmax, tag, s0, s1, S, D, P_loc, M, \
      delta, L, H, F, F, st
#define K2_F32(KF) return launch_halo_round<PlusTimes, 0, KF>(K2_ARGS)
#define K2_INT8(KF) return launch_halo_round<PlusTimes, 1, KF>(K2_ARGS)
#define K2_FP8(KF) return launch_halo_round<PlusTimes, 2, KF>(K2_ARGS)
#define K2_MIN(KF) return launch_halo_round<MinPlus, 0, KF>(K2_ARGS)
  if (dtype == 1) {
    if (wire == 0) DISPATCH_F(F, tag, K2_MIN)
  } else if (wire == 0) {
    DISPATCH_F(F, tag, K2_F32)
  } else if (wire == 1) {
    DISPATCH_F(F, tag, K2_INT8)
  } else if (wire == 2) {
    DISPATCH_F(F, tag, K2_FP8)
  }
#undef K2_MIN
#undef K2_FP8
#undef K2_INT8
#undef K2_F32
#undef K2_ARGS
  return cudaErrorInvalidValue;
}

// K2 over a batch (f32 or int32 wire): x (D, L, C) and table (n+1, C) with
// C = Q * F, the Q queries' rows side by side; G as for
// round_block_batch_launch.  All S steps in one launch.  Returns a cudaError_t.
extern "C" int halo_round_batch_launch(int dtype, void* x, void* scratch, const void* src_loc,
                                       const void* val, const void* row_ptr, const void* rows,
                                       const void* rows_loc, const void* send_idx,
                                       const void* recv_idx, const void* table, double c,
                                       double mix, double one_minus_mix, int tag, int S, int D,
                                       int P_loc, int M, int delta, int L, int H, int C, int G,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxShards || C < 1 || G < 1 || C % G != 0 || S < 1) return cudaErrorInvalidValue;
  if (!takes(dtype, tag, table)) return cudaErrorInvalidValue;
#define KHB_ARGS                                                                          \
  x, nullptr, scratch, nullptr, src_loc, val, row_ptr, rows, rows_loc, send_idx, recv_idx, \
      nullptr, table, c, mix, one_minus_mix, 0.0, tag, 0, S, S, D, P_loc, M, delta, L, H, C, G, st
#define KHB_PLUS(KF) return launch_halo_round<PlusTimes, 0, KF>(KHB_ARGS)
#define KHB_MIN(KF) return launch_halo_round<MinPlus, 0, KF>(KHB_ARGS)
  if (dtype == 0) DISPATCH_C(C, tag, KHB_PLUS)
  DISPATCH_C(C, tag, KHB_MIN)
#undef KHB_MIN
#undef KHB_PLUS
#undef KHB_ARGS
  return cudaErrorInvalidValue;
}

// A rank's commit step s over its Dl shards (K2's rank entry).  The plan's
// pointers (src_loc, rows_loc, send_idx) start at the launch's first shard,
// whose per-step arrays hold Dp shards; the schedule's (val, row_ptr, rows)
// at its first worker, of Ps workers a step.  C: the values a row (a
// batch's Q * F on wire 0; G as for round_block_batch_launch; a quantized
// wire takes C = G = F).  out: the (Dl, H, C) send block (x's type for wire
// 0, one byte a value for int8/fp8), scales (Dl, F) floats and ef (Dl, S,
// H, F) for int8/fp8, amax Dl * F zeroed words.
extern "C" int halo_local_launch(int dtype, int wire, void* x, void* ef, void* scratch,
                                 void* amax, void* out, void* scales, const void* src_loc,
                                 const void* val, const void* row_ptr, const void* rows,
                                 const void* rows_loc, const void* send_idx, const void* table,
                                 double c, double mix, double one_minus_mix, double inv_qmax,
                                 int tag, int s, int S, int Dl, int Dp, int Ps, int P_loc, int M,
                                 int delta, int L, int H, int C, int G, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dl < 1 || Dl > Dp || C < 1 || G < 1 || C % G != 0 || s < 0 || s >= S || Dl * P_loc > Ps) {
    return cudaErrorInvalidValue;
  }
  if (!takes(dtype, tag, table)) return cudaErrorInvalidValue;
  if (wire != 0 && (dtype != 0 || ef == nullptr || amax == nullptr || scales == nullptr ||
                    Dl * C > kMaxScales || G != C)) {
    return cudaErrorInvalidValue;
  }
#define KL_ARGS                                                                               \
  x, ef, scratch, amax, out, scales, src_loc, val, row_ptr, rows, rows_loc, send_idx, table, c, \
      mix, one_minus_mix, inv_qmax, tag, s, S, Dl, Dp, Ps, P_loc, M, delta, L, H, C, G, st
#define KL_F32(KF) return launch_halo_local<PlusTimes, 0, KF>(KL_ARGS)
#define KL_INT8(KF) return launch_halo_local<PlusTimes, 1, KF>(KL_ARGS)
#define KL_FP8(KF) return launch_halo_local<PlusTimes, 2, KF>(KL_ARGS)
#define KL_MIN(KF) return launch_halo_local<MinPlus, 0, KF>(KL_ARGS)
  if (dtype == 1) {
    if (wire == 0) DISPATCH_C(C, tag, KL_MIN)
  } else if (wire == 0) {
    DISPATCH_C(C, tag, KL_F32)
  } else if (wire == 1) {
    DISPATCH_F(C, tag, KL_INT8)
  } else if (wire == 2) {
    DISPATCH_F(C, tag, KL_FP8)
  }
#undef KL_MIN
#undef KL_FP8
#undef KL_INT8
#undef KL_F32
#undef KL_ARGS
  return cudaErrorInvalidValue;
}

// A rank's receive of step s: the gathered (D, H, C) rows (x's type for wire
// 0, C a batch's Q * F values a row; int8/fp8 bytes with (D, C) float
// scales) into the halo slots of its El shards.  recv_idx and dump_last
// start at its first shard, of Dp shards a step.  It runs no epilogue, so
// it takes no group width.  Returns a cudaError_t.
extern "C" int halo_recv_launch(int dtype, int wire, void* x, const void* rows_in,
                                const void* scales, const void* recv_idx, const void* dump_last,
                                int s, int El, int Dp, int D, int L, int H, int C, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (El < 1 || El > Dp || D < 1 || C < 1 || s < 0) return cudaErrorInvalidValue;
  if (wire != 0 && (dtype != 0 || scales == nullptr || dump_last == nullptr)) return cudaErrorInvalidValue;
#define KR_ARGS x, rows_in, scales, recv_idx, dump_last, s, El, Dp, D, L, H, C, st
#define KR_CASES(T, W)                                              \
  switch (C) {                                                      \
    case 1: return launch_halo_recv<T, W, 1>(KR_ARGS);              \
    case 2: return launch_halo_recv<T, W, 2>(KR_ARGS);              \
    case 4: return launch_halo_recv<T, W, 4>(KR_ARGS);              \
    case 8: return launch_halo_recv<T, W, 8>(KR_ARGS);              \
    case 16: return launch_halo_recv<T, W, 16>(KR_ARGS);            \
    case 32: return launch_halo_recv<T, W, 32>(KR_ARGS);            \
    default: return launch_halo_recv<T, W, 0>(KR_ARGS);             \
  }
  if (dtype == 1) {
    if (wire == 0) KR_CASES(int32_t, 0)
  } else if (wire == 0) {
    KR_CASES(float, 0)
  } else if (wire == 1) {
    return launch_halo_recv<float, 1, 0>(KR_ARGS);
  } else if (wire == 2) {
    return launch_halo_recv<float, 2, 0>(KR_ARGS);
  }
#undef KR_CASES
#undef KR_ARGS
  return cudaErrorInvalidValue;
}

// K1's rank step: commit step s of a rank's P workers (its (S, P, M) cells,
// (S, P, delta + 1) row_ptr and (S, P, delta) rows) over the whole x (n+1, C)
// into out (P * delta, C); C and G as for round_block_batch_launch (a
// single solve: C = G = F).  An ordinary launch.  Returns a cudaError_t.
extern "C" int round_block_rank_step_launch(int dtype, const void* x, void* out, const void* src,
                                            const void* val, const void* row_ptr, const void* rows,
                                            const void* table, double c, double mix,
                                            double one_minus_mix, int tag, int s, int S, int P, int M,
                                            int delta, int C, int G, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || G < 1 || C % G != 0 || s < 0 || s >= S || P < 1 || !takes(dtype, tag, table)) {
    return cudaErrorInvalidValue;
  }
#define KRS_ARGS x, out, src, val, row_ptr, rows, table, c, mix, one_minus_mix, tag, s, P, M, delta, C, G, st
#define KRS_PLUS(KF) return launch_rank_step<PlusTimes, KF>(KRS_ARGS)
#define KRS_MIN(KF) return launch_rank_step<MinPlus, KF>(KRS_ARGS)
  if (dtype == 0) DISPATCH_C(C, tag, KRS_PLUS)
  DISPATCH_C(C, tag, KRS_MIN)
#undef KRS_MIN
#undef KRS_PLUS
#undef KRS_ARGS
  return cudaErrorInvalidValue;
}

// K1's publish of step s: the gathered (P * delta, C) block of every worker
// into x (n+1, C) at the global rows[s] ((S, P, delta) rows; dump rows, == n,
// skipped).  An ordinary launch.  Returns a cudaError_t.
extern "C" int round_block_publish_launch(int dtype, void* x, const void* block, const void* rows, int n,
                                          int s, int S, int P, int delta, int C, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || s < 0 || s >= S || P < 1 || delta < 1 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
#define KP_ARGS x, block, rows, n, s, P, delta, C, st
#define KP_CASES(T)                                          \
  switch (C) {                                               \
    case 1: return launch_publish<T, 1>(KP_ARGS);            \
    case 2: return launch_publish<T, 2>(KP_ARGS);            \
    case 4: return launch_publish<T, 4>(KP_ARGS);            \
    case 8: return launch_publish<T, 8>(KP_ARGS);            \
    case 16: return launch_publish<T, 16>(KP_ARGS);          \
    case 32: return launch_publish<T, 32>(KP_ARGS);          \
    default: return launch_publish<T, 0>(KP_ARGS);           \
  }
  if (dtype == 0) KP_CASES(float)
  KP_CASES(int32_t)
#undef KP_CASES
#undef KP_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* round_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
