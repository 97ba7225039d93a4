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
// Bound on the H100: bytes.  A round must read each real edge's src index and
// value once (8 B an edge) and read and write the frontier once: for twitter
// scale 22 (64.3 M edges, 4.2 M rows) about 0.55 GB, 0.16 ms at 3.35 TB/s.
// At fine delta the fixed cost of a commit step dominates instead: the 2*S
// grid barriers (8,198 a round at delta = 128) and one step's latency chain
// (PERF.md).  That is this card's form of the paper's commit-cost trade-off.
//
// Design: tiles, staged edges, rows folded in order.  The schedule keeps a
// cell's edges grouped by local row with the padding last
// (core/engine.py::_cell_row_ptr), so a tile's edges are the one run
// [row_ptr[r0], row_ptr[r0 + R]) of src and val, and a tile never straddles
// two cells.  The block walks that run kChunk = 1,024 edges at a time
// (stage_fold, which K2 shares):
//   stage  every thread loads 4 of the chunk's src and val (neighbouring
//          threads on neighbouring edges, streamed past L1 with
//          ld.global.cs so they leave it to x), gathers their x (4
//          independent loads in flight a thread, not one dependent chain a
//          row), and writes the products to shared memory;
//   fold   the thread that owns row r adds the chunk's products of its row
//          in edge order from shared memory, carrying the sum from chunk to
//          chunk.
// The sum is thus the plain round's (edge order from the (+)-identity, no
// float atomics) bit for bit: plus-times starts at 0.0f with
// __fmul_rn/__fadd_rn (the build passes --fmad=false); min-plus starts at
// int32 max (what an empty jax segment_min reads) and computes
// min(x + val, INT_INF) with a wrapping int32 add.  Each row's epilogue
// operand (the table entry, or min-plus's old value) is loaded beside its
// edge range, before the walk, not after it.  The price of the order is the
// fold: one thread adds a row's products serially, so a row longer than a
// chunk (a hub's in-edges, on a skewed graph) is folded by one thread over
// many chunks while the block's other threads wait at the barrier; on
// twitter scale 22 no row has more than 38 edges, and the fold is a few
// percent of the walk (PERF.md).  What is left bounds the walk: the random
// 4-B gathers of x, each an L2 sector of 32 B where L1 misses.
//
// Tile size by delta: a step has P*delta rows.  R is that over the blocks
// that fit on the card at once (clamped to [8, 256] rows), so at delta = 128
// (1,024 rows a step) 128 small tiles spread the step over 128 SMs, and at
// sync and delta* a tile is about one per resident block and step.  The grid
// is at most what is co-resident, which a cooperative launch needs; the
// occupancy query runs once per kernel and device.  The staging buffer is
// static shared memory, which that query counts itself (no dynamic size).
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
constexpr int kAddConst = 0;  // c + acc            (pagerank)
constexpr int kAddTable = 1;  // table[row] + acc   (ppr's q, jacobi's b/diag)
constexpr int kMinOld = 2;    // min(old, acc)      (sssp, cc)

// The epilogue is split: its operand is loaded beside the row's edge range,
// before the row is summed, and finish() applies it to the sum.
struct PlusTimes {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T mul(T x, T a) { return __fmul_rn(x, a); }
  __device__ static T add(T acc, T v) { return __fadd_rn(acc, v); }
  // at: the global row id (the table's index)
  __device__ static T operand(int tag, const T*, int at, const T* table) {
    return tag == kAddTable ? table[at] : 0.0f;
  }
  __device__ static T finish(int tag, T operand, T acc, T c) {
    return tag == kAddConst ? __fadd_rn(c, acc) : __fadd_rn(operand, acc);
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
  // at: the row's slot in x (old)
  __device__ static T operand(int, const T* x, int at, const T*) {
    return __ldcg(x + at);
  }
  __device__ static T finish(int, T old, T acc, T) { return acc < old ? acc : old; }
};

constexpr int kChunk = 1024;  // edges a tile stages at once (4 a thread)
constexpr int kMinTileRows = 8;
constexpr int kMaxDevices = 64;
constexpr int kMaxShards = 64;  // D of a halo launch (a block keeps D maxima)
// K2 asks for K1's occupancy: at 76 registers (its f32 build's own choice)
// 3 blocks fit an SM, at 64 four, and the round is faster (PERF.md).
constexpr int kHaloBlocksPerSm = 4;

// torch.clamp's rule: a NaN passes through (fmaxf and fminf would drop it).
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The tile walk of K1 and K2: the block's tile is the edge run [t0, t1) of
// src and val, grouped by row; this thread's row (if it owns one) is the
// part [e0, e1).  The run is staged kChunk edges at a time: every thread
// loads 4 of the chunk's src and val (streamed), gathers their x through L1
// and writes the products to prod; then the thread that owns a row adds the
// chunk's products of its row in edge order, carrying the sum from chunk to
// chunk.  Returns that sum (the (+)-identity for an empty range).  Every
// thread of the block must call it with the same t0 and t1.
template <class Sr>
__device__ __forceinline__ typename Sr::T stage_fold(
    const typename Sr::T* x, const int32_t* __restrict__ src,
    const typename Sr::T* __restrict__ val, int t0, int t1, int e0, int e1,
    typename Sr::T* prod) {
  using T = typename Sr::T;
  constexpr int kPer = kChunk / kThreads;
  const int tid = threadIdx.x;
  T acc = Sr::zero();
  for (int cs = t0; cs < t1; cs += kChunk) {
    const int cn = min(kChunk, t1 - cs);
    const int32_t* sp = src + cs + tid;
    const T* vp = val + cs + tid;
    int32_t sv[kPer];
    T vv[kPer], xv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k * kThreads + tid < cn) {
        sv[k] = __ldcs(sp + k * kThreads);
        vv[k] = __ldcs(vp + k * kThreads);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k * kThreads + tid < cn) xv[k] = __ldca(x + sv[k]);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k * kThreads + tid < cn) prod[k * kThreads + tid] = Sr::mul(xv[k], vv[k]);
    }
    __syncthreads();
    const int lo = max(e0, cs);
    const int hi = min(e1, cs + cn);
    for (int e = lo; e < hi; ++e) acc = Sr::add(acc, prod[e - cs]);
    __syncthreads();
  }
  return acc;
}

template <class Sr>
__global__ void __launch_bounds__(kThreads)
    round_kernel(typename Sr::T* x, typename Sr::T* scratch,
                 const int32_t* __restrict__ src,
                 const typename Sr::T* __restrict__ val,
                 const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ rows,
                 const typename Sr::T* __restrict__ table, typename Sr::T c,
                 int tag, int n, int S, int P, int M, int delta, int R) {
  using T = typename Sr::T;
  __shared__ T prod[kChunk];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int tiles_per_cell = (delta + R - 1) / R;
  const long long tiles = static_cast<long long>(P) * tiles_per_cell;
  const long long cells = static_cast<long long>(P) * delta;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  for (int s = 0; s < S; ++s) {
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
      // this thread's row: its edge range and its epilogue's operand
      const long long i = static_cast<long long>(w) * delta + r0 + tid;
      int e0 = 0, e1 = 0;
      T operand = T();
      if (own) {
        e0 = ptr[tid];
        e1 = ptr[tid + 1];
        operand = Sr::operand(tag, x, rows[step_cell * delta + i], table);
      }
      const T acc = stage_fold<Sr>(x, src + cell * M, val + cell * M, t0, t1, e0, e1, prod);
      if (own) scratch[i] = Sr::finish(tag, operand, acc, c);
    }
    grid.sync();
    for (long long i = first; i < cells; i += stride) {
      const int row = rows[step_cell * delta + i];
      if (row < n) x[row] = scratch[i];
    }
    grid.sync();
  }
}

// Blocks of `kernel` that fit on the card at once (the most a cooperative
// launch may have), asked once per kernel and device and kept in `cache`.
cudaError_t resident_blocks(const void* kernel, int* cache, int* blocks) {
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
  if (!coop) return cudaErrorNotSupported;
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

template <class Sr>
cudaError_t launch(void* x, void* scratch, const void* src, const void* val,
                   const void* row_ptr, const void* rows, const void* table,
                   double c_in, int tag, int n, int S, int P, int M, int delta,
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
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&round_kernel<Sr>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  tile_grid(P, delta, resident, &R, &blocks);
  void* args[] = {&x_p, &scratch_p, &src_p, &val_p, &ptr_p, &rows_p, &table_p, &c,
                  &tag, &n,         &S,     &P,     &M,     &delta,  &R};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2: the commit steps [s0, s1) of one owner-computes halo round, for all D
// shards, in one cooperative launch.
//
// Replaces the TPU kernel src/repro/kernels/round_block.py::fused_halo_step_fn
// (a one-step pallas_call per shard with the shard's (L,) frontier aliased
// in VMEM and its (H,) boundary rows as a second output) together with what
// src/repro/dist/engine_sharded.py::frontier_pallas_round_fn runs between
// those calls: the all-gather of the boundary rows and, for an int8 or fp8
// wire, their quantization with error feedback.  On the TPU each shard is a
// device, so the exchange has to leave the kernel and an all-S grid per
// shard cannot keep the reference's order.  Here all D shards are stacked
// (D, L) on one card, and a grid barrier orders shard e's step-s reads after
// shard d's step-(s-1) commits exactly as the all-gather does; so one launch
// runs the whole round (the engine asks for [0, S)).
//
//   for s in s0..s1-1:
//     A  every tile of step s over all P = D * P_loc workers (worker w is
//        shard d = w / P_loc's), K1's tile walk (stage_fold) with
//          src    the shard's local slots, src_loc[d, s, w - d * P_loc]
//          gather x_loc[d, slot]
//          operand  table[rows[s, w, r]] (add_table) or
//                   x_loc[d, rows_loc[d, s, w - d * P_loc, r]] (min_old)
//        into scratch (P * delta,), shard d's chunk at d * P_loc * delta
//     grid.sync()
//     B  publish scratch into each shard's owned slots through rows_loc
//        (the dump slot L - 1 is skipped);
//        f32: for every (d, k), v = scratch[d's chunk + send_idx[s, d, k]]
//             goes to x_loc[e, recv_idx[s, e, d*H + k]] for every e (dump
//             slots skipped): one gather of v, D independent index loads
//        int8/fp8: want = scratch[...] + ef[d, s, k] for every (d, k), and
//             |want| folded into amax[s - s0, d] (atomicMax on the bits of a
//             non-negative float; the wrapper zeroes amax)
//     grid.sync()
//     C  (int8/fp8) scale, q, the dequantized value and the new ef[d, s, k]
//        for every (d, k), the dequantized value written into every
//        receiving shard's halo slot; grid.sync()
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
// (and, for min_old, each real row's old slot) once, per chunk row its edge
// range and local slot (and, for add_table, its global id and table entry),
// writes each real row once, and for the exchange reads send_idx
// (S * D * H) and recv_idx (S * D * D * H) once and writes each real halo
// slot once; an int8/fp8 wire also reads and writes ef once
// (chip_smoke.py::halo_round_bound).  The halo copies and the exchange's
// indices put it above K1's round bound: on twitter scale 22 at D = 4 and
// sync, recv_idx alone is 53 MB beside the edges' 514 MB.  At fine delta a
// step's fixed cost dominates as in K1: two grid barriers a step
// (three with a quantized wire) and the tile prologue, so at delta = 128
// (S = 4,099) a round holds 8,198 (12,297) barriers.
//
// A cross-card exchange (NCCL, one process per card) would run the same
// kernel one step at a time, s1 = s0 + 1, with the exchange restricted to
// the card's own shards and the all-gather between launches.
template <class Sr, int kWire>
__global__ void __launch_bounds__(kThreads, kHaloBlocksPerSm)
    halo_round_kernel(typename Sr::T* x, float* ef, typename Sr::T* scratch,
                      uint32_t* amax, const int32_t* __restrict__ src_loc,
                      const typename Sr::T* __restrict__ val,
                      const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ rows_loc,
                      const int32_t* __restrict__ send_idx,
                      const int32_t* __restrict__ recv_idx,
                      const typename Sr::T* __restrict__ table, typename Sr::T c,
                      int tag, int s0, int s1, int S, int D, int P_loc, int M,
                      int delta, int L, int H, int R, float inv_qmax) {
  using T = typename Sr::T;
  __shared__ T prod[kChunk];
  __shared__ uint32_t block_max[kWire ? kMaxShards : 1];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int P = D * P_loc;
  const int dump = L - 1;
  const int tiles_per_cell = (delta + R - 1) / R;
  const long long tiles = static_cast<long long>(P) * tiles_per_cell;
  const long long chunk = static_cast<long long>(P_loc) * delta;  // a shard's rows a step
  const long long cells = D * chunk;
  const long long sends = static_cast<long long>(D) * H;  // (d, k)
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  for (int s = s0; s < s1; ++s) {
    const long long step_cell = static_cast<long long>(s) * P;
    const int32_t* snd = send_idx + static_cast<long long>(s) * sends;  // (D, H)
    const int32_t* rcv = recv_idx + static_cast<long long>(s) * D * sends;  // (D, D*H)
    // --- A: the step's tiles, all shards
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int w = static_cast<int>(t / tiles_per_cell);
      const int r0 = static_cast<int>(t - static_cast<long long>(w) * tiles_per_cell) * R;
      const int rn = min(R, delta - r0);
      const int d = w / P_loc;
      const long long cell = step_cell + w;  // (s, w) of the schedule
      const long long lcell = (static_cast<long long>(d) * S + s) * P_loc + (w - d * P_loc);
      const T* xd = x + static_cast<long long>(d) * L;
      const int32_t* ptr = row_ptr + cell * (delta + 1) + r0;
      const int t0 = ptr[0];
      const int t1 = ptr[rn];
      const bool own = tid < rn;
      const int r = r0 + tid;
      int e0 = 0, e1 = 0;
      T operand = T();
      if (own) {
        e0 = ptr[tid];
        e1 = ptr[tid + 1];
        if (tag == kMinOld) {
          operand = Sr::operand(tag, xd, rows_loc[lcell * delta + r], table);
        } else if (tag == kAddTable) {
          operand = Sr::operand(tag, xd, rows[cell * delta + r], table);
        }
      }
      const T acc = stage_fold<Sr>(xd, src_loc + lcell * M, val + cell * M, t0, t1, e0, e1, prod);
      if (own) scratch[static_cast<long long>(w) * delta + r] = Sr::finish(tag, operand, acc, c);
    }
    grid.sync();
    // --- B: publish, then the exchange (f32) or the scales' maxima
    for (long long i = first; i < cells; i += stride) {
      const int d = static_cast<int>(i / chunk);
      const int slot = rows_loc[(static_cast<long long>(d) * S + s) * chunk + (i - d * chunk)];
      if (slot < dump) x[static_cast<long long>(d) * L + slot] = scratch[i];
    }
    if constexpr (kWire == 0) {
      for (long long m = first; m < sends; m += stride) {  // (d, k), to every e
        const int d = static_cast<int>(m / H);
        const T v = scratch[d * chunk + snd[m]];
        for (int e = 0; e < D; ++e) {
          const int slot = rcv[e * sends + m];
          if (slot < dump) x[static_cast<long long>(e) * L + slot] = v;
        }
      }
      grid.sync();
    } else {
      for (int d = tid; d < D; d += kThreads) block_max[d] = 0;
      __syncthreads();
      for (long long m = first; m < sends; m += stride) {  // (d, k)
        const int d = static_cast<int>(m / H);
        const float want = __fadd_rn(scratch[d * chunk + snd[m]],
                                     ef[(static_cast<long long>(d) * S + s) * H + (m - d * H)]);
        atomicMax(block_max + d, __float_as_uint(fabsf(want)));
      }
      __syncthreads();
      for (int d = tid; d < D; d += kThreads) {
        if (block_max[d]) atomicMax(amax + static_cast<long long>(s - s0) * D + d, block_max[d]);
      }
      grid.sync();
      // --- C: quantize, keep the residual, ship the dequantized value
      constexpr float kQmax = kWire == 1 ? 127.0f : 448.0f;
      for (long long m = first; m < sends; m += stride) {
        const int d = static_cast<int>(m / H);
        float* efp = ef + (static_cast<long long>(d) * S + s) * H + (m - d * H);
        const float want = __fadd_rn(scratch[d * chunk + snd[m]], *efp);
        const float a = __uint_as_float(__ldcg(amax + static_cast<long long>(s - s0) * D + d));
        const float scale = __fmul_rn(a < 1e-30f ? 1e-30f : a, inv_qmax);
        float q = __fdiv_rn(want, scale);
        if constexpr (kWire == 1) {  // through an integer, as the int8 cast: -0 becomes 0
          q = static_cast<float>(static_cast<int>(clamp_nan(rintf(q), -kQmax, kQmax)));
        } else {
          const __nv_fp8_storage_t b =
              __nv_cvt_float_to_fp8(clamp_nan(q, -kQmax, kQmax), __NV_SATFINITE, __NV_E4M3);
          q = __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
        }
        *efp = __fmaf_rn(-q, scale, want);
        const float wire = __fmul_rn(q, scale);
        for (int e = 0; e < D; ++e) {
          const int slot = rcv[e * sends + m];
          if (slot < dump) x[static_cast<long long>(e) * L + slot] = wire;
        }
      }
      grid.sync();
    }
  }
}

template <class Sr, int kWire>
cudaError_t launch_halo_round(void* x, void* ef, void* scratch, void* amax,
                              const void* src_loc, const void* val,
                              const void* row_ptr, const void* rows,
                              const void* rows_loc, const void* send_idx,
                              const void* recv_idx, const void* table,
                              double c_in, double inv_qmax_in, int tag, int s0,
                              int s1, int S, int D, int P_loc, int M, int delta,
                              int L, int H, cudaStream_t stream) {
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
  const T* table_p = static_cast<const T*>(table);
  T c = static_cast<T>(c_in);
  float inv_qmax = static_cast<float>(inv_qmax_in);
  static int cache[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(&halo_round_kernel<Sr, kWire>);
  int resident = 0, R = 0, blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  tile_grid(D * P_loc, delta, resident, &R, &blocks);
  void* args[] = {&x_p,   &ef_p,  &scratch_p, &amax_p, &src_p, &val_p, &ptr_p,
                  &rows_p, &rl_p, &snd_p,     &rcv_p,  &table_p, &c,   &tag,
                  &s0,    &s1,    &S,         &D,      &P_loc, &M,     &delta,
                  &L,     &H,     &R,         &inv_qmax};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 plus-times, 1 = int32 min-plus.  Returns a cudaError_t.
extern "C" int round_block_launch(int dtype, void* x, void* scratch,
                                  const void* src, const void* val,
                                  const void* row_ptr, const void* rows,
                                  const void* table, double c, int tag, int n,
                                  int S, int P, int M, int delta, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (tag == kAddConst || (tag == kAddTable && table != nullptr))) {
    return launch<PlusTimes>(x, scratch, src, val, row_ptr, rows, table, c, tag,
                             n, S, P, M, delta, st);
  }
  if (dtype == 1 && tag == kMinOld) {
    return launch<MinPlus>(x, scratch, src, val, row_ptr, rows, table, c, tag, n,
                           S, P, M, delta, st);
  }
  return cudaErrorInvalidValue;
}

// K2.  dtype and tag as for round_block_launch; wire: 0 = f32, 1 = int8,
// 2 = fp8 (float32 plus-times only; ef and amax are read only then).
// Returns a cudaError_t.
extern "C" int halo_round_launch(int dtype, int wire, void* x, void* ef,
                                 void* scratch, void* amax, const void* src_loc,
                                 const void* val, const void* row_ptr,
                                 const void* rows, const void* rows_loc,
                                 const void* send_idx, const void* recv_idx,
                                 const void* table, double c, double inv_qmax,
                                 int tag, int s0, int s1, int S, int D, int P_loc,
                                 int M, int delta, int L, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxShards || s0 < 0 || s1 > S || s0 >= s1) return cudaErrorInvalidValue;
#define HALO_ARGS                                                                  \
  x, ef, scratch, amax, src_loc, val, row_ptr, rows, rows_loc, send_idx, recv_idx, \
      table, c, inv_qmax, tag, s0, s1, S, D, P_loc, M, delta, L, H, st
  if (dtype == 0 && (tag == kAddConst || (tag == kAddTable && table != nullptr))) {
    if (wire == 0) return launch_halo_round<PlusTimes, 0>(HALO_ARGS);
    if (wire == 1 && ef != nullptr && amax != nullptr) return launch_halo_round<PlusTimes, 1>(HALO_ARGS);
    if (wire == 2 && ef != nullptr && amax != nullptr) return launch_halo_round<PlusTimes, 2>(HALO_ARGS);
  }
  if (dtype == 1 && tag == kMinOld && wire == 0) return launch_halo_round<MinPlus, 0>(HALO_ARGS);
#undef HALO_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* round_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
