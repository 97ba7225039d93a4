// K1: one full engine round (all S commit steps) in one cooperative launch,
// and K2: one shard's halo commit step (second entry point, further down).
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
// two cells.  The block walks that run kChunk = 1,024 edges at a time:
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

struct PlusTimes {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T mul(T x, T a) { return __fmul_rn(x, a); }
  __device__ static T add(T acc, T v) { return __fadd_rn(acc, v); }
  // slot: where old is read in x; row: the global row id (table index).
  __device__ static T epilogue(int tag, const T*, int, int row, T acc, T c,
                               const T* table) {
    return tag == kAddConst ? __fadd_rn(c, acc) : __fadd_rn(table[row], acc);
  }
  // K1 splits the epilogue: its operand is loaded before the row is summed.
  __device__ static T operand(int tag, const T*, int row, const T* table) {
    return tag == kAddTable ? table[row] : 0.0f;
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
  __device__ static T epilogue(int, const T* x, int slot, int, T acc, T,
                               const T*) {
    const T old = __ldcg(x + slot);
    return acc < old ? acc : old;
  }
  __device__ static T operand(int, const T* x, int row, const T*) {
    return __ldcg(x + row);  // old
  }
  __device__ static T finish(int, T old, T acc, T) { return acc < old ? acc : old; }
};

// K2's row walk: (+) over edges [e0, e1) in edge order of x[src] (x) val,
// the order in which K1 folds each row.  x is read and written by different
// blocks across grid.sync(), so its loads go through L2 (__ldcg), never a
// stale L1 or the read-only path.
template <class Sr>
__device__ __forceinline__ typename Sr::T walk_row(
    const typename Sr::T* x, const int32_t* __restrict__ src,
    const typename Sr::T* __restrict__ val, int e0, int e1) {
  typename Sr::T acc = Sr::zero();
  for (int e = e0; e < e1; ++e) {
    acc = Sr::add(acc, Sr::mul(__ldcg(x + src[e]), val[e]));
  }
  return acc;
}

constexpr int kChunk = 1024;  // edges a tile stages at once (4 a thread)
constexpr int kMinTileRows = 8;
constexpr int kMaxDevices = 64;

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
  constexpr int kPer = kChunk / kThreads;
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
      T acc = Sr::zero();
      for (int cs = t0; cs < t1; cs += kChunk) {
        const int cn = min(kChunk, t1 - cs);
        const int32_t* sp = src + cell * M + cs + tid;
        const T* vp = val + cell * M + cs + tid;
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

// One block per kThreads cells, at most as many as can be co-resident (a
// cooperative launch needs every block resident for grid.sync()).
cudaError_t cooperative_launch(const void* kernel, long long cells, void** args,
                               cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (cells + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, cache, &resident);
  if (err != cudaSuccess) return err;
  // rows a tile: one tile per resident block and step, within [8, 256]
  long long r = (static_cast<long long>(P) * delta + resident - 1) / resident;
  if (r < kMinTileRows) r = kMinTileRows;
  if (r > kThreads) r = kThreads;
  if (r > delta) r = delta;
  int R = static_cast<int>(r);
  long long blocks = static_cast<long long>(P) * ((delta + R - 1) / R);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  void* args[] = {&x_p, &scratch_p, &src_p, &val_p, &ptr_p, &rows_p, &table_p, &c,
                  &tag, &n,         &S,     &P,     &M,     &delta,  &R};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2: one shard's owner-computes halo commit step.
//
// Replaces the TPU kernel src/repro/kernels/round_block.py::fused_halo_step_fn
// (a one-step pallas_call with the shard's (L,) frontier aliased in VMEM and
// the (H,) boundary rows as a second output).  The engine
// (repro_torch/dist/engine_sharded.py) calls it once per shard and commit
// step, S*D launches a round, and exchanges the boundary rows between steps.
//
//   every local row i = (worker w, r) of the shard's chunk, one thread each:
//     acc = (+) over the row's edges, in edge order, of x[src] (x) val
//     scratch[i] = epilogue(old = x[rows_loc[i]], acc, global row rows_g[i])
//   grid.sync()
//   publish scratch into x at rows_loc (the dump slot L-1 is skipped)
//   send[h] = scratch[send_idx[h]]
//
// src holds local slots (owned, halo, dump) in the schedule's edge order, so
// the schedule's own row_ptr columns for the shard's workers give each row
// its edges.  The row walk, the epilogues and the rounding are K1's, so an
// f32 halo round equals K1's round bit for bit.
//
// Bound on the H100: bytes, as K1's, but per step: the step's real edges
// (8 B each), the chunk's rows read and written, and the boundary rows
// written.  At coarse delta one step is a round's worth of one shard's
// edges; at fine delta the launch and the grid barrier dominate (PERF.md).
template <class Sr>
__global__ void __launch_bounds__(kThreads)
    halo_step_kernel(typename Sr::T* x, typename Sr::T* scratch,
                     typename Sr::T* send, const int32_t* __restrict__ src,
                     const typename Sr::T* __restrict__ val,
                     const int32_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ rows_g,
                     const int32_t* __restrict__ rows_loc,
                     const int32_t* __restrict__ send_idx,
                     const typename Sr::T* __restrict__ table, typename Sr::T c,
                     int tag, int L, int P_loc, int M, int delta, int H) {
  cg::grid_group grid = cg::this_grid();
  const long long cells = static_cast<long long>(P_loc) * delta;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < cells; i += stride) {
    const int w = static_cast<int>(i / delta);
    const int r = static_cast<int>(i - static_cast<long long>(w) * delta);
    const int32_t* ptr = row_ptr + static_cast<long long>(w) * (delta + 1);
    const long long off = static_cast<long long>(w) * M;
    const auto acc = walk_row<Sr>(x, src + off, val + off, ptr[r], ptr[r + 1]);
    scratch[i] = Sr::epilogue(tag, x, rows_loc[i], rows_g[i], acc, c, table);
  }
  grid.sync();
  for (long long i = first; i < cells; i += stride) {
    const int slot = rows_loc[i];
    if (slot < L - 1) x[slot] = scratch[i];
  }
  // scratch rows of other blocks: read through L2, as x is
  for (long long h = first; h < H; h += stride) send[h] = __ldcg(scratch + send_idx[h]);
}

template <class Sr>
cudaError_t launch_halo(void* x, void* scratch, void* send, const void* src,
                        const void* val, const void* row_ptr, const void* rows_g,
                        const void* rows_loc, const void* send_idx,
                        const void* table, double c_in, int tag, int L, int P_loc,
                        int M, int delta, int H, cudaStream_t stream) {
  using T = typename Sr::T;
  T* x_p = static_cast<T*>(x);
  T* scratch_p = static_cast<T*>(scratch);
  T* send_p = static_cast<T*>(send);
  const int32_t* src_p = static_cast<const int32_t*>(src);
  const T* val_p = static_cast<const T*>(val);
  const int32_t* ptr_p = static_cast<const int32_t*>(row_ptr);
  const int32_t* rg_p = static_cast<const int32_t*>(rows_g);
  const int32_t* rl_p = static_cast<const int32_t*>(rows_loc);
  const int32_t* snd_p = static_cast<const int32_t*>(send_idx);
  const T* table_p = static_cast<const T*>(table);
  T c = static_cast<T>(c_in);
  void* args[] = {&x_p,   &scratch_p, &send_p, &src_p, &val_p, &ptr_p,
                  &rg_p,  &rl_p,      &snd_p,  &table_p, &c,   &tag,
                  &L,     &P_loc,     &M,      &delta, &H};
  long long cells = static_cast<long long>(P_loc) * delta;
  if (cells < H) cells = H;
  return cooperative_launch(reinterpret_cast<const void*>(&halo_step_kernel<Sr>),
                            cells, args, stream);
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

// K2.  dtype and tag as for round_block_launch.  Returns a cudaError_t.
extern "C" int halo_step_launch(int dtype, void* x, void* scratch, void* send,
                                const void* src, const void* val,
                                const void* row_ptr, const void* rows_g,
                                const void* rows_loc, const void* send_idx,
                                const void* table, double c, int tag, int L,
                                int P_loc, int M, int delta, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (tag == kAddConst || (tag == kAddTable && table != nullptr))) {
    return launch_halo<PlusTimes>(x, scratch, send, src, val, row_ptr, rows_g,
                                  rows_loc, send_idx, table, c, tag, L, P_loc, M,
                                  delta, H, st);
  }
  if (dtype == 1 && tag == kMinOld) {
    return launch_halo<MinPlus>(x, scratch, send, src, val, row_ptr, rows_g,
                                rows_loc, send_idx, table, c, tag, L, P_loc, M,
                                delta, H, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* round_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
