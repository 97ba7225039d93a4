// K1: one full engine round (all S commit steps) in one cooperative launch.
//
// Replaces the TPU kernel src/repro/kernels/round_block.py::fused_round_fn_q
// (its pallas_call runs the S steps as a sequential grid with the frontier
// aliased in VMEM).  Here the S steps are a loop inside one persistent
// cooperative launch:
//
//   for s in 0..S-1:
//     every (worker w, local row r < delta) of step s, one thread each:
//       acc = (+) over the row's edges, in edge order, of x[src] (x) val
//       scratch[w, r] = epilogue(old = x[rows[s,w,r]], acc, rows[s,w,r])
//     grid.sync()
//     publish scratch into x at rows[s] (dump rows, == n, are skipped)
//     grid.sync()
//
// so step s reads every commit of the steps before it and none of its own:
// the block Gauss-Seidel order of src/repro/core/engine.py::_commit_step.
// A thread finds its row's edges through row_ptr (S, P, delta+1), built on
// the host from the sorted dst_local, and never reads a padding entry.
//
// Bit-identity with the reference: plus-times starts at 0.0f and uses
// __fmul_rn/__fadd_rn (no FMA contraction; the build also passes
// --fmad=false) in edge order, with no float atomics; min-plus starts at
// int32 max (what an empty jax segment_min reads) and computes
// min(x + val, INT_INF) with a wrapping int32 add.
//
// Bound on the H100: bytes.  A round must read each real edge's src index and
// value once (8 B an edge) and read and write the frontier once: for twitter
// scale 22 (64.3 M edges, 4.2 M rows) about 0.55 GB, 0.17 ms at 3.35 TB/s.
// At fine delta the fixed cost of a commit step dominates instead: the 2*S
// grid barriers (8,198 a round at delta = 128) plus the serial walk of the
// step's longest row, each about half of the round (PERF.md).  That is this
// card's form of the paper's commit-cost trade-off.  A step has only P*delta
// rows of work, so the grid is sized to that work (at most what can be
// co-resident), not to the card.

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
  __device__ static T epilogue(int tag, const T* x, int row, T acc, T c,
                               const T* table) {
    return tag == kAddConst ? __fadd_rn(c, acc) : __fadd_rn(table[row], acc);
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
  __device__ static T epilogue(int, const T* x, int row, T acc, T, const T*) {
    const T old = __ldcg(x + row);
    return acc < old ? acc : old;
  }
};

// x is read and written by different blocks across grid.sync(), so its loads
// go through L2 (__ldcg), never a stale L1 or the read-only path.
template <class Sr>
__global__ void __launch_bounds__(kThreads)
    round_kernel(typename Sr::T* x, typename Sr::T* scratch,
                 const int32_t* __restrict__ src,
                 const typename Sr::T* __restrict__ val,
                 const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ rows,
                 const typename Sr::T* __restrict__ table, typename Sr::T c,
                 int tag, int n, int S, int P, int M, int delta) {
  using T = typename Sr::T;
  cg::grid_group grid = cg::this_grid();
  const long long cells = static_cast<long long>(P) * delta;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int s = 0; s < S; ++s) {
    const long long step_cell = static_cast<long long>(s) * P;
    for (long long i = first; i < cells; i += stride) {
      const int w = static_cast<int>(i / delta);
      const int r = static_cast<int>(i - static_cast<long long>(w) * delta);
      const long long cell = step_cell + w;
      const int32_t* ptr = row_ptr + cell * (delta + 1);
      const int32_t* cell_src = src + cell * M;
      const T* cell_val = val + cell * M;
      T acc = Sr::zero();
      const int e1 = ptr[r + 1];
      for (int e = ptr[r]; e < e1; ++e) {
        acc = Sr::add(acc, Sr::mul(__ldcg(x + cell_src[e]), cell_val[e]));
      }
      const int row = rows[step_cell * delta + i];
      scratch[i] = Sr::epilogue(tag, x, row, acc, c, table);
    }
    grid.sync();
    for (long long i = first; i < cells; i += stride) {
      const int row = rows[step_cell * delta + i];
      if (row < n) x[row] = scratch[i];
    }
    grid.sync();
  }
}

template <class Sr>
cudaError_t launch(void* x, void* scratch, const void* src, const void* val,
                   const void* row_ptr, const void* rows, const void* table,
                   double c_in, int tag, int n, int S, int P, int M, int delta,
                   cudaStream_t stream) {
  using T = typename Sr::T;
  const void* kernel = reinterpret_cast<const void*>(&round_kernel<Sr>);
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
  const long long cells = static_cast<long long>(P) * delta;
  long long blocks = (cells + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;

  T* x_p = static_cast<T*>(x);
  T* scratch_p = static_cast<T*>(scratch);
  const int32_t* src_p = static_cast<const int32_t*>(src);
  const T* val_p = static_cast<const T*>(val);
  const int32_t* ptr_p = static_cast<const int32_t*>(row_ptr);
  const int32_t* rows_p = static_cast<const int32_t*>(rows);
  const T* table_p = static_cast<const T*>(table);
  T c = static_cast<T>(c_in);
  void* args[] = {&x_p, &scratch_p, &src_p, &val_p, &ptr_p, &rows_p, &table_p,
                  &c,   &tag,       &n,     &S,     &P,     &M,     &delta};
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

extern "C" const char* round_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
