// K3: semiring SpMV over a padded ELL layout.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py::spmv_ell (bodies
// _kernel_plus_times and _kernel_min_plus; its pallas_call tiles the rows by
// row_tile = 256 with the frontier pinned in VMEM):
//
//   out[r, f] = (+)_j x[idx[r, j], f] (x) val[r, j]
//
// Bound on the H100: bytes.  Every padded idx and val entry is read once
// (8 B), x is gathered, and out written once: for twitter scale 22
// (4.2 M rows, max_deg 38 padded to 128) 4.3 GB, 1.29 ms at 3.35 TB/s,
// against 0.16 ms for the real edges alone.  Padding is the layout's cost,
// not the kernel's; the kernel reads it because ELL carries no row lengths
// (a lane_pad = 8 layout pads the same graph to 40 columns).  There is no
// dense tile anywhere, only a gathered semiring sum, so the tensor cores
// have no part in it.
//
// Design.  A block owns a tile of R consecutive rows and walks their
// columns in chunks of CW (CW = max_deg up to 64 columns, else 32: one
// 128-B line of idx and one of val per row).  Per chunk:
//   stage  every thread takes 4 neighbouring slots of the tile's
//          R x CW run (16-B loads of idx and val, neighbouring threads on
//          neighbouring addresses, streamed past L2 with ld.global.cs so
//          they do not evict x), gathers their x (independent loads, many
//          in flight; padding gathers x[0], one broadcast address), and
//          writes the products to shared memory, rows padded by 16 B
//          against bank conflicts;
//   fold   one thread per (row, feature) adds its row's CW products in
//          column order from shared memory (16-B reads, conflict-free),
//          carrying the sum from chunk to chunk.
// So every (row, feature) output is the plain version's running sum
// (repro_torch/kernels/ref.py::spmv_ell_ref, column by column) bit for bit:
// plus-times starts at 0.0f with __fmul_rn/__fadd_rn (the build passes
// --fmad=false); min-plus widens to int64, saturates at INT_INF and keeps
// the int64 minimum until the final cast, as the plain version does.  The
// fold is serial in a row; at 32 columns a chunk it is a short chain beside
// the chunk's loads, and the tile's other blocks on the SM keep the loads in
// flight while one block folds.  A row of max_deg = 4,096 is 128 chunks,
// and its fold 128 such chains in a row, one a chunk.  Where max_deg is not
// a multiple of 4 (or a pointer is not 16-B aligned) the same kernel runs
// with scalar slots.
//
// No bulk-copy (TMA) ring: with several tiles resident on each SM, plain
// 16-B loads keep enough bytes in flight, and the kernel reads close to the
// padded byte bound (PERF.md), which leaves a ring little to win.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kIntInf = (1 << 30) - 1;
constexpr int kMaxProducts = 8192;  // shared products a chunk, at most
constexpr int kMaxRows = 1024;      // rows a tile, at most

struct PlusTimes {
  using T = float;  // x, val, out
  using P = float;  // product and running sum
  using V4 = float4;
  __device__ static P zero() { return 0.0f; }
  __device__ static P mul(T x, T v) { return __fmul_rn(x, v); }
  __device__ static P add(P acc, P p) { return __fadd_rn(acc, p); }
  __device__ static T out(P acc) { return acc; }
};

struct MinPlus {
  using T = int32_t;
  using P = long long;
  using V4 = int4;
  __device__ static P zero() { return kIntInf; }
  __device__ static P mul(T x, T v) {
    const long long s = static_cast<long long>(x) + v;
    return s < kIntInf ? s : kIntInf;
  }
  __device__ static P add(P acc, P p) { return p < acc ? p : acc; }
  __device__ static T out(P acc) { return static_cast<T>(acc); }
};

__device__ __forceinline__ float v4get(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ int32_t v4get(const int4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Four products to shared memory at a 16-B aligned address.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(long long* p, const long long (&v)[4]) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(v[0], v[1]);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(v[2], v[3]);
}

// acc (+)= p[0], p[1], p[2], p[3], in that order.
template <class Sr>
__device__ __forceinline__ typename Sr::P fold4(typename Sr::P acc, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return Sr::add(Sr::add(Sr::add(Sr::add(acc, v.x), v.y), v.z), v.w);
}
template <class Sr>
__device__ __forceinline__ typename Sr::P fold4(typename Sr::P acc, const long long* p) {
  const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
  const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
  return Sr::add(Sr::add(Sr::add(Sr::add(acc, a.x), a.y), b.x), b.y);
}

// VEC: ELL slots a thread stages at once (4: 16-B loads; 1: scalar).
// FV: features a gather loads at once (4: one 16-B load of x's row; 1).
// The shared products of a chunk are laid out [F][R][stride], stride = CW
// plus 16 B (VEC 4, keeping rows 16-B aligned) or one element (VEC 1).
template <class Sr, int VEC, int FV>
__global__ void __launch_bounds__(kThreads)
    spmv_tiles(const typename Sr::T* __restrict__ x, const int32_t* __restrict__ idx,
               const typename Sr::T* __restrict__ val, typename Sr::T* __restrict__ out,
               long long rows, int max_deg, int F, int R, int CW) {
  using T = typename Sr::T;
  using P = typename Sr::P;
  using V4 = typename Sr::V4;
  constexpr int kSlots = FV == 4 ? 2048 : 4096;  // R * CW, at most
  constexpr int kIters = kSlots / (VEC * kThreads);
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = CW + (VEC == 4 ? static_cast<int>(16 / sizeof(P)) : 1);
  P* prod = reinterpret_cast<P*>(smem);
  P* accs = prod + static_cast<long long>(F) * R * stride;  // [R * F] running sums

  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int rn = static_cast<int>(rows - row0 < R ? rows - row0 : R);
  const int nq = rn * F;
  for (int q = threadIdx.x; q < nq; q += kThreads) accs[q] = Sr::zero();

  for (int c0 = 0; c0 < max_deg; c0 += CW) {
    const int cw = max_deg - c0 < CW ? max_deg - c0 : CW;
    const int groups = rn * cw / VEC;
    // stage: this thread's slot groups, loads first, then the gathers
    int32_t ii[kIters][VEC];
    T vv[kIters][VEC];
    int rr[kIters], cc[kIters];
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int g = k * kThreads + threadIdx.x;
      rr[k] = -1;
      if (g < groups) {
        const int q0 = g * VEC;
        rr[k] = q0 / cw;
        cc[k] = q0 - rr[k] * cw;
        const long long off = (row0 + rr[k]) * max_deg + c0 + cc[k];
        if constexpr (VEC == 4) {
          const int4 i4 = __ldcs(reinterpret_cast<const int4*>(idx + off));
          const V4 v4 = __ldcs(reinterpret_cast<const V4*>(val + off));
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ii[k][u] = v4get(i4, u);
            vv[k][u] = v4get(v4, u);
          }
        } else {
          ii[k][0] = __ldcs(idx + off);
          vv[k][0] = __ldcs(val + off);
        }
      }
    }
    for (int f0 = 0; f0 < F; f0 += FV) {
      P pp[FV][kIters][VEC];
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        if (rr[k] < 0) continue;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const long long xo = static_cast<long long>(ii[k][u]) * F + f0;
          if constexpr (FV == 4) {
            const V4 xv = __ldg(reinterpret_cast<const V4*>(x + xo));
#pragma unroll
            for (int fv = 0; fv < 4; ++fv) pp[fv][k][u] = Sr::mul(v4get(xv, fv), vv[k][u]);
          } else {
            pp[0][k][u] = Sr::mul(__ldg(x + xo), vv[k][u]);
          }
        }
      }
#pragma unroll
      for (int fv = 0; fv < FV; ++fv) {
#pragma unroll
        for (int k = 0; k < kIters; ++k) {
          if (rr[k] < 0) continue;
          P* dst = prod + (static_cast<long long>(f0 + fv) * R + rr[k]) * stride + cc[k];
          if constexpr (VEC == 4) {
            store4(dst, pp[fv][k]);
          } else {
            *dst = pp[fv][k][0];
          }
        }
      }
    }
    __syncthreads();
    // fold: (row, feature) q, rows fastest, in column order
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const int f = q / rn;
      const int r = q - f * rn;
      const P* p = prod + (static_cast<long long>(f) * R + r) * stride;
      P acc = accs[q];
      if constexpr (VEC == 4) {
        for (int j = 0; j < cw; j += 4) acc = fold4<Sr>(acc, p + j);
      } else {
        for (int j = 0; j < cw; ++j) acc = Sr::add(acc, p[j]);
      }
      accs[q] = acc;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int f = q / rn;
    const int r = q - f * rn;
    out[(row0 + r) * F + f] = Sr::out(accs[q]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <class Sr, int VEC, int FV>
cudaError_t launch_tiles(const void* x, const void* idx, const void* val, void* out,
                         long long rows, int max_deg, int F, cudaStream_t stream) {
  using T = typename Sr::T;
  using P = typename Sr::P;
  constexpr int kSlots = FV == 4 ? 2048 : 4096;
  const int CW = max_deg == 0 ? 1 : max_deg <= 64 ? max_deg : 32;
  const int stride = CW + (VEC == 4 ? static_cast<int>(16 / sizeof(P)) : 1);
  long long R = kSlots / CW;
  const long long by_products = kMaxProducts / (static_cast<long long>(CW) * F);
  if (by_products < R) R = by_products;
  if (R > kMaxRows) R = kMaxRows;
  if (R > rows) R = rows;
  if (R < 1) R = 1;
  const size_t smem = (static_cast<size_t>(F) * R * stride + static_cast<size_t>(R) * F) * sizeof(P);
  const auto kernel = &spmv_tiles<Sr, VEC, FV>;
  if (smem > 48 * 1024) {  // only a wide F takes more than the default
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (rows + R - 1) / R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx), static_cast<const T*>(val),
      static_cast<T*>(out), rows, max_deg, F, static_cast<int>(R), CW);
  return cudaGetLastError();
}

template <class Sr>
cudaError_t launch(const void* x, const void* idx, const void* val, void* out,
                   long long rows, int max_deg, int F, cudaStream_t stream) {
  const bool vec = max_deg % 4 == 0 && aligned16(idx) && aligned16(val);
  const bool fvec = F % 4 == 0 && aligned16(x);
  if (vec && fvec) return launch_tiles<Sr, 4, 4>(x, idx, val, out, rows, max_deg, F, stream);
  if (vec) return launch_tiles<Sr, 4, 1>(x, idx, val, out, rows, max_deg, F, stream);
  if (fvec) return launch_tiles<Sr, 1, 4>(x, idx, val, out, rows, max_deg, F, stream);
  return launch_tiles<Sr, 1, 1>(x, idx, val, out, rows, max_deg, F, stream);
}

}  // namespace

// semiring: 0 = float32 plus-times, 1 = int32 min-plus.  x is (n_slots, F)
// row-major (F = 1 for a vector), idx and val (rows, max_deg), out (rows, F).
// Returns a cudaError_t.
extern "C" int spmv_ell_launch(int semiring, const void* x, const void* idx,
                               const void* val, void* out, long long rows,
                               int max_deg, int F, void* stream) {
  if (rows == 0 || F == 0) return cudaSuccess;
  if (max_deg < 0 || F < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (semiring == 0) return launch<PlusTimes>(x, idx, val, out, rows, max_deg, F, st);
  if (semiring == 1) return launch<MinPlus>(x, idx, val, out, rows, max_deg, F, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* spmv_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
