// K3: semiring SpMV over a padded ELL layout.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py::spmv_ell (bodies
// _kernel_plus_times and _kernel_min_plus; its pallas_call tiles the rows by
// row_tile = 256 with the frontier pinned in VMEM):
//
//   out[r, f] = (+)_j x[idx[r, j], f] (x) val[r, j]
//
// One thread computes one (row, feature) output, walking the row's max_deg
// columns in order, so the sum has the plain version's order
// (repro_torch/kernels/ref.py::spmv_ell_ref, column by column):
// plus-times starts at 0.0f with __fmul_rn/__fadd_rn (the build passes
// --fmad=false), min-plus widens to int64 and saturates at INT_INF, as the
// reference's plain version does.  The F threads of a row read the same idx
// and val entries and neighbouring x entries.
//
// Bound on the H100: bytes.  Every padded idx and val entry is read once
// (8 B), x is gathered, and out written once: for twitter scale 22
// (4.2 M rows, max_deg padded to 128) 4.3 GB, 1.28 ms at 3.35 TB/s, against
// 0.16 ms for the real edges alone.  Padding is the layout's cost, not the
// kernel's; the kernel reads it because ELL carries no row lengths.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kIntInf = (1 << 30) - 1;

__global__ void __launch_bounds__(kThreads)
    spmv_plus_times(const float* __restrict__ x, const int32_t* __restrict__ idx,
                    const float* __restrict__ val, float* __restrict__ out,
                    long long rows, int max_deg, int F) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * F) return;
  const long long r = i / F;
  const int f = static_cast<int>(i - r * F);
  const int32_t* ir = idx + r * max_deg;
  const float* vr = val + r * max_deg;
  float acc = 0.0f;
  for (int j = 0; j < max_deg; ++j) {
    const float xv = __ldg(x + static_cast<long long>(ir[j]) * F + f);
    acc = __fadd_rn(acc, __fmul_rn(xv, vr[j]));
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
    spmv_min_plus(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ val, int32_t* __restrict__ out,
                  long long rows, int max_deg, int F) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * F) return;
  const long long r = i / F;
  const int f = static_cast<int>(i - r * F);
  const int32_t* ir = idx + r * max_deg;
  const int32_t* vr = val + r * max_deg;
  long long acc = kIntInf;
  for (int j = 0; j < max_deg; ++j) {
    long long s = static_cast<long long>(__ldg(x + static_cast<long long>(ir[j]) * F + f)) + vr[j];
    s = s < kIntInf ? s : kIntInf;
    acc = s < acc ? s : acc;
  }
  out[i] = static_cast<int32_t>(acc);
}

}  // namespace

// semiring: 0 = float32 plus-times, 1 = int32 min-plus.  x is (n_slots, F)
// row-major (F = 1 for a vector), idx and val (rows, max_deg), out (rows, F).
// Returns a cudaError_t.
extern "C" int spmv_ell_launch(int semiring, const void* x, const void* idx,
                               const void* val, void* out, long long rows,
                               int max_deg, int F, void* stream) {
  const long long total = rows * F;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (semiring == 0) {
    spmv_plus_times<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(idx),
        static_cast<const float*>(val), static_cast<float*>(out), rows, max_deg, F);
  } else if (semiring == 1) {
    spmv_min_plus<<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(val), static_cast<int32_t*>(out), rows, max_deg, F);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* spmv_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
