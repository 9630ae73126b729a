// Fused stationary gram for Hopper (sm_90a):
//
//   out[i, j] = var * k(0.5 * sum_d (s1[i, d] - s2[j, d])^2)
//
// for the four ARD_L2 families (SE, MAT32, MAT52, RQ), over a batch of
// `batch` independent rows r: s1[r] (m x d), s2[r] (n x d), var[r],
// alpha[r] -> out[r] (m x n).  The caller has already scaled both point
// sets by the row's ARD rate and centred them, so the kernel sees plain
// coordinates.  A single gram is the batch of one.
//
// Replaces the TPU kernel g3py_tpu/ops/pallas_gram.py::_stationary_kernel
// (launched by _stationary_gram_pallas).  The TPU tile formed the distance
// by the norm decomposition |s1|^2 + |s2|^2 - 2 s1.s2 so the cross term could
// ride the matrix unit.  Here the distance is a direct sum of squared
// differences: at d ~ 8 that is a few FMAs per output, it has no
// cancellation, and it needs no 256-multiple shapes.
//
// What bounds it on an H100: at d = 8 the (m, n) output store dominates
// (4 or 8 bytes written per output against ~3d flops plus one exp), so the
// kernel is bound by device-memory bytes; stores are coalesced along n and
// nothing but the output goes back to device memory.  At large d the FMAs
// of the distance sum dominate; the s1/s2 feature chunks staged in shared
// memory give each loaded value 4 reuses per thread.
//
// Design: one block owns a 64 x 64 output tile of one row (blockIdx.z is
// the row: the rows of a hyperparameter batch share one launch); a single
// gram takes an instantiation without the row offsets (BATCHED false):
// they cost 16 registers a thread (48 -> 64), one block fewer a SM and
// ~7% at (4096, 4096, 8) on the H100.  16 x 16
// threads each own 4 x 4 outputs (rows ty + 16 r, columns tx + 16 c).
// Features are staged in chunks of KC, so any d works; ragged m, n and d are masked.  var and
// the RQ alpha are read from device memory (no host sync).  No fast-math:
// exp, sqrt and pow are the IEEE-accurate library versions.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 16;
constexpr int PER = TILE / THREADS;  // outputs per thread along each axis
constexpr int KC = 8;                // feature chunk staged per step

enum Kind { SE = 0, MAT32 = 1, MAT52 = 2, RQ = 3 };

template <typename T, int KIND>
__device__ __forceinline__ T kform(T dm, T alpha) {
  if (KIND == SE) {
    return exp(-dm);
  } else if (KIND == MAT32) {
    const T t = sqrt(fmax(T(3) * dm, T(1e-36)));
    return (T(1) + t) * exp(-t);
  } else if (KIND == MAT52) {
    const T t = sqrt(fmax(T(5) * dm, T(1e-36)));
    return (T(1) + t + T(5) * dm / T(3)) * exp(-t);
  } else {
    return pow(T(1) + dm / alpha, -alpha);
  }
}

template <typename T, int KIND, bool BATCHED>
__global__ void __launch_bounds__(THREADS * THREADS)
stationary_gram_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                       const T* __restrict__ var_ptr,
                       const T* __restrict__ alpha_ptr, T* __restrict__ out,
                       int m, int n, int d) {
  // the row's operands (offsets in size_t: batch * m * n may pass 2^31)
  const size_t row = BATCHED ? blockIdx.z : 0;
  if (BATCHED) {
    s1 += row * m * d;
    s2 += row * n * d;
    out += row * m * n;
  }
  // feature-major staging: the inner loop reads a[k][row] and b[k][col]
  __shared__ T a[KC][TILE];
  __shared__ T b[KC][TILE];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * THREADS + tx;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;

  T acc[PER][PER];
#pragma unroll
  for (int r = 0; r < PER; ++r)
#pragma unroll
    for (int c = 0; c < PER; ++c) acc[r][c] = T(0);

  for (int k0 = 0; k0 < d; k0 += KC) {
    // TILE * KC = 512 values per operand, 256 threads: two each.  Neighbour
    // threads read neighbour features of one row.  Padding (outside m, n or
    // d) stages zeros, which add nothing to the sum.
    for (int idx = tid; idx < TILE * KC; idx += THREADS * THREADS) {
      const int r = idx / KC;
      const int k = idx % KC;
      const int gk = k0 + k;
      const int gi = row0 + r;
      const int gj = col0 + r;
      a[k][r] = (gi < m && gk < d) ? s1[(size_t)gi * d + gk] : T(0);
      b[k][r] = (gj < n && gk < d) ? s2[(size_t)gj * d + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T av[PER], bv[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) av[r] = a[k][ty + THREADS * r];
#pragma unroll
      for (int c = 0; c < PER; ++c) bv[c] = b[k][tx + THREADS * c];
#pragma unroll
      for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int c = 0; c < PER; ++c) {
          const T diff = av[r] - bv[c];
          acc[r][c] = fma(diff, diff, acc[r][c]);
        }
    }
    __syncthreads();
  }

  const T var = var_ptr[row];
  const T alpha = (KIND == RQ) ? alpha_ptr[row] : T(1);
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int gi = row0 + ty + THREADS * r;
    if (gi >= m) continue;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int gj = col0 + tx + THREADS * c;
      if (gj < n) out[(size_t)gi * n + gj] = var * kform<T, KIND>(T(0.5) * acc[r][c], alpha);
    }
  }
}

template <typename T, int KIND>
void launch_kind(const T* s1, const T* s2, const T* var, const T* alpha, T* out,
                 int m, int n, int d, int batch, cudaStream_t stream) {
  const dim3 block(THREADS, THREADS);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  if (batch == 1)
    stationary_gram_kernel<T, KIND, false><<<grid, block, 0, stream>>>(s1, s2, var, alpha, out,
                                                                       m, n, d);
  else
    stationary_gram_kernel<T, KIND, true><<<grid, block, 0, stream>>>(s1, s2, var, alpha, out,
                                                                      m, n, d);
}

template <typename T>
int launch(const T* s1, const T* s2, const T* var, const T* alpha, T* out,
           int m, int n, int d, int batch, int kind, cudaStream_t stream) {
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case SE:
      launch_kind<T, SE>(s1, s2, var, alpha, out, m, n, d, batch, stream);
      break;
    case MAT32:
      launch_kind<T, MAT32>(s1, s2, var, alpha, out, m, n, d, batch, stream);
      break;
    case MAT52:
      launch_kind<T, MAT52>(s1, s2, var, alpha, out, m, n, d, batch, stream);
      break;
    case RQ:
      launch_kind<T, RQ>(s1, s2, var, alpha, out, m, n, d, batch, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: every pointer is a device pointer (s1, s2, out: batch
// consecutive rows; var, alpha: one value a row); the return value is the
// cudaError_t of the launch (0 on success).
extern "C" int stationary_gram_f32(const float* s1, const float* s2,
                                   const float* var, const float* alpha,
                                   float* out, int m, int n, int d, int batch,
                                   int kind, void* stream) {
  return launch<float>(s1, s2, var, alpha, out, m, n, d, batch, kind,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int stationary_gram_f64(const double* s1, const double* s2,
                                   const double* var, const double* alpha,
                                   double* out, int m, int n, int d, int batch,
                                   int kind, void* stream) {
  return launch<double>(s1, s2, var, alpha, out, m, n, d, batch, kind,
                        static_cast<cudaStream_t>(stream));
}
