// Blocked right-looking Cholesky with per-panel inverses, for Hopper (sm_90a):
//
//   A (n x n, SPD, row-major)  ->  L (lower, zero strict upper triangle),
//                                  Dinv[k] = L_kk^{-1} for every B x B panel,
//                                  info (0, or 1 + the first failing column)
//
// Replaces the TPU kernel g3py_tpu/ops/pallas_cholesky.py::_pallas_cholesky
// (body _make_kernel, panel helpers _panel_factorize and _panel_invert).
// The TPU ran its panel loop as a sequential grid inside one kernel and
// kept a 256 x 256 diagonal tile, a row strip and a panel column in VMEM.
// On the H100 a block has 227 KB of shared memory and blocks run in no
// order, so the panel loop moves to the host side of this file and each
// panel k issues four steps on the caller's stream:
//
//   (a) diag_kernel      one block of 32 x 16 threads loads the B x B
//                        diagonal tile into shared memory, factors it in
//                        32-column sub-blocks (warp-level steps, see the
//                        kernel), writes L_kk, inverts it blockwise in
//                        shared memory and writes Dinv[k];
//   (b) the same product pan = A[below, k] * Dinv[k]^T, the panel's rows
//                        below the diagonal tile, into a scratch panel;
//   (c) cudaMemcpy2D     pan back into L's column panel;
//   (d) sgemm_nt_128     A[I, J] -= pan[I] * pan[J]^T over the 128 x 128
//                        tiles of the lower trailing triangle (a SYRK);
//                        nt_tile_kernel, 64 x 64 tiles, for f64 and B = 64.
//
// What bounds it: n^3/3 multiply-adds, against ~n^2 bytes moved at least,
// so at n >= 4096 the card's FP32 rate bounds it (n^3/3 flop at 67 TFLOP/s:
// 0.34 ms at n=4096, 22 ms at n=16384).  The panel width B sets the bytes
// the trailing updates move (~4n^3/(3B) in all) and the length of the
// serial chain of diagonal factorizations (n/B blocks, each 2B dependent
// steps).  B = 128 is chosen: its f32 tile (83 KB with padding and
// staging) and f64 tile (166 KB) fit one block's shared memory, the trailing traffic is
// half that of B = 64, and the serial chain is half as long.  The trailing
// update is a tiled FMA kernel of this file (f32: 128 x 128 tiles, 8 x 8
// outputs a thread, 16-byte shared-memory loads, two stages; f64: 64 x 64,
// 4 x 4; IEEE FP32/FP64 throughout: no tensor cores, no TF32), as the
// TPU kernel ran its products at Precision.HIGHEST.  wgmma with a 3xTF32
// split is a later step.
//
// Failure is reported, never clamped: the TPU clamped every pivot at 1e-30
// and returned finite garbage for a non-PD input.  Here the first column
// whose pivot is <= 0 or not finite is written to *info (1-based, by
// atomicCAS from 0, so the first failure wins); the factor is then garbage
// (NaN), as with cholesky_ex.  Ragged n is padded with identity (prep) and
// L is cut back to n x n (finish); info counts in the caller's columns.
//
// In float with B = 128 the loop looks one panel ahead (run_lookahead):
// panel k+1 is factored on a side stream while the rest of panel k's
// trailing update runs, joined back to the caller's stream by events.
//
// Nothing is allocated here: the caller passes the working matrix w
// (npad x npad; it may alias out when n == npad), two scratch panels pan
// (2 x (npad - B) x B), dinv (npad/B x B x B), out (n x n) and info (one int).
// The input a is only read.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int DT = 32;   // diag_kernel: DT x DTY threads (128 registers each)
constexpr int DTY = 16;
constexpr int W = 32;    // diag_kernel: block width of the inversion (one warp)
constexpr int WF = 16;   // diag_kernel: sub-block width of the factorization
constexpr int GT = 64;   // nt_tile_kernel: output tile GT x GT
constexpr int GK = 32;   // depth chunk staged per step
constexpr int GTH = 16;  // GTH x GTH threads, each PER x PER outputs
constexpr int PER = GT / GTH;

template <typename T>
__global__ void prep_kernel(const T* __restrict__ a, T* __restrict__ w,
                            int* __restrict__ info, int n, int npad) {
  const long long total = (long long)npad * npad;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) *info = 0;
  for (; e < total; e += stride) {
    const int i = (int)(e / npad);
    const int j = (int)(e % npad);
    w[e] = (i < n && j < n) ? a[(size_t)i * n + j] : (i == j ? T(1) : T(0));
  }
}

template <typename T>
__global__ void finish_kernel(const T* w, int ldw, T* out, int n) {
  const long long total = (long long)n * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int i = (int)(e / n);
    const int j = (int)(e % n);
    out[e] = (j <= i) ? w[(size_t)i * ldw + j] : T(0);
  }
}

// 1 / sqrt(d): the float form refines the hardware estimate by one Newton
// step (about 1 ulp, and a shorter dependency chain than sqrt plus a
// division); the double form is CUDA's rsqrt (1 ulp).  NaN for d <= 0.
__device__ __forceinline__ float recip_sqrt(float d) {
  const float y = rsqrtf(d);
  return y * (1.5f - 0.5f * d * y * y);
}
__device__ __forceinline__ double recip_sqrt(double d) { return rsqrt(d); }

// Factor and invert the diagonal tile at (kb, kb) of w (leading dimension
// ld); writes L_kk into w and L_kk^{-1} (zero strict upper) into dinv.
//
// The tile is worked in sub-blocks, so that the serial chain is a few
// warp-level steps per sub-block rather than one block-wide barrier per
// column:
//   factor   per sub-block of WF = 16 columns: one warp factors the
//            WF x WF diagonal block with its rows in registers (shuffles,
//            no barrier; that warp issues in order and its shuffle count
//            grows as WF^2, hence the narrow sub-block); one thread per row
//            solves the rows below against it; all threads apply the
//            rank-WF update to the rest of the tile;
//   invert   in blocks of W = 32: every warp inverts one W x W diagonal
//            block of L (a column per lane, in registers); then block row
//            by block row, X[i, :i] = -X_ii (L[i, :i] X[:i, :i]) by all
//            threads.
// X is kept transposed in the tile's strict upper triangle (free once L is
// written out) and its diagonal, 1 / L[j][j], in rd.  Sums run on two or
// four partial accumulators so that no step waits on one long FMA chain.
template <typename T>
__global__ void __launch_bounds__(DT * DTY, 1)
diag_kernel(T* __restrict__ w, T* __restrict__ dinv, int* __restrict__ info,
            int ld, int kb, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);  // B x S tile
  T* rd = t + B * (B + 1);                // 1 / L[j][j], the diagonal of X
  T* tmp = rd + B;                        // (B - W) x W staging of (L[i, :i] X[:i, :i])^T
  const int S = B + 1;                    // padded row: columns hit distinct banks
  const unsigned FULL = 0xffffffffu;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * DT + tx;
  const int nth = DT * DTY;
  const int warp = tid / 32;
  const int lane = tid % 32;
  T* tile = w + (size_t)kb * ld + kb;

  for (int e = tid; e < B * B; e += nth) {
    const int r = e / B, c = e % B;
    t[r * S + c] = tile[(size_t)r * ld + c];
  }
  __syncthreads();

  for (int jb = 0; jb < B; jb += WF) {
    // (1) warp 0: unblocked Cholesky of the WF x WF diagonal block; lane l
    //     holds row jb + l; rd[j] keeps 1 / L[j][j]
    if (warp == 0) {
      T row[WF];
#pragma unroll
      for (int c = 0; c < WF; ++c) row[c] = lane < WF ? t[(jb + lane) * S + jb + c] : T(0);
#pragma unroll
      for (int j = 0; j < WF; ++j) {
        const T d = __shfl_sync(FULL, row[j], j);
        if (lane == 0 && (!(d > T(0)) || !isfinite(d))) atomicCAS(info, 0, kb + jb + j + 1);
        const T inv = recip_sqrt(d);
        const T s = d * inv;
        if (lane == j) {
          row[j] = s;
          rd[jb + j] = inv;
        } else if (lane > j) {
          row[j] *= inv;
        }
#pragma unroll
        for (int c = j + 1; c < WF; ++c) {
          const T lc = __shfl_sync(FULL, row[j], c);
          if (lane >= c) row[c] -= row[j] * lc;
        }
      }
#pragma unroll
      for (int c = 0; c < WF; ++c)
        if (c <= lane && lane < WF) t[(jb + lane) * S + jb + c] = row[c];
    }
    __syncthreads();
    // (2) one thread per row below: x L_sub^T = a by forward substitution,
    //     the row in registers (L_sub reads are broadcasts)
    {
      const int r = jb + WF + tid;
      if (r < B) {
        T x[WF];
#pragma unroll
        for (int j = 0; j < WF; ++j) {
          T acc0 = t[r * S + jb + j], acc1 = T(0);
#pragma unroll
          for (int m = 0; m + 1 < j; m += 2) {
            acc0 -= x[m] * t[(jb + j) * S + jb + m];
            acc1 -= x[m + 1] * t[(jb + j) * S + jb + m + 1];
          }
          if (j % 2 == 1) acc0 -= x[j - 1] * t[(jb + j) * S + jb + j - 1];
          x[j] = (acc0 + acc1) * rd[jb + j];
        }
#pragma unroll
        for (int j = 0; j < WF; ++j) t[r * S + jb + j] = x[j];
      }
    }
    __syncthreads();
    // (3) rank-WF update of the tile's lower part right of the sub-block
    for (int r = ty; r < B; r += DTY) {
      if (r < jb + WF) continue;
      for (int c = jb + WF + tx; c <= r; c += DT) {
        T acc0 = T(0), acc1 = T(0);
#pragma unroll
        for (int m = 0; m < WF; m += 2) {
          acc0 += t[r * S + jb + m] * t[c * S + jb + m];
          acc1 += t[r * S + jb + m + 1] * t[c * S + jb + m + 1];
        }
        t[r * S + c] -= acc0 + acc1;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < B * B; e += nth) {
    const int r = e / B, c = e % B;
    tile[(size_t)r * ld + c] = t[r * S + c];
  }

  // inverse of each W x W diagonal block: warp b, lane j = column j;
  // x_i = -(sum_{m<i} L[i][m] x_m) / L[i][i] with x_m = 0 for m < j
  if (warp < B / W) {
    const int base = warp * W;
    T x[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      T acc0 = T(0), acc1 = T(0);
#pragma unroll
      for (int m = 0; m + 1 < i; m += 2) {
        acc0 += t[(base + i) * S + base + m] * x[m];
        acc1 += t[(base + i) * S + base + m + 1] * x[m + 1];
      }
      if (i % 2 == 1) acc0 += t[(base + i) * S + base + i - 1] * x[i - 1];
      const T ri = rd[base + i];
      x[i] = (i == lane) ? ri : (i > lane ? -(acc0 + acc1) * ri : T(0));
      if (i > lane) t[(base + lane) * S + base + i] = x[i];  // X[i][lane], transposed
    }
  }
  __syncthreads();

  // off-diagonal blocks, block row by block row: a warp takes four
  // columns c0..c0+3 at a time, lane r takes row ib + r (no divergence, no
  // bank conflicts; each L element loaded feeds four sums)
  for (int ib = W; ib < B; ib += W) {
    // tmp[c][r] = sum_{k=c}^{ib-1} L[ib + r][k] X[k][c]
    const T* lrow = t + (ib + lane) * S;
    for (int c0 = 4 * warp; c0 < ib; c0 += 4 * (nth / 32)) {
      T acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] = lrow[c0 + q] * rd[c0 + q];
#pragma unroll
        for (int k = q + 1; k < 4; ++k) acc[q] += lrow[c0 + k] * t[(c0 + q) * S + c0 + k];
      }
      for (int k = c0 + 4; k < ib; ++k) {
        const T l = lrow[k];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += l * t[(c0 + q) * S + k];  // X[k][c0 + q]
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) tmp[(c0 + q) * W + lane] = acc[q];
    }
    __syncthreads();
    // X[ib + r][c] = -sum_{m<=r} X[ib + r][ib + m] tmp[c][m]
    for (int c0 = 4 * warp; c0 < ib; c0 += 4 * (nth / 32)) {
      T acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = rd[ib + lane] * tmp[(c0 + q) * W + lane];
#pragma unroll
      for (int m = 0; m < W; ++m) {
        const T xm = (m < lane) ? t[(ib + m) * S + ib + lane] : T(0);  // X[ib + r][ib + m]
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += xm * tmp[(c0 + q) * W + m];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) t[(c0 + q) * S + ib + lane] = -acc[q];
    }
    __syncthreads();
  }

  for (int e = tid; e < B * B; e += nth) {
    const int r = e / B, c = e % B;
    dinv[e] = (c < r) ? t[c * S + r] : (c == r ? rd[r] : T(0));
  }
}

// The output tile (bi, bj) of this block: with tri, blockIdx.x enumerates
// the tiles bj <= bi of a lower triangle; otherwise blockIdx = (bj, bi).
__device__ __forceinline__ void tile_of_block(int tri, int* bi, int* bj) {
  if (tri) {
    const int b = blockIdx.x;
    int i = (int)((sqrt(8.0 * b + 1.0) - 1.0) * 0.5);
    while ((i + 1) * (i + 2) / 2 <= b) ++i;
    while (i * (i + 1) / 2 > b) --i;
    *bi = i;
    *bj = b - i * (i + 1) / 2;
  } else {
    *bi = blockIdx.y;
    *bj = blockIdx.x;
  }
}

// C[GT x GT tile] (=, or -= when SUB) X_rows * Y_rows^T over depth K, all
// row-major; each thread owns 4 x 4 outputs in registers, the depth is
// staged GK at a time in shared memory.  The generic form (any T, B = 64);
// float with B = 128 takes sgemm_nt_128 below.
template <typename T, bool SUB>
__global__ void __launch_bounds__(GTH * GTH)
nt_tile_kernel(const T* __restrict__ x, int ldx, const T* __restrict__ y, int ldy,
               T* c, int ldc, int K, int tri) {
  __shared__ T xs[GK][GT + 1];
  __shared__ T ys[GK][GT + 1];
  int bi, bj;
  tile_of_block(tri, &bi, &bj);
  const int tid = threadIdx.x;
  const int tx = tid % GTH;
  const int ty = tid / GTH;
  const T* xb = x + (size_t)bi * GT * ldx;
  const T* yb = y + (size_t)bj * GT * ldy;

  T acc[PER][PER];
#pragma unroll
  for (int r = 0; r < PER; ++r)
#pragma unroll
    for (int q = 0; q < PER; ++q) acc[r][q] = T(0);

  for (int k0 = 0; k0 < K; k0 += GK) {
    // neighbour threads read neighbour k of one row (coalesced)
#pragma unroll
    for (int p = 0; p < GT * GK / (GTH * GTH); ++p) {
      const int idx = tid + GTH * GTH * p;
      const int r = idx / GK;
      const int kk = idx % GK;
      xs[kk][r] = xb[(size_t)r * ldx + k0 + kk];
      ys[kk][r] = yb[(size_t)r * ldy + k0 + kk];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < GK; ++kk) {
      T av[PER], bv[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) av[r] = xs[kk][ty + GTH * r];
#pragma unroll
      for (int q = 0; q < PER; ++q) bv[q] = ys[kk][tx + GTH * q];
#pragma unroll
      for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int q = 0; q < PER; ++q) acc[r][q] = fma(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < PER; ++r) {
    T* crow = c + (size_t)(bi * GT + ty + GTH * r) * ldc + bj * GT;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tx + GTH * q;
      crow[j] = SUB ? crow[j] - acc[r][q] : acc[r][q];
    }
  }
}

// The float form of nt_tile_kernel at B = 128: a 128 x 128 output tile,
// 256 threads each owning 8 x 8 outputs (rows ty*4 + {0..3, 64..67}, columns
// tx*4 + {0..3, 64..67}), the depth staged 8 at a time, k-major in shared
// memory, in two stages: the next chunk's 16-byte global loads are in
// flight while the current one is multiplied.  Every operand read from
// shared memory is a 16-byte load, four of them per 64 FMAs.  Requires
// 16-byte aligned rows (ld % 4 == 0) and K % 8 == 0.
constexpr int FT = 128;
constexpr int FK = 8;
constexpr int FS = FT + 4;  // padded k-row: the transposing stores hit distinct banks

template <bool SUB>
__global__ void __launch_bounds__(256, 2)
sgemm_nt_128(const float* __restrict__ x, int ldx, const float* __restrict__ y, int ldy,
             float* c, int ldc, int K, int tri) {
  __shared__ __align__(16) float xs[2][FK][FS];
  __shared__ __align__(16) float ys[2][FK][FS];
  int bi, bj;
  tile_of_block(tri, &bi, &bj);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // global -> shared: thread tid moves one float4 of each operand per chunk
  const int lrow = tid / 2;
  const int lk = (tid % 2) * 4;
  const float* xg = x + (size_t)(bi * FT + lrow) * ldx + lk;
  const float* yg = y + (size_t)(bj * FT + lrow) * ldy + lk;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  float4 xv = *reinterpret_cast<const float4*>(xg);
  float4 yv = *reinterpret_cast<const float4*>(yg);
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += FK) {
    xs[stage][lk + 0][lrow] = xv.x;
    xs[stage][lk + 1][lrow] = xv.y;
    xs[stage][lk + 2][lrow] = xv.z;
    xs[stage][lk + 3][lrow] = xv.w;
    ys[stage][lk + 0][lrow] = yv.x;
    ys[stage][lk + 1][lrow] = yv.y;
    ys[stage][lk + 2][lrow] = yv.z;
    ys[stage][lk + 3][lrow] = yv.w;
    __syncthreads();
    if (k0 + FK < K) {  // the next chunk's loads overlap this chunk's FMAs
      xv = *reinterpret_cast<const float4*>(xg + k0 + FK);
      yv = *reinterpret_cast<const float4*>(yg + k0 + FK);
    }
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[stage][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[stage][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[stage][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ys[stage][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    stage ^= 1;  // the other stage is free: its readers passed this sync
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = bi * FT + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
    float* crow = c + (size_t)row * ldc + bj * FT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* dst = reinterpret_cast<float4*>(crow + h * 64 + tx * 4);
      float4 v = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                             acc[r][4 * h + 3]);
      if (SUB) {
        const float4 old = *dst;
        v = make_float4(old.x - v.x, old.y - v.y, old.z - v.z, old.w - v.w);
      }
      *dst = v;
    }
  }
}

// Steps (b) and (c) of panel k: pan = A[below, k] Dinv_k^T, copied back
// into L's column panel.
template <typename T>
cudaError_t panel_product(T* w, const T* dk, T* pan, int npad, int kb, int B, int R,
                          cudaStream_t st) {
  T* below = w + (size_t)(kb + B) * npad + kb;
  if (sizeof(T) == 4 && B == FT)
    sgemm_nt_128<false><<<dim3(1, R / FT), 256, 0, st>>>(
        (const float*)below, npad, (const float*)dk, B, (float*)pan, B, B, 0);
  else
    nt_tile_kernel<T, false><<<dim3(B / GT, R / GT), GTH * GTH, 0, st>>>(
        below, npad, dk, B, pan, B, B, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaMemcpy2DAsync(below, (size_t)npad * sizeof(T), pan, (size_t)B * sizeof(T),
                           (size_t)B * sizeof(T), R, cudaMemcpyDeviceToDevice, st);
}

// Step (d) of panel k, on the generic tiles: the whole lower trailing
// triangle below and right of the diagonal tile.
template <typename T>
cudaError_t trailing_update(T* w, const T* pan, int npad, int kb, int B, int R,
                            cudaStream_t st) {
  const long long t = R / GT;
  nt_tile_kernel<T, true><<<(unsigned)(t * (t + 1) / 2), GTH * GTH, 0, st>>>(
      pan, B, pan, B, w + (size_t)(kb + B) * npad + kb + B, npad, B, 1);
  return cudaGetLastError();
}

// The side stream of the lookahead, one per device, made at first use with
// the device's highest stream priority.
cudaStream_t side_stream() {
  static std::mutex lock;
  static cudaStream_t streams[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return nullptr;
  std::lock_guard<std::mutex> guard(lock);
  if (streams[dev] == nullptr) {
    // the highest priority: the block scheduler hands the side stream's
    // single diagonal-tile block the first SM that frees up inside the
    // caller's trailing update, instead of after its last block
    int least = 0, greatest = 0;
    if (cudaDeviceGetStreamPriorityRange(&least, &greatest) != cudaSuccess ||
        cudaStreamCreateWithPriority(&streams[dev], cudaStreamNonBlocking, greatest) !=
            cudaSuccess)
      return nullptr;
  }
  return streams[dev];
}

// float, B = 128: the panel loop with a lookahead of one panel.  The
// trailing update of panel k is split into its first tile column T1 (which
// is panel k+1's column) and the rest T2; once T1 is done, the side stream
// factors panel k+1 and forms its panel product while the caller's stream
// runs T2, so the serial chain of diagonal factorizations hides behind the
// trailing products.  The two scratch panels alternate.
cudaError_t run_lookahead(float* w, float* dinv, float* pan, int* info, int npad, int B,
                          int smem, cudaStream_t st) {
  cudaStream_t side = side_stream();
  if (side == nullptr) return cudaErrorInvalidResourceHandle;
  cudaEvent_t t1_done, side_done;
  cudaError_t e = cudaEventCreateWithFlags(&t1_done, cudaEventDisableTiming);
  if (e != cudaSuccess) return e;
  e = cudaEventCreateWithFlags(&side_done, cudaEventDisableTiming);
  if (e != cudaSuccess) {
    cudaEventDestroy(t1_done);
    return e;
  }
  const int nb = npad / B;
  const size_t pan_size = (size_t)(npad - B) * B;
  diag_kernel<float><<<1, dim3(DT, DTY), smem, st>>>(w, dinv, info, npad, 0, B);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = panel_product<float>(w, dinv, pan, npad, 0, B, npad - B, st);
  for (int k = 0; e == cudaSuccess && k + 1 < nb; ++k) {
    const int kb = k * B;
    const int t = (npad - kb - B) / FT;  // tile rows of the trailing matrix
    const float* pk = pan + (k % 2) * pan_size;
    float* trail = w + (size_t)(kb + B) * npad + kb + B;
    sgemm_nt_128<true><<<dim3(1, t), 256, 0, st>>>(pk, B, pk, B, trail, npad, B, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) break;
    if ((e = cudaEventRecord(t1_done, st)) != cudaSuccess) break;
    if ((e = cudaStreamWaitEvent(side, t1_done, 0)) != cudaSuccess) break;
    const int kn = kb + B;
    float* dn = dinv + (size_t)(k + 1) * B * B;
    diag_kernel<float><<<1, dim3(DT, DTY), smem, side>>>(w, dn, info, npad, kn, B);
    if ((e = cudaGetLastError()) != cudaSuccess) break;
    if (npad - kn - B > 0) {
      e = panel_product<float>(w, dn, pan + ((k + 1) % 2) * pan_size, npad, kn, B,
                               npad - kn - B, side);
      if (e != cudaSuccess) break;
    }
    if ((e = cudaEventRecord(side_done, side)) != cudaSuccess) break;
    if (t > 1) {
      sgemm_nt_128<true><<<(unsigned)((t - 1) * t / 2), 256, 0, st>>>(
          pk + (size_t)FT * B, B, pk + (size_t)FT * B, B, trail + (size_t)FT * npad + FT,
          npad, B, 1);
      if ((e = cudaGetLastError()) != cudaSuccess) break;
    }
    e = cudaStreamWaitEvent(st, side_done, 0);
  }
  cudaEventDestroy(t1_done);
  cudaEventDestroy(side_done);
  return e;
}

int grid_for(long long total) {
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int run(const T* a, T* w, T* out, T* pan, T* dinv, int* info, int n, int npad,
        int B, cudaStream_t st) {
  if (B <= 0 || B % GT != 0 || B > 128 || npad % B != 0 || n > npad || n < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (B * (B + 1) + B + W * B) * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(diag_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;

  prep_kernel<T><<<grid_for((long long)npad * npad), 256, 0, st>>>(a, w, info, n, npad);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if constexpr (sizeof(T) == 4) {
    if (B == FT && npad > B) {
      e = run_lookahead(w, dinv, pan, info, npad, B, smem, st);
      if (e != cudaSuccess) return (int)e;
      finish_kernel<T><<<grid_for((long long)n * n), 256, 0, st>>>(w, npad, out, n);
      return (int)cudaGetLastError();
    }
  }
  const int nb = npad / B;
  for (int k = 0; k < nb; ++k) {
    const int kb = k * B;
    const int R = npad - kb - B;  // rows below the diagonal tile
    T* dk = dinv + (size_t)k * B * B;
    diag_kernel<T><<<1, dim3(DT, DTY), smem, st>>>(w, dk, info, npad, kb, B);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (R == 0) break;
    if ((e = panel_product<T>(w, dk, pan, npad, kb, B, R, st)) != cudaSuccess) return (int)e;
    if ((e = trailing_update<T>(w, pan, npad, kb, B, R, st)) != cudaSuccess) return (int)e;
  }

  finish_kernel<T><<<grid_for((long long)n * n), 256, 0, st>>>(w, npad, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: every pointer is a device pointer; the return value is
// the cudaError_t of the launches (0 on success).
extern "C" int panel_cholesky_f32(const float* a, float* w, float* out, float* pan,
                                  float* dinv, int* info, int n, int npad, int block,
                                  void* stream) {
  return run<float>(a, w, out, pan, dinv, info, n, npad, block,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int panel_cholesky_f64(const double* a, double* w, double* out, double* pan,
                                  double* dinv, int* info, int n, int npad, int block,
                                  void* stream) {
  return run<double>(a, w, out, pan, dinv, info, n, npad, block,
                     static_cast<cudaStream_t>(stream));
}
