// Blocked right-looking Cholesky with per-panel inverses, for Hopper (sm_90a):
//
//   A (n x n, SPD, row-major)  ->  L (lower, zero strict upper triangle),
//                                  Dinv[k] = L_kk^{-1} for every B x B panel,
//                                  info (0, or 1 + the first failing column)
//
// over a batch of `batch` independent matrices (the hyperparameter rows of
// a sampler step or of an averaged predictor).  Every kernel of the panel
// loop takes the batch in its grid (blockIdx.x of diag_kernel, blockIdx.y
// of the FP32 products, blockIdx.z of nt_tile_kernel, blockIdx.y of
// the elementwise kernels), so the R matrices share one launch sequence,
// one side stream and one pair of events a panel: the serial chain of
// diagonal tiles runs R blocks at a time instead of one.  Row offsets are
// size_t (batch * npad^2 passes 2^31 at n = 16384, batch >= 8).
//
// Replaces the TPU kernel g3py_tpu/ops/pallas_cholesky.py::_pallas_cholesky
// (body _make_kernel, panel helpers _panel_factorize and _panel_invert).
// The TPU ran its panel loop as a sequential grid inside one kernel and
// kept a 256 x 256 diagonal tile, a row strip and a panel column in VMEM.
// On the H100 a block has 227 KB of shared memory and blocks run in no
// order, so the panel loop moves to the host side of this file.  Per panel k:
//
//   (a) diag_kernel      one block of 512 threads factors and inverts the
//                        B x B diagonal tile in shared memory (a blocked
//                        factor-and-invert over 16-column leaves, see the
//                        kernel), writes L_kk and Dinv[k];
//   (b) the panel product L[below, k] = A[below, k] * Dinv[k]^T;
//   (c) the trailing update A[I, J] -= L[I, k] * L[J, k]^T over the lower
//                        trailing triangle (a SYRK).
//
// What bounds it: n^3/3 multiply-adds, against ~n^2 bytes moved at least,
// so at n >= 4096 the card's FP32 rate bounds it (n^3/3 flop at 67 TFLOP/s:
// 0.34 ms at n=4096, 22 ms at n=16384).  The panel width B sets the bytes
// the trailing updates move (~4n^3/(3B) in all) and the length of the
// serial chain of diagonal tiles (n/B of them).  B = 128 is chosen: its f32
// tile (84 KiB with staging) and f64 tile (167 KiB) fit one block's shared
// memory, the trailing traffic is half that of B = 64, and the serial chain
// is half as long.  The products are
// FMA kernels of this file (IEEE FP32/FP64 throughout: no tensor cores, no
// TF32), as the TPU kernel ran its products at Precision.HIGHEST.  wgmma
// with a 3xTF32 split is a later step.
//
// In float with B = 128 (run_lookahead) the chain of diagonal tiles is what
// bounds n = 4096, so it is kept short and on one highest-priority side
// stream: panel k's update of panel k+1's column only (T1), panel k+1's
// diagonal tile, its product formed in place (T1 and the product in 16-row
// blocks that all run at once), while the caller's stream runs the rest of
// panel k's trailing update (T2).  Other cases (f64, B = 64) run the panel
// loop in order on the caller's stream, with the product into a scratch
// panel copied back into L.
//
// Failure is reported, never clamped: the TPU clamped every pivot at 1e-30
// and returned finite garbage for a non-PD input.  Here the first column
// whose pivot is <= 0 or not finite is written to *info (1-based, by
// atomicCAS from 0, so the first failure wins); the factor is then garbage
// (NaN), as with cholesky_ex.  Only the lower triangle of A is read.  Ragged
// n is padded with identity (prep) and L is copied back to n x n (finish);
// info counts in the caller's columns.
//
// Nothing is allocated here: the caller passes, for each matrix of the
// batch, the working matrix w (npad x npad; it may alias out when n ==
// npad), a scratch panel pan ((npad - B) x B; the in-order loop uses it),
// dinv (npad/B x B x B), out (n x n) and info (one int).  The input a is
// only read.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int DTH = 512;  // diag_kernel: threads (16 warps)
constexpr int LW = 16;    // diag_kernel: leaf width (one warp factors and inverts a leaf)
constexpr int GT = 64;    // nt_tile_kernel: output tile GT x GT
constexpr int GK = 32;    // depth chunk staged per step
constexpr int GTH = 16;   // GTH x GTH threads, each PER x PER outputs
constexpr int PER = GT / GTH;

// w = the lower triangle of a, identity-padded to npad, zero above the
// diagonal.  Later steps write above the diagonal only inside diagonal
// tiles, which the diagonal kernel then zeroes, so L needs no masking.
// blockIdx.y is the matrix of the batch (info[r] = 0 for each); the blocks
// stride over its rows and the threads over a row's columns, so no index
// is divided.  The two elementwise kernels below are laid out the same way.
template <typename T>
__global__ void prep_kernel(const T* __restrict__ a, T* __restrict__ w,
                            int* __restrict__ info, int n, int npad) {
  const size_t r = blockIdx.y;
  a += r * n * n;
  w += r * npad * npad;
  if (blockIdx.x == 0 && threadIdx.x == 0) info[r] = 0;
  for (int i = blockIdx.x; i < npad; i += gridDim.x) {
    const T* ai = a + (size_t)i * n;
    T* wi = w + (size_t)i * npad;
    for (int j = threadIdx.x; j < npad; j += blockDim.x)
      wi[j] = (j <= i && i < n) ? ai[j] : (i == j ? T(1) : T(0));
  }
}

// out[r] (n x n) = the leading n x n block of w[r] (npad x npad).
template <typename T>
__global__ void finish_kernel(const T* w, int npad, T* out, int n) {
  const size_t r = blockIdx.y;
  w += r * npad * npad;
  out += r * n * n;
  for (int i = blockIdx.x; i < n; i += gridDim.x)
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      out[(size_t)i * n + j] = w[(size_t)i * npad + j];
}

// The in-order loop's copy of the scratch panel back into L: rows x B
// values of each matrix, pan[r] (ld B, stride ps) -> dst + r * ds (ld ldd).
template <typename T>
__global__ void copy_panel_kernel(const T* __restrict__ pan, size_t ps, T* dst, int ldd,
                                  size_t ds, int rows, int B) {
  const size_t r = blockIdx.y;
  pan += r * ps;
  dst += r * ds;
  for (int i = blockIdx.x; i < rows; i += gridDim.x)
    for (int j = threadIdx.x; j < B; j += blockDim.x)
      dst[(size_t)i * ldd + j] = pan[(size_t)i * B + j];
}

// 1 / sqrt(d): the float form refines the hardware estimate by one Newton
// step (about 1 ulp, and a shorter dependency chain than sqrt plus a
// division); the double form is CUDA's rsqrt (1 ulp).  NaN for d <= 0.
__device__ __forceinline__ float recip_sqrt(float d) {
  const float y = rsqrtf(d);
  return y * (1.5f - 0.5f * d * y * y);
}
__device__ __forceinline__ double recip_sqrt(double d) { return rsqrt(d); }

// Phase clocks of diag_kernel, for measurement only (g3py_tpu_torch/tools/
// k2_chain.py compiles a copy with -DK2_PHASE_CLOCKS): K2_TICK(s) adds
// thread 0's clock64() cycles since its previous tick to slot s, K2_TICK_AT
// (s, t) thread t's (slots 12 and 13 only restart a thread's clock); the
// last two slots count the blocks and their globaltimer ns.
#ifdef K2_PHASE_CLOCKS
constexpr int K2_SLOTS = 16;
__device__ unsigned long long k2_phase_cycles[K2_SLOTS];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K2_TICK_START                 \
  long long k2_clk = clock64();       \
  const unsigned long long k2_ns0 = global_ns();
#define K2_TICK_AT(s, t)                                                \
  if (threadIdx.x == (t)) {                                             \
    const long long now = clock64();                                    \
    atomicAdd(&k2_phase_cycles[s], (unsigned long long)(now - k2_clk)); \
    k2_clk = now;                                                       \
  }
#define K2_TICK(s) K2_TICK_AT(s, 0)
#define K2_TICK_END                                                  \
  if (threadIdx.x == 0) {                                            \
    atomicAdd(&k2_phase_cycles[K2_SLOTS - 2], 1ull);                 \
    atomicAdd(&k2_phase_cycles[K2_SLOTS - 1], global_ns() - k2_ns0); \
  }
#else
#define K2_TICK_START
#define K2_TICK_AT(s, t)
#define K2_TICK(s)
#define K2_TICK_END
#endif

// (bi, bj) with bj <= bi of the b-th tile of a lower triangle, row by row.
__device__ __forceinline__ void tri_index(int b, int* bi, int* bj) {
  int i = (int)((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= b) ++i;
  while (i * (i + 1) / 2 > b) --i;
  *bi = i;
  *bj = b - i * (i + 1) / 2;
}

// Four consecutive values from 16-byte aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 u = *reinterpret_cast<const double2*>(p);
  const double2 v = *reinterpret_cast<const double2*>(p + 2);
  o[0] = u.x, o[1] = u.y, o[2] = v.x, o[3] = v.y;
}

// acc[x][y] += sum_m a[m][x] b[m][y] over `depth` k-major rows of stride qs.
template <typename T>
__device__ __forceinline__ void tile44(const T* a, const T* b, int qs, int depth,
                                       T (&acc)[4][4]) {
#pragma unroll 4
  for (int m = 0; m < depth; ++m) {
    T av[4], bv[4];
    load4(a + m * qs, av);
    load4(b + m * qs, bv);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = fma(av[x], bv[y], acc[x][y]);
  }
}

// v[idx] for a lane-dependent idx, without a local-memory array.
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[LW], int idx) {
  T r = v[0];
#pragma unroll
  for (int c = 1; c < LW; ++c)
    if (c == idx) r = v[c];
  return r;
}

// Four consecutive values to 16-byte aligned memory.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
  *reinterpret_cast<double2*>(p + 2) = make_double2(c, d);
}

// The leaf: one warp factors a LW x LW block and inverts its factor, in
// registers.  On entry lane l < LW holds row l of the block (v[c], c <= l
// read).  On exit lane l < LW holds row l of L (v[c], c <= l) and mine =
// 1 / L[l][l]; lane LW + c holds column c of X = L^{-1} (v[m] = X[m][c]).
// Both halves run the same right-looking step j: scale entry j (L[l][j] =
// A[l][j] / L[j][j] on the rows' lanes; X[j][c] = (delta_jc + v[j]) /
// L[j][j] on the inverse's, v[j] holding -sum_{k<j} L[j][k] X[k][c]), then
// v[c] -= v[j] L[c][j] for c > j, with column j of L published once to
// shared memory (lf) and read back as 16-byte broadcasts, so the inverse
// costs no work of its own beyond its half of the warp.  Two short
// dependent chains set the pace: the pivot (one shuffle of each lane's own
// running diagonal dg, rsqrt, one scale, one FMA) and the next column's
// entry (one shuffle, one FMA).  The update also runs, harmlessly, on
// entries above the diagonal, which are never read.  col0 is the caller's
// column of the leaf's first; the first non-positive or non-finite pivot
// goes to info.
template <typename T>
__device__ __forceinline__ void leaf_factor_invert(T (&v)[LW], T& mine, int lane, int* info,
                                                   int col0, T* lf) {
  const unsigned FULL = 0xffffffffu;
  const bool row = lane < LW;
  T dg = pick(v, lane), piv = T(1);
  if (!row) {
#pragma unroll
    for (int m = 0; m < LW; ++m) v[m] = T(0);
  }
#pragma unroll
  for (int j = 0; j < LW; ++j) {
    const T d = __shfl_sync(FULL, dg, j);
    const T inv = recip_sqrt(d);
    v[j] = row ? (lane == j ? d : v[j]) * inv : (lane == LW + j ? v[j] + T(1) : v[j]) * inv;
    dg = fma(-v[j], v[j], dg);
    if (lane == j) {
      mine = inv;
      piv = d;
    }
    if (j + 1 < LW) {  // v[j + 1] -= v[j] L[j + 1][j], on the chain
      const T next = __shfl_sync(FULL, v[j], j + 1);
      v[j + 1] = fma(-v[j], next, v[j + 1]);
    }
    if (row) lf[j * LW + lane] = v[j];
    __syncwarp();
#pragma unroll
    for (int c4 = (j + 2) / 4; c4 < LW / 4; ++c4) {
      T col[4];
      load4(lf + j * LW + 4 * c4, col);
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (4 * c4 + y > j + 1) v[4 * c4 + y] = fma(-v[j], col[y], v[4 * c4 + y]);
    }
  }
  const unsigned bad = __ballot_sync(FULL, row && !(piv > T(0) && isfinite(piv)));
  if (lane == 0 && bad != 0u) atomicCAS(info, 0, col0 + __ffs(bad));
}

// Writes a leaf at (j0, j0) of the tile: L on and below the diagonal, X
// transposed above it (X[m][c] at t[c][m]), 1 / L[j][j] into rd, and X
// whole (row-major, zero above the diagonal) into xl for the next phase B.
template <typename T, int S>
__device__ __forceinline__ void leaf_store(T* t, T* rd, T* xl, int j0, const T (&v)[LW],
                                           T mine, int lane) {
  if (lane < LW) {
#pragma unroll
    for (int c = 0; c < LW; ++c)
      if (c <= lane) t[(j0 + lane) * S + j0 + c] = v[c];
    rd[j0 + lane] = mine;
  } else {
    const int c = lane - LW;
#pragma unroll
    for (int m = 0; m < LW; ++m) {
      if (m > c) t[(j0 + c) * S + j0 + m] = v[m];
      xl[m * LW + c] = v[m];
    }
  }
}

// Factor and invert the diagonal tile at (kb, kb) of w (leading dimension
// ld); writes L_kk into w (zero above the diagonal) and L_kk^{-1} (zero
// strict upper) into dinv.  Block b works on matrix b of the batch: w + b
// ws, dinv + b ds, info + b.
//
// A right-looking loop over leaves of LW = 16 columns, in which every step
// keeps the warps busy and the inverse X = L_kk^{-1} is built alongside the
// factor, right-looking too.  At step i (leaf i at jb = 16 i, R rows below):
//   B  all warps: the leaf's panel L[below, i] = A[below, i] X_ii^T (into
//      pnl, k-major), and X's block row i, X[i, :i] = -X_ii Z[i, :i]
//      (into xb, k-major, and into the tile above the diagonal).  Four
//      threads a row; X_ii's rows are 16-byte broadcasts from xl.
//   C  warp 0: the next leaf's own update from pnl, then its factor and
//      inverse in registers (leaf_factor_invert).  12 other warps: the
//      rank-16 update of the rest of the trailing triangle (4 x 4 register
//      tiles), and Z[below, :i+1] += L[below, i] X[i, :i+1] (a row and 4
//      columns a thread), both from pnl and xb.  The 3 warps that share
//      warp 0's scheduler (4, 8, 12) stream L's panel, the zeros right of
//      leaf i and Dinv's rows of leaf i out: stores, which take few of the
//      scheduler's slots from the leaf, the longest serial step.
// Two barriers a step.  Z = L[below, :] X[:, :], whose rows are the next
// leaves' sums for X, takes the place of L's finished columns below the
// diagonal (which have gone to w); the tile keeps L's diagonal leaves, X
// transposed above the diagonal, and X's diagonal in rd.
template <typename T, int B>
__global__ void __launch_bounds__(DTH, 1)
diag_kernel(T* __restrict__ w, T* __restrict__ dinv, int* __restrict__ info, int ld, int kb,
            size_t ws, size_t ds) {
  w += blockIdx.x * ws;
  dinv += blockIdx.x * ds;
  info += blockIdx.x;
  constexpr int S = B + 1;   // tile row: odd, so a column's entries hit distinct banks
  constexpr int QS = B + 4;  // k-major row: 16-byte aligned for the 4-wide loads
  constexpr int NL = B / LW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);  // B x S
  T* rd = t + B * S;                      // B: 1 / L[j][j], the diagonal of X
  T* pnl = rd + B;                        // LW x QS: L[:, leaf i], k-major
  T* xb = pnl + LW * QS;                  // LW x QS: X[leaf i, :], k-major
  T* xl = xb + LW * QS;                   // LW x LW: X_ii
  T* lf = xl + LW * LW;                   // LW x LW: the leaf's columns of L
  const unsigned FULL = 0xffffffffu;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  T* tile = w + (size_t)kb * ld + kb;
  K2_TICK_START

  {
    T buf[B * B / DTH];  // every load in flight before the first store
#pragma unroll
    for (int p = 0; p < B * B / DTH; ++p) {
      const int e = tid + p * DTH;
      buf[p] = tile[(size_t)(e / B) * ld + e % B];
    }
#pragma unroll
    for (int p = 0; p < B * B / DTH; ++p) {
      const int e = tid + p * DTH;
      t[(e / B) * S + e % B] = buf[p];
    }
  }
  __syncthreads();
  K2_TICK(0)

  if (warp == 0) {
    T v[LW];
    T mine = T(0);
#pragma unroll
    for (int c = 0; c < LW; ++c) v[c] = lane < LW ? t[lane * S + c] : T(0);
    leaf_factor_invert(v, mine, lane, info, kb, lf);
    leaf_store<T, S>(t, rd, xl, 0, v, mine, lane);
  }
  __syncthreads();
  K2_TICK(1)

#pragma unroll 1
  for (int i = 0; i < NL; ++i) {
    const int jb = i * LW;
    const int R = B - jb - LW;
    // phase B: thread (u, g), g the same across a quarter-warp, forms a = g,
    // g + 4, g + 8, g + 12 of row u < R of the panel, L[jb + LW + u][jb + a]
    // = sum_m A[jb + LW + u][jb + m] X[a][m], or of column c = u - R < jb of
    // X's block row, X[jb + a][c] = -sum_m X[a][m] Z[jb + m][c]; the next 64
    // threads copy X_ii into xb.  Nothing read here is written here.
    {
      const int g = (tid / 8) % 4;
      const int u = (tid / 32) * 8 + tid % 8;
      const bool panel = u < R;
      if (u < R + jb) {
        const int r = panel ? jb + LW + u : u - R;
        T in[LW];
#pragma unroll
        for (int m = 0; m < LW; ++m) in[m] = panel ? t[r * S + jb + m] : t[(jb + m) * S + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int a = g + 4 * q;
          T acc = T(0);
#pragma unroll
          for (int m4 = 0; m4 < LW / 4; ++m4) {
            T x4[4];
            load4(xl + a * LW + 4 * m4, x4);
#pragma unroll
            for (int y = 0; y < 4; ++y) acc = fma(in[4 * m4 + y], x4[y], acc);
          }
          if (panel) {
            pnl[a * QS + r] = acc;
          } else {
            t[r * S + jb + a] = -acc;
            xb[a * QS + r] = -acc;
          }
        }
      } else if (u < B) {
        const int a = u - (R + jb);
#pragma unroll
        for (int q = 0; q < 4; ++q) xb[a * QS + jb + g + 4 * q] = xl[a * LW + g + 4 * q];
      }
    }
    __syncthreads();
    K2_TICK(2)
    if (R == 0) break;

    const int j0 = jb + LW;  // the next leaf
    if (warp == 0) {
      // its rows' rank-16 update, the depth split over the two half-warps
      const int l = lane % LW, h = lane / LW;
      T v[LW];
#pragma unroll
      for (int c = 0; c < LW; ++c) v[c] = T(0);
#pragma unroll
      for (int mm = 0; mm < LW / 2; ++mm) {
        const int m = h * (LW / 2) + mm;
        const T a = pnl[m * QS + j0 + l];
#pragma unroll
        for (int c4 = 0; c4 < LW / 4; ++c4) {
          T bq[4];
          load4(pnl + m * QS + j0 + 4 * c4, bq);
#pragma unroll
          for (int y = 0; y < 4; ++y) v[4 * c4 + y] = fma(a, bq[y], v[4 * c4 + y]);
        }
      }
#pragma unroll
      for (int c = 0; c < LW; ++c) {
        v[c] += __shfl_xor_sync(FULL, v[c], LW);
        v[c] = t[(j0 + l) * S + j0 + c] - v[c];
      }
      K2_TICK(5)
      T mine = T(0);
      leaf_factor_invert(v, mine, lane, info, kb + j0, lf);
      K2_TICK(6)
      leaf_store<T, S>(t, rd, xl, j0, v, mine, lane);
      K2_TICK(7)
    } else if (warp % 4 != 0) {
      const int nt = R / 4;
      const int n1 = nt * (nt + 1) / 2 - 10;  // 4 x 4 tiles, less the next leaf's 10
      const int ct = (warp - warp / 4 - 1) * 32 + lane;
      K2_TICK_AT(13, 32)
      for (int it = ct; it < n1 + R * (j0 / 4); it += 12 * 32) {
        if (it < n1) {
          int bi, bj;
          tri_index(it + 10, &bi, &bj);
          const int r0 = j0 + 4 * bi, c0 = j0 + 4 * bj;
          T acc[4][4] = {};
          tile44(pnl + r0, pnl + c0, QS, LW, acc);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) t[(r0 + x) * S + c0 + y] -= acc[x][y];
        } else {  // Z[r][c0 + y] (+)= sum_m L[r][jb + m] X[jb + m][c0 + y]
          const int r = j0 + (it - n1) % R;
          const int c0 = 4 * ((it - n1) / R);
          T acc[4] = {};
#pragma unroll
          for (int m = 0; m < LW; ++m) {
            const T a = pnl[m * QS + r];
            T x4[4];
            load4(xb + m * QS + c0, x4);
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[y] = fma(a, x4[y], acc[y]);
          }
          T* z = t + r * S + c0;
#pragma unroll
          for (int y = 0; y < 4; ++y) z[y] = c0 < jb ? z[y] + acc[y] : acc[y];
        }
      }
      K2_TICK_AT(8, 32)
    } else {
      // warps 4, 8, 12: out to w and dinv, L's panel below leaf i, and on
      // the rows of leaf i the zeros right of it and Dinv (X's block row,
      // from xb)
      const int st = (warp / 4 - 1) * 32 + lane;
      K2_TICK_AT(12, 128)
      for (int e = st; e < R * LW; e += 3 * 32) {
        const int r = j0 + e / LW, m = e % LW;
        tile[(size_t)r * ld + jb + m] = pnl[m * QS + r];
      }
      for (int e = st; e < LW * B; e += 3 * 32) {
        const int a = e / B, c = e % B;
        dinv[(jb + a) * B + c] = c < j0 ? xb[a * QS + c] : T(0);
        if (c >= j0) tile[(size_t)(jb + a) * ld + c] = T(0);
      }
      K2_TICK_AT(9, 128)
    }
    __syncthreads();
    K2_TICK(3)
  }

  // L's diagonal leaves, zero above their diagonals, and Dinv's rows of the
  // last leaf (the rest of L_kk and Dinv have gone out step by step)
#pragma unroll
  for (int p = 0; p < B * LW / DTH; ++p) {
    const int e = tid + p * DTH;
    const int q = e / (LW * LW), a = (e / LW) % LW, c = e % LW;
    const int r = q * LW + a;
    tile[(size_t)r * ld + q * LW + c] = c <= a ? t[r * S + q * LW + c] : T(0);
  }
#pragma unroll
  for (int p = 0; p < B * LW / DTH; ++p) {
    const int e = tid + p * DTH;
    const int a = e / B, c = e % B;
    dinv[(B - LW + a) * B + c] = xb[a * QS + c];
  }
  K2_TICK(4)
  K2_TICK_END
}

// Dynamic shared memory of diag_kernel<T, B>: the tile, rd, pnl, xb, xl, lf.
template <typename T>
constexpr int diag_smem(int B) {
  return (B * (B + 1) + B + 2 * LW * (B + 4) + 2 * LW * LW) * (int)sizeof(T);
}

// One block a matrix of the batch.
template <typename T>
cudaError_t diag(T* w, T* dk, int* info, int ld, int kb, int B, int batch, size_t ws,
                 size_t ds, cudaStream_t st) {
  if (B == 128)
    diag_kernel<T, 128><<<batch, DTH, diag_smem<T>(128), st>>>(w, dk, info, ld, kb, ws, ds);
  else
    diag_kernel<T, 64><<<batch, DTH, diag_smem<T>(64), st>>>(w, dk, info, ld, kb, ws, ds);
  return cudaGetLastError();
}

// C[GT x GT tile] (=, or -= when SUB) X_rows * Y_rows^T over depth K, all
// row-major; each thread owns 4 x 4 outputs in registers, the depth is
// staged GK at a time in shared memory.  With tri, blockIdx.x enumerates
// the tiles of a lower triangle; otherwise blockIdx = (bj, bi).
// blockIdx.z is the matrix of the batch (operands sx, sy, sc apart).  The
// generic form (f64, B = 64).
template <typename T, bool SUB>
__global__ void __launch_bounds__(GTH * GTH)
nt_tile_kernel(const T* __restrict__ x, int ldx, const T* __restrict__ y, int ldy,
               T* c, int ldc, int K, int tri, size_t sx, size_t sy, size_t sc) {
  x += blockIdx.z * sx;
  y += blockIdx.z * sy;
  c += blockIdx.z * sc;
  __shared__ T xs[GK][GT + 1];
  __shared__ T ys[GK][GT + 1];
  int bi = blockIdx.y, bj = blockIdx.x;
  if (tri) tri_index(blockIdx.x, &bi, &bj);
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

// The float trailing update at B = 128: C[tile] -= X_rows * Y_rows^T over
// the 128 x 128 tiles of a lower triangle (blockIdx.x), depth K.  256
// threads each own 8 x 8 outputs (rows ty*4 + {0..3, 64..67}, columns
// tx*4 + {0..3, 64..67}), the depth staged 8 at a time, k-major in shared
// memory, in two stages: the next chunk's 16-byte global loads are in
// flight while the current one is multiplied.  Every operand read from
// shared memory is a 16-byte load, four of them per 64 FMAs.  Requires
// 16-byte aligned rows (ld % 4 == 0) and K % 8 == 0.  blockIdx.y is the
// matrix of the batch (operands sx, sy, sc apart).
constexpr int FT = 128;
constexpr int FK = 8;
constexpr int FS = FT + 4;  // padded k-row: the transposing stores hit distinct banks

__global__ void __launch_bounds__(256, 2)
sgemm_nt_128(const float* __restrict__ x, int ldx, const float* __restrict__ y, int ldy,
             float* c, int ldc, int K, size_t sx, size_t sy, size_t sc) {
  x += blockIdx.y * sx;
  y += blockIdx.y * sy;
  c += blockIdx.y * sc;
  __shared__ __align__(16) float xs[2][FK][FS];
  __shared__ __align__(16) float ys[2][FK][FS];
  int bi, bj;
  tri_index(blockIdx.x, &bi, &bj);
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
      const float4 old = *dst;
      *dst = make_float4(old.x - acc[r][4 * h], old.y - acc[r][4 * h + 1],
                         old.z - acc[r][4 * h + 2], old.w - acc[r][4 * h + 3]);
    }
  }
}

// The chain's products at B = 128 (f32): C[16 rows x 128] (=, or -= when
// SUB) X_rows * Y^T over depth 128, one block per 16 rows, so that a panel
// of R rows is R / 16 blocks that run at once (sgemm_nt_128's 128-row
// blocks take ~15 us alone, which the chain cannot hide).  The block stages
// its 16 rows of X and all of Y (128 x 128) in shared memory, k-major, with
// every global load in flight at once.  What bounds a block is then shared
// memory: each warp reads a whole 512-byte row of Y per step of the depth,
// so a warp owns 4 rows x 4 columns (16 FMAs a 16-byte Y load) and the two
// halves of the depth go to two groups of 4 warps, summed at the end.  A
// block reads its rows of X whole before it writes C, and no other block
// reads them, so C may alias X: the panel product is written in place.
// blockIdx.y is the matrix of the batch (operands sx, sy, sc apart).
constexpr int RT = 16;
constexpr int RTS = RT + 4;  // k-major row of the X stage
constexpr int ROWS_SMEM = FT * (RTS + FS) * (int)sizeof(float);

template <bool SUB>
__global__ void __launch_bounds__(256)
sgemm_rows_16(const float* x, int ldx, const float* __restrict__ y, int ldy, float* c,
              int ldc, size_t sx, size_t sy, size_t sc) {
  x += blockIdx.y * sx;
  y += blockIdx.y * sy;
  c += blockIdx.y * sc;
  extern __shared__ __align__(16) float rows_smem[];
  float* xs = rows_smem;         // FT x RTS: X^T
  float* ys = xs + FT * RTS;     // FT x FS: Y^T
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * RT;
  {
    // thread tid moves the float4 at (row tid / 2, k 8p + 4 (tid % 2)) of Y
    // for every p, and of X at (row (tid % 32) / 2, p = tid / 32 + 8j)
    const int lrow = tid / 2, lk = (tid % 2) * 4;
    const int xrow = lane / 2, xp = tid / 32;
    float4 yv[FT / FK], xv[2];
#pragma unroll
    for (int p = 0; p < FT / FK; ++p)
      yv[p] = *reinterpret_cast<const float4*>(y + (size_t)lrow * ldy + FK * p + lk);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      xv[j] = *reinterpret_cast<const float4*>(x + (size_t)(row0 + xrow) * ldx +
                                               FK * (xp + 8 * j) + lk);
#pragma unroll
    for (int p = 0; p < FT / FK; ++p) {
      float* d = ys + (FK * p + lk) * FS + lrow;
      d[0] = yv[p].x, d[FS] = yv[p].y, d[2 * FS] = yv[p].z, d[3 * FS] = yv[p].w;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* d = xs + (FK * (xp + 8 * j) + lk) * RTS + xrow;
      d[0] = xv[j].x, d[RTS] = xv[j].y, d[2 * RTS] = xv[j].z, d[3 * RTS] = xv[j].w;
    }
  }
  __syncthreads();

  // warp w: rows 4 (w % 4) + {0..3}, depth half w / 4; lane: columns 4 lane + {0..3}
  const int w = tid / 32;
  const int r4 = 4 * (w % 4);
  const int k0 = (w / 4) * (FT / 2);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 8
  for (int k = k0; k < k0 + FT / 2; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(xs + k * RTS + r4);
    const float4 b = *reinterpret_cast<const float4*>(ys + k * FS + 4 * lane);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
  __syncthreads();  // the stage is free: the upper half hands its sums over
  float* part = rows_smem;  // RT x FT
  if (k0 != 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(part + (r4 + r) * FT + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  if (k0 == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 o = *reinterpret_cast<const float4*>(part + (r4 + r) * FT + 4 * lane);
      float4* dst = reinterpret_cast<float4*>(c + (size_t)(row0 + r4 + r) * ldc + 4 * lane);
      float4 v = make_float4(acc[r][0] + o.x, acc[r][1] + o.y, acc[r][2] + o.z, acc[r][3] + o.w);
      if (SUB) {
        const float4 old = *dst;
        v = make_float4(old.x - v.x, old.y - v.y, old.z - v.z, old.w - v.w);
      }
      *dst = v;
    }
  }
}

// The elementwise kernels' grid: one block a row (up to 65535 rows, then
// the blocks stride), one grid layer a matrix of the batch.
dim3 rows_grid(int rows, int batch) {
  return dim3(rows < 1 ? 1 : (rows > 65535 ? 65535 : rows), batch);
}

// The in-order loop's panel product: pan = A[below, k] Dinv_k^T, copied
// back into L's column panel (the product's blocks share rows, so it
// cannot be written in place).  nrow rows below the diagonal tile; the
// matrices of the batch are ws (w), ds (dinv) and ps (pan) apart.
template <typename T>
cudaError_t panel_product(T* w, const T* dk, T* pan, int npad, int kb, int B, int nrow,
                          int batch, size_t ws, size_t ds, size_t ps, cudaStream_t st) {
  T* below = w + (size_t)(kb + B) * npad + kb;
  nt_tile_kernel<T, false><<<dim3(B / GT, nrow / GT, batch), GTH * GTH, 0, st>>>(
      below, npad, dk, B, pan, B, B, 0, ws, ds, ps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  copy_panel_kernel<T><<<rows_grid(nrow, batch), B, 0, st>>>(pan, ps, below, npad, ws, nrow,
                                                              B);
  return cudaGetLastError();
}

// The in-order loop's trailing update: the whole lower trailing triangle
// below and right of the diagonal tile.
template <typename T>
cudaError_t trailing_update(T* w, const T* pan, int npad, int kb, int B, int nrow,
                            int batch, size_t ws, size_t ps, cudaStream_t st) {
  const long long t = nrow / GT;
  nt_tile_kernel<T, true><<<dim3((unsigned)(t * (t + 1) / 2), 1, batch), GTH * GTH, 0, st>>>(
      pan, B, pan, B, w + (size_t)(kb + B) * npad + kb + B, npad, B, 1, ps, ps, ws);
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
    // blocks the first SMs that free up inside the caller's trailing
    // update, instead of after its last block
    int least = 0, greatest = 0;
    if (cudaDeviceGetStreamPriorityRange(&least, &greatest) != cudaSuccess ||
        cudaStreamCreateWithPriority(&streams[dev], cudaStreamNonBlocking, greatest) !=
            cudaSuccess)
      return nullptr;
  }
  return streams[dev];
}

// float, B = 128: the panel loop with a lookahead of one panel.  With P_k =
// L's column panel k (its product written in place), per panel k:
//   side:   [after T2(k-1)] T1(k): panel k+1's column, its diagonal tile
//           included, -= P_k P_k^T, in 16-row blocks; diag(k+1); panel
//           k+1's product in place, in 16-row blocks;
//   caller: [after panel k's product] T2(k): the tiles right of column k+1
//           -= P_k P_k^T (sgemm_nt_128).
// So the serial chain of panels runs on the side stream alone, and T2(k)
// runs beside T1(k), diag(k+1) and panel k+1's product.  The streams hand
// over with two events each way, used alternately, so that each wait names
// the launch it needs (T2(k-1), product k) and not a later one.  Every
// launch covers the whole batch (ws, ds: the matrices' strides in w and
// dinv), so the events are per panel, not per matrix.
cudaError_t run_lookahead(float* w, float* dinv, int* info, int npad, int batch,
                          cudaStream_t st) {
  constexpr int B = FT;
  const size_t ws = (size_t)npad * npad;
  const size_t ds = (size_t)(npad / B) * B * B;
  cudaStream_t side = side_stream();
  if (side == nullptr) return cudaErrorInvalidResourceHandle;
  cudaEvent_t ev[4] = {};  // t2_done[2] (prep for k = 0), prod_done[2]
  cudaEvent_t* t2_done = ev;
  cudaEvent_t* prod_done = ev + 2;
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = cudaEventCreateWithFlags(&ev[i], cudaEventDisableTiming);
  const int nb = npad / B;
  if (e == cudaSuccess) e = cudaEventRecord(t2_done[1], st);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side, t2_done[1], 0);
  if (e == cudaSuccess) e = diag<float>(w, dinv, info, npad, 0, B, batch, ws, ds, side);
  if (e == cudaSuccess) {
    float* below = w + (size_t)B * npad;
    sgemm_rows_16<false><<<dim3((npad - B) / RT, batch), 256, ROWS_SMEM, side>>>(
        below, npad, dinv, B, below, npad, ws, ds, ws);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = cudaEventRecord(prod_done[0], side);
  for (int k = 0; e == cudaSuccess && k + 1 < nb; ++k) {
    const int kn = (k + 1) * B;                       // panel k+1's first row and column
    const int below = npad - kn - B;                  // rows below panel k+1's tile
    const float* pk = w + (size_t)kn * npad + k * B;  // P_k from row kn on
    if (below > 0) {
      if ((e = cudaStreamWaitEvent(st, prod_done[k % 2], 0)) != cudaSuccess) break;
      const int t = below / FT;
      sgemm_nt_128<<<dim3((unsigned)(t * (t + 1) / 2), batch), 256, 0, st>>>(
          pk + (size_t)B * npad, npad, pk + (size_t)B * npad, npad,
          w + (size_t)(kn + B) * npad + kn + B, npad, B, ws, ws, ws);
      if ((e = cudaGetLastError()) != cudaSuccess) break;
      if ((e = cudaEventRecord(t2_done[k % 2], st)) != cudaSuccess) break;
    }
    if ((e = cudaStreamWaitEvent(side, t2_done[(k + 1) % 2], 0)) != cudaSuccess) break;
    sgemm_rows_16<true><<<dim3((below + B) / RT, batch), 256, ROWS_SMEM, side>>>(
        pk, npad, pk, npad, w + (size_t)kn * npad + kn, npad, ws, ws, ws);
    if ((e = cudaGetLastError()) != cudaSuccess) break;
    float* dn = dinv + (size_t)(k + 1) * B * B;
    if ((e = diag<float>(w, dn, info, npad, kn, B, batch, ws, ds, side)) != cudaSuccess) break;
    if (below > 0) {
      float* col = w + (size_t)(kn + B) * npad + kn;  // panel k+1 below its tile
      sgemm_rows_16<false><<<dim3(below / RT, batch), 256, ROWS_SMEM, side>>>(
          col, npad, dn, B, col, npad, ws, ds, ws);
      if ((e = cudaGetLastError()) != cudaSuccess) break;
    }
    e = cudaEventRecord(prod_done[(k + 1) % 2], side);
  }
  if (e == cudaSuccess) e = cudaStreamWaitEvent(st, prod_done[(nb - 1) % 2], 0);
  for (int i = 0; i < 4; ++i)
    if (ev[i] != nullptr) cudaEventDestroy(ev[i]);
  return e;
}

template <typename T>
int run(const T* a, T* w, T* out, T* pan, T* dinv, int* info, int n, int npad,
        int B, int batch, cudaStream_t st) {
  if ((B != 64 && B != 128) || npad % B != 0 || n > npad || n < 1 || batch < 1 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const bool lookahead = sizeof(T) == 4 && B == FT && npad > B;
  cudaError_t e = B == 128 ? cudaFuncSetAttribute(diag_kernel<T, 128>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  diag_smem<T>(128))
                           : cudaFuncSetAttribute(diag_kernel<T, 64>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  diag_smem<T>(64));
  if (e == cudaSuccess && lookahead) {
    e = cudaFuncSetAttribute(sgemm_rows_16<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ROWS_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sgemm_rows_16<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM);
  }
  if (e != cudaSuccess) return (int)e;

  const size_t ws = (size_t)npad * npad;             // w's matrices apart
  const size_t ds = (size_t)(npad / B) * B * B;        // dinv's
  const size_t ps = (size_t)(npad > B ? npad - B : 1) * B;  // pan's
  prep_kernel<T><<<rows_grid(npad, batch), 256, 0, st>>>(a, w, info, n, npad);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if constexpr (sizeof(T) == 4) {
    if (lookahead) e = run_lookahead(w, dinv, info, npad, batch, st);
  }
  if (!lookahead) {
    for (int k = 0; k < npad / B; ++k) {
      const int kb = k * B;
      const int nrow = npad - kb - B;  // rows below the diagonal tile
      T* dk = dinv + (size_t)k * B * B;
      if ((e = diag<T>(w, dk, info, npad, kb, B, batch, ws, ds, st)) != cudaSuccess)
        return (int)e;
      if (nrow == 0) break;
      if ((e = panel_product<T>(w, dk, pan, npad, kb, B, nrow, batch, ws, ds, ps, st)) !=
          cudaSuccess)
        return (int)e;
      if ((e = trailing_update<T>(w, pan, npad, kb, B, nrow, batch, ws, ps, st)) !=
          cudaSuccess)
        return (int)e;
    }
  }
  if (e != cudaSuccess) return (int)e;
  if (w == out) return 0;  // L is already in place, zero above its diagonal
  finish_kernel<T><<<rows_grid(n, batch), 256, 0, st>>>(w, npad, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef K2_PHASE_CLOCKS
// Copies the phase clocks to host[K2_SLOTS] and clears them.
extern "C" int panel_cholesky_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k2_phase_cycles, sizeof(k2_phase_cycles));
  static const unsigned long long zero[K2_SLOTS] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k2_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
#endif

// C entry points: every pointer is a device pointer to `batch` consecutive
// matrices (a, out: n x n; w: npad x npad; pan: max(npad - B, 1) x B; dinv:
// npad/B panels of B x B; info: one int each); the return value is the
// cudaError_t of the launches (0 on success).
extern "C" int panel_cholesky_f32(const float* a, float* w, float* out, float* pan,
                                  float* dinv, int* info, int n, int npad, int block,
                                  int batch, void* stream) {
  return run<float>(a, w, out, pan, dinv, info, n, npad, block, batch,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int panel_cholesky_f64(const double* a, double* w, double* out, double* pan,
                                  double* dinv, int* info, int n, int npad, int block,
                                  int batch, void* stream) {
  return run<double>(a, w, out, pan, dinv, info, n, npad, block, batch,
                     static_cast<cudaStream_t>(stream));
}
