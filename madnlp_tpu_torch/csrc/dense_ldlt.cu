// Whole-matrix blocked unpivoted LDLᵀ (K7) for Hopper (sm_90a), float and
// double, behind a plain C interface loaded with ctypes by
// madnlp_tpu_torch/ops/dense_kernels.py.
//
// Replaces the TPU kernel
//   K7  madnlp_tpu/ops/pallas_ldlt.py:pallas_ldlt (:132; body _ldlt_kernel
//       :89, its diagonal block by _unblocked_ldlt :50 and
//       _unit_lower_inverse :71)
// which factors a whole N ≤ 1024 matrix resident in VMEM in one call.  On
// the card K7 is the dense path's factorization (ops/dense_solvers.py,
// LinearSolver.LDL) at any N.
//
// Layout: A is (Np, Np) row-major, Np a multiple of the block b, 1 ≤ b ≤
// 128.  Only the lower triangle is read.  On return the strict lower
// triangle holds L and the diagonal D (the TPU kernel's in-place output);
// the upper triangle is don't-care.  Per block column k (kb = k·b):
//   diag      L_kk, D_k by b rank-1 steps on the b×b diagonal block, and
//             L_kk⁻¹ by forward substitution;
//   panel     X = A[below, k]·L_kk⁻ᵀ, L = X·D_k⁻¹ over A[below, k];
//   trailing  A[below, below] −= L·Xᵀ on the lower triangle.
//
// What bounds it on this card.  Np³/3 flops on 2·Np² elements: at the
// dense nb=600 ACOPF system (N = 2674, Np = 2688) 6.5 GFLOP, bound by
// operations outside the tensor cores (TF32 is not IEEE float32, and DMMA's
// internal order cannot match the witness below) at 0.097 ms in float32.
// In practice the chain bounds it: the Np/b diagonal steps run one after
// another, each a chain of b dependent pivots on one SM, and everything
// else waits for them.  The first version of K7 (kept below as the
// witness) ran each step with two CTA barriers, an integer / and % per
// element and half the threads idle per pivot, and issued diag → panel →
// scale → trailing in order on one stream, so the other 131 SMs waited
// through every step.
//
// What this design does about it.
//   1. The diagonal step without the barrier storm (diag_kernel, one CTA of
//      512 threads, the block in shared memory).  The rank-1 steps go in
//      groups of four pivots, one CTA barrier per group: the owner warp of
//      group g (warps 0, 4, 8, 12 in turn: one issue slot, no competing
//      work on it) applies group g−1's pivots to the group's four columns
//      and factors them warp-synchronously, pivots by shuffle, while the
//      other twelve warps apply group g−1's pivots to the later columns,
//      each lane a row segment of four columns in one 16-byte load.  The
//      multipliers l = S/d are IEEE quotients computed without a division
//      per element: y = 1/d once per pivot, then x·y and two Markstein
//      corrections, which round to x/d itself while every intermediate is
//      normal (|x|, |d| in [2^-40, 2^41) in float, [2^-300, 2^301) in
//      double, read off the exponent bits); anything else, a zero pivot
//      included, takes the IEEE division, warp-uniformly.  The inverse
//      runs per warp on its columns of L_kk⁻¹ (independent chains), L read
//      16 bytes for four steps and x_jc by shuffle, without branches or
//      CTA barriers.  Block in and out by coalesced copies.
//   2. Look-ahead on two streams the C code creates once per device: a
//      high-priority stream runs the chain diag(k) → panel(k) → the update
//      of block column k+1 alone (strip) → diag(k+1) → …, while a
//      low-priority stream updates the rest of the trailing matrix with
//      column k, ordered by events: panel(k) before rest(k), rest(k−1)
//      before strip(k).  X is double-buffered by the parity of k.
//   3. Register-tiled SIMT products, operands staged row-major in shared
//      memory by cp.async (16-byte copies where aligned) and read by
//      16-byte loads along k: the chain's panel and strip in 32-row tiles
//      over the whole block column (256 threads, 2×8 outputs each, the
//      whole K in one stage), the rest in 128×128 tiles (256 threads, 8×8
//      each, K in double-buffered chunks of 32), only over the tiles that
//      meet the lower triangle.  The trailing epilogues stage their C tile
//      by cp.async too, so its loads are in flight together.  The D⁻¹ scale
//      is fused into the panel's epilogue (a CTA owns whole rows of the
//      block column, so it may overwrite its operand).
//   4. Launches: 4 per block column (3 on the chain, 1 beside it), 80 at
//      the dense cell's Np/b = 21, and the event records and waits between
//      the streams.
//
// Why it equals the witness bit for bit (float and double, every block the
// witness takes, on the strict lower triangle and the diagonal).  Every
// output element keeps its one accumulator and its order of operations:
// element (i, q) of the diagonal block takes S ← S − d_j·(l_i·l_q) in pivot
// order j with l = S/pivot_div(d_j) (the same quotient, see 1.); element
// (i, c) of L_kk⁻¹ starts at −l_ic and takes S ← S − l_ij·S_jc in j order;
// every product element starts at 0 and takes acc += a_k·b_k for
// k = 0..b−1 in order (the zero upper half of L_kk⁻¹ included), then the
// same single division or subtraction.  Each trailing element receives its
// column updates in k order (the events order strip(k) after rest(k−1)).
// Only which thread computes an element, and when, differs.  The build
// keeps nvcc's defaults (no fast math, FMA contraction on) and no tensor
// cores are used.
//
// A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel: the
// inertia that drives the IPM's regularization ladder must match exactly.
// Kernels allocate nothing; the entry points return the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr double ZERO_PIVOT_TOL = 1e-30;

template <typename T>
__device__ __forceinline__ T pivot_div(T v) {
  return fabs(v) <= (T)ZERO_PIVOT_TOL ? (T)INFINITY : v;
}

// -- the witness: the first version of K7, unchanged ------------------------
//
// The host loops over the block columns and launches, per column, on the
// caller's stream: (a) ref_diag_kernel, one CTA with the b×b block in shared
// memory, rank-1 steps with two barriers per pivot, L_kk⁻¹ in place by
// forward substitution into R; (b) a 64×64 SIMT GEMM X = A[below, k]·L_kk⁻ᵀ;
// (c) L = X·D_k⁻¹; (d) the 64×64 SIMT GEMM A[below, below] −= L·Xᵀ on the
// lower tiles.  Blocks 32, 64 and 128.  No solve path reaches it.

constexpr int REF_DIAG_THREADS = 512;

template <typename T>
size_t ref_diag_smem_bytes(int b) {
  return ((size_t)b * (b + 1) + b) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(REF_DIAG_THREADS, 1)
ref_diag_kernel(T* __restrict__ A, int ld, T* __restrict__ R, int b) {
  extern __shared__ unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);   // b × (b+1)
  T* lv = S + (size_t)b * (b + 1);         // b
  const int ls = b + 1;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < b * b; e += nt) {
    const int r = e / b, c = e % b;
    if (c <= r) S[r * ls + c] = A[(size_t)r * ld + c];
  }
  __syncthreads();

  // rank-1 steps on the lower triangle
  for (int j = 0; j < b; ++j) {
    const T dj = S[j * ls + j];
    const T div = pivot_div(dj);
    for (int i = j + 1 + tid; i < b; i += nt) lv[i] = S[i * ls + j] / div;
    __syncthreads();
    const int m = b - j - 1;
    for (int e = tid; e < m * m; e += nt) {
      const int r = e / m, c = e % m;
      if (c > r) continue;
      const int i = j + 1 + r, q = j + 1 + c;
      S[i * ls + q] -= dj * (lv[i] * lv[q]);
    }
    for (int i = j + 1 + tid; i < b; i += nt) S[i * ls + j] = lv[i];
    __syncthreads();
  }

  // L_kk (strict lower) and D_k back to A; the block's upper part is zero
  for (int e = tid; e < b * b; e += nt) {
    const int r = e / b, c = e % b;
    A[(size_t)r * ld + c] = c <= r ? S[r * ls + c] : T(0);
  }
  __syncthreads();

  // L_kk⁻¹ by forward substitution, in place on the strict lower triangle:
  // step j reads column j of L (untouched so far) and the finished row j
  for (int j = 0; j < b - 1; ++j) {
    for (int i = j + 1 + tid; i < b; i += nt) lv[i] = S[i * ls + j];
    __syncthreads();
    const int m = b - j - 1, w = j + 1;
    for (int e = tid; e < m * w; e += nt) {
      const int i = j + 1 + e / w, c = e % w;
      S[i * ls + c] = c == j ? -lv[i] : S[i * ls + c] - lv[i] * S[j * ls + c];
    }
    __syncthreads();
  }
  for (int e = tid; e < b * b; e += nt) {
    const int r = e / b, c = e % b;
    R[e] = c < r ? S[r * ls + c] : (c == r ? T(1) : T(0));
  }
}

// Tiled SIMT GEMM  C[M×N] (ldc)  =  or  -=  A[M×K] (lda) · B[N×K]ᵀ (ldb).
constexpr int REF_BM = 64, REF_BN = 64, REF_BK = 16, REF_GEMM_THREADS = 256;

template <typename T>
__device__ __forceinline__ void ref_gemm_nt_tile(
    const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
    T* __restrict__ C, int ldc, int M, int N, int K, bool subtract,
    int m0, int n0) {
  __shared__ T As[REF_BK][REF_BM + 1];
  __shared__ T Bs[REF_BK][REF_BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < K; k0 += REF_BK) {
    for (int e = tid; e < REF_BM * REF_BK; e += REF_GEMM_THREADS) {
      const int r = e / REF_BK, k = e % REF_BK;
      const int gr = m0 + r, gk = k0 + k;
      As[k][r] = (gr < M && gk < K) ? A[(size_t)gr * lda + gk] : T(0);
    }
    for (int e = tid; e < REF_BN * REF_BK; e += REF_GEMM_THREADS) {
      const int r = e / REF_BK, k = e % REF_BK;
      const int gr = n0 + r, gk = k0 + k;
      Bs[k][r] = (gr < N && gk < K) ? B[(size_t)gr * ldb + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < REF_BK; ++k) {
      T a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bb[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= N) continue;
      T* p = C + (size_t)r * ldc + c;
      *p = subtract ? *p - acc[i][j] : acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(REF_GEMM_THREADS)
ref_panel_kernel(const T* __restrict__ P, int ld, const T* __restrict__ R,
                 T* __restrict__ X, int rows, int b) {
  ref_gemm_nt_tile(P, ld, R, b, X, b, rows, b, b, false, blockIdx.y * REF_BM,
                   blockIdx.x * REF_BN);
}

template <typename T>
__global__ void ref_scale_kernel(const T* __restrict__ X,
                                 const T* __restrict__ Dk, T* __restrict__ P,
                                 int ld, int rows, int b) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * b) return;
  const int r = (int)(e / b), c = (int)(e % b);
  P[(size_t)r * ld + c] = X[e] / pivot_div(Dk[(size_t)c * (ld + 1)]);
}

template <typename T>
__global__ void __launch_bounds__(REF_GEMM_THREADS)
ref_trailing_kernel(T* __restrict__ C, const T* __restrict__ Lc,
                    const T* __restrict__ X, int ld, int rows, int b) {
  const int m0 = blockIdx.y * REF_BM, n0 = blockIdx.x * REF_BN;
  if (n0 > m0 + REF_BM - 1) return;   // wholly above the diagonal
  ref_gemm_nt_tile(Lc, ld, X, b, C, ld, rows, rows, b, true, m0, n0);
}

template <typename T>
int factorize_reference(T* A, T* R, T* xbuf, int np, int b,
                        cudaStream_t stream) {
  const size_t smem = ref_diag_smem_bytes<T>(b);
  cudaError_t err = cudaFuncSetAttribute(
      ref_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int kb = 0; kb < np; kb += b) {
    T* Akk = A + (size_t)kb * np + kb;
    ref_diag_kernel<T><<<1, REF_DIAG_THREADS, smem, stream>>>(Akk, np, R, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int rows = np - kb - b;
    if (rows == 0) break;
    T* P = Akk + (size_t)b * np;           // A[kb+b:, kb:kb+b]
    const dim3 panel_grid((b + REF_BN - 1) / REF_BN,
                          (rows + REF_BM - 1) / REF_BM);
    ref_panel_kernel<T><<<panel_grid, REF_GEMM_THREADS, 0, stream>>>(
        P, np, R, xbuf, rows, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const unsigned sblocks = (unsigned)(((size_t)rows * b + 255) / 256);
    ref_scale_kernel<T><<<sblocks, 256, 0, stream>>>(xbuf, Akk, P, np, rows,
                                                     b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 trail_grid((rows + REF_BN - 1) / REF_BN,
                          (rows + REF_BM - 1) / REF_BM);
    ref_trailing_kernel<T><<<trail_grid, REF_GEMM_THREADS, 0, stream>>>(
        P + b, P, xbuf, np, rows, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// -- K7 ----------------------------------------------------------------------

constexpr int MAX_BLOCK = 128;
constexpr int DIAG_THREADS = 512;
constexpr int DIAG_WARPS = DIAG_THREADS / 32;   // 16
constexpr int GROUP = 4;                        // pivots per CTA barrier
constexpr int SLOTS = MAX_BLOCK / DIAG_WARPS;   // 8 columns of L_kk⁻¹ a warp
constexpr int ROWS = MAX_BLOCK / 32;            // 4 rows a lane
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// leading dimension of the block in shared memory: rows 16-byte aligned and
// an odd multiple of 16 bytes apart, so that 8 lanes reading 16 bytes of 8
// consecutive rows hit 32 banks; past the last column of the last group
template <typename T>
__host__ __device__ __forceinline__ int diag_ld(int b) {
  return sizeof(T) == 4 ? round_up(b, 8) + 4 : round_up(b, 4) + 2;
}

// the block (MAX_BLOCK rows, so that rows ≥ b stay in bounds), then the
// multipliers (row-major, a row's four of a group together) and pivots of
// the last two groups of pivots
template <typename T>
size_t diag_smem_bytes(int b) {
  return ((size_t)MAX_BLOCK * diag_ld<T>(b) + 2 * MAX_BLOCK * GROUP +
          2 * GROUP) * sizeof(T);
}

// four consecutive elements, 16-byte aligned, from / to shared memory
template <typename T>
__device__ __forceinline__ void lds4(const T* p, T (&o)[GROUP]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const double2 u = *reinterpret_cast<const double2*>(p);
    const double2 v = *reinterpret_cast<const double2*>(p + 2);
    o[0] = u.x; o[1] = u.y; o[2] = v.x; o[3] = v.y;
  }
}
template <typename T>
__device__ __forceinline__ void sts4(T* p, const T (&o)[GROUP]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(o[2], o[3]);
  }
}

// column u of c4 at row block a, for a runtime a < ROWS
template <typename T>
__device__ __forceinline__ T pick(const T (&c4)[ROWS][GROUP], int u, int a) {
  T v = c4[0][u];
#pragma unroll
  for (int t = 1; t < ROWS; ++t)
    if (a == t) v = c4[t][u];
  return v;
}

// The quotient x / b, correctly rounded, from y = 1/b (IEEE): q0 = x·y and
// two corrections q ← q + (x − b·q)·y (Markstein: with y correctly rounded
// and q faithful, the last one rounds to x/b itself).  Valid where every
// intermediate stays normal: |x| and |b| in [2^-E, 2^(E+1)), E = 40 in
// float and 300 in double, read off the exponent bits.
template <typename T>
__device__ __forceinline__ bool in_quotient_range(T v) {
  if constexpr (sizeof(T) == 4) {
    const unsigned e = (__float_as_uint(v) >> 23) & 0xffu;
    return e - (127u - 40u) <= 80u;
  } else {
    const unsigned e =
        (unsigned)((unsigned long long)__double_as_longlong(v) >> 52) & 0x7ffu;
    return e - (1023u - 300u) <= 600u;
  }
}
template <typename T>
__device__ __forceinline__ T markstein_quotient(T x, T b, T y) {
  T q, r;
  if constexpr (sizeof(T) == 4) {
    q = __fmul_rn(x, y);
    r = fmaf(-b, q, x);
    q = fmaf(r, y, q);
    r = fmaf(-b, q, x);
    return fmaf(r, y, q);
  } else {
    q = __dmul_rn(x, y);
    r = fma(-b, q, x);
    q = fma(r, y, q);
    r = fma(-b, q, x);
    return fma(r, y, q);
  }
}

// Column u of c4 below pivot j divided by div (the multipliers
// l_i = S_ij / div, i > j), each the IEEE quotient: Markstein's sequence in
// range, x·y for a zero (the signed zero of x/b), and the IEEE division
// itself, warp-uniformly, for anything else (a zero pivot divides as inf).
// Every row computes the same straight-line sequence; the rows that keep
// their value are selected at the end.
template <typename T>
__device__ __forceinline__ void divide_column(T (&c4)[ROWS][GROUP], int u,
                                              T div, int j, int b,
                                              int lane) {
  const T y = T(1) / div;
  bool slow = !in_quotient_range(div);
  T q[ROWS];
  bool take[ROWS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const T x = c4[a][u];
    const T mk = markstein_quotient(x, div, y);
    q[a] = x == T(0) ? x * y : mk;
    const int i = lane + 32 * a;
    take[a] = i > j && i < b;
    slow |= take[a] && x != T(0) && !in_quotient_range(x);
  }
  if (__any_sync(FULL_MASK, slow)) {
#pragma unroll
    for (int a = 0; a < ROWS; ++a) q[a] = c4[a][u] / div;
  }
#pragma unroll
  for (int a = 0; a < ROWS; ++a) c4[a][u] = take[a] ? q[a] : c4[a][u];
}

// The previous group's pivots j = 4(g−1) + u' (in dprev, their multipliers
// row-major in lprev) on the four columns 4·gg + u of the calling lane's
// rows: S ← S − d_j·(l_i·l_q) in pivot order.  Rows above a column (and
// rows ≥ b) take the same arithmetic on don't-care values; row blocks
// wholly above the columns are skipped.
template <typename T>
__device__ __forceinline__ void update_cols(T* __restrict__ Ls, int lds,
                                            int gg, int lane,
                                            const T* __restrict__ lprev,
                                            const T* __restrict__ dprev) {
  T d[GROUP], lq[GROUP][GROUP];
  lds4(dprev, d);
#pragma unroll
  for (int u = 0; u < GROUP; ++u) lds4(lprev + (GROUP * gg + u) * GROUP, lq[u]);
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    if (32 * a + 31 < GROUP * gg) continue;   // warp-uniform
    T* at = Ls + (lane + 32 * a) * lds + GROUP * gg;
    T c[GROUP], lr[GROUP];
    lds4(at, c);
    lds4(lprev + (lane + 32 * a) * GROUP, lr);
#pragma unroll
    for (int up = 0; up < GROUP; ++up)
#pragma unroll
      for (int u = 0; u < GROUP; ++u) c[u] -= d[up] * (lr[up] * lq[u][up]);
    sts4(at, c);
  }
}

// The rank-1 steps of the b×b block in Ls (lower triangle), in groups of
// four pivots, one CTA barrier per group.  Lane ℓ of a warp handles the
// rows ℓ + 32a.  Between two barriers, the owner warp of group g applies
// group g−1's pivots to the group's four columns 4g..4g+3 and factors them
// warp-synchronously (pivot j by shuffle, its multipliers, its update of
// the group's later columns), then publishes the columns and pivots;
// meanwhile the other warps apply group g−1's pivots to the column groups
// gg > g.  The owners are the warps 0, 4, 8 and 12 in turn, and no other
// warp of that issue slot (warp id mod 4) has work, so the owner's chain of
// dependent steps issues without competition; the twelve other warps share
// the updates.  On return Ls holds L_kk (strict lower) and D_k (diagonal).
constexpr int OWNERS = DIAG_WARPS / 4, UPDATERS = DIAG_WARPS - OWNERS;

template <typename T>
__device__ __forceinline__ void factor_block(T* __restrict__ Ls, int lds,
                                             T* __restrict__ lbuf,
                                             T* __restrict__ dbuf, int b,
                                             int w, int lane) {
  const int groups = (b + GROUP - 1) / GROUP;
  for (int g = 0; g < groups; ++g) {
    const int p = g & 1;
    const T* lprev = lbuf + (p ^ 1) * MAX_BLOCK * GROUP;
    const T* dprev = dbuf + (p ^ 1) * GROUP;
    if (w == 4 * (g % OWNERS)) {
      if (g > 0) update_cols(Ls, lds, g, lane, lprev, dprev);
      T c4[ROWS][GROUP];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
        lds4(Ls + (lane + 32 * a) * lds + GROUP * g, c4[a]);
      const int aj = (GROUP * g) >> 5;   // row block of the group's pivots
      T dpiv[GROUP] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int j = GROUP * g + u;
        if (j >= b) break;
        const T dj = __shfl_sync(FULL_MASK, pick(c4, u, aj), j & 31);
        dpiv[u] = dj;
        divide_column(c4, u, pivot_div(dj), j, b, lane);
#pragma unroll
        for (int u2 = u + 1; u2 < GROUP; ++u2) {
          const T lq =
              __shfl_sync(FULL_MASK, pick(c4, u, aj), (j + u2 - u) & 31);
#pragma unroll
          for (int a = 0; a < ROWS; ++a) c4[a][u2] -= dj * (c4[a][u] * lq);
        }
      }
      T* lcur = lbuf + p * MAX_BLOCK * GROUP;
#pragma unroll
      for (int a = 0; a < ROWS; ++a) {
        sts4(Ls + (lane + 32 * a) * lds + GROUP * g, c4[a]);
        sts4(lcur + (lane + 32 * a) * GROUP, c4[a]);   // rows ≤ j: don't-care
      }
      if (lane == 0) sts4(dbuf + p * GROUP, dpiv);
    }
    if (g > 0 && w % 4 != 0) {
      const int k = w - w / 4 - 1;   // 0..11
      for (int gg = g + 1 + k; gg < groups; gg += UPDATERS)
        update_cols(Ls, lds, gg, lane, lprev, dprev);
    }
    __syncthreads();
  }
}

// L_kk⁻¹ of the unit lower L_kk in Ls by forward substitution, column
// chains per warp: x[s] holds column c = w + 16·s, lane ℓ its rows ℓ + 32a;
// step j reads L[i][j] (16 bytes for four steps) and x_jc (shuffle) and
// updates the rows below j, without CTA barriers and without branches: at
// steps j in row block ja the columns s < 2·ja are all under way, s > 2·ja
// + 1 not yet.  Then, once every warp has read L, L_kk⁻¹ (unit lower,
// zeros above) over the block in Ls.  Rows ≥ b carry don't-care values.
template <typename T>
__device__ __forceinline__ void unit_lower_inverse(T* __restrict__ Ls, int lds,
                                                   int b, int w, int lane) {
  T x[SLOTS][ROWS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int c = w + DIAG_WARPS * s, i = lane + 32 * a;
      x[s][a] = i > c ? -Ls[i * lds + c] : (i == c ? T(1) : T(0));
    }
#pragma unroll
  for (int ja = 0; ja < ROWS; ++ja) {
#pragma unroll 1
    for (int jq = 0; jq < 32 / GROUP; ++jq) {
      const int j0 = 32 * ja + GROUP * jq;
      if (j0 >= b - 1) break;
      T l4[ROWS][GROUP];
#pragma unroll
      for (int a = ja; a < ROWS; ++a)
        lds4(Ls + (lane + 32 * a) * lds + j0, l4[a]);
#pragma unroll
      for (int jj = 0; jj < GROUP; ++jj) {
        const int j = j0 + jj, jl = GROUP * jq + jj;
        if (j >= b - 1) break;
        const bool below = lane > jl;
#pragma unroll
        for (int s = 0; s < SLOTS && s < 2 * ja + 2; ++s) {
          const bool on = s < 2 * ja || w + DIAG_WARPS * s < j;
          const T xj = __shfl_sync(FULL_MASK, x[s][ja], jl);
          if (on && below) x[s][ja] = x[s][ja] - l4[ja][jj] * xj;
#pragma unroll
          for (int a = ja + 1; a < ROWS; ++a)
            if (on) x[s][a] = x[s][a] - l4[a][jj] * xj;
        }
      }
    }
  }
  __syncthreads();   // every read of L from Ls is done
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int c = w + DIAG_WARPS * s, i = lane + 32 * a;
      if (i < b && c < b) Ls[i * lds + c] = x[s][a];
    }
}

// (diag) LDLᵀ of the diagonal block at A (leading dimension ld): L_kk and
// D_k written over its lower triangle, L_kk⁻¹ (unit lower, zeros above)
// row-major into R (b×b).  One CTA of 512 threads; the block in shared
// memory, staged in and out coalesced.
template <typename T>
__global__ void __launch_bounds__(DIAG_THREADS, 1)
diag_kernel(T* __restrict__ A, int ld, T* __restrict__ R, int b) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  const int lds = diag_ld<T>(b);
  T* Ls = reinterpret_cast<T*>(k7_smem);           // MAX_BLOCK × lds
  T* lbuf = Ls + (size_t)MAX_BLOCK * lds;           // 2 × MAX_BLOCK × GROUP
  T* dbuf = lbuf + 2 * MAX_BLOCK * GROUP;           // 2 × GROUP
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  constexpr int PER = MAX_BLOCK * MAX_BLOCK / DIAG_THREADS;   // 32

  // element e = tid + 512·t of the b×b block is (r, c), stepped without
  // divisions
  const int r0 = tid / b, c0 = tid - r0 * b;
  const int step_r = DIAG_THREADS / b, step_c = DIAG_THREADS - step_r * b;
#define K7_FOR_ELEMENTS(body)                                   \
  {                                                             \
    int r = r0, c = c0;                                         \
    _Pragma("unroll") for (int t = 0; t < PER; ++t) {           \
      if (r < b) { body }                                       \
      r += step_r;                                              \
      c += step_c;                                              \
      if (c >= b) { c -= b; ++r; }                              \
    }                                                           \
  }
  K7_FOR_ELEMENTS(if (c <= r) cp_async<sizeof(T)>(Ls + r * lds + c,
                                                  A + (size_t)r * ld + c);)
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  factor_block(Ls, lds, lbuf, dbuf, b, w, lane);
  K7_FOR_ELEMENTS(if (c <= r) A[(size_t)r * ld + c] = Ls[r * lds + c];)
  unit_lower_inverse(Ls, lds, b, w, lane);
  __syncthreads();
  K7_FOR_ELEMENTS(R[r * b + c] = Ls[r * lds + c];)
#undef K7_FOR_ELEMENTS
}

// -- the products -------------------------------------------------------------
//
// acc[MR][NR] of the TM×TN tile at (m0, n0) of A·Bᵀ, A (M×K) and B (N×K)
// row-major: (TM/MR)·(TN/NR) threads, thread (ty, tx) owning rows
// ty + TY·i and columns tx + TX·j.  Both operands are staged row-major in
// shared memory by cp.async in chunks of `chunk` k (16-byte copies where
// the operands allow, else one element each), double-buffered, and read by
// 16-byte loads along k: each element's acc starts at 0 and takes
// acc += a_k·b_k for k = 0..K−1 in order; k past K within the last 16
// bytes is zero-filled (acc + 0·0 = acc).  Rows outside M or N are not
// loaded and their outputs not stored.

template <typename T>
struct Vec {   // 16 bytes of T
  static constexpr int N = 16 / sizeof(T);
};

// shared leading dimension for `chunk` k: 16-byte rows, 4 banks apart
template <typename T>
__host__ __device__ __forceinline__ int stage_ld(int chunk) {
  constexpr int words = sizeof(T) / 4;
  return round_up(round_up(chunk, Vec<T>::N), 32 / words) + 4 / words;
}

template <typename T>
size_t product_smem_bytes(int tm, int tn, int chunk, int stages) {
  return (size_t)stages * (tm + tn) * stage_ld<T>(chunk) * sizeof(T);
}

// rows [0, nrows) (of which `valid` exist) × k [k0, k0 + kn) of G (ld)
// into S (ldS), k in [kn, kpad) zeroed
template <typename T>
__device__ __forceinline__ void stage_rows(T* S, int ldS,
                                           const T* __restrict__ G, int ld,
                                           int nrows, int valid, int k0,
                                           int kn, int kpad, bool vec,
                                           int tid, int nthreads) {
  constexpr int V = Vec<T>::N;
  if (vec) {
    const int per = kn / V;
    for (int e = tid; e < nrows * per; e += nthreads) {
      const int r = e / per, c = (e - r * per) * V;
      if (r < valid)
        cp_async<16>(S + r * ldS + c, G + (size_t)r * ld + k0 + c);
    }
  } else {
    for (int e = tid; e < nrows * kn; e += nthreads) {
      const int r = e / kn, c = e - r * kn;
      if (r < valid)
        cp_async<sizeof(T)>(S + r * ldS + c, G + (size_t)r * ld + k0 + c);
    }
  }
  const int pad = kpad - kn;
  for (int e = tid; e < nrows * pad; e += nthreads) {
    const int r = e / pad;
    S[r * ldS + kn + (e - r * pad)] = T(0);
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T* out) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

template <typename T, int TM, int TN, int MR, int NR>
struct Tile {
  static constexpr int TX = TN / NR, TY = TM / MR, THREADS = TX * TY;
};

template <typename T, int TM, int TN, int MR, int NR>
__device__ __forceinline__ void product(
    const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
    int M, int N, int K, int m0, int n0, int chunk, bool vec, T* smem,
    T (&acc)[MR][NR]) {
  using C = Tile<T, TM, TN, MR, NR>;
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x, tx = tid % C::TX, ty = tid / C::TX;
  const int ldS = stage_ld<T>(chunk);
  const int nch = (K + chunk - 1) / chunk;
  const T* Ab = A + (size_t)m0 * lda;
  const T* Bb = B + (size_t)n0 * ldb;
  auto issue = [&](int ch) {
    const int k0 = ch * chunk, kn = min(chunk, K - k0);
    T* S = smem + (ch & 1) * (TM + TN) * ldS;
    stage_rows(S, ldS, Ab, lda, TM, M - m0, k0, kn, round_up(kn, V), vec,
               tid, C::THREADS);
    stage_rows(S + TM * ldS, ldS, Bb, ldb, TN, N - n0, k0, kn,
               round_up(kn, V), vec, tid, C::THREADS);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = T(0);
  issue(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      issue(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* As = smem + (ch & 1) * (TM + TN) * ldS;
    const T* Bs = As + TM * ldS;
    const int kpad = round_up(min(chunk, K - ch * chunk), V);
    for (int k = 0; k < kpad; k += V) {
      T a[MR][V], bv[NR][V];
#pragma unroll
      for (int i = 0; i < MR; ++i)
        load_vec(As + (ty + C::TY * i) * ldS + k, a[i]);
#pragma unroll
      for (int j = 0; j < NR; ++j)
        load_vec(Bs + (tx + C::TX * j) * ldS + k, bv[j]);
#pragma unroll
      for (int kk = 0; kk < V; ++kk)
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < NR; ++j) acc[i][j] += a[i][kk] * bv[j][kk];
    }
    __syncthreads();
  }
}

// the chain's tiles (panel and strip): 32 rows × the whole block column,
// the whole K in one chunk
constexpr int CTM = 32, CTN = MAX_BLOCK, CMR = 2, CNR = 8;
constexpr int CHAIN_THREADS = Tile<float, CTM, CTN, CMR, CNR>::THREADS;   // 256
// the rest's tiles: 128×128, K in chunks of 32, double-buffered
constexpr int RTM = 128, RTN = 128, RMR = 8, RNR = 8, REST_CHUNK = 32;
constexpr int REST_THREADS = Tile<float, RTM, RTN, RMR, RNR>::THREADS;    // 256

// C tile leading dimension in shared memory: the two rows a warp reads on
// the two halves of the banks
template <typename T>
__host__ __device__ __forceinline__ int ctile_ld(int tn) {
  return tn + 64 / (int)sizeof(T);
}

// C (M×N, ld) −= acc on the tile at (m0, n0): the C tile is first staged in
// shared memory (smem, after the product is done with it) by cp.async, so
// that its loads are in flight together
template <typename T, int TM, int TN, int MR, int NR>
__device__ __forceinline__ void subtract_tile(T* __restrict__ C, int ld,
                                              int M, int N, int m0, int n0,
                                              bool vec, T* smem,
                                              const T (&acc)[MR][NR]) {
  using Cfg = Tile<T, TM, TN, MR, NR>;
  const int tid = threadIdx.x, tx = tid % Cfg::TX, ty = tid / Cfg::TX;
  const int ldc = ctile_ld<T>(TN), kn = min(TN, N - n0);
  T* Cb = C + (size_t)m0 * ld + n0;
  stage_rows(smem, ldc, Cb, ld, TM, M - m0, 0, kn, kn,
             vec && kn % Vec<T>::N == 0, tid, Cfg::THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty + Cfg::TY * i;
    if (m0 + r >= M) continue;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int c = tx + Cfg::TX * j;
      if (c >= kn) continue;
      Cb[(size_t)r * ld + c] = smem[r * ldc + c] - acc[i][j];
    }
  }
}

// (panel) X = P·L_kk⁻ᵀ into X (rows×b), L = X / pivot_div(D_k) over P;
// Dk points at the block's diagonal (stride ld + 1).  A CTA owns whole rows
// of the block column (b ≤ CTN) and has staged them before it overwrites
// them.
template <typename T>
__global__ void __launch_bounds__(CHAIN_THREADS)
panel_kernel(T* __restrict__ P, int ld, const T* __restrict__ R,
             T* __restrict__ X, const T* __restrict__ Dk, int rows, int b,
             bool vec) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  using C = Tile<T, CTM, CTN, CMR, CNR>;
  const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
  T div[CNR];   // loaded ahead of the product
#pragma unroll
  for (int j = 0; j < CNR; ++j) {
    const int c = tx + C::TX * j;
    div[j] = c < b ? pivot_div(Dk[(size_t)c * (ld + 1)]) : T(1);
  }
  T acc[CMR][CNR];
  const int m0 = blockIdx.x * CTM;
  product<T, CTM, CTN, CMR, CNR>(P, ld, R, b, rows, b, b, m0, 0, b, vec,
                                 reinterpret_cast<T*>(k7_smem), acc);
#pragma unroll
  for (int i = 0; i < CMR; ++i) {
    const int r = m0 + ty + C::TY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < CNR; ++j) {
      const int c = tx + C::TX * j;
      if (c >= b) continue;
      X[(size_t)r * b + c] = acc[i][j];
      P[(size_t)r * ld + c] = acc[i][j] / div[j];
    }
  }
}

// (strip) block column k+1 of the trailing matrix, C = A[kb+b:, kb+b:kb+2b]
// (rows × b) −= L·X[0:b]ᵀ: the chain's part of the trailing update
template <typename T>
__global__ void __launch_bounds__(CHAIN_THREADS)
strip_kernel(T* __restrict__ C, int ld, const T* __restrict__ Lc,
             const T* __restrict__ X, int rows, int b, bool vec) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  T* smem = reinterpret_cast<T*>(k7_smem);
  T acc[CMR][CNR];
  const int m0 = blockIdx.x * CTM;
  product<T, CTM, CTN, CMR, CNR>(Lc, ld, X, b, rows, b, b, m0, 0, b, vec,
                                 smem, acc);
  subtract_tile<T, CTM, CTN, CMR, CNR>(C, ld, rows, b, m0, 0, vec, smem, acc);
}

// (rest) the trailing matrix right of block column k+1, C = A[kb+2b:,
// kb+2b:] (n × n) −= Lc·Xᵀ with Lc = A[kb+2b:, kb:kb+b], X its rows of the
// panel's X; a 1-D grid over the tiles that meet the lower triangle
template <typename T>
__global__ void __launch_bounds__(REST_THREADS)
rest_kernel(T* __restrict__ C, int ld, const T* __restrict__ Lc,
            const T* __restrict__ X, int n, int b, bool vec) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  T* smem = reinterpret_cast<T*>(k7_smem);
  const int t = blockIdx.x;
  int by = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((by + 1) * (by + 2) / 2 <= t) ++by;
  while (by * (by + 1) / 2 > t) --by;
  const int bx = t - by * (by + 1) / 2;
  T acc[RMR][RNR];
  const int m0 = by * RTM, n0 = bx * RTN;
  product<T, RTM, RTN, RMR, RNR>(Lc, ld, X, b, n, n, b, m0, n0, REST_CHUNK,
                                 vec, smem, acc);
  subtract_tile<T, RTM, RTN, RMR, RNR>(C, ld, n, n, m0, n0, vec, smem, acc);
}

template <typename T>
size_t chain_smem_bytes(int b) {
  return std::max(product_smem_bytes<T>(CTM, CTN, b, 1),
                  (size_t)CTM * ctile_ld<T>(CTN) * sizeof(T));
}
template <typename T>
size_t rest_smem_bytes(int b) {
  return std::max(
      product_smem_bytes<T>(RTM, RTN, REST_CHUNK, b > REST_CHUNK ? 2 : 1),
      (size_t)RTM * ctile_ld<T>(RTN) * sizeof(T));
}

// The two streams and the events of the look-ahead, created once per
// device: `chain` at the greatest priority, `side` at the least.
struct Lookahead {
  bool ready = false;
  cudaStream_t chain, side;
  cudaEvent_t start, panel, rest, chain_done, side_done;
};

cudaError_t lookahead_for(Lookahead** out) {
  constexpr int MAX_DEVICES = 64;
  static Lookahead per_device[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Lookahead& la = per_device[dev];
  if (!la.ready) {
    int least, greatest;
    if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) ||
        (err = cudaStreamCreateWithPriority(&la.chain, cudaStreamNonBlocking,
                                            greatest)) ||
        (err = cudaStreamCreateWithPriority(&la.side, cudaStreamNonBlocking,
                                            least)))
      return err;
    for (cudaEvent_t* e : {&la.start, &la.panel, &la.rest, &la.chain_done,
                           &la.side_done})
      if ((err = cudaEventCreateWithFlags(e, cudaEventDisableTiming)))
        return err;
    la.ready = true;
  }
  *out = &la;
  return cudaSuccess;
}

int tiles_of(int n, int t) { return (n + t - 1) / t; }

template <typename T>
cudaError_t set_smem_limits(int b) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(diag_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)diag_smem_bytes<T>(b))) ||
      (err = cudaFuncSetAttribute(panel_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)chain_smem_bytes<T>(b))) ||
      (err = cudaFuncSetAttribute(strip_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)chain_smem_bytes<T>(b))))
    return err;
  return cudaFuncSetAttribute(rest_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)rest_smem_bytes<T>(b));
}

// K7: A (np × np, in place), R (b × b scratch), xbuf (2 × (np − b) × b
// scratch: X of the even and the odd block columns)
template <typename T>
int factorize(T* A, T* R, T* xbuf, int np, int b, cudaStream_t caller) {
  if (b < 1 || b > MAX_BLOCK || np % b) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits<T>(b);
  if (err != cudaSuccess) return (int)err;
  Lookahead* la;
  if ((err = lookahead_for(&la))) return (int)err;
  const cudaStream_t chain = la->chain, side = la->side;
  // 16-byte copies where every row of every operand starts 16-byte aligned
  const bool vec = b % Vec<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xbuf) % 16 == 0;
  const size_t dsmem = diag_smem_bytes<T>(b), csmem = chain_smem_bytes<T>(b),
               rsmem = rest_smem_bytes<T>(b);
#define K7_CHECK(call) \
  if ((err = (call)) != cudaSuccess) return (int)err
  K7_CHECK(cudaEventRecord(la->start, caller));
  K7_CHECK(cudaStreamWaitEvent(chain, la->start, 0));
  K7_CHECK(cudaStreamWaitEvent(side, la->start, 0));
  const size_t xstride = (size_t)(np > b ? np - b : 1) * b;
  for (int k = 0, kb = 0; kb < np; ++k, kb += b) {
    T* Akk = A + (size_t)kb * np + kb;
    diag_kernel<T><<<1, DIAG_THREADS, dsmem, chain>>>(Akk, np, R, b);
    K7_CHECK(cudaGetLastError());
    const int rows = np - kb - b;
    if (rows == 0) break;
    T* P = Akk + (size_t)b * np;           // A[kb+b:, kb:kb+b]
    T* X = xbuf + (k & 1) * xstride;
    panel_kernel<T><<<tiles_of(rows, CTM), CHAIN_THREADS, csmem, chain>>>(
        P, np, R, X, Akk, rows, b, vec);
    K7_CHECK(cudaGetLastError());
    K7_CHECK(cudaEventRecord(la->panel, chain));
    // rest(k−1) updated block column k+1 before strip(k) does
    if (k > 0) K7_CHECK(cudaStreamWaitEvent(chain, la->rest, 0));
    strip_kernel<T><<<tiles_of(rows, CTM), CHAIN_THREADS, csmem, chain>>>(
        P + b, np, P, X, rows, b, vec);
    K7_CHECK(cudaGetLastError());
    const int n = rows - b;
    if (n > 0) {
      const int t = tiles_of(n, RTM);
      K7_CHECK(cudaStreamWaitEvent(side, la->panel, 0));
      rest_kernel<T><<<t * (t + 1) / 2, REST_THREADS, rsmem, side>>>(
          P + (size_t)b * np + 2 * b, np, P + (size_t)b * np,
          X + (size_t)b * b, n, b, vec);
      K7_CHECK(cudaGetLastError());
      K7_CHECK(cudaEventRecord(la->rest, side));
    }
  }
  K7_CHECK(cudaEventRecord(la->chain_done, chain));
  K7_CHECK(cudaEventRecord(la->side_done, side));
  K7_CHECK(cudaStreamWaitEvent(caller, la->chain_done, 0));
  K7_CHECK(cudaStreamWaitEvent(caller, la->side_done, 0));
#undef K7_CHECK
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: A (np × np, row-major, in place), R (b × b scratch), xbuf
// (2 × (np − b) × b scratch); 1 ≤ b ≤ 128
int dense_ldlt_f32(void* A, void* R, void* xbuf, int np, int b,
                   void* stream) {
  return factorize<float>((float*)A, (float*)R, (float*)xbuf, np, b,
                          (cudaStream_t)stream);
}

int dense_ldlt_f64(void* A, void* R, void* xbuf, int np, int b,
                   void* stream) {
  return factorize<double>((double*)A, (double*)R, (double*)xbuf, np, b,
                           (cudaStream_t)stream);
}

// the witness (the first version of K7): A in place, R (b × b scratch), xbuf
// ((np − b) × b scratch); b ∈ {32, 64, 128}
int dense_ldlt_reference_f32(void* A, void* R, void* xbuf, int np, int b,
                             void* stream) {
  return factorize_reference<float>((float*)A, (float*)R, (float*)xbuf, np, b,
                                    (cudaStream_t)stream);
}

int dense_ldlt_reference_f64(void* A, void* R, void* xbuf, int np, int b,
                             void* stream) {
  return factorize_reference<double>((double*)A, (double*)R, (double*)xbuf,
                                     np, b, (cudaStream_t)stream);
}

}  // extern "C"
