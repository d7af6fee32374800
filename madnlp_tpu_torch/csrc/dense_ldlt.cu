// Whole-matrix blocked unpivoted LDLᵀ (K7) for Hopper (sm_90a), float and
// double, behind a plain C interface loaded with ctypes by
// madnlp_tpu_torch/ops/dense_kernels.py.
//
// Replaces the TPU kernel
//   K7  madnlp_tpu/ops/pallas_ldlt.py:pallas_ldlt (body _ldlt_kernel)
// which factors a whole N ≤ 1024 matrix resident in VMEM in one call.
//
// Layout: A is (Np, Np) row-major, Np a multiple of the block b.  Only the
// lower triangle is read.  On return the strict lower triangle holds L and
// the diagonal D (the TPU kernel's in-place output); the upper triangle is
// don't-care.
//
// What bounds it on this card.  The factorization does Np³/3 flops on
// 2·Np² elements: at the dense nb=600 ACOPF system (N = 2674, Np = 2688)
// 6.5 GFLOP on 58 MB in float64, so it is bound by operations (float32 or
// float64 outside the tensor cores: TF32 is ruled out, the factor must be
// true float32).  But the block columns retire in strict order and each
// begins with a b×b diagonal LDLᵀ, a chain of b dependent pivot steps in
// one CTA, so in practice the sequential diagonal step bounds it.
//
// What the design does about that (first version: simple and right).  The
// host loops over the Np/b block columns k and launches, per column:
//   (a) diag_kernel — one CTA holds the b×b diagonal block in shared memory
//       (b·(b+1) elements: 66 KB in float32, 132 KB in float64 at b = 128),
//       factors it by rank-1 steps on its lower triangle, writes L_kk and
//       D_k back, then overwrites its strict lower triangle in place with
//       L_kk⁻¹ by forward substitution (the TPU kernel's order; in place
//       because the block and a separate inverse would not both fit a CTA's
//       227 KB in float64) and writes L_kk⁻¹ to a b×b scratch;
//   (b) a tiled SIMT GEMM  X = A[below, k] · L_kk⁻ᵀ  into scratch,
//   (c) L = X · D_k⁻¹ written over A[below, k], and
//   (d) a tiled SIMT GEMM over the lower tiles of the trailing matrix,
//       A[below, below] −= L · Xᵀ, spreading (b)-(d) over many SMs.
//   All products are full-precision FMA loops (no tensor cores, no TF32).
//   A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel: the
//   inertia that drives the IPM's regularization ladder must match exactly.
//   Kernels allocate nothing; the entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DIAG_THREADS = 512;
constexpr double ZERO_PIVOT_TOL = 1e-30;

template <typename T>
__device__ __forceinline__ T pivot_div(T v) {
  return fabs(v) <= (T)ZERO_PIVOT_TOL ? (T)INFINITY : v;
}

template <typename T>
size_t diag_smem_bytes(int b) {
  return ((size_t)b * (b + 1) + b) * sizeof(T);
}

// (a) the diagonal block at A + kb·(ld+1): LDLᵀ in shared memory, L_kk and
// D_k written back (upper part of the block zeroed), L_kk⁻¹ into R (b×b).
// One CTA; its shared memory keeps it alone on its SM, so the bound lets
// ptxas use the registers that leaves free.
template <typename T>
__global__ void __launch_bounds__(DIAG_THREADS, 1)
diag_kernel(T* __restrict__ A, int ld, T* __restrict__ R, int b) {
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
constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

template <typename T>
__device__ __forceinline__ void gemm_nt_tile(
    const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
    T* __restrict__ C, int ldc, int M, int N, int K, bool subtract,
    int m0, int n0) {
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int r = e / BK, k = e % BK;
      const int gr = m0 + r, gk = k0 + k;
      As[k][r] = (gr < M && gk < K) ? A[(size_t)gr * lda + gk] : T(0);
    }
    for (int e = tid; e < BN * BK; e += GEMM_THREADS) {
      const int r = e / BK, k = e % BK;
      const int gr = n0 + r, gk = k0 + k;
      Bs[k][r] = (gr < N && gk < K) ? B[(size_t)gr * ldb + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
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

// (b) X = A[below, k] · L_kk⁻ᵀ over the `rows` rows below the block
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
panel_kernel(const T* __restrict__ P, int ld, const T* __restrict__ R,
             T* __restrict__ X, int rows, int b) {
  gemm_nt_tile(P, ld, R, b, X, b, rows, b, b, false, blockIdx.y * BM,
               blockIdx.x * BN);
}

// (c) L = X / D_k, written over A[below, k]; Dk points at the block's
// diagonal (stride ld + 1)
template <typename T>
__global__ void scale_kernel(const T* __restrict__ X, const T* __restrict__ Dk,
                             T* __restrict__ P, int ld, int rows, int b) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * b) return;
  const int r = (int)(e / b), c = (int)(e % b);
  P[(size_t)r * ld + c] = X[e] / pivot_div(Dk[(size_t)c * (ld + 1)]);
}

// (d) A[below, below] −= L · Xᵀ on the tiles that touch the lower triangle
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
trailing_kernel(T* __restrict__ C, const T* __restrict__ Lc,
                const T* __restrict__ X, int ld, int rows, int b) {
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (n0 > m0 + BM - 1) return;   // wholly above the diagonal
  gemm_nt_tile(Lc, ld, X, b, C, ld, rows, rows, b, true, m0, n0);
}

template <typename T>
int factorize(T* A, T* R, T* xbuf, int np, int b, cudaStream_t stream) {
  const size_t smem = diag_smem_bytes<T>(b);
  cudaError_t err = cudaFuncSetAttribute(
      diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int kb = 0; kb < np; kb += b) {
    T* Akk = A + (size_t)kb * np + kb;
    diag_kernel<T><<<1, DIAG_THREADS, smem, stream>>>(Akk, np, R, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int rows = np - kb - b;
    if (rows == 0) break;
    T* P = Akk + (size_t)b * np;           // A[kb+b:, kb:kb+b]
    const dim3 panel_grid((b + BN - 1) / BN, (rows + BM - 1) / BM);
    panel_kernel<T><<<panel_grid, GEMM_THREADS, 0, stream>>>(P, np, R, xbuf,
                                                             rows, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const unsigned sblocks = (unsigned)(((size_t)rows * b + 255) / 256);
    scale_kernel<T><<<sblocks, 256, 0, stream>>>(xbuf, Akk, P, np, rows, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 trail_grid((rows + BN - 1) / BN, (rows + BM - 1) / BM);
    trailing_kernel<T><<<trail_grid, GEMM_THREADS, 0, stream>>>(
        P + b, P, xbuf, np, rows, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: A (np × np, row-major, in place), R (b × b scratch), xbuf
// ((np − b) × b scratch)
int dense_ldlt_f32(void* A, void* R, void* xbuf, int np, int b, void* stream) {
  return factorize<float>((float*)A, (float*)R, (float*)xbuf, np, b,
                          (cudaStream_t)stream);
}

int dense_ldlt_f64(void* A, void* R, void* xbuf, int np, int b, void* stream) {
  return factorize<double>((double*)A, (double*)R, (double*)xbuf, np, b,
                           (cudaStream_t)stream);
}

}  // extern "C"
