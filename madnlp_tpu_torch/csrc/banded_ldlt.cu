// Block-banded unpivoted LDLᵀ factorize (K1) and solve (K2) for Hopper
// (sm_90a), and their batched forms (K3, K4) over B same-geometry systems,
// float and double, behind a plain C interface loaded with ctypes by
// madnlp_tpu_torch/ops/banded_kernels.py.
//
// Replaces the TPU kernels
//   K1  madnlp_tpu/ops/pallas_banded_stream.py:_stream_factorize_kernel
//       (with madnlp_tpu/ops/pallas_banded.py:_ldlt_with_inverse for each
//       diagonal block), called by _stream_factorize_call
//   K2  madnlp_tpu/ops/pallas_banded_stream.py:_stream_solve_kernel,
//       called by _stream_solve_call
//   K3  madnlp_tpu/ops/pallas_banded_stream.py:_stream_factorize_call_batched
//       (K1's body on a sequential batch grid, what jax.vmap maps K1 onto)
//   K4  madnlp_tpu/ops/pallas_banded_stream.py:_stream_solve_call_batched
//
// Band layout (row-major): band[(j*(bw+1) + k)*b*b + r*b + c] is entry (r, c)
// of block (j+k, j) of the permuted matrix; band[j, 0] is lower-stored.
// invL[j*b*b + r*b + c] is entry (r, c) of L_jj⁻¹; d[j*b + r] the pivot.
//
// What bounds them on this card.
//   K1 does ~nb·(5/6 + bw + bw²)·2b³ flops on ~2·band bytes: at the flagship
//   geometry (b=256, bw=2, nb=11) 2.5 GFLOP on 24 MB, so it is bound by
//   operations (f32/f64 outside the tensor cores: TF32 is ruled out, the
//   factor must be true f32).  But the block columns retire in strict order
//   and each begins with the b×b diagonal LDLᵀ, a chain of b dependent pivot
//   steps, so in practice the sequential diagonal step bounds it.
//   K2 reads band and invL once per sweep: bound by bytes, but again a chain
//   of nb dependent block mat-vecs.
//
// What the design does about that.
//   K1: the host loops over block columns; per column it launches
//     (a) one CTA that factors the diagonal block panel by panel (p = 32)
//         with diag_ldlt_block_tiled (banded_diag.cuh, whose note has the
//         details): the b×b block itself (256 KB in f32, 512 KB in f64 at
//         b = 256) does not fit the 227 KB a CTA can use, so it stays in
//         global memory (L2-resident) and each panel's operands are staged
//         in shared memory by cp.async while warp 0 runs the 32×64 corner
//         recursion; the panel, L⁻¹-accumulation, trailing and R products
//         run on 4×4 register micro-tiles, one 16-byte operand load per 16
//         FMAs, the trailing one over the lower triangle's tiles only.  It
//         is bound by one SM's FMA rate and the chain of b/32 panels, and
//         its factor is bit for bit the scalar routine's (diag_ldlt_block,
//         which K5 keeps);
//     (b) a tiled SIMT GEMM  X = P·L_jj⁻ᵀ  over the panel rows into scratch,
//     (c) Lcol = X·D⁻¹ written over P, and
//     (d) a tiled SIMT GEMM over the (l, m, tile) grid for the trailing
//         update  band[j+l, m] −= Lcol_{l+m}·X_lᵀ,
//     spreading (b)-(d) over many SMs.
//   K2: one CTA runs both sweeps (1024 threads, warp-per-row dot products
//     for L⁻¹ and P, column-parallel partial sums for the transposed
//     products); it needs no grid-wide synchronisation.
//   All products are full-precision FMA loops (no tensor cores, no TF32).
//   A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel: the
//   inertia that drives the IPM's regularization ladder must match exactly.
//   Overhang columns c >= nb are updated but never factored.
//   Kernels allocate nothing; every entry point returns cudaGetLastError().
//
// The batched kernels K3 and K4 run the same __global__ bodies with a lane
// index: every kernel takes the lane strides of its arrays and an optional
// active mask (int32 per lane; null for K1/K2, whose launches have one lane
// and zero strides).  A CTA of an inactive lane returns at once, so its
// band, invL, d and right-hand side stay exactly as they were: that is how
// the solver's masked δ-regularization ladder and its finished lanes cost
// nothing and never overwrite a factor still in use.
//   K3 is bound by operations: B times K1's, 1.969 GFLOP per lane at the
//   flagship geometry.  Per block column it issues K1's four launches with
//   a lane dimension in every grid: the diagonal step as one CTA per lane
//   (B CTAs side by side on B SMs, where K1 leaves 131 SMs idle), the panel
//   and trailing GEMM grids with the lane folded into blockIdx.z, the D⁻¹
//   scaling with the lane in blockIdx.y.  Launches per factorization stay
//   4·nb whatever B is.
//   K4 is bound by bytes: B times K2's, 8.69 MB per lane at the flagship
//   geometry.  Its grid is (B,): one CTA per lane runs both sweeps of its
//   lane, the lanes side by side on separate SMs.

#include <cuda_runtime.h>
#include <math.h>

#include "banded_diag.cuh"

namespace {

constexpr int SOLVE_THREADS = 1024;

// Lane of this CTA (grid dimension given by the caller); false if the
// active mask switches the lane off.
__device__ __forceinline__ bool lane_on(const int* __restrict__ active,
                                        int lane) {
  return active == nullptr || active[lane] != 0;
}

// (a) LDLᵀ + L⁻¹ of one lower-stored b×b block A (ld = b), in place, by
// diag_ldlt_block_tiled (banded_diag.cuh): A <- strict-lower L + diag(d)
// (upper zero), R <- L⁻¹, dout <- d.  One CTA per lane (blockIdx.x); lane
// strides sA, sR, sd.  One CTA per SM at most (its shared memory sees to
// that): the bound lets ptxas use the registers a single resident CTA
// leaves free.  With TILED = false it runs the scalar routine
// diag_ldlt_block instead, which the tiled one equals bit for bit (only
// the diag_step entry launches that form, to hold the two against each
// other).
template <typename T, bool TILED>
__global__ void __launch_bounds__(DIAG_THREADS, 1)
diag_ldlt_kernel(T* __restrict__ A, T* __restrict__ R, T* __restrict__ dout,
                 int b, size_t sA, size_t sR, size_t sd,
                 const int* __restrict__ active) {
  const int lane_idx = blockIdx.x;
  if (!lane_on(active, lane_idx)) return;
  extern __shared__ __align__(16) unsigned char diag_smem[];
  T* sm = reinterpret_cast<T*>(diag_smem);
  if constexpr (TILED) {
    diag_ldlt_block_tiled(A + lane_idx * sA, R + lane_idx * sR,
                          dout + lane_idx * sd, b, sm);
  } else {
    diag_ldlt_block(A + lane_idx * sA, R + lane_idx * sR,
                    dout + lane_idx * sd, b, sm);
  }
}

// Shared memory of diag_ldlt_kernel<T, TILED>, in bytes, after raising the
// kernel's dynamic shared-memory limit to it; 0 if that was refused.
template <typename T, bool TILED>
size_t diag_kernel_smem(int b, cudaError_t* err) {
  const size_t smem = TILED ? diag_tiled_smem_bytes<T>(b)
                            : diag_smem_bytes<T>(b);
  *err = cudaFuncSetAttribute(diag_ldlt_kernel<T, TILED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  return *err == cudaSuccess ? smem : 0;
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

// Lane strides of the factorization's arrays, in elements.
struct FactorStrides {
  size_t band, invL, d, x;
};

// (b) X = P · invL_jᵀ with P = band[j, 1..bw] as a (bw·b)×b matrix;
// blockIdx.z is the lane
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
panel_kernel(const T* __restrict__ P, const T* __restrict__ iL,
             T* __restrict__ X, int rows, int b, FactorStrides s,
             const int* __restrict__ active) {
  const int lane_idx = blockIdx.z;
  if (!lane_on(active, lane_idx)) return;
  gemm_nt_tile(P + lane_idx * s.band, b, iL + lane_idx * s.invL, b,
               X + lane_idx * s.x, b, rows, b, b, false,
               blockIdx.y * BM, blockIdx.x * BN);
}

// (c) Lcol = X / d, written over P; blockIdx.y is the lane
template <typename T>
__global__ void scale_kernel(const T* __restrict__ X, const T* __restrict__ dj,
                             T* __restrict__ P, int rows, int b,
                             FactorStrides s, const int* __restrict__ active) {
  const int lane_idx = blockIdx.y;
  if (!lane_on(active, lane_idx)) return;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * b) return;
  X += lane_idx * s.x;
  dj += lane_idx * s.d;
  P += lane_idx * s.band;
  P[e] = X[e] / pivot_div(dj[e % b]);
}

// (d) band[j+l, m] -= Lcol_{l+m} · X_lᵀ for l = 1..bw, m = 0..bw-l;
// blockIdx.z enumerates the (lane, (l, m)) pairs, lane-major
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
trailing_kernel(T* __restrict__ band, const T* __restrict__ X, int j, int b,
                int bw, FactorStrides s, const int* __restrict__ active) {
  const int npairs = bw * (bw + 1) / 2;
  const int lane_idx = blockIdx.z / npairs;
  if (!lane_on(active, lane_idx)) return;
  band += lane_idx * s.band;
  X += lane_idx * s.x;
  int z = blockIdx.z % npairs, l = 1;
  while (z > bw - l) {
    z -= bw - l + 1;
    ++l;
  }
  const int m = z;
  const size_t bb = (size_t)b * b;
  const T* Lcol = band + ((size_t)j * (bw + 1) + l + m) * bb;
  const T* Xl = X + (size_t)(l - 1) * bb;
  T* C = band + ((size_t)(j + l) * (bw + 1) + m) * bb;
  gemm_nt_tile(Lcol, b, Xl, b, C, b, b, b, b, true,
               blockIdx.y * BM, blockIdx.x * BN);
}

// K1 (lanes = 1, active = null) and K3: the host loops over block columns
// and launches, per column, the four steps for every lane at once.
template <typename T>
int factorize(T* band, T* invL, T* d, T* xbuf, const int* active, int lanes,
              FactorStrides s, int nb, int b, int bw, cudaStream_t stream) {
  cudaError_t err;
  const size_t smem = diag_kernel_smem<T, true>(b, &err);
  if (err != cudaSuccess) return (int)err;
  const size_t bb = (size_t)b * b;
  const int rows = bw * b;
  const dim3 panel_grid((b + BN - 1) / BN, (rows + BM - 1) / BM, lanes);
  const dim3 trail_grid((b + BN - 1) / BN, (b + BM - 1) / BM,
                        lanes * (bw * (bw + 1) / 2));
  const dim3 scale_grid((unsigned)(((size_t)rows * b + 255) / 256), lanes);
  for (int j = 0; j < nb; ++j) {
    T* col = band + (size_t)j * (bw + 1) * bb;
    diag_ldlt_kernel<T, true><<<lanes, DIAG_THREADS, smem, stream>>>(
        col, invL + (size_t)j * bb, d + (size_t)j * b, b, s.band, s.invL,
        s.d, active);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    panel_kernel<T><<<panel_grid, GEMM_THREADS, 0, stream>>>(
        col + bb, invL + (size_t)j * bb, xbuf, rows, b, s, active);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scale_kernel<T><<<scale_grid, 256, 0, stream>>>(
        xbuf, d + (size_t)j * b, col + bb, rows, b, s, active);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    trailing_kernel<T><<<trail_grid, GEMM_THREADS, 0, stream>>>(
        band, xbuf, j, b, bw, s, active);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K2 (grid 1) and K4 (grid B, one CTA per lane): both sweeps in one CTA,
// in place on the lane's rhs ((nb+bw)·b × k, row-major).
// Shared memory: rs (b·k), z (b·k), part (SOLVE_THREADS).
// One CTA per SM, so that K4's lanes never share an SM's registers.
template <typename T>
__global__ void __launch_bounds__(SOLVE_THREADS, 1)
solve_kernel(const T* __restrict__ band, const T* __restrict__ invL,
             const T* __restrict__ d, T* __restrict__ rhs, int nb, int b,
             int bw, int k, size_t s_band, size_t s_invL, size_t s_d,
             size_t s_rhs, const int* __restrict__ active) {
  const int lane_idx = blockIdx.x;
  if (!lane_on(active, lane_idx)) return;
  band += lane_idx * s_band;
  invL += lane_idx * s_invL;
  d += lane_idx * s_d;
  rhs += lane_idx * s_rhs;
  extern __shared__ unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* z = rs + b * k;
  T* part = z + b * k;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nt / 32;
  const size_t bb = (size_t)b * b;
  const size_t colstride = (size_t)(bw + 1) * bb;
  const int rows = bw * b;

  // forward sweep with D⁻¹ fused
  for (int j = 0; j < nb; ++j) {
    const T* iL = invL + (size_t)j * bb;
    const T* Pj = band + (size_t)j * colstride + bb;
    T* rj = rhs + (size_t)j * b * k;
    for (int e = tid; e < b * k; e += nt) rs[e] = rj[e];
    __syncthreads();
    for (int i = warp; i < b; i += nwarps) {
      for (int c = 0; c < k; ++c) {
        T acc = 0;
        for (int q = lane; q < b; q += 32) acc += iL[(size_t)i * b + q] * rs[q * k + c];
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) z[i * k + c] = acc;
      }
    }
    __syncthreads();
    T* rn = rhs + (size_t)(j + 1) * b * k;
    for (int i = warp; i < rows; i += nwarps) {
      for (int c = 0; c < k; ++c) {
        T acc = 0;
        for (int q = lane; q < b; q += 32) acc += Pj[(size_t)i * b + q] * z[q * k + c];
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) rn[i * k + c] -= acc;
      }
    }
    for (int e = tid; e < b * k; e += nt) rj[e] = z[e] / pivot_div(d[(size_t)j * b + e / k]);
    __syncthreads();
  }
  for (int e = tid; e < rows * k; e += nt) rhs[(size_t)nb * b * k + e] = T(0);
  __syncthreads();

  // backward sweep: x_j = invL_jᵀ (w_j - P_jᵀ x_{j+1..j+bw})
  const int slices = nt / b;          // b divides SOLVE_THREADS
  const int q = tid % b, s = tid / b;
  for (int j = nb - 1; j >= 0; --j) {
    const T* iL = invL + (size_t)j * bb;
    const T* Pj = band + (size_t)j * colstride + bb;
    T* wj = rhs + (size_t)j * b * k;
    const T* xn = rhs + (size_t)(j + 1) * b * k;
    for (int c = 0; c < k; ++c) {
      T acc = 0;
      for (int i = s; i < rows; i += slices) acc += Pj[(size_t)i * b + q] * xn[i * k + c];
      part[tid] = acc;
      __syncthreads();
      if (tid < b) {
        T t = 0;
        for (int u = 0; u < slices; ++u) t += part[u * b + tid];
        z[tid * k + c] = wj[tid * k + c] - t;
      }
      __syncthreads();
    }
    for (int c = 0; c < k; ++c) {
      T acc = 0;
      for (int i = s; i < b; i += slices) acc += iL[(size_t)i * b + q] * z[i * k + c];
      part[tid] = acc;
      __syncthreads();
      if (tid < b) {
        T t = 0;
        for (int u = 0; u < slices; ++u) t += part[u * b + tid];
        wj[tid * k + c] = t;
      }
      __syncthreads();
    }
  }
}

template <typename T>
int solve(const T* band, const T* invL, const T* d, T* rhs, const int* active,
          int lanes, int nb, int b, int bw, int k, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)b * k + SOLVE_THREADS) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t nbp = (size_t)nb + bw;
  solve_kernel<T><<<lanes, SOLVE_THREADS, smem, stream>>>(
      band, invL, d, rhs, nb, b, bw, k, nbp * (bw + 1) * b * b,
      nbp * b * b, (size_t)nb * b, nbp * b * k, active);
  return (int)cudaGetLastError();
}

// The diagonal step alone on `lanes` contiguous blocks A (lanes, b, b), R
// (lanes, b, b), dout (lanes, b): the tiled routine K1 and K3 run, or
// (tiled = 0) the scalar one.
template <typename T>
int diag_step(T* A, T* R, T* dout, int lanes, int b, int tiled,
              cudaStream_t stream) {
  cudaError_t err;
  const size_t bb = (size_t)b * b;
  if (tiled) {
    const size_t smem = diag_kernel_smem<T, true>(b, &err);
    if (err != cudaSuccess) return (int)err;
    diag_ldlt_kernel<T, true><<<lanes, DIAG_THREADS, smem, stream>>>(
        A, R, dout, b, bb, bb, b, nullptr);
  } else {
    const size_t smem = diag_kernel_smem<T, false>(b, &err);
    if (err != cudaSuccess) return (int)err;
    diag_ldlt_kernel<T, false><<<lanes, DIAG_THREADS, smem, stream>>>(
        A, R, dout, b, bb, bb, b, nullptr);
  }
  return (int)cudaGetLastError();
}

// Lane strides of K3's arrays: band (B, nbp, bw+1, b, b), invL (B, nbp, b,
// b), d (B, nb·b), xbuf (B, bw·b, b).
FactorStrides batched_strides(int nb, int b, int bw) {
  const size_t nbp = (size_t)nb + bw, bb = (size_t)b * b;
  return FactorStrides{nbp * (bw + 1) * bb, nbp * bb, (size_t)nb * b,
                       (size_t)bw * bb};
}

}  // namespace

extern "C" {

// K1
int banded_factorize_f32(void* band, void* invL, void* d, void* xbuf, int nb,
                         int b, int bw, void* stream) {
  return factorize<float>((float*)band, (float*)invL, (float*)d, (float*)xbuf,
                          nullptr, 1, FactorStrides{0, 0, 0, 0}, nb, b, bw,
                          (cudaStream_t)stream);
}

int banded_factorize_f64(void* band, void* invL, void* d, void* xbuf, int nb,
                         int b, int bw, void* stream) {
  return factorize<double>((double*)band, (double*)invL, (double*)d,
                           (double*)xbuf, nullptr, 1,
                           FactorStrides{0, 0, 0, 0}, nb, b, bw,
                           (cudaStream_t)stream);
}

// K2
int banded_solve_f32(void* band, void* invL, void* d, void* rhs, int nb, int b,
                     int bw, int k, void* stream) {
  return solve<float>((const float*)band, (const float*)invL, (const float*)d,
                      (float*)rhs, nullptr, 1, nb, b, bw, k,
                      (cudaStream_t)stream);
}

int banded_solve_f64(void* band, void* invL, void* d, void* rhs, int nb, int b,
                     int bw, int k, void* stream) {
  return solve<double>((const double*)band, (const double*)invL,
                       (const double*)d, (double*)rhs, nullptr, 1, nb, b, bw,
                       k, (cudaStream_t)stream);
}

// K3
int banded_factorize_batched_f32(void* band, void* invL, void* d, void* xbuf,
                                 void* active, int lanes, int nb, int b,
                                 int bw, void* stream) {
  return factorize<float>((float*)band, (float*)invL, (float*)d, (float*)xbuf,
                          (const int*)active, lanes,
                          batched_strides(nb, b, bw), nb, b, bw,
                          (cudaStream_t)stream);
}

int banded_factorize_batched_f64(void* band, void* invL, void* d, void* xbuf,
                                 void* active, int lanes, int nb, int b,
                                 int bw, void* stream) {
  return factorize<double>((double*)band, (double*)invL, (double*)d,
                           (double*)xbuf, (const int*)active, lanes,
                           batched_strides(nb, b, bw), nb, b, bw,
                           (cudaStream_t)stream);
}

// K4
int banded_solve_batched_f32(void* band, void* invL, void* d, void* rhs,
                             void* active, int lanes, int nb, int b, int bw,
                             int k, void* stream) {
  return solve<float>((const float*)band, (const float*)invL, (const float*)d,
                      (float*)rhs, (const int*)active, lanes, nb, b, bw, k,
                      (cudaStream_t)stream);
}

int banded_solve_batched_f64(void* band, void* invL, void* d, void* rhs,
                             void* active, int lanes, int nb, int b, int bw,
                             int k, void* stream) {
  return solve<double>((const double*)band, (const double*)invL,
                       (const double*)d, (double*)rhs, (const int*)active,
                       lanes, nb, b, bw, k, (cudaStream_t)stream);
}

// the diagonal step of K1 / K3 alone
int banded_diag_step_f32(void* A, void* R, void* d, int lanes, int b,
                         int tiled, void* stream) {
  return diag_step<float>((float*)A, (float*)R, (float*)d, lanes, b, tiled,
                          (cudaStream_t)stream);
}

int banded_diag_step_f64(void* A, void* R, void* d, int lanes, int b,
                         int tiled, void* stream) {
  return diag_step<double>((double*)A, (double*)R, (double*)d, lanes, b,
                           tiled, (cudaStream_t)stream);
}

}  // extern "C"
