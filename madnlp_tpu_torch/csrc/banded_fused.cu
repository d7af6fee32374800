// Whole-band block-banded LDLᵀ factorize (K5) and solve (K6) for Hopper
// (sm_90a), float and double, behind a plain C interface loaded with ctypes
// by madnlp_tpu_torch/ops/banded_fused_kernels.py.
//
// Replaces the TPU kernels
//   K5  madnlp_tpu/ops/pallas_banded.py:_factorize_kernel, called by
//       _factorize_call (:251): the whole factorization in ONE kernel, the
//       block-column loop inside it, the band resident in VMEM
//   K6  madnlp_tpu/ops/pallas_banded.py:_solve_kernel, called by _solve_call
//       (:322): forward sweep with L_jj⁻¹ and the panel, z/d on the real
//       rows, backward sweep, in one kernel
//
// Band layout as in csrc/banded_ldlt.cu: band[(j*(bw+1) + k)*b*b + r*b + c]
// is entry (r, c) of block (j+k, j); band[j, 0] is lower-stored.
// invL[j*b*b + r*b + c] is entry (r, c) of L_jj⁻¹; d[j*b + r] the pivot.
//
// What bounds them on this card.
//   K5 does nb·(2/3 + 2bw + bw(bw+1))·b³ flops on ~2·band bytes: at
//   case118's geometry (b=64, bw=5, nb=10) 107 MFLOP on a 1.47 MB band read
//   and written (f32), so the card's peak would make it bound by operations.
//   But its block columns retire in strict order and it keeps the TPU
//   kernel's shape, one launch for the whole factorization, so one CTA
//   does all the work: its bound in practice is one SM's FMA rate and the
//   chain of dependent pivot steps in each diagonal block.
//   K6 reads the band and invL once per sweep: bound by bytes, and by the
//   chain of nb dependent block products in each sweep.
//
// What the design does about that (first version: simple and right).
//   K5: one CTA (512 threads) runs all nb block columns; per column it
//     (a) factors the diagonal block panel by panel with K1's diagonal step
//         (banded_diag.cuh).  Where the b×b block and its inverse fit next
//         to that step's scratch in the CTA's shared memory (b ≤ 128 in
//         float32, b ≤ 64 in float64; case118's b=64 takes 32 KB in f32),
//         they are staged there and written back; elsewhere they stay in
//         global memory (L2-resident) as in K1;
//     (b) forms X = P·L_jj⁻ᵀ over the bw·b panel rows into a scratch
//         buffer, then Lcol = X·D⁻¹ over the panel;
//     (c) applies the trailing update band[j+l, m] −= Lcol_{l+m}·X_lᵀ for
//         l = 1..bw, m = 0..bw−l (the TPU kernel's static unroll);
//     with a barrier between the phases and no grid-wide synchronisation.
//     The products of (b) and (c) are 64×64-tiled SIMT FMA loops over
//     shared-memory tiles carved from the diagonal step's scratch, summing
//     along k in the order K1's GEMMs do.  Holding the whole band on chip
//     (the TPU kernel's point) would need a cluster's distributed shared
//     memory: later work.
//   K6: the right-hand-side columns are independent, so the grid runs over
//     tiles of 8 of the kp padded columns; each CTA runs the forward sweep
//     (warp-per-row products with L_jj⁻¹ and P_j, coalesced along rows),
//     the scaling of the real rows by 1/d, and the backward sweep
//     (column-parallel partial sums for the transposed products) for its
//     tile.  k = 1 pads to 8 columns: one CTA.
//   All products are full-precision FMA loops (no tensor cores, no TF32).
//   A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel.
//   Overhang columns (blocks >= nb) receive trailing updates but are never
//   factored; their invL and d keep what the caller put there.
//   Kernels allocate nothing; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "banded_diag.cuh"

namespace {

constexpr int TILE = 64, TILE_K = 16;
constexpr int SOLVE_COLS = 8, FSOLVE_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;   // 227 KB: what one CTA may use

// C[M×N] (ldc)  =  or  -=  A[M×K] (lda) · B[N×K]ᵀ (ldb), by the whole CTA
// (DIAG_THREADS threads) over 64×64 output tiles; sm holds two
// TILE_K×(TILE+1) tiles.  Each output sums along k in order, as K1's
// gemm_nt_tile does.  Ends after a barrier.
template <typename T>
__device__ void cta_gemm_nt(const T* __restrict__ A, int lda,
                            const T* __restrict__ B, int ldb,
                            T* __restrict__ C, int ldc, int M, int N, int K,
                            bool subtract, T* __restrict__ sm) {
  T* As = sm;                         // [TILE_K][TILE + 1]
  T* Bs = sm + TILE_K * (TILE + 1);   // [TILE_K][TILE + 1]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;     // 16 × 32 threads
  const int tiles_n = (N + TILE - 1) / TILE;
  const int tiles = ((M + TILE - 1) / TILE) * tiles_n;
  for (int t = 0; t < tiles; ++t) {
    const int m0 = (t / tiles_n) * TILE, n0 = (t % tiles_n) * TILE;
    T acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0 = 0; k0 < K; k0 += TILE_K) {
      for (int e = tid; e < TILE * TILE_K; e += DIAG_THREADS) {
        const int r = e / TILE_K, k = e % TILE_K;
        const int gk = k0 + k;
        As[k * (TILE + 1) + r] = (m0 + r < M && gk < K)
                                     ? A[(size_t)(m0 + r) * lda + gk] : T(0);
        Bs[k * (TILE + 1) + r] = (n0 + r < N && gk < K)
                                     ? B[(size_t)(n0 + r) * ldb + gk] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) {
        T a[2], bb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = As[k * (TILE + 1) + ty + 32 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[k * (TILE + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bb[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + ty + 32 * i;
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
  __syncthreads();
}

// Shared memory of K5: the diagonal step's scratch (which also holds the
// GEMM tiles), plus the staged diagonal block and its inverse.
template <typename T>
size_t fused_scratch_elems(int b) {
  const size_t gemm = 2 * TILE_K * (TILE + 1);
  const size_t diag = diag_smem_bytes<T>(b) / sizeof(T);
  return diag > gemm ? diag : gemm;
}

template <typename T>
bool fused_staged(int b) {
  return (fused_scratch_elems<T>(b) + 2 * (size_t)b * b) * sizeof(T) <=
         MAX_SMEM;
}

// K5: the whole factorization of block columns 0..nb-1 in one CTA.
template <typename T>
__global__ void __launch_bounds__(DIAG_THREADS, 1)
fused_factorize_kernel(T* __restrict__ band, T* __restrict__ invL,
                       T* __restrict__ d, T* __restrict__ xbuf, int nb,
                       int b, int bw, size_t scratch_elems, int staged) {
  extern __shared__ unsigned char smem_raw[];
  T* scratch = reinterpret_cast<T*>(smem_raw);
  T* sA = scratch + scratch_elems;
  T* sR = sA + b * b;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t bb = (size_t)b * b;
  const size_t colstride = (size_t)(bw + 1) * bb;
  const int rows = bw * b;

  for (int j = 0; j < nb; ++j) {
    T* col = band + (size_t)j * colstride;
    T* iL = invL + (size_t)j * bb;
    T* dj = d + (size_t)j * b;
    // (a) the diagonal block: LDLᵀ in place, L_jj⁻¹
    T* A = col;
    T* R = iL;
    if (staged) {
      for (size_t e = tid; e < bb; e += nt) sA[e] = col[e];
      __syncthreads();
      A = sA;
      R = sR;
    }
    diag_ldlt_block(A, R, dj, b, scratch);
    if (staged) {
      for (size_t e = tid; e < bb; e += nt) {
        col[e] = sA[e];
        iL[e] = sR[e];
      }
    }
    // (b) X = P · L_jj⁻ᵀ, then Lcol = X · D⁻¹ written over P
    cta_gemm_nt(col + bb, b, R, b, xbuf, b, rows, b, b, false, scratch);
    for (size_t e = tid; e < (size_t)rows * b; e += nt) {
      col[bb + e] = xbuf[e] / pivot_div(dj[e % b]);
    }
    __syncthreads();
    // (c) trailing update of the next bw block columns
    for (int l = 1; l <= bw; ++l) {
      for (int m = 0; m <= bw - l; ++m) {
        cta_gemm_nt(col + (size_t)(l + m) * bb, b, xbuf + (size_t)(l - 1) * bb,
                    b, band + ((size_t)(j + l) * (bw + 1) + m) * bb, b, b, b,
                    b, true, scratch);
      }
    }
  }
}

// K6: both sweeps for one tile of SOLVE_COLS right-hand-side columns, in
// place on x ((nb+bw)·b × kp, row-major).  Shared memory: rs, z (b ×
// SOLVE_COLS each), part (FSOLVE_THREADS × SOLVE_COLS).
template <typename T>
__global__ void __launch_bounds__(FSOLVE_THREADS, 1)
fused_solve_kernel(const T* __restrict__ band, const T* __restrict__ invL,
                   const T* __restrict__ d, T* __restrict__ x, int nb, int b,
                   int bw, int kp) {
  constexpr int CT = SOLVE_COLS;
  extern __shared__ unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* z = rs + b * CT;
  T* part = z + b * CT;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nt / 32;
  const int c0 = blockIdx.x * CT;
  const size_t bb = (size_t)b * b;
  const size_t colstride = (size_t)(bw + 1) * bb;
  const int rows = bw * b;
  x += c0;

  // forward sweep: z_j = invL_j·r_j, r_{j+1..j+bw} −= P_j·z_j
  for (int j = 0; j < nb; ++j) {
    const T* iL = invL + (size_t)j * bb;
    const T* Pj = band + (size_t)j * colstride + bb;
    T* xj = x + (size_t)j * b * kp;
    for (int e = tid; e < b * CT; e += nt) rs[e] = xj[(size_t)(e / CT) * kp + e % CT];
    __syncthreads();
    for (int i = warp; i < b; i += nwarps) {
      T acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = 0;
      for (int q = lane; q < b; q += 32) {
        const T a = iL[(size_t)i * b + q];
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[c] += a * rs[q * CT + c];
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          z[i * CT + c] = acc[c];
          xj[(size_t)i * kp + c] = acc[c];
        }
      }
    }
    __syncthreads();
    T* xn = x + (size_t)(j + 1) * b * kp;
    for (int i = warp; i < rows; i += nwarps) {
      T acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = 0;
      for (int q = lane; q < b; q += 32) {
        const T a = Pj[(size_t)i * b + q];
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[c] += a * z[q * CT + c];
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) xn[(size_t)i * kp + c] -= acc[c];
      }
    }
    __syncthreads();
  }

  // z / d over the real rows
  for (int e = tid; e < nb * b * CT; e += nt) {
    const int r = e / CT;
    x[(size_t)r * kp + e % CT] /= pivot_div(d[r]);
  }
  __syncthreads();

  // backward sweep: x_j = invL_jᵀ (w_j − P_jᵀ x_{j+1..j+bw})
  const int slices = nt / b;          // b divides FSOLVE_THREADS
  const int q = tid % b, s = tid / b;
  for (int j = nb - 1; j >= 0; --j) {
    const T* iL = invL + (size_t)j * bb;
    const T* Pj = band + (size_t)j * colstride + bb;
    T* xj = x + (size_t)j * b * kp;
    const T* xn = x + (size_t)(j + 1) * b * kp;
    T acc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = 0;
    for (int i = s; i < rows; i += slices) {
      const T a = Pj[(size_t)i * b + q];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] += a * xn[(size_t)i * kp + c];
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) part[tid * CT + c] = acc[c];
    __syncthreads();
    if (tid < b) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        T t = 0;
        for (int u = 0; u < slices; ++u) t += part[(u * b + tid) * CT + c];
        z[tid * CT + c] = xj[(size_t)tid * kp + c] - t;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = 0;
    for (int i = s; i < b; i += slices) {
      const T a = iL[(size_t)i * b + q];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] += a * z[i * CT + c];
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) part[tid * CT + c] = acc[c];
    __syncthreads();
    if (tid < b) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        T t = 0;
        for (int u = 0; u < slices; ++u) t += part[(u * b + tid) * CT + c];
        xj[(size_t)tid * kp + c] = t;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int fused_factorize(T* band, T* invL, T* d, T* xbuf, int nb, int b, int bw,
                    cudaStream_t stream) {
  const int staged = fused_staged<T>(b) ? 1 : 0;
  const size_t scratch = fused_scratch_elems<T>(b);
  const size_t smem = (scratch + (staged ? 2 * (size_t)b * b : 0)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_factorize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_factorize_kernel<T><<<1, DIAG_THREADS, smem, stream>>>(
      band, invL, d, xbuf, nb, b, bw, scratch, staged);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_solve(const T* band, const T* invL, const T* d, T* x, int nb, int b,
                int bw, int kp, cudaStream_t stream) {
  const size_t smem =
      (2 * (size_t)b * SOLVE_COLS + (size_t)FSOLVE_THREADS * SOLVE_COLS) *
      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_solve_kernel<T><<<kp / SOLVE_COLS, FSOLVE_THREADS, smem, stream>>>(
      band, invL, d, x, nb, b, bw, kp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5
int banded_fused_factorize_f32(void* band, void* invL, void* d, void* xbuf,
                               int nb, int b, int bw, void* stream) {
  return fused_factorize<float>((float*)band, (float*)invL, (float*)d,
                                (float*)xbuf, nb, b, bw, (cudaStream_t)stream);
}

int banded_fused_factorize_f64(void* band, void* invL, void* d, void* xbuf,
                               int nb, int b, int bw, void* stream) {
  return fused_factorize<double>((double*)band, (double*)invL, (double*)d,
                                 (double*)xbuf, nb, b, bw,
                                 (cudaStream_t)stream);
}

// Whether K5 stages the diagonal block and its inverse in shared memory at
// block size b (itemsize 4 or 8).
int banded_fused_staged(int b, int itemsize) {
  return itemsize == 4 ? fused_staged<float>(b) : fused_staged<double>(b);
}

// K6
int banded_fused_solve_f32(void* band, void* invL, void* d, void* x, int nb,
                           int b, int bw, int kp, void* stream) {
  return fused_solve<float>((const float*)band, (const float*)invL,
                            (const float*)d, (float*)x, nb, b, bw, kp,
                            (cudaStream_t)stream);
}

int banded_fused_solve_f64(void* band, void* invL, void* d, void* x, int nb,
                           int b, int bw, int kp, void* stream) {
  return fused_solve<double>((const double*)band, (const double*)invL,
                             (const double*)d, (double*)x, nb, b, bw, kp,
                             (cudaStream_t)stream);
}

}  // extern "C"
