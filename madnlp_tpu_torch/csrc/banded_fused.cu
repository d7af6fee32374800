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
//   In practice its block columns retire in strict order, each behind the
//   chain of pivots of its diagonal block, and one launch has to carry
//   the whole chain.
//   K6 reads P_j and invL_j once per sweep: bound by bytes, and by the
//   chain of nb dependent block products in each sweep.
//
// What the design does about that.  Both run over ONE thread-block
// cluster per launch (per right-hand-side tile in K6), C ≤ 16 CTAs on as
// many SMs, with the launch plan of ops/banded_fused_kernels.py
// (fused_factorize_plan, fused_solve_plan).
//   K5 (cluster_factorize_kernel): per block column j, between cluster
//     barriers (barrier.cluster, release/acquire at cluster scope; no
//     grid-wide synchronisation):
//     (a) panel: X_l = P_l·L_jj⁻ᵀ for l = 1..bw, its 64×64 output tiles
//         dealt over the CTAs;
//     (b) look-ahead: the tiles of the next diagonal block's update
//         band[j+1, 0] −= Lcol_1·X_1ᵀ, and Lcol_l = X_l·D⁻¹ written over
//         P_l;
//     (c) CTA 0 factors the next diagonal block (LDLᵀ and L⁻¹ by
//         diag_ldlt_block_tiled, banded_diag.cuh, unchanged) while the
//         other CTAs run the rest of the trailing update band[j+l, m] −=
//         Lcol_{l+m}·X_lᵀ, every tile of every (l, m) side by side.
//     Where a product is one tile (b ≤ 64), CTA 0 runs the chain X_1 →
//     (b)'s update → (c)'s diagonal step alone, between the halves of a
//     split cluster barrier, and the others wait only for X_1: one
//     barrier a column on the chain instead of three.  The diagonal step
//     sets the time: on case118's band it is most of each column's.
//     The products are 64×64 tiles of register-tiled SIMT FMA (2×4
//     outputs a thread), their operands staged in shared memory 32 k at
//     a time, the next slice loaded into registers while the current one
//     is multiplied; Lcol is formed as X/d while it is staged.  Where the
//     plan finds room (b ≤ 64 in float32, case118's band included: the
//     TPU kernel's fits_vmem domain), the off-diagonal blocks and the
//     panel X live in the cluster's distributed shared memory from the
//     first load to the one write back, each block in its owner CTA,
//     read and written by the others through DSMEM; the diagonal blocks
//     go through L2, where the diagonal step works.  Elsewhere every
//     block stays in global memory (L2) and X in a scratch buffer.
//   K6 (cluster_fused_solve_kernel): the cluster solve of K2
//     (banded_ldlt.cu: rows of invL_j and P_j split over the CTAs in the
//     forward sweep, columns in the backward one, r_j, z_j and the window
//     of x exchanged by st.async into the other CTAs' shared memory and
//     counted on their mbarriers, the factor's slices copied by TMA), on
//     a grid of clusters, one per tile of right-hand-side columns.  Where
//     a CTA's slices of the whole factor fit its shared memory (case118
//     in float32), every copy is issued before the forward chain starts
//     and both sweeps read the factor from shared memory; elsewhere a
//     ring of stages streams it ahead of the chain, as in K2.
//   Both equal the one-CTA kernels they replaced bit for bit, which stay
//   beside them as
//   their card-side witnesses (fused_factorize_kernel, fused_solve_kernel):
//   every output element keeps its one accumulator and its order of terms
//   (K5: Σ_k in order from 0, then C − acc or X/d, the diagonal step bit
//   for bit the scalar routine; K6: lane-strided dot products and their
//   shuffle tree forward, FSOLVE_THREADS / b strided chains summed in
//   order backward), the same FMA contraction, division and subtraction,
//   and the overhang rows of x as the witness leaves them.  Only which
//   CTA, warp and thread computes an element, and when, changes.
//   All products are full-precision FMA loops (no tensor cores, no TF32).
//   A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel.
//   Overhang columns (blocks >= nb) receive trailing updates but are never
//   factored; their invL and d keep what the caller put there.
//   Kernels allocate nothing; every entry point returns cudaGetLastError().
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
// case118_timing, float32, case118's last KKT band, in turns): K5 0.389 ms
// (its witness 1.930, K1 0.484), K6 on one right-hand side 0.0623 ms (its
// witness 0.552, K2 0.0633); 0.41% and 0.48% of their bounds.  K5 waits on
// its ten diagonal steps, K6 on its chain of exchanges, as K2 does.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "banded_cluster.cuh"
#include "banded_diag.cuh"

namespace {

constexpr size_t SMEM_LIMIT = 232448;   // 227 KB: what one CTA may use
constexpr int MAX_CLUSTER = 16;

constexpr int TILE = 64, TILE_K = 16;
constexpr int SOLVE_COLS = 8, FSOLVE_THREADS = 256;

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
         SMEM_LIMIT;
}

// The witness of K5 (the one-CTA kernel K5 replaced): the whole
// factorization of block columns 0..nb-1 in one CTA.
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

// The witness of K6 (the kernel K6 replaced): both sweeps for one
// tile of SOLVE_COLS right-hand-side columns, in place on x ((nb+bw)·b ×
// kp, row-major).  Shared memory: rs, z (b ×
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
int factorize_reference(T* band, T* invL, T* d, T* xbuf, int nb, int b, int bw,
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
int solve_reference(const T* band, const T* invL, const T* d, T* x, int nb, int b,
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


// -- K6: the whole solve over a cluster per right-hand-side tile ---------------
//
// cluster_solve_kernel of csrc/banded_ldlt.cu (whose note has the
// details), changed where the witness differs from K2's reference:
//   * the backward chains are FSOLVE_THREADS / b per column, not
//     SOLVE_THREADS / b;
//   * a cluster solves the tile of k columns at column tile·k of x
//     (row stride ld), so a grid of clusters covers every tile;
//   * the overhang rows (blocks nb..nb+bw-1) keep the forward sweep's
//     updates in x, as the witness leaves them, and the backward sweep
//     reads them there (after a cluster barrier) instead of zeros;
//   * where stages == the number of chunks, the factor is resident: all
//     copies are issued at the start and none of the stages is reused.
constexpr int FUSED_THREADS = 512;
constexpr int MAX_FUSED_STAGES = 64;

// the mbarriers' bytes ahead of the stages (three for the exchanges, one
// per stage), in whole 128-byte units: the TMA writes 128-byte aligned
inline size_t fused_barrier_bytes(int stages) {
  return ((size_t)(3 + stages) * 8 + 127) / 128 * 128;
}

// Shared memory of the fused solve after its barriers, in elements: the
// stages, xw, the two zf, part.
inline size_t fused_solve_elems(int b, int bw, int k, int C, int rows,
                                int stages) {
  const size_t nr = b / C, S = FSOLVE_THREADS / b;
  return (size_t)stages * rows * b + (size_t)(bw + 3) * b * k + nr * S * k;
}

template <typename T>
struct FusedSolve {
  CUtensorMap band_f, invL_f, band_b, invL_b;
  const T* d;
  T* x;
  int nb, b, bw, k, ld;      // k columns per tile, ld the row stride of x
  int C, rows, stages, box;  // the launch plan
  int bar_bytes;
};

template <typename T, int B>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
cluster_fused_solve_kernel(const __grid_constant__ FusedSolve<T> a) {
  namespace cg = cooperative_groups;
  constexpr int S = FSOLVE_THREADS / B, LS = S == 1 ? 0 : S == 2 ? 1
                                               : S == 4 ? 2 : 3;
  constexpr int LB = B == 32 ? 5 : B == 64 ? 6 : B == 128 ? 7 : 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const T* d = a.d;
  const int nb = a.nb, bw = a.bw, k = a.k;
  const size_t ld = a.ld;
  T* rhs = a.x + (size_t)(blockIdx.x / C) * k;   // this cluster's tile
  const int nr = B / C, lnr = ilog2(nr);
  const int q0 = (int)cluster.block_rank() * nr;
  const int NS = a.stages, stage_elems = a.rows * B;
  const int frows = (bw + 1) * nr, brows = (bw + 1) * B;
  const int fsplit = nr, bsplit = bw * B;   // invL | P rows, P | invL rows
  const int per = (frows + a.rows - 1) / a.rows;
  const ChunkPlan plan{nb, per, a.rows, a.rows * C, frows, brows};
  const int total = 2 * nb * per;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nt / 32;
  const unsigned FULL = 0xffffffffu;
  const unsigned XBYTES = (unsigned)(B * k * sizeof(T));   // one exchange

  extern __shared__ __align__(128) unsigned char cluster_smem[];
  // mbarriers: [0] r_{j+1} (forward) / x_j (backward), [1 + p] z_j,
  // p = j & 1; [3 + s] stage s filled
  uint64_t* bars = reinterpret_cast<uint64_t*>(cluster_smem);
  T* stage = reinterpret_cast<T*>(cluster_smem + a.bar_bytes);
  T* xw = stage + (size_t)NS * stage_elems;
  T* zf2 = xw + (size_t)(bw + 1) * k * B;
  T* part = zf2 + (size_t)2 * k * B;
  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < 3 + NS; ++i) mbar_init(smem_u32(bars + i), 1);
      fence_mbarrier_init();
    }
    __syncwarp();
    // the first NS-1 chunks in flight (all but one where resident), lane
    // i issuing chunks i, i + 32, …
    for (int t = lane; t < NS - 1 && t < total; t += 32)
      issue_chunk<T, B>(plan.at(t), stage + (size_t)t * stage_elems, a,
                        smem_u32(bars + 3 + t), 0, lnr, q0);
  }
  for (int e = tid; e < B * k; e += nt)
    xw[(e % k) * B + e / k] = rhs[(size_t)(e / k) * ld + e % k];   // r_0
  cluster.sync();
  const unsigned to_rank = lane < C ? lane : 0;
  const unsigned xw_at = mapa(smem_u32(xw), to_rank);
  const unsigned zf_at = mapa(smem_u32(zf2), to_rank);
  const unsigned xbar_at = mapa(smem_u32(bars), to_rank);
  const unsigned zbar_at = mapa(smem_u32(bars + 1), to_rank);
  unsigned xph = 0, zph[2] = {0, 0};
  auto exchanged = [&](int i, unsigned& ph) {
    if (tid == 0) mbar_expect_tx(smem_u32(bars + i), XBYTES);
    mbar_wait(smem_u32(bars + i), ph);
    ph ^= 1;
  };

  for (int t = 0; t < total; ++t) {
    bool issued = tid != nt - 32 || t + NS - 1 >= total;
    auto issue_next = [&]() {
      if (issued) return;
      issued = true;
      const int sg = (t + NS - 1) % NS;
      fence_proxy_async();
      issue_chunk<T, B>(plan.at(t + NS - 1), stage + (size_t)sg * stage_elems,
                        a, smem_u32(bars + 3 + sg), 0, lnr, q0);
    };
    const Chunk ch = plan.at(t);
    const int j = ch.j, end = ch.r0 + ch.n, p = j & 1;
    const int fmid = min(max(fsplit, ch.r0), end);
    const bool many_d = ch.fwd && (fmid - ch.r0) * k > 2 * nwarps;
    const bool many_r = ch.fwd && (end - fmid) * k > 2 * nwarps;
    T pre_d = 0, pre_r = 0;
    {
      int r, c;
      if (many_d && warp_pair(lane, ch.r0, fmid, warp, nwarps, r, c) && c < k)
        pre_d = d[(size_t)j * B + q0 + r];
      if (many_r && warp_pair(lane, fmid, end, warp, nwarps, r, c) && c < k)
        pre_r = rhs[((size_t)(j + 1 + ((r - fsplit) >> lnr)) * B + q0 +
                     ((r - fsplit) & (nr - 1))) * ld + c];
    }
    mbar_wait(smem_u32(bars + 3 + t % NS), (t / NS) & 1);   // chunk t landed
    const T* st = stage + (size_t)(t % NS) * stage_elems;
    T* zf = zf2 + (size_t)p * k * B;
    if (ch.fwd) {
      const int mid = fmid;
      if (ch.r0 < mid) {
        if (ch.r0 == 0 && j > 0) exchanged(0, xph);   // r_j
        int m = 0;
        for (int c = 0; c < k; ++c) {
          for (int r = ch.r0 + warp; r < mid; r += nwarps, ++m) {
            const int rho = q0 + r;
            const T acc = warp_dot<T, B>(st + (size_t)(r - ch.r0) * B,
                                         xw + (size_t)c * B, lane);
            const T v = __shfl_sync(FULL, acc, 0);
            if (lane < C)
              st_async(zf_at + (unsigned)(((p * k + c) * B + rho) * sizeof(T)),
                       v, zbar_at + p * 8);
            const T dv = many_d && m < 32 ? __shfl_sync(FULL, pre_d, m)
                                          : d[(size_t)j * B + rho];
            if (lane == 0) rhs[((size_t)j * B + rho) * ld + c] = v / pivot_div(dv);
          }
        }
      }
      if (mid < end) {
        if (mid == fsplit) exchanged(1 + p, zph[p]);   // z_j
        int m = 0;
        for (int c = 0; c < k; ++c) {
          for (int r = mid + warp; r < end; r += nwarps, ++m) {
            const int l = (r - fsplit) >> lnr;
            if (l > 0) issue_next();
            const int rho = q0 + ((r - fsplit) & (nr - 1));
            T* dst = rhs + ((size_t)(j + 1 + l) * B + rho) * ld + c;
            const bool pre = many_r && m < 32;
            const T old0 = !pre && lane == 0 ? *dst : T(0);
            const T acc = warp_dot<T, B>(st + (size_t)(r - ch.r0) * B,
                                         zf + (size_t)c * B, lane);
            const T old = pre ? __shfl_sync(FULL, pre_r, m) : old0;
            if (l == 0 && j + 1 < nb) {
              const T v = __shfl_sync(FULL, old - acc, 0);
              if (lane < C)
                st_async(xw_at + (unsigned)((c * B + rho) * sizeof(T)), v,
                         xbar_at);
            } else if (lane == 0) {
              // r_{j+1+l} in x; the overhang rows too, as the witness
              *dst = old - acc;
            }
          }
        }
      }
      issue_next();
      __syncthreads();
      if (end == frows && j == nb - 1) {
        // end of the forward sweep: the overhang rows of x, which every
        // CTA has written, into the x window (blocks nb..nb+bw-1)
        cluster.sync();
        for (int e = tid; e < bw * B * k; e += nt) {
          const int c = e % k, rr = e / k;
          xw[((size_t)((nb + (rr >> LB)) % (bw + 1)) * k + c) * B +
             (rr & (B - 1))] = rhs[((size_t)nb * B + rr) * ld + c];
        }
        __syncthreads();
      }
    } else {
      const int mid = min(max(bsplit, ch.r0), end);
      const bool one = nr * k <= nt;   // one final sum per thread
      issue_next();
      for (int seg = 0; seg < 2; ++seg) {
        const bool inv = seg == 1;
        const int lo = inv ? mid : ch.r0, hi = inv ? end : mid;
        if (lo >= hi) continue;
        const int base = inv ? bsplit : 0;   // first row of the part
        const bool closes = inv ? hi == brows : hi == bsplit;
        if (lo == base) {
          if (inv) exchanged(1 + p, zph[p]);        // z_j
          else if (j + 1 < nb) exchanged(0, xph);   // x_{j+1}
        }
        T wpre = 0;
        if (!inv && closes && one && tid < nr * k)
          wpre = rhs[((size_t)j * B + q0 + (tid & (nr - 1))) * ld + (tid >> lnr)];
        for (int e = tid; e < (nr * k) << LS; e += nt) {
          const int ql = e & (nr - 1), s = (e >> lnr) & (S - 1);
          const int c = e >> (lnr + LS);
          T acc = lo == base ? T(0) : part[e];
          int i = lo + ((s - (lo - base)) & (S - 1));   // i - base ≡ s (mod S)
          const T* sp = st + ((i - ch.r0) << lnr) + ql;
          const int sstep = S << lnr;
          while (i < hi) {
            const int l = inv ? 0 : i >> LB;
            const int bhi = inv ? hi : min(hi, (l + 1) << LB);
            const T* xv = inv ? zf + (size_t)c * B + (i - bsplit)
                              : xw + ((size_t)((j + 1 + l) % (bw + 1)) * k + c) * B
                                    + (i - (l << LB));
            const int n = (bhi - i + S - 1) / S;
#pragma unroll 16
            for (int u = 0; u < n; ++u, sp += sstep, xv += S) acc += *sp * *xv;
            i += n * S;
          }
          part[e] = acc;
        }
        __syncthreads();
        if (!closes) continue;
        for (int e = tid; e < nr * k; e += nt) {
          const int ql = e & (nr - 1), c = e >> lnr, q = q0 + ql;
          T t = 0;
#pragma unroll
          for (int u = 0; u < S; ++u) t += part[((c * S + u) << lnr) + ql];
          T* w = rhs + ((size_t)j * B + q) * ld + c;
          if (inv) {
            *w = t;
            if (j > 0) {
              const unsigned off = (unsigned)((((j % (bw + 1)) * k + c) * B + q)
                                              * sizeof(T));
              for (int rk = 0; rk < C; ++rk)
                st_async(mapa(smem_u32(xw), rk) + off, t,
                         mapa(smem_u32(bars), rk));
            }
          } else {
            const T v = (one ? wpre : *w) - t;
            const unsigned off = (unsigned)(((p * k + c) * B + q) * sizeof(T));
            for (int rk = 0; rk < C; ++rk)
              st_async(mapa(smem_u32(zf2), rk) + off, v,
                       mapa(smem_u32(bars + 1 + p), rk));
          }
        }
        __syncthreads();   // part[] is read
      }
      issue_next();
    }
  }
  // no CTA leaves while another may still write to its shared memory
  cluster.sync();
}

// Raise kernel's shared-memory limit to `smem` and, for clusters of more
// than 8 CTAs, allow the non-portable sizes.
template <typename K>
cudaError_t cluster_kernel_attributes(K kernel, size_t smem, int C) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

// Launch `kernel(arg)` on `clusters` clusters of C CTAs of FUSED_THREADS.
template <typename K, typename A>
int launch_clusters(K kernel, const A& arg, int clusters, int C, size_t smem,
                    cudaStream_t stream) {
  cudaError_t err = cluster_kernel_attributes(kernel, smem, C);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_dim(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(FUSED_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K6 with the plan of ops/banded_fused_kernels.py:fused_solve_plan on the
// first n of the kp columns of x: ⌈n/k⌉ clusters of C CTAs, each a tile of
// k columns, `rows` forward rows per stage, `stages` stages.  Columns past
// the last tile are left as they are (a zero column stays zero, which is
// also what the solve makes of it).  cudaErrorInvalidValue for a plan the
// kernel cannot take.
template <typename T>
int fused_solve(const T* band, const T* invL, const T* d, T* x, int nb, int b,
                int bw, int kp, int n, int k, int C, int rows, int stages,
                cudaStream_t stream) {
  const int clusters = k < 1 ? 0 : (n + k - 1) / k;
  if (C < 1 || C > MAX_CLUSTER || (C & (C - 1)) || b % C ||
      (b / C) * sizeof(T) % 16 || rows < 1 || stages < 2 ||
      stages > MAX_FUSED_STAGES || k < 1 || n < 1 || clusters * k > kp ||
      bw < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int nr = b / C;
  int box = nr;   // the largest power of two dividing both rows and nr
  while (rows % box) box >>= 1;
  const size_t nbp = (size_t)nb + bw;
  FusedSolve<T> a;
  if (!tensor_map(&a.band_f, band, nbp * (bw + 1) * b, b, b, box) ||
      !tensor_map(&a.invL_f, invL, nbp * b, b, b, box) ||
      !tensor_map(&a.band_b, band, nbp * (bw + 1) * b, b, nr, box * C) ||
      !tensor_map(&a.invL_b, invL, nbp * b, b, nr, box * C))
    return (int)cudaErrorInvalidValue;
  a.d = d;
  a.x = x;
  a.nb = nb;
  a.b = b;
  a.bw = bw;
  a.k = k;
  a.ld = kp;
  a.C = C;
  a.rows = rows;
  a.stages = stages;
  a.box = box;
  a.bar_bytes = (int)fused_barrier_bytes(stages);
  const size_t smem =
      a.bar_bytes + fused_solve_elems(b, bw, k, C, rows, stages) * sizeof(T);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  switch (b) {
    case 32: return launch_clusters(cluster_fused_solve_kernel<T, 32>, a, clusters, C, smem, stream);
    case 64: return launch_clusters(cluster_fused_solve_kernel<T, 64>, a, clusters, C, smem, stream);
    case 128: return launch_clusters(cluster_fused_solve_kernel<T, 128>, a, clusters, C, smem, stream);
    case 256: return launch_clusters(cluster_fused_solve_kernel<T, 256>, a, clusters, C, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- K5: the whole factorization over one cluster ------------------------------
//
// C CTAs of FUSED_THREADS (= DIAG_THREADS, which the diagonal step takes)
// in one cluster.  Units of work are 64×64 output tiles (the whole block
// where b = 32) of the panel X_l = P_l·L_jj⁻ᵀ and of the trailing
// products band[j+l, m] −= Lcol_{l+m}·X_lᵀ, and the scaling Lcol_l =
// X_l·D⁻¹ of one block; a phase deals its units round robin over the CTAs
// that take part.  Per block column j (after the cluster barrier that
// makes L_jj⁻¹ and d_j visible):
//   panel      every CTA: the tiles of X_1..X_bw
//   look-ahead every CTA: the tiles of (l, m) = (1, 0), the next diagonal
//              block, and the bw scalings of Lcol_l over P_l
//   rest       CTA 0: the diagonal step of block column j+1 (where C > 1,
//              beside the others; where C = 1, first); the other CTAs:
//              the tiles of every other (l, m)
// with a cluster barrier after each phase.  A trailing product reads
// Lcol_{l+m} as X_{l+m}/d while it stages it: the division the witness
// makes when it writes Lcol, so the bits are the same, and no tile of a panel
// overwrites P while another tile still reads it.
//
// Where the plan makes the band resident, the off-diagonal blocks (c, m),
// m ≥ 1, live in shared memory, block c·bw + m − 1 in CTA (index mod C)
// at slot (index / C), and X_l in CTA (l − 1) mod C: loaded once, read and
// written through DSMEM by whichever CTA runs a unit, written back once.
// The diagonal blocks stay in global memory (L2), where the diagonal
// step's cp.async copies read them.  Elsewhere every block is in global
// memory and X in the caller's scratch buffer.
constexpr int FT = 64, FKC = 32, FLD = FT + 4;   // tile, k slice, its pitch
constexpr size_t STAGE_ELEMS = 2 * 2 * FKC * FLD;   // two slices of A and B

template <typename T>
struct FusedFactor {
  T* band;
  T* invL;
  T* d;
  T* xbuf;
  int nb, b, bw, C, resident;
  int slots, xslots;      // resident blocks and X blocks per CTA
  size_t scratch;         // elements of the scratch region
};

// Shared-memory scratch of K5, in elements: the diagonal step's or the
// products' staging, whichever is larger (a CTA runs one at a time).
template <typename T>
size_t factor_scratch_elems(int b) {
  const size_t diag = diag_tiled_smem_bytes<T>(b) / sizeof(T);
  return diag > STAGE_ELEMS ? diag : STAGE_ELEMS;
}

// acc[i][jj] = Σ_k A[r0+r+i][k]·Bm[c0+c+jj][k] over k = 0..b-1 in order,
// one FMA per k, from 0 (as cta_gemm_nt and K1's gemm_nt_tile sum), for
// this thread's 2×4 outputs (r, c) of the TR×TR tile at (r0, c0), TR =
// min(b, 64).  A (and Bm) are rows of b elements in global or in some
// CTA's shared memory; where dA is given, A[r][k] is read as
// A[r][k] / pivot_div(dA[k]).  sm: STAGE_ELEMS of this CTA's shared memory.
// Returns false for a thread without outputs.  Ends after a barrier.
template <typename T>
__device__ bool tile_product(const T* A, const T* Bm, const T* dA, int b,
                             int r0, int c0, T* sm, T (&acc)[2][4], int& r,
                             int& c) {
  const int TR = b < FT ? b : FT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  r = 2 * ty;
  c = 4 * tx;
  const bool on = r < TR && c < TR;
  // loader: vector v = tid of each operand's slice, row v % TR, k 4·(v / TR)
  const bool ld_on = tid < TR * (FKC / 4);
  const int lr = tid % TR, lk = (tid / TR) * 4;
  T ra[4], rb[4];
  auto fetch = [&](int k0) {
    if (!ld_on) return;
    ld4(A + (size_t)(r0 + lr) * b + k0 + lk, ra);
    ld4(Bm + (size_t)(c0 + lr) * b + k0 + lk, rb);
    if (dA != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = ra[i] / pivot_div(dA[k0 + lk + i]);
    }
  };
  auto put = [&](T* buf) {
    if (!ld_on) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      buf[(lk + i) * FLD + lr] = ra[i];
      buf[(FKC + lk + i) * FLD + lr] = rb[i];
    }
  };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0;
  const int nch = b / FKC;
  fetch(0);
  put(sm);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const T* As = sm + (size_t)(ch & 1) * (2 * FKC * FLD);
    const T* Bs = As + FKC * FLD;
    if (ch + 1 < nch) fetch((ch + 1) * FKC);
    if (on) {
#pragma unroll 8
      for (int kk = 0; kk < FKC; ++kk) {
        const T a0 = As[kk * FLD + r], a1 = As[kk * FLD + r + 1];
        T bv[4];
        ld4(Bs + kk * FLD + c, bv);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[0][jj] += a0 * bv[jj];
          acc[1][jj] += a1 * bv[jj];
        }
      }
    }
    if (ch + 1 < nch) put(sm + (size_t)((ch + 1) & 1) * (2 * FKC * FLD));
    __syncthreads();
  }
  r += r0;
  c += c0;
  return on;
}

// the two halves of a cluster barrier (release / acquire at cluster
// scope), every thread of every CTA taking part
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (l, m) of trailing pair p, in the order l = 1..bw, m = 0..bw-l
__device__ __forceinline__ void trailing_pair(int p, int bw, int& l, int& m) {
  l = 1;
  while (p > bw - l) {
    p -= bw - l + 1;
    ++l;
  }
  m = p;
}

template <typename T>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
cluster_factorize_kernel(const __grid_constant__ FusedFactor<T> a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char cluster_smem[];
  T* scratch = reinterpret_cast<T*>(cluster_smem);
  const int b = a.b, bw = a.bw, nb = a.nb, C = a.C;
  const size_t bb = (size_t)b * b;
  T* res = scratch + a.scratch;                 // resident blocks
  T* xres = res + (size_t)a.slots * bb;         // resident X blocks
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = b < FT ? b : FT, nt1 = b / TR, tiles = nt1 * nt1;
  const int npairs = bw * (bw + 1) / 2;

  // block (c, m) of the band, wherever it lives
  auto blk = [&](int c, int m) -> T* {
    if (!a.resident || m == 0) return a.band + ((size_t)c * (bw + 1) + m) * bb;
    const int i = c * bw + m - 1;
    return cluster.map_shared_rank(res + (size_t)(i / C) * bb, i % C);
  };
  auto xblk = [&](int l) -> T* {
    if (!a.resident) return a.xbuf + (size_t)(l - 1) * bb;
    const int i = l - 1;
    return cluster.map_shared_rank(xres + (size_t)(i / C) * bb, i % C);
  };
  // trailing tile u of pair p at column j: band[j+l, m] −= Lcol_{l+m}·X_lᵀ
  auto trailing = [&](int j, int p, int u) {
    int l, m, r, c;
    trailing_pair(p, bw, l, m);
    T acc[2][4];
    const bool on = tile_product(xblk(l + m), xblk(l), a.d + (size_t)j * b,
                                 b, (u / nt1) * TR, (u % nt1) * TR, scratch,
                                 acc, r, c);
    if (!on) return;
    T* tgt = blk(j + l, m);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T v[4];
      ld4(tgt + (size_t)(r + i) * b + c, v);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[jj] = v[jj] - acc[i][jj];
      st4(tgt + (size_t)(r + i) * b + c, v);
    }
  };
  auto diag = [&](int j) {
    diag_ldlt_block_tiled(a.band + (size_t)j * (bw + 1) * bb,
                          a.invL + (size_t)j * bb, a.d + (size_t)j * b, b,
                          scratch);
  };

  if (a.resident) {
    for (int s = 0; s < a.slots; ++s) {
      const int i = s * C + rank;
      if (i >= (nb + bw) * bw) break;
      const T* src = a.band + ((size_t)(i / bw) * (bw + 1) + 1 + i % bw) * bb;
      for (size_t e = 4 * (size_t)tid; e < bb; e += 4 * (size_t)nt) {
        T v[4];
        ld4(src + e, v);
        st4(res + (size_t)s * bb + e, v);
      }
    }
  }
  if (rank == 0) diag(0);
  cluster.sync();

  // tile t of the panel block X_l = P_l·L_jj⁻ᵀ
  auto panel = [&](int j, int l, int t) {
    T acc[2][4];
    int r, c;
    if (tile_product(blk(j, l), a.invL + (size_t)j * bb, (const T*)nullptr,
                     b, (t / nt1) * TR, (t % nt1) * TR, scratch, acc, r, c)) {
      T* X = xblk(l);
#pragma unroll
      for (int i = 0; i < 2; ++i) st4(X + (size_t)(r + i) * b + c, acc[i]);
    }
  };
  // Lcol_l = X_l / d_j written over P_l
  auto scale = [&](int j, int l) {
    const T* X = xblk(l);
    const T* dj = a.d + (size_t)j * b;
    T* P = blk(j, l);
    for (size_t e = 4 * (size_t)tid; e < bb; e += 4 * (size_t)nt) {
      T v[4];
      ld4(X + e, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = v[i] / pivot_div(dj[(e + i) % b]);
      st4(P + e, v);
    }
  };
  // One tile a product (b ≤ 64) on more than one CTA: CTA 0 carries the
  // chain X_1 → band[j+1, 0] −= Lcol_1·X_1ᵀ → the next diagonal step on
  // its own, between the two halves of a split cluster barrier, while
  // the others form X_2..X_bw, then (once X_1 is out) the scalings and
  // every other trailing product.
  const bool chain = tiles == 1 && C > 1;

  for (int j = 0; j < nb; ++j) {
    const bool next = j + 1 < nb;
    if (chain) {
      if (rank == 0) {
        panel(j, 1, 0);
      } else {
        for (int l = 1 + rank; l <= bw; l += C - 1) panel(j, l, 0);
      }
      cluster_arrive();
      if (rank == 0) {
        __syncthreads();   // X_1 is whole
        trailing(j, 0, 0);
        if (next) diag(j + 1);
        cluster_wait();
      } else {
        cluster_wait();
        for (int u = rank - 1; u < bw + npairs - 1; u += C - 1) {
          if (u < bw) scale(j, u + 1);
          else trailing(j, u - bw + 1, 0);
        }
      }
      cluster.sync();
      continue;
    }
    for (int u = rank; u < bw * tiles; u += C) panel(j, 1 + u / tiles, u % tiles);
    cluster.sync();
    // look-ahead: the next diagonal block's update; Lcol_l = X_l / d over P_l
    for (int u = rank; u < tiles + bw; u += C) {
      if (u < tiles) trailing(j, 0, u);
      else scale(j, u - tiles + 1);
    }
    cluster.sync();
    // the rest of the trailing update, beside the next diagonal step
    const int first = next && C > 1 ? 1 : 0;   // CTA 0 factors
    if (next && rank == 0) diag(j + 1);
    if (rank >= first) {
      for (int u = tiles + rank - first; u < npairs * tiles; u += C - first)
        trailing(j, u / tiles, u % tiles);
    }
    cluster.sync();
  }

  if (a.resident) {
    for (int s = 0; s < a.slots; ++s) {
      const int i = s * C + rank;
      if (i >= (nb + bw) * bw) break;
      T* dst = a.band + ((size_t)(i / bw) * (bw + 1) + 1 + i % bw) * bb;
      for (size_t e = 4 * (size_t)tid; e < bb; e += 4 * (size_t)nt) {
        T v[4];
        ld4(res + (size_t)s * bb + e, v);
        st4(dst + e, v);
      }
    }
  }
}

// K5 with the plan of ops/banded_fused_kernels.py:fused_factorize_plan:
// one cluster of C CTAs, the off-diagonal blocks resident in it or not.
// cudaErrorInvalidValue for a plan the kernel cannot take.
template <typename T>
int fused_factorize(T* band, T* invL, T* d, T* xbuf, int nb, int b, int bw,
                    int C, int resident, cudaStream_t stream) {
  if (C < 1 || C > MAX_CLUSTER || b % 32 || b > 256 || bw < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  FusedFactor<T> a;
  a.band = band;
  a.invL = invL;
  a.d = d;
  a.xbuf = xbuf;
  a.nb = nb;
  a.b = b;
  a.bw = bw;
  a.C = C;
  a.resident = resident ? 1 : 0;
  a.slots = resident ? ((nb + bw) * bw + C - 1) / C : 0;
  a.xslots = resident ? (bw + C - 1) / C : 0;
  a.scratch = factor_scratch_elems<T>(b);
  const size_t smem =
      (a.scratch + (size_t)(a.slots + a.xslots) * b * b) * sizeof(T);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return launch_clusters(cluster_factorize_kernel<T>, a, 1, C, smem, stream);
}

}  // namespace

extern "C" {

// K5: the cluster factorization, with the plan (C CTAs, resident) of
// ops/banded_fused_kernels.py:fused_factorize_plan
int banded_fused_factorize_f32(void* band, void* invL, void* d, void* xbuf,
                               int nb, int b, int bw, int C, int resident,
                               void* stream) {
  return fused_factorize<float>((float*)band, (float*)invL, (float*)d,
                                (float*)xbuf, nb, b, bw, C, resident,
                                (cudaStream_t)stream);
}

int banded_fused_factorize_f64(void* band, void* invL, void* d, void* xbuf,
                               int nb, int b, int bw, int C, int resident,
                               void* stream) {
  return fused_factorize<double>((double*)band, (double*)invL, (double*)d,
                                 (double*)xbuf, nb, b, bw, C, resident,
                                 (cudaStream_t)stream);
}

// the witness of K5 (the one-CTA kernel it replaced)
int banded_fused_factorize_reference_f32(void* band, void* invL, void* d,
                                         void* xbuf, int nb, int b, int bw,
                                         void* stream) {
  return factorize_reference<float>((float*)band, (float*)invL, (float*)d,
                                    (float*)xbuf, nb, b, bw,
                                    (cudaStream_t)stream);
}

int banded_fused_factorize_reference_f64(void* band, void* invL, void* d,
                                         void* xbuf, int nb, int b, int bw,
                                         void* stream) {
  return factorize_reference<double>((double*)band, (double*)invL,
                                     (double*)d, (double*)xbuf, nb, b, bw,
                                     (cudaStream_t)stream);
}

// K6: the cluster solve of the first n columns of x ((nb+bw)·b × kp) in
// tiles of k columns, with the plan (C CTAs, rows per stage, stages) of
// ops/banded_fused_kernels.py:fused_solve_plan
int banded_fused_solve_f32(void* band, void* invL, void* d, void* x, int nb,
                           int b, int bw, int kp, int n, int k, int C,
                           int rows, int stages, void* stream) {
  return fused_solve<float>((const float*)band, (const float*)invL,
                            (const float*)d, (float*)x, nb, b, bw, kp, n, k,
                            C, rows, stages, (cudaStream_t)stream);
}

int banded_fused_solve_f64(void* band, void* invL, void* d, void* x, int nb,
                           int b, int bw, int kp, int n, int k, int C,
                           int rows, int stages, void* stream) {
  return fused_solve<double>((const double*)band, (const double*)invL,
                             (const double*)d, (double*)x, nb, b, bw, kp, n,
                             k, C, rows, stages, (cudaStream_t)stream);
}

// the witness of K6 (the kernel it replaced, one CTA per 8 columns)
int banded_fused_solve_reference_f32(void* band, void* invL, void* d, void* x,
                                     int nb, int b, int bw, int kp,
                                     void* stream) {
  return solve_reference<float>((const float*)band, (const float*)invL,
                                (const float*)d, (float*)x, nb, b, bw, kp,
                                (cudaStream_t)stream);
}

int banded_fused_solve_reference_f64(void* band, void* invL, void* d, void* x,
                                     int nb, int b, int bw, int kp,
                                     void* stream) {
  return solve_reference<double>((const double*)band, (const double*)invL,
                                 (const double*)d, (double*)x, nb, b, bw, kp,
                                 (cudaStream_t)stream);
}

}  // extern "C"
