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
//   K2 reads P_j and invL_j once per sweep (8.69 MB in float32 at the
//   flagship geometry, 2.6 µs at the card's 3.35 TB/s): bound by bytes,
//   but again a chain of nb dependent block mat-vecs in each sweep.
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
//         which K5's witness keeps);
//     (b) a tiled SIMT GEMM  X = P·L_jj⁻ᵀ  over the panel rows into scratch,
//     (c) Lcol = X·D⁻¹ written over P, and
//     (d) a tiled SIMT GEMM over the (l, m, tile) grid for the trailing
//         update  band[j+l, m] −= Lcol_{l+m}·X_lᵀ,
//     spreading (b)-(d) over many SMs.
//   K2: one thread-block cluster of C CTAs (up to 16, on as many SMs)
//     runs both sweeps in one launch (cluster_solve_kernel, whose note
//     has the details).  The forward sweep splits the rows of invL_j and
//     P_j over the CTAs, the backward sweep their columns; the values that
//     cross CTAs (r_j, z_j, the window of x) go straight into the other
//     CTAs' shared memory (st.async, counted on their mbarriers), two
//     exchanges per block column and sweep.  The factor does not depend on
//     the right-hand side, so each CTA streams its slices into a ring of
//     shared-memory stages by TMA, chunks ahead of the chain: what remains
//     is the chain itself, 4·nb exchanges and the mat-vec latency between
//     them.  The one-CTA solve it replaced (1024 threads for both sweeps,
//     each load issued when the loop reached it: about 28 GB/s, one SM's
//     latency-bound rate) stays as solve_reference_kernel, the card-side
//     witness, which the cluster solve equals bit for bit (chip_smoke.py
//     and tests/test_torch_gpu.py).
//   All products are full-precision FMA loops (no tensor cores, no TF32).
//   A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel: the
//   inertia that drives the IPM's regularization ladder must match exactly.
//   Overhang columns c >= nb are updated but never factored.
//   Kernels allocate nothing; every entry point returns cudaGetLastError().
//
// The batched kernels K3 and K4 run the same __global__ bodies with a lane
// index: every kernel takes the lane strides of its arrays and an optional
// active mask (int32 per lane; null for K1/K2, whose launches have one lane
// and zero strides).  A CTA of an inactive lane returns at once (in K4 all
// CTAs of a cluster read the same lane, so its whole cluster returns, before
// any cluster barrier), so its band, invL, d and right-hand side stay
// exactly as they were: that is how
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
//   geometry, and 16 lanes' factors (218 MB) do not fit the 50 MB L2, so
//   both sweeps stream them from device memory.  It is K2's kernel with
//   one cluster per lane: the plan (ops/banded_kernels.py:solve_plan)
//   takes the largest cluster size for which every lane's cluster is
//   resident at once (cudaOccupancyMaxActiveClusters), so B·C SMs each
//   keep their stage ring of loads in flight, where the one-CTA solve ran
//   one SM per lane at one SM's latency-bound rate.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "banded_cluster.cuh"
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

// The reference solve (the one-CTA K2 and K4 that cluster_solve_kernel
// replaced, kept as its card-side witness, which it equals bit for bit):
// one CTA per lane runs both sweeps, in place on the lane's rhs
// ((nb+bw)·b × k, row-major).
// Shared memory: rs (b·k), z (b·k), part (SOLVE_THREADS).
// One CTA per SM, so that the lanes never share an SM's registers.
template <typename T>
__global__ void __launch_bounds__(SOLVE_THREADS, 1)
solve_reference_kernel(const T* __restrict__ band, const T* __restrict__ invL,
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
int solve_reference(const T* band, const T* invL, const T* d, T* rhs,
                    const int* active, int lanes, int nb, int b, int bw, int k,
                    cudaStream_t stream) {
  const size_t smem = (2 * (size_t)b * k + SOLVE_THREADS) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      solve_reference_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t nbp = (size_t)nb + bw;
  solve_reference_kernel<T><<<lanes, SOLVE_THREADS, smem, stream>>>(
      band, invL, d, rhs, nb, b, bw, k, nbp * (bw + 1) * b * b,
      nbp * b * b, (size_t)nb * b, nbp * b * k, active);
  return (int)cudaGetLastError();
}

// K2 (lanes = 1) and K4 (one cluster per lane): the cluster solve.
//
// C CTAs (a thread-block cluster) share one system.  CTA `rank` owns the
// in-block indices [q0, q0 + nr), nr = b / C: in the forward sweep the rows
// ρ of every block of r, z, invL_j and P_j, in the backward sweep the
// columns q of every block of x and of invL_j and P_j.  So each CTA only
// ever reads and writes its own rows of the lane's rhs in global memory.
// What crosses CTAs, two exchanges per block column and sweep, goes into
// every CTA's shared memory by st.async, each store counting its bytes on
// an mbarrier of the receiving CTA, which waits for the bytes it expects
// (a cluster barrier costs 0.8 µs even on one CTA, its cluster-scope
// fence: tools/cluster_barrier_probe.cu, PERF.md):
//   xw   forward: r_j, all b rows (k × b); backward: the window of x_m,
//        slot m mod (bw+1) ((bw+1) × k × b);
//   zf   z_j, all b rows (k × b), in two buffers by the parity of j: a CTA
//        may send z_{j+1} while another still reads z_j;
//   part the backward sweep's strided partial sums of the owned columns
//        (k × S × nr), S = SOLVE_THREADS / b as in the reference.
// The factor's slices a CTA reads do not depend on the right-hand side: a
// ring of `stages` shared-memory stages streams them ahead of the chain by
// TMA box copies, chunk after chunk, across block columns and from the
// forward sweep into the backward one.  A block column's slices form
// (bw+1)·nr forward rows of b elements (rows ρ of invL_j, then rows
// (l, ρ) of P_j) or (bw+1)·b backward rows of nr elements (the owned
// columns of the rows of P_j, then of invL_j); a chunk is up to `rows`
// forward rows or rows·C backward rows, a whole block column where the
// stages fit it, so both sweeps take the same number of chunks per block
// column.  One thread off the chain issues a chunk's copies (three at the
// flagship's geometry): issued by every thread with cp.async, the copies
// held each thread up for a large part of a block column's time.
//
// Bit for bit the reference: every output element keeps its one
// accumulator and its order of terms (forward: a warp per row, lane ℓ
// summing q = ℓ, ℓ+32, … then the shuffle tree 16, 8, 4, 2, 1; backward:
// the S strided chains i ≡ s (mod S) in row order, then their sum in the
// order s = 0..S-1 from 0), the same FMA contraction, the same division,
// subtraction and zero padding.  Only the CTA and warp that own it change.
constexpr int CLUSTER_THREADS = 512;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_STAGES = 8;
constexpr size_t SMEM_LIMIT = 232448;

// Shared memory of the cluster solve, in elements after the barriers'
// BARRIER_BYTES: the stages, xw, the two zf, part.
inline size_t cluster_smem_elems(int b, int bw, int k, int C, int rows,
                                 int stages) {
  const size_t nr = b / C, S = SOLVE_THREADS / b;
  return (size_t)stages * rows * b + (size_t)(bw + 3) * b * k + nr * S * k;
}

template <typename T>
struct ClusterSolve {
  // the tensor maps of band and invL as 2-D arrays of rows of b elements
  // (every lane): boxes of `box` rows × b for the forward sweep's copies,
  // of box·C rows × b/C for the backward sweep's
  CUtensorMap band_f, invL_f, band_b, invL_b;
  const T* d;
  T* rhs;
  const int* active;
  int nb, b, bw, k;
  size_t s_d, s_rhs;         // lane strides, in elements
  int C, rows, stages, box;  // the launch plan
};

constexpr int BARRIER_BYTES = 128;

template <typename T, int B>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
cluster_solve_kernel(const __grid_constant__ ClusterSolve<T> a) {
  namespace cg = cooperative_groups;
  constexpr int S = SOLVE_THREADS / B, LS = S == 4 ? 2 : S == 8 ? 3
                                               : S == 16 ? 4 : 5;
  constexpr int LB = B == 32 ? 5 : B == 64 ? 6 : B == 128 ? 7 : 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int lane_idx = blockIdx.x / C;
  // every CTA of a cluster reads the same lane: the whole cluster returns
  if (!lane_on(a.active, lane_idx)) return;
  const T* d = a.d + lane_idx * a.s_d;
  T* rhs = a.rhs + lane_idx * a.s_rhs;
  const int nb = a.nb, bw = a.bw, k = a.k;
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

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // mbarriers: [0] r_{j+1} (forward) / x_j (backward), [1 + p] z_j,
  // p = j & 1; [3 + s] stage s filled
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  T* stage = reinterpret_cast<T*>(smem_raw + BARRIER_BYTES);
  T* xw = stage + (size_t)NS * stage_elems;
  T* zf2 = xw + (size_t)(bw + 1) * k * B;
  T* part = zf2 + (size_t)2 * k * B;
  if (tid == 0) {
    for (int i = 0; i < 3 + NS; ++i) mbar_init(smem_u32(bars + i), 1);
    fence_mbarrier_init();
    // the first NS-1 chunks in flight
    for (int t = 0; t < NS - 1 && t < total; ++t)
      issue_chunk<T, B>(plan.at(t), stage + (size_t)t * stage_elems, a,
                        smem_u32(bars + 3 + t), lane_idx, lnr, q0);
  }
  for (int e = tid; e < B * k; e += nt) xw[(e % k) * B + e / k] = rhs[e];   // r_0
  // every CTA of the cluster runs, its barriers are initialized, and it
  // has read r_0 (which its owners overwrite from here)
  cluster.sync();
  // lane ℓ < C of every warp sends a broadcast value to CTA ℓ: its shared
  // addresses there
  const unsigned to_rank = lane < C ? lane : 0;
  const unsigned xw_at = mapa(smem_u32(xw), to_rank);
  const unsigned zf_at = mapa(smem_u32(zf2), to_rank);
  const unsigned xbar_at = mapa(smem_u32(bars), to_rank);
  const unsigned zbar_at = mapa(smem_u32(bars + 1), to_rank);
  unsigned xph = 0, zph[2] = {0, 0};
  // wait until the exchange on barrier i is complete (thread 0 states the
  // bytes it brings), then flip its phase
  auto exchanged = [&](int i, unsigned& ph) {
    if (tid == 0) mbar_expect_tx(smem_u32(bars + i), XBYTES);
    mbar_wait(smem_u32(bars + i), ph);
    ph ^= 1;
  };

  for (int t = 0; t < total; ++t) {
    // chunk t+NS-1 into the stage every thread finished reading in chunk
    // t-1, by lane 0 of the last warp, off the chain: in the forward sweep
    // once its rows of r_{j+1} are sent, in the backward sweep first (the
    // strided chains leave that warp idle where nr·S·k < nt - 32)
    bool issued = tid != nt - 32 || t + NS - 1 >= total;
    auto issue_next = [&]() {
      if (issued) return;
      issued = true;
      const int sg = (t + NS - 1) % NS;
      fence_proxy_async();
      issue_chunk<T, B>(plan.at(t + NS - 1), stage + (size_t)sg * stage_elems,
                        a, smem_u32(bars + 3 + sg), lane_idx, lnr, q0);
    };
    const Chunk ch = plan.at(t);
    const int j = ch.j, end = ch.r0 + ch.n, p = j & 1;
    const int fmid = min(max(fsplit, ch.r0), end);
    // the global values the forward chain reads, loaded ahead where a warp
    // has more than two rows (with fewer, each row's load hides behind its
    // own dot product, and loading ahead costs more than it saves): lane m
    // of a warp takes its m-th invL pair's pivot and m-th P pair's running
    // rhs value (both final before this chunk), handed over by shuffles
    const bool many_d = ch.fwd && (fmid - ch.r0) * k > 2 * nwarps;
    const bool many_r = ch.fwd && (end - fmid) * k > 2 * nwarps;
    T pre_d = 0, pre_r = 0;
    {
      int r, c;
      if (many_d && warp_pair(lane, ch.r0, fmid, warp, nwarps, r, c) && c < k)
        pre_d = d[(size_t)j * B + q0 + r];
      if (many_r && warp_pair(lane, fmid, end, warp, nwarps, r, c) && c < k)
        pre_r = rhs[((size_t)(j + 1 + ((r - fsplit) >> lnr)) * B + q0 +
                     ((r - fsplit) & (nr - 1))) * k + c];
    }
    mbar_wait(smem_u32(bars + 3 + t % NS), (t / NS) & 1);   // chunk t landed
    const T* st = stage + (size_t)(t % NS) * stage_elems;
    T* zf = zf2 + (size_t)p * k * B;
    if (ch.fwd) {
      // rows [r0, mid) of invL_j: z_j[ρ] = invL_j[ρ, :]·r_j to every CTA,
      // and r_j[ρ] <- z_j[ρ] / d;  rows [mid, end) of P_j:
      // r_{j+1+l}[ρ] −= P_j[(l, ρ), :]·z_j, the last update of r_{j+1}
      // (l = 0) straight to every CTA's xw
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
            if (lane == 0) rhs[((size_t)j * B + rho) * k + c] = v / pivot_div(dv);
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
            T* dst = rhs + ((size_t)(j + 1 + l) * B + rho) * k + c;
            const bool pre = many_r && m < 32;
            const T old0 = !pre && lane == 0 ? *dst : T(0);
            const T acc = warp_dot<T, B>(st + (size_t)(r - ch.r0) * B,
                                         zf + (size_t)c * B, lane);
            const T old = pre ? __shfl_sync(FULL, pre_r, m) : old0;
            if (l == 0) {
              const T v = __shfl_sync(FULL, old - acc, 0);
              if (lane < C && j + 1 < nb)
                st_async(xw_at + (unsigned)((c * B + rho) * sizeof(T)), v,
                         xbar_at);
            } else if (lane == 0) {
              *dst = old - acc;
            }
          }
        }
      }
      issue_next();
      __syncthreads();
      if (end == frows && j == nb - 1) {
        // end of the forward sweep: zero the padding rows this CTA owns,
        // and the x window (its slots for blocks nb.. are read as zeros)
        for (int e = tid; e < bw * nr * k; e += nt) {
          const int c = e % k, rr = e / k;
          rhs[((size_t)(nb + (rr >> lnr)) * B + q0 + (rr & (nr - 1))) * k + c] = T(0);
        }
        for (int e = tid; e < (bw + 1) * k * B; e += nt) xw[e] = T(0);
        __syncthreads();
      }
    } else {
      // rows [r0, mid) of P_j, then rows [mid, end) of invL_j, as strided
      // chains over the owned columns; at the end of each part the chains'
      // sums give z_j[q] = w_j[q] − (P_jᵀ x_{j+1..j+bw})[q], then
      // x_j[q] = (invL_jᵀ z_j)[q], each sent to every CTA
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
          wpre = rhs[((size_t)j * B + q0 + (tid & (nr - 1))) * k + (tid >> lnr)];
        for (int e = tid; e < (nr * k) << LS; e += nt) {
          const int ql = e & (nr - 1), s = (e >> lnr) & (S - 1);
          const int c = e >> (lnr + LS);
          T acc = lo == base ? T(0) : part[e];
          int i = lo + ((s - (lo - base)) & (S - 1));   // i - base ≡ s (mod S)
          const T* sp = st + ((i - ch.r0) << lnr) + ql;
          const int sstep = S << lnr;
          while (i < hi) {
            // the rows of one block of x (or of z) at a time
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
          T* w = rhs + ((size_t)j * B + q) * k + c;
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
  // every exchange this CTA takes part in has completed at its receivers
  // only when they waited; no CTA leaves while another may still write
  // to its shared memory
  cluster.sync();
}

// Raise cluster_solve_kernel<T, B>'s shared-memory limit to `smem` and,
// for clusters of more than 8 CTAs, allow the non-portable sizes.
template <typename T, int B>
cudaError_t cluster_attributes(size_t smem, int C) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_solve_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(cluster_solve_kernel<T, B>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <typename T, int B>
int launch_cluster(const ClusterSolve<T>& a, int lanes, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cluster_attributes<T, B>(smem, a.C);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_dim(a.C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * a.C);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_solve_kernel<T, B>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K2 / K4 on `lanes` clusters of a.C CTAs.  Returns a CUDA error code;
// cudaErrorInvalidValue for a plan the kernel cannot take.
template <typename T>
int solve_cluster(const ClusterSolve<T>& a, int lanes, cudaStream_t stream) {
  const int C = a.C;
  if (C < 1 || C > MAX_CLUSTER || (C & (C - 1)) || a.b % C ||
      (a.b / C) * sizeof(T) % 16 || a.rows < 1 || a.stages < 2 ||
      a.stages > MAX_STAGES || lanes < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      BARRIER_BYTES +
      cluster_smem_elems(a.b, a.bw, a.k, C, a.rows, a.stages) * sizeof(T);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  switch (a.b) {
    case 32: return launch_cluster<T, 32>(a, lanes, smem, stream);
    case 64: return launch_cluster<T, 64>(a, lanes, smem, stream);
    case 128: return launch_cluster<T, 128>(a, lanes, smem, stream);
    case 256: return launch_cluster<T, 256>(a, lanes, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of C CTAs of the cluster solve can be resident at
// once, at the most shared memory a CTA may use (one CTA per SM, as its
// launch bounds also ask; the same for every block size).
template <typename T>
int max_active_clusters(int C, int* out) {
  cudaError_t err = cluster_attributes<T, 256>(SMEM_LIMIT, C);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_dim(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = SMEM_LIMIT;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)cluster_solve_kernel<T, 256>, &cfg);
}

template <typename T>
int solve_lanes(const T* band, const T* invL, const T* d, T* rhs,
                const int* active, int lanes, int nb, int b, int bw, int k,
                int C, int rows, int stages, cudaStream_t stream) {
  const size_t nbp = (size_t)nb + bw;
  if (C < 1 || b % C || rows < 1) return (int)cudaErrorInvalidValue;
  const int nr = b / C;
  int box = nr;   // the largest power of two dividing both rows and nr
  while (rows % box) box >>= 1;
  ClusterSolve<T> a;
  const size_t band_rows = (size_t)lanes * nbp * (bw + 1) * b;
  const size_t invL_rows = (size_t)lanes * nbp * b;
  if (!tensor_map(&a.band_f, band, band_rows, b, b, box) ||
      !tensor_map(&a.invL_f, invL, invL_rows, b, b, box) ||
      !tensor_map(&a.band_b, band, band_rows, b, nr, box * C) ||
      !tensor_map(&a.invL_b, invL, invL_rows, b, nr, box * C))
    return (int)cudaErrorInvalidValue;
  a.d = d;
  a.rhs = rhs;
  a.active = active;
  a.nb = nb;
  a.b = b;
  a.bw = bw;
  a.k = k;
  a.s_d = (size_t)nb * b;
  a.s_rhs = nbp * b * k;
  a.C = C;
  a.rows = rows;
  a.stages = stages;
  a.box = box;
  return solve_cluster(a, lanes, stream);
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

// K2 (lanes = 1, active may be null) and K4: the cluster solve, with the
// launch plan (C CTAs per lane, rows per stage, stages) from
// ops/banded_kernels.py:solve_plan
int banded_solve_cluster_f32(void* band, void* invL, void* d, void* rhs,
                             void* active, int lanes, int nb, int b, int bw,
                             int k, int C, int rows, int stages,
                             void* stream) {
  return solve_lanes<float>((const float*)band, (const float*)invL,
                            (const float*)d, (float*)rhs, (const int*)active,
                            lanes, nb, b, bw, k, C, rows, stages,
                            (cudaStream_t)stream);
}

int banded_solve_cluster_f64(void* band, void* invL, void* d, void* rhs,
                             void* active, int lanes, int nb, int b, int bw,
                             int k, int C, int rows, int stages,
                             void* stream) {
  return solve_lanes<double>((const double*)band, (const double*)invL,
                             (const double*)d, (double*)rhs,
                             (const int*)active, lanes, nb, b, bw, k, C, rows,
                             stages, (cudaStream_t)stream);
}

// clusters of C CTAs of the cluster solve resident at once (into *out)
int banded_solve_max_clusters_f32(int C, int* out) {
  return max_active_clusters<float>(C, out);
}

int banded_solve_max_clusters_f64(int C, int* out) {
  return max_active_clusters<double>(C, out);
}

// the reference solve (the one-CTA K2 / K4), the witness of the cluster solve
int banded_solve_reference_f32(void* band, void* invL, void* d, void* rhs,
                               void* active, int lanes, int nb, int b, int bw,
                               int k, void* stream) {
  return solve_reference<float>((const float*)band, (const float*)invL,
                                (const float*)d, (float*)rhs,
                                (const int*)active, lanes, nb, b, bw, k,
                                (cudaStream_t)stream);
}

int banded_solve_reference_f64(void* band, void* invL, void* d, void* rhs,
                               void* active, int lanes, int nb, int b, int bw,
                               int k, void* stream) {
  return solve_reference<double>((const double*)band, (const double*)invL,
                                 (const double*)d, (double*)rhs,
                                 (const int*)active, lanes, nb, b, bw, k,
                                 (cudaStream_t)stream);
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
