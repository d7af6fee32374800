// The diagonal step of the block-banded LDLᵀ: LDLᵀ and L⁻¹ of one
// lower-stored b×b block by one CTA, the panel-blocked algorithm of
// madnlp_tpu/ops/pallas_banded.py:_ldlt_with_inverse (panel p = 32).  Two
// device functions compute it, bit for bit alike:
//
// diag_ldlt_block (K5's witness, csrc/banded_fused.cu).  The scalar pivot
// recursion runs on a 32×64 corner tile [C | I] in shared memory with three
// CTA barriers per pivot; the panel, trailing and L⁻¹-accumulation products
// are scalar FMA loops, one output element per thread and iteration, that
// load both operands for every FMA.  The block A and its inverse R may lie
// in global memory or in shared memory (the witness where it fits): the
// code reads them through generic pointers.
//
// diag_ldlt_block_tiled (K1, K3 and K5), A and R in
// global memory (L2-resident: the b = 256 block and its inverse are 256 KB
// each in float32).  What bounds the step on this card: it runs on one SM
// (one CTA per block, the other SMs wait for it inside K1's column loop),
// so its 7.2 M FMAs at b = 256 are bound by one SM's FMA rate (about 1/132
// of the card's), and its 8 panels form a dependent chain.  The scalar
// version reached about 5% of that rate: two shared or L2 loads per FMA,
// panel and R operands read from L2 inside the k-loops, half the trailing
// threads idle above the diagonal, and 93 CTA barriers per panel in the
// corner.  What this version does about it, per panel:
//   1. warp 0 runs the corner recursion alone and without CTA barriers,
//      each lane dividing for its own row's multiplier: in float32 lane r
//      holds row r of C in registers and row j reaches it by shuffles,
//      then lane c holds column c of I (giving invLc) and reads the
//      multipliers by broadcast; float64, whose 32 values a lane would
//      crowd the registers, runs the same column updates in shared memory;
//      meanwhile the other 15 warps stage the panel's
//      operands in shared memory: the panel rows A[hi:, lo:hi] transposed
//      (k-major) by 16-byte loads, and the rows R[lo:hi, :hi] by cp.async;
//   2. the panel product X = A[hi:, lo:hi]·invLcᵀ and the L⁻¹ accumulation
//      Zr = invLc·R[lo:hi, :hi], written in place over their staged
//      operands (each warp tile owns its operand slice) and, for Lc and Zr,
//      straight to A and R;
//   3. the trailing update of the lower triangle A[hi:, hi:] −= Lc·Xᵀ over
//      the warp tiles that meet the triangle only, and R[hi:, :hi] −= Lc·Zr.
// Every product runs on register micro-tiles: a thread owns 4×4 outputs, a
// warp 16×32 (or 32×16), and the k-loop runs outermost over registers, so
// one 16-byte shared load of each operand feeds 16 FMAs.  Three CTA
// barriers per panel.  Shared memory: the corner (32×33), its multipliers
// (32×32), invLcᵀ (32×36), the pivot divisors and three k-major 32×b
// panels (XT, LcT, ZR): 111.4 KB in float32 and 222.7 KB in float64 at
// b = 256, of the 227 KB a CTA may use (diag_tiled_smem_bytes).
//
// Why the two agree bit for bit.  Every element of X, Lc, the trailing
// block, Zr and R is still one accumulator that starts at 0, takes
// acc += a[k]·b[k] for k = 0..31 in order (the same product of the same two
// operands, contracted by nvcc to the same FMA), then the same single
// division or subtraction; the corner takes M[r][c] −= l[r]·M[j][c] in
// pivot order j with the same divisions.  Only which thread computes an
// element, and when, changes.  The build keeps nvcc's defaults (no fast
// math, FMA contraction on) and no tensor cores are used.  K5's witness,
// which keeps diag_ldlt_block, is the card-side witness: chip_smoke.py
// asserts K1's, K3's and K5's factors equal its exactly.
//
// A pivot with |d| <= 1e-30 divides as inf, as in the TPU kernel: the
// inertia that drives the IPM's regularization ladder must match exactly.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PANEL = 32;
constexpr int DIAG_THREADS = 512;
constexpr double ZERO_PIVOT_TOL = 1e-30;

template <typename T>
__device__ __forceinline__ T pivot_div(T v) {
  return fabs(v) <= (T)ZERO_PIVOT_TOL ? (T)INFINITY : v;
}

// Shared-memory scratch of diag_ldlt_block, in bytes.
template <typename T>
size_t diag_smem_bytes(int b) {
  const int ldm = 2 * PANEL + 1;
  size_t elems = (size_t)PANEL * ldm     // corner [C | I]
                 + 2 * PANEL             // lj, dc
                 + 2 * (size_t)b * (PANEL + 1)  // X, Lc
                 + (size_t)PANEL * b;    // Zr
  return elems * sizeof(T);
}

// LDLᵀ + L⁻¹ of one lower-stored b×b block A (ld = b), in place:
// A <- strict-lower L + diag(d) (upper zero), R <- L⁻¹, dout <- d.
// Every thread of the CTA calls it; sm is diag_smem_bytes<T>(b) of shared
// scratch.  Returns after a barrier.
template <typename T>
__device__ void diag_ldlt_block(T* __restrict__ A, T* __restrict__ R,
                                T* __restrict__ dout, int b,
                                T* __restrict__ sm) {
  const int P = PANEL;
  const int ldm = 2 * P + 1;
  const int ldx = P + 1;
  T* M = sm;                  // P x ldm
  T* lj = M + P * ldm;        // P
  T* dc = lj + P;             // P (pivot divisors of the panel)
  T* X = dc + P;              // b x ldx
  T* Lc = X + b * ldx;        // b x ldx
  T* Zr = Lc + b * ldx;       // P x b
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = tid; e < b * b; e += nt) R[e] = (e / b == e % b) ? T(1) : T(0);
  __syncthreads();

  for (int lo = 0; lo < b; lo += P) {
    const int hi = lo + P;
    const int nr = b - hi;
    // corner: symmetrize the lower-stored P×P block next to an identity
    for (int e = tid; e < P * 2 * P; e += nt) {
      const int r = e / (2 * P), c = e % (2 * P);
      T v;
      if (c < P) {
        const int rr = r > c ? r : c, cc = r > c ? c : r;
        v = A[(size_t)(lo + rr) * b + lo + cc];
      } else {
        v = (c - P == r) ? T(1) : T(0);
      }
      M[r * ldm + c] = v;
    }
    __syncthreads();
    // scalar pivot recursion on [C | I]
    for (int j = 0; j < P - 1; ++j) {
      if (tid < P) {
        lj[tid] = tid > j ? M[tid * ldm + j] / pivot_div(M[j * ldm + j]) : T(0);
      }
      __syncthreads();
      for (int e = tid; e < P * 2 * P; e += nt) {
        const int r = e / (2 * P), c = e % (2 * P);
        if (r > j && c > j) M[r * ldm + c] -= lj[r] * M[j * ldm + c];
      }
      __syncthreads();
      if (tid < P && tid > j) M[tid * ldm + j] = lj[tid];
      __syncthreads();
    }
    if (tid < P) {
      const T dv = M[tid * ldm + tid];
      dc[tid] = pivot_div(dv);
      dout[lo + tid] = dv;
    }
    __syncthreads();
    // panel: X = A[hi:, lo:hi] · invLcᵀ, Lc = X / dc
    for (int e = tid; e < nr * P; e += nt) {
      const int r = e / P, c = e % P;
      const T* arow = A + (size_t)(hi + r) * b + lo;
      const T* irow = M + c * ldm + P;
      T acc = 0;
#pragma unroll 8
      for (int k = 0; k < P; ++k) acc += arow[k] * irow[k];
      X[r * ldx + c] = acc;
      Lc[r * ldx + c] = acc / dc[c];
    }
    __syncthreads();
    // trailing update of the lower triangle: A[hi+r][hi+c] -= Lc[r]·X[c]
    for (int e = tid; e < nr * nr; e += nt) {
      const int r = e / nr, c = e % nr;
      if (c > r) continue;
      const T* lrow = Lc + r * ldx;
      const T* xrow = X + c * ldx;
      T acc = 0;
#pragma unroll 8
      for (int k = 0; k < P; ++k) acc += lrow[k] * xrow[k];
      A[(size_t)(hi + r) * b + hi + c] -= acc;
    }
    // L⁻¹ accumulation: Zr = invLc · R[lo:hi, :hi]
    for (int e = tid; e < P * hi; e += nt) {
      const int i = e / hi, c = e % hi;
      const T* irow = M + i * ldm + P;
      T acc = 0;
#pragma unroll 8
      for (int k = 0; k < P; ++k) acc += irow[k] * R[(size_t)(lo + k) * b + c];
      Zr[i * b + c] = acc;
    }
    __syncthreads();
    // R[hi:, :hi] -= Lc · Zr ; R[lo:hi, :hi] = Zr
    for (int e = tid; e < nr * hi; e += nt) {
      const int r = e / hi, c = e % hi;
      const T* lrow = Lc + r * ldx;
      T acc = 0;
#pragma unroll 8
      for (int k = 0; k < P; ++k) acc += lrow[k] * Zr[k * b + c];
      R[(size_t)(hi + r) * b + c] -= acc;
    }
    for (int e = tid; e < P * hi; e += nt) {
      const int i = e / hi, c = e % hi;
      R[(size_t)(lo + i) * b + c] = Zr[i * b + c];
    }
    // store the factored panel column: zeros above, LD corner, Lc below
    for (int e = tid; e < b * P; e += nt) {
      const int r = e / P, c = e % P;
      T v;
      if (r < lo) {
        v = T(0);
      } else if (r < hi) {
        const int rr = r - lo;
        v = rr >= c ? M[rr * ldm + c] : T(0);
      } else {
        v = Lc[(r - hi) * ldx + c];
      }
      A[(size_t)r * b + lo + c] = v;
    }
    __syncthreads();
  }
}

// -- the tiled diagonal step (K1, K3) -----------------------------------------

constexpr unsigned FULL_WARP = 0xffffffffu;

// Shared-memory scratch of diag_ldlt_block_tiled, in bytes: the factored
// corner C (P × (P+1)), the multipliers Ls (P × P, Ls[j][r] = l_j(r)),
// invT (P × (P+4), invT[k][i] = invLc[i][k]), the pivot divisors dc (P) and
// the k-major P × b panels XT, LcT and ZR.  Every part starts on a 16-byte
// boundary (3264 elements before XT).
template <typename T>
size_t diag_tiled_smem_bytes(int b) {
  const size_t elems = (size_t)PANEL * (PANEL + 1) + PANEL * PANEL
                       + PANEL * (PANEL + 4) + PANEL + 3 * (size_t)PANEL * b;
  return elems * sizeof(T);
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// cp.async of 16 bytes from global to shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first row and column of this lane's 4×4 micro-tile in a warp tile
// whose corner is (r0, c0): the warp's lanes form RG row groups × 32/RG
// column groups, so the warp tile is 4·RG rows × 4·(32/RG) columns.
template <int RG>
__device__ __forceinline__ void tile_origin(int r0, int c0, int& r, int& c) {
  constexpr int CG = 32 / RG;
  const int lane = threadIdx.x & 31;
  r = r0 + (lane / CG) * 4;
  c = c0 + (lane % CG) * 4;
}

// acc[i][j] = Σ_k As[k][r+i]·Bs[k][c+j] over k = 0..P-1 in order (one FMA
// per k into each accumulator, as the scalar loops of diag_ldlt_block sum);
// As and Bs are k-major with leading dimensions lda, ldb.
template <typename T>
__device__ __forceinline__ void micro_tile(const T* __restrict__ As, int lda,
                                           const T* __restrict__ Bs, int ldb,
                                           int r, int c, T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 4
  for (int k = 0; k < PANEL; ++k) {
    T av[4], bv[4];
    ld4(As + k * lda + r, av);
    ld4(Bs + k * ldb + c, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Warp 0's part of the tiled step for the panel at lo: LDLᵀ of the corner
// C = A[lo:lo+P, lo:lo+P] (lower-stored) by the scalar pivot recursion and
// invLc by the same updates on I, without CTA barriers.  Writes the
// factored corner to the corner rows of A's panel column (and M), the
// multipliers to Ls, invLc to invT, the pivots to dout[lo:] and their
// divisors to dc.
template <typename T>
__device__ __forceinline__ void tiled_corner(T* __restrict__ A,
                                             T* __restrict__ dout, int b,
                                             int lo, T* M, T* Ls, T* invT,
                                             T* dc) {
  constexpr int P = PANEL, ldm = P + 1, ldi = P + 4;
  const int r = threadIdx.x & 31;
  if constexpr (sizeof(T) == 4) {
    // C: lane r holds row r in registers, divides for its own multiplier
    // and receives row j by shuffles
    T m[P];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const int rr = r > c ? r : c, cc = r > c ? c : r;
      m[c] = A[(size_t)(lo + rr) * b + lo + cc];
    }
#pragma unroll
    for (int j = 0; j < P - 1; ++j) {
      const T piv = __shfl_sync(FULL_WARP, m[j], j);
      const T l = r > j ? m[j] / pivot_div(piv) : T(0);
#pragma unroll
      for (int c = j + 1; c < P; ++c) {
        const T mjc = __shfl_sync(FULL_WARP, m[c], j);
        if (r > j) m[c] -= l * mjc;
      }
      if (r > j) m[j] = l;
      Ls[j * P + r] = l;
    }
#pragma unroll
    for (int c = 0; c < P; ++c) M[r * ldm + c] = m[c];
    // row lo + r of A's panel column: L left of the diagonal, d on it,
    // zero right of it
#pragma unroll
    for (int c = 0; c < P; c += 4) {
      const T v[4] = {c <= r ? m[c] : T(0), c + 1 <= r ? m[c + 1] : T(0),
                      c + 2 <= r ? m[c + 2] : T(0),
                      c + 3 <= r ? m[c + 3] : T(0)};
      st4(A + (size_t)(lo + r) * b + lo + c, v);
    }
    __syncwarp();
    const T dv = M[r * ldm + r];
    dc[r] = pivot_div(dv);
    dout[lo + r] = dv;
    // I: the same updates, q[i] -= l_j(i)·q[j] for i > j in pivot order;
    // lane c holds column c, so the multipliers are broadcast reads; column
    // c of invLc is row c of invT
    T q[P];
#pragma unroll
    for (int i = 0; i < P; ++i) q[i] = (i == r) ? T(1) : T(0);
#pragma unroll
    for (int j = 0; j < P - 1; ++j)
#pragma unroll
      for (int i = j + 1; i < P; ++i) q[i] -= Ls[j * P + i] * q[j];
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const T v[4] = {q[i], q[i + 1], q[i + 2], q[i + 3]};
      st4(invT + r * ldi + i, v);
    }
  } else {
    // float64 keeps C in shared memory (32 doubles a lane would not leave
    // registers for the rest of the kernel): lane c owns column c, divides
    // for row c's multiplier, and updates its column with the multipliers
    // read by broadcast
#pragma unroll 4
    for (int i = 0; i < P; ++i) {
      const int rr = i > r ? i : r, cc = i > r ? r : i;
      M[i * ldm + r] = A[(size_t)(lo + rr) * b + lo + cc];
    }
    for (int j = 0; j < P - 1; ++j) {
      __syncwarp();
      const T l = r > j ? M[r * ldm + j] / pivot_div(M[j * ldm + j]) : T(0);
      Ls[j * P + r] = l;
      __syncwarp();
      if (r > j) {
        const T mj = M[j * ldm + r];
#pragma unroll 4
        for (int i = j + 1; i < P; ++i) M[i * ldm + r] -= Ls[j * P + i] * mj;
        M[r * ldm + j] = l;
      }
    }
    __syncwarp();
    // rows lo.. of A's panel column, column r of them
#pragma unroll 4
    for (int i = 0; i < P; ++i)
      A[(size_t)(lo + i) * b + lo + r] = r <= i ? M[i * ldm + r] : T(0);
    const T dv = M[r * ldm + r];
    dc[r] = pivot_div(dv);
    dout[lo + r] = dv;
    __syncwarp();
    // I: the same updates on Q (in M's space, lane c owns column c), then
    // invT[c][i] = Q[i][c]
#pragma unroll 4
    for (int i = 0; i < P; ++i) M[i * ldm + r] = (i == r) ? T(1) : T(0);
    for (int j = 0; j < P - 1; ++j) {
      const T qj = M[j * ldm + r];
#pragma unroll 4
      for (int i = j + 1; i < P; ++i) M[i * ldm + r] -= Ls[j * P + i] * qj;
    }
#pragma unroll 4
    for (int i = 0; i < P; ++i) invT[r * ldi + i] = M[i * ldm + r];
  }
}

// Warps 1..15's part for the panel at lo (thread t of ns): column block
// lo:lo+P of R set to the identity's and the rows above the corner of A's
// panel column to zero, then the panel's operands staged in shared memory:
// the panel rows A[hi:, lo:hi] transposed into XT (cp.async cannot
// transpose: 16-byte loads, four k at a time, consecutive threads on
// consecutive rows so that the shared stores meet no bank conflicts) and
// the rows R[lo:hi, :hi] into ZR by cp.async.
template <typename T>
__device__ __forceinline__ void tiled_stage(T* __restrict__ A,
                                            T* __restrict__ R, int b, int lo,
                                            T* XT, T* ZR, int t, int ns) {
  constexpr int P = PANEL, Q = P / 4;
  const int hi = lo + P, nr = b - hi;
  for (int e = t; e < b * Q; e += ns) {
    const int r = e / Q, c = lo + (e % Q) * 4;
    const T v[4] = {T(r == c), T(r == c + 1), T(r == c + 2), T(r == c + 3)};
    st4(R + (size_t)r * b + c, v);
  }
  for (int e = t; e < lo * Q; e += ns) {
    const T z[4] = {T(0), T(0), T(0), T(0)};
    st4(A + (size_t)(e / Q) * b + lo + (e % Q) * 4, z);
  }
  named_barrier(1, ns);   // R's new block before the copies of its rows
  for (int e = t; e < nr * Q; e += ns) {
    const int r = e % nr, k = (e / nr) * 4;
    T v[4];
    ld4(A + (size_t)(hi + r) * b + lo + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) XT[(k + i) * b + r] = v[i];
  }
  constexpr int V = 16 / sizeof(T);
  const int hv = hi / V;
  for (int e = t; e < P * hv; e += ns) {
    const int k = e / hv, c = (e % hv) * V;
    cp_async16(ZR + k * b + c, R + (size_t)(lo + k) * b + c);
  }
  cp_async_wait_all();
}

// The second phase for the panel at lo: X = A[hi:, lo:hi]·invLcᵀ (16×32
// warp tiles) and Lc = X / dc, Zr = invLc·R[lo:hi, :hi] (32×16 warp
// tiles); each tile is written over its own operand slice in XT or ZR,
// Lc also to LcT and A, Zr also to R.
template <typename T>
__device__ __forceinline__ void tiled_products(T* __restrict__ A,
                                               T* __restrict__ R, int b,
                                               int lo, const T* invT,
                                               const T* dc, T* XT, T* LcT,
                                               T* ZR, int warp, int nwarps) {
  constexpr int ldi = PANEL + 4;
  const int hi = lo + PANEL, npanel = (b - hi) / 16;
  for (int w = warp; w < npanel + hi / 16; w += nwarps) {
    T acc[4][4];
    int r, c;
    if (w < npanel) {
      tile_origin<4>(w * 16, 0, r, c);
      micro_tile(XT, b, invT, ldi, r, c, acc);
      T lc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) lc[i][j] = acc[i][j] / dc[c + j];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T x[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = acc[i][j];
          l[i] = lc[i][j];
        }
        st4(XT + (c + j) * b + r, x);
        st4(LcT + (c + j) * b + r, l);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(A + (size_t)(hi + r + i) * b + lo + c, lc[i]);
    } else {
      tile_origin<8>(0, (w - npanel) * 16, r, c);
      micro_tile(invT, ldi, ZR, b, r, c, acc);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st4(ZR + (r + i) * b + c, acc[i]);
        st4(R + (size_t)(lo + r + i) * b + c, acc[i]);
      }
    }
  }
}

// Tile w of the panel at hi - P's third phase: for w < ntr the trailing
// update A[hi+r][hi+c] -= Lc[r]·X[c] on a 16×32 warp tile that meets the
// lower triangle (row tile ti has ti/2 + 1 of them), else R[hi:, :hi] -=
// Lc·Zr on a 16×32 warp tile (hc of them per row tile).  16-byte
// read-modify-writes; entries above the diagonal are written back
// unchanged (no other thread writes them).
template <typename T>
__device__ __forceinline__ void tiled_update(int w, int ntr, int hc, int hi,
                                             int b, T* __restrict__ A,
                                             T* __restrict__ R, const T* LcT,
                                             const T* XT, const T* ZR) {
  int r, c;
  T* C;
  const T* Bs;
  const bool tri = w < ntr;
  if (tri) {
    int ti = 0, s = w;
    while (s > ti / 2) {
      s -= ti / 2 + 1;
      ++ti;
    }
    tile_origin<4>(ti * 16, s * 32, r, c);
    C = A + (size_t)(hi + r) * b + hi + c;
    Bs = XT;
  } else {
    const int u = w - ntr;
    tile_origin<4>((u / hc) * 16, (u % hc) * 32, r, c);
    C = R + (size_t)(hi + r) * b + c;
    Bs = ZR;
  }
  T v[4][4];
  // float32 reads the tile before the products; float64 after them (its
  // registers would not hold both)
  if (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(C + (size_t)i * b, v[i]);
  }
  T acc[4][4];
  micro_tile(LcT, b, Bs, b, r, c, acc);
  if (sizeof(T) == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(C + (size_t)i * b, v[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!tri || c + j <= r + i) v[i][j] -= acc[i][j];
    st4(C + (size_t)i * b, v[i]);
  }
}

// diag_ldlt_block for A and R in global memory (b a multiple of 32, at
// most 256), on register micro-tiles: the same outputs, bit for bit.  Every
// thread of the CTA (DIAG_THREADS of them) calls it; sm is
// diag_tiled_smem_bytes<T>(b) of 16-byte aligned shared scratch.  Returns
// after a barrier.
//
// Per panel, three phases between CTA barriers; the first runs one panel
// ahead, overlapping the previous panel's third phase:
//   1. warp 0: the corner (tiled_corner), as soon as warps 0 and 1 have
//      updated the corner block (the third phase's first two tiles);
//      warps 1..15: the rest of the third phase, then tiled_stage;
//   2. the panel and L⁻¹-accumulation products (tiled_products);
//   3. the trailing and R updates (tiled_update).
template <typename T>
__device__ void diag_ldlt_block_tiled(T* __restrict__ A, T* __restrict__ R,
                                      T* __restrict__ dout, int b,
                                      T* __restrict__ sm) {
  constexpr int P = PANEL, ldm = P + 1, ldi = P + 4;
  T* M = sm;                  // P x ldm: the factored corner C
  T* Ls = M + P * ldm;        // P x P: Ls[j][r], the multipliers of pivot j
  T* invT = Ls + P * P;       // P x ldi: invT[k][i] = invLc[i][k]
  T* dc = invT + P * ldi;     // P: pivot divisors of the panel
  T* XT = dc + P;             // P x b: staged A[hi+r][lo+k] at [k][r], then X
  T* LcT = XT + P * b;        // P x b: Lc[r][k] at [k][r]
  T* ZR = LcT + P * b;        // P x b: staged R[lo+k][c] at [k][c], then Zr
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, nwarps = nt >> 5;

  // lo = -P runs only the first panel's first phase
  for (int lo = -P; lo < b; lo += P) {
    const int hi = lo + P;
    const int nr = b - hi;
    const int npanel = nr / 16;
    if (lo >= 0) {
      tiled_products(A, R, b, lo, invT, dc, XT, LcT, ZR, warp, nwarps);
      __syncthreads();
    }
    // phase 3 of this panel and phase 1 of the next (at hi)
    const int q = npanel / 2;   // nr is a multiple of 32: npanel is even
    const int ntr = lo >= 0 ? q * (q + 1) : 0;
    const int hc = hi / 32;
    const int ntiles = lo >= 0 ? ntr + npanel * hc : 0;
    if (warp == 0) {
      if (nr > 0) {
        if (lo >= 0) {
          tiled_update(0, ntr, hc, hi, b, A, R, LcT, XT, ZR);
          named_barrier(2, 64);   // tiles 0 and 1 hold the next corner
        }
        tiled_corner(A, dout, b, hi, M, Ls, invT, dc);
      }
    } else {
      for (int w = warp; w < ntiles; w += nwarps - 1) {
        tiled_update(w, ntr, hc, hi, b, A, R, LcT, XT, ZR);
        if (w == 1) named_barrier(2, 64);
      }
      if (nr > 0) {
        named_barrier(1, nt - 32);   // every update of this panel is done
        tiled_stage(A, R, b, hi, XT, ZR, tid - 32, nt - 32);
      }
    }
    __syncthreads();
  }
}

}  // namespace
