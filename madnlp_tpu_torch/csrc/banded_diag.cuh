// The diagonal step of the block-banded LDLᵀ, shared by K1/K3
// (csrc/banded_ldlt.cu) and K5 (csrc/banded_fused.cu): LDLᵀ and L⁻¹ of one
// lower-stored b×b block by one CTA, the panel-blocked algorithm of
// madnlp_tpu/ops/pallas_banded.py:_ldlt_with_inverse (panel p = 32).
//
// The scalar pivot recursion only ever runs on a 32×64 corner tile
// [C | I] in shared memory; the panel, trailing and L⁻¹-accumulation
// products are FMA loops over shared-memory operands.  The block A and its
// inverse R may lie in global memory (L2-resident, as in K1, whose b = 256
// block does not fit a CTA) or in shared memory (K5 where it fits): the
// code reads them through generic pointers.
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

}  // namespace
