// Device helpers of the solves that run over a thread-block cluster: the
// cluster solve K2/K4 (cluster_solve_kernel, csrc/banded_ldlt.cu) and the
// whole-band solve K6 (csrc/banded_fused.cu).  TMA box copies of the
// factor into shared memory, counted on mbarriers; st.async stores into
// another CTA's shared memory, counted on its mbarriers; the chunks in
// which a solve streams its factor (a block column's rows of invL_j and
// P_j, or their columns); the warp-per-row dot product of the reference
// solves; and, on the host, the tensor maps of the band and invL and the
// launch attribute of a grid of clusters.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// 2-D TMA copy of the box at (x, y) of `map` into shared memory at `dst`
// (128-byte aligned), counted on the mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            int x, int y, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar) : "memory");
}

// order this CTA's earlier generic accesses to shared memory before the
// async proxy's (the TMA writes into a stage the CTA has read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// The exchanges between the CTAs of a cluster: st.async stores a value
// into another CTA's shared memory and counts its bytes on an mbarrier
// there; the receiver, whose thread 0 states the bytes it expects, waits
// for the barrier's phase (acquire at cluster scope).  A wait that never
// ends traps (after about a second) instead of hanging the card.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of this CTA's shared address `a` in CTA `rank`'s shared memory
__device__ __forceinline__ unsigned mapa(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  long long spins = 0;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++spins > (1ll << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
               :: "r"(addr), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}

// The m-th (row, column) pair a warp takes of rows [lo, hi) × k columns,
// rows dealt round robin over nwarps warps, columns outermost: false if
// the warp has fewer pairs.
__device__ __forceinline__ bool warp_pair(int m, int lo, int hi, int warp,
                                          int nwarps, int& r, int& c) {
  const int rows = hi - lo - warp <= 0 ? 0 : (hi - lo - warp + nwarps - 1) / nwarps;
  if (rows == 0) return false;
  c = m / rows;
  r = lo + warp + (m - c * rows) * nwarps;
  return true;
}

// Chunk t of the solve's stream: block column j, forward or backward
// sweep, the column's rows [r0, r0 + n) in that sweep's row order.
struct Chunk {
  int j, r0, n;
  bool fwd;
};

struct ChunkPlan {
  int nb, per, rf, rb, frows, brows;   // chunks per column, rows per chunk

  __device__ __forceinline__ Chunk at(int t) const {
    Chunk ch;
    ch.fwd = t < nb * per;
    if (!ch.fwd) t -= nb * per;
    const int step = t / per, u = t - step * per;
    ch.j = ch.fwd ? step : nb - 1 - step;
    const int r = ch.fwd ? rf : rb;
    ch.r0 = u * r;
    ch.n = min(r, (ch.fwd ? frows : brows) - ch.r0);
    return ch;
  }
};

// Stage chunk `ch` of lane `lane_idx`'s factor into `dst` by TMA box
// copies (issued by one thread), their bytes counted on the stage's
// mbarrier `bar`: forward boxes of a.box rows of invL_j or of one block of
// P_j, backward boxes of a.box·C rows of nr columns.
template <typename T, int B, class Args>
__device__ __forceinline__ void issue_chunk(const Chunk& ch, T* dst,
                                            const Args& a,
                                            unsigned bar, int lane_idx,
                                            int lnr, int q0) {
  const int nr = 1 << lnr, bw = a.bw, nbp = a.nb + bw;
  const int yb = lane_idx * nbp * (bw + 1) * B;   // the lane's first band row
  const int yi = lane_idx * nbp * B;              // and invL row
  const unsigned d0 = smem_u32(dst);
  mbar_expect_tx(bar, (unsigned)(ch.n * (ch.fwd ? B : nr) * sizeof(T)));
  if (ch.fwd) {
    for (int r = ch.r0; r < ch.r0 + ch.n; r += a.box) {
      const unsigned to = d0 + (unsigned)((r - ch.r0) * B * sizeof(T));
      if (r < nr)
        tma_load_2d(to, &a.invL_f, 0, yi + ch.j * B + q0 + r, bar);
      else
        tma_load_2d(to, &a.band_f, 0,
                    yb + (ch.j * (bw + 1) + 1 + ((r - nr) >> lnr)) * B + q0 +
                        ((r - nr) & (nr - 1)),
                    bar);
    }
  } else {
    const int split = bw * B;
    for (int i = ch.r0; i < ch.r0 + ch.n; i += a.box * (B >> lnr)) {
      const unsigned to = d0 + (unsigned)((i - ch.r0) * nr * sizeof(T));
      if (i < split)
        tma_load_2d(to, &a.band_b, q0, yb + (ch.j * (bw + 1) + 1) * B + i, bar);
      else
        tma_load_2d(to, &a.invL_b, q0, yi + ch.j * B + (i - split), bar);
    }
  }
}

// lane 0's dot product of a row with x, over q = lane, lane + 32, … in
// order, then the shuffle tree (the reference's warp-per-row order)
template <typename T, int B>
__device__ __forceinline__ T warp_dot(const T* __restrict__ av,
                                      const T* __restrict__ xv, int lane) {
  T acc = 0;
#pragma unroll
  for (int u = 0; u < B / 32; ++u) acc += av[lane + 32 * u] * xv[lane + 32 * u];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  return acc;
}

// The launch attribute that makes a grid of clusters of C CTAs.
inline cudaLaunchAttribute cluster_dim(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of `rows` rows of b elements at `base`, in boxes of
// box_y rows × box_x elements.
template <typename T>
bool tensor_map(CUtensorMap* map, const T* base, size_t rows, int b, int box_x,
                int box_y) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)b, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)b * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_x, (cuuint32_t)box_y};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map,
             sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
             2, (void*)base, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
