// Where the time of the whole-matrix dense LDLᵀ (K7,
// madnlp_tpu_torch/csrc/dense_ldlt.cu) goes, stage by stage, on the card.
//
// On a seeded symmetric indefinite Np×Np matrix (Np = 2688, b = 128: the
// dense nb=600 ACOPF system's padded size and block), in float and double:
//   witness  the first version of K7 (factorize_reference) as one call,
//            and its four launches per block column (diag, panel, scale,
//            trailing) each bracketed by CUDA events, summed over the
//            columns;
//   k7       the redesigned K7 (factorize: two streams, look-ahead) as one
//            call, and its launches per block column (diag, panel, strip,
//            rest) serialized on one stream, each bracketed by events;
//   equal    whether the two factors agree bit for bit on the strict lower
//            triangle and the diagonal.
// The median of REPS runs of each; one JSON line per dtype.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/dense_ldlt_stage_probe tools/dense_ldlt_stage_probe.cu \
//     && build/dense_ldlt_stage_probe

#include "../madnlp_tpu_torch/csrc/dense_ldlt.cu"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int NP = 2688, B = 128, REPS = 7;

#define CK(call)                                                         \
  do {                                                                   \
    cudaError_t e_ = (call);                                             \
    if (e_ != cudaSuccess) {                                             \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,                  \
              cudaGetErrorString(e_));                                   \
      exit(1);                                                           \
    }                                                                    \
  } while (0)

double median(std::vector<double> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

// Events bracketing the launches of one run, read after a synchronize.
struct Stages {
  std::vector<cudaEvent_t> ev;
  std::vector<int> stage;   // stage of the launch between ev[2i], ev[2i+1]
  int used = 0;
  explicit Stages(int n) : ev(2 * n), stage(n) {
    for (auto& e : ev) CK(cudaEventCreate(&e));
  }
  ~Stages() {
    for (auto& e : ev) cudaEventDestroy(e);
  }
  cudaEvent_t begin(int s, cudaStream_t st) {
    stage[used] = s;
    CK(cudaEventRecord(ev[2 * used], st));
    return ev[2 * used];
  }
  void end(cudaStream_t st) {
    CK(cudaEventRecord(ev[2 * used + 1], st));
    ++used;
  }
  void sum(double* ms) {
    CK(cudaDeviceSynchronize());
    for (int i = 0; i < used; ++i) {
      float t;
      CK(cudaEventElapsedTime(&t, ev[2 * i], ev[2 * i + 1]));
      ms[stage[i]] += t;
    }
    used = 0;
  }
};

template <typename T>
void witness_stages(T* A, T* R, T* xbuf, cudaStream_t s, Stages& st,
                    double* ms) {
  const size_t smem = ref_diag_smem_bytes<T>(B);
  CK(cudaFuncSetAttribute(ref_diag_kernel<T>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)smem));
  for (int kb = 0; kb < NP; kb += B) {
    T* Akk = A + (size_t)kb * NP + kb;
    st.begin(0, s);
    ref_diag_kernel<T><<<1, REF_DIAG_THREADS, smem, s>>>(Akk, NP, R, B);
    st.end(s);
    const int rows = NP - kb - B;
    if (rows == 0) break;
    T* P = Akk + (size_t)B * NP;
    st.begin(1, s);
    ref_panel_kernel<T><<<dim3((B + REF_BN - 1) / REF_BN,
                               (rows + REF_BM - 1) / REF_BM),
                          REF_GEMM_THREADS, 0, s>>>(P, NP, R, xbuf, rows, B);
    st.end(s);
    st.begin(2, s);
    ref_scale_kernel<T><<<(unsigned)(((size_t)rows * B + 255) / 256), 256, 0,
                          s>>>(xbuf, Akk, P, NP, rows, B);
    st.end(s);
    st.begin(3, s);
    ref_trailing_kernel<T><<<dim3((rows + REF_BN - 1) / REF_BN,
                                  (rows + REF_BM - 1) / REF_BM),
                             REF_GEMM_THREADS, 0, s>>>(P + B, P, xbuf, NP,
                                                       rows, B);
    st.end(s);
  }
  CK(cudaGetLastError());
  st.sum(ms);
}

template <typename T>
void k7_stages(T* A, T* R, T* xbuf, cudaStream_t s, Stages& st, double* ms) {
  CK(set_smem_limits<T>(B));
  const size_t smem = diag_smem_bytes<T>(B), csmem = chain_smem_bytes<T>(B),
               rsmem = rest_smem_bytes<T>(B);
  const size_t xstride = (size_t)(NP - B) * B;
  for (int k = 0, kb = 0; kb < NP; ++k, kb += B) {
    T* Akk = A + (size_t)kb * NP + kb;
    st.begin(0, s);
    diag_kernel<T><<<1, DIAG_THREADS, smem, s>>>(Akk, NP, R, B);
    st.end(s);
    const int rows = NP - kb - B;
    if (rows == 0) break;
    T* P = Akk + (size_t)B * NP;
    T* X = xbuf + (k & 1) * xstride;
    st.begin(1, s);
    panel_kernel<T><<<tiles_of(rows, CTM), CHAIN_THREADS, csmem, s>>>(
        P, NP, R, X, Akk, rows, B, true);
    st.end(s);
    st.begin(2, s);
    strip_kernel<T><<<tiles_of(rows, CTM), CHAIN_THREADS, csmem, s>>>(
        P + B, NP, P, X, rows, B, true);
    st.end(s);
    const int n = rows - B;
    if (n > 0) {
      const int t = tiles_of(n, RTM);
      st.begin(3, s);
      rest_kernel<T><<<t * (t + 1) / 2, REST_THREADS, rsmem, s>>>(
          P + (size_t)B * NP + 2 * B, NP, P + (size_t)B * NP,
          X + (size_t)B * B, n, B, true);
      st.end(s);
    }
  }
  CK(cudaGetLastError());
  st.sum(ms);
}

// a seeded symmetric indefinite matrix, diagonally dominant: the first
// 3/4 of the pivots positive, the rest negative
template <typename T>
std::vector<T> seeded_matrix() {
  std::vector<T> h((size_t)NP * NP);
  unsigned long long x = 88172645463325252ull;
  auto next = [&]() {
    x ^= x << 13; x ^= x >> 7; x ^= x << 17;
    return (double)(x >> 11) / 9007199254740992.0 * 2.0 - 1.0;
  };
  for (int i = 0; i < NP; ++i)
    for (int j = 0; j <= i; ++j) {
      const double v = i == j ? (i < 3 * NP / 4 ? 1.0 : -1.0) * (NP + next())
                              : next();
      h[(size_t)i * NP + j] = h[(size_t)j * NP + i] = (T)v;
    }
  return h;
}

template <typename T>
bool equal_lower(const std::vector<T>& a, const std::vector<T>& b) {
  for (int i = 0; i < NP; ++i)
    if (memcmp(&a[(size_t)i * NP], &b[(size_t)i * NP], (i + 1) * sizeof(T)))
      return false;
  return true;
}

template <typename T>
void probe(const char* name) {
  const std::vector<T> h = seeded_matrix<T>();
  const size_t bytes = h.size() * sizeof(T);
  T *A0, *A, *R, *xbuf;
  CK(cudaMalloc(&A0, bytes));
  CK(cudaMalloc(&A, bytes));
  CK(cudaMalloc(&R, (size_t)B * B * sizeof(T)));
  CK(cudaMalloc(&xbuf, 2 * (size_t)(NP - B) * B * sizeof(T)));
  CK(cudaMemcpy(A0, h.data(), bytes, cudaMemcpyHostToDevice));
  cudaStream_t s;
  CK(cudaStreamCreate(&s));
  cudaEvent_t t0, t1;
  CK(cudaEventCreate(&t0));
  CK(cudaEventCreate(&t1));
  Stages st(4 * (NP / B));

  std::vector<double> total[2], split[2][4];
  std::vector<T> out[2];
  for (int rep = 0; rep < REPS + 1; ++rep)
    for (int which = 0; which < 2; ++which) {
      // one call, as the wrapper makes it
      CK(cudaMemcpyAsync(A, A0, bytes, cudaMemcpyDeviceToDevice, s));
      CK(cudaEventRecord(t0, s));
      const int err = which == 0 ? factorize_reference<T>(A, R, xbuf, NP, B, s)
                                 : factorize<T>(A, R, xbuf, NP, B, s);
      CK(cudaEventRecord(t1, s));
      CK(cudaEventSynchronize(t1));
      if (err) {
        fprintf(stderr, "factorization failed: %d\n", err);
        exit(1);
      }
      float ms;
      CK(cudaEventElapsedTime(&ms, t0, t1));
      if (rep == 0) {   // warm-up; keep the factor
        out[which].resize(h.size());
        CK(cudaMemcpy(out[which].data(), A, bytes, cudaMemcpyDeviceToHost));
      } else {
        total[which].push_back(ms);
      }
      // the same launches, each bracketed by events
      double part[4] = {0, 0, 0, 0};
      CK(cudaMemcpyAsync(A, A0, bytes, cudaMemcpyDeviceToDevice, s));
      if (which == 0) witness_stages<T>(A, R, xbuf, s, st, part);
      else k7_stages<T>(A, R, xbuf, s, st, part);
      if (rep > 0)
        for (int i = 0; i < 4; ++i) split[which][i].push_back(part[i]);
    }
  const bool equal = equal_lower(out[0], out[1]);
  const int cols = NP / B;
  printf("{\"probe\": \"dense_ldlt_stages\", \"dtype\": \"%s\", \"Np\": %d, "
         "\"b\": %d, \"reps\": %d, "
         "\"witness\": {\"total_ms\": %.4f, \"diag_ms\": %.4f, "
         "\"panel_ms\": %.4f, \"scale_ms\": %.4f, \"trailing_ms\": %.4f, "
         "\"diag_us_per_step\": %.2f}, "
         "\"k7\": {\"total_ms\": %.4f, \"serial_diag_ms\": %.4f, "
         "\"serial_panel_ms\": %.4f, \"serial_strip_ms\": %.4f, "
         "\"serial_rest_ms\": %.4f, \"diag_us_per_step\": %.2f}, "
         "\"equal_bits\": %s}\n",
         name, NP, B, REPS, median(total[0]), median(split[0][0]),
         median(split[0][1]), median(split[0][2]), median(split[0][3]),
         1e3 * median(split[0][0]) / cols, median(total[1]),
         median(split[1][0]), median(split[1][1]), median(split[1][2]),
         median(split[1][3]), 1e3 * median(split[1][0]) / cols,
         equal ? "true" : "false");
  fflush(stdout);
  cudaFree(A0); cudaFree(A); cudaFree(R); cudaFree(xbuf);
  cudaStreamDestroy(s);
}

}  // namespace

int main() {
  probe<float>("float32");
  probe<double>("float64");
  return 0;
}
