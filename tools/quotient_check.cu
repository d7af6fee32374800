// The quotients of K7's diagonal step (madnlp_tpu_torch/csrc/dense_ldlt.cu:
// markstein_quotient from y = 1/b) against the IEEE division x / b, bit for
// bit, on the card: random x and b whose exponents lie in the range the
// kernel takes the sequence for (in_quotient_range), signs and mantissas
// from a counter-based hash, in four families: any mantissas; b's mantissa
// near all ones (1/b near a power of two); x's near all ones; b's with few
// bits.  2^30 float and 2^28 double pairs per family; one line per family.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/quotient_check tools/quotient_check.cu \
//     && build/quotient_check

#include "../madnlp_tpu_torch/csrc/dense_ldlt.cu"

#include <cstdio>

namespace {

__device__ unsigned long long mismatch32, pairs32, mismatch64, pairs64;

__device__ __forceinline__ unsigned long long mix(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

__global__ void check_float(unsigned long long base, int family) {
  const unsigned long long id =
      base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const unsigned long long h = mix(id), h2 = mix(id ^ 0x1234567ull);
  const unsigned ex = 127 - 40 + (unsigned)(h % 81);
  const unsigned eb = 127 - 40 + (unsigned)((h >> 8) % 81);
  unsigned mx = (unsigned)(h >> 20) & 0x7fffff, mb = (unsigned)h2 & 0x7fffff;
  if (family == 1) mb = 0x7fffff - (mb & 0xff);
  if (family == 2) mx = 0x7fffff - (mx & 0xff);
  if (family == 3) mb &= 0xff;
  const float x = __uint_as_float((ex << 23) | mx |
                                  ((unsigned)(h2 >> 40) & 1u) << 31);
  const float b = __uint_as_float((eb << 23) | mb |
                                  ((unsigned)(h2 >> 41) & 1u) << 31);
  if (!in_quotient_range(x) || !in_quotient_range(b)) return;
  const float q = markstein_quotient(x, b, 1.0f / b);
  atomicAdd(&pairs32, 1ull);
  if (__float_as_uint(q) != __float_as_uint(x / b))
    atomicAdd(&mismatch32, 1ull);
}

__global__ void check_double(unsigned long long base, int family) {
  const unsigned long long id =
      base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const unsigned long long h = mix(id), h2 = mix(id ^ 0x7654321ull),
                           h3 = mix(id ^ 0xabcdefull);
  const unsigned long long ex = 1023 - 300 + h % 601;
  const unsigned long long eb = 1023 - 300 + (h >> 12) % 601;
  unsigned long long mx = h2 & 0xfffffffffffffull,
                     mb = h3 & 0xfffffffffffffull;
  if (family == 1) mb = 0xfffffffffffffull - (mb & 0xffff);
  if (family == 2) mx = 0xfffffffffffffull - (mx & 0xffff);
  if (family == 3) mb &= 0xffff;
  const double x = __longlong_as_double(
      (long long)((ex << 52) | mx | ((h >> 62) & 1ull) << 63));
  const double b = __longlong_as_double(
      (long long)((eb << 52) | mb | ((h >> 63) & 1ull) << 63));
  if (!in_quotient_range(x) || !in_quotient_range(b)) return;
  const double q = markstein_quotient(x, b, 1.0 / b);
  atomicAdd(&pairs64, 1ull);
  if (__double_as_longlong(q) != __double_as_longlong(x / b))
    atomicAdd(&mismatch64, 1ull);
}

}  // namespace

int main() {
  const char* names[] = {"any", "b near all ones", "x near all ones",
                         "b few bits"};
  int failed = 0;
  for (int family = 0; family < 4; ++family) {
    const unsigned long long zero = 0;
    cudaMemcpyToSymbol(mismatch32, &zero, 8);
    cudaMemcpyToSymbol(pairs32, &zero, 8);
    cudaMemcpyToSymbol(mismatch64, &zero, 8);
    cudaMemcpyToSymbol(pairs64, &zero, 8);
    for (int r = 0; r < 16; ++r)
      check_float<<<1 << 16, 1024>>>(
          (unsigned long long)r << 26 | (unsigned long long)family << 40,
          family);
    for (int r = 0; r < 4; ++r)
      check_double<<<1 << 16, 1024>>>(
          (unsigned long long)r << 26 | (unsigned long long)family << 40,
          family);
    const cudaError_t err = cudaDeviceSynchronize();
    unsigned long long m32, n32, m64, n64;
    cudaMemcpyFromSymbol(&m32, mismatch32, 8);
    cudaMemcpyFromSymbol(&n32, pairs32, 8);
    cudaMemcpyFromSymbol(&m64, mismatch64, 8);
    cudaMemcpyFromSymbol(&n64, pairs64, 8);
    printf("{\"family\": \"%s\", \"float_pairs\": %llu, "
           "\"float_mismatches\": %llu, \"double_pairs\": %llu, "
           "\"double_mismatches\": %llu, \"error\": \"%s\"}\n",
           names[family], n32, m32, n64, m64, cudaGetErrorString(err));
    failed |= err != cudaSuccess || m32 || m64;
  }
  return failed;
}
