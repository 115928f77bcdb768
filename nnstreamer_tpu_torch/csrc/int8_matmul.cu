// int8_matmul: out = (x_q . w_q) * (x_scale * w_scale[n]) + bias[n]
// with int8 operands, exact int32 accumulation and float32 output.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_kernels.py::int8_matmul (pallas_call at :189).  The Python wrapper is
// nnstreamer_tpu_torch/ops/kernels.py::int8_matmul.
//
// Bound on an H100: memory at the classifier head's shape (M=1, K=1280,
// N=1001): the 1.28 MB int8 weight is streamed once for 2.56 M integer
// operations, about 0.39 us at 3.35 TB/s.  The TPU kernel keeps the whole
// K extent in VMEM; a block here has far less shared memory, so K is walked
// in BK-deep shared-memory tiles instead, and each block owns a BM x BN
// output tile.  The products use __dp4a (four int8 products summed into an
// int32 per instruction), and the accumulator is exact for K*127*127 < 2^31.
// The ragged edges of M, N and K are masked inside the kernel, so the weight
// is used as it lies, never padded or copied per call.  The epilogue keeps
// the JAX order, acc_f32 * (xs * ws[n]) + b[n], with round-to-nearest
// intrinsics and no fused multiply-add, so it is bitwise equal to the plain
// PyTorch version.  Tensor-core MMA, cp.async/TMA pipelining and split-K for
// the single-row case are left for later work.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;   // output rows per block
constexpr int BN = 32;   // output columns per block (one per thread column)
constexpr int BK = 128;  // K depth of one shared-memory tile
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / BN;   // 8
constexpr int kRowsPerThread = BM / kRowGroups;  // 4
constexpr int kXLoads = BM * BK / kThreads;      // x-tile bytes per thread
constexpr int kWLoads = BK * BN / kThreads;      // w-tile bytes per thread

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int K, int N) {
  __shared__ __align__(16) int8_t sx[BM][BK];
  __shared__ __align__(16) int8_t sw[BK][BN];

  const int tid = threadIdx.x;
  const int tn = tid % BN;
  const int tm = tid / BN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[kRowsPerThread] = {0, 0, 0, 0};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // All of a tile's global loads go out before any lands in shared
    // memory, so a tile costs about one memory latency, not one per load.
    int8_t xr[kXLoads], wr[kWLoads];
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      const int m = m0 + i / BK, k = k0 + i % BK;
      xr[j] = (m < M && k < K) ? x[(long long)m * K + k] : (int8_t)0;
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      const int k = k0 + i / BN, n = n0 + i % BN;
      wr[j] = (k < K && n < N) ? w[(long long)k * N + n] : (int8_t)0;
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      sx[i / BK][i % BK] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      sw[i / BN][i % BN] = wr[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; kk += 4) {
      const unsigned b = (unsigned)(uint8_t)sw[kk][tn] |
                         ((unsigned)(uint8_t)sw[kk + 1][tn] << 8) |
                         ((unsigned)(uint8_t)sw[kk + 2][tn] << 16) |
                         ((unsigned)(uint8_t)sw[kk + 3][tn] << 24);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int a = *reinterpret_cast<const int*>(&sx[tm + r * kRowGroups][kk]);
        acc[r] = __dp4a(a, (int)b, acc[r]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tn;
  if (n >= N) return;
  const float s = __fmul_rn(x_scale[0], w_scale[n]);
  const float b = bias != nullptr ? bias[n] : 0.0f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + tm + r * kRowGroups;
    if (m < M) out[(long long)m * N + n] = __fadd_rn(__fmul_rn((float)acc[r], s), b);
  }
}

}  // namespace

extern "C" int nns_int8_matmul(const void* x, const void* w, const void* x_scale,
                               const void* w_scale, const void* bias, void* out,
                               int M, int K, int N, void* stream) {
  if (M <= 0 || K < 0 || N <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
