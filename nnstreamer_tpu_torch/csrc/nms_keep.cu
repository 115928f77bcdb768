// nms_keep: greedy IoU > 0.5 non-maximum suppression over score-ordered,
// integer-valued float32 pixel boxes, as one block on the card.
//
// Replaces the JAX package's Pallas TPU kernel ops/nms.py::pallas_nms_keep
// (pallas_call at :109).  The Python wrapper is
// nnstreamer_tpu_torch/ops/nms.py::pallas_nms_keep; its plain version is
// nms_keep there (suppression_matrix, then greedy_keep).
//
// What it computes: keep[i] starts as valid[i].  For i = 0..K-1 in order, a
// row i that is still kept clears keep[j] for every later row j it
// suppresses: with x2 = x + w, y2 = y + h, area = w * h,
//   iw = max(0, min(x2_i, x2_j) - max(x_i, x_j) + 1), ih likewise,
//   inter = iw * ih, union = (area_i + area_j) - inter,
//   suppressed when union > 0 and 2 * inter > union.
// An invalid row never survives and never suppresses.  The TPU kernel pads
// K to a multiple of 128 lanes with w = h = -1 and invalid rows; nothing is
// padded here, and a padded row could not change a verdict anyway.
//
// Bound on an H100: neither bytes nor operations.  At the detection path's
// K = 100 the kernel reads 1.7 KB and does about 16 float32 operations per
// examined pair, a fraction of a microsecond of either; what bounds it is
// the chain of dependent rows: row i's verdict needs every earlier kept
// row's.  Design: one block.  The boxes (x, y, x2, y2, area) and the keep
// mask go into shared memory once; then the block walks the rows in order,
// and for each kept row the threads split the later rows between them,
// followed by one __syncthreads.  A row that is not kept costs no barrier:
// all threads read the same keep byte, last written before the previous
// barrier.  So the cost is one barrier per surviving row, and the K x K
// suppression matrix is never stored.
//
// Numerics: every operation rounds on its own (__fadd_rn, __fsub_rn,
// __fmul_rn, and -fmad=false for the rest), in the plain version's order,
// so the verdicts equal the plain version's bit for bit even where areas
// pass 2^24 and float32 rounding decides them.  max and min propagate NaN,
// as torch.maximum / torch.minimum / clamp_min do.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8192;          // must match ops/nms.py::MAX_K
constexpr int kMaxThreads = 1024;
constexpr int kBytesPerRow = 5 * sizeof(float) + 1;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float clamp_min0(float v) {
  return is_nan(v) ? v : fmaxf(v, 0.0f);
}

__global__ void __launch_bounds__(kMaxThreads)
nms_keep_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, const float* __restrict__ h,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ out, int K) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + K;
  float* sx2 = sy + K;
  float* sy2 = sx2 + K;
  float* sarea = sy2 + K;
  uint8_t* keep = reinterpret_cast<uint8_t*>(sarea + K);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int j = tid; j < K; j += nthreads) {
    const float xj = x[j], yj = y[j], wj = w[j], hj = h[j];
    sx[j] = xj;
    sy[j] = yj;
    sx2[j] = __fadd_rn(xj, wj);
    sy2[j] = __fadd_rn(yj, hj);
    sarea[j] = __fmul_rn(wj, hj);
    keep[j] = valid[j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    if (!keep[i]) continue;  // uniform: no thread wrote keep[i] since the last barrier
    const float xi = sx[i], yi = sy[i], x2i = sx2[i], y2i = sy2[i], ai = sarea[i];
    for (int j = i + 1 + tid; j < K; j += nthreads) {
      if (!keep[j]) continue;
      const float iw = clamp_min0(__fadd_rn(__fsub_rn(min_nan(x2i, sx2[j]), max_nan(xi, sx[j])), 1.0f));
      const float ih = clamp_min0(__fadd_rn(__fsub_rn(min_nan(y2i, sy2[j]), max_nan(yi, sy[j])), 1.0f));
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(ai, sarea[j]), inter);
      if (uni > 0.0f && __fmul_rn(2.0f, inter) > uni) keep[j] = 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += nthreads) out[j] = keep[j];
}

}  // namespace

extern "C" int nns_nms_keep(const void* x, const void* y, const void* w, const void* h,
                            const void* valid, void* keep, int K, void* stream) {
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int smem = K * kBytesPerRow;
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = (K + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  nms_keep_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K);
  return (int)cudaGetLastError();
}
