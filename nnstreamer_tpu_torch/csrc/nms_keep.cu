// nms_keep: greedy IoU > 0.5 non-maximum suppression over score-ordered,
// integer-valued float32 pixel boxes, as one block on the card.
//
// Replaces the JAX package's Pallas TPU kernel ops/nms.py::pallas_nms_keep
// (pallas_call at :109).  The Python wrapper is
// nnstreamer_tpu_torch/ops/nms.py::pallas_nms_keep; its plain version is
// nms_keep there (suppression_matrix, then greedy_keep), and
// suppression_bits / bit_walk_keep there model this kernel's bit layout
// and walk on the CPU.
//
// What it computes: keep[i] starts as valid[i].  For i = 0..K-1 in order, a
// row i that is still kept clears keep[j] for every later row j it
// suppresses: with x2 = x + w, y2 = y + h, area = w * h,
//   iw = max(0, min(x2_i, x2_j) - max(x_i, x_j) + 1), ih likewise,
//   inter = iw * ih, union = (area_i + area_j) - inter,
//   suppressed when union > 0 and 2 * inter > union.
// An invalid row never survives and never suppresses; a suppressed row
// suppresses nothing.  The TPU kernel pads K to a multiple of 128 lanes with
// w = h = -1 and invalid rows; nothing is padded here.
//
// Bound on an H100: neither bytes nor operations.  At the detection path's
// K = 100 the kernel reads 1.7 KB and does about 16 float32 operations per
// pair, well under a microsecond of either; what bounds it is the chain of
// dependent rows, since row i's verdict needs every earlier kept row's.
//
// What held the first design back: it walked the rows with the whole block
// and paid one __syncthreads per kept row, behind dependent shared-memory
// loads of that row (89 barriers, 29 us, at K = 100 with 89 rows kept).
//
// Design, for K <= kBitsMaxK (the main path), one launch of one block:
// - Phase 1, all threads: the K x ceil(K/32) suppression-bit matrix,
//   bits[i][c] bit b = row i suppresses row 32c + b, set only for
//   32c + b > i.  A task tests one row against one column byte (8 columns)
//   and stores that byte.  Only the bytes on or above the diagonal have
//   tasks, numbered so that a warp takes consecutive rows of one column
//   byte: its lanes read the same column box at each step (a broadcast).
//   Every pair is tested whatever valid says; the walk applies valid.  A
//   box is one float4 (x, y, x2, y2) plus its area, and min, max and clamp
//   are single NaN-propagating instructions.  Then one barrier.
// - Phase 2, one warp, no block barrier: the removed mask lives in
//   registers, word c of it in lane c % 32.  For each 32-row chunk the
//   state is one uniform word, with the invalid rows set from the start: a
//   row whose bit is clear is kept and ORs in its diagonal word.  The 32
//   diagonal words come from one shared load, handed out by shuffles that
//   do not depend on the state, so each row costs two dependent
//   instructions.  Then each lane ORs the chunk's kept rows' words into its
//   own later word.  The bits are stored by word column (word c of row i at
//   c K + i), so that step reads 32 consecutive words.
// The bits take 4 K ceil(K/32) bytes of shared memory beside the boxes:
// kBitsMaxK = 1280 is the largest K whose layout fits in 227 KB.  Above it
// the kernel keeps the first design (one barrier per kept row), up to
// kMaxK rows.
//
// Numerics: every operation rounds on its own (__fadd_rn, __fsub_rn,
// __fmul_rn, and -fmad=false for the rest), in the plain version's order,
// so the verdicts equal the plain version's bit for bit even where areas
// pass 2^24 and float32 rounding decides them.  max and min propagate NaN,
// as torch.maximum / torch.minimum / clamp_min do (which NaN comes out, or
// the sign of a zero, never changes a verdict).
// The kernel allocates nothing and launches once, on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8192;       // must match ops/nms.py::MAX_K
constexpr int kBitsMaxK = 1280;   // must match ops/nms.py::BITS_MAX_K
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kStaticSmemLimit = 48 * 1024;
static_assert(kBitsMaxK <= 64 * 32, "the walk holds two words of the removed mask per lane");
constexpr unsigned kFull = 0xffffffffu;

// min, max and clamp_min(0) that propagate NaN, as torch.minimum,
// torch.maximum and clamp_min do: one min.NaN / max.NaN instruction each.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clamp_min0(float v) { return max_nan(v, 0.0f); }

// Row i (the earlier, kept row) suppresses row j, in the plain version's
// operation order; a box is (x, y, x2, y2) and its area.
__device__ __forceinline__ bool suppresses(float4 bi, float ai, float4 bj, float aj) {
  const float iw = clamp_min0(__fadd_rn(__fsub_rn(min_nan(bi.z, bj.z), max_nan(bi.x, bj.x)), 1.0f));
  const float ih = clamp_min0(__fadd_rn(__fsub_rn(min_nan(bi.w, bj.w), max_nan(bi.y, bj.y)), 1.0f));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  return uni > 0.0f && __fmul_rn(2.0f, inter) > uni;
}

// One row of the walk within a chunk: the row (bit `bit` of the chunk) is
// kept when its bit of `rem` is clear, and then ORs in `dv`, its diagonal
// word.  Two dependent instructions, a bit test into a predicate and a
// predicated OR: the chain that sets the walk's time.
__device__ __forceinline__ uint32_t walk_step(uint32_t rem, uint32_t bit, uint32_t dv) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %1;\n\tsetp.eq.u32 p, t, 0;\n\t@p or.b32 %0, %0, %2;\n\t}"
      : "+r"(rem)
      : "r"(bit), "r"(dv));
  return rem;
}

// The OR of the words at `col` (32 consecutive rows of one word column) of
// the rows kept in `keep`; 0 when `active` is false.  The loads do not wait
// on `keep`, and each row costs a load and a predicated OR.
__device__ __forceinline__ uint32_t later_words(const uint32_t* col, uint32_t keep, bool active) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};  // four short OR chains, not one long one
  if (active) {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const uint32_t v = col[r];
      if (keep & (1u << r)) acc[r & 3] |= v;
    }
  }
  return (acc[0] | acc[1]) | (acc[2] | acc[3]);
}

// Row j's (x, y, x2 = x + w, y2 = y + h) and area = w * h, into shared memory.
__device__ __forceinline__ void load_box(int j, const float* __restrict__ x,
                                         const float* __restrict__ y,
                                         const float* __restrict__ w,
                                         const float* __restrict__ h, float4* box, float* area) {
  const float xj = x[j], yj = y[j], wj = w[j], hj = h[j];
  box[j] = make_float4(xj, yj, __fadd_rn(xj, wj), __fadd_rn(yj, hj));
  area[j] = __fmul_rn(wj, hj);
}

// Shared memory, in order: the boxes (K float4), the areas (K floats), the
// bits (K * W words, word column c of all rows at c * K, then 32 words of
// slack for the walk's reads past row K - 1), the valid mask (W words).
// ops/nms.py::bits_smem_bytes.
__global__ void __launch_bounds__(kMaxThreads)
nms_bits_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, const float* __restrict__ h,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ out, int K) {
  extern __shared__ float4 smem_bits_layout[];
  const int W = (K + 31) >> 5;
  float4* box = smem_bits_layout;
  float* area = reinterpret_cast<float*>(box + K);
  uint32_t* bits = reinterpret_cast<uint32_t*>(area + K);
  uint32_t* vbits = bits + K * W + 32;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // a multiple of 32
  // The boxes and the valid mask in one pass (one memory round trip); the
  // loop runs over whole warps, so the ballot is uniform.
  for (int j = tid; j < W * 32; j += nthreads) {
    bool v = false;
    if (j < K) {
      v = valid[j] != 0;
      load_box(j, x, y, w, h, box, area);
    }
    const unsigned vb = __ballot_sync(kFull, v);
    if ((j & 31) == 0) vbits[j >> 5] = vb;
  }
  for (int j = tid; j < K * W; j += nthreads) bits[j] = 0;
  __syncthreads();

  // Phase 1: each task tests one row against 8 columns (one column byte)
  // and stores the byte of bits.  Only the tasks on or above the diagonal
  // exist: column byte cb needs rows 0 .. min(K, 8 cb + 7) - 1, so the
  // first L + 1 column bytes hold 8 cb + 7 rows each (a triangle, task t
  // of it in column byte cb where 4 cb^2 + 3 cb <= t) and the rest K rows
  // each.  Consecutive tasks are consecutive rows of one column byte: a
  // warp reads the same column boxes (a broadcast).  The bytes below the
  // diagonal were zeroed with the loads.
  uint8_t* bit_bytes = reinterpret_cast<uint8_t*>(bits);
  const int nb = 4 * W;
  const int last = min(nb - 1, K >= 7 ? (K - 7) / 8 : -1);
  const int tri = 4 * (last + 1) * (last + 1) + 3 * (last + 1);
  const int ntasks = tri + (nb - last - 1) * K;
  for (int t = tid; t < ntasks; t += nthreads) {
    int cb, i;
    if (t < tri) {
      cb = static_cast<int>((sqrtf(9.0f + 16.0f * static_cast<float>(t)) - 3.0f) * 0.125f);
      while (cb > 0 && 4 * cb * cb + 3 * cb > t) --cb;
      while (4 * (cb + 1) * (cb + 1) + 3 * (cb + 1) <= t) ++cb;
      i = t - (4 * cb * cb + 3 * cb);
    } else {
      cb = last + 1 + (t - tri) / K;
      i = t - tri - (cb - last - 1) * K;
    }
    const int j0 = cb * 8;
    const float4 bi = box[i];
    const float ai = area[i];
    // Columns j0..j0+7 are tested whole (a column past K reads row K - 1);
    // those at or below the diagonal or past K are masked off.
    uint32_t byte = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = min(j0 + b, K - 1);
      if (suppresses(bi, ai, box[j], area[j])) byte |= 1u << b;
    }
    byte &= (0xffu << max(0, i - j0 + 1)) & (0xffu >> max(0, j0 + 8 - K));
    bit_bytes[((cb >> 2) * K + i) * 4 + (cb & 3)] = static_cast<uint8_t>(byte);
  }
  __syncthreads();

  // Phase 2: the greedy walk, in warp 0 alone.
  if (tid >= 32) return;
  const int lane = tid;
  uint32_t removed_lo = 0, removed_hi = 0;  // words lane and lane + 32 of the removed mask
  for (int c = 0; c < W; ++c) {
    const int r0 = c * 32;
    const uint32_t* column = bits + c * K + r0;  // word c of rows r0, r0 + 1, ...
    const uint32_t vmask = vbits[c];  // 0 for rows at or past K
    const uint32_t diag = r0 + lane < K ? column[lane] : 0u;
    // An invalid row (or one at or past K) starts out removed: it is never
    // kept, so it never ORs in its word.
    uint32_t rem = __shfl_sync(kFull, c < 32 ? removed_lo : removed_hi, c & 31) | ~vmask;
#pragma unroll
    for (int r = 0; r < 32; ++r) rem = walk_step(rem, 1u << r, __shfl_sync(kFull, diag, r));
    // A bit of rem is only ever set by an earlier row of the chunk, so the
    // rows kept are those whose bit stayed clear.
    const uint32_t keep = ~rem;
    if (r0 + lane < K) out[r0 + lane] = (keep >> lane) & 1u;
    removed_lo |= later_words(bits + lane * K + r0, keep, lane > c && lane < W);
    if (W > 32)
      removed_hi |= later_words(bits + (lane + 32) * K + r0, keep, lane + 32 > c && lane + 32 < W);
  }
}

// Above kBitsMaxK: the block walks the rows in order, one barrier per kept
// row, with the threads splitting the later rows.  Shared memory: the
// boxes, the areas, the keep bytes.
__global__ void __launch_bounds__(kMaxThreads)
nms_walk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, const float* __restrict__ h,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ out, int K) {
  extern __shared__ float4 smem_walk_layout[];
  float4* box = smem_walk_layout;
  float* area = reinterpret_cast<float*>(box + K);
  uint8_t* keep = reinterpret_cast<uint8_t*>(area + K);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int j = tid; j < K; j += nthreads) {
    keep[j] = valid[j] != 0;
    load_box(j, x, y, w, h, box, area);
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    if (!keep[i]) continue;  // uniform: no thread wrote keep[i] since the last barrier
    const float4 bi = box[i];
    const float ai = area[i];
    for (int j = i + 1 + tid; j < K; j += nthreads) {
      if (keep[j] && suppresses(bi, ai, box[j], area[j])) keep[j] = 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += nthreads) out[j] = keep[j];
}

}  // namespace

extern "C" int nns_nms_keep(const void* x, const void* y, const void* w, const void* h,
                            const void* valid, void* keep, int K, void* stream) {
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const bool use_bits = K <= kBitsMaxK;
  const int W = (K + 31) / 32;
  const int smem = use_bits ? 16 * K + 4 * K + 4 * (K * W + 32) + 4 * W : 16 * K + 4 * K + K;
  const int work = use_bits ? K * W * 4 : K;
  int threads = (work + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, const float*, const uint8_t*,
                 uint8_t*, int) = use_bits ? nms_bits_kernel : nms_walk_kernel;
  if (smem > kStaticSmemLimit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K);
  return (int)cudaGetLastError();
}
