// int8_matmul: out = (x_q . w_q) * (x_scale * w_scale[n]) + bias[n]
// with int8 operands, exact int32 accumulation and float32 output.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_kernels.py::int8_matmul (pallas_call at :189).  The Python
// wrapper is nnstreamer_tpu_torch/ops/kernels.py::int8_matmul; it picks the
// branch and the split-K geometry (ops/kernels.py::int8_matmul_geometry)
// and passes k_per_rank here, and ops/kernels.py::weight_reads models the
// small-M branch's weight loads for the CPU tests.
//
// Bound on an H100: memory at the classifier head's shape (M=1, K=1280,
// N=1001): the 1.28 MB int8 weight is read once for 2.56 M integer
// operations, about 0.39 us at 3.35 TB/s.  At M=1 the product does 2
// operations per weight byte, far below the card's ridge, so tensor cores
// buy nothing; what counts is getting the whole weight in flight at once.
//
// What held the first design (the tiled branch below) back at that shape:
// 32 blocks (100 of 132 SMs idle), each walking 10 K-tiles in series with a
// memory round trip and two barriers per tile, reading the weight one byte
// per thread per load, with 31 of 32 rows of each x tile padding.  17.5 us.
//
// Small-M branch (M <= kMaxSmallM), the main path: a split-K GEMV.
// - Grid: N in tiles of kTileN = 64 columns, each tile a cluster of kSplit =
//   8 blocks along K (k_per_rank rows each, a multiple of 4): 16 tiles x 8 =
//   128 blocks at N = 1001.  Every block takes all M rows of x, so the
//   weight is read once per call whatever M is.
// - Loads: a block issues all of its weight loads up front, in passes of up
//   to kPassK rows (one pass at K = 1280).  N = 1001 is odd, so each row
//   segment of 64 bytes starts at an arbitrary byte.  The block copies the
//   aligned 16-byte windows that hold the segment, whole, by cp.async, into
//   a shared 80-byte row that keeps the segment's 16-byte phase.  A
//   window's bytes beyond the segment belong to the same tensor (its
//   neighbouring columns or rows: 24% more bytes at the head's shape, from
//   L2) and land where no product reads; only the windows that cross the
//   tensor's first or last byte are copied byte by byte.  Every weight byte
//   reaches the products once, no byte outside the tensor is read, and any
//   data_ptr alignment works.  Loading the segments' ragged ends byte by
//   byte instead, with 16-byte copies of the aligned interior only, was
//   three times slower: the byte loads' address math and latency, not
//   bytes, set the time.
// - Products: 4 k-groups x 64 columns of threads; each packs 4 rows of its
//   column into one __dp4a word and takes all M rows of x from shared.
//   M is rounded up to 1, 4 or 16 at compile time (zero rows of x beyond
//   M), so the loop has no branches; rows 16 apart share their 16-byte
//   phase, so the byte offsets step by a constant.
// - Reduction: each block sums its k-groups and writes the sums into rank
//   0's shared memory (distributed shared memory); after one cluster
//   barrier rank 0 adds the 8 ranks' sums (integer addition: exact in any
//   order) and applies the epilogue, and the other blocks are done.  A
//   split barrier (arrive at the start, wait before the writes) makes sure
//   rank 0 has started.  No global scratch, no atomics, one launch.
// Larger M keeps the tiled kernel (BM x BN output tiles, BK-deep K tiles
// in shared memory).  A tensor-core branch waits for a caller with large M.
//
// The accumulator is exact for K*127*127 < 2^31.  The epilogue keeps the
// JAX order, acc_f32 * (xs * ws[n]) + b[n], with round-to-nearest
// intrinsics and no fused multiply-add, so it is bitwise equal to the plain
// PyTorch version.  The kernels allocate nothing and launch once, on the
// caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// -- small-M branch: split-K GEMV over a thread-block cluster ---------------

constexpr int kMaxSmallM = 16;  // must match ops/kernels.py::SMALL_M
constexpr int kSplit = 8;       // cluster size along K; ops/kernels.py::SPLIT_K
constexpr int kTileN = 64;      // output columns per cluster; ops/kernels.py::TILE_N
constexpr int kPassK = 256;     // K rows staged per pass; ops/kernels.py::PASS_K
constexpr int kGemvThreads = 256;
constexpr int kGroups = kGemvThreads / kTileN;  // 4 k-groups
constexpr int kWin = 16;                        // bytes of one cp.async
constexpr int kRowBytes = kTileN + kWin;        // 80: a segment keeps its 16-byte phase
constexpr int kWindows = kRowBytes / kWin;      // 5 windows hold any 64-byte segment
constexpr int kUnits = (kPassK * kWindows + kGemvThreads - 1) / kGemvThreads;  // per thread
static_assert(kPassK <= kGemvThreads, "x is staged one byte per thread and row");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MT>
constexpr int splitk_smem_bytes() {
  return kPassK * kRowBytes + MT * kPassK + (kGroups + kSplit) * MT * kTileN * 4;
}

// MT is M rounded up to 1, 4 or 16: x rows from M to MT are zeros.
template <int MT>
__global__ void __launch_bounds__(kGemvThreads)
int8_gemv_splitk_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int M, int K, int N, int k_per_rank) {
  // Dynamic shared memory (splitk_smem_bytes<MT>): the staged weight rows,
  // the staged x, this block's partial sums per k-group, and (read on rank 0
  // only) every rank's partial sums, gathered through distributed shared
  // memory.
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sw = smem;
  int* sx = reinterpret_cast<int*>(smem + kPassK * kRowBytes);
  int* part = sx + MT * (kPassK / 4);
  int* gather = part + kGroups * MT * kTileN;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // Before a block writes to rank 0's shared memory, rank 0 must have
  // started: arrive now, wait just before the writes, so the wait costs
  // nothing by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int c = tid % kTileN;
  const int g = tid / kTileN;
  const int n0 = blockIdx.y * kTileN;
  const int ncols = min(kTileN, N - n0);
  const int kbeg = rank * k_per_rank;
  const int kend = min(K, kbeg + k_per_rank);
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  const unsigned base_phase = static_cast<unsigned>(reinterpret_cast<uintptr_t>(wb));
  const long long size = (long long)K * N;
  uint8_t* sxb = reinterpret_cast<uint8_t*>(sx);

  int acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0;

  for (int kt = kbeg; kt < kend; kt += kPassK) {
    const int rows = min(kPassK, kend - kt);
    const int rows4 = (rows + 3) & ~3;
    // Weight: the 16-byte windows that hold row r's segment, whole, one
    // cp.async each: window v lands at sw[r * 80 + 16 v], so the segment's
    // byte at column col sits at phase + col.  The bytes a window holds
    // beyond the segment belong to the neighbouring columns or rows of the
    // same tensor and land where no product reads.  Only a window that
    // crosses the tensor's first or last byte (at most two in the whole
    // weight) is copied byte by byte, within the tensor.
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = tid + i * kGemvThreads;
      const int r = u / kWindows;
      const int v = u - r * kWindows;
      if (r < rows) {
        const long long off = (long long)(kt + r) * N + n0;
        const int phase = static_cast<int>((base_phase + static_cast<unsigned>(off)) & (kWin - 1));
        const long long wo = off - phase + kWin * v;  // the window's first byte
        uint8_t* dst = sw + r * kRowBytes + kWin * v;
        if (kWin * v < phase + ncols) {
          if (wo >= 0 && wo + kWin <= size) {
            cp_async16(dst, wb + wo);
          } else {
            for (int b = 0; b < kWin; ++b)
              if (wo + b >= 0 && wo + b < size) dst[b] = wb[wo + b];
          }
        }
      }
    }
    // x: every row m < MT of the pass's K range, one byte per thread and
    // row, zero for m >= M and past the range's end.
    if (tid < rows4) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        sxb[m * kPassK + tid] =
            m < M && tid < rows ? static_cast<uint8_t>(x[(long long)m * K + kt + tid]) : 0;
    }
    cp_async_wait_all();
    __syncthreads();

    // Products: thread (c, g) takes the k-quads q = g, g + 4, ..., i.e. rows
    // 4q + j, j < 4.  Rows 16 apart share their 16-byte phase, so each j
    // has one shared offset that steps by 16 rows.  Rows from `rows` to
    // rows4 meet zeros in x, whatever shared memory holds there.
    if (c < ncols) {
      int offs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 4 * g + j;
        const unsigned off = static_cast<unsigned>((long long)(kt + kk) * N + n0);
        offs[j] = kk * kRowBytes + static_cast<int>((base_phase + off) & (kWin - 1)) + c;
      }
      const int nq = rows4 / 4;
#pragma unroll 4
      for (int q = g; q < nq; q += kGroups) {
        const int step = (q - g) / kGroups * 16 * kRowBytes;
        const unsigned word = static_cast<unsigned>(sw[offs[0] + step]) |
                              (static_cast<unsigned>(sw[offs[1] + step]) << 8) |
                              (static_cast<unsigned>(sw[offs[2] + step]) << 16) |
                              (static_cast<unsigned>(sw[offs[3] + step]) << 24);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m] = __dp4a(sx[m * (kPassK / 4) + q], static_cast<int>(word), acc[m]);
      }
    }
    __syncthreads();
  }

  // This block's partial sums: part[g][m][c], summed over g and written to
  // rank 0's gather[rank][m][c].  One cluster barrier then makes every
  // rank's sums visible to rank 0, which alone goes on: no block reads
  // another's shared memory after it, so the others may leave.
#pragma unroll
  for (int m = 0; m < MT; ++m) part[(g * MT + m) * kTileN + c] = acc[m];
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  int* dst = cluster.map_shared_rank(gather, 0) + rank * MT * kTileN;
  for (int e = tid; e < M * kTileN; e += kGemvThreads) {
    const int m = e / kTileN;
    const int cc = e - m * kTileN;
    int s = 0;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) s += part[(gg * MT + m) * kTileN + cc];
    dst[m * kTileN + cc] = s;
  }
  cluster.sync();
  if (rank != 0) return;
  const float xs = x_scale[0];
  for (int e = tid; e < M * ncols; e += kGemvThreads) {
    const int m = e / ncols;
    const int cc = e - m * ncols;
    int s = 0;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) s += gather[(r * MT + m) * kTileN + cc];
    const int n = n0 + cc;
    const float b = bias != nullptr ? bias[n] : 0.0f;
    out[(long long)m * N + n] = __fadd_rn(__fmul_rn(static_cast<float>(s),
                                                    __fmul_rn(xs, w_scale[n])), b);
  }
}

// -- larger M: output tiles, K walked in shared-memory tiles -----------------

constexpr int BM = 32;   // output rows per block
constexpr int BN = 32;   // output columns per block (one per thread column)
constexpr int BK = 128;  // K depth of one shared-memory tile
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / BN;        // 8
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

// Clusters of each small-M kernel that fit on the card at once, checked once.
template <int MT>
int splitk_clusters = -1;

template <int MT>
int launch_splitk(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                  const float* b, float* out, int M, int K, int N, int k_per_rank,
                  cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, (N + kTileN - 1) / kTileN, 1);
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = splitk_smem_bytes<MT>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (splitk_clusters<MT> < 0) {
    cudaError_t err = cudaFuncSetAttribute(int8_gemv_splitk_kernel<MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           splitk_smem_bytes<MT>());
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, int8_gemv_splitk_kernel<MT>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;  // a cluster of 8 cannot be placed
    splitk_clusters<MT> = n;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_gemv_splitk_kernel<MT>, x, w, xs, ws,
                                             b, out, M, K, N, k_per_rank);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// k_per_rank > 0 takes the small-M split-K branch with that many K rows per
// cluster rank; 0 takes the tiled branch.
extern "C" int nns_int8_matmul(const void* x, const void* w, const void* x_scale,
                               const void* w_scale, const void* bias, void* out,
                               int M, int K, int N, int k_per_rank, void* stream) {
  if (M <= 0 || K < 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const auto xq = static_cast<const int8_t*>(x);
  const auto wq = static_cast<const int8_t*>(w);
  const auto xs = static_cast<const float*>(x_scale);
  const auto ws = static_cast<const float*>(w_scale);
  const auto b = static_cast<const float*>(bias);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k_per_rank > 0) {
    if (M > kMaxSmallM || k_per_rank % 4 != 0 || (long long)k_per_rank * kSplit < K)
      return (int)cudaErrorInvalidValue;
    if (M == 1) return launch_splitk<1>(xq, wq, xs, ws, b, o, M, K, N, k_per_rank, s);
    if (M <= 4) return launch_splitk<4>(xq, wq, xs, ws, b, o, M, K, N, k_per_rank, s);
    return launch_splitk<16>(xq, wq, xs, ws, b, o, M, K, N, k_per_rank, s);
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, kThreads, 0, s>>>(xq, wq, xs, ws, b, o, M, K, N);
  return (int)cudaGetLastError();
}
