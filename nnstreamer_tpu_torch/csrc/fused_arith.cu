// fused_arith: one elementwise pass of a tensor_transform chain
// (typecast, add, sub, mul, div, clamp) on the card.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_kernels.py::fused_arith (pallas_call at :113).  The Python wrapper is
// nnstreamer_tpu_torch/ops/kernels.py::fused_arith, which binds the chain:
// it works out each step's result dtype under the JAX promotion rules and
// passes the steps here by value.
//
// Bound on an H100: memory.  Every element is read once and written once;
// the chain does a handful of operations per element.  At the image-labeling
// path's shape (224x224x3 uint8 -> float32) that is 150,528 B in and
// 602,112 B out, about 0.22 us at 3.35 TB/s, so the launch itself dominates.
// Design: a grid-stride loop, one element per thread per trip, templated on
// the input and output type so loads and stores are typed; the chain is
// interpreted per element from a small struct kept in kernel parameters
// (uniform across the grid, so the switch never diverges).
//
// Numerics follow the JAX kernel:
// - each step computes in its own result dtype (int steps wrap at the
//   dtype's width; float16 steps compute in float32 and round to half after
//   every step, which is exact for + - * since float32 holds 2*11+2 bits);
// - division by a literal arrives as a multiplication by its reciprocal,
//   which is what XLA compiles x / const into on every backend;
// - round-to-nearest intrinsics throughout (__fadd_rn, __fmul_rn, ...), no
//   fused multiply-add, so the normalize chain is bitwise equal to JAX's;
// - float -> int conversion saturates and maps NaN to 0, as XLA's convert;
// - clamp is XLA's max(lo, x) then min(hi, x): NaN propagates.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Outside the unnamed namespace: the extern "C" entry point takes a Chain,
// and a type with internal linkage would make that symbol local.
constexpr int kMaxSteps = 8;

// Must match ops/kernels.py::_Step / _Chain (ctypes).
struct Step {
  int op;
  int dt;    // result dtype of this step
  double a;  // operand, or clamp's lower bound
  double b;  // clamp's upper bound
};

struct Chain {
  int start_dt;  // dtype the chain starts from (narrow ints promoted to I32)
  int n_steps;
  Step steps[kMaxSteps];
};

namespace {

enum Dt { U8 = 0, I8 = 1, U16 = 2, I16 = 3, U32 = 4, I32 = 5, F16 = 6, F32 = 7 };
enum Op { TYPECAST = 0, ADD = 1, SUB = 2, MUL = 3, CLAMP = 5 };

struct Val {
  long long i;  // integer dtypes, wrapped to the current dtype's range
  float f;      // float dtypes (a float16 value is held exactly as float)
};

__device__ __forceinline__ bool is_int(int dt) { return dt <= I32; }

__device__ __forceinline__ float round_half(float f) {
  return __half2float(__float2half_rn(f));
}

__device__ __forceinline__ long long wrap(long long v, int dt) {
  unsigned long long u = (unsigned long long)v;
  switch (dt) {
    case U8: return (long long)(uint8_t)u;
    case I8: return (long long)(int8_t)(uint8_t)u;
    case U16: return (long long)(uint16_t)u;
    case I16: return (long long)(int16_t)(uint16_t)u;
    case U32: return (long long)(uint32_t)u;
    default: return (long long)(int32_t)(uint32_t)u;
  }
}

__device__ __forceinline__ long long float_to_int(float f, int dt) {
  if (f != f) return 0;
  double lo, hi;
  switch (dt) {
    case U8: lo = 0.0; hi = 255.0; break;
    case I8: lo = -128.0; hi = 127.0; break;
    case U16: lo = 0.0; hi = 65535.0; break;
    case I16: lo = -32768.0; hi = 32767.0; break;
    case U32: lo = 0.0; hi = 4294967295.0; break;
    default: lo = -2147483648.0; hi = 2147483647.0; break;
  }
  double t = trunc((double)f);
  t = t < lo ? lo : t;
  t = t > hi ? hi : t;
  return (long long)t;
}

// Change the value's dtype from cur to dt (astype semantics).
__device__ __forceinline__ void convert(Val& v, int cur, int dt) {
  if (cur == dt) return;
  if (is_int(dt)) {
    v.i = is_int(cur) ? wrap(v.i, dt) : float_to_int(v.f, dt);
  } else {
    float f = is_int(cur) ? __ll2float_rn(v.i) : v.f;
    v.f = dt == F16 ? round_half(f) : f;
  }
}

// A Python literal in a float dtype: rounded once, from double.
__device__ __forceinline__ float float_literal(double a, int dt) {
  return dt == F16 ? __half2float(__double2half(a)) : __double2float_rn(a);
}

__device__ __forceinline__ void apply_step(Val& v, const Step& s) {
  if (s.op == TYPECAST) return;
  if (is_int(s.dt)) {
    unsigned long long x = (unsigned long long)v.i;
    unsigned long long y = (unsigned long long)(long long)s.a;
    switch (s.op) {
      case ADD: v.i = wrap((long long)(x + y), s.dt); break;
      case SUB: v.i = wrap((long long)(x - y), s.dt); break;
      case MUL: v.i = wrap((long long)(x * y), s.dt); break;
      case CLAMP: {
        long long lo = (long long)s.a, hi = (long long)s.b;
        v.i = lo >= v.i ? lo : v.i;
        v.i = hi <= v.i ? hi : v.i;
        break;
      }
      default: break;
    }
    return;
  }
  float a = float_literal(s.a, s.dt);
  float r = v.f;
  switch (s.op) {
    case ADD: r = __fadd_rn(r, a); break;
    case SUB: r = __fsub_rn(r, a); break;
    case MUL: r = __fmul_rn(r, a); break;
    case CLAMP: {
      float hi = float_literal(s.b, s.dt);
      r = a >= r ? a : r;
      r = hi <= r ? hi : r;
      break;
    }
    default: break;
  }
  v.f = s.dt == F16 ? round_half(r) : r;
}

template <typename T> struct Io;
#define INT_IO(T)                                                        \
  template <> struct Io<T> {                                             \
    static __device__ __forceinline__ void load(T x, Val& v) { v.i = x; }  \
    static __device__ __forceinline__ T store(const Val& v) { return (T)v.i; } \
  };
INT_IO(uint8_t)
INT_IO(int8_t)
INT_IO(uint16_t)
INT_IO(int16_t)
INT_IO(uint32_t)
INT_IO(int32_t)
#undef INT_IO
template <> struct Io<__half> {
  static __device__ __forceinline__ void load(__half x, Val& v) { v.f = __half2float(x); }
  static __device__ __forceinline__ __half store(const Val& v) { return __float2half_rn(v.f); }
};
template <> struct Io<float> {
  static __device__ __forceinline__ void load(float x, Val& v) { v.f = x; }
  static __device__ __forceinline__ float store(const Val& v) { return v.f; }
};

template <typename InT, typename OutT>
__global__ void fused_arith_kernel(const InT* __restrict__ x, OutT* __restrict__ y,
                                   long long n, int in_dt, int out_dt, Chain c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    Val v{0, 0.0f};
    Io<InT>::load(x[i], v);
    convert(v, in_dt, c.start_dt);
    int cur = c.start_dt;
    for (int k = 0; k < c.n_steps; ++k) {
      convert(v, cur, c.steps[k].dt);
      cur = c.steps[k].dt;
      apply_step(v, c.steps[k]);
    }
    convert(v, cur, out_dt);
    y[i] = Io<OutT>::store(v);
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* x, void* y, long long n, int in_dt, int out_dt,
                   const Chain& c, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks/SM
  fused_arith_kernel<InT, OutT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const InT*>(x), static_cast<OutT*>(y), n, in_dt, out_dt, c);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t launch_out(const void* x, void* y, long long n, int in_dt, int out_dt,
                       const Chain& c, cudaStream_t s) {
  switch (out_dt) {
    case U8: return launch<InT, uint8_t>(x, y, n, in_dt, out_dt, c, s);
    case I8: return launch<InT, int8_t>(x, y, n, in_dt, out_dt, c, s);
    case U16: return launch<InT, uint16_t>(x, y, n, in_dt, out_dt, c, s);
    case I16: return launch<InT, int16_t>(x, y, n, in_dt, out_dt, c, s);
    case U32: return launch<InT, uint32_t>(x, y, n, in_dt, out_dt, c, s);
    case I32: return launch<InT, int32_t>(x, y, n, in_dt, out_dt, c, s);
    case F16: return launch<InT, __half>(x, y, n, in_dt, out_dt, c, s);
    case F32: return launch<InT, float>(x, y, n, in_dt, out_dt, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int nns_fused_arith(const void* x, void* y, long long n, int in_dt,
                               int out_dt, const Chain* chain, void* stream) {
  if (n <= 0 || chain == nullptr || chain->n_steps < 0 || chain->n_steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  const Chain c = *chain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dt) {
    case U8: return (int)launch_out<uint8_t>(x, y, n, in_dt, out_dt, c, s);
    case I8: return (int)launch_out<int8_t>(x, y, n, in_dt, out_dt, c, s);
    case U16: return (int)launch_out<uint16_t>(x, y, n, in_dt, out_dt, c, s);
    case I16: return (int)launch_out<int16_t>(x, y, n, in_dt, out_dt, c, s);
    case U32: return (int)launch_out<uint32_t>(x, y, n, in_dt, out_dt, c, s);
    case I32: return (int)launch_out<int32_t>(x, y, n, in_dt, out_dt, c, s);
    case F16: return (int)launch_out<__half>(x, y, n, in_dt, out_dt, c, s);
    case F32: return (int)launch_out<float>(x, y, n, in_dt, out_dt, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
