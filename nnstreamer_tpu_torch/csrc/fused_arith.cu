// fused_arith: one elementwise pass of a tensor_transform chain
// (typecast, add, sub, mul, div, clamp) on the card.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_kernels.py::fused_arith (pallas_call at :113).  The Python wrapper is
// nnstreamer_tpu_torch/ops/kernels.py::fused_arith.  The host lowers each
// (input dtype, chain) once into a Program (ops/kernels.py::lower_chain): for
// each step a conversion code, an operation code, a post code and the
// operands as 32-bit patterns, float literals already rounded to the step's
// dtype.  The kernel takes it as a __grid_constant__ parameter and reads it
// with every index known at compile time (the step loop is unrolled over
// kMaxSteps), so nothing goes to local memory.
//
// Bound on an H100: memory.  Every element is read once and written once,
// with one conversion and a few float operations.  The normalize chain on a
// (224,224,3) uint8 frame moves 150,528 B in and 602,112 B out: 0.22 us at
// 3.35 TB/s, below the cost of any launch, so at the path's shapes the
// launch sets the floor.  A 4K frame (2160x3840x3) moves 124.4 MB, more than
// the 50 MB L2: 37.1 us.  The operations stay under the bytes: integer to
// float conversions run at 16 per clock per SM, 3.7e12/s on 132 SMs.
// Shared memory, tensor cores and TMA buy nothing here: each byte is
// touched once, by one thread, with no reuse and no reduction.
//
// Design:
// - 16-byte vector I/O: each thread loads 16 bytes of input (16 uint8, 8 of
//   a 2-byte type, 4 of a 4-byte type).  A vector's outputs of 16 bytes or
//   fewer go out in one aligned store of their width (one 4-byte store for
//   float32 -> uint8); outputs of 32 or 64 bytes (4 x 16 B for uint8 ->
//   float32) are staged through shared memory by the warp, so that every
//   store instruction writes 512 contiguous bytes.  That staging is what
//   reaches the bytes bound: the output is 4 bytes for every byte in, and
//   stores of 16 bytes at a 64-byte stride across a warp held a 4K frame
//   to about half of it (PERF.md, findings).  The vector body starts at the
//   first element where both x and y are aligned
//   (ops/kernels.py::fused_arith_geometry); the elements before it and
//   after the last whole vector are a scalar branch of the same kernel, so
//   any element-aligned view is taken.
// - A grid sized to the card and the tensor: one vector per thread, in
//   kThreads-thread blocks, ceil(vectors / kThreads) of them: 74 blocks at
//   (224,224,3) and 132 at (300,300,3), one wave on 132 SMs; 12,150 at 4K,
//   where blocks retire and start in address order.  A grid-stride loop
//   over 132 x 8 blocks with up to 4 loads in flight per thread measured
//   slower at every size (PERF.md, findings).
// - Two variants, chosen on the host from the program:
//   FLOAT_CHAIN (every step computes in float32, as the normalize chain):
//   one conversion of the input to float, then float ops on pre-rounded
//   literals, one switch per step hoisted over the vector's elements;
//   GENERAL (int, float16 and bfloat16 steps): a value travels as 32 bits,
//   an integer as its two's complement pattern (int steps are 32-bit
//   unsigned arithmetic, whose sums and products reduce correctly mod 2^8
//   and 2^16, then wrap to the step's width), a float as float32 bits.
// - Instantiations by width, not by dtype: the float32-chain variant is
//   instantiated for each of the 9 input dtypes (its one conversion to
//   float), the general one for each pair of input and output widths
//   (1, 2 or 4 bytes: 9 pairs), an element's dtype selecting at run time,
//   once per vector, how its bits widen to 32 (zero or sign extension,
//   float16 or bfloat16 to float32) and narrow again (truncation, or
//   rounding to float16 or bfloat16): 18 kernels.  A kernel per (input,
//   output) dtype pair, 90 of them, built five times as long and ran
//   within 0.1 us of these (PERF.md, findings).
// - Plain write-back stores: the filter's first conv reads the output next,
//   from L2.
//
// Numerics follow the JAX kernel, bit for bit with the plain version:
// - float16 and bfloat16 steps compute in float32 and round to half or to
//   bfloat16 (nearest even) after every step, as XLA computes them; an int
//   converts to either through float32 (two roundings, as XLA converts);
// - a bfloat16 division by a literal is a multiplication by its float32
//   reciprocal (XLA widens the division to float32 first);
// - division by a literal arrives as a multiplication by its reciprocal,
//   which is what XLA compiles x / const into on every backend;
// - round-to-nearest intrinsics throughout (__fadd_rn, __fmul_rn, ...), and
//   no contraction by the compiler (-fmad=false): the only fused
//   multiply-adds are the ones the host asks for.  XLA on the CPU folds the
//   literals of consecutive adds and of consecutive multiplies and contracts
//   a multiply followed by an add into one rounding (ROADMAP C7 to C9); the
//   host replays that (ops/kernels.py::ChainPlan), so a chain arrives with
//   its literals folded and a multiply-add as one step, O_FFMA
//   (__fmaf_rn, the operand and result flushed) or, for float16, O_HFMA
//   (__hfma: one rounding to half, as the CPU's native half arithmetic),
//   except on the lanes that a float -> int conversion before it saturated
//   to the int's maximum (or NaN to 0, for a signed int), which XLA's CPU
//   code computes one rounding a step (ROADMAP C10; mark_constant below);
// - int -> float rounds from the exact value (__int2float_rn, and
//   __uint2float_rn for uint32);
// - float -> int truncates and saturates, NaN to 0 (cvt.rzi, which clamps
//   to its 32-bit range, then a clamp to a narrow int's range), as XLA's
//   convert;
// - clamp is XLA's max(lo, x) then min(hi, x): NaN propagates, -0.0 orders
//   below +0.0; integer bounds arrive inside the step dtype's range
//   (ops/kernels.py::_int_clamp);
// - float arithmetic (add, sub, mul, clamp) flushes float32 subnormals, as
//   XLA does: each operand, and each result, that is subnormal becomes the
//   zero of its sign (ftz below; the host flushes the literals).  A
//   conversion keeps them, and so do the steps XLA folds away, which the
//   host lowers to no operation (x + 0, x * 1, clamp(-inf, inf)) or to a
//   sign flip (x * -1).  The flush is explicit, not nvcc's --ftz=true,
//   which would change int8_matmul's epilogue too.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Outside the unnamed namespace: the extern "C" entry point takes a
// Program, and a type with internal linkage would make that symbol local.
constexpr int kMaxSteps = 8;
constexpr int kThreads = 128;
constexpr int kVecBytes = 16;

// Must match ops/kernels.py::_Program (ctypes), field for field.
struct Program {
  int variant;
  int n_steps;
  int conv[kMaxSteps];  // Conv: the value to the step's dtype
  int op[kMaxSteps];    // Op: the step's operation on a and b
  int post[kMaxSteps];  // Conv: wrap to a narrow int, or round to half
  uint32_t a[kMaxSteps];
  uint32_t b[kMaxSteps];
  uint32_t reset;       // bit k: step k's conversion drops the constant lanes (C13)
};

namespace {

enum Dt { U8 = 0, I8 = 1, U16 = 2, I16 = 3, U32 = 4, I32 = 5, F16 = 6, F32 = 7, BF16 = 8 };
// Must match ops/kernels.py::CONV, OP and FLOAT_CHAIN / GENERAL.
enum Conv {
  C_NONE = 0, C_WRAP_U8 = 1, C_WRAP_I8 = 2, C_WRAP_U16 = 3, C_WRAP_I16 = 4,
  C_I2F = 5, C_U2F = 6, C_I2H = 7, C_U2H = 8, C_F2H = 9,
  C_F2U8 = 10, C_F2I8 = 11, C_F2U16 = 12, C_F2I16 = 13, C_F2U32 = 14, C_F2I32 = 15,
  C_I2B = 16, C_U2B = 17, C_F2B = 18
};
enum Op {
  O_NONE = 0, O_IADD = 1, O_ISUB = 2, O_IMUL = 3, O_ICLAMP = 4, O_UCLAMP = 5,
  O_FADD = 6, O_FSUB = 7, O_FMUL = 8, O_FCLAMP = 9, O_FNEG = 10, O_FFMA = 11, O_HFMA = 12
};
enum Variant { FLOAT_CHAIN = 0, GENERAL = 1 };
// How the general variant widens an element's bits to 32, and narrows them.
enum Load { L_ZERO = 0, L_SIGN = 1, L_F16 = 2, L_BF16 = 3 };
enum Store { S_TRUNC = 0, S_F16 = 1, S_BF16 = 2 };

struct f16 {  // a float16 in memory
  uint16_t bits;
};
struct bf16 {  // a bfloat16 in memory: the high half of a float32
  uint16_t bits;
};

// -- one element in and out -------------------------------------------------

template <typename T> __device__ __forceinline__ float to_float(T v) {
  return __int2float_rn((int32_t)v);
}
template <> __device__ __forceinline__ float to_float<uint32_t>(uint32_t v) {
  return __uint2float_rn(v);
}
template <> __device__ __forceinline__ float to_float<f16>(f16 v) {
  return __half2float(__ushort_as_half(v.bits));
}
template <> __device__ __forceinline__ float to_float<bf16>(bf16 v) {
  return __uint_as_float((uint32_t)v.bits << 16);
}
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }

__device__ __forceinline__ uint32_t half_bits(float f) {
  return __float_as_uint(__half2float(__float2half_rn(f)));
}

// f rounded to bfloat16 (nearest even), as float32 bits.
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f)) << 16;
}

__device__ __forceinline__ uint32_t saturate(float f, int32_t lo, int32_t hi) {
  int32_t v = __float2int_rz(f);  // saturates to int32, NaN -> 0
  v = v < lo ? lo : v;
  return (uint32_t)(v > hi ? hi : v);
}

// A float32 subnormal replaced by the zero of its sign (a NaN stays: its
// magnitude compares false).
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? __uint_as_float(__float_as_uint(v) & 0x80000000u) : v;
}

__device__ __forceinline__ uint32_t neg_bits(uint32_t x) { return x ^ 0x80000000u; }

// x * a + b rounded once in float32, the operand and the result flushed.
__device__ __forceinline__ float ffma(float x, float a, float b) {
  return ftz(__fmaf_rn(ftz(x), a, b));
}

// x * a + b rounded once in float16, all three float16 values held as
// float32 (exact both ways), as the float32 bits of the result.
__device__ __forceinline__ uint32_t hfma_bits(uint32_t x, __half a, __half b) {
  return __float_as_uint(__half2float(__hfma(__float2half_rn(__uint_as_float(x)), a, b)));
}

// max(lo, v) then min(hi, v), as XLA's clamp.
template <typename T> __device__ __forceinline__ T xla_clamp(T v, T lo, T hi) {
  v = lo >= v ? lo : v;
  return hi <= v ? hi : v;
}
// The float clamp: a NaN propagates, and -0.0 orders below +0.0, as XLA's
// max and min order them (of two equal values max takes the AND of their
// bits and min the OR, which differ only for zeros of opposite signs).
__device__ __forceinline__ float fclamp(float v, float lo, float hi) {
  v = lo > v ? lo : (lo == v ? __int_as_float(__float_as_int(lo) & __float_as_int(v)) : v);
  return hi < v ? hi : (hi == v ? __int_as_float(__float_as_int(hi) | __float_as_int(v)) : v);
}

// -- the steps, each switch hoisted over a vector's elements ----------------

#define EACH(expr)                     \
  _Pragma("unroll") for (int e = 0; e < kN; ++e) { \
    const uint32_t x = r[e];           \
    (void)x;                           \
    r[e] = (expr);                     \
  }                                    \
  break;

template <int kN>
__device__ __forceinline__ void wrap_or_round(uint32_t (&r)[kN], int c) {
  switch (c) {
    case C_WRAP_U8: EACH(x & 0xFFu)
    case C_WRAP_I8: EACH((uint32_t)(int32_t)(int8_t)(x & 0xFFu))
    case C_WRAP_U16: EACH(x & 0xFFFFu)
    case C_WRAP_I16: EACH((uint32_t)(int32_t)(int16_t)(x & 0xFFFFu))
    case C_F2H: EACH(half_bits(__uint_as_float(x)))
    case C_F2B: EACH(bf16_bits(__uint_as_float(x)))
    default: break;
  }
}

template <int kN>
__device__ __forceinline__ void convert(uint32_t (&r)[kN], int c) {
  switch (c) {
    case C_I2F: EACH(__float_as_uint(__int2float_rn((int32_t)x)))
    case C_U2F: EACH(__float_as_uint(__uint2float_rn(x)))
    case C_I2H: EACH(half_bits(__int2float_rn((int32_t)x)))
    case C_U2H: EACH(half_bits(__uint2float_rn(x)))
    case C_I2B: EACH(bf16_bits(__int2float_rn((int32_t)x)))
    case C_U2B: EACH(bf16_bits(__uint2float_rn(x)))
    case C_F2U8: EACH(saturate(__uint_as_float(x), 0, 255))
    case C_F2I8: EACH(saturate(__uint_as_float(x), -128, 127))
    case C_F2U16: EACH(saturate(__uint_as_float(x), 0, 65535))
    case C_F2I16: EACH(saturate(__uint_as_float(x), -32768, 32767))
    case C_F2U32: EACH(__float2uint_rz(__uint_as_float(x)))
    case C_F2I32: EACH((uint32_t)__float2int_rz(__uint_as_float(x)))
    default: wrap_or_round(r, c); break;
  }
}

// ROADMAP C10: XLA's CPU code converts a float to an int through selects,
// one arm a constant for a value at or above the int's maximum (as a
// float32) and, for a signed int, for NaN.  LLVM folds every later step of
// that arm one rounding at a time, so a multiply-add that it contracts
// elsewhere is a multiply and an add on those lanes.  Bit e of `sat` marks
// such a lane; only O_FFMA and O_HFMA read it.  A later float -> int
// conversion keeps those lanes only where LLVM folds the int -> float -> int
// round trip (ROADMAP C13), and then marks none of its own (the folded
// conversion has no select); where it cannot, the program's reset bit for
// that step drops them and marks its own (ops/kernels.py::constant_resets).
__device__ __forceinline__ bool is_f2i(int c) { return c >= C_F2U8 && c <= C_F2I32; }

template <int kN>
__device__ __forceinline__ void mark_constant(const uint32_t (&r)[kN], int c, uint32_t& sat) {
  float top;
  bool nan_too;
  switch (c) {
    case C_F2U8: top = 255.0f; nan_too = false; break;
    case C_F2I8: top = 127.0f; nan_too = true; break;
    case C_F2U16: top = 65535.0f; nan_too = false; break;
    case C_F2I16: top = 32767.0f; nan_too = true; break;
    case C_F2U32: top = 4294967296.0f; nan_too = false; break;
    case C_F2I32: top = 2147483648.0f; nan_too = true; break;
    default: return;
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const float f = __uint_as_float(r[e]);
    if (f >= top || (nan_too && f != f)) sat |= 1u << e;
  }
}

// x * a + b one rounding a step: the multiply and the add of O_FFMA, each
// operand and result flushed, as O_FMUL and O_FADD.
__device__ __forceinline__ float fmul_fadd(float x, float a, float b) {
  return ftz(__fadd_rn(ftz(__fmul_rn(ftz(x), a)), b));
}

// The same in float16: the product of two halves is exact in float32 and
// the sum of two is rounded once more to half, which float32's 24 bits
// make correct (2 x 11 + 2 <= 24).
__device__ __forceinline__ uint32_t hmul_hadd_bits(uint32_t x, float a, float b) {
  const float p = __uint_as_float(half_bits(__fmul_rn(__uint_as_float(x), a)));
  return half_bits(__fadd_rn(p, b));
}

template <int kN>
__device__ __forceinline__ void apply(uint32_t (&r)[kN], int op, uint32_t a, uint32_t b,
                                      uint32_t sat) {
  const float fa = __uint_as_float(a), fb = __uint_as_float(b);
  const __half ha = __float2half_rn(fa), hb = __float2half_rn(fb);
  switch (op) {
    case O_IADD: EACH(x + a)
    case O_ISUB: EACH(x - a)
    case O_IMUL: EACH(x * a)
    case O_ICLAMP: EACH((uint32_t)xla_clamp((int32_t)x, (int32_t)a, (int32_t)b))
    case O_UCLAMP: EACH(xla_clamp(x, a, b))
    case O_FADD: EACH(__float_as_uint(ftz(__fadd_rn(ftz(__uint_as_float(x)), fa))))
    case O_FSUB: EACH(__float_as_uint(ftz(__fsub_rn(ftz(__uint_as_float(x)), fa))))
    case O_FMUL: EACH(__float_as_uint(ftz(__fmul_rn(ftz(__uint_as_float(x)), fa))))
    case O_FCLAMP: EACH(__float_as_uint(fclamp(ftz(__uint_as_float(x)), fa, fb)))
    case O_FNEG: EACH(neg_bits(x))
    case O_FFMA:
      EACH(__float_as_uint((sat >> e) & 1u ? fmul_fadd(__uint_as_float(x), fa, fb)
                                           : ffma(__uint_as_float(x), fa, fb)))
    case O_HFMA: EACH((sat >> e) & 1u ? hmul_hadd_bits(x, fa, fb) : hfma_bits(x, ha, hb))
    default: break;
  }
}
#undef EACH

template <int kN>
__device__ __forceinline__ void general_steps(uint32_t (&r)[kN], const Program& p) {
  uint32_t sat = 0;  // C10's lanes, set by a float -> int conversion
  bool converted = false;
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    if (k < p.n_steps) {
      if (is_f2i(p.conv[k]) && (!converted || ((p.reset >> k) & 1u))) {
        sat = 0;
        mark_constant(r, p.conv[k], sat);
        converted = true;
      }
      convert(r, p.conv[k]);
      apply(r, p.op[k], p.a[k], p.b[k], sat);
      wrap_or_round(r, p.post[k]);
    }
  }
}

template <int kN>
__device__ __forceinline__ void float_steps(float (&v)[kN], const Program& p) {
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    if (k < p.n_steps) {
      const float a = __uint_as_float(p.a[k]), b = __uint_as_float(p.b[k]);
      switch (p.op[k]) {
        case O_FADD:
#pragma unroll
          for (int e = 0; e < kN; ++e) v[e] = ftz(__fadd_rn(ftz(v[e]), a));
          break;
        case O_FSUB:
#pragma unroll
          for (int e = 0; e < kN; ++e) v[e] = ftz(__fsub_rn(ftz(v[e]), a));
          break;
        case O_FMUL:
#pragma unroll
          for (int e = 0; e < kN; ++e) v[e] = ftz(__fmul_rn(ftz(v[e]), a));
          break;
        case O_FCLAMP:
#pragma unroll
          for (int e = 0; e < kN; ++e) v[e] = fclamp(ftz(v[e]), a, b);
          break;
        case O_FNEG:
#pragma unroll
          for (int e = 0; e < kN; ++e) v[e] = __uint_as_float(neg_bits(__float_as_uint(v[e])));
          break;
        case O_FFMA:
#pragma unroll
          for (int e = 0; e < kN; ++e) v[e] = ffma(v[e], a, b);
          break;
        default:  // a typecast to float32: nothing to do
          break;
      }
    }
  }
}

// The 32-bit representation of a vector's input elements, stored as their
// width W: an int zero- or sign-extended, a float as its float32 bits.
template <typename W, int kN>
__device__ __forceinline__ void load_bits(const W (&in)[kN], uint32_t (&r)[kN], int ld) {
  if constexpr (sizeof(W) == 2) {
    switch (ld) {
      case L_SIGN:
#pragma unroll
        for (int e = 0; e < kN; ++e) r[e] = (uint32_t)(int32_t)(int16_t)in[e];
        break;
      case L_F16:
#pragma unroll
        for (int e = 0; e < kN; ++e) r[e] = __float_as_uint(__half2float(__ushort_as_half(in[e])));
        break;
      case L_BF16:
#pragma unroll
        for (int e = 0; e < kN; ++e) r[e] = (uint32_t)in[e] << 16;
        break;
      default:
#pragma unroll
        for (int e = 0; e < kN; ++e) r[e] = in[e];
        break;
    }
  } else if constexpr (sizeof(W) == 1) {
    if (ld == L_SIGN) {
#pragma unroll
      for (int e = 0; e < kN; ++e) r[e] = (uint32_t)(int32_t)(int8_t)in[e];
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) r[e] = in[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) r[e] = in[e];
  }
}

// Output elements of width W from their 32-bit representation (already in
// range): an int's low bits, a float16 or bfloat16 rounded from float32.
template <typename W, int kN>
__device__ __forceinline__ void store_bits(const uint32_t (&r)[kN], W (&out)[kN], int st) {
  if constexpr (sizeof(W) == 2) {
    switch (st) {
      case S_F16:
#pragma unroll
        for (int e = 0; e < kN; ++e)
          out[e] = __half_as_ushort(__float2half_rn(__uint_as_float(r[e])));
        break;
      case S_BF16:
#pragma unroll
        for (int e = 0; e < kN; ++e)
          out[e] = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(r[e])));
        break;
      default:
#pragma unroll
        for (int e = 0; e < kN; ++e) out[e] = (W)r[e];
        break;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = (W)r[e];
  }
}

// kFloat: InT is the input dtype and OutT float.  Else both are the
// elements' widths (uint8_t, uint16_t, uint32_t), `ld` and `st` their
// dtypes' Load and Store codes.
template <bool kFloat, typename InT, typename OutT, int kN>
__device__ __forceinline__ void eval(const InT (&in)[kN], OutT (&out)[kN], const Program& p,
                                     int ld, int st) {
  if constexpr (kFloat) {
    static_assert(sizeof(OutT) == 4, "the float32 chain writes float32");
    float v[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) v[e] = to_float(in[e]);
    float_steps(v, p);
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = v[e];
  } else {
    uint32_t r[kN];
    load_bits(in, r, ld);
    general_steps(r, p);
    store_bits(r, out, st);
  }
}

// A vector's outputs with the widest aligned stores: 16-byte pieces, or
// one 8- or 4-byte store.
template <typename T, int kN>
__device__ __forceinline__ void store_vec(T* dst, const T (&o)[kN]) {
  constexpr int kBytes = kN * (int)sizeof(T);
  if constexpr (kBytes >= 16) {
    uint4 w[kBytes / 16];
    memcpy(w, o, kBytes);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) reinterpret_cast<uint4*>(dst)[i] = w[i];
  } else if constexpr (kBytes == 8) {
    uint2 w;
    memcpy(&w, o, 8);
    *reinterpret_cast<uint2*>(dst) = w;
  } else {
    static_assert(kBytes == 4, "a vector stores 4, 8 or a multiple of 16 bytes");
    uint32_t w;
    memcpy(&w, o, 4);
    *reinterpret_cast<uint32_t*>(dst) = w;
  }
}

// Slot of piece `part` of vector `vec` in a warp's staging area: rotated
// so that neither the lanes writing their pieces nor the lanes reading
// consecutive pieces meet a bank conflict.
template <int kParts>
__device__ __forceinline__ int slot(int vec, int part) {
  return vec * kParts + ((part + vec / (8 / kParts)) % kParts);
}

// Thread t takes vector t (elements head + t * kN onwards) and, if t <
// head + tail, one scalar element: t itself in the head, or the t - head-th
// element after the last whole vector.  A vector's outputs of 32 or 64
// bytes (kParts 16-byte pieces) go out through shared memory, so that each
// store instruction of a warp writes 512 contiguous bytes: piece c of the
// warp's output comes from its vector c / kParts.
template <typename InT, typename OutT, bool kFloat>
__global__ void __launch_bounds__(kThreads)
fused_arith_kernel(const InT* __restrict__ x, OutT* __restrict__ y, long long head,
                   long long nvec, long long tail, int ld, int st,
                   const __grid_constant__ Program p) {
  constexpr int kN = kVecBytes / (int)sizeof(InT);
  constexpr int kParts = kN * (int)sizeof(OutT) / 16;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long first = t - lane;  // the warp's first vector
  if (first < nvec) {                // the whole warp, or none of it
    const uint4 w = t < nvec ? reinterpret_cast<const uint4*>(x + head)[t]
                             : make_uint4(0u, 0u, 0u, 0u);
    InT in[kN];
    memcpy(in, &w, kVecBytes);
    OutT out[kN];
    eval<kFloat>(in, out, p, ld, st);
    if constexpr (kParts >= 2) {
      __shared__ uint4 stage[kThreads * kParts];
      uint4* s = stage + (threadIdx.x - lane) * kParts;
      uint4 piece[kParts];
      memcpy(piece, out, sizeof(piece));
#pragma unroll
      for (int i = 0; i < kParts; ++i) s[slot<kParts>(lane, i)] = piece[i];
      __syncwarp();
      uint4* yw = reinterpret_cast<uint4*>(y + head + first * kN);
#pragma unroll
      for (int i = 0; i < kParts; ++i) {
        const int c = i * 32 + lane;
        if (first + c / kParts < nvec) yw[c] = s[slot<kParts>(c / kParts, c % kParts)];
      }
    } else if (t < nvec) {
      store_vec(y + head + t * kN, out);
    }
  }
  if (t < head + tail) {
    const long long i = t < head ? t : t + nvec * kN;
    const InT in[1] = {x[i]};
    OutT out[1];
    eval<kFloat>(in, out, p, ld, st);
    y[i] = out[0];
  }
}

struct Launch {
  long long head, nvec, tail;
  int blocks;
  cudaStream_t stream;
};

template <typename InT, typename OutT, bool kFloat>
cudaError_t launch(const void* x, void* y, const Launch& l, const Program& p, int ld = 0,
                   int st = 0) {
  fused_arith_kernel<InT, OutT, kFloat><<<l.blocks, kThreads, 0, l.stream>>>(
      static_cast<const InT*>(x), static_cast<OutT*>(y), l.head, l.nvec, l.tail, ld, st, p);
  return cudaGetLastError();
}

// The general variant at input width InW: one kernel per output width.
template <typename InW>
cudaError_t launch_general(const void* x, void* y, int out_bytes, const Launch& l,
                           const Program& p, int ld, int st) {
  switch (out_bytes) {
    case 1: return launch<InW, uint8_t, false>(x, y, l, p, ld, st);
    case 2: return launch<InW, uint16_t, false>(x, y, l, p, ld, st);
    case 4: return launch<InW, uint32_t, false>(x, y, l, p, ld, st);
    default: return cudaErrorInvalidValue;
  }
}

int dt_bytes(int dt) {
  switch (dt) {
    case U8: case I8: return 1;
    case U16: case I16: case F16: case BF16: return 2;
    case U32: case I32: case F32: return 4;
    default: return 0;
  }
}

int load_code(int dt) {
  return dt == I8 || dt == I16 ? L_SIGN : dt == F16 ? L_F16 : dt == BF16 ? L_BF16 : L_ZERO;
}

int store_code(int dt) { return dt == F16 ? S_F16 : dt == BF16 ? S_BF16 : S_TRUNC; }

}  // namespace

extern "C" int nns_fused_arith(const void* x, void* y, int in_dt, int out_dt,
                               const Program* prog, long long head, long long nvec,
                               long long tail, int blocks, void* stream) {
  if (prog == nullptr || prog->n_steps < 0 || prog->n_steps > kMaxSteps || blocks < 1 ||
      head < 0 || nvec < 0 || tail < 0 || (long long)blocks * kThreads < nvec ||
      (long long)blocks * kThreads < head + tail ||
      (prog->variant != FLOAT_CHAIN && prog->variant != GENERAL))
    return (int)cudaErrorInvalidValue;
  const Program& p = *prog;
  const Launch l{head, nvec, tail, blocks, static_cast<cudaStream_t>(stream)};
  const int out_bytes = dt_bytes(out_dt);
  if (dt_bytes(in_dt) == 0 || out_bytes == 0) return (int)cudaErrorInvalidValue;
  if (p.variant == FLOAT_CHAIN) {
    if (out_dt != F32) return (int)cudaErrorInvalidValue;
    switch (in_dt) {
      case U8: return (int)launch<uint8_t, float, true>(x, y, l, p);
      case I8: return (int)launch<int8_t, float, true>(x, y, l, p);
      case U16: return (int)launch<uint16_t, float, true>(x, y, l, p);
      case I16: return (int)launch<int16_t, float, true>(x, y, l, p);
      case U32: return (int)launch<uint32_t, float, true>(x, y, l, p);
      case I32: return (int)launch<int32_t, float, true>(x, y, l, p);
      case F16: return (int)launch<f16, float, true>(x, y, l, p);
      case F32: return (int)launch<float, float, true>(x, y, l, p);
      default: return (int)launch<bf16, float, true>(x, y, l, p);
    }
  }
  const int ld = load_code(in_dt), st = store_code(out_dt);
  switch (dt_bytes(in_dt)) {
    case 1: return (int)launch_general<uint8_t>(x, y, out_bytes, l, p, ld, st);
    case 2: return (int)launch_general<uint16_t>(x, y, out_bytes, l, p, ld, st);
    default: return (int)launch_general<uint32_t>(x, y, out_bytes, l, p, ld, st);
  }
}
