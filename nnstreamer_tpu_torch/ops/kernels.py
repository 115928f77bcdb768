"""Two of the port's hand-written CUDA kernels, their wrappers and plain versions.

- :func:`fused_arith` replaces the JAX package's
  ``ops/pallas_kernels.py::fused_arith``: one elementwise pass of a ``tensor_transform`` chain
  (``csrc/fused_arith.cu``), which the host lowers into a small program
  (:func:`lower_chain`; :func:`program_eval` models the kernel in numpy)
  and launches with :func:`fused_arith_geometry`.
- :func:`int8_matmul` replaces the JAX package's
  ``ops/pallas_kernels.py::int8_matmul``: int8 x int8 → int32 product with the dequant and bias in
  the epilogue (``csrc/int8_matmul.cu``).

Each wrapper checks device, dtype, shape and contiguity.  A CPU tensor goes
to the plain PyTorch version beside it (``*_plain``), which computes the
same function step for step; a CUDA tensor launches the kernel or raises.
Each CUDA launch adds one to the wrapper's ``launches`` count; a call
inside a CUDA-graph capture counts once too, and the graph's replays, which
launch the kernel again without the wrapper, count nothing.  Each host
entry point launches on the caller's current stream and calls only
``cudaGetLastError`` after it, so it may be captured.  The sources
note each kernel's bound on an H100 and what the design does about it.
The third kernel, ``nms_keep``, has its wrapper in :mod:`.nms`;
:data:`KERNELS` lists all three.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..spec import BFLOAT16, numpy_dtype, torch_dtype
from .build import load

# -- dtype rules of a transform chain (JAX's promotion, x64 disabled) -------

_CANON = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
}
_F32 = np.dtype(np.float32)
_I32 = np.dtype(np.int32)


def _canon(dtype) -> np.dtype:
    dtype = numpy_dtype(dtype)
    return _CANON.get(dtype, dtype)


def _is_int(dtype) -> bool:
    return dtype.kind in ("i", "u")


# -- bfloat16 ---------------------------------------------------------------
# numpy has no bfloat16: a bfloat16 value is held as the float32 of the same
# value.  Every conversion to it rounds a float32 to nearest even (an int or
# a double goes through float32 first, as XLA and ml_dtypes convert).


def bf16_round(f: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16, as float32 (a NaN stays a NaN)."""
    f = np.asarray(f, np.float32)
    r = f.view(np.uint32).astype(np.uint64)
    r = (r + 0x7FFF + ((r >> 16) & 1)) & 0xFFFF0000
    r = np.where(np.isnan(f), 0x7FC00000, r).astype(np.uint32)
    return r.view(np.float32).reshape(f.shape)


def bf16_bits(f: np.ndarray) -> np.ndarray:
    """The bfloat16 bits (uint16) of float32 values, rounded to nearest even."""
    return (bf16_round(f).view(np.uint32) >> 16).astype(np.uint16)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    """float32 values of bfloat16 bits (uint16)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def step_dtype(cur, op: str, val) -> np.dtype:
    """Result dtype of one chain step on a ``cur`` stream.

    A Python literal is weakly typed, as in JAX: an int literal keeps the
    stream dtype; a float literal keeps a float stream's dtype and turns an
    int stream into float32; true division of an int stream gives float32.
    64-bit dtypes canonicalize to 32-bit, as JAX does with x64 disabled.
    """
    cur = _canon(cur)
    if op == "typecast":
        return _canon(val)
    if op not in ("add", "sub", "mul", "div", "clamp"):
        raise ValueError(f"unknown chain op {op!r}")
    if not _is_int(cur):
        return cur
    vals = val if op == "clamp" else (val,)
    if op == "div" or any(isinstance(v, float) for v in vals):
        return _F32
    return cur


def chain_out_dtype(in_dtype, ops: Sequence[Tuple[str, object]]) -> np.dtype:
    """Result dtype of a whole chain (``pallas_kernels.chain_out_dtype``)."""
    cur = _canon(in_dtype)
    for op, val in ops:
        cur = step_dtype(cur, op, val)
    return cur


# -- fused_arith ------------------------------------------------------------

_DT_CODES = {
    np.dtype(np.uint8): 0, np.dtype(np.int8): 1, np.dtype(np.uint16): 2,
    np.dtype(np.int16): 3, np.dtype(np.uint32): 4, np.dtype(np.int32): 5,
    np.dtype(np.float16): 6, np.dtype(np.float32): 7, BFLOAT16: 8,
}
MAX_STEPS = 8

# The lowered program of csrc/fused_arith.cu (its enums Conv, Op, Variant).
# A value travels as 32 bits: an integer as its two's complement pattern
# (sign-extended from a narrow signed dtype, zero-extended from a narrow
# unsigned one), a float16 or float32 as the float32 bits of its value.
# A bfloat16 travels as float32 bits too.  Each step is a conversion to the
# step's dtype, the operation on a literal already in that dtype, and a post
# step that brings the result back to the dtype's range: a wrap to a narrow
# int's width, or a rounding to half or to bfloat16.
CONV = {"none": 0, "wrap_u8": 1, "wrap_i8": 2, "wrap_u16": 3, "wrap_i16": 4,
        "i2f": 5, "u2f": 6, "i2h": 7, "u2h": 8, "f2h": 9,
        "f2u8": 10, "f2i8": 11, "f2u16": 12, "f2i16": 13, "f2u32": 14, "f2i32": 15,
        "i2b": 16, "u2b": 17, "f2b": 18}
OP = {"none": 0, "iadd": 1, "isub": 2, "imul": 3, "iclamp": 4, "uclamp": 5,
      "fadd": 6, "fsub": 7, "fmul": 8, "fclamp": 9, "fneg": 10}
# FLOAT_CHAIN: every step computes in float32 (the normalize chain): the
# kernel converts the input to float once and runs float ops on float
# literals.  GENERAL: any chain, int and float16 steps included.
FLOAT_CHAIN, GENERAL = 0, 1

_U32 = np.dtype(np.uint32)
_F16 = np.dtype(np.float16)
_WRAP = {np.dtype(np.uint8): "wrap_u8", np.dtype(np.int8): "wrap_i8",
         np.dtype(np.uint16): "wrap_u16", np.dtype(np.int16): "wrap_i16"}


_ROUND = {_F16: "h", BFLOAT16: "b"}  # the float dtypes a step rounds to


def _conv_code(cur: np.dtype, dt: np.dtype) -> str:
    """The conversion from a ``cur`` value to ``dt`` (astype) on the 32-bit
    representation."""
    if cur == dt:
        return "none"
    if _is_int(dt):
        if _is_int(cur):  # a 32-bit pattern already holds any 32-bit int
            return _WRAP.get(dt, "none")
        return "f2" + dt.name[0] + str(dt.itemsize * 8)
    if _is_int(cur):  # through float32, as XLA converts an int to a half
        return ("u2" if cur == _U32 else "i2") + _ROUND.get(dt, "f")
    # to float32 is exact; to half or bfloat16 rounds the float32 value once
    return "f2" + _ROUND[dt] if dt in _ROUND else "none"


def _literal32(v, dt) -> np.float32:
    """A float literal rounded once from double to ``dt``, as a float32
    (bfloat16: through float32, as JAX binds a Python float to it)."""
    with np.errstate(over="ignore"):  # beyond the dtype's range: inf
        if dt == BFLOAT16:
            return bf16_round(np.float32(v))[()]
        return np.float32(dt.type(v))


# Float arithmetic flushes subnormals, as XLA does (C6): on the CPU it runs
# with denormals-are-zero and flush-to-zero set, and the TPU has no float32
# subnormals.  Every float step but a conversion and the steps XLA folds
# away (:func:`_xla_fold`) reads each operand, and writes its result, with
# a float32 subnormal replaced by a zero of its sign.  A float16 value is
# never a float32 subnormal, so float16 steps keep float16 subnormals, as
# XLA's do (it computes them in float32).
_TINY = np.float32(np.finfo(np.float32).tiny)


def _flush32(f) -> np.float32:
    """A float32 with a subnormal replaced by a zero of its sign."""
    f = np.float32(f)
    return np.copysign(np.float32(0), f) if abs(f) < _TINY else f


def _bits(v, dt: np.dtype) -> int:
    """A float literal rounded to ``dt`` and flushed (as the plain
    version's ``_literal``), as the bits of its float32 value."""
    return int(_flush32(_literal32(v, dt)).view(np.uint32))


def _xla_fold(op: str, dt: np.dtype, a, b) -> str:
    """A float step that XLA's algebraic simplifier removes: ``x * 1`` is
    ``x``, ``x * -1`` is ``-x`` (a sign flip), ``clamp(-inf, inf)`` is
    ``x``; none of them does arithmetic, so a subnormal stays.  The
    literal is compared as rounded to ``dt`` (``rmul`` keeps a float32)."""
    if op in ("mul", "rmul"):
        lit = np.float32(a) if op == "rmul" else _literal32(a, dt)
        return "typecast" if lit == 1 else "neg" if lit == -1 else op
    if op == "clamp" and _literal32(a, dt) == -np.inf and _literal32(b, dt) == np.inf:
        return "typecast"
    return op


def _int_clamp(lo: int, hi: int, dt: np.dtype) -> Tuple[int, int]:
    """Bounds of an integer clamp moved into ``dt``'s range with the same
    result: the plain version computes ``min(hi, max(lo, v))`` on exact
    integers and wraps it, for a value ``v`` in that range."""
    info = np.iinfo(dt)
    if lo > info.max:  # max(lo, v) is lo for every v
        c = min(hi, lo)
    elif hi < info.min:  # max(lo, v) >= v > hi
        c = hi
    else:
        return max(lo, int(info.min)), min(hi, int(info.max))
    bits = dt.itemsize * 8
    c &= (1 << bits) - 1
    if info.min < 0 and c >= 1 << (bits - 1):
        c -= 1 << bits
    return c, c


class Program(NamedTuple):
    """A chain lowered for ``csrc/fused_arith.cu``: the variant, and for
    each step its conversion, operation and post codes and its operands'
    32-bit patterns."""

    variant: int
    conv: Tuple[int, ...]
    op: Tuple[int, ...]
    post: Tuple[int, ...]
    a: Tuple[int, ...]
    b: Tuple[int, ...]


def lower_chain(start: np.dtype, steps) -> Program:
    """Lower a plan's steps (op, result dtype, a, b), starting from a
    ``start`` stream, into the kernel's program."""
    conv, ops, post, a_bits, b_bits = [], [], [], [], []
    cur = start
    for op, dt, a, b in steps:
        conv.append(CONV[_conv_code(cur, dt)])
        cur = dt
        a32 = b32 = 0
        after = "none"
        if op == "typecast":
            code = "none"
        elif op == "neg":  # a sign flip: exact, no flush
            code = "fneg"
        elif _is_int(dt):
            if op == "clamp":
                lo, hi = _int_clamp(int(a), int(b), dt)
                code = "uclamp" if dt == _U32 else "iclamp"
                a32, b32 = lo & 0xFFFFFFFF, hi & 0xFFFFFFFF
            else:
                code = "i" + op
                a32 = int(a) & 0xFFFFFFFF
                after = _WRAP.get(dt, "none")
        elif op == "rmul":  # a reciprocal kept in float32 (ChainPlan)
            code = "fmul"
            a32 = int(_flush32(a).view(np.uint32))
            after = "f2" + _ROUND[dt]
        else:
            code = "f" + op
            a32 = _bits(a, dt)
            b32 = _bits(b, dt) if op == "clamp" else 0
            after = "f2" + _ROUND[dt] if dt in _ROUND else "none"
        ops.append(OP[code])
        post.append(CONV[after])
        a_bits.append(a32)
        b_bits.append(b32)
    f32 = bool(steps) and all(dt == _F32 for _, dt, _, _ in steps)
    return Program(FLOAT_CHAIN if f32 else GENERAL, tuple(conv), tuple(ops), tuple(post),
                   tuple(a_bits), tuple(b_bits))


class _Program(ctypes.Structure):
    # Must match csrc/fused_arith.cu::Program, field for field.
    _fields_ = [("variant", ctypes.c_int), ("n_steps", ctypes.c_int),
                ("conv", ctypes.c_int * MAX_STEPS), ("op", ctypes.c_int * MAX_STEPS),
                ("post", ctypes.c_int * MAX_STEPS), ("a", ctypes.c_uint32 * MAX_STEPS),
                ("b", ctypes.c_uint32 * MAX_STEPS)]


def _reciprocal(val, dt: np.dtype) -> float:
    """1/val as XLA computes it when it rewrites ``x / const`` into
    ``x * (1 / const)`` (its algebraic simplifier does so on every backend,
    so JAX's division by a literal is this product, not an IEEE division):
    the literal rounded to the step dtype, inverted in that dtype (float16
    through float32, as Eigen's half does).  A bfloat16 division runs in
    float32 (XLA widens it), so its reciprocal stays a float32: the product
    rounded to bfloat16 equals the rounded quotient on every bfloat16 input
    tried (all 65,536, at 13 divisors)."""
    with np.errstate(divide="ignore", over="ignore"):
        inv = np.float32(1) / _literal32(val, dt)
    return float(inv) if dt == BFLOAT16 else float(dt.type(inv))


class ChainPlan:
    """A bound chain, resolved for one input dtype: the dtype it starts
    from, each step's (op, result dtype, operand a, operand b), and the
    output dtype; for the kernel, the chain lowered (:attr:`program`)."""

    def __init__(self, in_dtype: np.dtype, ops: Tuple[Tuple[str, object], ...],
                 promote: bool = True):
        if len(ops) > MAX_STEPS:
            raise ValueError(f"fused_arith takes at most {MAX_STEPS} steps, got {len(ops)}")
        self.out_dtype = chain_out_dtype(in_dtype, ops)
        # The TPU kernel promotes a narrow int input to int32 up front when
        # the chain changes its dtype (pallas_kernels.py:100-110), so the
        # integer steps before a float op compute in int32, without wrap.
        # The transform's plain path (``promote=False``) does not.
        promote = (promote and self.out_dtype != in_dtype and _is_int(in_dtype)
                   and in_dtype.itemsize < 4)
        self.start_dtype = _I32 if promote else _canon(in_dtype)
        steps = []
        cur = self.start_dtype
        for op, val in ops:
            cur = step_dtype(cur, op, val)
            if op == "typecast":
                a = b = 0.0
            elif op == "clamp":
                a, b = val
            elif op == "div":
                op, a, b = "rmul" if cur == BFLOAT16 else "mul", _reciprocal(val, cur), 0.0
            elif op in ("add", "sub") and not _is_int(cur) and _literal32(val, cur) == 0:
                # XLA folds x + 0 and x - 0 into x (a -0.0 stays -0.0, where
                # IEEE addition of +0.0 would give +0.0): no operation
                op, a, b = "typecast", 0.0, 0.0
            else:
                a, b = val, 0.0
            if not _is_int(cur):
                op = _xla_fold(op, cur, a, b)
            steps.append((op, cur, a, b))
        self.steps = tuple(steps)

    @functools.cached_property
    def program(self) -> Program:
        """The chain lowered for the kernel (:func:`lower_chain`)."""
        # The output conversion is the identity: a promoted start changes
        # only the int steps before the chain's first change of dtype.
        last = self.steps[-1][1] if self.steps else self.start_dtype
        assert last == self.out_dtype, (last, self.out_dtype)
        return lower_chain(self.start_dtype, self.steps)

    @functools.cached_property
    def c_program(self) -> _Program:
        p = self.program
        c = _Program()
        c.variant, c.n_steps = p.variant, len(p.op)
        for field in ("conv", "op", "post", "a", "b"):
            getattr(c, field)[:len(p.op)] = getattr(p, field)
        return c


def plan_chain(in_dtype: np.dtype, ops: Tuple[Tuple[str, object], ...],
               promote: bool = True) -> ChainPlan:
    """The chain's plan, cached.  The cache key spells each literal out:
    0, 0.0 and -0.0 are one key to a dict, but an int literal keeps an int
    stream's dtype where a float one promotes it, and -0.0 is a bound of
    its own."""
    return _cached_plan(in_dtype, tuple(ops), promote, tuple((op, repr(v)) for op, v in ops))


@functools.lru_cache(maxsize=256)
def _cached_plan(in_dtype, ops, promote, key) -> ChainPlan:
    del key  # only tells apart literals that compare equal
    return ChainPlan(in_dtype, ops, promote)


def _wrap_int(v: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """An int64 tensor wrapped to ``dtype``'s width (two's complement)."""
    bits = dtype.itemsize * 8
    mask = (1 << bits) - 1
    if np.issubdtype(dtype, np.signedinteger):
        off = 1 << (bits - 1)
        return torch.bitwise_and(v + off, mask) - off
    return torch.bitwise_and(v, mask)


def _round_half(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float16).to(torch.float32)


def _round_to(v: torch.Tensor, dt) -> torch.Tensor:
    """A float32 result rounded to a narrower float step dtype."""
    if dt == _F16:
        return _round_half(v)
    if dt == BFLOAT16:
        return v.to(torch.bfloat16).to(torch.float32)
    return v


def _convert(v: torch.Tensor, cur: np.dtype, dt: np.dtype) -> torch.Tensor:
    """astype in the working representation: int64 for integer dtypes,
    float32 for float dtypes (float16 values held exactly)."""
    if cur == dt:
        return v
    if _is_int(dt):
        if _is_int(cur):
            return _wrap_int(v, dt)
        info = np.iinfo(dt)  # saturate, NaN → 0: XLA's float → int convert
        t = v.to(torch.float64).trunc().clamp(float(info.min), float(info.max))
        return torch.where(torch.isnan(v), torch.zeros_like(t), t).to(torch.int64)
    f = v.to(torch.float32) if _is_int(cur) else v
    return _round_to(f, dt)


def _literal(a, dt: np.dtype, device) -> torch.Tensor:
    """A Python literal in the step dtype, rounded once from double, as a
    0-d tensor on ``device``."""
    if _is_int(dt):
        return torch.tensor(int(a), dtype=torch.int64, device=device)
    return torch.tensor(float(_flush32(_literal32(a, dt))), dtype=torch.float32, device=device)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """A float32 tensor with its subnormals replaced by zeros of their sign
    (:func:`_flush32`), explicit on any device: nothing here depends on the
    device's or the process's denormal mode."""
    return torch.where(v.abs() < float(_TINY), v * 0, v)


def _same(a: torch.Tensor, b: torch.Tensor, bitop) -> torch.Tensor:
    return bitop(a.view(torch.int32), b.view(torch.int32)).view(torch.float32)


def _fmax(lo: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """XLA's float max(lo, x): a NaN x propagates, -0.0 orders below +0.0
    (of two equal values, the AND of their bits)."""
    return torch.where(lo > v, lo, torch.where(lo == v, _same(lo, v, torch.bitwise_and), v))


def _fmin(hi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """XLA's float min(hi, x), as :func:`_fmax` (the OR of equal bits)."""
    return torch.where(hi < v, hi, torch.where(hi == v, _same(hi, v, torch.bitwise_or), v))


def _apply_step(v: torch.Tensor, op: str, dt: np.dtype, a, b) -> torch.Tensor:
    if op == "typecast":
        return v
    if op == "neg":
        return -v
    if not _is_int(dt):
        v = _flush(v)
    if op == "rmul":  # by a float32 reciprocal, then rounded to the step dtype
        r = v * torch.tensor(float(_flush32(a)), dtype=torch.float32, device=v.device)
        return _round_to(_flush(r), dt)
    lit = _literal(a, dt, v.device)
    if op == "clamp":
        hi = _literal(b, dt, v.device)
        if _is_int(dt):
            v = torch.where(lit >= v, lit, v)  # XLA max(lo, x)
            r = torch.where(hi <= v, hi, v)
        else:
            r = _fmin(hi, _fmax(lit, v))
    elif op == "add":
        r = v + lit
    elif op == "sub":
        r = v - lit
    elif op == "mul":
        r = v * lit
    else:
        raise ValueError(f"unknown chain op {op!r}")
    if _is_int(dt):
        return _wrap_int(r, dt)
    return _round_to(_flush(r), dt)


def run_chain(x: torch.Tensor, plan: ChainPlan) -> torch.Tensor:
    """Plain PyTorch evaluation of a resolved chain, step by step."""
    cur = _canon(x.dtype)
    v = x.to(torch.int64) if _is_int(cur) else x.to(torch.float32)
    v = _convert(v, cur, plan.start_dtype)
    cur = plan.start_dtype
    for op, dt, a, b in plan.steps:
        v = _convert(v, cur, dt)
        cur = dt
        v = _apply_step(v, op, dt, a, b)
    v = _convert(v, cur, plan.out_dtype)
    return v.to(torch_dtype(plan.out_dtype))


def fused_arith_plain(x: torch.Tensor, ops: Sequence[Tuple[str, object]]) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_arith`, on any device."""
    return run_chain(x, plan_chain(numpy_dtype(x.dtype), tuple(ops)))


def _f(r: np.ndarray) -> np.ndarray:
    return r.view(np.float32)


def _saturate(r: np.ndarray, dt) -> np.ndarray:
    """float -> int as ``cvt.rzi`` with saturation: truncate, clamp to the
    int's range, NaN to 0; the result as a 32-bit pattern."""
    f = _f(r)
    info = np.iinfo(dt)
    with np.errstate(invalid="ignore"):
        t = np.clip(np.trunc(f.astype(np.float64)), info.min, info.max)
    t = np.where(np.isnan(f), 0.0, t).astype(np.int64)
    return (t & 0xFFFFFFFF).astype(np.uint32)


def _wrap_bits(r: np.ndarray, dt) -> np.ndarray:
    return r.astype(dt).astype(np.int32 if np.dtype(dt).kind == "i" else np.uint32).view(np.uint32)


def _half_bits(f: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # beyond float16's range: inf
        return f.astype(np.float16).astype(np.float32).view(np.uint32)


def _bf16_bits32(f: np.ndarray) -> np.ndarray:
    return bf16_round(f).view(np.uint32)


_CONV_FNS = {
    "none": lambda r: r,
    "wrap_u8": lambda r: _wrap_bits(r, np.uint8), "wrap_i8": lambda r: _wrap_bits(r, np.int8),
    "wrap_u16": lambda r: _wrap_bits(r, np.uint16),
    "wrap_i16": lambda r: _wrap_bits(r, np.int16),
    "i2f": lambda r: r.view(np.int32).astype(np.float32).view(np.uint32),
    "u2f": lambda r: r.astype(np.float32).view(np.uint32),
    "i2h": lambda r: _half_bits(r.view(np.int32).astype(np.float32)),
    "u2h": lambda r: _half_bits(r.astype(np.float32)),
    "f2h": lambda r: _half_bits(_f(r)),
    "i2b": lambda r: _bf16_bits32(r.view(np.int32).astype(np.float32)),
    "u2b": lambda r: _bf16_bits32(r.astype(np.float32)),
    "f2b": lambda r: _bf16_bits32(_f(r)),
    **{f"f2{dt.name[0]}{dt.itemsize * 8}": (lambda r, dt=dt: _saturate(r, dt))
       for dt in map(np.dtype, (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32))},
}
_CONV_NAMES = {v: k for k, v in CONV.items()}
_OP_NAMES = {v: k for k, v in OP.items()}


def _op_eval(r: np.ndarray, op: str, a: int, b: int) -> np.ndarray:
    if op == "none":
        return r
    if op in ("iadd", "isub", "imul"):
        with np.errstate(over="ignore"):
            a = np.uint32(a)
            return r + a if op == "iadd" else r - a if op == "isub" else r * a
    if op in ("iclamp", "uclamp"):
        t = np.int32 if op == "iclamp" else np.uint32
        v, lo, hi = r.view(t), np.uint32(a).view(t), np.uint32(b).view(t)
        v = np.where(lo >= v, lo, v)
        return np.where(hi <= v, hi, v).astype(t).view(np.uint32)
    if op == "fneg":
        return r ^ np.uint32(0x80000000)
    r = _flush_bits(r)
    v, lo = _f(r), np.uint32(a).view(np.float32)
    with np.errstate(all="ignore"):  # IEEE results: inf, NaN
        if op == "fadd":
            v = v + lo
        elif op == "fsub":
            v = v - lo
        elif op == "fmul":
            v = v * lo
        else:  # fclamp: max(lo, x) then min(hi, x), NaN propagates, -0.0 < +0.0
            r = np.where(lo > v, np.uint32(a), np.where(lo == v, r & np.uint32(a), r))
            v = _f(r.astype(np.uint32))
            hi = np.uint32(b).view(np.float32)
            r = np.where(hi < v, np.uint32(b), np.where(hi == v, r | np.uint32(b), r))
            return r.astype(np.uint32)
    return _flush_bits(v.astype(np.float32).view(np.uint32))


def _flush_bits(r: np.ndarray) -> np.ndarray:
    """float32 bits with each subnormal replaced by the zero of its sign."""
    return np.where((r & np.uint32(0x7F800000)) == 0, r & np.uint32(0x80000000), r)


def program_eval(x: np.ndarray, program: Program, out_dtype, in_dtype=None) -> np.ndarray:
    """A model of ``csrc/fused_arith.cu`` in numpy: ``x`` through the
    lowered ``program`` on the kernel's 32-bit representation, step by
    step as the kernel's variant computes it.  A bfloat16 input
    (``in_dtype=BFLOAT16``) or output is its uint16 bits."""
    x = np.asarray(x)
    if in_dtype == BFLOAT16:
        x = bf16_value(x)
    if program.variant == FLOAT_CHAIN:  # one conversion, then float32 ops
        r = x.astype(np.float32).view(np.uint32)
    elif _is_int(x.dtype):
        r = x.astype(np.int32 if x.dtype.kind == "i" else np.uint32).view(np.uint32)
    else:
        r = x.astype(np.float32).view(np.uint32)
    r = np.array(r, np.uint32, copy=True)
    for k, op in enumerate(program.op):
        if program.variant == GENERAL:
            r = _CONV_FNS[_CONV_NAMES[program.conv[k]]](r)
        r = _op_eval(r, _OP_NAMES[op], program.a[k], program.b[k])
        r = _CONV_FNS[_CONV_NAMES[program.post[k]]](r)
    if out_dtype == BFLOAT16:
        return bf16_bits(_f(r))
    out = np.dtype(out_dtype)
    if _is_int(out):
        return r.view(np.int32 if out.kind == "i" else np.uint32).astype(out)
    return _f(r).astype(out)


# Launch geometry of csrc/fused_arith.cu (its constants of the same names).
# A thread takes one vector of VEC_BYTES of input, 16 B being the widest
# load, and at most one scalar element; THREADS threads a block, as many
# blocks as the vectors (or scalars) need.
THREADS = 128
VEC_BYTES = 16


class FusedGeometry(NamedTuple):
    """One ``fused_arith`` launch: elements [0, head) and the ``tail`` after
    the vector body are scalar; ``nvec`` vectors of VEC_BYTES of input start
    at element ``head``; ``blocks`` x ``threads``."""

    head: int
    nvec: int
    tail: int
    blocks: int
    threads: int


@functools.lru_cache(maxsize=1024)
def _geometry(n: int, in_size: int, out_size: int, x_phase: int, y_phase: int) -> FusedGeometry:
    vec = VEC_BYTES // in_size
    unit = min(VEC_BYTES, vec * out_size)  # the widest aligned store
    head = next((h for h in range(vec) if (x_phase + h * in_size) % VEC_BYTES == 0
                 and (y_phase + h * out_size) % unit == 0), None)
    if head is None or head >= n:  # no element sits at both alignments
        head, nvec = n, 0
    else:
        nvec = (n - head) // vec
    tail = n - head - nvec * vec
    blocks = max(1, -(-max(nvec, head + tail) // THREADS))
    return FusedGeometry(head, nvec, tail, blocks, THREADS)


def fused_arith_geometry(n: int, in_size: int, out_size: int, x_ptr: int,
                         y_ptr: int) -> FusedGeometry:
    """The launch geometry of a call on ``n`` elements of ``in_size`` bytes
    into ``out_size`` bytes each, at addresses ``x_ptr`` and ``y_ptr``."""
    return _geometry(n, in_size, out_size, x_ptr % VEC_BYTES, y_ptr % VEC_BYTES)


def fused_arith_accesses(in_size: int, geo: FusedGeometry):
    """The elements a launch of ``geo`` touches, in the kernel's own index
    math: ``(vectors, scalars)``, the first element of every vector access
    and every scalar element, once per access (thread ``t`` takes vector
    ``t`` if ``t < nvec`` and a scalar if ``t < head + tail``)."""
    vec = VEC_BYTES // in_size
    t = np.arange(geo.blocks * geo.threads, dtype=np.int64)
    vectors = geo.head + t[t < geo.nvec] * vec
    s = t[t < geo.head + geo.tail]
    return vectors, np.where(s < geo.head, s, s + geo.nvec * vec)


_TORCH_OK = {torch_dtype(d) for d in _DT_CODES}


def fused_arith_plan(in_dtype, ops: Sequence[Tuple[str, object]]) -> ChainPlan:
    """The kernel's plan for a chain on an ``in_dtype`` stream; raises
    TypeError for a dtype the kernel does not take (64-bit types)."""
    in_dtype = numpy_dtype(in_dtype)
    if in_dtype not in _DT_CODES:
        raise TypeError(f"fused_arith: unsupported input dtype {in_dtype}")
    plan = plan_chain(in_dtype, tuple(ops))
    if plan.out_dtype not in _DT_CODES:
        raise TypeError(f"fused_arith: unsupported output dtype {plan.out_dtype}")
    return plan


def _check_fused_arith(x, ops) -> ChainPlan:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"fused_arith takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype not in _TORCH_OK:
        raise TypeError(f"fused_arith: unsupported input dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_arith: input must be contiguous")
    return fused_arith_plan(x.dtype, ops)


def fused_arith(x: torch.Tensor, ops: Sequence[Tuple[str, object]]) -> torch.Tensor:
    """Apply a bound arithmetic chain in one pass; any shape.

    ``ops`` is a chain as ``elements/transform.py::_bind_chain`` returns
    it.  The output dtype follows :func:`chain_out_dtype`.
    """
    plan = _check_fused_arith(x, ops)
    if x.device.type == "cpu":
        return run_chain(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"fused_arith: unsupported device {x.device}")
    y = torch.empty(x.shape, dtype=torch_dtype(plan.out_dtype), device=x.device)
    n = x.numel()
    if n == 0:
        return y
    geo = fused_arith_geometry(n, x.element_size(), y.element_size(), x.data_ptr(),
                               y.data_ptr())
    lib = _fused_arith_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nns_fused_arith(
            x.data_ptr(), y.data_ptr(), _DT_CODES[numpy_dtype(x.dtype)],
            _DT_CODES[plan.out_dtype], ctypes.byref(plan.c_program), geo.head, geo.nvec,
            geo.tail, geo.blocks, stream)
    if err:
        raise RuntimeError(f"fused_arith launch failed: CUDA error {err}")
    fused_arith.launches += 1
    return y


fused_arith.launches = 0


@functools.lru_cache(maxsize=None)
def _fused_arith_lib() -> ctypes.CDLL:
    lib = load("fused_arith")
    lib.nns_fused_arith.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Program), ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.nns_fused_arith.restype = ctypes.c_int
    return lib


# -- int8_matmul ------------------------------------------------------------


def int8_matmul_plain(x_q, w_q, x_scale, w_scale, bias=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul`, on any device.

    The product runs in float64, which is exact for int8 operands while
    |sum| < 2**53; the epilogue is ``acc * (xs * ws) + b`` in float32 with
    one rounding per operation, as the kernel computes it.
    """
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    n = w_q.shape[1]
    scale = x_scale.reshape(()).to(torch.float32) * w_scale.reshape(1, n).to(torch.float32)
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.float32, device=w_q.device)
    return acc.to(torch.float32) * scale + bias.reshape(1, n)


# The small-M branch of csrc/int8_matmul.cu: a split-K GEMV over a cluster
# of SPLIT_K blocks per TILE_N output columns, for M <= SMALL_M.  Each
# block stages up to PASS_K weight rows at a time; a row segment of TILE_N
# bytes lands in a SHARED_ROW-byte shared row that keeps its 16-byte phase.
SMALL_M = 16
SPLIT_K = 8
TILE_N = 64
PASS_K = 256
SHARED_ROW = TILE_N + 16
_MAX_GRID_Y = 65_535


class Int8Geometry(NamedTuple):
    """How one ``int8_matmul`` call is launched: ``branch`` is ``"splitk"``
    (clusters of SPLIT_K blocks along x) or ``"tiled"``; ``k_per_rank`` is
    the K rows each cluster rank takes (0 for the tiled branch), which the
    wrapper passes to the kernel; ``grid`` is the grid of blocks."""

    branch: str
    k_per_rank: int
    grid: Tuple[int, int]


def int8_matmul_geometry(m: int, k: int, n: int) -> Int8Geometry:
    """The branch and launch geometry of an (m, k) x (k, n) call."""
    tiles = -(-n // TILE_N)
    if m <= SMALL_M and tiles <= _MAX_GRID_Y:
        per_rank = -(-k // SPLIT_K)
        k_per_rank = max(4, -(-per_rank // 4) * 4)  # a whole number of dp4a words
        return Int8Geometry("splitk", k_per_rank, (SPLIT_K, tiles))
    return Int8Geometry("tiled", 0, (-(-n // 32), -(-m // 32)))


def weight_reads(m: int, k: int, n: int, base: int = 0):
    """The small-M branch's weight loads, in the kernel's own index math,
    for a (k, n) weight whose first byte lies at address ``base``.

    Each row segment of a column tile (``start``, ``start + ncols``) is
    copied as the aligned 16-byte windows that hold it, whole, into an
    80-byte shared row at offset ``16 v`` for window ``v``, so its byte at
    column ``col`` lands at ``(start & 15) + col``.  A window that crosses
    the tensor's first or last byte is copied byte by byte, within it.

    Returns ``(vectors, bytes_, segments)``: arrays of (address, shared
    offset, segment) for the 16-byte copies and for the single bytes, and
    the (start, ncols) of every segment, indexed by segment."""
    geo = int8_matmul_geometry(m, k, n)
    if geo.branch != "splitk":
        raise ValueError(f"({m},{k},{n}) takes the tiled branch")
    rows = []
    for rank in range(SPLIT_K):
        kbeg = rank * geo.k_per_rank
        kend = min(k, kbeg + geo.k_per_rank)
        for kt in range(kbeg, kend, PASS_K):
            rows.extend(range(kt, kt + min(PASS_K, kend - kt)))
    n0 = np.arange(geo.grid[1], dtype=np.int64) * TILE_N
    start = (base + np.asarray(rows, np.int64)[:, None] * n + n0[None, :]).ravel()
    ncols = np.broadcast_to(np.minimum(TILE_N, n - n0), (len(rows), len(n0))).ravel()
    phase = start & 15
    seg = np.arange(len(start))
    lo, hi = base, base + k * n
    vectors, singles = [], []
    for v in range(SHARED_ROW // 16):
        win = start - phase + 16 * v
        holds = 16 * v < phase + ncols
        whole = holds & (win >= lo) & (win + 16 <= hi)
        vectors.append(np.stack([win[whole], np.full(int(whole.sum()), 16 * v), seg[whole]], 1))
        for i in np.flatnonzero(holds & ~whole):
            addr = np.arange(max(win[i], lo), min(win[i] + 16, hi))
            singles.append(np.stack([addr, 16 * v + addr - win[i], np.full(len(addr), i)], 1))
    singles = np.concatenate(singles) if singles else np.zeros((0, 3), np.int64)
    return np.concatenate(vectors), singles, np.stack([start, ncols], 1)


def _check_int8_matmul(x_q, w_q, x_scale, w_scale, bias):
    tensors = [("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
               ("x_scale", x_scale, torch.float32), ("w_scale", w_scale, torch.float32)]
    if bias is not None:
        tensors.append(("bias", bias, torch.float32))
    for name, t, dtype in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"int8_matmul: {name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"int8_matmul: {name} must be {dtype}, got {t.dtype}")
        if t.device != x_q.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x_q on {x_q.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
        # Only the weight is read in 16-byte pieces, and the kernel finds
        # their alignment itself; every other operand is read one element at
        # a time.  So any element-aligned view (a storage offset included)
        # is fine.
        if t.data_ptr() % t.element_size():
            raise ValueError(f"int8_matmul: {name} is not aligned to its element size")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul: bad shapes x_q {tuple(x_q.shape)}, w_q {tuple(w_q.shape)}")
    n = w_q.shape[1]
    if x_scale.numel() != 1:
        raise ValueError("int8_matmul: x_scale must hold one value")
    if w_scale.numel() != n:
        raise ValueError(f"int8_matmul: w_scale must hold {n} values")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"int8_matmul: bias must hold {n} values")


def int8_matmul(x_q, w_q, x_scale, w_scale, bias=None) -> torch.Tensor:
    """``(x_q · w_q) * (x_scale * w_scale) + bias`` → (M, N) float32.

    x_q: (M, K) int8; w_q: (K, N) int8; x_scale: one float32 (per-tensor
    activation scale, a tensor so that it never leaves the device);
    w_scale: N float32 (per output channel); bias: (N,) float32 or None.
    On a CUDA tensor it is one launch: the split-K cluster branch for
    M <= :data:`SMALL_M`, the tiled branch above (:func:`int8_matmul_geometry`).
    """
    _check_int8_matmul(x_q, w_q, x_scale, w_scale, bias)
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale, bias)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x_q.device}")
    m, k = x_q.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    geo = int8_matmul_geometry(m, k, n)
    lib = _int8_matmul_lib()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = lib.nns_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, k, n, geo.k_per_rank, stream)
    if err:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


@functools.lru_cache(maxsize=None)
def _int8_matmul_lib() -> ctypes.CDLL:
    lib = load("int8_matmul")
    lib.nns_int8_matmul.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.nns_int8_matmul.restype = ctypes.c_int
    return lib


# Every kernel wrapper of the port, for launch counting; the NMS kernel's
# wrapper lives in ops/nms.py beside its plain version.
from .nms import pallas_nms_keep  # noqa: E402

KERNELS = (fused_arith, int8_matmul, pallas_nms_keep)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
