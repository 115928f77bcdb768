"""Two of the port's hand-written CUDA kernels, their wrappers and plain versions.

- :func:`fused_arith` replaces the JAX package's
  ``ops/pallas_kernels.py::fused_arith``: one elementwise pass of a ``tensor_transform`` chain
  (``csrc/fused_arith.cu``).
- :func:`int8_matmul` replaces the JAX package's
  ``ops/pallas_kernels.py::int8_matmul``: int8 x int8 → int32 product with the dequant and bias in
  the epilogue (``csrc/int8_matmul.cu``).

Each wrapper checks device, dtype, shape and contiguity.  A CPU tensor goes
to the plain PyTorch version beside it (``*_plain``), which computes the
same function step for step; a CUDA tensor launches the kernel or raises.
Each CUDA launch adds one to the wrapper's ``launches`` count.  The sources
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

from ..spec import numpy_dtype, torch_dtype
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


def _is_int(dtype: np.dtype) -> bool:
    return np.issubdtype(dtype, np.integer)


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
    np.dtype(np.float16): 6, np.dtype(np.float32): 7,
}
_OP_CODES = {"typecast": 0, "add": 1, "sub": 2, "mul": 3, "clamp": 5}
MAX_STEPS = 8


class _Step(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int), ("dt", ctypes.c_int),
                ("a", ctypes.c_double), ("b", ctypes.c_double)]


class _Chain(ctypes.Structure):
    _fields_ = [("start_dt", ctypes.c_int), ("n_steps", ctypes.c_int),
                ("steps", _Step * MAX_STEPS)]


def _reciprocal(val, dt: np.dtype) -> float:
    """1/val as XLA computes it when it rewrites ``x / const`` into
    ``x * (1 / const)`` (its algebraic simplifier does so on every backend,
    so JAX's division by a literal is this product, not an IEEE division):
    the literal rounded to the step dtype, inverted in that dtype (float16
    through float32, as Eigen's half does)."""
    c = np.float32(dt.type(val))
    inv = np.float32(1) / c
    return float(dt.type(inv))


class ChainPlan:
    """A bound chain, resolved for one input dtype: the dtype it starts
    from, each step's (op, result dtype, operand a, operand b), and the
    output dtype."""

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
                op, a, b = "mul", _reciprocal(val, cur), 0.0
            else:
                a, b = val, 0.0
            steps.append((op, cur, a, b))
        self.steps = tuple(steps)

    @functools.cached_property
    def c_chain(self) -> _Chain:
        c = _Chain()
        c.start_dt = _DT_CODES[self.start_dtype]
        c.n_steps = len(self.steps)
        for i, (op, dt, a, b) in enumerate(self.steps):
            c.steps[i] = _Step(_OP_CODES[op], _DT_CODES[dt], float(a), float(b))
        return c


@functools.lru_cache(maxsize=256)
def plan_chain(in_dtype: np.dtype, ops: Tuple[Tuple[str, object], ...],
               promote: bool = True) -> ChainPlan:
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
    return _round_half(f) if dt == np.float16 else f


def _literal(a, dt: np.dtype, device) -> torch.Tensor:
    """A Python literal in the step dtype, rounded once from double, as a
    0-d tensor on ``device``."""
    if _is_int(dt):
        return torch.tensor(int(a), dtype=torch.int64, device=device)
    return torch.tensor(float(dt.type(a)), dtype=torch.float32, device=device)


def _apply_step(v: torch.Tensor, op: str, dt: np.dtype, a, b) -> torch.Tensor:
    if op == "typecast":
        return v
    lit = _literal(a, dt, v.device)
    if op == "clamp":
        hi = _literal(b, dt, v.device)
        v = torch.where(lit >= v, lit, v)  # XLA max(lo, x): NaN propagates
        r = torch.where(hi <= v, hi, v)
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
    return _round_half(r) if dt == np.float16 else r


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
    lib = _fused_arith_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nns_fused_arith(
            x.data_ptr(), y.data_ptr(), n, _DT_CODES[numpy_dtype(x.dtype)],
            _DT_CODES[plan.out_dtype], ctypes.byref(plan.c_chain), stream)
    if err:
        raise RuntimeError(f"fused_arith launch failed: CUDA error {err}")
    fused_arith.launches += 1
    return y


fused_arith.launches = 0


@functools.lru_cache(maxsize=None)
def _fused_arith_lib() -> ctypes.CDLL:
    lib = load("fused_arith")
    lib.nns_fused_arith.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_Chain), ctypes.c_void_p]
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
