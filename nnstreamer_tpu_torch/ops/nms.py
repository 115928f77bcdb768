"""Greedy non-maximum suppression on the device, for fused detection segments.

The port of the JAX package's ``ops/nms.py``.  Boxes arrive score-ordered
as integer-valued float32 pixels (the decoder's ``px`` rule quantizes them
first), and row *i* suppresses a later row *j* when their IoU exceeds 0.5
under the host loop's inclusive-pixel convention (``x2 - x1 + 1``).  The
test is the exact ``2·inter > union``: with integer areas below 2**24 it
equals the host's float64 ``inter / union > 0.5``.  Above that float32
rounds, and the verdict is whatever float32 gives in this op order.

- :func:`nms_keep` is plain PyTorch: the pairwise suppression matrix, then
  the sequential greedy walk.  It is the port of the JAX package's XLA form
  and the plain version of the kernel.
- :func:`pallas_nms_keep` (the JAX package's name for its kernel entry)
  launches the hand-written CUDA kernel ``csrc/nms_keep.cu`` on a CUDA
  tensor and runs :func:`nms_keep` on a CPU tensor.  Each CUDA launch adds
  one to its ``launches`` count.  Fused detection segments always call it:
  the JAX package's ``[segment] pallas_nms`` switch exists because Pallas
  off the TPU runs interpreted, and the wrapper here already picks by
  device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import load

# Above BITS_MAX_K the kernel keeps five float32 values and one keep byte
# per row in shared memory: 8192 rows take 172,032 bytes of the 227 KB a
# block may use.
MAX_K = 8192
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448


def bits_smem_bytes(k: int) -> int:
    """Shared memory of the kernel's bit branch at K = k: the boxes (k
    float4 of x, y, x2, y2), the areas (k float32), the suppression bits
    (k rows of ceil(k/32) words, then 32 words of slack), then the valid
    mask (ceil(k/32) words)."""
    words = -(-k // 32)
    return 16 * k + 4 * k + 4 * (k * words + 32) + 4 * words


# The largest K whose bit layout fits (csrc/nms_keep.cu kBitsMaxK).
BITS_MAX_K = max(k for k in range(1, MAX_K + 1) if bits_smem_bytes(k) <= SMEM_LIMIT)


def suppression_matrix(x, y, w, h) -> torch.Tensor:
    """(K, K) bool: row *i* suppresses column *j*, in float32 with one
    rounding per operation, in the JAX package's op order."""
    x2 = x + w
    y2 = y + h
    ix1 = torch.maximum(x[:, None], x[None, :])
    iy1 = torch.maximum(y[:, None], y[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    iw = (ix2 - ix1 + 1.0).clamp_min(0.0)
    ih = (iy2 - iy1 + 1.0).clamp_min(0.0)
    inter = iw * ih
    area = w * h
    union = area[:, None] + area[None, :] - inter
    return (union > 0.0) & (2.0 * inter > union)


def greedy_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sequential greedy pass over score-ordered rows: row *i*, if still
    kept, clears every later row it suppresses.  ``valid`` seeds the keep
    mask, so an invalid row neither survives nor suppresses."""
    k = sup.shape[0]
    idx = torch.arange(k, device=sup.device)
    later = sup & (idx[None, :] > idx[:, None])
    keep = valid.clone()
    for i in range(k):
        keep = keep & ~(later[i] & keep[i])
    return keep


def nms_keep(x, y, w, h, valid) -> torch.Tensor:
    """Plain PyTorch NMS: the keep mask over score-ordered boxes."""
    return greedy_keep(suppression_matrix(x, y, w, h), valid)


def suppression_bits(x, y, w, h) -> np.ndarray:
    """The kernel's packed suppression bits: (K, ceil(K/32)) uint32, word
    ``c`` of row ``i`` has bit ``b`` set when row ``i`` suppresses row
    ``j = 32c + b`` and ``j > i``.  Every pair is tested, valid or not."""
    k = x.shape[0]
    words = -(-k // 32)
    sup = suppression_matrix(x, y, w, h).cpu().numpy()
    later = sup & (np.arange(k)[None, :] > np.arange(k)[:, None])
    padded = np.zeros((k, words * 32), bool)
    padded[:, :k] = later
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (padded.reshape(k, words, 32) * weights).sum(axis=2, dtype=np.uint32)


def bit_tasks(k: int):
    """The kernel's first-phase tasks at K = k, in task order: arrays of
    (column byte, row).  Column byte ``cb`` (columns 8 cb .. 8 cb + 7) has
    a task for each row ``i < min(k, 8 cb + 7)``: the bytes on or above the
    diagonal.  The first ``last + 1`` column bytes form a triangle whose
    task ``t`` lies in the column byte ``cb`` with ``4 cb^2 + 3 cb <= t``,
    found from a float32 square root and corrected, as the kernel does."""
    nb = 4 * -(-k // 32)
    last = min(nb - 1, (k - 7) // 8 if k >= 7 else -1)
    tri = 4 * (last + 1) ** 2 + 3 * (last + 1)
    t = np.arange(tri + (nb - last - 1) * k, dtype=np.int64)
    cb = np.empty_like(t)
    head = t[:tri].astype(np.float32)
    cb[:tri] = ((np.sqrt(np.float32(9) + np.float32(16) * head) - np.float32(3))
                * np.float32(0.125)).astype(np.int64)
    for _ in range(2):
        over = (t[:tri] < 4 * cb[:tri] ** 2 + 3 * cb[:tri]) & (cb[:tri] > 0)
        cb[:tri][over] -= 1
        under = t[:tri] >= 4 * (cb[:tri] + 1) ** 2 + 3 * (cb[:tri] + 1)
        cb[:tri][under] += 1
    cb[tri:] = last + 1 + (t[tri:] - tri) // k
    row = np.where(t < tri, t - (4 * cb ** 2 + 3 * cb), t - tri - (cb - last - 1) * k)
    return cb, row


def bit_walk_keep(bits: np.ndarray, valid) -> np.ndarray:
    """The kernel's greedy walk over packed bits, in 32-row chunks, as its
    one warp runs it.  Within a chunk the removed word is one value; a
    valid row whose bit is clear is kept and ORs in its diagonal word.
    Then the chunk's kept rows' later words join the removed mask."""
    valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, bool)
    k, words = bits.shape
    removed = [0] * words
    keep = np.zeros(k, bool)
    for c in range(words):
        r0 = c * 32
        rows = range(r0, min(k, r0 + 32))
        vmask = sum(1 << (r - r0) for r in rows if valid[r])
        rem = removed[c]
        for r in rows:
            if (vmask >> (r - r0)) & 1 and not (rem >> (r - r0)) & 1:
                rem |= int(bits[r, c])
        kept = vmask & ~rem
        for r in rows:
            keep[r] = bool((kept >> (r - r0)) & 1)
        for wi in range(c + 1, words):
            for r in rows:
                if (kept >> (r - r0)) & 1:
                    removed[wi] |= int(bits[r, wi])
    return keep


def _check(x, y, w, h, valid) -> int:
    for name, t, dtype in (("x", x, torch.float32), ("y", y, torch.float32),
                           ("w", w, torch.float32), ("h", h, torch.float32),
                           ("valid", valid, torch.bool)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"nms_keep: {name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"nms_keep: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != x.shape[0]:
            raise ValueError(f"nms_keep: {name} must be 1-D of length {x.shape[0]}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"nms_keep: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"nms_keep: {name} must be contiguous")
        # The kernel reads each operand one element at a time, so any
        # element-aligned view (a storage offset included) is fine.
        if t.data_ptr() % t.element_size():
            raise ValueError(f"nms_keep: {name} is not aligned to its element size")
    return x.shape[0]


def pallas_nms_keep(x, y, w, h, valid) -> torch.Tensor:
    """Keep mask (K,) bool of greedy IoU>0.5 NMS over score-ordered,
    integer-valued float32 boxes ``x, y, w, h`` (K,) seeded by ``valid``
    (K,) bool.  Bitwise equal to :func:`nms_keep`; on a CUDA tensor it is
    one launch of the ``nms_keep`` kernel, for K up to :data:`MAX_K`
    (the bit-walk design up to :data:`BITS_MAX_K`)."""
    k = _check(x, y, w, h, valid)
    if x.device.type == "cpu":
        return nms_keep(x, y, w, h, valid)
    if x.device.type != "cuda":
        raise ValueError(f"nms_keep: unsupported device {x.device}")
    if k > MAX_K:
        raise ValueError(f"nms_keep: the kernel takes at most {MAX_K} boxes, got {k}")
    keep = torch.empty((k,), dtype=torch.bool, device=x.device)
    if k == 0:
        return keep
    lib = _nms_keep_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nns_nms_keep(x.data_ptr(), y.data_ptr(), w.data_ptr(), h.data_ptr(),
                               valid.data_ptr(), keep.data_ptr(), k, stream)
    if err:
        raise RuntimeError(f"nms_keep launch failed: CUDA error {err}")
    pallas_nms_keep.launches += 1
    return keep


pallas_nms_keep.launches = 0


@functools.lru_cache(maxsize=None)
def _nms_keep_lib() -> ctypes.CDLL:
    lib = load("nms_keep")
    lib.nns_nms_keep.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    lib.nns_nms_keep.restype = ctypes.c_int
    return lib
