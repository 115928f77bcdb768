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

import torch

from .build import load

# The kernel keeps five float32 values and one keep byte per row in shared
# memory: 8192 rows take 172,032 bytes of the 227 KB a block may use.
MAX_K = 8192


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
    return x.shape[0]


def pallas_nms_keep(x, y, w, h, valid) -> torch.Tensor:
    """Keep mask (K,) bool of greedy IoU>0.5 NMS over score-ordered,
    integer-valued float32 boxes ``x, y, w, h`` (K,) seeded by ``valid``
    (K,) bool.  Bitwise equal to :func:`nms_keep`; on a CUDA tensor it is
    one launch of the ``nms_keep`` kernel, for K up to :data:`MAX_K`."""
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
