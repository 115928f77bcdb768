"""``tensor_crop``: crop regions out of a tensor stream, driven by a second
stream of region tensors.

The port of the JAX package's ``elements/crop.py`` (upstream nnstreamer's
element for the detect→crop→classify pattern): a ``raw`` sink pad takes
``(H, W, C)`` frames, an ``info`` sink pad takes ``(4,)`` or ``(N, 4)``
integer or float rows ``[x, y, w, h]`` in pixels, and the two are
collected by the same time-sync engine as ``tensor_mux``
(:class:`~.collect.CollectNode`).

- **dynamic** (default): one output tensor a region, each of its own
  ``(h, w, C)`` shape, clipped to the frame; the negotiated spec leaves
  the dims open.
- **static** (``size="W:H" num=K``): always one ``(K, H, W, C)`` tensor,
  zero-padded when fewer regions arrive, each region's ``w/h`` ignored in
  favour of the static size and its ``x/y`` clamped to the frame.  One
  shape, so the filter downstream captures one CUDA graph.

A row with ``w <= 0`` or ``h <= 0`` is the empty-region sentinel (a
detector pads its fixed-K output with zero-area rows) and is skipped in
both modes; a round whose regions are all empty gives an all-zero stack in
static mode and no frame in dynamic mode.

The crops are slices of the raw tensor on its own device (the card after
``tensor_upload``): the static stack is filled there by device copies and a
dynamic crop is a contiguous copy of its slice.  Only the small region
tensor is read to the host, where its values are truncated to int64 as
numpy's ``astype(np.int64)`` truncates them.  Whole-segment compilation
stops at this element (``graph/segments.py`` folds no collect node).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..graph.node import NegotiationError
from ..graph.registry import register_element
from ..spec import NNS_TENSOR_SIZE_LIMIT, TensorSpec, TensorsSpec
from .collect import CollectNode


@register_element("tensor_crop")
class TensorCrop(CollectNode):
    REQUEST_SINK_PADS = False

    def __init__(self, name: Optional[str] = None, size: str = "", num: int = 0,
                 sync_mode: str = "slowest", sync_option: str = ""):
        super().__init__(name, sync_mode=sync_mode, sync_option=sync_option)
        self.add_sink_pad("raw")
        self.add_sink_pad("info")
        self.size = str(size)
        self.num = int(num)
        self._static_wh = None
        if self.size:
            parts = self.size.split(":")
            if len(parts) != 2:
                raise ValueError(f"size must be 'W:H', got {self.size!r}")
            w, h = int(parts[0]), int(parts[1])
            if w <= 0 or h <= 0:
                raise ValueError(f"size must be positive, got {self.size!r}")
            if self.num <= 0:
                raise ValueError("static mode (size=W:H) requires num=K > 0")
            self._static_wh = (w, h)
        elif self.num < 0:
            raise ValueError(f"num must be >= 0, got {self.num}")

    # -- negotiation --------------------------------------------------------

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        raw = in_specs["raw"].tensors[0]
        info = in_specs["info"].tensors[0]
        if raw.rank is not None and raw.rank != 3:
            raise NegotiationError(
                f"{self.name}: raw pad expects (H, W, C) video-layout tensors, got {raw}")
        if info.shape is not None:
            last = info.shape[-1]
            if last is not None and last != 4:
                raise NegotiationError(
                    f"{self.name}: info regions must be [x, y, w, h] rows, "
                    f"got trailing dim {last}")
        rate = in_specs["raw"].rate
        chan = raw.shape[2] if raw.shape is not None else None
        if self._static_wh is not None:
            w, h = self._static_wh
            out = TensorSpec(dtype=raw.dtype, shape=(self.num, h, w, chan))
        else:  # per-region shapes depend on the data
            out = TensorSpec(dtype=raw.dtype, shape=(None, None, chan))
        return {"src": TensorsSpec.of(out, rate=rate)}

    # -- combination --------------------------------------------------------

    @staticmethod
    def _regions(info) -> np.ndarray:
        """The region rows on the host as int64, truncated toward zero."""
        if isinstance(info, torch.Tensor):
            info = info.detach()
            if info.dtype == torch.bfloat16:
                info = info.float()  # exact: bfloat16 is a float32 prefix
            info = info.cpu().numpy()
        r = np.asarray(info)
        if r.ndim == 1:
            r = r.reshape(1, -1)
        if r.ndim != 2 or r.shape[-1] != 4:
            raise ValueError(
                f"info tensor must be (4,) or (N, 4) [x, y, w, h], got shape {r.shape}")
        return r.astype(np.int64)

    def combine(self, frames: Dict[str, Frame]) -> Optional[Frame]:
        raw_f, info_f = frames["raw"], frames["info"]
        img = torch.as_tensor(raw_f.tensors[0])
        regions = self._regions(info_f.tensors[0])
        H, W = img.shape[0], img.shape[1]
        pts, dur = self.output_timing(frames)

        if self._static_wh is not None:
            w, h = self._static_wh
            out = torch.zeros((self.num, h, w, img.shape[2]), dtype=img.dtype,
                              device=img.device)
            filled = 0
            for x, y, rw, rh in regions:
                if filled >= self.num:
                    break
                if rw <= 0 or rh <= 0:
                    continue  # empty-region sentinel row
                x = max(0, min(int(x), W - w)) if W >= w else 0
                y = max(0, min(int(y), H - h)) if H >= h else 0
                src = img[y:y + h, x:x + w]
                out[filled, :src.shape[0], :src.shape[1]] = src
                filled += 1
            meta = dict(raw_f.meta)
            meta["tensor_crop"] = {"regions": filled}
            return Frame(tensors=(out,), pts=pts, duration=dur, meta=meta)

        crops = []
        limit = self.num if self.num > 0 else NNS_TENSOR_SIZE_LIMIT
        for x, y, rw, rh in regions:
            if len(crops) >= limit:
                break
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(W, int(x) + int(rw)), min(H, int(y) + int(rh))
            if x1 <= x0 or y1 <= y0:
                continue  # empty or clipped-away region
            crops.append(img[y0:y1, x0:x1].contiguous())
        if not crops:
            return None  # no valid region: the round gives no frame
        meta = dict(raw_f.meta)
        meta["tensor_crop"] = {"regions": len(crops)}
        return Frame(tensors=tuple(crops), pts=pts, duration=dur, meta=meta)
