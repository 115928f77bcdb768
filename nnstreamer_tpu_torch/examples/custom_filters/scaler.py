"""Scaler custom filter: nearest-neighbour resize of an (H, W, C) video
tensor to the ``custom`` property's ``"WxH"``; with no property it passes
frames through unchanged.  Source row ``i`` of an output of height ``h`` is
``i * H // h`` (columns likewise), on the device the frame is on."""

import torch

from nnstreamer_tpu_torch.backends.custom import CustomFilterBase
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec


class CustomFilter(CustomFilterBase):
    def __init__(self, custom: str = ""):
        self.target = None
        if custom:
            w, _, h = custom.partition("x")
            self.target = (int(h), int(w))

    def set_input_spec(self, in_spec):
        t = in_spec.tensors[0]
        if len(t.shape) != 3:
            raise ValueError(f"scaler expects (H, W, C) video tensors, got {t}")
        if self.target is None:
            return in_spec
        h, w = self.target
        out = TensorSpec(dtype=t.dtype, shape=(h, w, t.shape[2]))
        return TensorsSpec(tensors=(out,), rate=in_spec.rate)

    def invoke(self, frame):
        if self.target is None:
            return frame
        h_in, w_in, _ = frame.shape
        h, w = self.target
        rows = torch.arange(h, device=frame.device) * h_in // h
        cols = torch.arange(w, device=frame.device) * w_in // w
        return frame.index_select(0, rows).index_select(1, cols)
