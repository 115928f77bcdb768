"""Average custom filter: an (H, W, C) video tensor to its per-channel
spatial mean, (1, 1, C), in the input's dtype (a float mean cast back, as
numpy's ``astype`` truncates it)."""

import torch

from nnstreamer_tpu_torch.backends.custom import CustomFilterBase
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec


class CustomFilter(CustomFilterBase):
    def set_input_spec(self, in_spec):
        t = in_spec.tensors[0]
        if len(t.shape) != 3:
            raise ValueError(f"average expects (H, W, C) video tensors, got {t}")
        out = TensorSpec(dtype=t.dtype, shape=(1, 1, t.shape[2]))
        return TensorsSpec(tensors=(out,), rate=in_spec.rate)

    def invoke(self, frame):
        acc = torch.float64 if not frame.dtype.is_floating_point else frame.dtype
        return frame.to(acc).mean(dim=(0, 1), keepdim=True).to(frame.dtype)
