"""RNN-step custom filter: one step of a parameter-free tanh RNN, ``(h, x)``
→ ``tanh(h + x)``, for a cycle through repo slots; on the tensors' device."""

import torch

from nnstreamer_tpu_torch.backends.custom import CustomFilterBase
from nnstreamer_tpu_torch.spec import TensorsSpec


class CustomFilter(CustomFilterBase):
    def set_input_spec(self, in_spec):
        if in_spec.num_tensors != 2:
            raise ValueError("rnn filter expects (h, x)")
        h, x = in_spec.tensors
        if h.shape != x.shape:
            raise ValueError(f"h/x specs must match, got {in_spec}")
        return TensorsSpec(tensors=(h,), rate=in_spec.rate)

    def invoke(self, h, x):
        h, x = (torch.as_tensor(t).to(torch.float32) for t in (h, x))
        return torch.tanh(h + x)
