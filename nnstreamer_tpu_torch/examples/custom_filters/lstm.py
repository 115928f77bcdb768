"""LSTM-step custom filter: one step of a parameter-free LSTM-like update,
``(h, c, x)`` → ``(h', c')`` with ``c' = tanh(c + x)`` and ``h' = tanh(h +
c')``, for a cycle through repo slots; on the tensors' device."""

import torch

from nnstreamer_tpu_torch.backends.custom import CustomFilterBase
from nnstreamer_tpu_torch.spec import TensorsSpec


class CustomFilter(CustomFilterBase):
    def set_input_spec(self, in_spec):
        if in_spec.num_tensors != 3:
            raise ValueError("lstm filter expects (h, c, x)")
        h, c, x = in_spec.tensors
        if not (h.shape == c.shape == x.shape):
            raise ValueError(f"h/c/x specs must match, got {in_spec}")
        return TensorsSpec(tensors=(h, c), rate=in_spec.rate)

    def invoke(self, h, c, x):
        h, c, x = (torch.as_tensor(t).to(torch.float32) for t in (h, c, x))
        c_new = torch.tanh(c + x)
        return torch.tanh(h + c_new), c_new
