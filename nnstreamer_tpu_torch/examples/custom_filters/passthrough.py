"""Passthrough custom filter: shape-polymorphic, it echoes its input."""

from nnstreamer_tpu_torch.backends.custom import CustomFilterBase


class CustomFilter(CustomFilterBase):
    def set_input_spec(self, in_spec):
        return in_spec

    def invoke(self, *tensors):
        return tensors
