"""``protobuf`` decoder: tensor frames to serialized protobuf bytes.

The port of the JAX package's ``decoders/proto.py``, the analog of
upstream 2.x's ``tensordec-protobuf.cc``: the whole frame (every tensor,
self-described, and its pts/duration) becomes one ``TensorFrame`` message
(``proto/tensor_frame.proto``, :mod:`..interop.protobuf_codec`), emitted as
a flat uint8 host tensor.  The inverse is ``tensor_converter
input-format=protobuf``.

Framing: each message is prefixed with its length as 8 little-endian
bytes.  Bare proto3 messages concatenate ambiguously (a parser merges two
appended messages into one), so a ``filesink`` capture of a stream would
otherwise read back as one frame; the converter splits on the prefixes.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..buffer import Frame
from ..elements.decoder import DecoderPlugin, register_decoder
from ..interop import encode_frame
from ..spec import TensorSpec, TensorsSpec

LEN_PREFIX = struct.Struct("<Q")


@register_decoder("protobuf")
class ProtobufEncode(DecoderPlugin):
    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        # the message's length varies by frame: a dtype-only spec
        return TensorsSpec(tensors=(TensorSpec(dtype=np.uint8, shape=None),),
                           rate=in_spec.rate)

    def decode(self, frame: Frame, in_spec: TensorsSpec) -> Frame:
        del in_spec
        msg = encode_frame(frame)
        payload = torch.frombuffer(bytearray(LEN_PREFIX.pack(len(msg)) + msg), dtype=torch.uint8)
        return Frame(tensors=(payload,), pts=frame.pts, duration=frame.duration,
                     meta=dict(frame.meta))
