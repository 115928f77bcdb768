"""Interop codecs: tensor frames to and from standard wire formats.

The port's copy of the JAX package's ``interop``: the protobuf codec
(:mod:`.protobuf_codec`) backs ``tensor_decoder mode=protobuf`` and
``tensor_converter input-format=protobuf``.  It is written on ``struct``
and torch alone: the port needs no ``protobuf`` package.
"""

from .protobuf_codec import decode_frame, encode_frame  # noqa: F401
