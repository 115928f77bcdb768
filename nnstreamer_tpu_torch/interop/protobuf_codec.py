"""Frame to and from protobuf bytes (schema: ``proto/tensor_frame.proto``).

A proto3 codec of the port's own for the schema's two messages, with no
``protobuf`` package behind it::

    message Tensor      { string name = 1; string dtype = 2;
                          repeated uint64 shape = 3; bytes data = 4; }
    message TensorFrame { repeated Tensor tensors = 1;
                          optional int64 pts = 2; optional int64 duration = 3; }

:func:`encode_frame` writes the bytes that protobuf's ``SerializeToString``
writes for the same message: fields in field-number order, a field at its
default (an empty name, shape or payload) left out, ``shape`` as one
packed varint list, ``pts`` / ``duration`` present only when set, a
negative int64 as a 10-byte varint.  :func:`decode_frame` parses what
protobuf's parser accepts: ``shape`` packed or not, fields in any order
(the last of a repeated scalar wins), unknown fields of any wire type
skipped, and a known field number with another wire type skipped as
unknown.

Payloads are C-contiguous little-endian (the byte order of every host the
port runs on); dtypes are the spec layer's names, ``bfloat16`` included
(``torch.bfloat16`` on both ends).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..buffer import NONE_TS, Frame, is_valid_ts, tensor_bytes
from ..spec import dtype_from_name, dtype_name, torch_dtype

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_MASK64 = (1 << 64) - 1


# -- the wire ---------------------------------------------------------------

def _varint(value: int) -> bytes:
    """Base-128 varint of ``value`` taken as 64 bits (two's complement)."""
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint(field << 3 | wire_type)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(payload)) + payload


def _read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= end:
            raise ValueError("protobuf: truncated varint")
        if shift >= 70:
            raise ValueError("protobuf: varint longer than 10 bytes")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & _MASK64, pos
        shift += 7


def _skip(buf, pos: int, end: int, wire_type: int, field: int) -> int:
    """Position past one field's value of ``wire_type`` (an unknown field)."""
    if wire_type == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire_type in (_I64, _I32):
        pos += 8 if wire_type == _I64 else 4
    elif wire_type == _LEN:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    elif wire_type == _SGROUP:
        while True:  # fields up to the group's matching end tag
            tag, pos = _read_varint(buf, pos, end)
            if tag & 7 == _EGROUP:
                if tag >> 3 != field:
                    raise ValueError("protobuf: mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, tag & 7, tag >> 3)
    else:
        raise ValueError(f"protobuf: invalid wire type {wire_type}")
    if pos > end:
        raise ValueError("protobuf: truncated field")
    return pos


def _fields(buf, pos: int, end: int):
    """(field number, wire type, value start, value end) of each field of
    the message in ``buf[pos:end]``; a varint's value is read by the caller."""
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        field, wire_type = tag >> 3, tag & 7
        if field == 0:
            raise ValueError("protobuf: field number 0")
        if wire_type == _EGROUP:
            raise ValueError("protobuf: unmatched end-group tag")
        start = pos
        if wire_type == _LEN:
            n, start = _read_varint(buf, pos, end)
            if start + n > end:
                raise ValueError("protobuf: truncated length-delimited field")
            pos = start + n
        else:
            pos = _skip(buf, pos, end, wire_type, field)
        yield field, wire_type, start, pos


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >> 63 else value


def _text(buf, start: int, end: int) -> str:
    try:
        return bytes(buf[start:end]).decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError("protobuf: a string field is not valid UTF-8") from None


# -- frames -----------------------------------------------------------------

def encode_frame(frame: Frame, names=None) -> bytes:
    """Serialize every tensor and the timing into one ``TensorFrame``.

    An unstamped frame leaves ``pts`` / ``duration`` absent, so it decodes
    as "no timestamp", not as t=0.  Per-tensor names come from ``names`` (a
    sequence aligned with ``frame.tensors``) or else from
    ``frame.meta["tensor_names"]``, the key :func:`decode_frame` restores
    them under."""
    if names is None:
        names = frame.meta.get("tensor_names") or ()
    out = bytearray()
    for i, t in enumerate(frame.tensors):
        t = torch.as_tensor(t)
        data = tensor_bytes(t)
        msg = bytearray()
        if i < len(names) and names[i]:
            msg += _len_field(1, str(names[i]).encode("utf-8"))
        msg += _len_field(2, dtype_name(t.dtype).encode("utf-8"))
        if t.dim():
            msg += _len_field(3, b"".join(_varint(int(d)) for d in t.shape))
        if data:
            msg += _len_field(4, data)
        out += _len_field(1, bytes(msg))
    if frame.pts is not None and is_valid_ts(frame.pts):
        out += _key(2, _VARINT) + _varint(int(frame.pts))
    if frame.duration is not None and is_valid_ts(frame.duration):
        out += _key(3, _VARINT) + _varint(int(frame.duration))
    return bytes(out)


def _parse_tensor(buf, pos: int, end: int) -> Tuple[str, str, List[int], memoryview]:
    name = dtype = ""
    shape: List[int] = []
    data = buf[0:0]
    for field, wt, start, stop in _fields(buf, pos, end):
        if field == 1 and wt == _LEN:
            name = _text(buf, start, stop)
        elif field == 2 and wt == _LEN:
            dtype = _text(buf, start, stop)
        elif field == 3 and wt == _LEN:  # packed
            p = start
            while p < stop:
                d, p = _read_varint(buf, p, stop)
                shape.append(d)
        elif field == 3 and wt == _VARINT:  # unpacked
            shape.append(_read_varint(buf, start, stop)[0])
        elif field == 4 and wt == _LEN:
            data = buf[start:stop]
    return name, dtype, shape, data


def decode_frame(data) -> Frame:
    """Parse a ``TensorFrame`` message back into a Frame of host tensors."""
    buf = memoryview(data).cast("B")
    entries = []
    pts: Optional[int] = None
    duration: Optional[int] = None
    for field, wt, start, stop in _fields(buf, 0, len(buf)):
        if field == 1 and wt == _LEN:
            entries.append(_parse_tensor(buf, start, stop))
        elif field == 2 and wt == _VARINT:
            pts = _signed64(_read_varint(buf, start, stop)[0])
        elif field == 3 and wt == _VARINT:
            duration = _signed64(_read_varint(buf, start, stop)[0])
    tensors = []
    for name, dtype_s, shape, payload in entries:
        dtype = dtype_from_name(dtype_s)
        n = 1
        for d in shape:
            n *= d
        if len(payload) != n * dtype.itemsize:
            raise ValueError(
                f"protobuf tensor payload is {len(payload)}B, expected "
                f"{n * dtype.itemsize}B for {dtype_s}{tuple(shape)}")
        tdt = torch_dtype(dtype)
        t = torch.frombuffer(bytearray(payload), dtype=tdt) if n else torch.empty(0, dtype=tdt)
        tensors.append(t.reshape(tuple(shape)))
    meta = {}
    if any(e[0] for e in entries):
        meta["tensor_names"] = tuple(e[0] for e in entries)
    return Frame(tensors=tuple(tensors),
                 pts=pts if pts is not None else NONE_TS,
                 duration=duration if duration is not None else NONE_TS,
                 meta=meta)
