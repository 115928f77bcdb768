"""``tensor_converter``: media streams → tensor streams.

The port of the JAX element.  A raw frame passes through as a tensor:
video (H, W, C), with 4-byte raster stride padding sliced off
(``meta["stride"]``, :meth:`TensorConverter._strip_stride`), audio
(samples, channels), text and octet buffers as they come.
``frames_per_tensor`` frames are stacked on a new leading axis, and a
missing timestamp is synthesized from the input rate.

``input-dim`` / ``input-type`` reinterpret each incoming buffer's bytes as
tensors of the declared spec (:meth:`TensorConverter._reinterpret`): a
buffer may hold several, each sent on as a frame of its own, and
negotiation refuses an upstream frame whose size is not a whole number of
them.

``input-format=protobuf`` reads each incoming byte buffer as a stream of
length-prefixed ``TensorFrame`` messages (``tensor_decoder mode=protobuf``'s
output, a ``filesrc`` capture of it) and sends one frame a message;
``num-tensors`` declares the tensor count a message carries, the one thing
negotiation knows of them (dtypes and shapes ride in each message).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional

import torch

from ..buffer import NONE_TS, SECOND, Frame, is_valid_ts
from ..decoders.proto import LEN_PREFIX
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..interop import decode_frame
from ..media import VideoSpec
from ..spec import TensorSpec, TensorsSpec, torch_dtype


@register_element("tensor_converter")
class TensorConverter(Node):
    def __init__(self, name: Optional[str] = None, frames_per_tensor: int = 1,
                 input_dim: str = "", input_type: str = "", input_format: str = "",
                 num_tensors: int = 1):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.frames_per_tensor = int(frames_per_tensor)
        if self.frames_per_tensor < 1:
            raise ValueError("frames-per-tensor must be >= 1")
        self.input_format = str(input_format or "").lower()
        if self.input_format not in ("", "protobuf"):
            raise ValueError(f"unknown input-format {input_format!r} (know: protobuf)")
        if self.input_format and self.frames_per_tensor != 1:
            raise ValueError("frames-per-tensor does not apply to input-format=protobuf "
                             "(each message is one self-describing frame)")
        if self.input_format and input_type:
            raise ValueError("input-type does not apply to input-format=protobuf "
                             "(dtypes ride in each message)")
        self.num_tensors = int(num_tensors)
        if self.num_tensors < 1:
            raise ValueError("num-tensors must be >= 1")
        if not self.input_format and self.num_tensors != 1:
            raise ValueError("num-tensors only applies with input-format=protobuf")
        self.input_spec: Optional[TensorSpec] = None
        if input_dim:
            if self.input_format:
                raise ValueError("input-dim and input-format are mutually exclusive "
                                 "(protobuf messages are self-describing)")
            self.input_spec = TensorSpec.from_dims_string(input_dim, input_type or "uint8")
        self._in_rate: Optional[Fraction] = None
        self._adapter: List[Frame] = []
        self._frame_idx = 0

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        in_spec = in_specs["sink"]
        self._in_rate = in_spec.rate
        self._adapter = []
        self._frame_idx = 0
        rate = in_spec.rate
        if self.input_format == "protobuf":
            if in_spec.num_tensors != 1:
                raise NegotiationError(
                    f"{self.name}: protobuf input must be a single byte buffer per frame, "
                    f"got {in_spec.num_tensors} tensors")
            return {"src": TensorsSpec(tensors=tuple(TensorSpec() for _ in
                                                     range(self.num_tensors)), rate=rate)}
        if rate and self.frames_per_tensor != 1:
            rate = rate / self.frames_per_tensor
        if self.input_spec is not None:
            t = self.input_spec
            if self.frames_per_tensor != 1:
                t = TensorSpec(dtype=t.dtype, shape=(self.frames_per_tensor,) + t.shape)
            if in_spec.num_tensors == 1 and in_spec.tensors[0].is_fixed:
                up_bytes = in_spec.tensors[0].nbytes
                if up_bytes % self.input_spec.nbytes:
                    raise NegotiationError(
                        f"{self.name}: upstream {up_bytes}B not a multiple of "
                        f"declared tensor {self.input_spec.nbytes}B")
            return {"src": TensorsSpec(tensors=(t,), rate=rate)}
        if in_spec.num_tensors != 1:
            raise NegotiationError(f"{self.name}: converter input must be single-tensor")
        t = in_spec.tensors[0]
        if self.frames_per_tensor != 1:
            t = TensorSpec(dtype=t.dtype, shape=(self.frames_per_tensor,) + t.shape)
        return {"src": TensorsSpec(tensors=(t,), rate=rate)}

    @staticmethod
    def _strip_stride(arr: torch.Tensor, frame: Frame) -> torch.Tensor:
        """Slice off 4-byte raster stride padding (a view, no copy)."""
        if frame.meta.get("stride") is None:
            return arr
        return arr[:, :frame.meta["width"], ...]

    def _reinterpret(self, arr: torch.Tensor) -> torch.Tensor:
        """The buffer's bytes as one tensor of the declared spec, or as a
        stack of several along a new leading axis."""
        t = self.input_spec
        raw = arr.contiguous().reshape(-1).view(torch.uint8)
        want = t.nbytes
        if raw.numel() % want:
            raise ValueError(f"{self.name}: buffer of {raw.numel()}B does not hold whole "
                             f"{want}B tensors")
        if raw.storage_offset() % t.dtype.itemsize:
            raw = raw.clone()  # a typed view needs an aligned start
        n = raw.numel() // want
        typed = raw.view(torch_dtype(t.dtype))
        return typed.reshape(t.shape if n == 1 else (n,) + tuple(t.shape))

    def _synthesize_ts(self, frame: Frame) -> Frame:
        """Fill a missing PTS/duration from the input frame rate."""
        if is_valid_ts(frame.pts) or not self._in_rate:
            return frame
        dur = int(SECOND / self._in_rate)
        return Frame(tensors=frame.tensors, pts=self._frame_idx * dur,
                     duration=dur, meta=frame.meta)

    def _messages(self, frame: Frame) -> None:
        """Push one frame a length-prefixed message of the buffer, each as
        it is parsed.  The transport frame's timing wins where it is valid
        (a live stream restamps); else the message's, the capture's, does."""
        raw = frame.tensor(0).detach().reshape(-1).contiguous().cpu()
        buf = memoryview(raw.view(torch.uint8).numpy()) if raw.numel() else memoryview(b"")
        off = 0
        while off < len(buf):
            if off + LEN_PREFIX.size > len(buf):
                raise ValueError(f"{self.name}: truncated length prefix at byte "
                                 f"{off}/{len(buf)}")
            (mlen,) = LEN_PREFIX.unpack_from(buf, off)
            off += LEN_PREFIX.size
            if off + mlen > len(buf):
                raise ValueError(f"{self.name}: truncated protobuf message ({mlen}B "
                                 f"declared, {len(buf) - off}B left)")
            decoded = decode_frame(buf[off:off + mlen])
            off += mlen
            if len(decoded.tensors) != self.num_tensors:
                # the src pad negotiated num-tensors open specs: another count
                # would break the caps contract far from its cause
                raise ValueError(f"{self.name}: protobuf message carries "
                                 f"{len(decoded.tensors)} tensors, negotiated "
                                 f"num-tensors={self.num_tensors}")
            self.src_pads["src"].push(Frame(
                tensors=decoded.tensors,
                pts=frame.pts if is_valid_ts(frame.pts) else decoded.pts,
                duration=frame.duration if is_valid_ts(frame.duration) else decoded.duration,
                meta=dict(frame.meta)))

    def process(self, pad: Pad, frame: Frame):
        del pad
        if self.input_format == "protobuf":
            self._messages(frame)
            return None
        arr = frame.tensor(0)
        if isinstance(frame.meta.get("media"), VideoSpec):
            arr = self._strip_stride(arr, frame)
        if self.input_spec is not None:
            arr = self._reinterpret(arr)
            if arr.dim() == len(self.input_spec.shape) + 1:
                # several tensors in one buffer: a frame each
                out = []
                dur = frame.duration
                if is_valid_ts(dur) and arr.shape[0] > 1:
                    dur //= arr.shape[0]
                for i in range(arr.shape[0]):
                    got = self._batch(self._synthesize_ts(
                        Frame.of(arr[i], pts=frame.pts, duration=dur)))
                    if got is not None:
                        out.extend(got)
                    self._frame_idx += 1
                return out or None
        out = self._batch(self._synthesize_ts(frame.with_tensors((arr,))))
        self._frame_idx += 1
        return out

    def _batch(self, frame: Frame):
        if self.frames_per_tensor == 1:
            return [frame]
        self._adapter.append(frame)
        if len(self._adapter) < self.frames_per_tensor:
            return None
        first = self._adapter[0]
        durs = [f.duration for f in self._adapter if is_valid_ts(f.duration)]
        stacked = torch.stack([f.tensor(0) for f in self._adapter], dim=0)
        self._adapter = []
        return [Frame.of(stacked, pts=first.pts, duration=sum(durs) if durs else NONE_TS)]
