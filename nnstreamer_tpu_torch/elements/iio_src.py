"""``tensor_src_iio``: Linux IIO sensor source.

The port of the JAX package's ``elements/iio_src.py``, the analog of
``gst/nnstreamer/tensor_source/tensor_src_iio.c`` (industrial-IO sensors
under ``/sys/bus/iio/devices``, ``:163-164``), in both of the reference's
operating modes (``:182-184``):

- **poll / one-shot**: each sample re-reads the ``in_*_raw`` sysfs values
  and applies scale and offset;
- **continuous**: the buffered capture.  It parses
  ``scan_elements/in_*_{en,index,type}`` (type strings
  ``[be|le]:[s|u]bits/storagebits>>shift``, ``:717``), selects a trigger by
  name or number (``trigger/current_trigger``), sets the sampling
  frequency, sizes and enables the kernel ring buffer (``buffer/length``,
  ``buffer/enable``), then streams fixed-size binary scan frames from the
  character device (``dev_dir``/iio:deviceN: a FIFO or a file in tests, as
  ``unittest_src_iio.cpp`` makes with mkfifo), decoding each channel with
  endian swap, right shift, mask and sign extension (``:2314-2371``).

As in the reference's tests (``unittest_src_iio.cpp:52-120``), ``base_dir``
(sysfs) and ``dev_dir`` (character devices) redirect the roots, so a fake
tree exercises the element without hardware.

Properties (reference ``:149-160``): ``mode`` (poll|one-shot|continuous),
``device``/``device_number``, ``trigger``/``trigger_number``, ``channels``
(auto: enable every scan channel; custom: use the pre-enabled ones),
``buffer_capacity``, ``frequency``, ``merge_channels``, ``poll_timeout``
(ms), ``num_buffers``, ``base_dir``, ``dev_dir``.  Frames are float32 host
tensors: one (n,) tensor of the channels, or n (1,) tensors unmerged.
"""

from __future__ import annotations

import os
import re
import select
import time
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..buffer import SECOND, Frame
from ..graph.node import SourceNode
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec
from ..utils.props import parse_bool

DEFAULT_BASE_DIR = "/sys/bus/iio/devices"
DEFAULT_DEV_DIR = "/dev"
_CHANNEL_RE = re.compile(r"^in_(.+)_raw$")
_SCAN_EN_RE = re.compile(r"^in_(.+)_en$")
_TYPE_RE = re.compile(
    r"^(?P<endian>be|le):(?P<sign>s|u)(?P<bits>\d+)/(?P<storage>\d+)"
    r"(?:>>(?P<shift>\d+))?$"
)


def _read_text(path: str, default: str = "") -> str:
    try:
        with open(path, "r") as f:
            return f.read().strip()
    except OSError:
        return default


def _read_float(path: str, default: float) -> float:
    try:
        return float(_read_text(path) or default)
    except ValueError:
        return default


def _write_text(path: str, value: str) -> None:
    with open(path, "w") as f:
        f.write(value)


@dataclass
class ScanChannel:
    """One buffered channel parsed from ``scan_elements`` (reference
    ``GstTensorSrcIIOChannelProperties``)."""

    name: str
    index: int
    big_endian: bool
    is_signed: bool
    used_bits: int
    storage_bits: int
    shift: int
    scale: float = 1.0
    offset: float = 0.0
    location: int = 0  # byte offset in the scan frame (alignment-padded)

    @property
    def storage_bytes(self) -> int:
        return ((self.storage_bits - 1) >> 3) + 1 if self.storage_bits else 0

    def decode(self, frame: bytes) -> float:
        """Extract + scale this channel's value from one binary scan frame
        (the reference's per-dtype macro chain, ``tensor_src_iio.c:120-140``)."""
        raw = frame[self.location : self.location + self.storage_bytes]
        value = int.from_bytes(raw, "big" if self.big_endian else "little")
        value >>= self.shift
        value &= (1 << self.used_bits) - 1
        if self.is_signed and value & (1 << (self.used_bits - 1)):
            value -= 1 << self.used_bits
        return (value + self.offset) * self.scale


def parse_type_string(name: str, contents: str) -> Optional[ScanChannel]:
    """Parse ``[be|le]:[s|u]bits/storagebits[>>shift]`` (reference
    ``set_channel_type``, ``tensor_src_iio.c:717-790``).  Returns None on a
    malformed string or zero storage (the reference warns and skips)."""
    m = _TYPE_RE.match(contents.strip())
    if not m:
        return None
    used = int(m.group("bits"))
    storage = int(m.group("storage"))
    shift = int(m.group("shift") or 0)
    if storage == 0 or used == 0 or used > storage or shift >= storage:
        return None
    return ScanChannel(
        name=name,
        index=0,
        big_endian=m.group("endian") == "be",
        is_signed=m.group("sign") == "s",
        used_bits=used,
        storage_bits=storage,
        shift=shift,
    )


def assign_locations(channels: List[ScanChannel]) -> int:
    """Compute each channel's byte offset in the scan frame with the
    kernel's alignment rule (pad up to a multiple of storage_bytes,
    reference ``:1458-1465``); returns the total frame size."""
    size = 0
    for ch in sorted(channels, key=lambda c: c.index):
        sb = ch.storage_bytes
        if size % sb:
            size = size - (size % sb) + sb
        ch.location = size
        size += sb
    return size


class _PollChannel:
    def __init__(self, path: str, name: str):
        self.path = path
        self.name = name
        base = path[: -len("_raw")]
        self.scale = _read_float(base + "_scale", 1.0)
        self.offset = _read_float(base + "_offset", 0.0)

    def read(self) -> float:
        raw = float(_read_text(self.path) or 0)
        return (raw + self.offset) * self.scale


@register_element("tensor_src_iio")
class TensorSrcIIO(SourceNode):
    LANE_BLOCKING = True  # select()/timed reads against sysfs trigger files
    def __init__(
        self,
        name: Optional[str] = None,
        mode: str = "poll",
        device: str = "",
        device_number: int = -1,
        trigger: str = "",
        trigger_number: int = -1,
        channels: str = "auto",
        buffer_capacity: int = 1,
        frequency: float = 0.0,
        merge_channels: bool = True,
        poll_timeout: int = 10000,
        num_buffers: int = -1,
        base_dir: str = DEFAULT_BASE_DIR,
        dev_dir: str = DEFAULT_DEV_DIR,
    ):
        super().__init__(name)
        if mode not in ("poll", "one-shot", "continuous"):
            raise ValueError(f"tensor_src_iio: unknown mode {mode!r}")
        self.mode = mode
        self.device = str(device)
        self.device_number = int(device_number)
        self.trigger = str(trigger)
        self.trigger_number = int(trigger_number)
        self.channels = str(channels)
        if self.channels not in ("auto", "custom"):
            raise ValueError("channels must be 'auto' or 'custom'")
        self.buffer_capacity = int(buffer_capacity)
        self.frequency = float(frequency)
        # a launch string's "false" is False (the JAX element takes bool() of it)
        self.merge_channels = parse_bool(merge_channels, name="merge-channels")
        self.poll_timeout = int(poll_timeout)
        self.num_buffers = 1 if mode == "one-shot" else int(num_buffers)
        self.base_dir = os.fspath(base_dir)
        self.dev_dir = os.fspath(dev_dir)
        self._channels: List[_PollChannel] = []
        self._scan: List[ScanChannel] = []
        self._frame_size = 0
        self._dev_dir: Optional[str] = None
        self._dev_num = -1
        self._data_fd: Optional[int] = None
        self._data_is_fifo = False
        self._buffer_enabled = False

    # -- device discovery ---------------------------------------------------

    def _find_device(self) -> str:
        if not os.path.isdir(self.base_dir):
            raise FileNotFoundError(f"IIO base dir not found: {self.base_dir}")
        candidates = sorted(
            d for d in os.listdir(self.base_dir) if d.startswith("iio:device")
        )
        for d in candidates:
            path = os.path.join(self.base_dir, d)
            num = int(d.replace("iio:device", ""))
            dev_name = _read_text(os.path.join(path, "name"))
            if self.device and dev_name == self.device:
                self._dev_num = num
                return path
            if self.device_number >= 0 and num == self.device_number:
                self._dev_num = num
                return path
            if not self.device and self.device_number < 0:
                self._dev_num = num
                return path  # first device
        raise FileNotFoundError(
            f"IIO device not found (device={self.device!r}, "
            f"number={self.device_number}) under {self.base_dir}"
        )

    def _find_trigger(self) -> Optional[str]:
        """Resolve the trigger *name* to write into current_trigger
        (reference verifies the trigger exists under the base dir)."""
        if not self.trigger and self.trigger_number < 0:
            return None
        for d in sorted(os.listdir(self.base_dir)):
            if not d.startswith("trigger"):
                continue
            try:
                num = int(d.replace("trigger", ""))
            except ValueError:
                continue
            tname = _read_text(os.path.join(self.base_dir, d, "name"))
            if self.trigger and tname == self.trigger:
                return tname
            if self.trigger_number >= 0 and num == self.trigger_number:
                return tname
        raise FileNotFoundError(
            f"IIO trigger not found (trigger={self.trigger!r}, "
            f"number={self.trigger_number}) under {self.base_dir}"
        )

    def _scan_poll_channels(self, dev_dir: str) -> List[_PollChannel]:
        chans = []
        for fname in sorted(os.listdir(dev_dir)):
            m = _CHANNEL_RE.match(fname)
            if m:
                chans.append(_PollChannel(os.path.join(dev_dir, fname), m.group(1)))
        if not chans:
            raise ValueError(f"IIO device {dev_dir} has no in_*_raw channels")
        return chans

    def _scan_buffered_channels(self, dev_dir: str) -> List[ScanChannel]:
        scan_dir = os.path.join(dev_dir, "scan_elements")
        if not os.path.isdir(scan_dir):
            raise FileNotFoundError(
                f"continuous mode needs {scan_dir} (scan_elements)"
            )
        chans: List[ScanChannel] = []
        for fname in sorted(os.listdir(scan_dir)):
            m = _SCAN_EN_RE.match(fname)
            if not m:
                continue
            cname = m.group(1)
            en_path = os.path.join(scan_dir, fname)
            if self.channels != "auto" and _read_text(en_path, "0") != "1":
                continue  # custom: only pre-enabled channels
            type_str = _read_text(os.path.join(scan_dir, f"in_{cname}_type"))
            ch = parse_type_string(cname, type_str)
            if ch is None:
                # A channel we can't decode MUST NOT stay enabled: the
                # kernel would still pack its bytes into every scan frame
                # and desynchronize the whole layout.  auto: keep disabled;
                # custom (user enabled it explicitly): fail loudly.
                if self.channels == "auto":
                    _write_text(en_path, "0")
                    continue
                raise ValueError(
                    f"IIO channel {cname!r}: unparseable type {type_str!r}"
                )
            if self.channels == "auto":
                _write_text(en_path, "1")  # enable all (reference AUTO mode)
            ch.index = int(
                _read_text(os.path.join(scan_dir, f"in_{cname}_index"), "0")
                or 0
            )
            # scale/offset live in the device dir (shared with poll mode)
            ch.scale = _read_float(os.path.join(dev_dir, f"in_{cname}_scale"), 1.0)
            ch.offset = _read_float(os.path.join(dev_dir, f"in_{cname}_offset"), 0.0)
            chans.append(ch)
        if not chans:
            raise ValueError(f"IIO device {dev_dir}: no usable scan channels")
        chans.sort(key=lambda c: c.index)
        return chans

    def _setup_frequency(self, dev_dir: str) -> None:
        if self.frequency <= 0:
            return
        avail = _read_text(os.path.join(dev_dir, "sampling_frequency_available"))
        if avail:
            ok = any(
                abs(float(v) - self.frequency) < 1e-9
                for v in avail.replace(",", " ").split()
            )
            if not ok:
                raise ValueError(
                    f"frequency {self.frequency} not in available set: {avail}"
                )
        path = os.path.join(dev_dir, "sampling_frequency")
        if os.path.exists(path):
            freq = self.frequency
            _write_text(
                path, str(int(freq)) if freq == int(freq) else str(freq)
            )

    def start(self) -> None:
        super().start()
        self._dev_dir = self._find_device()
        if self.mode == "continuous":
            # frequency is a device-level setting only for buffered capture;
            # in poll mode it is purely the local poll rate (no sysfs writes)
            self._setup_frequency(self._dev_dir)
            trig = self._find_trigger()
            if trig is not None:
                _write_text(
                    os.path.join(self._dev_dir, "trigger", "current_trigger"),
                    trig,
                )
            self._scan = self._scan_buffered_channels(self._dev_dir)
            self._frame_size = assign_locations(self._scan)
            buf_dir = os.path.join(self._dev_dir, "buffer")
            if os.path.isdir(buf_dir):
                _write_text(
                    os.path.join(buf_dir, "length"), str(self.buffer_capacity)
                )
                _write_text(os.path.join(buf_dir, "enable"), "1")
                self._buffer_enabled = True
            data_path = os.path.join(self.dev_dir, f"iio:device{self._dev_num}")
            self._data_fd = os.open(data_path, os.O_RDONLY | os.O_NONBLOCK)
            import stat as _stat

            self._data_is_fifo = _stat.S_ISFIFO(os.fstat(self._data_fd).st_mode)
        else:
            self._channels = self._scan_poll_channels(self._dev_dir)

    def _disable_buffer(self) -> None:
        if not self._buffer_enabled:
            return
        self._buffer_enabled = False
        try:
            _write_text(
                os.path.join(self._dev_dir or "", "buffer", "enable"), "0"
            )
        except OSError:
            pass

    def stop(self) -> None:
        if self._data_fd is not None:
            try:
                os.close(self._data_fd)
            finally:
                self._data_fd = None
        # disable even if start() failed between enable and os.open — a
        # ring buffer left streaming makes later opens fail with EBUSY
        self._disable_buffer()
        super().stop()

    # -- streaming ----------------------------------------------------------

    def output_spec(self) -> TensorsSpec:
        n = (
            len(self._scan)
            if self.mode == "continuous"
            else len(self._channels)
        )
        rate = Fraction(self.frequency).limit_denominator() if self.frequency else None
        if self.merge_channels:
            tensors = (TensorSpec(dtype=np.float32, shape=(n,)),)
        else:
            tensors = tuple(
                TensorSpec(dtype=np.float32, shape=(1,)) for _ in range(n)
            )
        return TensorsSpec(tensors=tensors, rate=rate)

    def _emit_frame(self, values: np.ndarray, idx: int, dur: int) -> Frame:
        pts = idx * dur if dur else 0
        if self.merge_channels:
            return Frame.of(torch.from_numpy(values), pts=pts, duration=dur)
        return Frame.of(*[torch.tensor([v], dtype=torch.float32) for v in values],
                        pts=pts, duration=dur)

    def _read_scan_frame(self) -> Optional[bytes]:
        """One fixed-size binary frame from the char device, honoring
        ``poll_timeout`` (reference ``:384-385``).  None = timeout/EOF."""
        assert self._data_fd is not None
        buf = b""
        deadline = time.monotonic() + self.poll_timeout / 1000.0
        while len(buf) < self._frame_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self.stopped:
                return None
            r, _, _ = select.select([self._data_fd], [], [], min(remaining, 0.1))
            if not r:
                continue
            chunk = os.read(self._data_fd, self._frame_size - len(buf))
            if not chunk:
                if self._data_is_fifo:
                    # a FIFO reads 0 both at real EOF and BEFORE any writer
                    # has opened it (O_NONBLOCK open) — keep waiting until
                    # data arrives or poll_timeout expires
                    time.sleep(0.005)
                    continue
                return None  # regular file exhausted: end of stream
            buf += chunk
        return buf

    def frames(self) -> Iterable[Frame]:
        period = 1.0 / self.frequency if self.frequency > 0 else 0.0
        dur = int(period * SECOND) if period else 0
        idx = 0
        if self.mode == "continuous":
            while self.num_buffers < 0 or idx < self.num_buffers:
                if self.stopped:
                    return
                raw = self._read_scan_frame()
                if raw is None:
                    return
                values = np.array(
                    [c.decode(raw) for c in self._scan], dtype=np.float32
                )
                yield self._emit_frame(values, idx, dur)
                idx += 1
            return
        while self.num_buffers < 0 or idx < self.num_buffers:
            if self.stopped:
                return
            t0 = time.monotonic()
            values = np.array(
                [c.read() for c in self._channels], dtype=np.float32
            )
            yield self._emit_frame(values, idx, dur)
            idx += 1
            if period:
                left = period - (time.monotonic() - t0)
                if left > 0:
                    time.sleep(left)
