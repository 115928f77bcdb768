"""``tensor_rate``: adapt a tensor stream to a target frame rate.

The port of the JAX package's ``elements/rate.py`` (upstream's
``tensor_rate``, itself modeled on ``videorate``), driven by pts, with no
wall clock:

- the output timeline is slotted at ``period = D/N`` seconds for
  ``framerate=N/D``; slot k's pts is ``k * period``, and a frame belongs to
  the slot nearest its pts;
- each incoming frame claims every unclaimed slot up to its own: the
  earlier ones are filled with the previous frame (duplication), as
  ``videorate`` does, and the frame goes out in its own slot at once;
- a frame whose slot is already claimed is dropped (it is still the
  frame a later gap duplicates);
- at EOS the slots whose centers fall before the input's end (last pts +
  duration) are filled with the last frame;
- ``throttle=false`` only restamps: nothing is dropped or duplicated.

Counters ``in_frames``, ``out_frames``, ``dup``, ``drop``; each drop and
duplicate also fires the ``rate_drop`` / ``rate_dup`` hook.  A duplicated
frame hands on the same tensors (a card tensor is not copied).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional

from ..buffer import Frame, is_valid_ts
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..obs import hooks as _hooks
from ..spec import TensorsSpec
from ..utils.props import parse_bool

_SECOND_NS = 1_000_000_000


@register_element("tensor_rate")
class TensorRate(Node):
    def __init__(self, name: Optional[str] = None, framerate: str = "30/1",
                 throttle: bool = True):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        try:
            if "/" in str(framerate):
                num, den = str(framerate).split("/", 1)
                self.rate = Fraction(int(num), int(den))
            else:
                self.rate = Fraction(framerate)
        except (ValueError, ZeroDivisionError) as exc:
            raise ValueError(f"bad framerate {framerate!r}: {exc}") from None
        if self.rate <= 0:
            raise ValueError(f"framerate must be positive, got {framerate!r}")
        self.throttle = parse_bool(throttle, name="throttle")
        self._period_ns = int(_SECOND_NS * self.rate.denominator / self.rate.numerator)
        self._next_slot = 0                    # the first unclaimed output slot
        self._pending: Optional[Frame] = None  # the previous frame (duplication)
        self._end_ns: Optional[int] = None     # the input's media end (pts + duration)
        self.in_frames = 0
        self.out_frames = 0
        self.dup = 0
        self.drop = 0

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        return {"src": TensorsSpec(tensors=in_specs["sink"].tensors, rate=self.rate)}

    def _slot_of(self, pts: int) -> int:
        return max(0, (pts + self._period_ns // 2) // self._period_ns)

    def _emit_slot(self, frame: Frame, slot: int, duplicated: bool) -> None:
        self.out_frames += 1
        if duplicated:
            self.dup += 1
            if _hooks.enabled:
                _hooks.emit("rate_dup", self)
        self.src_pads["src"].push(frame.with_tensors(frame.tensors, pts=slot * self._period_ns,
                                                     duration=self._period_ns))

    def process(self, pad: Pad, frame: Frame):
        del pad
        self.in_frames += 1
        if not self.throttle:
            self._emit_slot(frame, self._next_slot, duplicated=False)
            self._next_slot += 1
            return None
        pts = frame.pts if is_valid_ts(frame.pts) else self._next_slot * self._period_ns
        if is_valid_ts(frame.duration):
            self._end_ns = pts + frame.duration
        slot = self._slot_of(pts)
        if slot < self._next_slot:
            self.drop += 1
            if _hooks.enabled:
                _hooks.emit("rate_drop", self)
            self._pending = frame
            return None
        while self._pending is not None and self._next_slot < slot:
            self._emit_slot(self._pending, self._next_slot, duplicated=True)
            self._next_slot += 1
        self._emit_slot(frame, slot, duplicated=False)
        self._next_slot = slot + 1
        self._pending = frame
        return None

    def drain(self):
        """EOS: duplicate the last frame into every slot whose center lies
        before the input's end, as a continuing input would have claimed
        them (a pure down-sample gains no duplicate)."""
        if not self.throttle or self._pending is None or self._end_ns is None:
            return None
        period = self._period_ns
        while self._next_slot * period + period // 2 < self._end_ns:
            self._emit_slot(self._pending, self._next_slot, duplicated=True)
            self._next_slot += 1
        return None
