"""N-way fan-in with time synchronization, shared by mux and merge.

The port of the JAX package's ``elements/collect.py``.  Three policies:

- ``nosync``  — take whatever is at each pad's head.
- ``slowest`` — the sync point is the most lagging pad's head timestamp;
  each pad gives its frame closest to that point (older ones dropped).
- ``basepad`` — follow pad K's timestamps within a tolerance;
  ``sync_option="K:duration_ns"``.

Pads are ordered ``sink_0 < sink_1 < sink_10`` (``(len(n), n)``).  A round
fires whenever every linked pad that is not at EOS holds a frame; a pad at
EOS with nothing queued ends the stream.  Queues and rounds are kept under
the node's lock, but the downstream push runs outside it, in the order the
rounds were taken (tickets), so the upstream threads are never held up by
the chain below.

Several threads push into one collect node.  Each frame's tensors may
still be arriving from an upload's copy (``graph/node.py``): before a
round is combined, the thread that emits it makes its stream wait for the
copy of every tensor of the round, whichever pad it came in on.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from ..buffer import NONE_TS, Event, Frame, is_valid_ts
from ..graph.node import Node, Pad
from ..pool import wait_ready


class CollectNode(Node):
    """Base of mux and merge: collects one frame a linked sink pad, time
    synchronized, then calls :meth:`combine`."""

    REQUEST_SINK_PADS = True

    def __init__(self, name: Optional[str] = None, sync_mode: str = "slowest",
                 sync_option: str = ""):
        super().__init__(name)
        self.add_src_pad("src")
        self.sync_mode = str(sync_mode)
        if self.sync_mode not in ("nosync", "slowest", "basepad"):
            raise ValueError(f"unknown sync-mode {self.sync_mode!r}")
        self.sync_option = str(sync_option)
        self._base_pad_idx = 0
        self._base_tolerance = NONE_TS
        if self.sync_mode == "basepad" and self.sync_option:
            parts = self.sync_option.split(":")
            self._base_pad_idx = int(parts[0])
            if len(parts) > 1:
                self._base_tolerance = int(parts[1])
        self._queues: Dict[str, collections.deque] = {}
        # each pad's last contributed or dropped frame: basepad gives it
        # again while the pad's head lies outside the tolerance
        self._last: Dict[str, Frame] = {}
        self._finished = False
        self._emit_cv = threading.Condition()
        self._ticket = 0
        self._emit_next = 0

    # -- collection ---------------------------------------------------------

    def _pad_order(self) -> List[str]:
        return sorted(self._queues, key=lambda n: (len(n), n))

    def _linked_sinks(self) -> List[Pad]:
        return [p for p in self.sink_pads.values() if p.peer is not None]

    def _dispatch(self, pad: Pad, item) -> None:
        """Bookkeeping under the lock; emission outside it, in ticket order.
        An arrival that completes no round returns at once.  A caps or other
        event waits for its turn, so that no frame of an earlier round is
        still being pushed with the old spec."""
        outs: List = []
        caps_item = None
        finish = False
        with self._lock:
            if isinstance(item, Event):
                if item.kind == "eos":
                    pad.eos = True
                    # an EOS pad may let a waiting round go before the end
                    if not self._finished:
                        outs, finish = self._collect_rounds()
                    if not finish and not self._finished and \
                            all(p.eos for p in self._linked_sinks()):
                        finish = True
                    if finish:
                        self._finished = True
                else:
                    caps_item = item
            else:
                if self._finished:
                    return  # the stream already ended (a pad ran dry)
                self._queues.setdefault(pad.name, collections.deque()).append(item)
                outs, finish = self._collect_rounds()
                if finish:
                    self._finished = True
            if not outs and not finish and caps_item is None:
                return
            ticket = self._ticket
            self._ticket += 1
        with self._emit_cv:
            while self._emit_next != ticket:
                self._emit_cv.wait()
        try:
            if caps_item is not None:
                if caps_item.kind == "caps":
                    # the commit phase again with every pad's spec, so that
                    # downstream sees the new combined spec
                    with self._lock:
                        caps_events = self._recompute_caps(pad, caps_item.payload)
                    for spad, event in caps_events:
                        spad.peer.node._dispatch(spad.peer, event)
                else:
                    self.on_event(pad, caps_item)
            for frames in outs:
                for f in frames.values():
                    for t in f.tensors:
                        wait_ready(t)
                out = self.combine(frames)
                if out is not None:
                    self._emit(out)
            if finish:
                for spad in self.src_pads.values():
                    spad.push(Event.eos())
                if self.pipeline is not None:
                    self.pipeline._node_eos(self)
        finally:
            with self._emit_cv:
                self._emit_next += 1
                self._emit_cv.notify_all()

    def _ready(self) -> bool:
        return all(self._queues.get(pad.name) for pad in self._linked_sinks())

    def _exhausted(self) -> bool:
        """A pad at EOS with an empty queue can complete no other round."""
        return any(pad.eos and not self._queues.get(pad.name) for pad in self._linked_sinks())

    def _active_queues(self) -> List[Tuple[str, collections.deque]]:
        return [(name, self._queues[name]) for name in self._pad_order() if self._queues[name]]

    def _sync_point(self, active) -> int:
        if self.sync_mode == "basepad":
            order = self._pad_order()
            if self._base_pad_idx < len(order):
                q = self._queues.get(order[self._base_pad_idx])
                if q:
                    return q[0].pts
            return NONE_TS
        # slowest: the latest head timestamp, which the laggards must reach
        ts = NONE_TS
        for _, q in active:
            if is_valid_ts(q[0].pts):
                ts = max(ts, q[0].pts)
        return ts

    def _collect_rounds(self) -> Tuple[List, bool]:
        """Take rounds while complete sets remain: (the pad → frame sets,
        whether the stream ended).  Combines and emits nothing itself."""
        outs: List = []
        while True:
            if self._exhausted():
                return outs, True
            if not self._ready():
                return outs, False
            active = self._active_queues()
            if not active:
                return outs, False
            if self.sync_mode == "nosync":
                chosen = [(name, q.popleft()) for name, q in active]
            else:
                base_ts = self._sync_point(active)
                if base_ts == NONE_TS:
                    chosen = [(name, q.popleft()) for name, q in active]
                elif self.sync_mode == "basepad":
                    result = self._collect_basepad(active, base_ts)
                    if result is None:
                        return outs, False  # a pad needs newer data
                    if result == "retry":
                        continue  # a stale head was dropped
                    chosen = result
                else:
                    chosen = []
                    need_buffer = False
                    for name, q in active:
                        pad = self.sink_pads[name]
                        while len(q) >= 2 and self._closer(q[1].pts, q[0].pts, base_ts):
                            q.popleft()
                        head = q[0]
                        if len(q) == 1 and not pad.eos and is_valid_ts(head.pts) \
                                and self._ends_before(head, base_ts):
                            need_buffer = True  # a laggard: wait for newer data
                            break
                        chosen.append((name, head))
                    if need_buffer:
                        return outs, False
                    for name, _ in chosen:
                        self._queues[name].popleft()
            if not chosen:
                return outs, False
            outs.append(dict(chosen))

    def _collect_basepad(self, active, base_ts: int):
        """One basepad round: a head before the sync point is stale (kept
        as the pad's last, then retry or wait); a head outside the
        tolerance gives the pad's last frame instead and stays queued; the
        tolerance is the smaller of the option's and the base pad's own
        frame gap less one.  The chosen list, ``"retry"`` or None (wait)."""
        order = self._pad_order()
        base_name = order[self._base_pad_idx] if self._base_pad_idx < len(order) else None
        tol: Optional[int] = self._base_tolerance if self._base_tolerance != NONE_TS else None
        last_base = self._last.get(base_name) if base_name else None
        if last_base is not None:
            bq = self._queues.get(base_name)
            if bq and is_valid_ts(bq[0].pts) and is_valid_ts(last_base.pts):
                gap = abs(bq[0].pts - last_base.pts) - 1
                tol = gap if tol is None else min(tol, gap)
        chosen = []
        for name, q in active:
            pad = self.sink_pads[name]
            head = q[0]
            if name != base_name and is_valid_ts(head.pts) and head.pts < base_ts:
                self._last[name] = q.popleft()
                if q or pad.eos:
                    return "retry"
                return None
            outside = tol is not None and is_valid_ts(head.pts) and abs(head.pts - base_ts) > tol
            if outside and name in self._last:
                chosen.append((name, self._last[name]))
            else:
                self._last[name] = q.popleft()
                chosen.append((name, self._last[name]))
        return chosen

    @staticmethod
    def _closer(candidate_ts: int, current_ts: int, base_ts: int) -> bool:
        if not is_valid_ts(candidate_ts):
            return False
        if not is_valid_ts(current_ts):
            return True
        return abs(candidate_ts - base_ts) <= abs(current_ts - base_ts)

    @staticmethod
    def _ends_before(frame: Frame, ts: int) -> bool:
        end = frame.end_ts
        return (end if is_valid_ts(end) else frame.pts) < ts

    def start(self) -> None:
        super().start()
        self._finished = False
        self._queues.clear()
        self._last.clear()
        with self._emit_cv:
            self._ticket = 0
            self._emit_next = 0

    # -- subclasses ----------------------------------------------------------

    def combine(self, frames: Dict[str, Frame]):
        """One synchronized set (pad name → frame) made into output frames."""
        raise NotImplementedError

    @staticmethod
    def output_timing(frames: Dict[str, Frame]) -> Tuple[int, int]:
        """The output's pts and duration: the smallest valid of each."""
        pts = min((f.pts for f in frames.values() if is_valid_ts(f.pts)), default=NONE_TS)
        dur = min((f.duration for f in frames.values() if is_valid_ts(f.duration)),
                  default=NONE_TS)
        return pts, dur
