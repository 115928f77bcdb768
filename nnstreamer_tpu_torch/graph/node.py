"""Graph nodes and pads: the dataflow skeleton.

The port's copy of the JAX package's ``graph/node.py``: pads link nodes,
negotiation is an explicit pass over the graph (``graph/pipeline.py``), a
pad push runs the downstream chain synchronously in the pusher's thread, and
events (EOS, caps) travel in band with frames.  Each source runs in its own
thread.  Elements with request pads (mux and merge on the sink side,
demux, split and tee on the src side) make a pad when a link names one
they lack, or names none once every pad is linked (``sink_N``, ``src_N``).

A frame's tensor may still be arriving: ``tensor_upload`` copies on a side
stream and marks the tensor with the copy's event.  :meth:`Node._dispatch`
makes the current stream wait for it before ``process`` runs, so every
consumer (a filter, a transform, a decoder, a sink and its callbacks, an
aggregator) reads the frame after its copy, each with one wait per tensor.
A ``queue`` only enqueues the frame and overrides ``_dispatch``: it does not
wait, so the copy of one frame never holds up the work queued on the stream
for the one before.

Tracer hook points (``obs/hooks.py``) bracket each dispatch
(``dispatch_enter``/``dispatch_exit``, the wait for the upload's copy
included) and mark each pad push (``pad_push``); with no tracer attached
each site costs one flag test and the clock is never read.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, Optional, Tuple, Union

from ..buffer import Event, Frame
from ..obs import hooks as _hooks
from ..pool import wait_ready
from ..spec import ANY, TensorsSpec, numpy_dtype


class NegotiationError(Exception):
    """Pad specs cannot be reconciled (``GST_FLOW_NOT_NEGOTIATED``)."""


def _frame_sig(tensors) -> tuple:
    """(dtype, shape) signature of a frame's payloads."""
    return tuple((numpy_dtype(t.dtype), tuple(t.shape)) for t in tensors)


# Pads whose negotiated spec is not fully fixed skip the per-frame check.
_UNCHECKED = object()


class Pad:
    """One endpoint of a link; direction is "sink" (input) or "src"."""

    __slots__ = ("node", "name", "direction", "peer", "spec", "eos", "sig")

    def __init__(self, node: "Node", name: str, direction: str):
        self.node = node
        self.name = name
        self.direction = direction
        self.peer: Optional[Pad] = None
        self.spec: Optional[TensorsSpec] = None
        self.eos = False
        self.sig = None

    @property
    def full_name(self) -> str:
        return f"{self.node.name}.{self.name}"

    def link(self, other: "Pad") -> None:
        if self.direction != "src" or other.direction != "sink":
            raise ValueError(f"can only link src→sink, got {self.full_name}→{other.full_name}")
        if self.peer is not None or other.peer is not None:
            raise ValueError(f"pad already linked: {self.full_name} or {other.full_name}")
        self.peer = other
        other.peer = self

    def push(self, item: Union[Frame, Event]) -> None:
        """Push a frame or event downstream, synchronously.

        A frame whose (dtype, shape) differs from the negotiated spec sends
        a caps event downstream first, so the change renegotiates
        explicitly."""
        if self.direction != "src":
            raise ValueError("push() is only valid on src pads")
        if self.peer is None:
            return
        if isinstance(item, Frame) and self.sig is not _UNCHECKED:
            sig = _frame_sig(item.tensors)
            if sig != self.sig:
                self._spec_changed(sig, item)
        if _hooks.enabled:
            _hooks.emit("pad_push", self, item)
        self.peer.node._dispatch(self.peer, item)

    def _spec_changed(self, sig: tuple, frame: Frame) -> None:
        if self.sig is None:
            if self.spec is not None and self.spec.tensors_fixed:
                expected = tuple((t.dtype, tuple(t.shape)) for t in self.spec.tensors)
                if sig == expected:
                    self.sig = sig
                    return
            else:
                self.sig = _UNCHECKED
                return
        new_spec = TensorsSpec.from_arrays(
            frame.tensors, rate=self.spec.rate if self.spec else None
        )
        self.spec = new_spec
        self.sig = sig
        self.peer.node._dispatch(self.peer, Event.caps(new_spec))

    def __repr__(self) -> str:
        return f"Pad({self.full_name}, {self.direction})"


# process() returns nothing, one frame, a list of frames, or
# (pad_name, frame) pairs for nodes with several src pads.
ProcessResult = Union[None, Frame, Iterable[Union[Frame, Tuple[str, Frame]]]]


class Node:
    """Base class of all elements.

    Subclasses override some of :meth:`sink_spec` (pad template),
    :meth:`configure` (commit: fixed input specs in, fixed output specs
    out), :meth:`process` (per frame), :meth:`start` and :meth:`stop`.
    """

    # Set by elements that make sink pads on demand (mux, merge) and src
    # pads on demand (demux, split, tee): a link to a pad name they lack,
    # or to no name once every pad is linked, adds the pad.
    REQUEST_SINK_PADS = False
    REQUEST_SRC_PADS = False
    # Set by elements that block on the outside world (repo slots): the
    # JAX package's dispatcher lanes move such a node off a lane; the port
    # reads it once its lanes are ported.
    LANE_BLOCKING = False

    _AUTO_IDS = itertools.count()

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{type(self).__name__.lower()}{next(Node._AUTO_IDS)}"
        self.sink_pads: Dict[str, Pad] = {}
        self.src_pads: Dict[str, Pad] = {}
        self.pipeline = None
        self._lock = threading.Lock()
        self._started = False

    def add_sink_pad(self, name: str = "sink") -> Pad:
        if name in self.sink_pads:
            raise ValueError(f"duplicate sink pad {name} on {self.name}")
        pad = Pad(self, name, "sink")
        self.sink_pads[name] = pad
        return pad

    def add_src_pad(self, name: str = "src") -> Pad:
        if name in self.src_pads:
            raise ValueError(f"duplicate src pad {name} on {self.name}")
        pad = Pad(self, name, "src")
        self.src_pads[name] = pad
        return pad

    def _get_pad(self, pads: Dict[str, Pad], request: bool, kind: str,
                 name: Optional[str]) -> Pad:
        if name is None:
            for pad in pads.values():  # the first unlinked pad
                if pad.peer is None:
                    return pad
            if request:
                name = f"{kind}_{len(pads)}"
            elif not pads:
                raise ValueError(f"{self.name} has no {kind} pads")
            else:
                raise ValueError(f"{self.name}: all {kind} pads linked")
        if name in pads:
            return pads[name]
        if request:
            adder = self.add_sink_pad if kind == "sink" else self.add_src_pad
            return adder(name)
        raise ValueError(f"{self.name} has no {kind} pad {name!r}")

    def get_sink_pad(self, name: Optional[str] = None) -> Pad:
        """The pad of that name, the first unlinked one, or a new request
        pad where the element makes them."""
        return self._get_pad(self.sink_pads, self.REQUEST_SINK_PADS, "sink", name)

    def get_src_pad(self, name: Optional[str] = None) -> Pad:
        return self._get_pad(self.src_pads, self.REQUEST_SRC_PADS, "src", name)

    # -- negotiation --------------------------------------------------------

    def sink_spec(self, pad_name: str) -> TensorsSpec:
        """Partial spec accepted on a sink pad (template caps)."""
        del pad_name
        return ANY

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        """Commit fixed input specs; return fixed specs per src pad.
        Default: the first input spec to every src pad."""
        spec = next(iter(in_specs.values())) if in_specs else ANY
        return {name: spec for name in self.src_pads}

    def reconfigure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        """Mid-stream renegotiation; the same commit phase by default."""
        return self.configure(in_specs)

    def warmup_plan(self):
        """Work for the warmup phase (``graph/warmup.py``): ``(label,
        thunk)`` pairs, each thunk capturing one geometry this node will
        bring downstream at run time.  Called after negotiation, before
        PLAYING.  Default: nothing (negotiation captured the negotiated
        geometry); ``tensor_dynbatch`` plans its bucket ladder."""
        return []

    # -- dataflow -----------------------------------------------------------

    def _dispatch(self, pad: Pad, item: Union[Frame, Event]) -> None:
        """Items arriving on a sink pad; serialized per element.  A frame's
        tensors are waited for (their upload's copy) before ``process``."""
        if _hooks.enabled:
            t0 = time.perf_counter_ns()
            _hooks.emit("dispatch_enter", self, pad, item, t0)
            try:
                with self._lock:
                    self._dispatch_locked(pad, item)
            finally:
                _hooks.emit("dispatch_exit", self, pad, item, time.perf_counter_ns() - t0)
            return
        with self._lock:
            self._dispatch_locked(pad, item)

    def _dispatch_locked(self, pad: Pad, item: Union[Frame, Event]) -> None:
        if isinstance(item, Event):
            self._handle_event(pad, item)
        else:
            for t in item.tensors:
                wait_ready(t)
            self._emit(self.process(pad, item))

    def _emit(self, result: ProcessResult) -> None:
        if result is None:
            return
        if isinstance(result, Frame):
            self.push(result)
            return
        for item in result:
            if isinstance(item, tuple):
                pad_name, frame = item
                self.push(frame, pad_name)
            else:
                self.push(item)

    def _handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind == "eos":
            pad.eos = True
            if all(p.eos for p in self.sink_pads.values()):
                self._on_eos()
        elif event.kind == "caps":
            self._handle_caps(pad, event.payload)
        else:
            self.on_event(pad, event)

    def on_event(self, pad: Pad, event: Event) -> None:
        """Events other than EOS and caps: forwarded downstream."""
        del pad
        for spad in self.src_pads.values():
            spad.push(event)

    def _handle_caps(self, pad: Pad, new_spec: TensorsSpec) -> None:
        """Re-run negotiation from this node down for a mid-stream change;
        an incompatible change raises."""
        for spad, event in self._recompute_caps(pad, new_spec):
            spad.peer.node._dispatch(spad.peer, event)

    def _recompute_caps(self, pad: Pad, new_spec: TensorsSpec):
        """Commit a mid-stream spec change here; the caps events to send
        on, as (src pad, event), which the caller pushes (a collecting node
        defers them to its turn)."""
        template = self.sink_spec(pad.name)
        merged = template.intersect(new_spec)
        if merged is None:
            raise NegotiationError(
                f"{pad.full_name}: mid-stream spec change to {new_spec} "
                f"rejected (template {template})"
            )
        pad.spec = merged
        pad.sig = None
        in_specs = {
            p.name: p.spec
            for p in self.sink_pads.values()
            if p.peer is not None and p.spec is not None
        }
        out_specs = self.reconfigure(in_specs)
        events = []
        for name, spad in self.src_pads.items():
            spec = out_specs.get(name)
            if spad.peer is None or spec is None or spec == spad.spec:
                continue
            spad.spec = spec
            spad.sig = None
            events.append((spad, Event.caps(spec)))
        return events

    def _on_eos(self) -> None:
        """Every sink pad reached EOS: drain and forward."""
        self._emit(self.drain())
        for spad in self.src_pads.values():
            spad.push(Event.eos())
        if self.pipeline is not None:
            self.pipeline._node_eos(self)

    def process(self, pad: Pad, frame: Frame) -> ProcessResult:
        """Per-frame work.  Default: passthrough."""
        del pad
        return frame

    def drain(self) -> ProcessResult:
        """Flush internal state at EOS."""
        return None

    def push(self, frame: Frame, pad_name: Optional[str] = None) -> None:
        if pad_name is None:
            if len(self.src_pads) != 1:
                raise ValueError(f"{self.name}: pad_name required with multiple src pads")
            pad = next(iter(self.src_pads.values()))
        else:
            pad = self.src_pads[pad_name]
        pad.push(frame)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Acquire resources; called before negotiation."""
        self._started = True

    def stop(self) -> None:
        self._started = False

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class SourceNode(Node):
    """Push source: the pipeline runs :meth:`frames` in its own thread and
    pushes each frame, then EOS."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_src_pad("src")
        self._stop_evt = threading.Event()

    def frames(self) -> Iterable[Frame]:
        raise NotImplementedError

    @property
    def stopped(self) -> bool:
        return self._stop_evt.is_set()

    def request_stop(self) -> None:
        self._stop_evt.set()

    def output_spec(self) -> TensorsSpec:
        """Fixed spec of the frames this source produces."""
        raise NotImplementedError

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        del in_specs
        return {"src": self.output_spec()}


class SinkTerminal(Node):
    """Base of sinks (no src pads)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")
