"""``tensor_repo`` with ``tensor_reposink`` and ``tensor_reposrc``: recurrence.

The port of the JAX package's ``elements/repo.py``, the feedback path of a
cyclic (LSTM, RNN) topology that a dataflow graph otherwise forbids:

- a process-global repository of slots, each a one-frame mailbox with a
  lock and a condition;
- ``tensor_reposink slot-index=N`` publishes every frame into slot N,
  waiting while the slot still holds one;
- ``tensor_reposrc slot-index=N caps=...`` is a source that first emits a
  zero frame of its ``caps`` (the cycle's bootstrap) on its ``device``,
  then waits on the slot for each next frame;
- a slot holds its frame's spec beside it, checked on the src side;
- slot indices change at run time (:meth:`TensorRepoSink.set_slot`).

A slot holds the frame's tensors as they are: on the card, the filter's
outputs stay there around the cycle, and nothing is copied to the host.
The filter hands out fresh output tensors each frame (not the tensors its
CUDA graph writes), so a slot never holds a tensor that the next replay
overwrites.  Every thread here issues its work on the device's default
stream, so a frame the filter wrote is read after it in stream order.

``[fleet] repo_addr`` (a repo served by another process) is not ported:
:func:`configured_repo` refuses it rather than fall back to the local repo.
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..buffer import Frame
from ..device import resolve_device
from ..graph.node import Pad, SinkTerminal, SourceNode
from ..graph.registry import register_element
from ..spec import TensorsSpec, torch_dtype


class _Slot:
    __slots__ = ("cond", "frame", "spec", "eos", "restored")

    def __init__(self):
        self.cond = threading.Condition()
        self.frame: Optional[Frame] = None
        self.spec: Optional[TensorsSpec] = None
        self.eos = False
        # set by a checkpoint restore: the next start keeps the slot's frame
        # and the src skips its zero bootstrap
        self.restored = False


class TensorRepo:
    """The slot registry.  Each slot is a lossless one-frame handoff:
    :meth:`set_buffer` waits while a frame is pending and :meth:`get_buffer`
    waits until one arrives, so a cycle flows frame for frame."""

    def __init__(self):
        self._slots: Dict[int, _Slot] = {}
        self._lock = threading.Lock()

    def slot(self, idx: int) -> _Slot:
        with self._lock:
            if idx not in self._slots:
                self._slots[idx] = _Slot()
            return self._slots[idx]

    def set_buffer(self, idx: int, frame: Frame, spec: Optional[TensorsSpec],
                   poll: float = 0.1, should_abort=None) -> bool:
        """Publish one frame, once the previous one was taken; False if the
        slot reached EOS (or ``should_abort()``) instead."""
        s = self.slot(idx)
        with s.cond:
            while s.frame is not None and not s.eos:
                s.cond.wait(poll)
                if should_abort is not None and should_abort():
                    return False
            if s.eos:
                return False
            s.frame = frame
            s.spec = spec
            s.cond.notify_all()
            return True

    def get_buffer(self, idx: int, timeout: Optional[float] = None
                   ) -> Tuple[Optional[Frame], Optional[TensorsSpec], bool]:
        """Take the pending frame, waiting for one: (frame, spec, eos);
        (None, None, eos) when ``timeout`` passes first."""
        s = self.slot(idx)
        with s.cond:
            while s.frame is None and not s.eos:
                if not s.cond.wait(timeout if timeout is not None else 0.1):
                    if timeout is not None:
                        return None, None, s.eos
            if s.frame is None and s.eos:
                return None, None, True
            frame, spec = s.frame, s.spec
            s.frame = None
            s.cond.notify_all()
            return frame, spec, False

    def set_eos(self, idx: int) -> None:
        s = self.slot(idx)
        with s.cond:
            s.eos = True
            s.cond.notify_all()

    def prepare(self, idx: int) -> None:
        """The sink's start: a fresh slot (a restored frame kept), no EOS."""
        s = self.slot(idx)
        with s.cond:
            if not s.restored:
                s.frame = None
                s.spec = None
            s.eos = False
            s.cond.notify_all()

    def reopen(self, idx: int) -> None:
        """The src's start: clear an EOS left by an earlier run's interrupt,
        keep a pending frame (a producer may have published already)."""
        s = self.slot(idx)
        with s.cond:
            s.eos = False
            s.cond.notify_all()

    def take_restored(self, idx: int) -> bool:
        """Read and clear the restored flag: the src skips its bootstrap
        once a restore."""
        s = self.slot(idx)
        with s.cond:
            was = s.restored
            s.restored = False
            return was

    def clear(self, idx: int) -> None:
        """Empty a slot for a fresh run."""
        s = self.slot(idx)
        with s.cond:
            s.frame = None
            s.spec = None
            s.eos = False
            s.restored = False
            s.cond.notify_all()

    def reset(self, idx: Optional[int] = None) -> None:
        with self._lock:
            if idx is None:
                self._slots.clear()
            else:
                self._slots.pop(idx, None)


GLOBAL_REPO = TensorRepo()


def configured_repo() -> TensorRepo:
    """The repo of elements made without ``repo=``: the process-global one.
    A non-empty ``[fleet] repo_addr`` (``NNSTPU_FLEET_REPO_ADDR``) names a
    repo served by another process, which the port cannot reach yet: that
    raises, so that a cycle meant to span processes never runs on a local
    repo by mistake."""
    from ..conf import conf

    addr = (conf.get("fleet", "repo_addr", "") or "").strip()
    if addr:
        raise NotImplementedError(
            f"[fleet] repo_addr={addr!r}: a remote tensor repo is not ported; "
            "unset it to use the process-global repo")
    return GLOBAL_REPO


@register_element("tensor_reposink")
class TensorRepoSink(SinkTerminal):
    LANE_BLOCKING = True  # a full slot waits until the consumer takes it

    def __init__(self, name: Optional[str] = None, slot_index: int = 0,
                 signal_rate: int = 0, repo: Optional[TensorRepo] = None):
        super().__init__(name)
        del signal_rate  # taken for launch-string parity
        self.slot_index = int(slot_index)
        self.repo = repo or configured_repo()
        self._spec: Optional[TensorsSpec] = None
        self.dropped = 0
        # the frame this run published last: a cycle's state once its
        # stream ended (``utils/checkpoint.py::checkpoint_pipeline``)
        self.last_published: Optional[Frame] = None

    def set_slot(self, idx: int) -> None:
        self.slot_index = int(idx)

    def configure(self, in_specs):
        self._spec = in_specs["sink"]
        return {}

    def start(self) -> None:
        super().start()
        self.repo.prepare(self.slot_index)
        self.dropped = 0
        self.last_published = None

    def process(self, pad: Pad, frame: Frame):
        del pad
        ok = self.repo.set_buffer(
            self.slot_index, frame, self._spec,
            should_abort=lambda: self.pipeline is not None and self.pipeline.state == "STOPPED")
        if ok:
            self.last_published = frame
        else:  # the consumer ended (slot at EOS), or the pipeline stopped
            self.dropped += 1
            if self.dropped == 1:
                warnings.warn(f"{self.name}: repo slot {self.slot_index} is at EOS; "
                              "dropping published frames", RuntimeWarning, stacklevel=2)
        return None

    def drain(self):
        self.repo.set_eos(self.slot_index)
        return None

    def interrupt(self) -> None:
        self.repo.set_eos(self.slot_index)


@register_element("tensor_reposrc")
class TensorRepoSrc(SourceNode):
    LANE_BLOCKING = True  # waits on its slot

    def __init__(self, name: Optional[str] = None, slot_index: int = 0, caps: str = "",
                 repo: Optional[TensorRepo] = None, device="cuda"):
        super().__init__(name)
        self.slot_index = int(slot_index)
        self.repo = repo or configured_repo()
        self.device = resolve_device(device)
        if isinstance(caps, TensorsSpec):
            self._spec = caps
        elif caps:
            self._spec = TensorsSpec.from_caps_string(caps)
        else:
            raise ValueError("tensor_reposrc requires caps= (cycle bootstrap spec)")

    def set_slot(self, idx: int) -> None:
        self.slot_index = int(idx)

    def start(self) -> None:
        super().start()
        self.repo.reopen(self.slot_index)

    def output_spec(self) -> TensorsSpec:
        return self._spec.fixate() if not self._spec.is_fixed else self._spec

    def _dummy_frame(self) -> Frame:
        """The bootstrap: zeros of the caps, on the element's device, where
        the filter's capture expects the state."""
        tensors = tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=self.device)
                        for t in self.output_spec().tensors)
        return Frame(tensors=tensors, pts=0, duration=0)

    def frames(self) -> Iterable[Frame]:
        # a restored slot's frame takes the bootstrap's place: a resumed run
        # must not see a zero frame the uninterrupted one never saw
        if not self.repo.take_restored(self.slot_index):
            yield self._dummy_frame()
        my_spec = self.output_spec()
        while not self.stopped:
            frame, spec, eos = self.repo.get_buffer(self.slot_index, timeout=0.1)
            if eos:
                return
            if frame is None:
                continue  # the poll timed out: check the stop flag
            if spec is not None and my_spec.intersect(spec) is None:
                raise ValueError(f"{self.name}: repo slot {self.slot_index} spec {spec} "
                                 f"incompatible with caps {my_spec}")
            yield frame

    def interrupt(self) -> None:
        self.request_stop()
        self.repo.set_eos(self.slot_index)
