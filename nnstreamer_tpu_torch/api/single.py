"""Single-shot inference: ``ml_single_*`` parity.

The port of the JAX package's ``api/single.py``, the reference's
minimal-latency path (``nnstreamer-capi-single-new.c``): drive a filter
backend directly, with no pipeline, pads or element threads.
:class:`SingleShot` is the ``ml_single_open / ml_single_invoke /
ml_single_close`` triple (and a context manager), with the invoke timeout
(``ml_single_set_timeout``, ``-single-new.c:706``) and get/set of the I/O
specs.

``device`` (``"cuda"`` by default; it raises as
:func:`~..device.resolve_device` does when there is no GPU) is where the
invoke's inputs go: a host array or tensor is copied there once, as
``tensor_upload`` copies a frame in a pipeline, and the ``torch`` backend
is pinned to it (a model from a file loads there).  ``device="cpu"`` keeps
everything on the host.  Outputs are handed back where the backend made
them: a CUDA model's outputs stay on the card.

**The timeout and the card.**  With a timeout set, the invoke runs on a
worker thread, as in the JAX package, and the caller waits for it at most
that long.  Two things follow on the card:

- torch's current stream is per thread.  :class:`SingleShot` takes the
  opening thread's current stream when it opens and runs every invoke
  under it, whichever thread runs the invoke: the backend's CUDA graph
  (captured while opening, or at the first invoke) is replayed on the
  stream it was captured from.  The invoke first makes that stream wait
  for the caller's current stream (the inputs' copies), marks the inputs
  as used there, and makes the caller's stream wait for the outputs.
- A timed-out invoke goes on running.  Invokes are serialized by a lock,
  since a replay reuses the capture's static buffers, and :meth:`close`
  after an :class:`InvokeTimeout` does not free the backend (its graphs
  and their memory pool) under a replay in flight: it shuts the worker
  pool down without waiting (the JAX package's ``wait=False``) and the
  backend is closed when the invoke in flight has returned and its stream
  has drained.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..backends.base import FilterBackend, get_backend
from ..device import resolve_device
from ..spec import TensorsSpec


class InvokeTimeout(TimeoutError):
    pass


class SingleShot:
    """One-shot synchronous inference on a model.

    >>> with SingleShot(framework="torch", model=my_model) as s:
    ...     out, = s.invoke(image)
    """

    def __init__(self, framework: str = "", model=None, custom: str = "",
                 input_spec: Optional[TensorsSpec] = None, timeout: Optional[float] = None,
                 backend: Optional[FilterBackend] = None, device="cuda"):
        if backend is not None:
            self.backend = backend
        else:
            if not framework:
                raise ValueError("SingleShot requires framework= (or backend=)")
            self.backend = get_backend(framework)
        self.device = resolve_device(device)
        if hasattr(self.backend, "pinned_device") and self.backend.pinned_device is None:
            self.backend.pinned_device = self.device.type
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self.timeout = timeout
        self._opened = False
        self._configured = False
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._inflight: Optional[concurrent.futures.Future] = None
        self._lock = threading.Lock()
        self._invoke_lock = threading.Lock()  # one invoke (replay) at a time
        self.backend.open(model, custom)
        self._opened = True
        if input_spec is not None:
            self.set_input_spec(input_spec)
        elif (spec := self.backend.model_spec()) is not None and spec.tensors_fixed:
            self.set_input_spec(spec)

    # -- spec management (ml_single_get/set_input_info) ---------------------

    def input_spec(self) -> Optional[TensorsSpec]:
        # once configured, the negotiated spec: a backend whose own spec is
        # partial must not shadow the concrete one
        if self._in_spec is not None:
            return self._in_spec
        return self.backend.model_spec()

    def output_spec(self) -> Optional[TensorsSpec]:
        if self._out_spec is not None:
            return self._out_spec
        return self.backend.output_spec()

    def set_input_spec(self, spec: TensorsSpec) -> TensorsSpec:
        """Reconfigure for a new input spec; returns the output spec
        (``ml_single_set_input_info``).  On the card this captures the
        backend's graph for the spec, on the calling thread's stream."""
        with self._invoke_lock:
            out = self.backend.reconfigure(spec)
        self._configured = True
        # a shape-polymorphic backend has no spec of its own, yet
        # ml_single_get_input/output_info report the configured one
        self._in_spec = spec
        self._out_spec = out
        return out

    def set_timeout(self, seconds: Optional[float]) -> None:
        self.timeout = seconds

    # -- invoke -------------------------------------------------------------

    def _to_device(self, t) -> torch.Tensor:
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
        return t.to(self.device)

    def _invoke(self, xs: Tuple, caller) -> Tuple:
        with self._invoke_lock:
            if self._stream is None:
                return self.backend.invoke(xs)
            with torch.cuda.stream(self._stream):
                if caller != self._stream:
                    self._stream.wait_stream(caller)
                    for x in xs:
                        if x.is_cuda:
                            x.record_stream(self._stream)
                outs = self.backend.invoke(xs)
            if caller != self._stream:
                caller.wait_stream(self._stream)
            return outs

    def invoke(self, *tensors) -> Tuple:
        """Synchronous inference; raises :class:`InvokeTimeout` when a
        timeout is set and exceeded."""
        if not self._opened:
            raise RuntimeError("SingleShot is closed")
        xs = tuple(self._to_device(t) for t in tensors)
        if not self._configured:
            self.set_input_spec(TensorsSpec.from_arrays(xs))
        caller = torch.cuda.current_stream(self.device) if self._stream is not None else None
        if self.timeout is None:
            return self._invoke(xs, caller)
        with self._lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            future = self._pool.submit(self._invoke, xs, caller)
            self._inflight = future
        try:
            return future.result(timeout=self.timeout)
        except concurrent.futures.TimeoutError:
            raise InvokeTimeout(f"invoke exceeded {self.timeout}s") from None

    # -- lifecycle ----------------------------------------------------------

    def _release(self) -> None:
        """Close the backend once no invoke runs and its stream is drained."""
        with self._invoke_lock:
            if self._stream is not None:
                self._stream.synchronize()
            self.backend.close()

    def close(self) -> None:
        with self._lock:
            if not self._opened:
                return
            self._opened = False
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
            inflight, self._inflight = self._inflight, None
        if inflight is None:
            self._release()
        else:  # runs at once if the invoke has returned
            inflight.add_done_callback(lambda _f: self._release())

    def __enter__(self) -> "SingleShot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
