"""Batch-sharded dispatch: one call a shard, captured as one graph a shard.

The port's counterpart of the JAX backend's sharded executables
(``backends/jax_backend.py``: a batch-axis ``NamedSharding`` over the
dispatch mesh).  The torch backend (``backends/torch_backend.py``) cuts a
batch into ``n`` equal shards along its leading dim, one a device of the
mesh, runs the filter's function on each, and joins the outputs on the
mesh's first device.

A function may reduce over the whole batch (the int8 head's one activation
scale, ``ops/quant.py``): it calls :func:`~..parallel.mesh.reduce_over_batch`,
the collective XLA inserts for such a reduction.  :class:`ShardRun` runs
the shards in threads of their own, one at a time: each runs until it
reaches a collective or returns; when every shard has reached it, each in
turn takes the reduction of all shards' values and runs on.  The
collectives cut each shard's call into segments.

:func:`capture_sharded` captures each shard's segments as CUDA graphs
(one capture open at a time, ``capture_error_mode="thread_local"``), after
warm-up calls on side streams, as ``capture_calls`` does for one device;
:class:`ShardedCapture` replays segment ``k`` of every shard before segment
``k + 1`` of any.  On one card the shards share its stream, which orders
them; across cards an event of each card orders each segment after the
segments before it.  A function with no collective is one graph a shard.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..obs.launch_gate import launching
from ..parallel.mesh import all_reduce, move, set_current_shard

WARMUP_CALLS = 3


class _Aborted(Exception):
    """Another shard failed: this one stops where it waits."""


def _record(dev: torch.device):
    """An event on this thread's current stream of ``dev``, or None (the
    CPU, or a stream being captured: a graph's order is its replay's)."""
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _wait(dev: torch.device, ev) -> None:
    if ev is not None:
        torch.cuda.current_stream(dev).wait_event(ev)


class ShardRun:
    """``fns[i](*args[i])`` for every shard ``i``, each in a thread of its
    own, one running at a time, with the collectives between them.

    ``contexts(i)`` gives the context manager a shard's thread runs its
    call in (a stream, inference mode); ``begin(i, k)`` / ``end(i, k)`` run
    in that thread around the shard's ``k``-th segment (a capture).  On the
    card, events order the streams eagerly: a shard starts after the
    caller's work, a reduction reads each shard's value after it is made,
    and the caller's stream waits for every shard's end (not while
    capturing, where the replays' order does it)."""

    def __init__(self, fns: Sequence[Callable], args: Sequence[tuple],
                 devs: Sequence[torch.device], contexts: Optional[Callable] = None,
                 begin: Optional[Callable] = None, end: Optional[Callable] = None):
        self.n = len(fns)
        # a captured run takes no events: a graph may not wait on work
        # outside its capture, and the replays keep the segments' order
        self._ordered = begin is None
        self.fns, self.args, self.devs = list(fns), list(args), list(devs)
        self._contexts = contexts or (lambda i: contextlib.nullcontext())
        self._begin = begin or (lambda i, k: None)
        self._end = end or (lambda i, k: None)
        self.slots: List[list] = []  # each collective's values, by shard
        self._slot_events: List[list] = []
        self.outputs: list = [None] * self.n
        self._cv = threading.Condition()
        self._turn: Optional[int] = None
        self._state = ["ready"] * self.n  # ready, waiting (at a collective), done, error
        self._errors: list = [None] * self.n
        self._start: dict = {}  # per device: the caller's work before the call
        self._done: list = [None] * self.n
        self._aborted = False
        self._local = threading.local()
        # the caller's autograd modes, which a new thread does not inherit
        self._grad = torch.is_grad_enabled()
        self._inference = torch.is_inference_mode_enabled()

    @property
    def segments(self) -> int:
        return len(self.slots) + 1

    def _record(self, i: int):
        return _record(self.devs[i]) if self._ordered else None

    def _wait_turn(self, i: int) -> None:
        with self._cv:
            while self._turn != i and not self._aborted:
                self._cv.wait()
            if self._aborted:
                raise _Aborted()

    def _yield(self, i: int, state: str) -> None:
        with self._cv:
            self._state[i] = state
            self._turn = None
            self._cv.notify_all()

    def _shard(self, i: int) -> None:
        self._local.index, self._local.k = i, 0
        set_current_shard(self)
        try:
            self._wait_turn(i)
            with torch.inference_mode(self._inference), torch.set_grad_enabled(self._grad), \
                    self._contexts(i):
                _wait(self.devs[i], self._start.get(str(self.devs[i])))
                self._begin(i, 0)
                try:
                    out = self.fns[i](*self.args[i])
                finally:
                    if not self._aborted:
                        self._end(i, self._local.k)
                self._done[i] = self._record(i)
            self.outputs[i] = out
            self._yield(i, "done")
        except _Aborted:
            pass
        except BaseException as exc:  # noqa: BLE001 - handed to the caller's thread
            self._errors[i] = exc
            self._yield(i, "error")
        finally:
            set_current_shard(None)

    def collective(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """In shard ``i``'s thread: close its segment, hand ``t`` over, wait
        until every shard has; then open the next segment and return the
        reduction of every shard's value on this shard's device."""
        i, k = self._local.index, self._local.k
        self._end(i, k)
        with self._cv:
            if len(self.slots) <= k:
                self.slots.append([None] * self.n)
                self._slot_events.append([None] * self.n)
            self.slots[k][i] = t
            self._slot_events[k][i] = self._record(i)
        self._yield(i, "waiting")
        self._wait_turn(i)
        self._local.k = k + 1
        self._begin(i, k + 1)
        for ev in self._slot_events[k]:
            _wait(self.devs[i], ev)
        return all_reduce(self.slots[k], [self.devs[i]], op)[0]

    def _give_turn(self, i: int) -> str:
        with self._cv:
            self._turn = i
            self._cv.notify_all()
            while self._turn == i:
                self._cv.wait()
            return self._state[i]

    def run(self) -> list:
        """Run every shard to its end; returns their outputs."""
        self._start = {str(d): _record(d) for d in self.devs} if self._ordered else {}
        threads = [threading.Thread(target=self._shard, args=(i,), name=f"shard:{i}",
                                    daemon=True) for i in range(self.n)]
        for th in threads:
            th.start()
        try:
            while True:
                states = [self._give_turn(i) for i in range(self.n)]
                if "error" in states:
                    raise next(e for e in self._errors if e is not None)
                if all(s == "done" for s in states):
                    for dev, ev in zip(self.devs, self._done):
                        _wait(dev, ev)
                    return self.outputs
                if any(s == "done" for s in states):
                    raise RuntimeError("the shards of a sharded dispatch reached different "
                                       "collectives: the function's reductions depend on "
                                       "the shard")
        finally:
            with self._cv:
                if any(s not in ("done", "error") for s in self._state):
                    self._aborted = True
                    self._cv.notify_all()
            for th in threads:
                th.join()


def split_batch(tensors: Sequence[torch.Tensor], devs: Sequence[torch.device]) -> List[tuple]:
    """Each tensor cut into ``len(devs)`` equal shards along dim 0; shard
    ``i`` of every tensor on ``devs[i]``."""
    n = len(devs)
    for t in tensors:
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(f"a batch of shape {tuple(t.shape)} does not split into {n} "
                             "shards along its leading dim")
    parts = [t.chunk(n, dim=0) for t in tensors]
    return [tuple(move(p[i], devs[i]) for p in parts) for i in range(n)]


def join_outputs(outs: Sequence[tuple], device: torch.device) -> tuple:
    """The shards' outputs joined along dim 0 on ``device``: new tensors."""
    for o in outs[0]:
        if o.dim() == 0:
            raise ValueError("a sharded dispatch's outputs must keep the batch dim; "
                             f"got a scalar of {o.dtype}")
    return tuple(torch.cat([move(o[j], device) for o in outs], dim=0)
                 for j in range(len(outs[0])))


def _as_tuple(outs) -> tuple:
    return tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)


def run_eager(fns, tensors, devs) -> Tuple[tuple, ShardRun]:
    """One sharded call, eagerly: the joined outputs and the run."""
    run = ShardRun(fns, split_batch(tensors, devs), devs)
    outs = [_as_tuple(o) for o in run.run()]
    return join_outputs(outs, devs[0]), run


class ShardedCapture:
    """A sharded geometry, captured: each shard's graphs (one a segment),
    static inputs and outputs."""

    def __init__(self, graphs, static_in, static_out, devs, keep, warmup_calls,
                 warmup_s, capture_s, flops=None):
        self.graphs = graphs  # [shard][segment]
        self.shard_in = static_in  # [shard] tuple
        self.shard_out = static_out  # [shard] tuple
        self.devs = list(devs)
        self._keep = keep  # the collectives' values, which later segments read
        self.warmup_calls = warmup_calls
        self.warmup_s = warmup_s
        self.capture_s = capture_s
        self.flops = flops
        self.pool_bytes = None
        self.last_shard_events = None
        self._multi = len({str(d) for d in self.devs}) > 1

    @property
    def static_in(self) -> tuple:
        return tuple(t for s in self.shard_in for t in s)

    @property
    def static_out(self) -> tuple:
        return tuple(t for s in self.shard_out for t in s)

    @property
    def segments(self) -> int:
        return len(self.graphs[0])

    def run(self, xs, timing: bool = False) -> tuple:
        """Copy a batch's shards into the static inputs, replay segment by
        segment, and join the outputs (new tensors).  ``timing``: an event
        pair around each of a shard's segments (``last_shard_events``)."""
        for i, part in enumerate(split_batch(xs, self.devs)):
            for s, x in zip(self.shard_in[i], part):
                if x.shape != s.shape or x.dtype != s.dtype:
                    raise ValueError(f"captured for {s.dtype}{tuple(s.shape)} a shard, "
                                     f"got {x.dtype}{tuple(x.shape)}")
                s.copy_(x, non_blocking=True)
        events = [[] for _ in self.devs] if timing else None
        done = None
        for k in range(self.segments):
            ends = []
            for i, dev in enumerate(self.devs):
                with torch.cuda.device(dev):
                    stream = torch.cuda.current_stream(dev)
                    if done is not None:
                        for e in done:
                            stream.wait_event(e)
                    if timing:
                        b = torch.cuda.Event(enable_timing=True)
                        b.record(stream)
                    with launching():
                        self.graphs[i][k].replay()
                    if timing:
                        e = torch.cuda.Event(enable_timing=True)
                        e.record(stream)
                        events[i].append((b, e))
                    if self._multi:
                        ev = torch.cuda.Event()
                        ev.record(stream)
                        ends.append(ev)
            done = ends if self._multi else None
        self.last_shard_events = events
        return join_outputs(self.shard_out, self.devs[0])


def capture_sharded(fns: Sequence[Callable], shard_spec, devs: Sequence[torch.device],
                    warmup_calls: int = WARMUP_CALLS
                    ) -> ShardedCapture:
    """Capture ``fns[i]`` at ``shard_spec`` (one shard's input spec) on
    ``devs[i]`` for every shard, zeros as the static inputs: ``warmup_calls``
    eager sharded calls on side streams (the first shard's first call under
    ``FlopCounterMode``: ``flops`` is that times the shards), then one
    sharded call whose segments are captured."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..spec import torch_dtype
    from .torch_backend import gc_paused

    n = len(devs)
    static_in = [tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=d)
                       for t in shard_spec.tensors) for d in devs]
    sides = [torch.cuda.Stream(d) for d in devs]
    for s, d in zip(sides, devs):
        s.wait_stream(torch.cuda.current_stream(d))
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    for c in range(warmup_calls):
        def contexts(i, c=c):
            stack = contextlib.ExitStack()
            stack.enter_context(torch.cuda.stream(sides[i]))
            if c == 0 and i == 0:
                stack.enter_context(counter)
            return stack

        with torch.inference_mode():
            ShardRun(fns, static_in, devs, contexts=contexts).run()
    for s, d in zip(sides, devs):
        torch.cuda.current_stream(d).wait_stream(s)
    for d in {str(d): d for d in devs}.values():
        torch.cuda.synchronize(d)
    t1 = time.perf_counter()
    graphs: List[list] = [[] for _ in range(n)]
    streams = [torch.cuda.Stream(d) for d in devs]

    def begin(i, k):
        g = torch.cuda.CUDAGraph()
        graphs[i].append(g)
        g.capture_begin(capture_error_mode="thread_local")

    def end(i, k):
        graphs[i][k].capture_end()

    with gc_paused(), torch.inference_mode():
        run = ShardRun(fns, static_in, devs, contexts=lambda i: torch.cuda.stream(streams[i]),
                       begin=begin, end=end)
        outs = [_as_tuple(o) for o in run.run()]
    for d in {str(d): d for d in devs}.values():
        torch.cuda.synchronize(d)
    flops = counter.get_total_flops() * n if warmup_calls else None
    return ShardedCapture(graphs, static_in, outs, devs, run.slots, warmup_calls,
                          t1 - t0, time.perf_counter() - t1, flops=flops)
