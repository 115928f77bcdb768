"""Continuous batching for autoregressive decode.

The port of the JAX package's ``serving.py`` engine: many independent
token streams share one device; each engine tick runs ONE step over a
fixed-capacity batch of per-slot K/V caches, and streams join and leave
between ticks without a change of shape: membership is data (a gate
vector), not shape.

- **One CUDA graph.**  On the card the engine captures the batched step
  (:func:`~nnstreamer_tpu_torch.models.transformer.step_slots`) once, at
  construction, over static input and state buffers: ``xs`` (S, d_in),
  ``gates`` (S,), the ``(S, L, 2, T_max, d)`` cache batch and the
  positions (S, 1).  A tick copies the fed rows and the gates in, replays
  the graph and reads ``(S, n_out)`` back; the cache never leaves the card.
  The step is written over the slot axis (each slot's K/V written at its
  own position by device-side indexing), not mapped over a per-slot
  function, and reads nothing on the host.  This is the counterpart of the
  reference's single ``jax.jit`` and its all-gates-false warm-up tick: the
  capture's warm-up calls run with every gate off, which leaves the state
  as it was.
- **Gated advance.**  A slot with no input this tick flows through the
  step but writes back its old K/V and keeps its position, so starvation
  changes nothing; no reduction crosses the slot axis, so a stream's
  outputs do not depend on the streams it shares ticks with.
- **Prefill.**  ``DecodeSession.prefill`` runs a whole prompt in one
  causal pass (:func:`~nnstreamer_tpu_torch.models.transformer.prefill`);
  prompt lengths pad to power-of-two buckets and each bucket is one graph
  (captured on first use, or ahead by :meth:`ContinuousBatcher.warmup_prefill`
  through ``graph/warmup.execute``).

On the CPU (``device="cpu"``) the same functions run eagerly.
:class:`DecodeServer` serves the engine over the NNSQ wire
(``elements/query.py``): one connection is one session, with prefill,
probes that do not step, the scheduler's waiting room, drain, and live
migration of a session through a remote ``tensor_repo`` (``fleet/repo.py``).
Not ported: ``devices=N`` (the slot axis sharded over a mesh, ROADMAP item
13b) and the reference's persistent compilation cache (a CUDA graph cannot
be reloaded).

Usage::

    eng = ContinuousBatcher(capacity=8, t_max=128)
    sess = eng.open_session()            # joins at the next tick
    sess.feed(x_t)                       # (d_in,) features, any pace
    y_t = sess.get(timeout=5)            # (n_out,) in feed order
    sess.close()                         # slot free for the next stream
    eng.stop()
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .backends.torch_backend import capture_calls
from .device import resolve_device
from .models import transformer
from .obs.launch_gate import launching
from .spec import torch_dtype

_STOPPED = object()  # sentinel: engine stopped while a get() waited


class DecodeSession:
    """One client stream: a reserved slot in the engine's batch."""

    def __init__(self, engine: "ContinuousBatcher", slot: int):
        self._engine = engine
        self.slot = slot
        self._q_in: "queue.Queue" = queue.Queue()
        self._q_out: "queue.Queue" = queue.Queue()
        self.closed = False
        self.steps = 0
        # host mirror of the slot's position (prefill sets it to the prompt
        # length, each gated step advances it): stats() reads no device
        self.pos = 0
        # while gated (a snapshot in progress) _gather leaves the queue alone
        self._gated = False

    def feed(self, x) -> None:
        """Queue one step's features ((d_in,) float32); returns at once.
        The input is copied: the caller may reuse its buffer."""
        if self.closed:
            raise RuntimeError("session closed")
        self._engine._check_alive()
        x = np.array(x, np.float32)
        if x.shape != (self._engine.d_in,):
            raise ValueError(f"feed expects shape ({self._engine.d_in},), got {x.shape}")
        self._q_in.put(x)
        self._engine._kick()

    def prefill(self, xs) -> None:
        """Queue a whole ``(T, d_in)`` prompt as one causal pass: the slot's
        cache and position are replaced by the prompt's, one output (the
        last prompt token's) arrives through :meth:`get`, and later
        :meth:`feed` steps continue from position T.  The prompt pads to a
        power-of-two bucket (at most ``t_max``)."""
        if self.closed:
            raise RuntimeError("session closed")
        self._engine._check_alive()
        xs = np.array(xs, np.float32)
        eng = self._engine
        if xs.ndim != 2 or xs.shape[1] != eng.d_in or xs.shape[0] < 1:
            raise ValueError(f"prefill expects shape (T, {eng.d_in}) with T >= 1, "
                             f"got {xs.shape}")
        if xs.shape[0] > eng.t_max:
            raise ValueError(f"prompt length {xs.shape[0]} exceeds cache t_max {eng.t_max}")
        tb = 1
        while tb < xs.shape[0]:
            tb <<= 1
        tb = min(tb, eng.t_max)
        padded = np.zeros((tb, eng.d_in), np.float32)
        padded[:xs.shape[0]] = xs
        self._q_in.put(("prefill", padded, int(xs.shape[0])))
        eng._kick()

    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        """Next output ((n_out,) float32), blocking up to ``timeout``.
        Outputs computed before the engine stopped are delivered first;
        then every get raises RuntimeError (with the engine's failure, if
        any)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                out = self._q_out.get_nowait()
            except queue.Empty:
                if not self._engine._running:
                    err = self._engine._error
                    raise RuntimeError("engine stopped" + (f" (engine failure: {err!r})"
                                                           if err else "")) from None
                if deadline is None:
                    wait = 0.1
                else:
                    wait = min(0.1, deadline - time.monotonic())
                    if wait <= 0:
                        raise TimeoutError(f"no decode output within {timeout}s "
                                           "(stream starved?)") from None
                try:
                    out = self._q_out.get(timeout=wait)
                except queue.Empty:
                    continue  # re-check liveness and the deadline
            if out is _STOPPED:
                # the stop's sentinel can land before the last tick's
                # outputs: deliver those first, keep one sentinel last
                behind = []
                while True:
                    try:
                        item = self._q_out.get_nowait()
                    except queue.Empty:
                        break
                    if item is not _STOPPED:
                        behind.append(item)
                for item in behind:
                    self._q_out.put(item)
                self._q_out.put(_STOPPED)
                if behind:
                    continue
                err = self._engine._error
                raise RuntimeError("engine stopped while this stream was waiting"
                                   + (f" (engine failure: {err!r})" if err else ""))
            return out

    def snapshot(self) -> dict:
        """This session's whole decode state at a tick boundary
        (:meth:`ContinuousBatcher.snapshot_session`)."""
        return self._engine.snapshot_session(self)

    def close(self) -> None:
        """Release the slot for the next :meth:`ContinuousBatcher.open_session`."""
        if not self.closed:
            self.closed = True
            self._engine._release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ContinuousBatcher:
    """Fixed-capacity continuous-batching engine around a decode cell.

    Parameters mirror :func:`~nnstreamer_tpu_torch.models.transformer.
    build_decode_cell`; ``params`` (a tree in the JAX package's layout, or
    the port's) replaces the random init, so one checkpoint serves the
    repo-slot cell and the engine.  ``window=True`` gives every slot a ring
    cache.  ``device`` defaults to the card; ``devices`` must be None or 1.
    """

    def __init__(self, capacity: int = 4, t_max: int = 128, d_in: int = 64, n_out: int = 16,
                 d_model: int = 128, n_heads: int = 8, n_layers: int = 2, dtype=torch.float32,
                 seed: int = 0, params=None, window: bool = False,
                 devices: Optional[int] = None, device="cuda"):
        if devices not in (None, 1):
            raise NotImplementedError(f"devices={devices!r} shards the slot axis over a mesh: "
                                      "it is not ported yet (ROADMAP item 13b)")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.d_in, self.n_out, self.t_max = d_in, n_out, t_max
        self.window = window
        self._dtype = torch_dtype(dtype)
        tree = params if params is not None else transformer.init_tree(
            seed, d_model, n_heads, n_layers, 4 * d_model, d_in, n_out)
        self.params = transformer.prepare(tree, self._dtype, self.device)
        transformer._check_decode(self.params, window, "ContinuousBatcher")
        n_layers_p = len(self.params["blocks"])
        d_model_p = self.params["ln_f"]["scale"].shape[-1]
        # the I/O geometry comes from the params, as the layers do: a
        # checkpoint of another d_in fails here, not in the engine thread
        w_e, w_h = self.params["embed"]["w"], self.params["head"]["w"]
        d_in_p = int(getattr(w_e, "q", w_e).shape[0])
        n_out_p = int(getattr(w_h, "q", w_h).shape[-1])
        if (d_in_p, n_out_p) != (d_in, n_out):
            raise ValueError(f"params expect d_in={d_in_p}, n_out={n_out_p} but the engine was "
                             f"built with d_in={d_in}, n_out={n_out}: pass matching dimensions")
        s, dev = self.capacity, self.device
        self._caches = torch.zeros((s, n_layers_p, 2, t_max, d_model_p), dtype=self._dtype,
                                   device=dev)
        self._poss = torch.zeros((s, 1), dtype=torch.int32, device=dev)
        self._xs = torch.zeros((s, d_in), dtype=torch.float32, device=dev)
        self._gates = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._graph = None
        self.capture_s = 0.0
        if dev.type == "cuda":
            # the step's one capture, paid here and not on a client's first
            # step; the warm-up calls run with every gate off
            t0 = time.perf_counter()
            self._graph, self._ys, _, _ = capture_calls(self._batched_step, dev)
            self.capture_s = time.perf_counter() - t0
        self._prefill_fns: Dict[int, object] = {}  # bucket T -> prefill callable
        self._cv = threading.Condition()
        self._active: Dict[int, DecodeSession] = {}
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() gives slot 0 first
        self._resets: list = []
        # pending restores (slot, cache, pos), applied by _gather after resets
        self._restores: list = []
        # True between _gather and the tick's closing critical section: the
        # device state must not be read then (snapshot_session waits)
        self._ticking = False
        self._running = True
        self._error: Optional[BaseException] = None
        self.ticks = 0           # batched steps and prefills dispatched
        self.steps_total = 0     # per-stream outputs served
        self.prefill_tokens = 0  # prompt tokens absorbed by prefill
        self.sessions_migrated_out = 0
        self.sessions_migrated_in = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()

    # -- the device step -------------------------------------------------------

    def _batched_step(self) -> torch.Tensor:
        """One tick over the static buffers: the cache updated in place,
        the positions advanced where gated; returns ys (S, n_out)."""
        ys, nxt = transformer.step_slots(self.params, self._xs, self._caches, self._poss,
                                         dtype=self._dtype, window=self.window,
                                         gate=self._gates)
        self._poss.copy_(nxt)
        return ys

    def _step(self, xs: np.ndarray, gates: np.ndarray) -> np.ndarray:
        """Copy a tick's inputs in, run the step (replay the graph on the
        card), and read the outputs back."""
        self._xs.copy_(torch.from_numpy(xs))
        self._gates.copy_(torch.from_numpy(gates))
        if self._graph is not None:
            with launching():
                self._graph.replay()
            ys = self._ys
        else:
            ys = self._batched_step()
        return ys.cpu().numpy()

    def _prefill_fn(self, tb: int):
        """The prefill of bucket length ``tb``: ``fn(xp (tb, d_in) numpy, n)``
        → (y_last, cache, pos) on the device; on the card one captured
        graph per bucket, its outputs rewritten by the next call."""
        fn = self._prefill_fns.get(tb)
        if fn is not None:
            return fn
        params, t_max, dtype, dev = self.params, self.t_max, self._dtype, self.device
        if dev.type != "cuda":
            def fn(xp, n):
                return transformer.prefill(params, torch.tensor(xp), t_max, n, dtype=dtype)
        else:
            xp_s = torch.zeros((tb, self.d_in), dtype=torch.float32, device=dev)
            n_s = torch.full((), tb, dtype=torch.int32, device=dev)
            graph, outs, _, _ = capture_calls(
                lambda: transformer.prefill(params, xp_s, t_max, n_s, dtype=dtype), dev)

            def fn(xp, n):
                xp_s.copy_(torch.tensor(xp))
                n_s.fill_(int(n))
                with launching():
                    graph.replay()
                return outs
        self._prefill_fns[tb] = fn
        return fn

    def warmup_prefill(self, max_len: Optional[int] = None) -> dict:
        """Make every prompt bucket's prefill ahead (on the card, capture its
        graph), so no prompt pays it on the request path: the power-of-two
        ladder up to ``max_len`` (default ``t_max``) and ``t_max`` itself.
        Returns the warmup report (``graph/warmup.py``)."""
        from .graph.warmup import execute

        cap = min(int(max_len) if max_len else self.t_max, self.t_max)
        buckets, tb = [], 1
        while tb < cap:
            buckets.append(tb)
            tb <<= 1
        buckets.append(cap)

        def warm(tb: int):
            with torch.no_grad():
                self._prefill_fn(tb)(np.zeros((tb, self.d_in), np.float32), tb)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        items = [("decode_engine", f"prefill_t{tb}", lambda t=tb: warm(t)) for tb in buckets]
        return execute(items, name="decode_engine")

    # -- client surface ----------------------------------------------------------

    def open_session(self, timeout: Optional[float] = None) -> DecodeSession:
        """Reserve a slot (blocks up to ``timeout`` for capacity; TimeoutError
        past it).  The slot's cache and position reset before its first
        step."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._free or not self._running, timeout=timeout):
                raise TimeoutError(f"no free slot within {timeout}s (capacity {self.capacity})")
            if not self._running:
                raise RuntimeError("engine stopped")
            slot = self._free.pop()
            sess = DecodeSession(self, slot)
            self._active[slot] = sess
            self._resets.append(slot)
            return sess

    def publish_metrics(self, registry=None):
        """Republish :meth:`stats` as ``nnstpu_serving_*`` gauges, refreshed at
        every scrape.  Returns the collector for ``registry.remove_collector``."""
        from .obs.export import register_engine

        return register_engine(self, registry=registry)

    def stats(self) -> dict:
        """Occupancy, served counters, the tick-coalescing ratio and each
        slot's occupancy and position (no device read)."""
        with self._cv:
            slots = {}
            for slot in range(self.capacity):
                sess = self._active.get(slot)
                slots[slot] = {"occupied": sess is not None,
                               "pos": sess.pos if sess is not None else 0,
                               "steps": sess.steps if sess is not None else 0,
                               "gated": bool(sess is not None and sess._gated)}
            return {
                "capacity": self.capacity,
                "active_sessions": len(self._active),
                "free_slots": len(self._free),
                "ticks": self.ticks,
                "steps_total": self.steps_total,
                "prefill_tokens": self.prefill_tokens,
                "coalescing": round(self.steps_total / self.ticks, 3) if self.ticks else None,
                "running": self._running,
                "sessions_migrated_out": self.sessions_migrated_out,
                "sessions_migrated_in": self.sessions_migrated_in,
                "slots": slots,
            }

    def stop(self) -> None:
        """Stop the engine; every active session's blocked ``get()`` raises."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
            for sess in self._active.values():
                sess._q_out.put(_STOPPED)
        self._thread.join(timeout=10)

    def _check_alive(self) -> None:
        if not self._running:
            err = self._error
            raise RuntimeError("engine stopped" + (f" (engine failure: {err!r})" if err else ""))

    def _fail(self, exc: BaseException) -> None:
        """An engine-thread failure: record it, stop, wake every waiter."""
        with self._cv:
            self._error = exc
            self._running = False
            self._cv.notify_all()
            for sess in self._active.values():
                sess._q_out.put(_STOPPED)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def _kick(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _release(self, sess: DecodeSession) -> None:
        with self._cv:
            if self._active.get(sess.slot) is sess:
                del self._active[sess.slot]
                # a restore not applied yet must not reach the slot's next stream
                self._restores = [r for r in self._restores if r[0] != sess.slot]
                self._free.append(sess.slot)
                self._cv.notify_all()

    # -- checkpoint and restore ----------------------------------------------------

    def snapshot_session(self, sess: DecodeSession, timeout: float = 10.0) -> dict:
        """Checkpoint one session at a tick boundary: gate its slot off, wait
        for the tick in flight to end and deliver, then take the slot's
        cache, position and both queues.  The session stays gated until it
        is closed or :meth:`abort_snapshot` re-arms it.  The dict
        round-trips through :func:`pack_session_snapshot` and feeds
        :meth:`restore_session` on an engine of the same geometry."""
        with self._cv:
            if self._active.get(sess.slot) is not sess:
                raise RuntimeError("session is not active on this engine (closed, or a foreign "
                                   "engine's session)")
            sess._gated = True
            try:
                if not self._cv.wait_for(lambda: not self._ticking or not self._running,
                                         timeout=timeout):
                    raise TimeoutError(f"engine did not reach a tick boundary within {timeout}s")
                self._check_alive()
                cache = self._caches[sess.slot].to(torch.float32).cpu().numpy()
                pos = int(self._poss[sess.slot, 0])
                pending_in = []
                while True:
                    try:
                        pending_in.append(sess._q_in.get_nowait())
                    except queue.Empty:
                        break
                pending_out = []
                while True:
                    try:
                        item = sess._q_out.get_nowait()
                    except queue.Empty:
                        break
                    if item is not _STOPPED:
                        pending_out.append(np.asarray(item, np.float32))
                self.sessions_migrated_out += 1
            except BaseException:
                sess._gated = False
                self._cv.notify_all()
                raise
        return {"version": 1, "d_in": self.d_in, "n_out": self.n_out, "t_max": self.t_max,
                "window": bool(self.window), "cache": cache, "pos": pos,
                "steps": int(sess.steps), "pending_in": pending_in, "pending_out": pending_out}

    def abort_snapshot(self, sess: DecodeSession, snapshot: dict) -> None:
        """Undo a snapshot whose handoff failed before the slot was released:
        re-queue what it drained and re-arm the session."""
        with self._cv:
            for item in snapshot.get("pending_in", ()):
                sess._q_in.put(item)
            for item in snapshot.get("pending_out", ()):
                sess._q_out.put(item)
            sess._gated = False
            self._cv.notify_all()

    def restore_session(self, snapshot: dict, timeout: Optional[float] = None) -> DecodeSession:
        """Open a session that continues from ``snapshot``: its cache and
        position go into the new slot before its first tick, pending inputs
        re-queue in order and computed outputs are delivered first.  A
        snapshot of another geometry raises ValueError."""
        cache = np.array(snapshot["cache"], np.float32)  # a copy: the caller's may be read-only
        want = tuple(self._caches.shape[1:])
        mine = dict(d_in=self.d_in, n_out=self.n_out, t_max=self.t_max, window=bool(self.window))
        theirs = {k: snapshot.get(k) for k in mine}
        theirs["window"] = bool(theirs["window"])
        if theirs != mine or tuple(cache.shape) != want:
            raise ValueError(f"snapshot geometry mismatch: snapshot has {theirs} with cache "
                             f"{tuple(cache.shape)}, this engine expects {mine} with cache "
                             f"{want}: refusing to restore wrong state")
        sess = self.open_session(timeout=timeout)
        with self._cv:
            sess.steps = int(snapshot.get("steps", 0))
            sess.pos = int(snapshot["pos"])
            self._restores.append((sess.slot, cache, sess.pos))
            for item in snapshot.get("pending_out", ()):
                sess._q_out.put(np.asarray(item, np.float32))
            for item in snapshot.get("pending_in", ()):
                sess._q_in.put(item)
            self.sessions_migrated_in += 1
            self._cv.notify_all()
        return sess

    # -- the tick loop ---------------------------------------------------------------

    def _gather(self):
        """Under the lock: apply pending resets and restores, then take at
        most one queued item per active session.  Returns (xs, gates, fed,
        prefills), or None when idle."""
        for slot in self._resets:
            self._caches[slot].zero_()
            self._poss[slot].zero_()
        self._resets.clear()
        for slot, cache, pos in self._restores:
            self._caches[slot].copy_(torch.from_numpy(cache))
            self._poss[slot].fill_(pos)
        self._restores.clear()
        xs = gates = None
        fed, prefills = {}, []
        for slot, sess in self._active.items():
            if sess._gated:
                continue
            try:
                item = sess._q_in.get_nowait()
            except queue.Empty:
                continue
            if isinstance(item, tuple) and item[0] == "prefill":
                prefills.append((slot, sess, item[1], item[2]))
                continue
            if xs is None:
                xs = np.zeros((self.capacity, self.d_in), np.float32)
                gates = np.zeros((self.capacity,), bool)
            xs[slot] = item
            gates[slot] = True
            fed[slot] = sess
        if not fed and not prefills:
            return None
        return xs, gates, fed, prefills

    def _loop(self) -> None:
        try:
            while True:
                with self._cv:
                    batch = self._gather()
                    while batch is None and self._running:
                        self._cv.wait()  # every state change that makes work notifies
                        batch = self._gather()
                    if batch is None and not self._running:
                        return
                    xs, gates, fed, prefills = batch
                    self._ticking = True
                # the device work (and a bucket's first capture) runs outside
                # the lock: feed, open_session and stop never wait for it
                pre_out = []
                with torch.no_grad():
                    for slot, sess, xp, n in prefills:
                        y_last, cache, pos = self._prefill_fn(xp.shape[0])(xp, n)
                        self._caches[slot].copy_(cache)
                        self._poss[slot].copy_(pos)
                        pre_out.append((sess, y_last.cpu().numpy(), n))
                    ys = self._step(xs, gates) if fed else None
                # one critical section for the tick's counters and outputs: a
                # stats() sees all of the tick or none, and once _ticking is
                # False every output of the tick is in its queue
                with self._cv:
                    for sess, y_last, n in pre_out:
                        self.prefill_tokens += n
                        self.ticks += 1
                        self.steps_total += 1
                        sess.steps += 1
                        sess.pos = n
                    if ys is not None:
                        self.ticks += 1
                        self.steps_total += len(fed)
                        for sess in fed.values():
                            sess.steps += 1
                            sess.pos += 1
                    for sess, y_last, n in pre_out:
                        sess._q_out.put(y_last)
                    if ys is not None:
                        for slot, sess in fed.items():
                            sess._q_out.put(ys[slot].copy())
                    self._ticking = False
                    self._cv.notify_all()
        except BaseException as exc:  # noqa: BLE001 - wake the waiters
            self._fail(exc)


# -- session snapshot wire format ------------------------------------------------
#
# A snapshot travels as one flat tuple of numpy tensors (a tensor_repo frame):
#
#   t[0]  int64 header: [version, d_in, n_out, t_max, window, pos, steps,
#                        n_pending_in, n_pending_out, *pending_in_meta]
#         pending_in_meta[i]: -1 for a queued step, the unpadded prompt
#         length for a queued prefill;
#   t[1]  float32 cache slice (L, 2, T_max, d_model);
#   t[2]  float32 (n_pending_out, n_out) computed outputs (one zero row when
#         there are none: no dim may be 0);
#   t[3:] the pending inputs in queue order (steps rank 1, prompts rank 2 at
#         their bucket length).

SNAPSHOT_VERSION = 1
# a frame carries at most 16 tensors, 3 of them fixed
MAX_SNAPSHOT_PENDING = 12


def pack_session_snapshot(snap: dict) -> tuple:
    """A :meth:`ContinuousBatcher.snapshot_session` dict → flat numpy
    tensors for one frame."""
    pending_in = list(snap.get("pending_in", ()))
    if len(pending_in) > MAX_SNAPSHOT_PENDING:
        raise RuntimeError(f"session has {len(pending_in)} pending inputs; at most "
                           f"{MAX_SNAPSHOT_PENDING} fit a snapshot frame")
    meta, items = [], []
    for item in pending_in:
        if isinstance(item, tuple) and item[0] == "prefill":
            meta.append(int(item[2]))
            items.append(np.asarray(item[1], np.float32))
        else:
            meta.append(-1)
            items.append(np.asarray(item, np.float32))
    pending_out = [np.asarray(o, np.float32) for o in snap.get("pending_out", ())]
    outs = (np.stack(pending_out) if pending_out
            else np.zeros((1, int(snap["n_out"])), np.float32))
    header = np.array([SNAPSHOT_VERSION, snap["d_in"], snap["n_out"], snap["t_max"],
                       int(bool(snap["window"])), snap["pos"], snap.get("steps", 0),
                       len(items), len(pending_out)] + meta, np.int64)
    return (header, np.asarray(snap["cache"], np.float32), outs, *items)


def unpack_session_snapshot(tensors) -> dict:
    """Inverse of :func:`pack_session_snapshot`; a corrupt or foreign frame
    raises ValueError."""
    if len(tensors) < 3:
        raise ValueError(f"session snapshot needs >= 3 tensors, got {len(tensors)}")
    header = np.asarray(tensors[0])
    if header.dtype != np.int64 or header.ndim != 1 or header.size < 9:
        raise ValueError(f"bad snapshot header {header.dtype}/{header.shape}")
    ver = int(header[0])
    if ver != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {ver} != {SNAPSHOT_VERSION}")
    d_in, n_out, t_max, window, pos, steps, n_in, n_pout = (int(v) for v in header[1:9])
    if header.size != 9 + n_in or len(tensors) != 3 + n_in:
        raise ValueError(f"snapshot declares {n_in} pending inputs but carries "
                         f"{len(tensors) - 3} (header size {header.size})")
    outs = np.asarray(tensors[2], np.float32)
    if outs.ndim != 2 or outs.shape != (max(1, n_pout), n_out):
        raise ValueError(f"snapshot pending outputs {outs.shape} != ({n_pout}, {n_out})")
    pending_in = []
    for i in range(n_in):
        arr = np.asarray(tensors[3 + i], np.float32)
        n = int(header[9 + i])
        if n < 0:
            if arr.shape != (d_in,):
                raise ValueError(f"pending step {i} has shape {arr.shape} != ({d_in},)")
            pending_in.append(arr)
        else:
            if arr.ndim != 2 or arr.shape[1] != d_in or not 1 <= n <= arr.shape[0]:
                raise ValueError(f"pending prefill {i} has shape {arr.shape} with length {n}")
            pending_in.append(("prefill", arr, n))
    return {"version": ver, "d_in": d_in, "n_out": n_out, "t_max": t_max,
            "window": bool(window), "cache": np.asarray(tensors[1], np.float32), "pos": pos,
            "steps": steps, "pending_in": pending_in,
            "pending_out": [outs[i] for i in range(n_pout)]}


class DecodeServer:
    """Continuous batching over TCP: **one connection = one decode
    session** on a shared :class:`ContinuousBatcher`.

    The port of the JAX package's ``DecodeServer``.  The wire protocol is
    the ``tensor_query`` framing (:mod:`nnstreamer_tpu_torch.elements.query`:
    raw endian-explicit bytes, no pickle), so a pipeline offloads a decode
    stream with the stock client element::

        tensor_query_client host=... port=...   # out_spec=(n_out,) f32

    Each connection streams synchronously (send one ``(d_in,)`` step,
    receive one ``(n_out,)`` output — per-stream ordering is inherent);
    CONCURRENT connections are what the engine coalesces into batched
    ticks, so aggregate throughput scales with the number of live streams
    up to ``capacity`` — continuous batching as a network service.

    Negotiation: the stock client probes with a zero frame stamped
    ``PROBE_PTS`` (a dedicated wire sentinel, distinct from the ``-1`` of
    an unstamped stream frame).  Probes are answered with the output
    geometry WITHOUT advancing decode state — any number of them (mid-
    stream renegotiation included) is safe; every other frame, stamped or
    not, is one decode step.  Passing ``out_spec=`` to the client skips
    the probe entirely.
    """

    def __init__(self, engine: ContinuousBatcher, host: str = "127.0.0.1",
                 port: int = 0, session_timeout: float = 30.0,
                 scheduler=None, migration: bool = True, device="cuda"):
        """``device`` is the engine's: the card by default (without one the
        constructor raises unless ``device="cpu"``); an engine on another
        device raises.

        ``scheduler`` (:class:`nnstreamer_tpu_torch.sched.Scheduler`) makes
        session admission priority-aware when capacity slots are
        contended: joiners wait in (priority, FIFO) order behind a
        bounded waiting room, and an over-full room sheds with a typed
        ``NNSQ`` error frame instead of parking the connection for the
        whole ``session_timeout``.  ``scheduler=None`` consults conf
        (``NNSTPU_SCHED_POLICY``); unset keeps the legacy first-come
        ``open_session`` path.

        ``migration=False`` disables the live-migration control ops
        (``MIGRATE_PTS``/``RESUME_PTS`` fall through to the decode-step
        validation, exactly what a pre-migration server answers) — the
        knob the version-gate tests and a paranoid operator use."""
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"DecodeServer on {self.device}, its engine on {engine.device}")
        self.engine = engine
        self.host, self.port = host, int(port)
        self.session_timeout = float(session_timeout)
        self.migration = bool(migration)
        self.sessions_migrated = 0   # snapshots shipped off this server
        self.sessions_restored = 0   # sessions restored onto this server
        self._srv: Optional[socket.socket] = None
        self._accept: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        self.connections = 0  # observability
        self._own_sched = False
        if scheduler is None:
            from .sched import configured_scheduler

            scheduler = configured_scheduler("decode_server")
            self._own_sched = scheduler is not None
        self.scheduler = scheduler
        # live client sockets: stop() must shut these down too — an idle
        # client's _serve thread is parked in recv, and only unblocking it
        # releases the session's capacity slot (review r5).  Each maps to
        # a per-connection state (send lock + has-session flag) so
        # drain() can send typed goodbyes without interleaving a reply.
        self._conns: Dict[socket.socket, "DecodeServer._ConnState"] = {}
        self._conns_lock = threading.Lock()

    class _ConnState:
        __slots__ = ("lock", "sess", "migrated")

        def __init__(self):
            self.lock = threading.Lock()
            self.sess = False  # this connection holds a decode session
            self.migrated = False  # its session was migrated away

    def start(self) -> "DecodeServer":
        from . import faults as _faults

        # chaos runs cover this front door too (NNSTPU_FAULTS)
        _faults.ensure_configured()
        self._srv = socket.create_server((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._accept = threading.Thread(
            target=self._accept_loop, daemon=True, name="decode-server")
        self._accept.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._srv is not None:
            try:
                # close() alone does not wake a blocked accept/recv
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._srv.close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # wakes the recv → finally
            except OSError:
                pass
        if self._accept is not None:
            self._accept.join(timeout=10)
        if self._own_sched and self.scheduler is not None:
            # conf-activated scheduler: this server owns its collector
            self.scheduler.close()

    def drain(self, timeout: float = 10.0) -> bool:
        """Graceful shutdown (the SIGTERM path): stop accepting, reject
        NEW session joins with a typed ``[UNAVAILABLE]``, close idle
        probe-only connections with the same typed goodbye, and let live
        decode sessions keep stepping until they close — up to the
        deadline, after which the stragglers are terminated with the
        typed ``[SESSION]`` wire code (never a torn socket).  Returns
        True when every session ended before the deadline; always ends
        in :meth:`stop`."""
        from .elements.query import send_error

        self._draining = True
        if self._srv is not None:
            try:
                # close() alone does not wake a blocked accept
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._srv.close()
        with self._conns_lock:
            conns = list(self._conns.items())
        for conn, st in conns:
            if st.sess:
                continue  # live session: it finishes (or hits the deadline)
            with st.lock:
                if st.sess:
                    continue
                try:
                    send_error(conn, "decode server draining",
                               code="UNAVAILABLE")
                except OSError:
                    pass
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._conns_lock:
                if not any(st.sess for st in self._conns.values()):
                    break
            time.sleep(0.02)
        with self._conns_lock:
            stragglers = [(c, st) for c, st in self._conns.items() if st.sess]
        for conn, st in stragglers:
            with st.lock:
                try:
                    send_error(
                        conn, "decode server drained: session terminated "
                        "(reconnect and re-prefill elsewhere)",
                        code="SESSION")
                except OSError:
                    pass
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        self.stop()
        return not stragglers

    def kill(self) -> None:
        """Crash simulation (chaos ``worker_kill``): tear every socket
        down mid-flight, no courtesy frames — stateful clients see a
        broken session, exactly like a SIGKILLed worker."""
        self._running = False
        if self._srv is not None:
            try:
                # close() alone does not wake a blocked accept
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._srv.close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._accept is not None:
            self._accept.join(timeout=10)
        if self._own_sched and self.scheduler is not None:
            self.scheduler.close()

    def stats(self) -> dict:
        """Server snapshot (engine state lives in ``engine.stats()``)."""
        out = {"running": self._running, "connections": self.connections,
               "migration": self.migration,
               "sessions_migrated": self.sessions_migrated,
               "sessions_restored": self.sessions_restored}
        if self.scheduler is not None:
            out["sched"] = self.scheduler.stats()
        return out

    def _admit_session(self, client: str,
                       tenant: Optional[str] = None) -> DecodeSession:
        """Priority-aware slot assignment: non-blocking grant attempts in
        the gate's (priority, FIFO) order until a slot frees or the
        session timeout / waiting-room bound sheds the join.  With span
        tracing on, the slot wait is recorded on the joining request's
        trace (queue-wait decomposition, same family as ``sched_wait``)."""
        from .obs import spans as _spans

        def try_grant():
            try:
                return self.engine.open_session(timeout=0)
            except TimeoutError:
                return None  # full right now: stay in the gate

        t0 = _spans.now_ns() if _spans.enabled else 0
        sess = self.scheduler.acquire_slot(
            client, try_grant, timeout=self.session_timeout, tenant=tenant)
        if t0:
            _spans.record_span(
                "slot_wait", t0, _spans.now_ns() - t0, cat="sched",
                args={"server": "decode_server", "client": client})
        return sess

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # stop() closed the listener
            self.connections += 1
            with self._conns_lock:
                self._conns[conn] = self._ConnState()
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _handle_migration(self, conn, state, sess, tensors, pts, wtrace,
                          client) -> Optional[DecodeSession]:
        """One live-migration control op on this connection.  Returns the
        connection's (possibly new) session.  Every failure answers the
        typed ``[MIGRATING]`` code — and, for a snapshot that had not yet
        crossed the point of no return, re-arms the session in place, so
        a failed handoff never advances or loses state."""
        from .buffer import Frame
        from .elements.query import (
            MIGRATE_PTS,
            QueryMigratingError,
            parse_session_control,
            send_error,
            send_tensors,
        )
        from .fleet.repo import RemoteTensorRepo
        from .obs import spans as _spans

        op = "snapshot" if pts == MIGRATE_PTS else "restore"
        tok = (_spans.span_begin(wtrace[0], wtrace[1])
               if wtrace is not None and _spans.enabled else None)
        try:
            addr, key, deadline_ms = parse_session_control(tensors)
            deadline_s = max(0.1, deadline_ms / 1e3)
            if pts == MIGRATE_PTS:
                if sess is None:
                    raise QueryMigratingError(
                        "no live session on this connection to migrate")
                snap = self.engine.snapshot_session(sess,
                                                    timeout=deadline_s)
                try:
                    packed = pack_session_snapshot(snap)
                    repo = RemoteTensorRepo.from_addr(addr)
                    try:
                        if not repo.set_buffer(
                                key, Frame(tensors=packed, pts=0)):
                            raise RuntimeError(
                                f"repo slot {key} refused the snapshot "
                                "(EOS)")
                    finally:
                        repo.close()
                except BaseException:
                    # the slot was only gated: re-queue the drained
                    # items and keep serving exactly where it was
                    self.engine.abort_snapshot(sess, snap)
                    raise
                sess.close()
                with state.lock:
                    state.sess = False
                    state.migrated = True
                    self.sessions_migrated += 1
                    send_tensors(conn, (np.array([1], np.int64),), pts,
                                 trace=wtrace)
                return None
            # RESUME_PTS: restore a snapshot onto a fresh connection
            if sess is not None:
                raise QueryMigratingError(
                    "restore needs a fresh connection (this one already "
                    "holds a session)")
            if self._draining:
                raise QueryMigratingError(
                    "decode server draining: restore refused")
            repo = RemoteTensorRepo.from_addr(addr)
            try:
                frame, _spec, eos = repo.get_buffer(key, timeout=deadline_s)
            finally:
                repo.close()
            if frame is None or eos:
                raise QueryMigratingError(
                    f"no snapshot in repo slot {key} within {deadline_s}s")
            snap = unpack_session_snapshot(frame.tensors)
            # ValueError here = geometry mismatch: typed-refused below,
            # wrong state is never restored
            new_sess = self.engine.restore_session(
                snap, timeout=min(deadline_s, self.session_timeout))
            with state.lock:
                state.sess = True
                self.sessions_restored += 1
                send_tensors(conn, (np.array([1], np.int64),), pts,
                             trace=wtrace)
            return new_sess
        except Exception as exc:  # noqa: BLE001 — typed refusal, keep serving
            try:
                with state.lock:
                    send_error(conn, f"decode server {op} failed: {exc}",
                               code="MIGRATING")
            except OSError:
                pass
            return sess
        finally:
            if tok is not None:
                _spans.span_end(tok, f"migrate_{op}", "migrate",
                                args={"client": client})

    def _serve(self, conn: socket.socket) -> None:
        from .elements.query import (
            MIGRATE_PTS,
            PROBE_PTS,
            RESUME_PTS,
            recv_tensors_ex,
            send_error,
            send_tensors,
        )
        from .sched import OverloadError

        try:
            peer = conn.getpeername()
            client = f"{peer[0]}:{peer[1]}"
        except (OSError, IndexError):
            client = "unknown"
        with self._conns_lock:
            state = self._conns.get(conn) or self._ConnState()
        sess: Optional[DecodeSession] = None
        tenant = client.rsplit(":", 1)[0]
        try:
            while self._running:
                try:
                    # trace context is consumed and echoed (a traced
                    # client keeps its flag; a plain-v1 client never
                    # sees the bit); a declared wire tenant wins over
                    # the peer-IP fallback for shed accounting
                    tensors, pts, wtrace, wtenant = recv_tensors_ex(conn)
                except (ConnectionError, OSError):
                    return  # client left: free the slot in finally
                if wtenant:
                    tenant = wtenant
                if state.migrated:
                    # the session moved away mid-handoff race: typed
                    # verdict that explicitly did NOT apply the frame,
                    # so a migration-aware peer may re-send it to the
                    # session's new home (never a duplicate step)
                    try:
                        with state.lock:
                            send_error(
                                conn, "session migrated away; the frame "
                                "was not applied — resume on the new "
                                "worker", code="MIGRATING")
                    except OSError:
                        pass
                    return
                if pts in (MIGRATE_PTS, RESUME_PTS) and self.migration:
                    # version-gated wire path: with migration disabled
                    # (or on a pre-migration server) these sentinels fall
                    # through to the decode-step validation below and
                    # answer a plain error — the router reads that as
                    # "cannot migrate" and degrades to [SESSION]
                    sess = self._handle_migration(
                        conn, state, sess, tensors, pts, wtrace, client)
                    continue
                try:
                    if len(tensors) != 1:
                        raise ValueError(
                            f"decode step takes 1 tensor, got {len(tensors)}")
                    shp = tuple(tensors[0].shape)
                    is_step = shp == (self.engine.d_in,)
                    is_prompt = (len(shp) == 2 and shp[1] == self.engine.d_in
                                 and 1 <= shp[0] <= self.engine.t_max)
                    if pts == PROBE_PTS:
                        # the stock client's negotiation probe: answer the
                        # output geometry WITHOUT advancing decode state.
                        # Validate the PROBE's geometry so a mismatched
                        # client fails at configure time with a clear
                        # message, not mid-stream (review r5).
                        if not (is_step or is_prompt):
                            raise ValueError(
                                f"decode server expects ({self.engine.d_in},)"
                                f" steps or (T, {self.engine.d_in}) prompts,"
                                f" got {shp}")
                        with state.lock:
                            send_tensors(
                                conn,
                                (np.zeros((self.engine.n_out,), np.float32),),
                                pts, trace=wtrace)
                        continue
                    if sess is None:
                        if self._draining:
                            # no NEW sessions on a draining server: typed
                            # rejection so the client (or router) can
                            # re-route the join elsewhere
                            with state.lock:
                                send_error(conn, "decode server draining",
                                           code="UNAVAILABLE")
                            return
                        # lazy join: a probe-only connection never holds a
                        # capacity slot
                        if self.scheduler is not None:
                            sess = self._admit_session(client, tenant)
                        else:
                            sess = self.engine.open_session(
                                timeout=self.session_timeout)
                        with state.lock:
                            state.sess = True
                    # a traced step gets a serve span on the client's
                    # wire trace (the decode analog of nnsq_serve — the
                    # loadgen report joins it by trace id)
                    from .obs import spans as _spans

                    tok = (_spans.span_begin(wtrace[0], wtrace[1])
                           if wtrace is not None and _spans.enabled
                           else None)
                    try:
                        if tensors[0].ndim == 2:
                            # rank-2 frame = a whole prompt: ONE compiled
                            # prefill pass builds the slot's KV state (an
                            # over-length prompt gets prefill's specific
                            # t_max error, not a generic shape complaint)
                            sess.prefill(tensors[0])
                        else:
                            sess.feed(tensors[0])
                        y = sess.get(timeout=self.session_timeout)
                    finally:
                        if tok is not None:
                            _spans.span_end(
                                tok, "nnsq_serve", "decode",
                                args={"client": client,
                                      "op": ("prefill"
                                             if tensors[0].ndim == 2
                                             else "step")})
                    reply_trace = wtrace
                    if tok is not None:
                        reply_trace = (wtrace[0], tok[0])
                    with state.lock:
                        send_tensors(conn, (y,), pts, trace=reply_trace)
                except OverloadError as exc:
                    # shed join: typed wire rejection, never a parked
                    # connection (the client raises QueryOverloadError)
                    try:
                        with state.lock:
                            send_error(conn, f"decode server: {exc}",
                                       code=exc.code)
                    except OSError:
                        pass
                    return
                except (ValueError, RuntimeError, TimeoutError) as exc:
                    # a dead/failed engine is a typed UNAVAILABLE (the
                    # stock client raises QueryUnavailableError and its
                    # stateful mode fails fast instead of replaying);
                    # geometry mistakes stay plain-text errors
                    code = ("UNAVAILABLE"
                            if isinstance(exc, RuntimeError)
                            and not isinstance(exc, ValueError) else "")
                    try:
                        with state.lock:
                            send_error(conn, f"decode server: {exc}",
                                       code=code)
                    except OSError:
                        return
                    if isinstance(exc, (RuntimeError, TimeoutError)):
                        return  # engine stopped / capacity timeout: drop
        finally:
            if sess is not None:
                sess.close()
            with self._conns_lock:
                self._conns.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass
