"""Remote ``tensor_repo``: cross-pipeline recurrence across processes.

The port of the JAX package's ``fleet/repo.py``.  The in-process
:class:`~nnstreamer_tpu_torch.elements.repo.TensorRepo` is a
process-global mailbox, the recurrence mechanism.  A cycle whose
``reposink`` and ``reposrc`` live in different processes, or a decode
session migrating between servers (``serving.py::DecodeServer``), needs
the mailbox itself to move out of process: :class:`TensorRepoServer` serves a repo's slots
over the NNSQ tensor framing (raw endian-explicit bytes, the same
untrusted-peer discipline as the query wire), and
:class:`RemoteTensorRepo` is a drop-in ``TensorRepo`` replacement whose
ops round-trip to it.  Activation is conf-driven: ``[fleet] repo_addr``
(``NNSTPU_FLEET_REPO_ADDR``) points every default-repo
``tensor_reposink``/``tensor_reposrc`` in the process at the server —
recurrence survives the process boundary with unchanged pipelines.

A :class:`TensorRepoServer` holds its slots' frames on its ``device`` (the
card by default; without one the constructor raises unless
``device="cpu"``), as a local repo holds a filter's outputs there, and
reads a frame to the host once to answer a ``GET``.
:class:`RemoteTensorRepo` hands back host tensors; ``tensor_reposrc`` moves
them to its own device.

Wire shape (one request frame -> one reply frame, per connection):

- request tensors[0] is an ``int64[3]`` header ``[op, slot, arg]``;
  ``SET`` appends the published frame's tensors and carries its pts in
  the NNSQ pts field; ``GET``'s ``arg`` is the poll timeout in ms.
- replies: ``SET``/``EOS``/``CLEAR``/``PREPARE``/``REOPEN``/
  ``TAKE_RESTORED`` answer ``int64[1]`` (the op's boolean); ``GET``
  answers the frame's tensors with its pts, or an EMPTY frame with pts
  ``-1`` (poll timeout) / ``-2`` (slot at EOS).

The blocking semantics live server-side (the slot condvars), so a
remote ``set_buffer`` still backpressures frame-for-frame and a remote
``get_buffer`` still wakes on publish — each client thread holds its own
connection (thread-local), so a sink blocked in ``SET`` never wedges the
src's ``GET``.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ..buffer import Frame
from ..device import resolve_device
from ..elements.query import recv_tensors, send_tensors, wire_tensor
from ..elements.repo import TensorRepo
from ..spec import TensorsSpec

OP_SET = 1
OP_GET = 2
OP_EOS = 3
OP_CLEAR = 4
OP_PREPARE = 5
OP_REOPEN = 6
OP_TAKE_RESTORED = 7

# ops safe to blindly re-send after a transport failure: applying them
# twice is indistinguishable from applying them once.  SET is NOT (a
# lost reply may mean the frame WAS published — re-sending double-
# publishes), GET is NOT (the reply may have carried the one frame),
# TAKE_RESTORED is NOT (it consumes a one-shot flag).
_IDEMPOTENT_OPS = frozenset({OP_EOS, OP_CLEAR, OP_PREPARE, OP_REOPEN})
_OP_NAMES = {OP_SET: "SET", OP_GET: "GET", OP_EOS: "EOS",
             OP_CLEAR: "CLEAR", OP_PREPARE: "PREPARE",
             OP_REOPEN: "REOPEN", OP_TAKE_RESTORED: "TAKE_RESTORED"}

_PTS_EMPTY = -1   # GET poll timeout: nothing published yet
_PTS_EOS = -2     # GET: the slot is at EOS


class RemoteRepoError(ConnectionError):
    """Typed failure of a remote ``tensor_repo`` op: the transport died
    and the op either could not be retried (non-idempotent — the
    server-side effect is unknowable) or kept failing through the retry
    budget.  A ``ConnectionError`` subclass so every existing caller's
    transport handling still applies; the typed class is what the
    migration/recovery paths branch on."""

    def __init__(self, op: int, slot: int, cause: BaseException):
        super().__init__(
            f"remote repo {_OP_NAMES.get(op, op)} on slot {slot} failed: "
            f"{cause}")
        self.op = op
        self.slot = slot
        self.cause = cause


class TensorRepoServer:
    """Serve a :class:`TensorRepo`'s slots over TCP (one daemon thread
    per connection; ``port=0`` binds ephemeral)."""

    def __init__(self, repo: Optional[TensorRepo] = None,
                 host: str = "127.0.0.1", port: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.repo = repo if repo is not None else TensorRepo()
        self.host, self.port = host, int(port)
        self._srv: Optional[socket.socket] = None
        self._accept: Optional[threading.Thread] = None
        self._running = False
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self.ops = 0  # observability

    def start(self) -> "TensorRepoServer":
        self._srv = socket.create_server((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._accept = threading.Thread(
            target=self._accept_loop, daemon=True, name="repo-server")
        self._accept.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._srv is not None:
            try:
                self._srv.shutdown(socket.SHUT_RDWR)  # wakes the accept
            except OSError:
                pass
            self._srv.close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # wakes its serve thread
            except OSError:
                pass
        if self._accept is not None:
            self._accept.join(timeout=10)

    def __enter__(self) -> "TensorRepoServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="repo-server-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.add(conn)
        try:
            with conn:
                self._serve_loop(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_loop(self, conn: socket.socket) -> None:
        while self._running:
            try:
                tensors, pts = recv_tensors(conn)
            except (ConnectionError, OSError):
                return
            try:
                reply = self._execute(tensors, pts)
                send_tensors(conn, reply[0], reply[1], fault_key="nnsq.repo")
            except (ConnectionError, OSError):
                return
            except Exception:  # noqa: BLE001 — one bad op, keep serving
                try:
                    send_tensors(conn, (np.array([0], np.int64),), -3)
                except OSError:
                    return

    def _execute(self, tensors, pts) -> Tuple[tuple, int]:
        head = np.asarray(tensors[0])
        op, slot, arg = int(head[0]), int(head[1]), int(head[2])
        self.ops += 1
        repo = self.repo
        ack = lambda v: ((np.array([int(v)], np.int64),), 0)  # noqa: E731
        if op == OP_SET:
            frame = Frame(tensors=tuple(wire_tensor(t, self.device)
                                        for t in tensors[1:]), pts=pts)
            spec = TensorsSpec.from_arrays(frame.tensors)
            ok = repo.set_buffer(slot, frame, spec,
                                 should_abort=lambda: not self._running)
            return ack(ok)
        if op == OP_GET:
            frame, _spec, eos = repo.get_buffer(
                slot, timeout=max(0.001, arg / 1e3))
            if eos:
                return ((), _PTS_EOS)
            if frame is None:
                return ((), _PTS_EMPTY)
            return (tuple(frame.tensors), frame.pts)
        if op == OP_EOS:
            repo.set_eos(slot)
            return ack(1)
        if op == OP_CLEAR:
            repo.clear(slot)
            return ack(1)
        if op == OP_PREPARE:
            repo.prepare(slot)
            return ack(1)
        if op == OP_REOPEN:
            repo.reopen(slot)
            return ack(1)
        if op == OP_TAKE_RESTORED:
            return ack(repo.take_restored(slot))
        raise ValueError(f"unknown repo op {op}")


class RemoteTensorRepo:
    """Drop-in ``TensorRepo`` whose slots live in a
    :class:`TensorRepoServer`.  Connections are per-thread (a blocked
    ``SET`` must not serialize against another element's ``GET``), with
    the same blocking contracts as the local repo:

    - :meth:`set_buffer` blocks until the previous frame is consumed
      (the server-side condvar), returning False at EOS;
    - :meth:`get_buffer` polls with ``timeout`` exactly like the local
      call shape, so ``tensor_reposrc``'s stop-flag loop is unchanged;
    - specs travel as the arrays themselves — the src side re-derives
      and intersects against its caps (geometry mismatches still fail).
    """

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 op_retries: int = 2, retry_backoff_s: float = 0.05):
        self.host, self.port = str(host), int(port)
        self.connect_timeout = float(connect_timeout)
        self.op_retries = int(op_retries)       # idempotent ops only
        self.retry_backoff_s = float(retry_backoff_s)
        self.retries_total = 0  # observability: re-sent idempotent ops
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._socks = []  # every LIVE dialed socket, for close()
        self._closed = False

    @classmethod
    def from_addr(cls, addr: str) -> "RemoteTensorRepo":
        host, _, port = addr.rpartition(":")
        return cls(host or "127.0.0.1", int(port))

    def _sock(self) -> socket.socket:
        if self._closed:
            raise RemoteRepoError(
                0, -1, RuntimeError("repo client closed"))
        sock = getattr(self._tls, "sock", None)
        if sock is None:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
            # generous read deadline: SET legitimately blocks until the
            # consumer side catches up (backpressure over the wire)
            sock.settimeout(600.0)
            self._tls.sock = sock
            with self._lock:
                if self._closed:
                    # lost the race with close(): never leak the fd
                    try:
                        sock.close()
                    except OSError:
                        pass
                    self._tls.sock = None
                    raise RemoteRepoError(
                        0, -1, RuntimeError("repo client closed"))
                self._socks.append(sock)
        return sock

    def _reset(self) -> None:
        sock = getattr(self._tls, "sock", None)
        self._tls.sock = None
        if sock is not None:
            with self._lock:
                # a dead socket leaves the tracked set immediately — the
                # live-socket list stays bounded across a churn soak
                # instead of accumulating every connection ever dialed
                try:
                    self._socks.remove(sock)
                except ValueError:
                    pass
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close every cached per-thread connection (idempotent).  The
        client is unusable afterwards — threads whose cached socket was
        just closed get a typed :class:`RemoteRepoError` instead of
        silently re-dialing (which would leak fds past the close)."""
        with self._lock:
            self._closed = True
            socks, self._socks = self._socks, []
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass

    def _op(self, op: int, slot: int, arg: int = 0,
            payload: tuple = (), pts: int = 0) -> Tuple[tuple, int]:
        """One request/reply round trip.  Idempotent ops retry with a
        fresh connection (bounded, backed off) — a fault-injected drop
        or truncation on the wire heals transparently; non-idempotent
        ops (``SET``/``GET``/``TAKE_RESTORED``) fail typed immediately,
        because the server-side effect of the lost exchange is
        unknowable and a blind re-send could double-publish or eat a
        frame."""
        attempts = 1 + (self.op_retries if op in _IDEMPOTENT_OPS else 0)
        for attempt in range(attempts):
            try:
                sock = self._sock()
                send_tensors(
                    sock,
                    (np.array([op, slot, arg], np.int64),) + tuple(payload),
                    pts, fault_key="nnsq.repo")
                return recv_tensors(sock)
            except RemoteRepoError:
                raise
            except (ConnectionError, OSError) as exc:
                self._reset()
                if attempt + 1 < attempts:
                    self.retries_total += 1
                    time.sleep(self.retry_backoff_s * (attempt + 1))
                    continue
                raise RemoteRepoError(op, slot, exc) from exc

    # -- the TensorRepo surface ---------------------------------------------

    def set_buffer(self, idx: int, frame: Frame, spec=None, poll: float = 0.1,
                   should_abort=None) -> bool:
        del spec, poll, should_abort  # blocking lives server-side
        outs, _ = self._op(OP_SET, idx, payload=tuple(frame.tensors),
                           pts=frame.pts)
        return bool(np.asarray(outs[0])[0])

    def get_buffer(self, idx: int, timeout: Optional[float] = None
                   ) -> Tuple[Optional[Frame], Optional[TensorsSpec], bool]:
        outs, pts = self._op(
            OP_GET, idx, arg=int((timeout if timeout is not None else 0.1)
                                 * 1000))
        if not outs:
            if pts == _PTS_EOS:
                return None, None, True
            return None, None, False
        frame = Frame(tensors=tuple(wire_tensor(o) for o in outs), pts=pts)
        return frame, TensorsSpec.from_arrays(frame.tensors), False

    def set_eos(self, idx: int) -> None:
        self._op(OP_EOS, idx)

    def clear(self, idx: int) -> None:
        self._op(OP_CLEAR, idx)

    def prepare(self, idx: int) -> None:
        self._op(OP_PREPARE, idx)

    def reopen(self, idx: int) -> None:
        self._op(OP_REOPEN, idx)

    def take_restored(self, idx: int) -> bool:
        outs, _ = self._op(OP_TAKE_RESTORED, idx)
        return bool(np.asarray(outs[0])[0])
