"""``tensor_query_client`` / ``QueryServer``: offload a filter over TCP.

The port of the JAX package's ``elements/query.py`` (the edge-offloading
pair of upstream nnstreamer 2.x, ``tensor_query_client`` /
``tensor_query_server``): ONE server process owns the card, and any number
of client pipelines (other processes, other hosts) stream frames to it and
get results back.

Wire protocol (version 1, little-endian), byte for byte the JAX package's:

    request :  MAGIC(4s=b"NNSQ") ver(u16) ntensors(u16) pts(i64)
               [trace_id(u64) span_id(u64) reserved(u32)]   — iff FLAG_TRACE
               [tenant_len(u16) tenant]                      — iff FLAG_TENANT
               [caps_len(u16) caps]                          — iff FLAG_CAPS
               [dtype_len(u16) dtype_str shape_rank(u16) shape(u32 × rank)
                payload_len(u64) payload] × ntensors
    reply   :  same framing; errors use ntensors=0xFFFF followed by
               msg_len(u32) + utf-8, a ``[CODE] `` prefix naming the typed
               error (:data:`ERROR_TYPES`).

The ``ver`` field is split ``flags | version``: the low byte is the
protocol version (1), the high byte carries the flag bits
(:data:`FLAG_TRACE`, :data:`FLAG_TENANT`, :data:`FLAG_CAPS`).  Senders emit
a flag only after the peer proved it speaks it (the server echoes the
trace and caps flags on flagged requests; the client's flagged negotiation
probe falls back to a plain probe when a strict version-1 peer drops it).
Raw C-order bytes, no pickle: safe against untrusted peers.

Payloads on the wire are numpy arrays: :func:`send_tensors` takes numpy
arrays or torch tensors, reading a tensor on the card to the host once
before it frames it, and :func:`recv_tensors` gives numpy arrays.  A
bfloat16 tensor goes out with the dtype string ``'<V2'``, the string the
JAX package's ``ml_dtypes`` bfloat16 arrays carry, and comes back as the
JAX package's receiver gives it back: a two-byte void (``V2``) array of its
bits.  The elements and servers here turn a ``V2`` payload into a
``torch.bfloat16`` tensor (:func:`wire_tensor`): it is the only dtype the
port sends as ``V2``.

The server runs any ``FilterBackend`` (framework + model, as
``tensor_filter`` takes them; ``fragment`` serves a launch-string chain,
``partition/fragment.py``).  A thread per connection; per-connection
threads share a bounded per-input-spec backend LRU under a lock, so
concurrent clients of different geometries never thrash one backend's
capture.  Received payloads go to the server's device on the receiving
thread and the backend's invoke runs under the lock; on the card a torch
backend replays the CUDA graph of its geometry on the device's default
stream, which every thread here shares, so a copy issued on a connection
thread and the replay that reads it stay in stream order.  The replay's
outputs are read to the host on the connection thread that sends the
reply: that read waits out the replay (``stats()``'s ``reply_read_s``).
Captures run with ``capture_error_mode="thread_local"``
(``backends/torch_backend.py::capture_calls``), so a connection thread's
copy does not invalidate another geometry's capture; :meth:`QueryServer.
warmup` captures every geometry a server will see before it accepts a
request.  With ``batch=K`` the server also coalesces same-geometry
requests from concurrent connections into one bucketed batched invoke.

With the dispatch mesh (``NNSTPU_MESH``, ``parallel/mesh.py``)
``max_batch`` is the cap a shard: a group is dispatched in chunks of
``max_batch × ndev`` rows, each padded to ``mesh_bucket`` (a multiple of
the mesh), so one dispatch spans every shard.
"""

from __future__ import annotations

import collections
import queue
import random
import socket
import struct
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import faults as _faults
from ..buffer import Frame
from ..device import resolve_device
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..obs import spans as _spans
from ..spec import TensorSpec, TensorsSpec, torch_dtype
from ..utils.props import parse_bool

MAGIC = b"NNSQ"
VERSION = 1
VER_MASK = 0x00FF   # low byte: protocol version
FLAG_TRACE = 0x0100  # high-byte flag: trace-context block follows the header
FLAG_TENANT = 0x0200  # high-byte flag: tenant-identity block follows trace
FLAG_CAPS = 0x0400   # high-byte flag: caps-string block follows tenant
_TRACE_BLOCK = struct.Struct("<QQI")  # trace_id, span_id, reserved
MAX_TENANT = 64  # tenant-identity byte cap (one label value, not a payload)
MAX_CAPS = 4096  # caps-string byte cap (a spec, not a payload)
ERR_SENTINEL = 0xFFFF
# the dtype string of a bfloat16 payload: ml_dtypes' bfloat16 ``dtype.str``
BF16_WIRE = b"<V2"


def mesh_devices() -> int:
    """The dispatch mesh's width for serving (1: unsharded dispatch)."""
    from ..parallel.mesh import dispatch_mesh_devices

    return dispatch_mesh_devices()


class QueryError(RuntimeError):
    """Base for typed server-side error frames."""

    code = ""


class QueryOverloadError(QueryError):
    """The server shed this request (admission limit / rate / queue)."""

    code = "OVERLOAD"


class QueryExpiredError(QueryOverloadError):
    """The request's deadline passed while it was queued."""

    code = "EXPIRED"


class QueryUnavailableError(QueryError):
    """The backend circuit breaker is open, or the server is draining."""

    code = "UNAVAILABLE"


class QueryTimeoutError(QueryError):
    """Client-side: no (complete) reply within ``request_timeout``.  When
    raised mid-frame the socket's read position is undefined: the caller
    must drop the connection, never reuse it (the retry path in
    :class:`TensorQueryClient` does exactly that)."""

    code = "TIMEOUT"


class QuerySessionBrokenError(QueryError):
    """A ``stateful=True`` decode session died mid-stream.  Raised
    client-side when the connection tears, and sent as the typed
    ``[SESSION]`` wire code by a draining decode server that must end a
    live session.  Stateful requests are never retried: the server's
    session may already have advanced, and a silent replay would corrupt
    the stream.  Reconnect and re-prefill to rebuild the session."""

    code = "SESSION"


class QueryMigratingError(QueryError):
    """The typed ``[MIGRATING]`` wire code: a live-migration operation on a
    decode session could not be honoured (snapshot refused, restore
    refused, session already moved away), without the session's state
    having advanced."""

    code = "MIGRATING"


class CapsNegotiationUnsupported(NegotiationError):
    """The typed cannot-split verdict: this client required caps
    negotiation over the wire (``require_caps=True``), but the peer proved
    it does not speak :data:`FLAG_CAPS`."""


# wire code -> client-side exception; unknown or absent codes stay a plain
# RuntimeError, as the JAX package's receiver raises them
ERROR_TYPES = {
    "OVERLOAD": QueryOverloadError,
    "EXPIRED": QueryExpiredError,
    "UNAVAILABLE": QueryUnavailableError,
    "TIMEOUT": QueryTimeoutError,
    "SESSION": QuerySessionBrokenError,
    "MIGRATING": QueryMigratingError,
}
# pts of the client's negotiation probe frame, distinct from NONE_TS (-1):
# a stateful server (serving.DecodeServer) answers a probe without
# advancing its session
PROBE_PTS = -2
# live-migration control sentinels on a decode connection: MIGRATE_PTS
# asks the serving end to snapshot this connection's session into a
# tensor_repo slot and release it; RESUME_PTS asks a fresh connection to
# restore a session from one
MIGRATE_PTS = -3
RESUME_PTS = -4


def pack_session_control(repo_addr: str, key: int,
                         deadline_ms: int = 10000) -> tuple:
    """The payload of a ``MIGRATE_PTS``/``RESUME_PTS`` control frame:
    which :class:`~nnstreamer_tpu_torch.fleet.repo.TensorRepoServer` slot
    the snapshot crosses through, and how long the op may take."""
    return (np.array([int(key), int(deadline_ms)], np.int64),
            np.frombuffer(repo_addr.encode("utf-8"), np.uint8))


def parse_session_control(tensors) -> Tuple[str, int, int]:
    """Inverse of :func:`pack_session_control` ->
    ``(repo_addr, key, deadline_ms)``; malformed frames raise."""
    if len(tensors) != 2:
        raise ValueError(
            f"session control frame takes 2 tensors, got {len(tensors)}")
    head = wire_array(tensors[0])
    addr_b = wire_array(tensors[1])
    if head.dtype != np.int64 or head.shape != (2,) or \
            addr_b.dtype != np.uint8 or addr_b.ndim != 1 or \
            addr_b.size > 256:
        raise ValueError("malformed session control frame")
    return (addr_b.tobytes().decode("utf-8"), int(head[0]), int(head[1]))


def wire_array(t) -> np.ndarray:
    """A payload as the numpy array whose bytes go on the wire: a tensor
    read to the host once (a no-op for a host tensor), a bfloat16 tensor
    as its bits in a two-byte void array."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    # np.asarray (not ascontiguousarray: it promotes 0-d to 1-d);
    # tobytes() emits C order whatever the memory layout
    return np.asarray(t)


def wire_tensor(a, device=None) -> torch.Tensor:
    """A received payload as a torch tensor (on ``device`` when given): a
    two-byte void payload is the bits of a bfloat16 tensor."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        if not a.flags.writeable:
            a = a.copy()
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            # a socket timeout (the client's request_timeout) is a typed
            # failure; mid-read it also means a torn frame: the stream
            # position is now unknowable (the caller must drop the socket)
            raise QueryTimeoutError(
                "timed out waiting for peer"
                + (f" mid-frame ({len(buf)}/{n} bytes of a read)"
                   if buf else "")) from None
        if not chunk:
            # the peer died mid-frame: a torn frame, not a clean close
            raise ConnectionError(
                f"peer closed mid-message ({len(buf)}/{n} bytes of a read)")
        buf.extend(chunk)
    return buf


def send_tensors(sock: socket.socket, tensors, pts: int,
                 trace: Optional[Tuple[int, int]] = None,
                 fault_key: str = "nnsq",
                 tenant: Optional[str] = None,
                 caps: Optional[str] = None) -> None:
    """``trace=(trace_id, span_id)`` sets :data:`FLAG_TRACE` and prepends
    the trace-context block; ``tenant="team-a"`` sets :data:`FLAG_TENANT`
    and appends the tenant block (truncated to :data:`MAX_TENANT` bytes);
    ``caps="other/tensors, ..."`` sets :data:`FLAG_CAPS` and appends the
    caps-string block (over :data:`MAX_CAPS` bytes raises: a truncated caps
    string would negotiate the wrong format).  ``fault_key`` names this
    send site to the chaos engine (``faults.on_wire``: ``socket_drop`` /
    ``truncate`` / ``corrupt``)."""
    ver = (VERSION | (FLAG_TRACE if trace is not None else 0)
           | (FLAG_TENANT if tenant else 0)
           | (FLAG_CAPS if caps else 0))
    parts = [MAGIC, struct.pack("<HHq", ver, len(tensors), pts)]
    if trace is not None:
        parts.append(_TRACE_BLOCK.pack(trace[0], trace[1], 0))
    if tenant:
        t = tenant.encode()[:MAX_TENANT]
        parts.append(struct.pack("<H", len(t)))
        parts.append(t)
    if caps:
        c = caps.encode()
        if len(c) > MAX_CAPS:
            raise ValueError(f"caps block {len(c)} bytes > {MAX_CAPS}")
        parts.append(struct.pack("<H", len(c)))
        parts.append(c)
    for t in tensors:
        bf16 = isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
        a = wire_array(t)
        dt = BF16_WIRE if bf16 else a.dtype.str.encode()  # endian-explicit
        parts.append(struct.pack("<H", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<H", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}I", *a.shape))
        parts.append(struct.pack("<Q", a.nbytes))
        parts.append(a.tobytes())
    data = b"".join(parts)
    if _faults.enabled:
        # may corrupt the payload, send a torn half-frame, or drop the
        # socket (raising ConnectionError to this sender)
        data = _faults.on_wire(sock, data, fault_key)
    sock.sendall(data)


def send_error(sock: socket.socket, msg: str, code: str = "") -> None:
    """Error frame on the ``ntensors=0xFFFF`` framing.  ``code`` (one of
    :data:`ERROR_TYPES`) rides as a ``[CODE] `` message prefix, so the
    receiver raises the matching typed exception."""
    if code:
        msg = f"[{code}] {msg}"
    m = msg.encode()[:4096]
    sock.sendall(MAGIC + struct.pack("<HHq", VERSION, ERR_SENTINEL, 0)
                 + struct.pack("<I", len(m)) + m)


MAX_TENSORS = 16  # the frame contract (NNS_TENSOR_SIZE_LIMIT)
MAX_RANK = 16
MAX_ERRMSG = 4096  # the cap send_error applies


def recv_tensors(sock: socket.socket) -> Tuple[Tuple[np.ndarray, ...], int]:
    """Receive one frame, discarding any trace/tenant/caps context."""
    tensors, pts, _, _, _ = recv_tensors_full(sock)
    return tensors, pts


def recv_tensors_ex(
    sock: socket.socket,
) -> Tuple[Tuple[np.ndarray, ...], int, Optional[Tuple[int, int]],
           Optional[str]]:
    """Receive one frame plus its trace and tenant, discarding any caps
    block."""
    tensors, pts, trace, tenant, _ = recv_tensors_full(sock)
    return tensors, pts, trace, tenant


def recv_tensors_full(
    sock: socket.socket,
) -> Tuple[Tuple[np.ndarray, ...], int, Optional[Tuple[int, int]],
           Optional[str], Optional[str]]:
    """Receive one frame plus all its optional wire metadata:
    ``(tensors, pts, (trace_id, span_id) | None, tenant | None,
    caps | None)``.  Takes the :data:`FLAG_TRACE`, :data:`FLAG_TENANT` and
    :data:`FLAG_CAPS` bits; any other flag or version rejects.  Declared
    sizes are checked before anything is allocated."""
    head = _recv_exact(sock, 4 + 12)
    if head[:4] != MAGIC:
        raise ConnectionError(f"bad magic {bytes(head[:4])!r}")
    ver, n, pts = struct.unpack("<HHq", head[4:])
    flags = ver & ~VER_MASK
    if (ver & VER_MASK) != VERSION or \
            (flags & ~(FLAG_TRACE | FLAG_TENANT | FLAG_CAPS)):
        raise ConnectionError(f"protocol version {ver} != {VERSION}")
    trace = None
    if flags & FLAG_TRACE:
        t_id, s_id, _reserved = _TRACE_BLOCK.unpack(
            _recv_exact(sock, _TRACE_BLOCK.size))
        trace = (t_id, s_id)
    tenant = None
    if flags & FLAG_TENANT:
        (tlen,) = struct.unpack("<H", _recv_exact(sock, 2))
        if tlen > MAX_TENANT:
            raise ConnectionError(f"tenant block {tlen} bytes > {MAX_TENANT}")
        tenant = _recv_exact(sock, tlen).decode("utf-8", "replace")
    caps = None
    if flags & FLAG_CAPS:
        (clen,) = struct.unpack("<H", _recv_exact(sock, 2))
        if clen > MAX_CAPS:
            raise ConnectionError(f"caps block {clen} bytes > {MAX_CAPS}")
        caps = _recv_exact(sock, clen).decode("utf-8", "replace")
    if n == ERR_SENTINEL:
        (mlen,) = struct.unpack("<I", _recv_exact(sock, 4))
        if mlen > MAX_ERRMSG:
            raise ConnectionError(f"oversized error frame ({mlen} bytes)")
        text = _recv_exact(sock, mlen).decode()
        cls: type = RuntimeError
        if text.startswith("[") and "]" in text:
            cls = ERROR_TYPES.get(text[1:text.index("]")], RuntimeError)
        raise cls(f"query server error: {text}")
    if n > MAX_TENSORS:
        raise ConnectionError(f"{n} tensors exceeds the {MAX_TENSORS} limit")
    out = []
    for _ in range(n):
        (dlen,) = struct.unpack("<H", _recv_exact(sock, 2))
        dtype = np.dtype(_recv_exact(sock, dlen).decode())
        (rank,) = struct.unpack("<H", _recv_exact(sock, 2))
        if rank > MAX_RANK:
            raise ConnectionError(f"rank {rank} exceeds {MAX_RANK}")
        shape = struct.unpack(f"<{rank}I", _recv_exact(sock, 4 * rank)) \
            if rank else ()
        (nbytes,) = struct.unpack("<Q", _recv_exact(sock, 8))
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if rank else dtype.itemsize
        if nbytes != want:
            # allocate only what the declared geometry justifies: a hostile
            # or corrupt peer must not drive this side into a huge buffer
            raise ConnectionError(
                f"payload {nbytes} bytes != shape {shape} × {dtype} ({want})")
        a = np.frombuffer(_recv_exact(sock, nbytes), dtype=dtype)
        out.append(a.reshape(shape))
    return tuple(out), pts, trace, tenant, caps


def _close_listener(srv: Optional[socket.socket]) -> None:
    """shutdown + close: close() alone leaves an accept thread blocked in
    the syscall, and a restart on the same port would see EADDRINUSE."""
    if srv is None:
        return
    try:
        srv.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.close()


class QueryServer:
    """Serve a filter backend over TCP.  ``with QueryServer(...) as s:`` or
    ``start()``/``stop()``; ``port=0`` picks a free port (``server.port``
    reads it back).  ``device`` (the card by default; without one the
    constructor raises unless ``device="cpu"``) is where received payloads
    go before the backend runs on them."""

    MAX_SPEC_BACKENDS = 8  # distinct concurrent input geometries served

    def __init__(
        self,
        framework: str,
        model=None,
        custom: str = "",
        host: str = "127.0.0.1",
        port: int = 0,
        batch: int = 0,
        batch_window_ms: float = 2.0,
        max_batch: int = 64,
        scheduler=None,
        device="cuda",
    ):
        """``batch=K`` (K ≥ 2) turns on **cross-client batching**: requests
        from concurrent connections with the same geometry coalesce into
        one batched invoke.  It needs a model with a polymorphic leading
        batch dim (the ``tensor_dynbatch`` contract); the dispatcher waits
        up to ``batch_window_ms`` for stragglers.  Each connection has at
        most one request in flight, so per-client ordering is inherent.
        ``max_batch`` caps the power-of-two padding bucket: a group with
        more rows is split into ``max_batch``-row sub-dispatches (the last
        one bucketed), so the set of captured geometries stays bounded.

        ``scheduler`` (a :class:`nnstreamer_tpu_torch.sched.Scheduler`)
        adds admission control: requests are admitted (or shed with a typed
        ``NNSQ`` error frame) at receipt, ready batch groups dispatch in
        the policy's order, deadline-expired requests drop before dispatch,
        and the circuit breaker turns a failing backend into immediate
        typed rejections.  ``scheduler=None`` consults conf (``[sched]
        policy``); with nothing configured there is no scheduler."""
        self.device = resolve_device(device)
        self._framework = framework
        self._model = model
        self._custom = custom
        # per-spec backends (a bounded LRU) under one lock: concurrent
        # clients with different geometries do not thrash one backend
        self._lock = threading.Lock()
        self._backends: "Dict[TensorsSpec, object]" = {}
        self.host, self.port = host, int(port)
        self._srv: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        # live connections and their send locks: drain() sends a typed
        # goodbye on an idle connection without interleaving bytes with a
        # concurrent reply
        self._conns: "Dict[socket.socket, QueryServer._ConnState]" = {}
        self._conns_lock = threading.Lock()
        self.batch = int(batch)
        if self.batch == 1 or self.batch < 0:
            raise ValueError("batch must be 0 (off) or >= 2")
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batch_window_s = float(batch_window_ms) / 1e3
        self._rq: "Optional[queue.Queue]" = None
        self._dispatch_thread: Optional[threading.Thread] = None
        self.batched_invokes = 0   # observability
        self.batched_frames = 0
        self.batched_splits = 0    # over-max_batch groups sub-dispatched
        # host seconds: the backend invokes (a replay's enqueue on the
        # card), and the reads of replies to the host (which wait out the
        # replay), with their counts
        self.invoke_s = 0.0
        self.invokes = 0
        self.reply_read_s = 0.0
        self.replies = 0
        self._stats_lock = threading.Lock()  # the connection threads add to these
        self._own_sched = False
        if scheduler is None:
            from ..sched import configured_scheduler

            scheduler = configured_scheduler("query_server")
            self._own_sched = scheduler is not None
        self.scheduler = scheduler
        # a fleet worker's serving scope (fleet/worker.py ServeScope): the
        # stages of a backend made here dispatch under it, so tracers
        # started on the scope see them
        self.obs_scope = None

    def _to_device(self, tensors) -> tuple:
        return tuple(wire_tensor(a, self.device) for a in tensors)

    def _backend_for(self, spec: TensorsSpec):
        """Backend configured for ``spec`` (the caller holds the lock)."""
        be = self._backends.pop(spec, None)
        if be is None:
            from ..backends.base import get_backend

            be = get_backend(self._framework)
            be.open(self._model, custom=self._custom)
            if self.obs_scope is not None and hasattr(be, "bind_scope"):
                be.bind_scope(self.obs_scope)
            be.reconfigure(spec)
            if len(self._backends) >= self.MAX_SPEC_BACKENDS:
                # true LRU: the first key is the coldest entry
                cold = next(iter(self._backends))
                self._backends.pop(cold).close()
        self._backends[spec] = be  # (re-)insert as most recent
        return be

    def _invoke(self, tensors) -> tuple:
        """Invoke the backend of ``tensors``' geometry (lock held by the
        caller), timed on the host."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs = self._backend_for(TensorsSpec.from_arrays(tensors)).invoke(tensors)
        self.invoke_s += time.perf_counter() - t0
        self.invokes += 1
        return tuple(outs)

    def _negotiate_caps(self, tensors, caps_str: str):
        """Serve a :data:`FLAG_CAPS` negotiation probe: reconfigure the
        backend with the client's caps (which carry the framerate the zeros
        frame cannot) and return ``(outs, reply_caps)``, zero frames of the
        negotiated output spec and its caps string.  Raises
        :class:`NegotiationError` when the declared caps do not match the
        probe frame or the backend rejects the spec."""
        in_spec = TensorsSpec.from_caps_string(caps_str)
        got = TensorsSpec.from_arrays(tensors)
        if in_spec.intersect(got) is None:
            raise NegotiationError(
                f"caps probe declares {in_spec} but carries {got}")
        with self._lock:
            if not self._running:
                raise RuntimeError("query server stopped")
            be = self._backend_for(got)
            out_spec = be.reconfigure(in_spec)
        if not out_spec.tensors_fixed:
            raise NegotiationError(
                f"backend {self._framework} negotiated a non-fixed output "
                f"spec {out_spec} for caps probe {in_spec}")
        outs = tuple(torch.zeros(tuple(t.shape), dtype=torch_dtype(t.dtype))
                     for t in out_spec.tensors)
        return outs, out_spec.to_caps_string()

    def start(self) -> "QueryServer":
        # a serving front door picks up NNSTPU_FAULTS as Pipeline.start does
        _faults.ensure_configured()
        self._srv = socket.create_server((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._running = True
        if self.batch:
            self._rq = queue.Queue()
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="query-server-batcher")
            self._dispatch_thread.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="query-server-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="query-server-conn").start()

    class _ConnState:
        """Per-connection send lock + in-flight flag for drain()."""

        __slots__ = ("lock", "busy")

        def __init__(self):
            self.lock = threading.Lock()
            self.busy = False

    def _serve(self, conn: socket.socket) -> None:
        from ..sched import BreakerOpenError, OverloadError

        try:
            peer = conn.getpeername()
            client, tenant = f"{peer[0]}:{peer[1]}", str(peer[0])
        except (OSError, IndexError):
            client = tenant = "unknown"
        state = self._ConnState()
        with self._conns_lock:
            self._conns[conn] = state
        try:
            with conn:
                self._serve_loop(conn, state, client, tenant,
                                 OverloadError, BreakerOpenError)
        finally:
            with self._conns_lock:
                self._conns.pop(conn, None)

    def _reply(self, conn, state, outs, pts, trace=None, caps=None) -> None:
        """Read the outputs to the host (once, timed: the read waits out the
        replay that writes them) and send them."""
        t0 = time.perf_counter()
        host = tuple(wire_array(o) for o in outs)
        with self._stats_lock:
            self.reply_read_s += time.perf_counter() - t0
            self.replies += 1
        with state.lock:
            send_tensors(conn, host, pts, trace=trace,
                         fault_key="nnsq.server", caps=caps)

    def _serve_loop(self, conn, state, client, peer_tenant,
                    OverloadError, BreakerOpenError) -> None:
        while self._running:
            try:
                wire, pts, wire_trace, wire_tenant, wire_caps = \
                    recv_tensors_full(conn)
            except (ConnectionError, OSError):
                return
            # a declared tenant identity wins over the peer-IP fallback
            tenant = wire_tenant or peer_tenant
            with state.lock:
                if self._draining:
                    # a request racing the drain: a typed goodbye
                    try:
                        send_error(conn, "server draining",
                                   code="UNAVAILABLE")
                    except OSError:
                        pass
                    return
                state.busy = True
            # a flagged request attaches this serve span to the client's
            # trace; replies echo the flag only when the request carried it
            tok = (_spans.span_begin(wire_trace[0], wire_trace[1])
                   if wire_trace is not None and _spans.enabled else None)
            item = None
            try:
                try:
                    tensors = tuple(wire_tensor(a) for a in wire)
                    if self.scheduler is not None:
                        t0 = tensors[0] if tensors else None
                        cost = (int(t0.shape[0])
                                if t0 is not None and t0.dim() >= 1 else 1)
                        # may raise OverloadError: shed with a typed frame,
                        # keep the connection serving
                        item = self.scheduler.admit(
                            client, tenant=tenant, cost=max(1, cost))
                    reply_caps = None
                    if wire_caps is not None and pts == PROBE_PTS:
                        outs, reply_caps = self._negotiate_caps(
                            tensors, wire_caps)
                    elif self.batch:
                        outs = self._invoke_batched(
                            tensors, item,
                            trace=((wire_trace[0], tok[0])
                                   if tok is not None else None))
                    else:
                        outs = self._invoke_direct(tensors, tenant=tenant)
                    reply_trace = wire_trace
                    if tok is not None:
                        reply_trace = (wire_trace[0], tok[0])
                        # the serve span is recorded before the reply bytes
                        # go out: a client that reads this recorder as its
                        # recv returns already sees it
                        _spans.span_end(tok, "nnsq_serve", "query",
                                        args={"client": client})
                        tok = None
                    self._reply(conn, state, outs, pts, trace=reply_trace,
                                caps=reply_caps)
                finally:
                    if item is not None:
                        self.scheduler.release(item)
                    if tok is not None:  # error path: close the span
                        _spans.span_end(tok, "nnsq_serve", "query",
                                        args={"client": client})
            except (OverloadError, BreakerOpenError) as exc:
                try:
                    with state.lock:
                        send_error(conn, str(exc), code=exc.code)
                except OSError:
                    return
            except Exception as exc:  # noqa: BLE001 — report, keep serving
                try:
                    with state.lock:
                        # killed or stopped mid-dispatch: a typed goodbye
                        send_error(conn, repr(exc),
                                   code="" if self._running else "UNAVAILABLE")
                except OSError:
                    return
            finally:
                state.busy = False
            if self._draining:
                # the in-flight dispatch drained; now say goodbye typed
                with state.lock:
                    try:
                        send_error(conn, "server draining",
                                   code="UNAVAILABLE")
                    except OSError:
                        pass
                return

    def _invoke_direct(self, tensors, tenant: str = ""):
        """Unbatched invoke (breaker-gated when a scheduler is attached)."""

        def run():
            t0 = _spans.now_ns() if _spans.enabled else 0
            if _faults.enabled:
                # chaos "backend_invoke" inside the measured window: an
                # invoke_delay simulates a slow device
                _faults.maybe_invoke("query_server.filter")
            xs = self._to_device(tensors)
            with self._lock:
                if not self._running:
                    raise RuntimeError("query server stopped")
                outs = self._invoke(xs)
            if t0:
                _spans.record_span(
                    "device_invoke", t0, _spans.now_ns() - t0, cat="device",
                    args={"framework": self._framework})
            return outs

        if self.scheduler is not None:
            return self.scheduler.invoke(run, tenant=tenant)
        return run()

    # -- cross-client batching ---------------------------------------------

    class _Pending:
        __slots__ = ("spec", "tensors", "event", "outs", "error", "item",
                     "trace")

        def __init__(self, spec, tensors, item=None, trace=None):
            self.spec = spec
            self.tensors = tensors
            self.event = threading.Event()
            self.outs = None
            self.error = None
            self.item = item  # SchedItem when a scheduler is attached
            self.trace = trace  # (trace_id, span_id) from the wire, if any

    def _invoke_batched(self, tensors, item=None, trace=None):
        """Enqueue for the dispatcher; block until this request's rows of
        the batched result arrive.  The wait polls ``_running`` so a request
        racing ``stop()`` errors out instead of hanging its thread."""
        if not self._running:
            raise RuntimeError("query server stopped")
        req = self._Pending(TensorsSpec.from_arrays(tensors), tensors, item,
                            trace)
        self._rq.put(req)
        while not req.event.wait(0.5):
            if not self._running:
                raise RuntimeError("query server stopped")
        if req.error is not None:
            raise req.error
        return req.outs

    def _dispatch_loop(self) -> None:
        """One pending group per spec, each with its own window deadline:
        mixed-geometry traffic progresses independently.  With a scheduler
        attached, a ready group (full, or past its window) becomes one
        schedulable item and the policy decides which ready group runs
        next."""
        sch = self.scheduler
        pending: Dict[TensorsSpec, list] = {}  # spec -> [deadline, group]
        while self._running:
            timeout = 0.1
            if pending:
                nearest = min(d for d, _ in pending.values())
                timeout = min(timeout, max(0.001, nearest - time.monotonic()))
            if sch is not None and sch.queued():
                timeout = 0  # ready groups waiting: drain, don't block
            try:
                req = (self._rq.get(timeout=timeout) if timeout > 0
                       else self._rq.get_nowait())
            except queue.Empty:
                req = None
            if req is not None:
                entry = pending.get(req.spec)
                if entry is None:
                    pending[req.spec] = [
                        time.monotonic() + self.batch_window_s, [req]]
                else:
                    entry[1].append(req)
                    if len(entry[1]) >= self.batch:
                        del pending[req.spec]
                        self._group_ready(entry[1])
            now = time.monotonic()
            for spec in [s for s, (d, _) in pending.items() if d <= now]:
                self._group_ready(pending.pop(spec)[1])
            if sch is not None:
                gitem = sch.dequeue()
                if gitem is not None:
                    self._dispatch_group(gitem.payload)
        # exit: every still-pending waiter must wake
        for _, group in pending.values():
            for g in group:
                g.error = RuntimeError("query server stopped")
                g.event.set()
        while sch is not None:
            gitem = sch.dequeue()
            if gitem is None:
                break
            for g in gitem.payload:
                g.error = RuntimeError("query server stopped")
                g.event.set()

    def _group_ready(self, group) -> None:
        """A coalesced group is ready: dispatch inline (no scheduler) or
        hand it to the policy as one schedulable item."""
        sch = self.scheduler
        if sch is None:
            self._dispatch_group(group)
            return
        from ..sched import SchedItem

        members = [g.item for g in group if g.item is not None]
        first = members[0] if members else None
        deadlines = [m.deadline for m in members if m.deadline is not None]
        sch.enqueue(SchedItem(
            first.client if first else "unknown",
            cost=sum(m.cost for m in members) or 1.0,
            priority=max((m.priority for m in members), default=0),
            deadline=min(deadlines) if deadlines else None,
            enqueue_t=min((m.enqueue_t for m in members),
                          default=time.monotonic()),
            payload=group,
            tenant=first.tenant if first else None,
        ))

    def _dispatch_group(self, group) -> None:
        sch = self.scheduler
        if sch is not None:
            # deadline-expired members drop before dispatch, typed
            now = time.monotonic()
            live = []
            for g in group:
                if g.item is not None and g.item.expired(now):
                    g.error = sch.expired_error(g.item)
                    g.event.set()
                else:
                    live.append(g)
            group = live
            if not group:
                return
            for g in group:
                if g.item is not None:
                    sch.observe_wait(g.item, now, trace=g.trace)
        n_tensors = len(group[0].tensors)
        try:
            # requests carry the batch dim ((k_i, ...) frames): concatenate
            # along axis 0 and split the result back by row offsets.  Rows
            # pad up to a power of two (repeating the last row), so the
            # backend captures one graph per bucket: tensor_dynbatch's rule
            rows = []
            for g in group:
                r = None
                for t in g.tensors:
                    if t.dim() < 1:
                        raise ValueError(
                            "batched query serving needs frames with a "
                            "leading batch dim (got a rank-0 tensor)")
                    if r is None:
                        r = t.shape[0]
                    elif t.shape[0] != r:
                        raise ValueError(
                            "batched query serving needs every tensor in a "
                            f"frame to share the leading batch dim (got "
                            f"{t.shape[0]} vs {r})")
                rows.append(r)
            total = sum(rows)
            # max_batch is the cap a shard of the dispatch mesh: chunks of
            # max_batch x ndev rows, buckets the mesh divides (mesh_bucket)
            from .dynbatch import mesh_bucket

            ndev = mesh_devices()
            eff_max = self.max_batch * ndev
            cat = [torch.cat([g.tensors[i] for g in group], dim=0)
                   for i in range(n_tensors)]
            out_parts: Optional[list] = None
            for start in range(0, total, eff_max):
                n = min(eff_max, total - start)
                b = mesh_bucket(n, self.max_batch, ndev)
                chunk = []
                for i in range(n_tensors):
                    part = cat[i][start:start + n]
                    if b > n:
                        part = torch.cat(
                            [part, part[-1:].expand(b - n, *part.shape[1:])],
                            dim=0)
                    chunk.append(part)

                def run(chunk=chunk):
                    t0 = _spans.now_ns() if _spans.enabled else 0
                    if _faults.enabled:
                        _faults.maybe_invoke("query_server.filter")
                    xs = self._to_device(chunk)
                    with self._lock:
                        if not self._running:
                            raise RuntimeError("server stopping")
                        outs_ = self._invoke(xs)
                    if t0:
                        # one invoke for many client traces: the shared
                        # device leg is recorded on every member's trace
                        dur = _spans.now_ns() - t0
                        traced = [g.trace for g in group
                                  if g.trace is not None] or [None]
                        for i_t, tr in enumerate(traced):
                            _spans.record_span(
                                "device_invoke", t0, dur,
                                cat="device", trace=tr,
                                args={"framework": self._framework,
                                      "rows": int(chunk[0].shape[0]),
                                      "coalesced": len(traced),
                                      "shared": i_t > 0})
                    return outs_

                g_tenant = next((g.item.tenant for g in group
                                 if g.item is not None
                                 and g.item.tenant), "") or ""
                outs = (sch.invoke(run, tenant=g_tenant)
                        if sch is not None else run())
                self.batched_invokes += 1
                if out_parts is None:
                    out_parts = [[] for _ in outs]
                for j, o in enumerate(outs):
                    out_parts[j].append(o[:n])
            if total > eff_max:
                self.batched_splits += 1
            full = [torch.cat(ps, dim=0) if len(ps) > 1 else ps[0]
                    for ps in out_parts]
            self.batched_frames += total
            off = 0
            for g, r in zip(group, rows):
                g.outs = [o[off:off + r] for o in full]
                g.event.set()
                off += r
        except Exception as exc:  # noqa: BLE001 — every waiter must wake
            for g in group:
                g.error = exc
                g.event.set()

    def warmup(self, row_spec: TensorsSpec) -> dict:
        """Capture ahead: build the per-spec backend (its capture, on the
        card) of every geometry this server can dispatch for ``row_spec``,
        the spec of one request (no leading batch dim with batching on).
        With cross-client batching that is the pow-2 bucket ladder up to
        ``max_batch`` (times the dispatch mesh's width); an unbatched
        server warms ``row_spec`` itself.
        Returns ``graph/warmup.execute``'s report."""
        from ..graph.warmup import execute

        def warm(spec: TensorsSpec):
            with self._lock:
                if not self._running:
                    raise RuntimeError("query server stopped")
                self._backend_for(spec)

        items = []
        if self.batch:
            ndev = mesh_devices()
            b = 1
            while b <= self.max_batch:
                spec = TensorsSpec(tensors=tuple(
                    TensorSpec(dtype=t.dtype, shape=(b * ndev,) + tuple(t.shape))
                    for t in row_spec.tensors))
                items.append(("query_server", f"bucket{b * ndev}",
                              lambda s=spec: warm(s)))
                b <<= 1
        else:
            items.append(("query_server", "spec", lambda: warm(row_spec)))
        return execute(items, name="query_server")

    def stats(self) -> dict:
        """Server observability snapshot (thread-safe)."""
        out = {
            "running": self._running,
            "batch": self.batch,
            "batched_invokes": self.batched_invokes,
            "batched_frames": self.batched_frames,
            "batched_splits": self.batched_splits,
            "max_batch": self.max_batch,
            "mesh_devices": mesh_devices(),
            "spec_backends": len(self._backends),
            "invokes": self.invokes,
            "invoke_s": self.invoke_s,
            "replies": self.replies,
            "reply_read_s": self.reply_read_s,
            "graphs": self._graph_counts(),
        }
        if self.scheduler is not None:
            out["sched"] = self.scheduler.stats()
        return out

    def _graph_counts(self) -> dict:
        """Captures and CUDA-graph replays over the per-spec backends (a
        torch backend's own counts, or a fragment's over its filters)."""
        out = {"captures": 0, "replays": 0}
        for be in list(self._backends.values()):
            if hasattr(be, "graph_counts"):
                counts = be.graph_counts()
            else:
                counts = getattr(be, "stats", None)
                if not isinstance(counts, dict):
                    continue
            for k in out:
                out[k] += int(counts.get(k, 0))
        return out

    def drain(self, timeout: float = 10.0) -> bool:
        """Graceful shutdown: stop accepting, let in-flight dispatches
        finish and deliver their replies, and send a typed
        ``[UNAVAILABLE]`` error frame to idle connections before closing
        them.  Returns True when every connection closed before the
        deadline; always ends in :meth:`stop`."""
        self._draining = True
        _close_listener(self._srv)  # no new connections
        with self._conns_lock:
            conns = list(self._conns.items())
        for conn, st in conns:
            with st.lock:
                if st.busy:
                    continue  # in flight: its serve loop says goodbye
                try:
                    send_error(conn, "server draining", code="UNAVAILABLE")
                except OSError:
                    pass
                try:
                    conn.shutdown(socket.SHUT_RDWR)  # wake its recv
                except OSError:
                    pass
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._conns_lock:
                if not self._conns:
                    break
            time.sleep(0.01)
        with self._conns_lock:
            clean = not self._conns
        self.stop()
        return clean

    def kill(self) -> None:
        """Crash simulation: tear every socket down mid-flight with no
        courtesy error frames, as a killed process would."""
        self._running = False
        _close_listener(self._srv)
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
        self.stop()

    def stop(self) -> None:
        self._running = False
        _close_listener(self._srv)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # wakes its serve thread
            except OSError:
                pass
        if self._rq is not None:
            # wake every queued waiter
            while True:
                try:
                    g = self._rq.get_nowait()
                except queue.Empty:
                    break
                g.error = RuntimeError("query server stopped")
                g.event.set()
        for th in (self._accept_thread, self._dispatch_thread):
            if th is not None and th is not threading.current_thread():
                th.join(timeout=10)
        with self._lock:  # never close a backend under an in-flight invoke
            for be in self._backends.values():
                be.close()
            self._backends.clear()
        if self._own_sched and self.scheduler is not None:
            # conf-activated scheduler: this server owns its collector
            self.scheduler.close()
            self._own_sched = False

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@register_element("tensor_query_client")
class TensorQueryClient(Node):
    """Replace an in-process ``tensor_filter`` with a remote one: each
    frame's tensors go to the server, the reply frame flows downstream
    (pts kept; one round trip a frame: put a ``queue`` upstream to pipeline
    the wire like any other blocking hop).  Replies land on ``device``,
    the card by default (the constructor raises without one unless
    ``device="cpu"``), where an in-process filter would leave its outputs."""

    # every process() is a blocking round trip: under dispatcher lanes the
    # segment holding this node runs on the helper pool
    LANE_BLOCKING = True

    def __init__(
        self,
        name: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        connect_timeout: float = 10.0,
        out_spec=None,
        request_timeout: Optional[float] = 60.0,
        retries: int = 0,
        retry_backoff_ms: float = 50.0,
        retry_backoff_cap_ms: float = 2000.0,
        retry_jitter: float = 0.25,
        stateful: bool = False,
        tenant: str = "",
        caps: bool = False,
        require_caps: bool = False,
        edge: str = "",
        device="cuda",
    ):
        """``request_timeout`` bounds every blocking read after connect
        (``None`` blocks forever); expiry raises the typed
        :class:`QueryTimeoutError` and drops the socket.

        ``retries=N`` re-sends a failed request up to N more times with
        exponential backoff (doubling from ``retry_backoff_ms`` to the cap,
        plus up to ``retry_jitter`` relative jitter) on a fresh connection
        each time.  Retries apply only to connection-level failures (drop,
        torn frame, timeout): typed server rejections always surface.

        ``stateful=True`` marks a decode session
        (:class:`nnstreamer_tpu_torch.serving.DecodeServer`): a mid-stream
        connection failure raises :class:`QuerySessionBrokenError` at once,
        never retrying.

        ``tenant="team-a"`` declares this link's tenant on the wire
        (:data:`FLAG_TENANT`), once the negotiation probe proved the peer
        speaks header flags.  ``caps=True`` carries caps negotiation over
        the wire (:data:`FLAG_CAPS`): the probe ships the upstream spec as
        a caps string (framerate included) and the reply's caps become
        this link's src spec; a peer that drops the flagged probe falls
        back to the plain probe, unless ``require_caps=True``, which raises
        :class:`CapsNegotiationUnsupported` instead.  ``edge="edge0"`` tags
        the per-frame ``nnsq_rtt`` spans with a partition edge.
        ``out_spec`` (a ``TensorsSpec`` or a caps string) skips the
        probe."""
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.device = resolve_device(device)
        self.host, self.port = str(host), int(port)
        self.connect_timeout = float(connect_timeout)
        if isinstance(out_spec, str):
            out_spec = TensorsSpec.from_caps_string(out_spec)
        self.out_spec = out_spec  # optional static declaration
        self.request_timeout = (float(request_timeout)
                                if request_timeout else None)
        self.retries = int(retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_cap_ms = float(retry_backoff_cap_ms)
        self.retry_jitter = float(retry_jitter)
        self.stateful = parse_bool(stateful, name="stateful")
        self.tenant = str(tenant)
        self.caps = parse_bool(caps, name="caps")
        self.require_caps = parse_bool(require_caps, name="require_caps")
        self.edge = str(edge)
        self.retries_total = 0    # observability: re-sent requests
        self.reconnects = 0       # sockets dropped and re-dialed
        # the host nanoseconds of the last round trips that succeeded
        self.rtt_ns: "collections.deque" = collections.deque(maxlen=4096)
        # a deterministic jitter stream per element (crc32: str hash() is
        # salted per process)
        self._rng = random.Random(zlib.crc32(self.name.encode()))
        self._sock: Optional[socket.socket] = None
        self._interrupted = False
        # does the peer speak the header flags? learned by the negotiation
        # probe (False until proven: old servers only see version-1 bytes)
        self._trace_wire = False
        self._caps_wire = False  # did the peer answer the caps probe?

    def _connect(self) -> socket.socket:
        if self._interrupted:
            # a closed socket must not silently reconnect
            raise ConnectionError(f"{self.name}: interrupted")
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
            self._sock.settimeout(self.request_timeout)
        return self._sock

    def start(self) -> None:
        self._interrupted = False  # a restarted pipeline reconnects fresh
        super().start()

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if self.out_spec is not None:
            return {"src": self.out_spec}
        if not spec.tensors_fixed:
            raise NegotiationError(
                f"{self.name}: remote negotiation needs fixed input tensors "
                f"(got {spec}); pass out_spec= for polymorphic streams")
        # probe the server with a zero frame to learn the output spec.  A
        # declared tenant, caps negotiation or span tracing flag the first
        # probe (the capability check): a strict version-1 server drops the
        # connection, and the client re-probes plain
        zeros = tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype))
                      for t in spec.tensors)
        outs = reply_caps = None
        first_exc: Optional[BaseException] = None
        want_ext = _spans.enabled or bool(self.tenant) or self.caps
        try:
            outs, reply_caps = self._probe(zeros, spec, want_ext=want_ext)
        except (OSError, RuntimeError) as exc:
            first_exc = exc
            if want_ext:
                self._reset_socket()
                try:
                    outs, reply_caps = self._probe(zeros, spec,
                                                   want_ext=False)
                except (OSError, RuntimeError):
                    outs = None
        if outs is None:
            raise NegotiationError(
                f"{self.name}: query server at {self.host}:{self.port} "
                f"failed the negotiation probe: {first_exc}") from first_exc
        if reply_caps is not None:
            out = TensorsSpec.from_caps_string(reply_caps)
            if (out.rate is None or not out.rate) and spec.rate:
                out = TensorsSpec(tensors=out.tensors, rate=spec.rate)
            return {"src": out}
        if self.caps and self.require_caps:
            raise CapsNegotiationUnsupported(
                f"{self.name}: query server at {self.host}:{self.port} "
                "does not speak FLAG_CAPS caps negotiation "
                "(require_caps=true): cannot split the pipeline here")
        return {"src": TensorsSpec.from_arrays(
            [wire_tensor(o) for o in outs], rate=spec.rate)}

    def _probe(self, zeros, spec: TensorsSpec, want_ext: bool):
        sock = self._connect()
        trace = (_spans.new_trace_id(), 0) if want_ext else None
        caps_str = (spec.to_caps_string()
                    if (want_ext and self.caps) else None)
        send_tensors(sock, zeros, PROBE_PTS, trace=trace,
                     tenant=self.tenant if want_ext else None,
                     caps=caps_str)
        outs, _, reply_trace, _, reply_caps = recv_tensors_full(sock)
        self._trace_wire = reply_trace is not None
        self._caps_wire = reply_caps is not None
        return outs, reply_caps

    def _reset_socket(self) -> None:
        """Drop the socket for a reconnect (not interrupt(): the negotiation
        fallback must be able to dial again)."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def process(self, pad: Pad, frame: Frame):
        del pad
        attempts = 1 if self.stateful else 1 + max(0, self.retries)
        delay_s = self.retry_backoff_ms / 1e3
        for attempt in range(attempts):
            try:
                t0 = time.perf_counter_ns()
                out = self._roundtrip(frame)
                self.rtt_ns.append(time.perf_counter_ns() - t0)
                return out
            except (QueryTimeoutError, ConnectionError, OSError) as exc:
                # the stream position is unknowable after a torn frame or
                # a timeout: never reuse the socket
                self._reset_socket()
                self.reconnects += 1
                if self._interrupted:
                    raise
                if self.stateful:
                    raise QuerySessionBrokenError(
                        f"{self.name}: decode session to "
                        f"{self.host}:{self.port} broken mid-stream "
                        f"({exc}); stateful requests are never retried — "
                        "reconnect and re-prefill to rebuild the session"
                    ) from exc
                if attempt + 1 >= attempts:
                    raise
                self.retries_total += 1
                # capped exponential backoff + jitter
                time.sleep(delay_s *
                           (1.0 + self.retry_jitter * self._rng.random()))
                delay_s = min(delay_s * 2, self.retry_backoff_cap_ms / 1e3)

    def _outputs(self, frame: Frame, outs, pts) -> Frame:
        return frame.with_tensors(
            tuple(wire_tensor(o, self.device) for o in outs), pts=pts)

    def _roundtrip(self, frame: Frame) -> Frame:
        """One send/recv attempt on the current (or a fresh) socket."""
        sock = self._connect()
        tenant = self.tenant if (self.tenant and self._trace_wire) else None
        ctx = (frame.meta.get(_spans.META_KEY)
               if self._trace_wire and _spans.enabled else None)
        if ctx is None:
            send_tensors(sock, frame.tensors, frame.pts,
                         fault_key="nnsq.client", tenant=tenant)
            outs, pts = recv_tensors(sock)
            return self._outputs(frame, outs, pts)
        # a traced round trip: the rtt span rides the frame's trace, its id
        # goes out as the server-side parent, and the reply names the
        # server's serve span
        tok = _spans.span_begin(ctx[0], ctx[1])
        args = {"server": f"{self.host}:{self.port}"}
        if self.edge:
            args["edge"] = self.edge
        try:
            send_tensors(sock, frame.tensors, frame.pts,
                         trace=(ctx[0], tok[0]), fault_key="nnsq.client",
                         tenant=tenant)
            outs, pts, reply_trace, _ = recv_tensors_ex(sock)
            if reply_trace is not None:
                args["server_span"] = f"{reply_trace[1]:x}"
        finally:
            _spans.span_end(tok, "nnsq_rtt", "query", args=args)
        return self._outputs(frame, outs, pts)

    def interrupt(self) -> None:
        """Unblock a worker stuck in recv on a dead or wedged server:
        ``Pipeline.stop()`` interrupts nodes before joining threads, and
        shutting the socket down makes the blocked recv raise at once."""
        self._interrupted = True
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        self.interrupt()
        super().stop()
