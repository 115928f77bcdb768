"""The port's NNSQ wire, ``QueryServer`` and ``tensor_query_client`` against
the JAX package's.

Case for case with the JAX package's ``tests/test_query.py`` (the protocol,
the offload pipelines, cross-client batching, the batch cap and its split),
its ``nnsq_send`` fault cases (``tests/test_faults.py``), the end-to-end
trace over NNSQ (``tests/test_spans.py``) and the ``fragment`` backend with
caps negotiation (``tests/test_partition.py``), on the CPU (``device="cpu"``
everywhere).  Golden rule of the reference: remote results equal the
in-process filter's exactly; the transport adds no numerics.

Cross-package parity: the port's ``send_tensors`` writes the reference's
bytes for every dtype the port's spec knows and each flag block, and each
side reads the other's; a port client against the reference's server and a
reference client against the port's server reply with the reference's
numbers (MobileNet-v2 0.35 at 32x32 with the int8 head, the weights carried
by ``params_from_jax``); slice 1's ``split_launch`` halves run in the port
equal to the in-process pipeline; and a bfloat16 payload crosses as the
reference sends it (``'<V2'``) and comes back as the reference's receiver
gives it (a ``V2`` array), which the port's elements read as bfloat16.
Every socket binds 127.0.0.1:0 and every blocking read has a timeout.
"""

import socket
import struct
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import ml_dtypes

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.jax_backend import JaxModel
from nnstreamer_tpu.elements import query as jq
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu_torch import faults
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements import query as tq
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.query import (
    FLAG_CAPS,
    PROBE_PTS,
    CapsNegotiationUnsupported,
    QueryServer,
    QuerySessionBrokenError,
    TensorQueryClient,
    recv_tensors,
    recv_tensors_ex,
    send_error,
    send_tensors,
)
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.node import NegotiationError
from nnstreamer_tpu_torch.graph.parse import ParseError, split_launch
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.obs import spans
from nnstreamer_tpu_torch.partition import FragmentBackend
from nnstreamer_tpu_torch.spec import BFLOAT16, TensorSpec, TensorsSpec

F32 = np.float32
VEC4 = TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,)))
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
SIZE, CLASSES = 32, 10


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.deactivate()
    spans.disable()
    spans.reset()


def model_of(fn, shape=(4,), dtype=F32):
    return TorchModel(apply=lambda p, x: fn(x), device="cpu",
                      input_spec=None if shape is None else TensorsSpec.of(
                          TensorSpec(dtype=dtype, shape=shape)))


def double_model(shape=(4,)):
    return model_of(lambda x: x * 2.0, shape)


def server(model, **kw):
    return QueryServer(framework="torch", model=model, device="cpu", **kw)


def client(**kw):
    kw.setdefault("request_timeout", 30.0)
    return TensorQueryClient(device="cpu", **kw)


def run_client(port, data, **kw):
    got = []
    p = tnns.Pipeline()
    src = p.add(DataSrc(data=data))
    cli = p.add(client(port=port, **kw))
    sink = p.add(TensorSink())
    sink.connect("new-data", got.append)
    p.link_chain(src, cli, sink)
    p.run(timeout=120)
    return got, cli


def pair():
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    return a, b


class TestProtocol:
    def test_roundtrip_multi_tensor(self):
        a, b = pair()
        try:
            t0 = np.arange(12, dtype=np.float32).reshape(3, 4)
            t1 = torch.tensor([7], dtype=torch.int64)
            t2 = np.float32(3.5)  # rank-0
            send_tensors(a, (t0, t1, t2), pts=123)
            out, pts = recv_tensors(b)
            assert pts == 123 and len(out) == 3
            np.testing.assert_array_equal(out[0], t0)
            np.testing.assert_array_equal(out[1], [7])
            assert out[2].shape == () and float(out[2]) == 3.5
        finally:
            a.close(); b.close()

    def test_error_frame_raises(self):
        a, b = pair()
        try:
            send_error(a, "backend exploded")
            with pytest.raises(RuntimeError, match="backend exploded"):
                recv_tensors(b)
        finally:
            a.close(); b.close()

    def test_bad_magic_rejected(self):
        a, b = pair()
        try:
            a.sendall(b"EVIL" + b"\x00" * 12)
            with pytest.raises(ConnectionError, match="magic"):
                recv_tensors(b)
        finally:
            a.close(); b.close()


class _Capture:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.data = b""

    def sendall(self, data):
        self.data += bytes(data)


WIRE_DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64", "uint64",
               "float16", "float32", "float64", "bfloat16"]
FLAG_BLOCKS = {
    "plain": {},
    "trace": dict(trace=(0x1234_5678_9ABC, 42)),
    "tenant": dict(tenant="team-a"),
    "caps": dict(caps="other/tensors,num_tensors=1,dimensions=4:3,types=float32"),
    "all": dict(trace=(7, 9), tenant="t" * 80,
                caps="other/tensors,num_tensors=1,dimensions=4:3,types=float32"),
}


def _payloads(name, shape=(3, 4)):
    """The same values as (the reference's array, the port's tensor)."""
    rng = np.random.default_rng(hash(name) % 1000)
    x = (rng.standard_normal(shape) * 50).astype(np.float32)
    if name == "bfloat16":
        ref = x.astype(ml_dtypes.bfloat16)
        return ref, torch.from_numpy(ref.view(np.int16).copy()).view(torch.bfloat16)
    ref = x.astype(np.dtype(name))
    return ref, torch.from_numpy(ref.copy())


class TestWireParity:
    """The port's bytes are the reference's, and each reads the other's."""

    @pytest.mark.parametrize("flags", sorted(FLAG_BLOCKS))
    @pytest.mark.parametrize("dtype", WIRE_DTYPES)
    def test_send_bytes_equal_reference(self, dtype, flags):
        ref, port = _payloads(dtype)
        scalar = np.float32(2.5)
        want, got = _Capture(), _Capture()
        jq.send_tensors(want, (ref, scalar), 77, **FLAG_BLOCKS[flags])
        tq.send_tensors(got, (port, torch.tensor(2.5)), 77, **FLAG_BLOCKS[flags])
        assert got.data == want.data

    @pytest.mark.parametrize("code", ["", "OVERLOAD", "EXPIRED", "UNAVAILABLE", "TIMEOUT",
                                      "SESSION", "MIGRATING"])
    def test_error_frames_equal_and_typed_across(self, code):
        want, got = _Capture(), _Capture()
        jq.send_error(want, "it broke", code=code)
        tq.send_error(got, "it broke", code=code)
        assert got.data == want.data
        a, b = pair()
        try:
            a.sendall(want.data)
            with pytest.raises(tq.ERROR_TYPES.get(code, RuntimeError), match="it broke") as e:
                tq.recv_tensors(b)
            assert type(e.value).__name__ == jq.ERROR_TYPES.get(code, RuntimeError).__name__
        finally:
            a.close(); b.close()

    @pytest.mark.parametrize("dtype", WIRE_DTYPES)
    def test_each_side_reads_the_other(self, dtype):
        ref, port = _payloads(dtype)
        a, b = pair()
        try:
            jq.send_tensors(a, (ref,), 5, trace=(3, 4), tenant="x", caps="c")
            got = tq.recv_tensors_full(b)
            tq.send_tensors(a, (port,), 5, trace=(3, 4), tenant="x", caps="c")
            want = jq.recv_tensors_full(b)
        finally:
            a.close(); b.close()
        assert got[1:] == want[1:] == (5, (3, 4), "x", "c")
        g, w = got[0][0], want[0][0]
        assert g.dtype == w.dtype and g.shape == w.shape == (3, 4)
        assert g.tobytes() == w.tobytes() == ref.tobytes()
        back = tq.wire_tensor(g)
        assert back.dtype == port.dtype and torch.equal(back, port)

    def test_bfloat16_crosses_as_the_reference_sends_it(self):
        """The reference sends ml_dtypes' bfloat16 as '<V2' and hands back
        a V2 void array; the port sends and hands back the same, and its
        elements read V2 as torch.bfloat16, bit for bit."""
        ref, port = _payloads("bfloat16", (2, 3))
        cap = _Capture()
        tq.send_tensors(cap, (port,), 0)
        assert b"<V2" in cap.data
        for recv in (jq.recv_tensors, tq.recv_tensors):
            a, b = pair()
            try:
                a.sendall(cap.data)
                (out,), _ = recv(b)
            finally:
                a.close(); b.close()
            assert out.dtype == np.dtype("V2") and out.shape == (2, 3)
            assert out.tobytes() == ref.tobytes()
        t = tq.wire_tensor(out)
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.view(torch.int16), port.view(torch.int16))
        assert tnns.TensorsSpec.from_arrays([t]).tensors[0].dtype is BFLOAT16


class TestQueryPipeline:
    def test_remote_matches_local(self):
        frames = [np.full((4,), float(i), np.float32) for i in range(8)]
        with server(double_model()) as srv:
            got, _ = run_client(srv.port, [f.copy() for f in frames])
        assert len(got) == 8
        for i, f in enumerate(got):
            np.testing.assert_allclose(f.tensor(0).numpy(), 2.0 * i)

    def test_pts_preserved_and_output_spec_negotiated(self):
        model = model_of(lambda x: x.reshape(-1).sum()[None], (2, 3))
        with server(model) as srv:
            frames = [Frame.of(torch.full((2, 3), float(i)), pts=i * 100) for i in range(4)]
            got = []
            p = tnns.Pipeline()
            src = p.add(DataSrc(data=frames))
            cli = p.add(client(port=srv.port))
            sink = p.add(TensorSink())
            sink.connect("new-data", got.append)
            p.link_chain(src, cli, sink)
            p.run(timeout=120)
            assert sink.sink_pads["sink"].spec.tensors[0].shape == (1,)
        assert [f.pts for f in got] == [0, 100, 200, 300]
        np.testing.assert_allclose(got[2].tensor(0).numpy(), [6 * 2.0])

    def test_midstream_renegotiation(self):
        model = model_of(lambda x: x * 3.0, None)  # polymorphic
        frames = [np.full((4,), 1.0, F32), np.full((2, 3), 2.0, F32), np.full((4,), 3.0, F32)]
        with server(model) as srv:
            got, _ = run_client(srv.port, frames, out_spec=TensorsSpec.of(
                TensorSpec(dtype=F32, shape=None)))
        assert [tuple(f.tensor(0).shape) for f in got] == [(4,), (2, 3), (4,)]
        np.testing.assert_allclose(got[1].tensor(0).numpy(), 6.0)

    def test_concurrent_clients(self):
        with server(double_model()) as srv:
            results = {}

            def one(k):
                results[k], _ = run_client(srv.port, [np.full((4,), float(100 * k + i), F32)
                                                      for i in range(6)])

            threads = [threading.Thread(target=one, args=(k,)) for k in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        for k in range(3):
            assert len(results[k]) == 6
            for i, f in enumerate(results[k]):
                np.testing.assert_allclose(f.tensor(0).numpy(), 2.0 * (100 * k + i))

    def test_server_error_propagates(self):
        def boom(x):
            raise ValueError("boom")

        bad = TorchModel(apply=lambda p, x: boom(x), input_spec=VEC4, output_spec=VEC4,
                         device="cpu")
        with server(bad) as srv:
            p = tnns.Pipeline()
            src = p.add(DataSrc(data=[np.zeros((4,), F32)]))
            cli = p.add(client(port=srv.port))
            sink = p.add(TensorSink())
            p.link_chain(src, cli, sink)
            with pytest.raises(NegotiationError, match="probe"):
                p.run(timeout=60)

    def test_oversized_payload_rejected(self):
        a, b = pair()
        try:
            evil = (tq.MAGIC + struct.pack("<HHq", tq.VERSION, 1, 0)
                    + struct.pack("<H", 3) + b"<f4"
                    + struct.pack("<H", 1) + struct.pack("<I", 2)
                    + struct.pack("<Q", 1 << 40))  # 1 TiB for a (2,) f32
            a.sendall(evil)
            with pytest.raises(ConnectionError, match="payload"):
                recv_tensors(b)
        finally:
            a.close(); b.close()

    def test_mixed_shape_clients_no_thrash(self):
        model = model_of(lambda x: x * 2.0, None)
        out_spec = TensorsSpec.of(TensorSpec(dtype=F32, shape=None))
        with server(model) as srv:
            results = {}

            def one(k, shape):
                results[k], _ = run_client(srv.port, [np.full(shape, float(10 * k + i), F32)
                                                      for i in range(5)], out_spec=out_spec)

            threads = [threading.Thread(target=one, args=(0, (4,))),
                       threading.Thread(target=one, args=(1, (2, 3)))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert len(srv._backends) == 2  # one backend per spec, cached
        for k, shape in ((0, (4,)), (1, (2, 3))):
            assert len(results[k]) == 5
            for i, f in enumerate(results[k]):
                assert tuple(f.tensor(0).shape) == shape
                np.testing.assert_allclose(f.tensor(0).numpy(), 2.0 * (10 * k + i))

    def test_client_interrupt_unblocks_dead_server(self):
        silent_ready = threading.Event()
        srv_sock = socket.create_server(("127.0.0.1", 0))
        srv_sock.settimeout(30)
        port = srv_sock.getsockname()[1]

        def half_server():
            conn, _ = srv_sock.accept()
            conn.settimeout(30)
            with conn:
                tensors, pts = recv_tensors(conn)  # the negotiation probe
                send_tensors(conn, tensors, pts)   # answer it
                silent_ready.set()
                try:
                    while conn.recv(65536):
                        pass
                except OSError:
                    return

        th = threading.Thread(target=half_server, daemon=True)
        th.start()
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[np.zeros((4,), F32) for _ in range(50)]))
        cli = p.add(client(port=port))
        sink = p.add(TensorSink())
        p.link_chain(src, cli, sink)
        p.start()
        assert silent_ready.wait(timeout=30)
        time.sleep(0.05)  # let a frame enter the silent recv
        t0 = time.monotonic()
        p.stop()
        assert time.monotonic() - t0 < 10, "stop() hung on a dead server"
        srv_sock.close()
        th.join(timeout=30)

    def test_parse_launch_spelling(self):
        with server(double_model()) as srv:
            p = tnns.parse_launch(
                f"datasrc name=s ! tensor_query_client port={srv.port} device=cpu "
                "! tensor_sink name=out collect=true")
            p["s"].data = [np.full((4,), 5.0, F32)]
            p.run(timeout=60)
            np.testing.assert_allclose(p["out"].frames[0].tensor(0).numpy(), 10.0)


def poly_model(fn=lambda x: x * 2.0):
    return model_of(fn, (None, 4))


class TestCrossClientBatching:
    def test_concurrent_clients_batched_and_exact(self):
        with server(poly_model(), batch=4, batch_window_ms=25.0) as srv:
            results = {}

            def one(k):
                results[k], _ = run_client(srv.port, [np.full((1, 4), float(100 * k + i), F32)
                                                      for i in range(8)])

            threads = [threading.Thread(target=one, args=(k,)) for k in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            invokes, frames_served = srv.batched_invokes, srv.batched_frames
        for k in range(3):
            assert len(results[k]) == 8
            for i, f in enumerate(results[k]):
                np.testing.assert_allclose(f.tensor(0).numpy(), 2.0 * (100 * k + i))
        assert frames_served >= 24  # negotiation probes also batch
        assert invokes < frames_served, (invokes, frames_served)

    def test_lone_client_still_exact(self):
        with server(poly_model(), batch=4, batch_window_ms=1.0) as srv:
            got, _ = run_client(srv.port, [np.full((1, 4), float(i), F32) for i in range(5)])
        assert len(got) == 5
        for i, f in enumerate(got):
            np.testing.assert_allclose(f.tensor(0).numpy(), 2.0 * i)

    def test_batch_one_rejected(self):
        with pytest.raises(ValueError, match="batch"):
            server(poly_model(), batch=1)


class TestBatchCap:
    def test_oversize_group_dispatches_exact_and_stays_correct(self):
        with server(poly_model(), batch=2, batch_window_ms=1.0, max_batch=4) as srv:
            frames = [np.arange(24, dtype=F32).reshape(6, 4) + i for i in range(3)]
            got, _ = run_client(srv.port, frames)
        assert len(got) == 3
        for i, f in enumerate(got):
            np.testing.assert_allclose(f.tensor(0).numpy(),
                                       2.0 * (np.arange(24, dtype=F32).reshape(6, 4) + i))

    def test_max_batch_validation(self):
        with pytest.raises(ValueError, match="max_batch"):
            server(poly_model(lambda x: x), batch=2, max_batch=0)


class TestBatchSplitBoundsCompiles:
    """Over-max_batch groups split into max_batch-row sub-dispatches: the
    set of geometries the backend sees stays {4, 2, 1} here."""

    def test_split_bounds_executable_set_and_stays_correct(self):
        seen = []
        model = model_of(lambda x: (seen.append(tuple(x.shape)), x * 2.0)[1], (None, 4))
        with server(model, batch=2, batch_window_ms=1.0, max_batch=4) as srv:
            totals = [5, 6, 7, 9, 10, 11]  # all past the cap, all distinct
            for t in totals:
                group = []
                for r in (3, t - 3):  # two coalesced clients per group
                    x = torch.arange(r * 4, dtype=torch.float32).reshape(r, 4) + t
                    group.append(srv._Pending(TensorsSpec.from_arrays((x,)), (x,)))
                srv._dispatch_group(group)
                for g in group:
                    assert g.error is None, g.error
                    np.testing.assert_allclose(g.outs[0].numpy(), 2.0 * g.tensors[0].numpy())
            assert srv.batched_splits == len(totals)
            assert {s[0] for s in seen} <= {1, 2, 4}
            assert len(srv._backends) <= 3
            assert srv.stats()["batched_splits"] == len(totals)

    def test_under_cap_group_unsplit(self):
        with server(poly_model(lambda x: x + 1.0), batch=2, batch_window_ms=1.0,
                    max_batch=8) as srv:
            x = torch.ones((3, 4))
            group = [srv._Pending(TensorsSpec.from_arrays((x,)), (x,))]
            srv._dispatch_group(group)
            assert group[0].error is None
            np.testing.assert_allclose(group[0].outs[0].numpy(), x.numpy() + 1.0)
            assert srv.batched_splits == 0
            assert srv.batched_invokes == 1  # one pow-2-padded dispatch


class TestDevice:
    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            QueryServer(framework="torch", model=double_model())
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TensorQueryClient(port=1)

    def test_mesh_is_refused_naming_item_13(self, monkeypatch):
        """ROADMAP item 13 is done: ``NNSTPU_MESH`` no longer raises.  On
        the one CPU ``dp:4`` clamps to no mesh; over a forced 4-device mesh
        ``max_batch`` is a shard's cap, as the reference's
        ``TestQueryMeshSizing``: 12 rows at max_batch 4 dispatch once,
        padded to ``mesh_bucket`` (16 rows), exact."""
        from nnstreamer_tpu_torch.parallel import mesh as pmesh

        monkeypatch.setenv("NNSTPU_MESH", "dp:4")
        pmesh.reset_dispatch_mesh()
        try:
            with server(poly_model(), batch=2, batch_window_ms=1.0) as srv:
                assert srv.stats()["mesh_devices"] == 1  # one device: clamped off
                x = torch.ones((1, 4))
                group = [srv._Pending(TensorsSpec.from_arrays((x,)), (x,))]
                srv._dispatch_group(group)
                assert group[0].error is None
            pmesh.force_device_count(4, "cpu")
            with server(poly_model(), batch=2, batch_window_ms=1.0, max_batch=4) as srv:
                assert srv.stats()["mesh_devices"] == 4
                xs = [torch.arange(r * 4, dtype=torch.float32).reshape(r, 4) for r in (6, 6)]
                group = [srv._Pending(TensorsSpec.from_arrays((x,)), (x,)) for x in xs]
                srv._dispatch_group(group)
                for g, x in zip(group, xs):
                    assert g.error is None, g.error
                    assert torch.equal(g.outs[0], 2.0 * x)
                assert srv.batched_invokes == 1 and srv.batched_splits == 0
        finally:
            pmesh.force_device_count(None)

    def test_server_stop_closes_its_sockets(self):
        srv = server(double_model()).start()
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        try:
            send_tensors(c, (np.zeros(4, F32),), 0)
            recv_tensors(c)
            srv.stop()
            assert c.recv(16) == b""  # the server closed its end
            deadline = time.monotonic() + 10
            while srv._conns and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not srv._conns  # its serve thread left
        finally:
            c.close()


# -- faults on the wire (tests/test_faults.py's nnsq_send cases) -------------


class TestWireFaults:
    def test_torn_frame_is_a_connection_error(self):
        srv = socket.create_server(("127.0.0.1", 0))
        srv.settimeout(30)
        port = srv.getsockname()[1]

        def serve_half():
            conn, _ = srv.accept()
            conn.settimeout(30)
            with conn:
                tensors, pts = recv_tensors(conn)
                cap = _Capture()
                send_tensors(cap, tensors, pts)
                conn.sendall(cap.data[: len(cap.data) // 2])  # a torn reply

        t = threading.Thread(target=serve_half, daemon=True)
        t.start()
        try:
            cli = client(port=port, out_spec=VEC4, name="cli_torn")
            cli.start()
            with pytest.raises(ConnectionError, match="mid-message"):
                cli.process(None, Frame.of(torch.zeros(4), pts=0))
        finally:
            srv.close()
            t.join(timeout=30)

    def test_retry_reconnects_through_injected_drops(self):
        eng = faults.install("socket_drop@server:every=3,count=2")
        with server(double_model()) as srv:
            cli = client(port=srv.port, out_spec=VEC4, retries=2, retry_backoff_ms=5,
                         name="cli_retry")
            cli.start()
            for i in range(8):
                out = cli.process(None, Frame.of(torch.full((4,), float(i)), pts=i))
                np.testing.assert_allclose(out.tensor(0).numpy(), 2.0 * i)
            assert eng.injections["socket_drop"] == 2
            assert cli.retries_total == 2
            assert cli.reconnects >= 2
            cli.stop()

    def test_stateful_session_fails_fast_never_replays(self):
        eng = faults.install("socket_drop@server:every=1,count=1")
        with server(model_of(lambda x: x)) as srv:
            cli = client(port=srv.port, out_spec=VEC4, retries=5, stateful=True,
                         name="cli_state")
            cli.start()
            with pytest.raises(QuerySessionBrokenError):
                cli.process(None, Frame.of(torch.zeros(4), pts=0))
            assert cli.retries_total == 0  # fail fast, no silent replay
            assert eng.injections["socket_drop"] == 1
            cli.stop()

    def test_typed_server_errors_are_not_retried(self):
        from nnstreamer_tpu_torch.sched import AdmissionController, Scheduler

        # each (4,) request costs 4 admission tokens: burst=4 admits one,
        # the near-zero refill rate sheds the second with a typed frame
        sch = Scheduler("fifo", admission=AdmissionController(max_queue=8, rate=0.001, burst=4),
                        name="faults_tight")
        try:
            with server(model_of(lambda x: x), scheduler=sch) as srv:
                cli = client(port=srv.port, out_spec=VEC4, retries=3, name="cli_typed")
                cli.start()
                cli.process(None, Frame.of(torch.zeros(4), pts=0))
                with pytest.raises(tq.QueryOverloadError):
                    cli.process(None, Frame.of(torch.zeros(4), pts=1))
                assert cli.retries_total == 0
                cli.stop()
        finally:
            sch.close()

    @pytest.mark.parametrize("kind", ["truncate", "corrupt"])
    def test_client_side_faults(self, kind):
        eng = faults.install(f"{kind}@client:every=2,count=1")
        with server(double_model()) as srv:
            cli = client(port=srv.port, out_spec=VEC4, retries=2, retry_backoff_ms=1,
                         name=f"cli_{kind}")
            cli.start()
            outs = [cli.process(None, Frame.of(torch.full((4,), 1.0), pts=i)).tensor(0)
                    for i in range(3)]
            cli.stop()
        assert eng.injections[kind] == 1
        if kind == "truncate":
            # the torn request is dropped and re-sent: every reply exact
            assert cli.retries_total == 1
            assert all(torch.equal(o, torch.full((4,), 2.0)) for o in outs)
        else:
            # NNSQ carries no checksum (nor does the reference's wire): the
            # flipped payload byte reaches the model as data
            assert sum(not torch.equal(o, torch.full((4,), 2.0)) for o in outs) == 1


# -- the end-to-end trace over NNSQ (tests/test_spans.py) --------------------


def test_pipeline_end_to_end_trace_over_nnsq():
    with server(model_of(lambda x: x + 1)) as srv:
        got = []
        p = tnns.Pipeline(name="nnsqsp")
        src = p.add(DataSrc(data=[np.full(4, i, F32) for i in range(4)], name="s"))
        cli = p.add(client(port=srv.port, name="qc"))
        sink = p.add(TensorSink(callback=got.append, name="out"))
        p.link_chain(src, cli, sink)
        p.attach_tracer("spans")
        p.run(timeout=60)
    assert len(got) == 4
    assert cli._trace_wire is True
    frame_traces = {f.meta[spans.META_KEY][0] for f in got}
    assert len(frame_traces) == 4
    snap = spans.snapshot()
    xs = [r for r in snap if r[0] == spans.PH_COMPLETE]
    serve = {r[6] for r in xs if r[4] == "nnsq_serve"}
    rtt = {r[6] for r in xs if r[4] == "nnsq_rtt"}
    assert rtt == frame_traces
    assert serve >= frame_traces


def test_probe_pts_flagged_still_probe():
    spans.enable()
    with server(double_model()) as srv:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        try:
            send_tensors(s, (np.zeros((4,), F32),), PROBE_PTS, trace=(1, 0))
            outs, pts, reply, _ = recv_tensors_ex(s)
            assert pts == PROBE_PTS and reply is not None
        finally:
            s.close()


# -- the fragment backend and caps negotiation (tests/test_partition.py) -----


class TestFragmentBackend:
    CHAIN = ("tensor_transform mode=arithmetic option=mul:2.0 name=a device=cpu ! "
             "queue ! tensor_transform mode=arithmetic option=add:1.0 name=b device=cpu")

    def test_invoke_matches_in_process_math(self):
        be = FragmentBackend()
        be.open(self.CHAIN)
        try:
            assert len(be._nodes) == 2  # the queue is elided
            out_spec = be.reconfigure(TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,))))
            assert out_spec.tensors_fixed
            (out,) = be.invoke((torch.full((4,), 3.0),))
            np.testing.assert_allclose(out.numpy(), 3.0 * 2.0 + 1.0)
        finally:
            be.close()

    @pytest.mark.parametrize("model,exc,match", [
        ("", ValueError, "launch-string"),
        ("queue ! queue", ValueError, "no servable stages"),
        ("videotestsrc", ParseError, "1-in/1-out"),
    ], ids=["empty", "all_elided", "non_linear"])
    def test_rejected(self, model, exc, match):
        with pytest.raises(exc, match=match):
            FragmentBackend().open(model)

    def test_transforms_fold_into_the_filter(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")
        model_py = tmp_path / "summer.py"
        model_py.write_text(
            "import numpy as np\n"
            "from nnstreamer_tpu_torch.backends.torch_backend import TorchModel\n"
            "from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec\n"
            "def get_model():\n"
            "    return TorchModel(apply=lambda p, x: x.sum(-1, keepdim=True), device='cpu',\n"
            "                      input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32,\n"
            "                                                           shape=(4,))))\n")
        be = FragmentBackend()
        be.open("tensor_transform mode=arithmetic option=mul:2.0 acceleration=pallas device=cpu"
                f" ! tensor_filter framework=torch name=f model={model_py} ! "
                "tensor_transform mode=arithmetic option=add:1.0 acceleration=pallas device=cpu")
        try:
            assert [type(n).__name__ for n in be._nodes] == ["TensorFilter"]
            be.reconfigure(TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,))))
            (out,) = be.invoke((torch.arange(4, dtype=torch.float32),))
            np.testing.assert_allclose(out.numpy(), [2.0 * 6 + 1.0])
        finally:
            be.close()


class TestCapsNegotiation:
    def test_caps_probe_negotiates_spec_and_rate(self):
        with QueryServer(framework="custom", model=lambda x: x * 2.0, device="cpu") as srv:
            cli = client(port=srv.port, caps=True, name="qc_caps")
            cli.start()
            try:
                in_spec = TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,)), rate=Fraction(30))
                out = cli.configure({"sink": in_spec})
                assert cli._caps_wire is True
                assert out["src"].tensors[0].shape == (4,)
                assert out["src"].tensors[0].dtype == np.dtype(F32)
                assert out["src"].rate == Fraction(30)
                got = cli.process(None, Frame.of(torch.full((4,), 2.0), pts=7))
                np.testing.assert_allclose(got.tensor(0).numpy(), 4.0)
            finally:
                cli.stop()


def _strict_v1_server(model):
    """A pre-flags NNSQ peer: the old exact version check (``ver != 1`` ->
    drop the connection), plain version-1 replies."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    rejected = []
    stop = threading.Event()

    def recvn(c, n):
        buf = b""
        while len(buf) < n:
            chunk = c.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    def serve():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(30)
            with conn:
                try:
                    while not stop.is_set():
                        head = recvn(conn, 16)
                        ver, n, pts = struct.unpack("<HHq", head[4:])
                        if ver != 1:
                            rejected.append(ver)
                            break
                        tensors = []
                        for _ in range(n):
                            (dlen,) = struct.unpack("<H", recvn(conn, 2))
                            dt = np.dtype(recvn(conn, dlen).decode())
                            (rank,) = struct.unpack("<H", recvn(conn, 2))
                            shape = (struct.unpack(f"<{rank}I", recvn(conn, 4 * rank))
                                     if rank else ())
                            (nb,) = struct.unpack("<Q", recvn(conn, 8))
                            tensors.append(np.frombuffer(recvn(conn, nb), dt).reshape(shape))
                        send_tensors(conn, tuple(model(t) for t in tensors), pts)
                except (ConnectionError, OSError):
                    pass

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return srv, port, rejected, stop, th


class TestCapsVersionGating:
    @pytest.mark.parametrize("require", [False, True])
    def test_strict_v1_peer(self, require):
        srv, port, rejected, stop, th = _strict_v1_server(lambda t: t * 2.0)
        cli = client(port=port, caps=True, require_caps=require, name=f"qc_old_{require}")
        cli.start()
        try:
            spec = TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,)), rate=Fraction(30))
            if require:
                with pytest.raises(CapsNegotiationUnsupported):
                    cli.configure({"sink": spec})
            else:
                out = cli.configure({"sink": spec})
                assert cli._caps_wire is False
                assert out["src"].tensors[0].shape == (4,)
                got = cli.process(None, Frame.of(torch.full((4,), 3.0), pts=0))
                np.testing.assert_allclose(got.tensor(0).numpy(), 6.0)
            assert rejected and all(v & FLAG_CAPS for v in rejected)
        finally:
            cli.stop()
            stop.set()
            srv.close()
            th.join(timeout=30)

    def test_verdict_is_a_negotiation_error(self):
        assert issubclass(CapsNegotiationUnsupported, NegotiationError)


# -- across the packages -----------------------------------------------------


@pytest.fixture(scope="module")
def labels_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels.txt"
    path.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    return str(path)


@pytest.fixture(scope="module")
def jax_model():
    return jm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                              int8_head=True)


def port_model(jax_model):
    return tm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                              params=jax.tree_util.tree_map(np.asarray, jax_model.params),
                              int8_head=True, device="cpu")


def _slice(nns, mid, labels, sink_cls, n=6, **transform_kw):
    """Slice 1 at 32x32: source, converter, normalize, ``mid`` (a filter or
    a query client), the labeling decoder, a collecting sink."""
    p = nns.Pipeline()
    chain = [p.add(nns.make("videotestsrc", num_buffers=n, width=SIZE, height=SIZE,
                            pattern="random", seed=3)),
             p.add(nns.make("tensor_converter")),
             p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                            acceleration="pallas", **transform_kw)),
             p.add(mid),
             p.add(nns.make("tensor_decoder", mode="image_labeling", option1=labels)),
             p.add(sink_cls(collect=True))]
    p.link_chain(*chain)
    p.run(timeout=300)
    return chain[-1].frames


def _same_labels(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.meta["label_index"] == w.meta["label_index"]
        assert g.meta["label"] == w.meta["label"]
        assert (g.pts, g.duration) == (w.pts, w.duration)


def test_port_client_against_reference_server(jax_model, labels_file):
    """The reference's server replies with the reference's numbers: the
    port's client delivers them exactly (the wire adds no numerics)."""
    want = _slice(jnns, JaxFilter(framework="jax", model=jax_model), labels_file, JaxSink)
    with jq.QueryServer(framework="jax", model=jax_model) as srv:
        got = _slice(tnns, client(port=srv.port), labels_file, TensorSink, device="cpu")
    _same_labels(got, want)
    for g, w in zip(got, want):
        assert g.meta["score"] == w.meta["score"]


def test_reference_client_against_port_server(jax_model, labels_file):
    """The reference's client against the port's server on the same
    weights: the reference's labels, the score within the bf16 trunk's
    rounding (as the in-process slices are held, test_torch_pipeline)."""
    want = _slice(jnns, JaxFilter(framework="jax", model=jax_model), labels_file, JaxSink)
    with server(port_model(jax_model)) as srv:
        got = _slice(jnns, jq.TensorQueryClient(port=srv.port, request_timeout=30.0),
                     labels_file, JaxSink)
    _same_labels(got, want)
    for g, w in zip(got, want):
        assert abs(g.meta["score"] - w.meta["score"]) <= 0.15


def test_split_launch_halves_equal_the_in_process_slice(labels_file, tmp_path, monkeypatch):
    """Slice 1's launch string, split by the port's split_launch: the server
    half on the fragment backend (the normalize folded into the filter), the
    client half with tensor_query_client; the decoder's text equals the
    in-process pipeline's frame for frame."""
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")
    ckpt = str(tmp_path / "m.npz")
    save_state(tm.init_tree(0, CLASSES, 0.35), ckpt)
    desc = (f"videotestsrc num-buffers=6 width={SIZE} height={SIZE} pattern=random seed=3 ! "
            "tensor_converter ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas "
            "device=cpu ! "
            f"tensor_filter framework=torch model={ckpt} "
            f"custom=builder=mobilenet_v2:build_quantized,int8_head=1,num_classes={CLASSES},"
            f"width_mult=0.35,image_size={SIZE} ! "
            f"tensor_decoder mode=image_labeling option1={labels_file} ! "
            "tensor_sink name=out collect=true")
    whole = tnns.parse_launch(desc)
    whole.run(timeout=300)
    want = whole["out"].frames
    with QueryServer(framework="fragment", model="", device="cpu") as srv:
        cli_desc, srv_desc = split_launch(desc, 2, {"port": str(srv.port), "device": "cpu",
                                                    "request_timeout": "30"})
        assert "tensor_query_client" in cli_desc and srv_desc.startswith("tensor_transform")
        srv._model = srv_desc
        half = tnns.parse_launch(cli_desc)
        half.run(timeout=300)
        (be,) = srv._backends.values()
        assert [type(n).__name__ for n in be._nodes] == ["TensorFilter", "TensorDecoder"]
    got = half["out"].frames
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert bytes(g.tensor(0).numpy()) == w.meta["label"].encode()
        assert g.pts == w.pts
