"""The port's ``DecodeServer`` against the JAX package's decode loop and server.

Case for case with the JAX package's ``tests/test_serving.py::
TestDecodeServer`` and its TCP prefill cases, and ``tests/test_migration.py::
TestWireOps`` (the MIGRATE/RESUME control ops through a ``TensorRepoServer``),
on the CPU (``device="cpu"``): one connection is one session, probes never
step, a rank-2 frame prefills, and a migrated session finishes token for
token as an unmigrated one.  Outputs are held to the JAX package's
single-stream ``decode_step`` loop on the same params within 1e-5 (as
``tests/test_torch_serving.py`` holds the engine); a session migrated from
the port's server to the JAX package's server, through either package's
repo server, finishes within the same tolerance.  Small size: t_max 16,
d_in 8, n_out 4, d_model 32, 4 heads, 2 layers.
"""

import socket
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nnstreamer_tpu.fleet.repo import TensorRepoServer as JaxRepoServer
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.serving import ContinuousBatcher as JaxBatcher
from nnstreamer_tpu.serving import DecodeServer as JaxDecodeServer
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.elements.query import (
    MIGRATE_PTS,
    PROBE_PTS,
    RESUME_PTS,
    QueryMigratingError,
    QuerySessionBrokenError,
    QueryUnavailableError,
    TensorQueryClient,
    pack_session_control,
    recv_tensors,
    send_tensors,
)
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.fleet.repo import TensorRepoServer
from nnstreamer_tpu_torch.serving import ContinuousBatcher, DecodeServer
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

KW = dict(t_max=16, d_in=8, n_out=4, d_model=32, n_heads=4, n_layers=2)
TOL = dict(rtol=1e-5, atol=1e-5)
JTREE = jt.init_params(jax.random.PRNGKey(0), KW["d_model"], KW["n_heads"], KW["n_layers"],
                       4 * KW["d_model"], KW["d_in"], KW["n_out"])
TREE = jax.tree_util.tree_map(np.asarray, JTREE)
OUT_SPEC = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(KW["n_out"],)))


def engine(capacity=2):
    return ContinuousBatcher(capacity=capacity, params=TREE, device="cpu", **KW)


def decode_server(eng, **kw):
    return DecodeServer(eng, device="cpu", **kw)


def single_stream_outputs(xs):
    """The JAX package's single-sequence decode_step loop."""
    cache = jt.init_decode_cache(KW["n_layers"], KW["d_model"], KW["t_max"])
    pos = jnp.zeros((1,), jnp.int32)
    step = jax.jit(lambda x, c, p: jt.decode_step(JTREE, x, c, p))
    outs = []
    for x in xs:
        y, cache, pos = step(jnp.asarray(x), cache, pos)
        outs.append(np.asarray(y))
    return outs


def stream_inputs(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(KW["d_in"]).astype(np.float32) for _ in range(n)]


def assert_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


class RawClient:
    def __init__(self, port, timeout=30.0):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)

    def request(self, arrays, pts=0):
        send_tensors(self.sock, arrays, pts)
        return recv_tensors(self.sock)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def offload(port, xs, **kw):
    got = []
    p = tnns.Pipeline()
    src = p.add(DataSrc(data=xs))
    cli = p.add(TensorQueryClient(port=port, device="cpu", request_timeout=30.0, **kw))
    sink = p.add(TensorSink())
    sink.connect("new-data", lambda f: got.append(f.tensor(0).numpy()))
    p.link_chain(src, cli, sink)
    p.run(timeout=120)
    return got


class TestDecodeServer:
    @pytest.mark.parametrize("probe", [False, True], ids=["out_spec", "probed"])
    def test_pipeline_offload_matches_single_stream(self, probe):
        """With out_spec the client skips negotiation; without it the
        probe answers the geometry and does not step the session."""
        xs = stream_inputs(50 + probe, 5)
        with engine() as eng, decode_server(eng) as srv:
            got = offload(srv.port, xs, **({} if probe else {"out_spec": OUT_SPEC}))
            assert eng.stats()["steps_total"] == len(xs)
        assert_close(got, single_stream_outputs(xs))

    def test_concurrent_connections_share_the_batch(self):
        with engine() as eng, decode_server(eng) as srv:
            streams = {k: stream_inputs(60 + k, 6) for k in range(2)}
            got = {k: [] for k in streams}

            def one(k):
                c = RawClient(srv.port)
                try:
                    for i, x in enumerate(streams[k]):
                        outs, pts = c.request((x,), i)
                        assert pts == i
                        got[k].append(outs[0])
                finally:
                    c.close()

            ts = [threading.Thread(target=one, args=(k,)) for k in streams]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
        for k, xs in streams.items():
            assert_close(got[k], single_stream_outputs(xs))

    def test_probes_are_stateless_and_unstamped_frames_step(self):
        xs = stream_inputs(55, 3)
        with engine() as eng, decode_server(eng) as srv:
            c = RawClient(srv.port)
            try:
                zero = np.zeros(KW["d_in"], np.float32)
                outs, _ = c.request((zero,), PROBE_PTS)
                assert outs[0].shape == (KW["n_out"],)
                got = []
                for i, x in enumerate(xs):
                    if i == 1:  # a mid-stream re-probe does not step either
                        c.request((zero,), PROBE_PTS)
                    outs, _ = c.request((x,), -1)  # unstamped = a step
                    got.append(outs[0])
            finally:
                c.close()
        assert_close(got, single_stream_outputs(xs))

    def test_capacity_exhaustion_surfaces_as_protocol_error(self):
        with engine(1) as eng, decode_server(eng, session_timeout=0.2) as srv:
            a, b = RawClient(srv.port), RawClient(srv.port)
            try:
                x = np.zeros(KW["d_in"], np.float32)
                a.request((x,), 0)  # a holds the only slot
                with pytest.raises(RuntimeError, match="no free slot"):
                    b.request((x,), 0)
            finally:
                a.close(), b.close()

    def test_server_stop_releases_idle_clients_slots(self):
        eng = engine(1)
        try:
            srv = decode_server(eng).start()
            c = RawClient(srv.port)
            c.request((np.zeros(KW["d_in"], np.float32),), 0)  # holds the only slot
            assert not eng._free
            srv.stop()  # must unblock c's serve thread
            deadline = time.time() + 10
            while not eng._free and time.time() < deadline:
                time.sleep(0.05)
            assert eng._free, "slot not released by server stop"
            c.close()
        finally:
            eng.stop()

    def test_mismatched_client_fails_at_negotiation(self):
        wrong = [np.zeros(KW["d_in"] * 2, np.float32)]
        with engine() as eng, decode_server(eng) as srv:
            with pytest.raises(Exception, match=r"expects \(8,\)"):
                offload(srv.port, wrong)

    def test_tcp_prompt_frame_prefills(self):
        xs = stream_inputs(97, 6)
        with engine() as eng, decode_server(eng) as srv:
            c = RawClient(srv.port)
            try:
                outs, _ = c.request((np.stack(xs[:4]),), 0)  # rank 2 = a prompt
                got = [outs[0]]
                for i, x in enumerate(xs[4:]):
                    outs, _ = c.request((x,), i + 1)
                    got.append(outs[0])
            finally:
                c.close()
        want = single_stream_outputs(xs)
        np.testing.assert_allclose(got[0], want[3], **TOL)
        assert_close(got[1:], want[4:])

    def test_probe_rejects_overlong_prompt_geometry(self):
        with engine(1) as eng, decode_server(eng) as srv:
            c = RawClient(srv.port)
            try:
                bad = np.zeros((KW["t_max"] + 4, KW["d_in"]), np.float32)
                with pytest.raises(RuntimeError, match="decode server"):
                    c.request((bad,), PROBE_PTS)
            finally:
                c.close()

    def test_drain_ends_idle_connections_typed_and_live_sessions_finish(self):
        xs = stream_inputs(70, 4)
        with engine() as eng:
            srv = decode_server(eng).start()
            live, idle = RawClient(srv.port), RawClient(srv.port)
            idle.request((np.zeros(KW["d_in"], np.float32),), PROBE_PTS)
            got = [live.request((xs[0],), 0)[0][0]]
            done = {}

            def drain():
                done["clean"] = srv.drain(timeout=10)

            t = threading.Thread(target=drain)
            t.start()
            with pytest.raises(QueryUnavailableError):
                recv_tensors(idle.sock)  # the typed goodbye
            for i, x in enumerate(xs[1:]):
                got.append(live.request((x,), i + 1)[0][0])
            live.close()
            t.join(timeout=30)
            idle.close()
            assert done["clean"] is True
        assert_close(got, single_stream_outputs(xs))

    def test_drain_deadline_ends_stragglers_with_session_code(self):
        with engine() as eng:
            srv = decode_server(eng).start()
            c = RawClient(srv.port)
            c.request((np.zeros(KW["d_in"], np.float32),), 0)
            assert srv.drain(timeout=0.2) is False
            with pytest.raises(QuerySessionBrokenError):
                recv_tensors(c.sock)
            c.close()

    def test_kill_tears_sockets_and_stats_count(self):
        with engine() as eng:
            srv = decode_server(eng).start()
            c = RawClient(srv.port)
            c.request((np.zeros(KW["d_in"], np.float32),), 0)
            assert srv.stats()["connections"] == 1 and srv.stats()["running"]
            srv.kill()
            with pytest.raises((ConnectionError, OSError)):
                c.request((np.zeros(KW["d_in"], np.float32),), 1)
            c.close()
            assert srv.stats()["running"] is False

    def test_defaults_to_the_card(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with engine() as eng:
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                DecodeServer(eng)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TensorRepoServer()


# -- the MIGRATE/RESUME wire ops (tests/test_migration.py::TestWireOps) ------


def _control_run(prompt, steps):
    """One unmigrated session end to end on a port engine."""
    with engine() as eng:
        sess = eng.open_session()
        sess.prefill(prompt)
        out = [sess.get(timeout=10)]
        for s in steps:
            sess.feed(s)
            out.append(sess.get(timeout=10))
        sess.close()
    return out


def _prompt(seed, t=3):
    return np.random.RandomState(seed).rand(t, KW["d_in"]).astype(np.float32)


def _steps(n, base):
    return [np.random.RandomState(base + i).rand(KW["d_in"]).astype(np.float32)
            for i in range(n)]


class TestWireOps:
    @pytest.mark.parametrize("repo_pkg", ["port", "jax"])
    def test_migrate_then_resume_across_servers(self, repo_pkg):
        """Snapshot off server A into a repo server (either package's),
        resume on server B, finish token for token; a frame racing the
        completed migrate gets the typed [MIGRATING] 'not applied'."""
        prompt, steps = _prompt(11), _steps(4, 110)
        ctl = _control_run(prompt, steps)
        repo = (TensorRepoServer(device="cpu") if repo_pkg == "port" else JaxRepoServer()).start()
        with engine() as ea, engine() as eb, decode_server(ea) as sa, decode_server(eb) as sb:
            try:
                c = RawClient(sa.port)
                out = [c.request((prompt,))[0][0]]
                for s in steps[:2]:
                    out.append(c.request((s,))[0][0])
                frame = pack_session_control(f"127.0.0.1:{repo.port}", 77, 5000)
                acks, _ = c.request(frame, pts=MIGRATE_PTS)
                assert int(acks[0][0]) == 1
                assert ea.stats()["active_sessions"] == 0  # the slot freed
                with pytest.raises(QueryMigratingError):
                    c.request((steps[2],))
                c.close()
                c2 = RawClient(sb.port)
                acks, _ = c2.request(frame, pts=RESUME_PTS)
                assert int(acks[0][0]) == 1
                for s in steps[2:]:
                    out.append(c2.request((s,))[0][0])
                c2.close()
                for x, y in zip(ctl, out):
                    np.testing.assert_array_equal(x, y)
                assert sa.stats()["sessions_migrated"] == 1
                assert sb.stats()["sessions_restored"] == 1
            finally:
                repo.stop()

    def test_migration_disabled_answers_plain_error(self):
        repo = TensorRepoServer(device="cpu").start()
        with engine() as eng, decode_server(eng, migration=False) as srv:
            try:
                c = RawClient(srv.port)
                c.request((np.zeros(KW["d_in"], np.float32),))  # a live session
                frame = pack_session_control(f"127.0.0.1:{repo.port}", 5, 2000)
                with pytest.raises(RuntimeError) as ei:
                    c.request(frame, pts=MIGRATE_PTS)
                assert not isinstance(ei.value, (QueryMigratingError, QuerySessionBrokenError))
                outs, _ = c.request((np.zeros(KW["d_in"], np.float32),))
                assert outs[0].shape == (KW["n_out"],)
                c.close()
            finally:
                repo.stop()

    def test_resume_refusals_are_typed(self):
        repo = TensorRepoServer(device="cpu").start()
        with engine() as eng, decode_server(eng) as srv:
            try:
                c = RawClient(srv.port)
                frame = pack_session_control(f"127.0.0.1:{repo.port}", 9, 300)
                with pytest.raises(QueryMigratingError):
                    c.request(frame, pts=RESUME_PTS)  # nothing in the slot
                c.request((np.zeros(KW["d_in"], np.float32),))
                with pytest.raises(QueryMigratingError):
                    c.request(frame, pts=RESUME_PTS)  # this one holds a session
                c.close()
            finally:
                repo.stop()

    def test_port_session_resumes_on_the_reference_server(self):
        """A session snapshotted by the port's server resumes on the JAX
        package's server (same params) and finishes within 1e-5 of the
        reference's single-stream loop."""
        prompt, steps = _prompt(12, t=4), _steps(4, 120)
        want = single_stream_outputs(list(prompt) + steps)
        repo = TensorRepoServer(device="cpu").start()
        jeng = JaxBatcher(capacity=2, params=JTREE, **KW)
        jsrv = JaxDecodeServer(jeng).start()
        try:
            with engine() as ea, decode_server(ea) as sa:
                c = RawClient(sa.port)
                out = [c.request((prompt,))[0][0]]
                out += [c.request((s,))[0][0] for s in steps[:2]]
                frame = pack_session_control(f"127.0.0.1:{repo.port}", 3, 5000)
                assert int(c.request(frame, pts=MIGRATE_PTS)[0][0][0]) == 1
                c.close()
            c2 = RawClient(jsrv.port)
            assert int(c2.request(frame, pts=RESUME_PTS)[0][0][0]) == 1
            out += [c2.request((s,))[0][0] for s in steps[2:]]
            c2.close()
        finally:
            jsrv.stop()
            jeng.stop()
            repo.stop()
        assert_close(out, want[len(prompt) - 1:])
