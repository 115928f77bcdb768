"""The port's remote ``tensor_repo`` (``fleet/repo.py``) against the JAX
package's.

Case for case with the JAX package's ``tests/test_migration.py::
TestRepoHardening`` (idempotent ops retry through injected drops, the
others fail typed, ``close`` closes every cached socket and never re-dials,
the tracked socket list stays bounded), plus the remote cases: the slot
protocol over the wire (publish blocks until taken, a poll times out, EOS),
a recurrence split across two pipelines through ``[fleet] repo_addr``, and
each package's client against the other's server on the same frames.  On the
CPU (``device="cpu"``); every socket binds 127.0.0.1:0.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.fleet import repo as jfleet
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch import faults
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements import repo as trepo
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.fleet.repo import RemoteRepoError, RemoteTensorRepo, TensorRepoServer
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

CAPS4 = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(4,)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.deactivate()


def repo_server():
    return TensorRepoServer(port=0, device="cpu")


class TestRemoteSlots:
    def test_publish_take_poll_and_eos(self):
        with repo_server() as srv:
            repo = RemoteTensorRepo("127.0.0.1", srv.port)
            try:
                assert repo.get_buffer(3, timeout=0.05) == (None, None, False)  # poll timeout
                x = torch.arange(4, dtype=torch.float32)
                assert repo.set_buffer(3, Frame.of(x, pts=11)) is True
                frame, spec, eos = repo.get_buffer(3, timeout=1)
                assert not eos and frame.pts == 11 and torch.equal(frame.tensor(0), x)
                assert spec == TensorsSpec.from_arrays([x])
                # the server holds the frame on its device as the local repo would
                repo.set_buffer(3, Frame.of(x + 1, pts=12))
                held = srv.repo.slot(3).frame.tensor(0)
                assert isinstance(held, torch.Tensor) and held.device.type == "cpu"
                repo.get_buffer(3, timeout=1)
                repo.set_eos(3)
                assert repo.get_buffer(3, timeout=0.05) == (None, None, True)
                assert repo.set_buffer(3, Frame.of(x, pts=13)) is False  # at EOS
                assert srv.ops >= 7
            finally:
                repo.close()

    def test_set_blocks_until_the_frame_is_taken(self):
        with repo_server() as srv:
            repo = RemoteTensorRepo("127.0.0.1", srv.port)
            try:
                repo.set_buffer(4, Frame.of(torch.zeros(4), pts=0))
                done = threading.Event()

                def second():
                    repo.set_buffer(4, Frame.of(torch.ones(4), pts=1))
                    done.set()

                t = threading.Thread(target=second, daemon=True)
                t.start()
                assert not done.wait(0.2)  # backpressure over the wire
                assert repo.get_buffer(4, timeout=1)[0].pts == 0
                assert done.wait(10)
                assert repo.get_buffer(4, timeout=1)[0].pts == 1
                t.join(timeout=10)
            finally:
                repo.close()

    def test_recurrence_across_pipelines_through_repo_addr(self, monkeypatch):
        """A producer pipeline's reposink and a consumer pipeline's reposrc,
        both made without ``repo=``, meet in the repo server named by
        ``[fleet] repo_addr``: the consumer sees the bootstrap zero frame,
        then every published frame, in order."""
        with repo_server() as srv:
            monkeypatch.setenv("NNSTPU_FLEET_REPO_ADDR", f"127.0.0.1:{srv.port}")
            prod = tnns.Pipeline("producer")
            rsink = prod.add(trepo.TensorRepoSink(slot_index=31))
            data = [torch.full((4,), float(i)) for i in range(1, 5)]
            prod.link(prod.add(DataSrc(data=data)), rsink)
            cons = tnns.Pipeline("consumer")
            rsrc = cons.add(trepo.TensorRepoSrc(slot_index=31, caps=CAPS4, device="cpu"))
            out = cons.add(TensorSink(collect=True))
            cons.link(rsrc, out)
            assert isinstance(rsink.repo, RemoteTensorRepo) and rsrc.repo is rsink.repo
            cons.start()
            prod.run(timeout=60)
            deadline = time.monotonic() + 30
            while len(out.frames) < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            cons.stop()
            got = [float(f.tensor(0)[0]) for f in out.frames]
            assert got[:5] == [0.0, 1.0, 2.0, 3.0, 4.0]
            assert all(f.tensor(0).device.type == "cpu" for f in out.frames)
            rsink.repo.close()

    @pytest.mark.parametrize("direction", ["port_client", "jax_client"])
    def test_each_package_against_the_others_server(self, direction):
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        if direction == "port_client":
            srv, cli = jfleet.TensorRepoServer(port=0).start(), None
            cli = RemoteTensorRepo("127.0.0.1", srv.port)
            frame = Frame.of(torch.from_numpy(x), pts=5)
        else:
            srv = repo_server().start()
            cli = jfleet.RemoteTensorRepo("127.0.0.1", srv.port)
            frame = JFrame.of(x, pts=5)
        try:
            assert cli.set_buffer(9, frame) is True
            got, _, eos = cli.get_buffer(9, timeout=1)
            assert not eos and got.pts == 5
            np.testing.assert_array_equal(np.asarray(got.tensor(0)), x)
            cli.prepare(9)
            assert cli.take_restored(9) is False
            cli.set_eos(9)
            assert cli.get_buffer(9, timeout=0.05)[2] is True
        finally:
            cli.close()
            srv.stop()


class TestRepoHardening:
    def test_idempotent_ops_retry_through_drops(self):
        with repo_server() as srv:
            repo = RemoteTensorRepo("127.0.0.1", srv.port)
            try:
                # every=3 lands drops on requests and replies across the run
                faults.install("socket_drop@repo:every=3", seed=5)
                for _ in range(6):
                    repo.prepare(3)  # idempotent: survives the drops
                    repo.clear(3)
                assert faults.engine().injections.get("socket_drop", 0) >= 2
                assert repo.retries_total >= 1
            finally:
                faults.deactivate()
                repo.close()

    def test_non_idempotent_ops_fail_typed(self):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dead_port = probe.getsockname()[1]
        probe.close()
        repo = RemoteTensorRepo("127.0.0.1", dead_port, retry_backoff_s=0.01)
        with pytest.raises(RemoteRepoError):
            repo.set_buffer(1, Frame.of(torch.zeros(4), pts=0))
        with pytest.raises(RemoteRepoError):
            repo.prepare(1)
        repo.close()

    def test_close_closes_cached_sockets_no_redial(self):
        with repo_server() as srv:
            repo = RemoteTensorRepo("127.0.0.1", srv.port)
            seen = []

            def worker():
                repo.prepare(7)
                seen.append(getattr(repo._tls, "sock", None))

            ths = [threading.Thread(target=worker) for _ in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=30)
            assert len(repo._socks) == 4  # one cached socket per thread
            repo.close()
            assert repo._socks == []
            for s in seen:
                assert s is not None and s.fileno() == -1  # really closed
            with pytest.raises(RemoteRepoError):
                repo.prepare(7)  # typed, and never re-dials

    def test_reset_keeps_socket_list_bounded(self):
        with repo_server() as srv:
            repo = RemoteTensorRepo("127.0.0.1", srv.port)
            try:
                faults.install("socket_drop@repo:every=1", seed=7)
                for _ in range(6):
                    try:
                        repo.set_eos(2)
                    except ConnectionError:
                        pass
                assert len(repo._socks) <= 1, "dead sockets must leave the tracked list"
            finally:
                faults.deactivate()
                repo.close()

    def test_server_stop_closes_its_connections(self):
        srv = repo_server().start()
        repo = RemoteTensorRepo("127.0.0.1", srv.port)
        repo.prepare(1)
        srv.stop()
        deadline = time.monotonic() + 10
        while srv._conns and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._conns
        with pytest.raises(RemoteRepoError):
            repo.set_buffer(1, Frame.of(torch.zeros(4), pts=0))
        repo.close()
