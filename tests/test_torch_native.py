"""The port's native frame queue (C++, built with ``g++`` here) and its
Python twin, against the JAX package's.

Case for case with the JAX package's ``tests/test_native.py``: the queue
contract (FIFO, timeouts, backpressure, the leak modes, events never
dropped, shutdown wake-ups) on both of the port's queues, the native
queue's handle table and a producers-consumer stress, and the ``queue``
element on either.  Seeded push/pop sequences go through the port's native
queue, the port's twin and the JAX package's two queues, and every status
and popped item must agree.  Where the port differs on purpose: a failed
native build raises with the native runtime on (the JAX package falls back
to the twin without a word), and ``stats()["impl"]`` names the queue.
"""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu import native as jnative
from nnstreamer_tpu.buffer import Event as JEvent
from nnstreamer_tpu.native.queue import NativeFrameQueue as JNative
from nnstreamer_tpu.native.queue import PyFrameQueue as JPy

from nnstreamer_tpu_torch import native
from nnstreamer_tpu_torch.buffer import Event, Frame
from nnstreamer_tpu_torch.native import (
    DROPPED_INCOMING,
    OK,
    OK_DROPPED_OLDEST,
    SHUTDOWN,
    TIMEOUT,
    NativeBuildError,
)
from nnstreamer_tpu_torch.native.queue import NativeFrameQueue, PyFrameQueue, make_frame_queue

IMPLS = [PyFrameQueue, NativeFrameQueue]


def test_native_library_builds():
    """g++ is here: the native path is real, under build/nnstreamer_tpu_torch."""
    lib = native.load()
    assert lib is not None
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "nnstreamer_tpu_torch")
    assert native.SOURCE.name == "frame_queue.cpp"


def test_codes_are_the_reference_ones():
    for name in ("OK", "OK_DROPPED_OLDEST", "DROPPED_INCOMING", "SHUTDOWN", "TIMEOUT",
                 "EVENT_BIT"):
        assert getattr(native, name) == getattr(jnative, name)


@pytest.fixture(params=IMPLS, ids=lambda c: c.__name__)
def q4(request):
    q = request.param(4)
    yield q
    q.close()


class TestContract:
    def test_fifo_order(self, q4):
        for i in range(4):
            assert q4.push(i) == OK
        assert len(q4) == 4
        assert [q4.pop(0)[1] for _ in range(4)] == [0, 1, 2, 3]

    def test_pop_timeout(self, q4):
        status, item = q4.pop(timeout_ms=30)
        assert status == TIMEOUT and item is None

    def test_blocking_push_backpressure(self, q4):
        for i in range(4):
            q4.push(i)
        done = []

        def pusher():
            done.append(q4.push(99, leaky="no"))

        t = threading.Thread(target=pusher)
        t.start()
        time.sleep(0.05)
        assert not done  # blocked: queue full
        assert q4.pop(0) == (OK, 0)
        t.join(timeout=2)
        assert done == [OK]
        assert len(q4) == 4

    def test_push_timeout_when_full(self, q4):
        for i in range(4):
            q4.push(i)
        assert q4.push(9, leaky="no", timeout_ms=20) == TIMEOUT
        assert len(q4) == 4 and q4.dropped == 0

    def test_leaky_downstream_drops_oldest(self, q4):
        for i in range(4):
            q4.push(i)
        assert q4.push(4, leaky="downstream") == OK_DROPPED_OLDEST
        assert [q4.pop(0)[1] for _ in range(4)] == [1, 2, 3, 4]
        assert q4.dropped == 1 and q4.stats()["dropped"] == 1

    def test_leaky_upstream_rejects_incoming(self, q4):
        for i in range(4):
            q4.push(i)
        assert q4.push(4, leaky="upstream") == DROPPED_INCOMING
        assert [q4.pop(0)[1] for _ in range(4)] == [0, 1, 2, 3]
        assert q4.dropped == 1

    def test_events_never_dropped(self, q4):
        eos = Event.eos()
        q4.push(0)
        q4.push(eos)
        q4.push(2)
        q4.push(3)
        # leak downstream evicts the oldest non-event (0), keeping eos
        assert q4.push(4, leaky="downstream") == OK_DROPPED_OLDEST
        popped = [q4.pop(0)[1] for _ in range(4)]
        assert popped[0] is eos
        assert popped[1:] == [2, 3, 4]

    def test_event_blocks_in_every_mode(self, q4):
        for i in range(4):
            q4.push(i)
        for mode in ("no", "downstream", "upstream"):
            assert q4.push(Event.eos(), leaky=mode, timeout_ms=10) == TIMEOUT
        assert q4.dropped == 0

    def test_shutdown_wakes_blocked_pop(self, q4):
        results = []

        def popper():
            results.append(q4.pop(-1))

        t = threading.Thread(target=popper)
        t.start()
        time.sleep(0.05)
        q4.shutdown()
        t.join(timeout=2)
        assert results == [(SHUTDOWN, None)]

    def test_shutdown_wakes_blocked_push(self, q4):
        for i in range(4):
            q4.push(i)
        results = []

        def pusher():
            results.append(q4.push(99))

        t = threading.Thread(target=pusher)
        t.start()
        time.sleep(0.05)
        q4.shutdown()
        t.join(timeout=2)
        assert results == [SHUTDOWN]

    def test_pop_drains_before_shutdown_reports(self, q4):
        q4.push("x")
        q4.shutdown()
        assert q4.pop(0) == (OK, "x")
        assert q4.pop(0) == (SHUTDOWN, None)

    def test_arbitrary_python_objects(self, q4):
        frame = Frame.of(torch.arange(3))
        q4.push(frame)
        status, out = q4.pop(0)
        assert status == OK and out is frame

    def test_stats_and_impl(self, q4):
        q4.push(1)
        assert q4.stats() == {"depth": 1, "capacity": 4, "dropped": 0}
        assert q4.impl == ("native" if isinstance(q4, NativeFrameQueue) else "python")


def _script(rng, n):
    """A seeded push/pop script over a queue of 3: pushes of frames or
    events in every leak mode (with a timeout, so nothing blocks for good),
    and pops."""
    steps = []
    for i in range(n):
        r = rng.random()
        if r < 0.6:
            steps.append(("push", i, bool(rng.random() < 0.15),
                          str(rng.choice(["no", "downstream", "upstream"]))))
        else:
            steps.append(("pop",))
    return steps


def _play(q, steps, event):
    out = []
    for st in steps:
        if st[0] == "push":
            _, i, is_event, mode = st
            item = event(i) if is_event else i
            out.append(("push", q.push(item, leaky=mode, timeout_ms=0), len(q), q.dropped))
        else:
            status, item = q.pop(0)
            if item is not None and not isinstance(item, int):
                item = ("event", item.payload)
            out.append(("pop", status, item, len(q)))
    q.shutdown()
    out.append(("after", q.pop(0)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sequences_agree_with_the_reference(seed):
    """The port's native queue, its twin and the JAX package's two queues
    give the same status, item, depth and drop count at every step."""
    steps = _script(np.random.default_rng(seed), 200)
    runs = {}
    for name, cls, ev in (("native", NativeFrameQueue, lambda i: Event("flush", i)),
                          ("python", PyFrameQueue, lambda i: Event("flush", i)),
                          ("jax_native", JNative, lambda i: JEvent("flush", i)),
                          ("jax_python", JPy, lambda i: JEvent("flush", i))):
        q = cls(3)
        try:
            runs[name] = _play(q, steps, ev)
        finally:
            q.close()
    assert runs["native"] == runs["python"] == runs["jax_native"] == runs["jax_python"]
    statuses = {r[1] for r in runs["native"] if r[0] == "push"}
    assert {OK, OK_DROPPED_OLDEST, DROPPED_INCOMING, TIMEOUT} <= statuses


class TestNativeSpecifics:
    def test_handle_table_empties(self):
        q = NativeFrameQueue(8)
        try:
            for i in range(8):
                q.push(i)
            for _ in range(8):
                q.pop(0)
            assert len(q._objs) == 0
            # rejected pushes leak no table entries either
            for i in range(8):
                q.push(i)
            q.push(99, leaky="upstream")
            q.push(98, leaky="no", timeout_ms=0)
            assert len(q._objs) == 8
            q.push(97, leaky="downstream")
            assert len(q._objs) == 8
        finally:
            q.close()

    def test_mpsc_stress(self):
        """4 producers x 1 consumer, 400 items, nothing lost or duplicated."""
        q = NativeFrameQueue(16)
        seen = []
        n_per = 100

        def produce(base):
            for i in range(n_per):
                q.push(base + i)

        def consume():
            while len(seen) < 4 * n_per:
                status, item = q.pop(200)
                if status == OK:
                    seen.append(item)
                elif status == SHUTDOWN:
                    return

        threads = [threading.Thread(target=produce, args=(k * 1000,)) for k in range(4)]
        consumer = threading.Thread(target=consume)
        consumer.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        consumer.join(timeout=10)
        q.close()
        assert sorted(seen) == sorted(k * 1000 + i for k in range(4) for i in range(n_per))


class TestBuildAndSwitch:
    def test_failed_build_raises_with_native_on(self, tmp_path, monkeypatch):
        """No silent fallback: a source g++ rejects raises, with its log."""
        bad = tmp_path / "frame_queue.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(NativeBuildError, match="g\\+\\+ failed"):
            native.build(bad)
        assert not any((tmp_path / "build").glob("*.so"))

    def test_missing_compiler_raises_from_make_frame_queue(self, tmp_path, monkeypatch):
        src = tmp_path / "frame_queue.cpp"
        src.write_text(native.SOURCE.read_text() + "\n// unbuilt\n")
        monkeypatch.setattr(native, "SOURCE", src)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(shutil, "which", lambda name: None)
        monkeypatch.delenv("NNSTPU_COMMON_NATIVE_RUNTIME", raising=False)
        with pytest.raises(NativeBuildError, match="g\\+\\+ not found"):
            make_frame_queue(4)
        monkeypatch.setenv("NNSTPU_COMMON_NATIVE_RUNTIME", "off")
        q = make_frame_queue(4)
        assert isinstance(q, PyFrameQueue) and q.impl == "python"

    def test_build_holds_no_lock_c23(self, tmp_path, monkeypatch):
        """ROADMAP C23: the first queues of three threads build the library
        with no lock held around ``g++`` (the JAX package holds its lock
        there: lockdep's blocking_call_under_lock)."""
        from nnstreamer_tpu_torch.analysis import lockdep

        src = tmp_path / "frame_queue.cpp"
        src.write_text(native.SOURCE.read_text() + "\n// fresh\n")
        monkeypatch.setattr(native, "SOURCE", src)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.delenv("NNSTPU_COMMON_NATIVE_RUNTIME", raising=False)
        fresh = lockdep.install()
        lockdep.reset()
        try:
            monkeypatch.setattr(native, "_lock", threading.Lock())  # a tracked lock
            queues = []
            ts = [threading.Thread(target=lambda: queues.append(make_frame_queue(4)))
                  for _ in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert len(queues) == 3 and all(q.impl == "native" for q in queues)
            assert lockdep.findings("blocking_call_under_lock") == [], lockdep.format_report()
            for q in queues:
                q.close()
        finally:
            if fresh:
                lockdep.uninstall()
            else:
                lockdep.reset()

    def test_unchanged_source_loads_from_disk(self, monkeypatch):
        path = native.build()
        mtime = path.stat().st_mtime_ns
        assert native.build() == path and path.stat().st_mtime_ns == mtime


class TestQueueElementIntegration:
    def test_element_uses_native_by_default(self, monkeypatch):
        from nnstreamer_tpu_torch.elements.queue import Queue

        monkeypatch.delenv("NNSTPU_COMMON_NATIVE_RUNTIME", raising=False)
        q = Queue(max_size_buffers=2)
        assert q.backend_kind == "native"
        assert q.stats()["impl"] == "native"
        q.stop()

    def test_element_python_via_conf(self, monkeypatch):
        from nnstreamer_tpu_torch.elements.queue import Queue

        monkeypatch.setenv("NNSTPU_COMMON_NATIVE_RUNTIME", "off")
        q = Queue(max_size_buffers=2)
        assert q.backend_kind == "python"
        q.stop()

    @pytest.mark.parametrize("native_on", ["on", "off"])
    def test_pipeline_through_queue(self, monkeypatch, native_on):
        import nnstreamer_tpu_torch as tnns
        from nnstreamer_tpu_torch.elements.queue import Queue
        from nnstreamer_tpu_torch.elements.sink import TensorSink
        from nnstreamer_tpu_torch.elements.testsrc import DataSrc

        monkeypatch.setenv("NNSTPU_COMMON_NATIVE_RUNTIME", native_on)
        data = [torch.full((3,), float(i)) for i in range(20)]
        got = []
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=data))
        q = p.add(Queue(max_size_buffers=4))
        sink = p.add(TensorSink(callback=lambda f: got.append(f)))
        p.link_chain(src, q, sink)
        p.start()
        assert q.backend_kind == ("native" if native_on == "on" else "python")
        assert p.wait(60)
        p.stop()
        assert len(got) == 20
        np.testing.assert_array_equal(np.asarray(got[7].tensors[0]), data[7].numpy())

    def test_leaky_downstream_pipeline_stays_live(self):
        """A slow consumer behind a leaky queue drops frames, not deadlocks."""
        import nnstreamer_tpu_torch as tnns
        from nnstreamer_tpu_torch.elements.queue import Queue
        from nnstreamer_tpu_torch.elements.sink import TensorSink
        from nnstreamer_tpu_torch.elements.testsrc import DataSrc

        got = []

        def slow_sink(frame):
            time.sleep(0.005)
            got.append(frame)

        data = [torch.full((2,), float(i)) for i in range(50)]
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=data))
        q = p.add(Queue(max_size_buffers=2, leaky="downstream"))
        sink = p.add(TensorSink(callback=slow_sink))
        p.link_chain(src, q, sink)
        p.start()
        assert q.stats()["impl"] == "native"
        assert p.wait(60)
        p.stop()
        assert 0 < len(got) <= 50
        # the last frame always survives leak-downstream (newest kept)
        np.testing.assert_array_equal(np.asarray(got[-1].tensors[0]), data[-1].numpy())
