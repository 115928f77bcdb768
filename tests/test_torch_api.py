"""The port's application API against the JAX package's.

:class:`SingleShot` (open, invoke, close, specs, ``set_input_spec``, the
timeout, the custom backend, closed raises) and :class:`PipelineHandle`
(indexing, ``src_input`` → sink callback, valve, output selector, unknown
names), with ``appsrc``/``appsink``, each against the reference's output on
the same model or launch string and the same inputs (numpy, fixed seeds).
Outputs are compared bit for bit where the models are float32
element-wise ops, and within 1e-6 relative for a sum (the two packages add
in another order).  The port runs on the CPU (``device="cpu"``, and
``device=cpu`` for a transform in a string).
"""

import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.api import InvokeTimeout as JInvokeTimeout
from nnstreamer_tpu.api import PipelineHandle as JPipelineHandle
from nnstreamer_tpu.api import SingleShot as JSingleShot
from nnstreamer_tpu.backends.jax_backend import JaxModel
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec
from nnstreamer_tpu.spec import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch.api import InvokeTimeout, PipelineHandle, SingleShot
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec


def _models(shape=(4,)):
    jm = JaxModel(apply=lambda p, x: x * 2 + 1,
                  input_spec=JTensorsSpec.of(JTensorSpec(dtype=np.float32, shape=shape)))
    tm = TorchModel(apply=lambda p, x: x * 2 + 1, device="cpu",
                    input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=shape)))
    return jm, tm


def _x(shape=(4,), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestSingleShot:
    def test_open_invoke_close(self):
        jm, tm = _models()
        x = _x()
        with JSingleShot(framework="jax", model=jm) as js:
            (want,) = js.invoke(x)
        with SingleShot(framework="torch", model=tm, device="cpu") as s:
            (got,) = s.invoke(x)
            (got_t,) = s.invoke(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))

    def test_specs_exposed(self):
        jm, tm = _models((2, 3))
        with JSingleShot(framework="jax", model=jm) as js, \
                SingleShot(framework="torch", model=tm, device="cpu") as s:
            for a, b in ((s.input_spec(), js.input_spec()), (s.output_spec(), js.output_spec())):
                assert a.tensors[0].shape == b.tensors[0].shape == (2, 3)
                assert str(a.tensors[0].dtype) == str(np.dtype(b.tensors[0].dtype))

    def test_set_input_spec_reconfigures(self):
        jm = JaxModel(apply=lambda p, x: x.sum(axis=-1))
        tm = TorchModel(apply=lambda p, x: x.sum(dim=-1), device="cpu")
        with JSingleShot(framework="jax", model=jm) as js, \
                SingleShot(framework="torch", model=tm, device="cpu") as s:
            want = js.set_input_spec(JTensorsSpec.of(JTensorSpec(np.float32, (5, 7))))
            got = s.set_input_spec(TensorsSpec.of(TensorSpec(np.float32, (5, 7))))
            assert got.tensors[0].shape == want.tensors[0].shape == (5,)
            assert s.input_spec().tensors[0].shape == (5, 7)
            x = _x((5, 7), 1)
            # a float32 sum of 7: XLA and torch add in another order
            np.testing.assert_allclose(s.invoke(x)[0].numpy(), np.asarray(js.invoke(x)[0]),
                                       rtol=1e-6, atol=0)

    def test_timeout_fires(self):
        class Slow:
            def invoke(self, x):
                time.sleep(1.0)
                return x

            def set_input_spec(self, spec):
                return spec

        js = JSingleShot(framework="custom", model=Slow(), timeout=0.2)
        with pytest.raises(JInvokeTimeout):
            js.invoke(np.zeros((2,), np.float32))
        js.close()
        s = SingleShot(framework="custom", model=Slow(), timeout=0.2, device="cpu")
        with pytest.raises(InvokeTimeout):
            s.invoke(np.zeros((2,), np.float32))
        s.close()

    def test_close_after_timeout_waits_for_the_invoke_in_flight(self):
        """close() returns at once, but the backend (a capture and its
        pool, on the card) is closed only after the timed-out invoke has
        returned; a second invoke waits for the first."""
        events = []
        release = threading.Event()

        class Slow:
            def invoke(self, x):
                events.append("invoke")
                release.wait(10)
                events.append("returned")
                return x + 1

            def set_input_spec(self, spec):
                return spec

        s = SingleShot(framework="custom", model=Slow(), timeout=0.05, device="cpu")
        backend_close = s.backend.close

        def close():
            events.append("backend closed")
            backend_close()

        s.backend.close = close
        with pytest.raises(InvokeTimeout):
            s.invoke(np.zeros((2,), np.float32))
        s.close()
        assert "backend closed" not in events
        with pytest.raises(RuntimeError, match="closed"):
            s.invoke(np.zeros((2,), np.float32))
        release.set()
        for _ in range(200):
            if "backend closed" in events:
                break
            time.sleep(0.01)
        assert events == ["invoke", "returned", "backend closed"]

    def test_invokes_are_serialized(self):
        """A direct invoke after a timed-out one runs only once that one
        has returned (a replay reuses the capture's static buffers)."""
        active, peak = [0], [0]
        lock = threading.Lock()

        class Tracked:
            def invoke(self, x):
                with lock:
                    active[0] += 1
                    peak[0] = max(peak[0], active[0])
                time.sleep(0.3)
                with lock:
                    active[0] -= 1
                return x

            def set_input_spec(self, spec):
                return spec

        s = SingleShot(framework="custom", model=Tracked(), timeout=0.05, device="cpu")
        with pytest.raises(InvokeTimeout):
            s.invoke(np.zeros((2,), np.float32))
        s.set_timeout(None)
        s.invoke(np.zeros((2,), np.float32))
        s.close()
        assert peak[0] == 1

    def test_custom_backend(self):
        with JSingleShot(framework="custom", model=lambda x: x + 5) as js:
            (want,) = js.invoke(np.zeros((3,), np.float32))
        with SingleShot(framework="custom", model=lambda x: x + 5, device="cpu") as s:
            (got,) = s.invoke(np.zeros((3,), np.float32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_closed_raises(self):
        for cls in (JSingleShot, SingleShot):
            kw = {} if cls is JSingleShot else {"device": "cpu"}
            s = cls(framework="custom", model=lambda x: x, **kw)
            s.close()
            with pytest.raises(RuntimeError):
                s.invoke(np.zeros((1,), np.float32))

    def test_cuda_without_a_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SingleShot(framework="custom", model=lambda x: x)

    def test_torch_backend_pinned_to_the_device(self, monkeypatch):
        """The torch backend is pinned to ``device``: a bare callable (a
        model the backend places itself) lands there whatever ``[filter]
        torch_device`` says, and a model on another device is refused."""
        monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cuda")
        with SingleShot(framework="torch", model=lambda x: x * 2, device="cpu") as s:
            assert s.backend.pinned_device == "cpu" and s.backend.device.type == "cpu"
            np.testing.assert_array_equal(s.invoke(np.ones(3, np.float32))[0].numpy(), [2, 2, 2])

        class Elsewhere(TorchModel):
            pass

        from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

        be = TorchBackend()
        be.pinned_device = "cuda"
        with pytest.raises(ValueError, match="pinned"):
            SingleShot(backend=be, model=Elsewhere(apply=lambda p, x: x, device="cpu"),
                       device="cpu")


CAPS = ("other/tensor, dimension=(string)4:1:1:1, type=(string)float32, "
        "framerate=(fraction)0/1")


def _both(desc, drive):
    """Run ``drive(handle, np_or_torch)`` on the reference's and the port's
    handle of ``desc``; returns (reference result, port result)."""
    out = []
    for H in (JPipelineHandle, PipelineHandle):
        h = H.construct(desc)
        with h:
            out.append(drive(h))
    return out


class TestPipelineHandle:
    def test_construct_indexes_elements(self):
        desc = (f"appsrc name=in caps='{CAPS}' ! valve name=v ! output-selector name=s "
                "s.src_0 ! tensor_sink name=a s.src_1 ! appsink name=b")
        for H in (JPipelineHandle, PipelineHandle):
            h = H.construct(desc)
            assert set(h.sources) == {"in"} and set(h.valves) == {"v"}
            assert set(h.sinks) == {"a", "b"} and set(h.switches) == {"s"}

    def test_src_input_to_sink_callback(self):
        xs = [_x(seed=i) for i in range(3)]

        def drive(h):
            got = []
            h.sink_register("out", lambda f: got.append(np.asarray(f.tensor(0))))
            h.start()
            for x in xs:
                h.src_input("in", x if isinstance(h, JPipelineHandle) else torch.from_numpy(x))
            h.src_eos("in")
            assert h.wait(10)
            return got

        want, got = _both(f"appsrc name=in caps='{CAPS}' ! tensor_sink name=out", drive)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_transform_after_appsrc(self):
        xs = [_x(seed=10 + i) for i in range(3)]

        def drive(h):
            got = []
            h.sink_register("out", lambda f: got.append(np.asarray(f.tensor(0))))
            h.start()
            for x in xs:
                h.src_input("in", x)
            h.src_eos("in")
            assert h.wait(10)
            return got

        out = []
        for H, dev in ((JPipelineHandle, ""), (PipelineHandle, " device=cpu")):
            h = H.construct(f"appsrc name=in caps='{CAPS}' ! tensor_transform "
                            f"mode=arithmetic option=mul:3,add:0.5{dev} ! tensor_sink name=out")
            with h:
                out.append(drive(h))
        for g, w in zip(out[1], out[0]):
            np.testing.assert_array_equal(g, w)

    def test_valve_control(self):
        def drive(h):
            h.start()
            h.src_input("in", np.zeros((4,), np.float32))
            time.sleep(0.2)
            h.valve_set_open("v", True)
            h.src_input("in", np.ones((4,), np.float32))
            h.src_eos("in")
            assert h.wait(10)
            sink = h.sinks["out"]
            return sink.num_frames, [np.asarray(f.tensor(0)) for f in sink.frames]

        (wn, wf), (gn, gf) = _both(f"appsrc name=in caps='{CAPS}' ! valve name=v drop=true ! "
                                   "tensor_sink name=out collect=true", drive)
        assert gn == wn == 1
        np.testing.assert_array_equal(gf[0], wf[0])

    def test_switch_select(self):
        def drive(h):
            h.start()
            pads = set(h.switch_pads("sel"))
            h.src_input("in", np.zeros((4,), np.float32))
            time.sleep(0.2)
            h.switch_select("sel", "src_1")
            h.src_input("in", np.ones((4,), np.float32))
            h.src_eos("in")
            assert h.wait(10)
            return pads, h.sinks["a"].num_frames, h.sinks["b"].num_frames

        want, got = _both(f"appsrc name=in caps='{CAPS}' ! output-selector name=sel "
                          "sel.src_0 ! tensor_sink name=a collect=true "
                          "sel.src_1 ! tensor_sink name=b collect=true", drive)
        assert got == want == ({"src_0", "src_1"}, 1, 1)

    def test_input_selector(self):
        """Two appsrcs into an input-selector: only the active pad's frames
        pass, before and after a switch."""
        def drive(h):
            got = []
            h.sink_register("out", lambda f: got.append(float(np.asarray(f.tensor(0))[0])))
            h.start()
            h.src_input("a", np.full((4,), 1, np.float32))
            h.src_input("b", np.full((4,), 2, np.float32))
            time.sleep(0.3)
            h.switch_select("sel", "sink_1")
            h.src_input("a", np.full((4,), 3, np.float32))
            h.src_input("b", np.full((4,), 4, np.float32))
            time.sleep(0.3)
            h.src_eos("a")
            h.src_eos("b")
            assert h.wait(10)
            return sorted(h.switch_pads("sel")), got

        want, got = _both(f"input-selector name=sel ! tensor_sink name=out "
                          f"appsrc name=a caps='{CAPS}' ! sel.sink_0 "
                          f"appsrc name=b caps='{CAPS}' ! sel.sink_1", drive)
        assert got == want == (["sink_0", "sink_1"], [1.0, 4.0])

    def test_unknown_names_raise(self):
        for H in (JPipelineHandle, PipelineHandle):
            h = H.construct(f"appsrc name=in caps='{CAPS}' ! tensor_sink name=out")
            for call in (lambda: h.sink_register("nope", lambda f: None),
                         lambda: h.valve_set_open("nope", True),
                         lambda: h.switch_select("nope", "src_0"),
                         lambda: h.src_input("nope", np.zeros(4, np.float32))):
                with pytest.raises(KeyError):
                    call()
            with pytest.raises(ValueError):
                h.pipeline.nodes["out"].connect("no-such-signal", lambda f: None)


class TestAppElements:
    def test_appsrc_hands_tensors_on_without_a_copy(self):
        from nnstreamer_tpu_torch.elements.app import AppSrc

        src = AppSrc(caps=CAPS)
        x = np.arange(4, dtype=np.float32)
        t = torch.arange(4, dtype=torch.float32)
        src.push_frame(Frame.of(x))
        src.push_frame(Frame.of(t))
        src.end_of_stream()
        a, b = list(src.frames())
        assert isinstance(a.tensor(0), torch.Tensor)
        assert a.tensor(0).data_ptr() == x.ctypes.data  # the array's own memory
        assert b.tensor(0) is t

    def test_appsink_pull_against_reference(self):
        xs = [_x(seed=20 + i) for i in range(3)]

        def drive(h):
            h.start()
            for x in xs:
                h.src_input("in", x)
            h.src_eos("in")
            sink = h.sinks["out"]
            got = []
            while (f := sink.pull(timeout=None)) is not None:
                got.append(np.asarray(f.tensor(0)))
            return got

        want, got = _both(f"appsrc name=in caps='{CAPS}' ! appsink name=out", drive)
        assert len(got) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_appsink_drop_keeps_the_newest(self):
        from nnstreamer_tpu_torch.elements.app import AppSink

        sink = AppSink(max_buffers=2, drop=True)
        for i in range(5):
            sink.process(None, Frame.of(torch.tensor([i])))
        sink.drain()
        assert [int(sink.pull().tensor(0)[0]) for _ in range(2)] == [3, 4]
        assert sink.pull() is None and sink.num_frames == 5
