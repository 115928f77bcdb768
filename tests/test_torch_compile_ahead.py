"""The port's per-geometry captures on the CPU: the backend's LRU of
captures and its key.

There is no card here, so the tests install a capture function of
``capture_graph``'s signature on the backend (``TorchBackend.capture``); it
calls the function a few times, as the real one does before capturing, and
returns an entry that runs it eagerly.  The cases mirror the JAX package's
``tests/test_compile_ahead.py`` where they have a counterpart (LRU order and
``compile_cache``, a key that changes with what was compiled, a fused
filter's renegotiation staying correct).  Outputs are compared exactly: the
same eager torch ops run on both sides.  The tests that need the card (a
replay equals the eager call, outputs are not aliased, the kernels run
inside a graph) carry the ``cuda`` marker.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.backends import exec_cache
from nnstreamer_tpu_torch.backends import torch_backend as tb
from nnstreamer_tpu_torch.backends.torch_backend import CapturedGraph, TorchBackend, TorchModel
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.node import NegotiationError
from nnstreamer_tpu_torch.ops import kernels as K
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec


def spec(*shape, dtype=np.float32):
    return TensorsSpec.of(TensorSpec(dtype=dtype, shape=shape))


def poly_model(scale=2.0, d=4, name="poly"):
    w = torch.full((d,), scale)
    return TorchModel(apply=lambda params, x: x * params + 1, params=w, device="cpu",
                      name=name, input_spec=spec(None, d))


class FakeCapture:
    """A capture function for the CPU: ``warmup_calls`` eager calls on
    zeros, then an entry that runs the function eagerly.  Logs each
    capture's spec."""

    def __init__(self, warmup_calls=2):
        self.log = []
        self.warmup_calls = warmup_calls

    def __call__(self, fn, in_spec, device):
        self.log.append(tuple(tuple(t.shape) for t in in_spec.tensors))
        zeros = [torch.zeros(t.shape, dtype=torch.float32, device=device)
                 for t in in_spec.tensors]
        for _ in range(self.warmup_calls):
            fn(*zeros)
        return _EagerEntry(fn, self.warmup_calls)


class _EagerEntry:
    def __init__(self, fn, warmup_calls):
        self.fn = fn
        self.warmup_calls = warmup_calls
        self.capture_s = self.warmup_s = 0.0

    def run(self, xs):
        return tb._as_tuple(self.fn(*xs))


def backend(custom="", model=None, capture=None):
    be = TorchBackend()
    be.capture = capture if capture is not None else FakeCapture()
    be.open(model or poly_model(), custom)
    return be


class TestCaptureLRU:
    def test_cpu_backend_runs_eagerly_without_a_capture(self):
        be = TorchBackend()
        be.open(poly_model())
        be.reconfigure(spec(2, 4))
        assert be._entry is None and be.stats["captures"] == 0
        out = be.invoke((torch.ones(2, 4),))
        assert torch.equal(out[0], torch.full((2, 4), 3.0))
        assert be.stats["replays"] == 0

    def test_invoke_replays_the_selected_capture(self):
        be = backend()
        be.reconfigure(spec(2, 4))
        x = torch.arange(8.0).reshape(2, 4)
        assert torch.equal(be.invoke((x,))[0], x * 2 + 1)
        assert be.stats["captures"] == 1 and be.stats["replays"] == 1
        assert be.stats["warmup_calls"] == 2

    @pytest.mark.parametrize("custom", ["compile_cache=2", "compile_cache:2"])
    def test_lru_hit_and_evict_order(self, custom):
        cap = FakeCapture()
        be = backend(custom, capture=cap)
        for b in (1, 2, 1, 3, 2):
            be.reconfigure(spec(b, 4))
        # 1, 2 captured; 1 hits; 3 evicts the least recent (2); 2 again
        assert cap.log == [((1, 4),), ((2, 4),), ((3, 4),), ((2, 4),)]
        assert be.stats["captures"] == 4 and be.stats["hits"] == 1
        assert be.stats["evictions"] == 2
        assert len(be._graphs) == 2

    def test_default_cache_size_and_bad_value(self):
        assert backend()._cache_size == tb.DEFAULT_COMPILE_CACHE == 8
        assert backend("compile_cache=lots")._cache_size == 8
        assert backend("compile_cache=0")._cache_size == 1

    def test_reopen_drops_captures(self):
        be = backend()
        be.reconfigure(spec(2, 4))
        be.open(poly_model(scale=3.0))
        assert not be._graphs
        be.reconfigure(spec(2, 4))
        assert be.stats["captures"] == 2
        assert torch.equal(be.invoke((torch.ones(2, 4),))[0], torch.full((2, 4), 4.0))

    def test_set_wrapper_keys_captures_by_stages(self):
        be = backend()
        be.reconfigure(spec(2, 4))
        be.set_wrapper(lambda f: (lambda x: f(x) * 10), stages=["x10"])
        assert be._entry is None  # nothing selected until negotiation
        be.reconfigure_fused(spec(2, 4), spec(2, 4))
        assert torch.equal(be.invoke((torch.ones(2, 4),))[0], torch.full((2, 4), 30.0))
        # a rebuild of the same stages selects their capture
        be.set_wrapper(lambda f: (lambda x: f(x) * 10), stages=["x10"])
        be.reconfigure_fused(spec(2, 4), spec(2, 4))
        assert be.stats["hits"] == 1 and be.stats["captures"] == 2
        # back to the bare model: its capture is still in the LRU
        be.set_wrapper(None)
        be.reconfigure(spec(2, 4))
        assert be.stats["hits"] == 2 and be.stats["captures"] == 2
        assert torch.equal(be.invoke((torch.ones(2, 4),))[0], torch.full((2, 4), 3.0))

    def test_uncapturable_function_raises_naming_model_and_op(self):
        def model_fn(params, x):
            if float(x.sum()) > 0:  # a host read: no capture takes this
                return x
            return x + params

        def refusing(fn, in_spec, device):
            del in_spec, device
            try:
                fn(torch.ones(1, 4))
            except RuntimeError:
                raise
            raise RuntimeError("operation not permitted when stream is capturing")

        be = backend(model=TorchModel(apply=model_fn, params=torch.ones(4), device="cpu",
                                      name="syncing_model"), capture=refusing)
        with pytest.raises(NegotiationError, match="syncing_model") as err:
            be.reconfigure(spec(1, 4))
        assert "test_torch_compile_ahead.py" in str(err.value)
        assert "cannot be captured" in str(err.value)
        assert be._entry is None and be.stats["captures"] == 0

    def test_filter_surfaces_capture_failure_at_negotiation(self):
        def refusing(fn, in_spec, device):
            raise RuntimeError("capture refused")

        be = TorchBackend()
        be.capture = refusing
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[np.ones((2, 4), np.float32)]))
        filt = p.add(TensorFilter(backend=be, model=poly_model()))
        sink = p.add(TensorSink())
        p.link_chain(src, filt, sink)
        with pytest.raises(NegotiationError, match="poly"):
            p.start()
        assert p.state != "PLAYING"


class TestCapturedGraphRun:
    """The entry's run protocol with a stand-in graph: static inputs are
    overwritten, outputs are clones."""

    def _entry(self):
        static_in = (torch.zeros(3),)
        static_out = (torch.zeros(3),)

        class Graph:
            def replay(self):
                static_out[0].copy_(static_in[0] * 2)

        return CapturedGraph(Graph(), None, static_in, static_out, 3, 0.0, 0.0)

    def test_outputs_are_clones_not_aliases(self):
        e = self._entry()
        a = e.run([torch.ones(3)])[0]
        b = e.run([torch.full((3,), 5.0)])[0]
        assert torch.equal(a, torch.full((3,), 2.0))  # not overwritten by frame 2
        assert torch.equal(b, torch.full((3,), 10.0))
        assert a.data_ptr() != b.data_ptr() != e.static_out[0].data_ptr()

    def test_wrong_shape_raises(self):
        with pytest.raises(ValueError, match="captured for"):
            self._entry().run([torch.ones(4)])


class TestKeys:
    def test_fingerprint_covers_stages_params_and_sources(self, monkeypatch):
        base = exec_cache.fingerprint(["a"], {"w": torch.zeros(3)})
        assert exec_cache.fingerprint(["a"], {"w": torch.ones(3)}) == base  # values don't count
        assert exec_cache.fingerprint(["b"], {"w": torch.zeros(3)}) != base
        assert exec_cache.fingerprint(["a"], {"w": torch.zeros(4)}) != base
        assert exec_cache.fingerprint(["a"], {"w": torch.zeros(3, dtype=torch.int8)}) != base
        monkeypatch.setattr(exec_cache, "sources_digest", lambda: "edited")
        assert exec_cache.fingerprint(["a"], {"w": torch.zeros(3)}) != base

    def test_param_signature_walks_the_tree(self):
        class Q:
            def __init__(self):
                self.q = torch.zeros(2, 3, dtype=torch.int8)
                self.scale = 0.5

        sig = exec_cache.param_signature({"b": [torch.zeros(2)], "a": Q()})
        assert sig == [["a", ["Q", [["q", ["torch.int8", [2, 3]]], ["scale", ["0.5"]]]]],
                       ["b", [["torch.float32", [2]]]]]
        lin = torch.nn.Linear(3, 2)
        assert exec_cache.param_signature(lin) == exec_cache.param_signature(lin.state_dict())

    def test_the_same_key_hits(self):
        cap = FakeCapture()
        be = backend(capture=cap)
        be.reconfigure(spec(2, 4))
        be.reconfigure(spec(2, 4))
        assert len(cap.log) == 1 and be.stats["hits"] == 1

    @pytest.mark.parametrize("change", ["spec", "dtype", "label", "stages", "params",
                                        "sources"])
    def test_each_part_of_the_key_recaptures(self, change, monkeypatch):
        cap = FakeCapture()
        be = backend(capture=cap)
        be.reconfigure(spec(2, 4))
        in_spec = spec(2, 4)
        if change == "spec":
            in_spec = spec(3, 4)
        elif change == "dtype":
            be.model.input_spec = None  # a model that takes any dtype
            in_spec = spec(2, 4, dtype=np.float64)
        elif change == "label":
            be.segment_label = "c+f+d"
        elif change == "stages":
            be.set_wrapper(None, stages=["another chain"])
        elif change == "params":
            be.model.params = torch.zeros(4, dtype=torch.float64)
            be.set_wrapper(None)  # a new function: its fingerprint is taken afresh
        else:
            monkeypatch.setattr(exec_cache, "sources_digest", lambda: "edited")
            be.set_wrapper(None)
        be.reconfigure(in_spec)
        assert len(cap.log) == 2 and be.stats["hits"] == 0


class TestFusedFilterCaptures:
    """A fused filter (normalize folded in) under the injected capture."""

    OPTION = "typecast:float32,add:-127.5,div:127.5"

    def _pipeline(self, cap, frames, option=OPTION):
        be = TorchBackend()
        be.capture = cap
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=frames))
        tr = p.add(tnns.make("tensor_transform", mode="arithmetic", option=option,
                             acceleration="pallas", device="cpu"))
        filt = p.add(TensorFilter(backend=be, model=poly_model()))
        sink = p.add(TensorSink(collect=True))
        p.link_chain(src, tr, filt, sink)
        return p, filt, sink

    def _frames(self, n=3):
        return [np.random.default_rng(i).integers(0, 256, (2, 4)).astype(np.uint8)
                for i in range(n)]

    def test_fused_capture_computes_the_chain(self):
        cap = FakeCapture()
        frames = self._frames()
        p, filt, sink = self._pipeline(cap, frames)
        p.run(timeout=30)
        be = filt.backend
        assert cap.log == [((2, 4),)]  # the raw uint8 geometry, once
        assert be.stats["captures"] == 1 and be.stats["replays"] == 3
        ops = [("typecast", np.dtype(np.float32)), ("add", -127.5), ("div", 127.5)]
        for f, got in zip(frames, sink.frames):
            want = K.fused_arith_plain(torch.from_numpy(f), ops) * 2 + 1
            assert torch.equal(got.tensor(0), want)

    def test_renegotiating_the_same_chain_hits(self):
        cap = FakeCapture()
        p, filt, _ = self._pipeline(cap, self._frames(1))
        p.start()
        try:
            assert p.wait(30)
            raw = filt.sink_pads["sink"].spec
            filt.configure({"sink": raw})  # the wrapper is rebuilt for the same stages
            be = filt.backend
            assert be.stats["captures"] == 1 and be.stats["hits"] == 1
        finally:
            p.stop()

    def test_another_chain_captures_afresh(self):
        cap = FakeCapture()
        p, filt, _ = self._pipeline(cap, self._frames(1))
        p.start()
        try:
            assert p.wait(30)
            raw = filt.sink_pads["sink"].spec
            other = tnns.make("tensor_transform", mode="arithmetic",
                              option="typecast:float32,div:255.0", acceleration="pallas",
                              device="cpu")
            filt.set_fused_transforms([other], [])
            filt.configure({"sink": raw})
            be = filt.backend
            assert be.stats["captures"] == 2 and be.stats["hits"] == 0
            x = torch.full((2, 4), 255, dtype=torch.uint8)
            assert torch.equal(be.invoke((x,))[0], torch.full((2, 4), 3.0))
        finally:
            p.stop()


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _cuda_pipeline(frames, model):
    p = tnns.parse_launch(
        "datasrc name=s ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 acceleration=pallas ! "
        "tensor_upload ! queue max-size-buffers=4 ! tensor_filter framework=torch name=f ! "
        "tensor_sink name=out collect=true")
    p["s"].data = frames
    p["f"].model = model
    return p


@pytest.mark.cuda
def test_cuda_capture_replays_equal_eager_and_not_aliased(cuda_device):
    w = torch.randn(4, 5, device=cuda_device)
    model = TorchModel(apply=lambda params, x: x.reshape(-1, 4) @ params, params=w,
                       device=cuda_device)
    frames = [np.random.default_rng(i).integers(0, 256, (6, 4)).astype(np.uint8)
              for i in range(5)]
    p = _cuda_pipeline(frames, model)
    p.start()
    try:
        assert p.wait(120)
        be = p["f"].backend
        assert be.stats["captures"] == 1 and be.stats["replays"] == 5
        outs = [f.tensor(0) for f in p["out"].frames]
        assert len({o.data_ptr() for o in outs}) == 5
        for f, o in zip(frames, outs):
            assert torch.equal(o, be.eager(torch.from_numpy(f))[0])
    finally:
        p.stop()


@pytest.mark.cuda
def test_cuda_kernels_launch_inside_the_graph(cuda_device):
    model = TorchModel(apply=lambda params, x: x * 2, device=cuda_device)
    frames = [np.full((8, 8, 3), i, np.uint8) for i in range(6)]
    K.reset_launches()
    p = _cuda_pipeline(frames, model)
    p.run(timeout=120)
    # warm-up calls and the capture launch the wrapper; replays do not
    assert K.fused_arith.launches == tb.WARMUP_CALLS + 1
    assert len(p["out"].frames) == 6
    ops = [("typecast", np.dtype(np.float32)), ("add", -127.5), ("div", 127.5)]
    for f, got in zip(frames, p["out"].frames):
        want = K.fused_arith_plain(torch.from_numpy(f).to(cuda_device), ops) * 2
        assert torch.equal(got.tensor(0), want)


@pytest.mark.cuda
def test_cuda_fused_drift_recaptures_and_matches_eager(cuda_device):
    """The drift guard on the card (``tests/test_torch_drift.py`` on the
    CPU): a fused filter fed (8,8,3) uint8, (5,4,3), (8,8,3) again and an
    int16 frame with no caps event recaptures twice, hits once, and every
    output equals the eager call on the same frame."""
    from nnstreamer_tpu_torch.buffer import Frame

    be = TorchBackend()
    be.open(TorchModel(apply=lambda p, x: x * 2, device=cuda_device))
    filt = TensorFilter(backend=be)
    tr = tnns.make("tensor_transform", mode="arithmetic",
                   option="typecast:float32,add:-127.5,div:127.5", acceleration="pallas")
    filt.set_fused_transforms([tr], [])
    filt.start()
    try:
        first = spec(8, 8, 3, dtype=np.uint8)
        tr.configure({"sink": first})
        filt.configure({"sink": first})
        frames = [torch.full((8, 8, 3), 7, dtype=torch.uint8),
                  torch.full((5, 4, 3), 9, dtype=torch.uint8),
                  torch.full((8, 8, 3), 11, dtype=torch.uint8),
                  torch.full((8, 8, 3), 1000, dtype=torch.int16)]
        for x in frames:
            x = x.to(cuda_device)
            out = filt.process(None, Frame.of(x)).tensors[0]
            assert torch.equal(out, be.eager(x)[0])
        assert be.stats["captures"] == 3 and be.stats["hits"] == 1
        assert float(out.flatten()[0]) == pytest.approx((1000 - 127.5) / 127.5 * 2, rel=1e-6)
    finally:
        filt.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "shape"])
def test_cuda_bare_drift_direct_invoke(cuda_device, case):
    """C3 on the card, a bare model: an int32 frame to a (2,3) float32
    capture of ``x * 2`` gives int32, and an (8,3,3) frame to a (4,6,3)
    capture gives (8,3,3), each by a capture of its own (the JAX backend
    recompiles; before the drift guard the first came back cast to float32
    and the second raised)."""
    be = TorchBackend()
    be.open(TorchModel(apply=lambda p, x: x * 2, device=cuda_device))
    if case == "dtype":
        be.reconfigure(spec(2, 3))
        x = torch.ones(2, 3, dtype=torch.int32, device=cuda_device)
    else:
        be.reconfigure(spec(4, 6, 3))
        x = torch.arange(8 * 3 * 3, dtype=torch.float32, device=cuda_device).reshape(8, 3, 3)
    (out,) = be.invoke((x,))
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out, x * 2)
    assert be.stats["captures"] == 2
