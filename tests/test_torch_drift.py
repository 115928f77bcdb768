"""The torch backend's per-frame drift guard, against the JAX backend's.

A frame whose shape or dtype drifted without a caps event (a polymorphic
upstream pad) must never be cast or reshaped into the old geometry: a bare
model is reconfigured for it, a fused one rebuilt by its filter through the
drift hook.  The JAX package's ``tests/test_renegotiation.py::
TestBackendDriftGuard`` cases run here in both packages on the same inputs.
Each runs twice: eagerly on the CPU, and with an injected capture whose
entry is a :class:`CapturedGraph` (static inputs of the spec's dtype and
shape, its ``run`` checks) over a stand-in graph that replays the function
eagerly, as on the card.  The ``cuda`` twin, with real captures, is in
``tests/test_torch_compile_ahead.py``, which imports no JAX.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_backend import JaxBackend, JaxModel
from nnstreamer_tpu.buffer import Frame as JaxFrame
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.elements.transform import TensorTransform as JaxTransform
from nnstreamer_tpu.spec import TensorSpec as JaxTensorSpec, TensorsSpec as JaxTensorsSpec
from nnstreamer_tpu_torch.backends import torch_backend as tb
from nnstreamer_tpu_torch.backends.torch_backend import CapturedGraph, TorchBackend, TorchModel
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.transform import TensorTransform
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec, torch_dtype


class GraphCapture:
    """``capture_graph``'s contract on the CPU: static inputs of the spec's
    dtypes and shapes, the warm-up calls, and a :class:`CapturedGraph`
    whose graph replays the function eagerly into its static outputs."""

    def __init__(self):
        self.log = []

    def __call__(self, fn, in_spec, device):
        self.log.append(tuple((str(t.dtype), tuple(t.shape)) for t in in_spec.tensors))
        static_in = tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=device)
                          for t in in_spec.tensors)
        for _ in range(tb.WARMUP_CALLS):
            fn(*static_in)
        static_out = tb._as_tuple(fn(*static_in))

        class Graph:
            def replay(self):
                for o, r in zip(static_out, tb._as_tuple(fn(*static_in))):
                    o.copy_(r)

        return CapturedGraph(Graph(), fn, static_in, static_out, tb.WARMUP_CALLS, 0.0, 0.0)


CAPTURES = pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])


def torch_backend(apply, captured):
    be = TorchBackend()
    if captured:
        be.capture = GraphCapture()
    be.open(TorchModel(apply=apply, device="cpu"))
    return be


def jax_spec(dtype, *shape):
    return JaxTensorsSpec.of(JaxTensorSpec(dtype=dtype, shape=shape))


def spec(dtype, *shape):
    return TensorsSpec.of(TensorSpec(dtype=dtype, shape=shape))


class TestBackendDriftGuard:
    @CAPTURES
    def test_shape_drift_direct_invoke(self, captured):
        x = np.arange(8 * 3 * 3, dtype=np.float32).reshape(8, 3, 3)
        ref = JaxBackend()
        ref.open(JaxModel(apply=lambda p, x: x + 0.0))
        ref.reconfigure(jax_spec(np.float32, 4, 6, 3))
        (want,) = ref.invoke((x,))
        be = torch_backend(lambda p, x: x + 0.0, captured)
        be.reconfigure(spec(np.float32, 4, 6, 3))
        (out,) = be.invoke((torch.from_numpy(x),))  # same element count, new geometry
        assert out.shape == (8, 3, 3) == want.shape
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        if captured:
            assert be.stats["captures"] == 2 and be.stats["replays"] == 1

    @CAPTURES
    def test_dtype_drift_direct_invoke(self, captured):
        x = np.ones((2, 3), np.int32)
        ref = JaxBackend()
        ref.open(JaxModel(apply=lambda p, x: x * 2))
        ref.reconfigure(jax_spec(np.float32, 2, 3))
        (want,) = ref.invoke((x,))
        be = torch_backend(lambda p, x: x * 2, captured)
        be.reconfigure(spec(np.float32, 2, 3))
        (out,) = be.invoke((torch.from_numpy(x),))
        assert out.dtype == torch.int32 and np.dtype(want.dtype) == np.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        # the drifted spec has its own capture and output spec
        assert np.dtype(be.output_spec().tensors[0].dtype) == np.int32
        if captured:
            assert be.capture.log == [(("float32", (2, 3)),), (("int32", (2, 3)),)]

    @CAPTURES
    def test_fused_shape_drift_rebuilds_wrapper(self, captured):
        """A fused transpose bakes its geometry: drift re-installs the fused
        chain through the drift hook, and the first spec's capture is hit
        again afterwards."""
        a = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
        d = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)

        def run(filt, tr, spec_a, frame, wrap):
            filt.set_fused_transforms([tr], [])
            filt.start()
            tr.configure({"sink": spec_a})
            filt.configure({"sink": spec_a})
            try:
                return [np.asarray(filt.process(None, frame.of(wrap(x))).tensors[0])
                        for x in (a, d, a + 1.0)]
            finally:
                filt.stop()

        want = run(JaxFilter(framework="jax", model=JaxModel(apply=lambda p, x: x * 2.0)),
                   JaxTransform(mode="transpose", option="1:0:2:3"),
                   jax_spec(np.float32, 4, 6, 3), JaxFrame, lambda x: x)
        be = torch_backend(lambda p, x: x * 2.0, captured)
        filt = TensorFilter(backend=be)
        got = run(filt, TensorTransform(mode="transpose", option="1:0:2:3", device="cpu"),
                  spec(np.float32, 4, 6, 3), Frame, torch.from_numpy)
        for g, w, x in zip(got, want, (a, d, a + 1.0)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, x.transpose(0, 2, 1) * 2.0)
        if captured:
            assert be.stats["captures"] == 2 and be.stats["hits"] == 1
            assert be.stats["replays"] == 3


class TestGuard:
    def test_wrapper_without_hook_raises(self):
        be = torch_backend(lambda p, x: x, captured=True)
        be.set_wrapper(lambda f: f, stages=["id"])
        be.reconfigure_fused(spec(np.float32, 2, 3), spec(np.float32, 2, 3))
        with pytest.raises(ValueError, match="no drift hook"):
            be.invoke((torch.ones(3, 2),))

    def test_same_spec_frames_replay_without_rebinding(self):
        be = torch_backend(lambda p, x: x + 1, captured=True)
        be.reconfigure(spec(np.int16, 5))
        for i in range(3):
            (out,) = be.invoke((torch.full((5,), i, dtype=torch.int16),))
            assert torch.equal(out, torch.full((5,), i + 1, dtype=torch.int16))
        assert be.stats["captures"] == 1 and be.stats["replays"] == 3

    def test_rank_drift_against_a_declared_spec_refuses(self):
        be = TorchBackend()
        be.capture = GraphCapture()
        be.open(TorchModel(apply=lambda p, x: x, device="cpu",
                           input_spec=spec(np.float32, None, 4)))
        be.reconfigure(spec(np.float32, 2, 4))
        with pytest.raises(ValueError, match="incompatible with model spec"):
            be.invoke((torch.ones(2, 5),))

    def test_captured_graph_refuses_a_dtype_it_was_not_captured_for(self):
        static_in = (torch.zeros(3),)
        static_out = (torch.zeros(3),)

        class Graph:
            def replay(self):
                static_out[0].copy_(static_in[0] * 2)

        entry = CapturedGraph(Graph(), None, static_in, static_out, 3, 0.0, 0.0)
        with pytest.raises(ValueError, match="captured for torch.float32"):
            entry.run([torch.ones(3, dtype=torch.int32)])
