"""The port's ``tensor_transform`` element against the JAX package's.

Each case runs one pipeline per package, ``datasrc → tensor_transform →
tensor_sink``, on the same numpy input; the port runs with
``device="cpu"``.  Both the data and the negotiated output spec must agree.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JaxDataSrc
from nnstreamer_tpu.elements.transform import TensorTransform as JaxTransform
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.elements.transform import TensorTransform


def _run_jax(x, **props):
    p = jnns.Pipeline()
    src = p.add(JaxDataSrc(data=[x]))
    tr = p.add(JaxTransform(**props))
    sink = p.add(JaxSink(collect=True))
    p.link_chain(src, tr, sink)
    p.run(timeout=60)
    return np.asarray(sink.frames[0].tensor(0)), tr.src_pads["src"].spec.tensors[0]


def _run_port(x, **props):
    p = tnns.Pipeline()
    src = p.add(DataSrc(data=[torch.from_numpy(x) if isinstance(x, np.ndarray) else x]))
    tr = p.add(TensorTransform(device="cpu", **props))
    sink = p.add(TensorSink(collect=True))
    p.link_chain(src, tr, sink)
    p.run(timeout=60)
    out = sink.frames[0].tensor(0)
    assert out.device.type == "cpu"
    return out.numpy(), tr.src_pads["src"].spec.tensors[0]


def _check(x, exact=True, **props):
    got, got_spec = _run_port(x, **props)
    want, want_spec = _run_jax(x, **props)
    assert got_spec.dtype == want_spec.dtype and got_spec.shape == want_spec.shape
    assert got.dtype == want.dtype == got_spec.dtype
    assert got.shape == want.shape == got_spec.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        # stand: mean and std are reductions summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


IMG = np.random.default_rng(0).integers(0, 256, (16, 24, 3)).astype(np.uint8)
F32 = np.random.default_rng(1).standard_normal((2, 3, 4)).astype(np.float32) * 10


class TestModes:
    @pytest.mark.parametrize("accel", [True, "pallas"])
    def test_typecast(self, accel):
        _check(IMG, mode="typecast", option="float32", acceleration=accel)
        _check(F32, mode="typecast", option="int16", acceleration=accel)

    @pytest.mark.parametrize("accel", [True, "pallas"])
    def test_arithmetic_normalize(self, accel):
        _check(IMG, mode="arithmetic", option="typecast:float32,add:-127.5,div:127.5",
               acceleration=accel)

    @pytest.mark.parametrize("accel", [True, "pallas"])
    def test_arithmetic_integer_chain(self, accel):
        x = np.arange(-20, 20, dtype=np.int32)
        _check(x, mode="arithmetic", option="mul:3,add:1", acceleration=accel)
        # narrow ints: wraps on the plain path, int32 up front under pallas
        _check(IMG, mode="arithmetic", option="add:200,div:2", acceleration=accel)

    @pytest.mark.parametrize("option", ["1:0:2:3", "2:0:1:3", "0:2:1:3"])
    def test_transpose(self, option):
        _check(F32, mode="transpose", option=option)
        _check(IMG, mode="transpose", option=option, acceleration="pallas")

    @pytest.mark.parametrize("option", ["0:2", "2:0", "1:0"])
    def test_dimchg(self, option):
        _check(F32, mode="dimchg", option=option)

    @pytest.mark.parametrize("option", ["default", "default:per-channel"])
    def test_stand(self, option):
        _check(IMG, exact=False, mode="stand", option=option)
        _check(F32, exact=False, mode="stand", option=option)

    @pytest.mark.parametrize("accel", [True, "pallas"])
    def test_clamp(self, accel):
        _check(F32, mode="clamp", option="-5:5", acceleration=accel)
        _check(IMG, mode="clamp", option="10:200", acceleration=accel)


class TestPromotion:
    """tests/test_pallas_quant.py:278,301,321 on every acceleration path."""

    @pytest.mark.parametrize("accel", ["pallas", True, False])
    def test_out_of_range_literal_promotes(self, accel):
        x = np.array([0, 1, 200, 255], np.uint8)
        _check(x, mode="arithmetic", option="add:-128", acceleration=accel)
        got, _ = _run_port(x, mode="arithmetic", option="add:-128", acceleration=accel)
        np.testing.assert_array_equal(got, x.astype(np.float32) - 128)

    @pytest.mark.parametrize("accel", ["pallas", True, False])
    def test_negative_clamp_on_unsigned(self, accel):
        x = np.array([0, 1, 2, 3], np.uint8)
        _check(x, mode="clamp", option="-1:1", acceleration=accel)
        got, _ = _run_port(x, mode="clamp", option="-1:1", acceleration=accel)
        np.testing.assert_array_equal(got, [0, 1, 1, 1])

    @pytest.mark.parametrize("accel", ["pallas", True, False])
    def test_implicit_promotion_negotiated(self, accel):
        x = np.arange(8, dtype=np.uint8)
        _check(x, mode="arithmetic", option="div:2.0", acceleration=accel)
        got, spec = _run_port(x, mode="arithmetic", option="div:2.0", acceleration=accel)
        assert spec.dtype == np.float32
        np.testing.assert_array_equal(got, x / 2.0)


# ROADMAP C1's inputs.  acceleration=false is the JAX element's numpy rule on
# the host; true and pallas are the jit rules, and must not move.
C1_CASES = {
    "normalize_u8": (np.arange(256, dtype=np.uint8),
                     dict(mode="arithmetic", option="typecast:float32,add:-127.5,div:127.5")),
    "div_int_literal": (np.array([14, 190, 121], np.uint8),
                        dict(mode="arithmetic", option="div:3")),
    "f32_to_int8": (np.array([-456.76, 219.39, 300.0], np.float32),
                    dict(mode="typecast", option="int8")),
    "negative_to_uint32": (np.array([-1.5, -3.0, -1000.25, 7.0], np.float32),
                           dict(mode="arithmetic", option="typecast:uint32,add:-1")),
}


class TestHostRule:
    @pytest.mark.parametrize("accel", [False, True, "pallas"])
    @pytest.mark.parametrize("case", sorted(C1_CASES))
    def test_roadmap_c1_inputs_match_reference(self, case, accel):
        x, props = C1_CASES[case]
        _check(x, acceleration=accel, **props)

    def test_host_rule_values(self):
        """The reference's numpy results, written out.  numpy leaves an
        out-of-range float-to-int cast to the platform: these are x86's,
        where the value is truncated to int32 and then wraps to the target
        width (-456 -> 56, 219 -> -37, 300 -> 44)."""
        got, _ = _run_port(np.array([-456.76, 219.39, 300.0], np.float32), mode="typecast",
                           option="int8", acceleration=False)
        np.testing.assert_array_equal(got, np.array([56, -37, 44], np.int8))
        got, _ = _run_port(np.array([14, 190, 121], np.uint8), mode="arithmetic",
                           option="div:3", acceleration=False)
        np.testing.assert_array_equal(got, (np.array([14, 190, 121]) / 3).astype(np.float32))
        assert got[0] == np.float32(4.6666665)
        got, _ = _run_port(np.arange(256, dtype=np.uint8), mode="arithmetic",
                           option="typecast:float32,add:-127.5,div:127.5", acceleration=False)
        assert got[1] == np.float32(-0.99215686)
        got, _ = _run_port(np.array([-1.5, -3.0], np.float32), mode="arithmetic",
                           option="typecast:uint32,add:-1", acceleration=False)
        assert got.dtype == np.float32 and (got > 4.29e9).all()  # the cast wrapped
        # the jit rules saturate instead
        got, _ = _run_port(np.array([-456.76, 219.39, 300.0], np.float32), mode="typecast",
                           option="int8", acceleration=True)
        np.testing.assert_array_equal(got, np.array([-128, 127, 127], np.int8))

    @pytest.mark.parametrize("mode,option", [("transpose", "1:0:2:3"), ("dimchg", "0:2"),
                                             ("stand", "default"),
                                             ("stand", "default:per-channel"),
                                             ("clamp", "-5:5")])
    def test_other_modes_on_host_match_reference(self, mode, option):
        _check(F32, mode=mode, option=option, acceleration=False)

    def test_host_rule_output_lands_on_element_device(self):
        tr = TensorTransform(device="cpu", mode="arithmetic", option="div:3",
                             acceleration=False)
        spec = tnns.TensorsSpec.of(tnns.TensorSpec(dtype=np.uint8, shape=(3,)))
        tr.configure({"sink": spec})
        out = tr.process(None, tnns.Frame.of(torch.tensor([14, 190, 121], dtype=torch.uint8)))
        assert out.tensor(0).dtype == torch.float32 and out.tensor(0).device.type == "cpu"


# ROADMAP C6's inputs: float32 1e-39 and -5.8e-39, bfloat16 bits 0x0001,
# 0x007F and 0x8001 (9.2e-41, 1.166e-38, -9.2e-41), beside a normal value.
C6_F32 = np.array([1e-39, -5.8e-39, 2.0], np.float32)
C6_BF16_BITS = np.array([0x0001, 0x007F, 0x8001, 0x4000], np.uint16)


class TestSubnormals:
    """C6, repaired: the jit rules (``true``, ``pallas``) flush float32 and
    bfloat16 subnormals in float arithmetic to zeros of their sign, as XLA
    does; the host rule (``false``) keeps them, as the reference's numpy
    does.  Compared bit for bit, so a zero's sign counts."""

    @pytest.mark.parametrize("accel", [False, True, "pallas"])
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("props", [dict(mode="arithmetic", option="mul:2"),
                                       dict(mode="arithmetic", option="div:2"),
                                       dict(mode="clamp", option="-1:1")])
    def test_roadmap_c6_inputs_match_reference(self, props, dt, accel):
        if dt == "bfloat16":
            jx = C6_BF16_BITS.view(ml_dtypes.bfloat16)
            tx = torch.from_numpy(C6_BF16_BITS.view(np.int16)).view(torch.bfloat16)
        else:
            jx, tx = C6_F32, torch.from_numpy(C6_F32)
        want, _ = _run_jax(jx, acceleration=accel, **props)
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[tx]))
        tr = p.add(TensorTransform(device="cpu", acceleration=accel, **props))
        sink = p.add(TensorSink(collect=True))
        p.link_chain(src, tr, sink)
        p.run(timeout=60)
        got = sink.frames[0].tensor(0)
        bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        got = got.view(bits).numpy()
        want = want.view(got.dtype)
        np.testing.assert_array_equal(got, want)
        sub = slice(0, len(got) - 1)
        mag = np.int32(0x7FFF) if bits == torch.int16 else np.int32(0x7FFFFFFF)
        kept = (got[sub] & mag) != 0  # the host rule may still underflow one to 0
        assert kept.any() if accel is False else not kept.any()


@pytest.mark.parametrize("props", [dict(mode="typecast", option="bfloat16"),
                                   dict(mode="arithmetic", option="typecast:bfloat16,add:1")])
def test_bfloat16_streams_match_reference(props):
    """bfloat16 streams were refused at negotiation before the kernel and
    the chains took bfloat16; now every acceleration takes them, and they
    give the reference's bits (``tests/test_torch_bf16.py`` has the rest)."""
    x = np.array([0.5, -3.25, 1e10, 7.0], np.float32)
    for accel in ("pallas", True, False):
        want, want_spec = _run_jax(x, acceleration=accel, **props)
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[torch.from_numpy(x)]))
        tr = p.add(TensorTransform(device="cpu", acceleration=accel, **props))
        sink = p.add(TensorSink(collect=True))
        p.link_chain(src, tr, sink)
        p.run(timeout=60)
        got = sink.frames[0].tensor(0)
        assert got.dtype == torch.bfloat16 and tr.src_pads["src"].spec.tensors[0].dtype.name \
            == want_spec.dtype.name == "bfloat16"
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      want.view(np.uint16))


def test_pallas_rejects_dtypes_without_kernel():
    with pytest.raises(tnns.NegotiationError):
        _run_port(np.zeros(4, np.int64), mode="arithmetic", option="add:1",
                  acceleration="pallas")


@pytest.mark.parametrize("value,want", [("yes", True), ("off", False), ("orc", "pallas"),
                                        ("pallas", "pallas"), (False, False)])
def test_acceleration_property_spellings(value, want):
    tr = TensorTransform(device="cpu", mode="typecast", option="float32", acceleration=value)
    assert tr.acceleration == want
    with pytest.raises(ValueError, match="bad boolean"):
        TensorTransform(device="cpu", mode="typecast", option="float32", acceleration="ture")


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TensorTransform(mode="typecast", option="float32")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tnns.make("tensor_transform", mode="arithmetic", option="add:1")


def test_frame_is_made_contiguous_for_the_kernel():
    """The element hands the kernel a contiguous tensor on its device, even
    when the frame arrives as a strided view."""
    tr = TensorTransform(device="cpu", mode="arithmetic", option="add:1",
                         acceleration="pallas")
    spec = tnns.TensorsSpec.of(tnns.TensorSpec(dtype=np.int32, shape=(4, 2)))
    tr.configure({"sink": spec})
    x = torch.arange(8, dtype=torch.int32).reshape(2, 4).t()  # non-contiguous
    out = tr.process(None, tnns.Frame.of(x)).tensor(0)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), x.numpy() + 1)
