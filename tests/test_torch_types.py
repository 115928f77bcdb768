"""The port's stream types against the JAX package's.

Spec helpers, caps and dims strings (the port's strings must equal the
reference's, and each package must parse the other's), the bfloat16 stream
dtype, the ``Frame`` helpers and ``WireTensor``, ``parse_bool``, the media
specs, the converter's ``input-dim`` / ``input-type`` reinterpretation and
stride strip, ``audiotestsrc`` and ``videotestsrc is-live``, and the
filter's ``input=`` / ``output=`` properties.  Every comparison is exact:
none of these computes in floating point.
"""

import time
from fractions import Fraction

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu import media as jmedia
from nnstreamer_tpu import spec as jspec
from nnstreamer_tpu.buffer import Frame as JaxFrame
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.elements.testsrc import AudioTestSrc as JaxAudioTestSrc
from nnstreamer_tpu.utils.props import parse_bool as jax_parse_bool
from nnstreamer_tpu_torch import media as tmedia
from nnstreamer_tpu_torch import spec as tspec
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.buffer import Frame, WireTensor
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.testsrc import AudioTestSrc, VideoTestSrc
from nnstreamer_tpu_torch.utils.props import parse_bool

J_BF16 = np.dtype(ml_dtypes.bfloat16)

# (dtype name, numpy shape) lists: one frame's tensors each
SPECS = [
    [("uint8", (224, 224, 3))],
    [("float32", (12,))],
    [("int16", (16000, 1))],
    [("bfloat16", (16000, 1))],
    [("float32", (2, 3, 4, 5))],
    [("uint8", (7,)), ("float32", (1, 10)), ("bfloat16", (4, 4))],
    [("int64", (3, 1)), ("float16", (1,))],
]
RATES = [None, Fraction(0), Fraction(30), Fraction(30000, 1001), Fraction(1, 10)]


def _specs(pkg, tensors, rate):
    return pkg.TensorsSpec(tensors=tuple(pkg.TensorSpec(dtype=pkg.dtype_from_name(n), shape=s)
                                         for n, s in tensors), rate=rate)


def _names(spec):
    """(dtype name, shape) of each tensor of a spec of either package."""
    return [(tspec.dtype_name(t.dtype), t.shape) for t in spec.tensors]


class TestSpecHelpers:
    @pytest.mark.parametrize("tensors", SPECS, ids=str)
    def test_counts_and_dims_strings_match_reference(self, tensors):
        got, want = _specs(tspec, tensors, None), _specs(jspec, tensors, None)
        assert got.num_tensors == want.num_tensors == len(tensors)
        for g, w in zip(got.tensors, want.tensors):
            assert g.num_elements == w.num_elements
            assert g.nbytes == w.nbytes
            assert g.dims_string() == w.dims_string()
            # parsing squeezes leading numpy 1-dims, in both packages
            back = tspec.TensorSpec.from_dims_string(w.dims_string(), tspec.dtype_name(g.dtype))
            theirs = jspec.TensorSpec.from_dims_string(w.dims_string(), jspec.dtype_name(w.dtype))
            assert back.shape == theirs.shape and back.dtype is g.dtype
            assert back.num_elements == g.num_elements

    @pytest.mark.parametrize("dims", ["3:224:224:1", "3:224:224", "1:16000", "12", "1:1:1:1",
                                      "5:1:3"])
    def test_from_dims_string_squeezes_like_reference(self, dims):
        got = tspec.TensorSpec.from_dims_string(dims, "uint8")
        want = jspec.TensorSpec.from_dims_string(dims, "uint8")
        assert got.shape == want.shape and tspec.dtype_name(got.dtype) == "uint8"

    @pytest.mark.parametrize("dims", ["", "0:3", "1:2:3:4:5", "a:b"])
    def test_bad_dims_strings_raise_in_both(self, dims):
        for pkg in (tspec, jspec):
            with pytest.raises(ValueError):
                pkg.TensorSpec.from_dims_string(dims)

    def test_compatibility_and_validation(self):
        fixed = tspec.TensorSpec(dtype=np.float32, shape=(3, 4))
        assert fixed.is_compatible(tspec.TensorSpec(shape=(None, 4)))
        assert not fixed.is_compatible(tspec.TensorSpec(dtype=np.int8))
        fixed.validate_array(torch.zeros(3, 4))
        fixed.validate_array(np.zeros((3, 4), np.float32))
        with pytest.raises(ValueError, match="does not match"):
            fixed.validate_array(torch.zeros(4, 3))
        with pytest.raises(ValueError, match="not fixed"):
            tspec.TensorSpec(shape=(None, 4)).num_elements
        ts = tspec.TensorsSpec.of(fixed)
        assert ts.is_compatible(tspec.TensorsSpec.of(tspec.TensorSpec()))
        assert not ts.is_compatible(tspec.TensorsSpec.of(fixed, fixed))
        spec = tnns.spec_of(torch.zeros(2, dtype=torch.int16), np.zeros(3, np.uint8), rate=5)
        want = jnns.spec_of(np.zeros(2, np.int16), np.zeros(3, np.uint8), rate=5)
        assert _names(spec) == _names(want) == [("int16", (2,)), ("uint8", (3,))]
        assert spec.rate == want.rate == 5

    def test_supported_dtypes_match_reference(self):
        assert tspec.supported_dtypes() == jspec.supported_dtypes()


class TestCaps:
    @pytest.mark.parametrize("rate", RATES, ids=str)
    @pytest.mark.parametrize("tensors", SPECS, ids=str)
    def test_caps_string_equals_reference_and_round_trips(self, tensors, rate):
        got, want = _specs(tspec, tensors, rate), _specs(jspec, tensors, rate)
        caps = got.to_caps_string()
        assert caps == want.to_caps_string()
        back = tspec.TensorsSpec.from_caps_string(caps)
        assert back.rate == (rate if rate is not None else 0)
        assert [t.dims_string() for t in back.tensors] == [t.dims_string() for t in got.tensors]
        assert back.to_caps_string() == caps
        theirs = jspec.TensorsSpec.from_caps_string(caps)
        assert [(jspec.dtype_name(t.dtype), t.shape) for t in theirs.tensors] == \
            [(tspec.dtype_name(t.dtype), t.shape) for t in back.tensors]

    @pytest.mark.parametrize("caps", [
        "video/x-raw, format=RGB",
        "other/tensors, num_tensors=(int)3, dimensions=(string)3:1:1:1,6:5:4:2, "
        "types=(string)float32,uint8, framerate=(fraction)0/1",
        "other/tensors, dimensions=(string)3, types=(string)float32,uint8",
    ])
    def test_bad_caps_raise_in_both(self, caps):
        for pkg in (tspec, jspec):
            with pytest.raises(ValueError):
                pkg.TensorsSpec.from_caps_string(caps)


class TestBFloat16:
    def test_dtype_maps_and_names(self):
        assert tspec.dtype_from_name("bfloat16") is tspec.BFLOAT16
        assert tspec.numpy_dtype(torch.bfloat16) is tspec.BFLOAT16
        assert tspec.numpy_dtype(J_BF16) is tspec.BFLOAT16
        assert tspec.torch_dtype(tspec.BFLOAT16) is torch.bfloat16
        assert tspec.dtype_name(torch.bfloat16) == "bfloat16"
        assert tspec.BFLOAT16.itemsize == J_BF16.itemsize == 2

    def test_spec_of_a_bfloat16_tensor(self):
        t = tspec.TensorSpec.from_array(torch.zeros(16000, 1, dtype=torch.bfloat16))
        assert t.dtype is tspec.BFLOAT16 and t.nbytes == 32000
        assert t == tspec.TensorSpec(dtype="bfloat16", shape=(16000, 1))
        assert t != tspec.TensorSpec(dtype=np.float16, shape=(16000, 1))
        assert t.intersect(tspec.TensorSpec(dtype=np.uint16)) is None
        want = jspec.TensorsSpec.of(jspec.TensorSpec(dtype=J_BF16, shape=(16000, 1)), rate=1)
        assert tspec.TensorsSpec.of(t, rate=1).to_caps_string() == want.to_caps_string()

    def test_bfloat16_frames_flow_and_renegotiate(self):
        xs = [torch.arange(4, dtype=torch.bfloat16), torch.arange(6, dtype=torch.bfloat16)]
        p = tnns.Pipeline()
        src = p.add(tnns.make("datasrc", data=xs))
        sink = p.add(tnns.make("tensor_sink", collect=True))
        p.link_chain(src, sink)
        p.run(timeout=60)
        assert [f.tensor(0).dtype for f in sink.frames] == [torch.bfloat16] * 2
        assert sink.sink_pads["sink"].spec.tensors[0].dtype is tspec.BFLOAT16
        host = sink.frames[1].to_host().tensor(0)
        assert host.dtype == torch.bfloat16  # numpy has no bfloat16: a torch tensor
        np.testing.assert_array_equal(host.view(torch.uint16).numpy(),
                                      np.arange(6).astype(J_BF16).view(np.uint16))


class TestFrame:
    @pytest.mark.parametrize("pts,duration", [(0, 10), (5, -1), (-1, 10), (100, 0)])
    def test_end_ts_and_counts_match_reference(self, pts, duration):
        got = Frame.of(torch.zeros(2), torch.ones(3), pts=pts, duration=duration)
        want = JaxFrame.of(np.zeros(2), np.ones(3), pts=pts, duration=duration)
        assert got.end_ts == want.end_ts
        assert got.num_tensors == want.num_tensors == 2

    def test_to_host_keeps_timing_and_meta(self):
        f = Frame.of(torch.arange(3), np.arange(2), pts=7, duration=3, label="x")
        h = f.to_host()
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in h.tensors)
        assert (h.pts, h.duration, h.meta) == (7, 3, {"label": "x"})
        np.testing.assert_array_equal(h.tensor(1).numpy(), np.arange(2))

    def test_wire_tensor_presents_the_logical_array(self):
        data = torch.arange(24, dtype=torch.int16)
        w = WireTensor(data, (2, 3, 4), torch.int16)
        assert (w.shape, w.ndim, w.size, w.nbytes, len(w)) == ((2, 3, 4), 3, 24, 48, 2)
        assert w.dtype == np.int16
        np.testing.assert_array_equal(np.asarray(w), np.arange(24).reshape(2, 3, 4))
        np.testing.assert_array_equal(np.asarray(w, dtype=np.float32),
                                      np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        assert torch.equal(w[1], data.view(2, 3, 4)[1])
        with pytest.raises(ValueError, match="without a copy"):
            w.__array__(copy=False)
        with pytest.raises(TypeError):
            len(WireTensor(torch.zeros(1), (), np.float32))
        assert repr(w) == "WireTensor(int16(2, 3, 4))"


SPELLINGS = [True, False, 0, 1, "1", "0", "true", "TRUE", " yes ", "on", "off", "no", "false",
             "False", ""]


@pytest.mark.parametrize("value", SPELLINGS, ids=repr)
def test_parse_bool_matches_reference(value):
    assert parse_bool(value) is jax_parse_bool(value)


@pytest.mark.parametrize("value", ["ture", "2", "y", "enabled"])
def test_parse_bool_refuses_what_reference_refuses(value):
    for fn in (parse_bool, jax_parse_bool):
        with pytest.raises(ValueError, match="bad boolean"):
            fn(value, name="sync")


class TestMedia:
    @pytest.mark.parametrize("fmt", sorted(tmedia.AUDIO_FORMATS))
    @pytest.mark.parametrize("fpt", [1, 1600])
    def test_audio_spec_matches_reference(self, fmt, fpt):
        got = tmedia.AudioSpec(format=fmt, channels=2, sample_rate=16000).tensor_spec(fpt)
        want = jmedia.AudioSpec(format=fmt, channels=2, sample_rate=16000).tensor_spec(fpt)
        assert _names(got) == _names(want)
        assert got.rate == want.rate

    def test_text_and_octet_specs_match_reference(self):
        assert tmedia.TextSpec(size=64).tensor_spec().tensors[0].shape == \
            jmedia.TextSpec(size=64).tensor_spec().tensors[0].shape == (64,)
        inner = tspec.TensorsSpec.of(tspec.TensorSpec(dtype=np.float32, shape=(4,)))
        assert tmedia.OctetSpec(spec=inner).tensor_spec() == inner
        for pkg in (tmedia, jmedia):
            with pytest.raises(ValueError, match="input-dim"):
                pkg.OctetSpec().tensor_spec()
            with pytest.raises(ValueError, match="unsupported audio format"):
                pkg.AudioSpec(format="S24LE")


def _run_both(data_for, *elements, **run):
    """``datasrc ! elements ! tensor_sink`` in both packages: (port, reference)
    frames."""
    outs = []
    for nns in (tnns, jnns):
        p = nns.Pipeline()
        chain = [p.add(nns.make("datasrc", data=data_for(nns)))]
        chain += [p.add(nns.make(name, **props)) for name, props in elements]
        chain.append(p.add(nns.make("tensor_sink", collect=True)))
        p.link_chain(*chain)
        p.run(timeout=60, **run)
        outs.append(chain[-1].frames)
    return outs


def _same_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_tensors == w.num_tensors
        for a, b in zip(g.tensors, w.tensors):
            b = np.asarray(b)
            assert tspec.dtype_name(a.dtype) == jspec.dtype_name(b.dtype)
            np.testing.assert_array_equal(a.numpy(), b)
        assert (g.pts, g.duration) == (w.pts, w.duration)


RAW = np.random.default_rng(3).integers(0, 256, 96).astype(np.uint8)


class TestConverter:
    @pytest.mark.parametrize("dim,typ", [("4:6", "float32"), ("4:3:2", "int16"), ("96", ""),
                                         ("3:4", "uint16"), ("8:3", "bfloat16"),
                                         ("2:3", "float64")])
    def test_reinterpretation_matches_reference(self, dim, typ):
        """One buffer of 96 bytes: one tensor, or several sent on one by one."""
        props = {"input_dim": dim, "input_type": typ} if typ else {"input_dim": dim}

        def data(nns):
            conv = torch.from_numpy if nns is tnns else np.asarray
            return [nns.Frame.of(conv(RAW.copy()), pts=0, duration=1000),
                    nns.Frame.of(conv(RAW[::-1].copy()), pts=1000, duration=1000)]

        got, want = _run_both(data, ("tensor_converter", props))
        if typ == "bfloat16":   # numpy has no bfloat16 in the port: compare the bits
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.tensor(0).view(torch.uint16).numpy(),
                                              np.asarray(w.tensor(0)).view(np.uint16))
                assert (g.pts, g.duration) == (w.pts, w.duration)
        else:
            _same_frames(got, want)

    def test_reinterpretation_with_frames_per_tensor(self):
        def data(nns):
            conv = torch.from_numpy if nns is tnns else np.asarray
            return [conv(RAW.copy())]

        got, want = _run_both(data, ("tensor_converter",
                                     {"input_dim": "4:2", "input_type": "int32",
                                      "frames_per_tensor": 3}))
        _same_frames(got, want)
        assert tuple(got[0].tensor(0).shape) == (3, 2, 4)

    def test_unaligned_buffer_is_reinterpreted(self):
        conv = tnns.make("tensor_converter", input_dim="4", input_type="int32")
        spec = tspec.TensorsSpec.of(tspec.TensorSpec(dtype=np.uint8, shape=(16,)))
        conv.configure({"sink": spec})
        raw = torch.from_numpy(RAW[:17].copy())[1:]  # starts one byte into its storage
        out = conv.process(None, Frame.of(raw))
        np.testing.assert_array_equal(out[0].tensor(0).numpy(), RAW[1:17].view(np.int32))

    @pytest.mark.parametrize("pkg", [tnns, jnns], ids=["port", "reference"])
    def test_byte_size_mismatch_refused_at_negotiation(self, pkg):
        p = pkg.Pipeline()
        x = np.zeros(10, np.uint8)
        src = p.add(pkg.make("datasrc", data=[torch.from_numpy(x) if pkg is tnns else x]))
        conv = p.add(pkg.make("tensor_converter", input_dim="4", input_type="float32"))
        sink = p.add(pkg.make("tensor_sink"))
        p.link_chain(src, conv, sink)
        with pytest.raises(Exception, match="not a multiple"):
            p.run(timeout=60)

    def test_stride_strip_matches_reference(self):
        raw = np.random.default_rng(2).integers(0, 256, (3, 8, 1)).astype(np.uint8)

        def data(nns):
            x = raw if nns is jnns else torch.from_numpy(raw)
            return [nns.Frame.of(x, media=nns.VideoSpec(format="GRAY8", width=5, height=3),
                                 stride=8, width=5)]

        got, want = _run_both(data, ("tensor_converter", {}))
        _same_frames(got, want)
        assert tuple(got[0].tensor(0).shape) == (3, 5, 1)

    @pytest.mark.parametrize("fpt", [1, 4])
    def test_audio_through_frames_per_tensor(self, fpt):
        def data(nns):
            src = (AudioTestSrc if nns is tnns else JaxAudioTestSrc)(
                num_buffers=8, samplesperbuffer=160, channels=2, rate=8000)
            return list(src.frames())

        got, want = _run_both(data, ("tensor_converter", {"frames_per_tensor": fpt}))
        _same_frames(got, want)

    def test_text_buffers_pass_as_uint8(self):
        text = np.frombuffer(b"hello world\0\0\0\0\0", np.uint8)

        def data(nns):
            x = text.copy() if nns is jnns else torch.from_numpy(text.copy())
            return [nns.Frame.of(x, media=nns.TextSpec(size=16))]

        got, want = _run_both(data, ("tensor_converter", {}))
        _same_frames(got, want)


class TestSources:
    @pytest.mark.parametrize("kw", [
        dict(samplesperbuffer=1600, rate=16000, freq=440),
        dict(samplesperbuffer=100, rate=8000, freq=1000, channels=2, format="S32LE"),
        dict(samplesperbuffer=64, format="F32LE", freq=333.3),
        dict(samplesperbuffer=64, format="U8"),
        dict(samplesperbuffer=64, wave="silence"),
    ], ids=str)
    def test_audiotestsrc_bit_identical_to_reference(self, kw):
        got = list(AudioTestSrc(num_buffers=5, **kw).frames())
        want = list(JaxAudioTestSrc(num_buffers=5, **kw).frames())
        _same_frames(got, want)
        assert got[0].meta["media"].format == want[0].meta["media"].format
        a = AudioTestSrc(num_buffers=5, **kw).output_spec()
        b = JaxAudioTestSrc(num_buffers=5, **kw).output_spec()
        assert _names(a) == _names(b)
        assert a.rate == b.rate

    def test_audiotestsrc_from_a_launch_string(self):
        p = tnns.parse_launch("audiotestsrc num-buffers=3 samplesperbuffer=10 ! "
                              "tensor_sink name=out collect=true")
        p.run(timeout=60)
        assert [tuple(f.tensor(0).shape) for f in p["out"].frames] == [(10, 1)] * 3

    @pytest.mark.parametrize("live", ["true", True])
    def test_videotestsrc_is_live_keeps_the_framerate(self, live):
        src = VideoTestSrc(num_buffers=4, width=4, height=4, framerate="50/1", is_live=live)
        t0 = time.perf_counter()
        frames = list(src.frames())
        assert len(frames) == 4 and time.perf_counter() - t0 >= 3 / 50

    def test_videotestsrc_is_live_from_a_launch_string(self):
        p = tnns.parse_launch("videotestsrc name=v num-buffers=1 is-live=false ! fakesink")
        assert p["v"].is_live is False
        with pytest.raises(ValueError, match="bad boolean"):
            tnns.parse_launch("videotestsrc is-live=ture ! fakesink")


class TestFilterSpecProps:
    @pytest.mark.parametrize("dims,types", [("3:224:224:1", "uint8"), ("1:16000.12", "float32,int8"),
                                            ("", "float32"), ("4:4", ""), ("2.3", "bfloat16")])
    def test_parse_matches_reference(self, dims, types):
        got = TensorFilter._parse_spec_props(dims, types)
        want = JaxFilter._parse_spec_props(dims, types)
        assert [(t.dtype and tspec.dtype_name(t.dtype), t.shape) for t in got.tensors] == \
            [(t.dtype and jspec.dtype_name(t.dtype), t.shape) for t in want.tensors]
        assert TensorFilter._parse_spec_props("", "") is None

    def _run(self, **props):
        model = TorchModel(apply=lambda params, x: x.sum(dim=0), device="cpu",
                           input_spec=tspec.TensorsSpec.of(tspec.TensorSpec(dtype=np.float32,
                                                                            shape=(4, 3))))
        p = tnns.Pipeline()
        src = p.add(tnns.make("datasrc", data=[torch.ones(4, 3)]))
        filt = p.add(TensorFilter(framework="torch", model=model, **props))
        sink = p.add(tnns.make("tensor_sink", collect=True))
        p.link_chain(src, filt, sink)
        p.run(timeout=60)
        return sink.frames[0].tensor(0)

    def test_matching_properties_pass(self):
        out = self._run(input="3:4", inputtype="float32", output="3", outputtype="float32")
        assert torch.equal(out, torch.full((3,), 4.0))

    @pytest.mark.parametrize("props,match", [
        (dict(input="4:3", inputtype="float32"), "input property"),
        (dict(inputtype="int8"), "input property"),
        (dict(output="4"), "output property"),
        (dict(outputtype="uint8"), "output property"),
    ])
    def test_conflicting_properties_refused(self, props, match):
        with pytest.raises(Exception, match=match):
            self._run(**props)

    @pytest.mark.parametrize("props,ok", [("input=3 inputtype=float32 output=3", True),
                                          ("inputtype=uint8", False), ("output=4", False)])
    def test_properties_checked_under_fusion(self, props, ok):
        """With a transform folded before the filter, input= holds against
        the transform's output and output= against the model's."""
        p = tnns.parse_launch(
            "datasrc name=s ! tensor_transform mode=typecast option=float32 device=cpu ! "
            f"tensor_filter framework=torch name=f {props} ! tensor_sink name=out collect=true")
        p["s"].data = [torch.arange(3, dtype=torch.uint8)]
        p["f"].model = TorchModel(apply=lambda params, x: x * 2, device="cpu")
        if ok:
            p.run(timeout=60)
            assert p["f"].backend._wrapper is not None  # the transform folded
            assert torch.equal(p["out"].frames[0].tensor(0), torch.tensor([0., 2., 4.]))
        else:
            with pytest.raises(Exception, match="property"):
                p.run(timeout=60)
