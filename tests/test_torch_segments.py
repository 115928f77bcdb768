"""Transform fusion and whole-segment compilation in the port.

Planning boundaries, the undo/restore lifecycle, per-element fallback and
fused-equals-unfused parity, mirroring the JAX package's
``tests/test_segments.py``; then the detection slice end to end (videotestsrc
→ converter → normalize → SSD → bounding_boxes → sink, 96x96, 5 labels,
float32) through the port and through the JAX package, both with segments
on (the JAX package also with its Pallas NMS switch on; the port has no
such switch and always calls its NMS kernel's wrapper).  The port runs on
``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.models import ssd_mobilenet as js
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.conf import DEFAULTS, Conf
from nnstreamer_tpu_torch.elements.converter import TensorConverter
from nnstreamer_tpu_torch.elements.decoder import DecoderPlugin, TensorDecoder, register_decoder
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.elements.transform import TensorTransform
from nnstreamer_tpu_torch.graph import segments
from nnstreamer_tpu_torch.graph.node import Node
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb
from nnstreamer_tpu_torch.models import ssd_mobilenet as ts
from nnstreamer_tpu_torch.ops import nms as tnms
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

SIZE, LABELS, FRAMES = 96, 5, 3
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
# exp and sigmoid differ by ulps between XLA, numpy and PyTorch, and the
# float32 trunks sum in another order: a detection's prob may move by a
# few ulps of 1.0 between the two packages, and between the port's device
# stage and its numpy host decode.
PROB_ATOL = 1e-5


def _double_model(shape=(4,)):
    return TorchModel(apply=lambda params, x: x * 2, device="cpu",
                      input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=shape)))


def _plan_for(p, filt):
    return {pl.filter: pl for pl in segments.plan_segments(p)}[filt.name]


class _Tee(Node):
    """A 1-to-2 fan point (the port has no tee element yet)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src_0")
        self.add_src_pad("src_1")

    def process(self, pad, frame):
        return [("src_0", frame), ("src_1", frame)]


class _Mux(Node):
    """A 2-to-1 node."""

    def __init__(self, name=None):
        super().__init__(name)
        self.add_sink_pad("sink_0")
        self.add_sink_pad("sink_1")
        self.add_src_pad("src")


@register_decoder("seg_test_host_only")
class _HostOnlyPlugin(DecoderPlugin):
    """A decoder with no device lowering."""

    def out_spec(self, in_spec):
        return in_spec

    def decode(self, frame, in_spec):
        return frame


@register_decoder("seg_test_refuser")
class _RefusingPlugin(DecoderPlugin):
    """Offers device_stage but refuses every geometry."""

    def init(self, options):
        self.stage_calls = 0

    def out_spec(self, in_spec):
        return in_spec

    def device_stage(self, in_spec):
        self.stage_calls += 1
        return None

    def decode(self, frame, in_spec):
        frame.meta["host_decoded"] = True
        return frame


class TestPlanning:
    def test_tee_cuts_both_directions(self):
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[np.zeros(4, np.float32)]))
        tee = p.add(_Tee())
        filt = p.add(TensorFilter(framework="torch", model=_double_model()))
        tee2 = p.add(_Tee())
        s1, s2, s3 = (p.add(TensorSink(collect=True)) for _ in range(3))
        p.link(src, tee)
        p.link(f"{tee.name}.src_0", filt)
        p.link(f"{tee.name}.src_1", s1)
        p.link(filt, tee2)
        p.link(f"{tee2.name}.src_0", s2)
        p.link(f"{tee2.name}.src_1", s3)
        plan = _plan_for(p, filt)
        assert not plan.folds
        assert (tee.name, "fan-out") in plan.cuts
        assert (tee2.name, "fan-out") in plan.cuts
        p.segment_compile = True
        p.run(timeout=60)
        assert s2.num_frames == s3.num_frames == 1
        np.testing.assert_array_equal(s2.frames[0].tensor(0).numpy(), np.zeros(4, np.float32))

    def test_n_to_1_cuts(self):
        p = tnns.Pipeline()
        a = p.add(DataSrc(data=[np.zeros(4, np.float32)]))
        b = p.add(DataSrc(data=[np.zeros(4, np.float32)]))
        mux = p.add(_Mux())
        filt = p.add(TensorFilter(framework="torch", model=_double_model()))
        sink = p.add(TensorSink(collect=True))
        p.link(a, f"{mux.name}.sink_0")
        p.link(b, f"{mux.name}.sink_1")
        p.link_chain(mux, filt, sink)
        plan = _plan_for(p, filt)
        assert not plan.pre
        assert (mux.name, "n-to-1 sync") in plan.cuts

    def test_source_cuts(self):
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[np.zeros(4, np.float32)]))
        filt = p.add(TensorFilter(framework="torch", model=_double_model()))
        p.link_chain(src, filt, p.add(TensorSink()))
        plan = _plan_for(p, filt)
        assert (src.name, "source") in plan.cuts
        assert not plan.folds

    def test_trivial_converter_folds_nontrivial_refuses(self):
        def build(fpt):
            p = tnns.Pipeline()
            shape = (4,) if fpt == 1 else (2, 4)
            src = p.add(DataSrc(data=[np.zeros(4, np.float32)] * 2))
            conv = p.add(TensorConverter(frames_per_tensor=fpt))
            filt = p.add(TensorFilter(framework="torch", model=_double_model(shape)))
            p.link_chain(src, conv, filt, p.add(TensorSink(collect=True)))
            return p, conv, filt

        p, conv, filt = build(1)
        plan = _plan_for(p, filt)
        assert plan.pre == [conv.name]
        assert plan.label == f"{conv.name}+{filt.name}"

        p, conv, filt = build(2)
        plan = _plan_for(p, filt)
        assert not plan.pre
        assert (conv.name, "non-trivial converter config") in plan.fallbacks

    def test_host_transform_is_a_fallback(self):
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[np.zeros(4, np.float32)]))
        tr = p.add(TensorTransform(mode="arithmetic", option="mul:2.0", acceleration=False,
                                   device="cpu"))
        filt = p.add(TensorFilter(framework="torch", model=_double_model()))
        p.link_chain(src, tr, filt, p.add(TensorSink()))
        plan = _plan_for(p, filt)
        assert (tr.name, "host transform (acceleration off)") in plan.fallbacks

    def test_decoder_without_lowering_is_a_fallback(self):
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[np.zeros(4, np.float32)]))
        filt = p.add(TensorFilter(framework="torch", model=_double_model()))
        dec = p.add(TensorDecoder(mode="seg_test_host_only"))
        p.link_chain(src, filt, dec, p.add(TensorSink(collect=True)))
        plan = _plan_for(p, filt)
        assert not plan.post
        assert any(n == dec.name for n, _ in plan.fallbacks)


def _cascade(x, model, seg):
    p = tnns.Pipeline()
    p.segment_compile = seg
    src = p.add(DataSrc(data=[x]))
    conv = p.add(TensorConverter())
    filt = p.add(TensorFilter(framework="torch", model=model))
    dec = p.add(TensorDecoder(mode="bounding_boxes", option1="fused-ssd",
                              option4=f"{SIZE}:{SIZE}", option5=f"{SIZE}:{SIZE}"))
    sink = p.add(TensorSink(collect=True))
    p.link_chain(src, conv, filt, dec, sink)
    return p, conv, filt, dec, sink


@pytest.fixture(scope="module")
def fused_model():
    return ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, seed=3,
                    fused_decode=32, device="cpu")


def _frame_input(seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)


class TestRestoreLifecycle:
    def test_stop_restores_unfused_graph(self, fused_model):
        p, conv, filt, dec, sink = _cascade(_frame_input(), fused_model, True)
        p.start()
        try:
            assert conv.name not in p.nodes
            assert dec.plugin._lowered is not None
            assert filt.backend.segment_label == f"{conv.name}+{filt.name}+{dec.name}"
            assert p.wait(60)
        finally:
            p.stop()
        assert sink.num_frames == 1
        assert conv.name in p.nodes
        assert conv.src_pads["src"].peer is not None
        assert dec.plugin._lowered is None
        assert not filt._fused_pre and not filt._fused_post
        assert filt.backend.segment_label == ""
        assert not p._segment_undos

    def test_failed_start_restores_unfused_graph(self, fused_model):
        class _Exploder(Node):
            def __init__(self):
                super().__init__("exploder")
                self.add_sink_pad("sink")

            def configure(self, in_specs):
                raise RuntimeError("negotiation boom")

        p = tnns.Pipeline()
        p.segment_compile = True
        src = p.add(DataSrc(data=[np.zeros((SIZE, SIZE, 3), np.uint8)]))
        conv = p.add(TensorConverter())
        norm = p.add(TensorTransform(mode="arithmetic", option=NORMALIZE, acceleration="pallas",
                                     device="cpu"))
        filt = p.add(TensorFilter(framework="torch", model=fused_model))
        dec = p.add(TensorDecoder(mode="bounding_boxes", option1="fused-ssd",
                                  option4=f"{SIZE}:{SIZE}", option5=f"{SIZE}:{SIZE}"))
        p.link_chain(src, conv, norm, filt, dec, p.add(_Exploder()))
        with pytest.raises(Exception, match="negotiation boom"):
            p.start()
        assert conv.src_pads["src"].peer is norm.sink_pads["sink"]
        assert norm.src_pads["src"].peer is filt.sink_pads["sink"]
        assert set(p.nodes) >= {conv.name, norm.name}
        assert dec.plugin._lowered is None
        assert not filt._fused_pre and not filt._fused_post
        assert filt.backend.segment_label == ""
        assert not p._segment_undos

    def test_disabled_by_default(self, fused_model, monkeypatch):
        monkeypatch.delenv("NNSTPU_SEGMENT_ENABLED", raising=False)
        p, conv, filt, dec, sink = _cascade(_frame_input(), fused_model, None)
        assert not segments.segments_enabled(p)
        p.run(timeout=60)
        assert sink.num_frames == 1
        assert dec.plugin._lowered is None
        assert not filt._fused_post

    def test_env_knob_enables(self, fused_model, monkeypatch):
        monkeypatch.setenv("NNSTPU_SEGMENT_ENABLED", "1")
        p, conv, filt, dec, sink = _cascade(_frame_input(), fused_model, None)
        assert segments.segments_enabled(p)
        p.segment_compile = False
        assert not segments.segments_enabled(p)


class TestPerElementFallback:
    def test_refusing_decoder_falls_back_to_host(self):
        p = tnns.Pipeline()
        p.segment_compile = True
        src = p.add(DataSrc(data=[np.ones(4, np.float32)] * 3))
        filt = p.add(TensorFilter(framework="torch", model=_double_model()))
        dec = p.add(TensorDecoder(mode="seg_test_refuser"))
        sink = p.add(TensorSink(collect=True))
        p.link_chain(src, filt, dec, sink)
        assert _plan_for(p, filt).post == [dec.name]  # plan-time optimism
        p.run(timeout=60)
        assert dec.plugin.stage_calls >= 1
        assert sink.num_frames == 3
        assert all(f.meta.get("host_decoded") for f in sink.frames)
        np.testing.assert_array_equal(sink.frames[0].tensor(0).numpy(), np.full(4, 2, np.float32))


class TestTransformFusion:
    def test_folded_transform_equals_unfolded(self):
        data = [np.random.default_rng(i).integers(0, 256, (8, 8, 3)).astype(np.uint8)
                for i in range(3)]
        model = TorchModel(apply=lambda params, x: x.sum(dim=-1), device="cpu",
                           input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32,
                                                                shape=(8, 8, 3))))
        outs = []
        for fuse in (True, False):
            p = tnns.Pipeline()
            p.auto_fuse = fuse
            src = p.add(DataSrc(data=data))
            norm = p.add(TensorTransform(mode="arithmetic", option=NORMALIZE,
                                         acceleration="pallas", device="cpu"))
            filt = p.add(TensorFilter(framework="torch", model=model))
            sink = p.add(TensorSink(collect=True))
            p.link_chain(src, norm, filt, sink)
            p.run(timeout=60)
            assert (norm.name in p.nodes) is not fuse
            assert bool(filt._fused_pre) is fuse
            outs.append([f.tensor(0).numpy() for f in sink.frames])
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)


class TestParity:
    def test_fused_ssd_cascade_bitwise(self, fused_model):
        """Converter + SSD + fused-ssd decoder: the fused segment is bitwise
        the unfused path (canvas bytes and every object field)."""
        frames = []
        for seg in (False, True):
            p, conv, filt, dec, sink = _cascade(_frame_input(7), fused_model, seg)
            p.run(timeout=120)
            frames.append(sink.frames[0])
        o0, o1 = ([(o.x, o.y, o.width, o.height, o.class_id, o.prob)
                   for o in f.meta["objects"]] for f in frames)
        assert o0 == o1 and o0
        assert frames[0].tensor(0).numpy().tobytes() == frames[1].tensor(0).numpy().tobytes()

    def test_fused_ssd_cascade_matches_jax(self):
        jparams = js.init_params(jax.random.PRNGKey(5), num_labels=LABELS)
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        x = _frame_input(2)
        got = []
        for seg in (False, True):
            model = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32,
                             params=tree, fused_decode=32, device="cpu")
            p, conv, filt, dec, sink = _cascade(x, model, seg)
            p.run(timeout=120)
            got.append(sink.frames[0].meta["objects"])
        p = jnns.Pipeline()
        p.segment_compile = True
        chain = [p.add(jnns.make("datasrc", data=[x])), p.add(jnns.make("tensor_converter")),
                 p.add(JaxFilter(framework="jax", model=js.build(
                     num_labels=LABELS, image_size=SIZE, dtype=jnp.float32, params=jparams,
                     fused_decode=32))),
                 p.add(jnns.make("tensor_decoder", mode="bounding_boxes", option1="fused-ssd",
                                 option4=f"{SIZE}:{SIZE}", option5=f"{SIZE}:{SIZE}")),
                 p.add(jnns.make("tensor_sink", collect=True))]
        p.link_chain(*chain)
        p.run(timeout=180)
        want = chain[-1].frames[0].meta["objects"]
        assert want
        for objs in got:
            assert [(o.class_id, o.x, o.y, o.width, o.height) for o in objs] == \
                [(o.class_id, o.x, o.y, o.width, o.height) for o in want]
            np.testing.assert_allclose([o.prob for o in objs], [o.prob for o in want],
                                       rtol=0, atol=PROB_ATOL)

    def test_image_label_lowering(self):
        jmodel = jm.build(num_classes=10, width_mult=0.35, image_size=64, dtype=jnp.float32)
        tmodel = tm.build(num_classes=10, width_mult=0.35, image_size=64, dtype=torch.float32,
                          params=jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
        x = np.random.default_rng(0).random((64, 64, 3), np.float32)
        metas = []
        for seg in (False, True):
            p = tnns.Pipeline()
            p.segment_compile = seg
            src = p.add(DataSrc(data=[x]))
            filt = p.add(TensorFilter(framework="torch", model=tmodel))
            dec = p.add(TensorDecoder(mode="image_labeling"))
            sink = p.add(TensorSink(collect=True))
            p.link_chain(src, filt, dec, sink)
            assert _plan_for(p, filt).post == ([dec.name])
            p.run(timeout=60)
            metas.append(sink.frames[0].meta)
        assert metas[0]["label_index"] == metas[1]["label_index"]
        assert metas[0]["score"] == metas[1]["score"]
        p = jnns.Pipeline()
        p.segment_compile = True
        chain = [p.add(jnns.make("datasrc", data=[x])),
                 p.add(JaxFilter(framework="jax", model=jmodel)),
                 p.add(jnns.make("tensor_decoder", mode="image_labeling")),
                 p.add(jnns.make("tensor_sink", collect=True))]
        p.link_chain(*chain)
        p.run(timeout=120)
        want = chain[-1].frames[0].meta
        assert metas[1]["label_index"] == want["label_index"]
        assert abs(metas[1]["score"] - want["score"]) <= 1e-4 * max(1.0, abs(want["score"]))


@pytest.fixture(scope="module")
def detection_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("det")
    labels = d / "labels.txt"
    labels.write_text("\n".join(["background"] + [f"object_{i}" for i in range(1, LABELS)]))
    return str(labels), ts.write_priors_file(str(d / "priors.txt"), image_size=SIZE)


def _detection_slice(nns, filt, files, seg, **transform_kw):
    """The object-detection pipeline, tflite-ssd sub-mode."""
    labels, priors = files
    p = nns.Pipeline()
    p.segment_compile = seg
    chain = [p.add(nns.make("videotestsrc", num_buffers=FRAMES, width=SIZE, height=SIZE,
                            pattern="random", seed=5)),
             p.add(nns.make("tensor_converter")),
             p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                            acceleration="pallas", **transform_kw)),
             p.add(filt),
             p.add(nns.make("tensor_decoder", mode="bounding_boxes", option1="tflite-ssd",
                            option2=labels, option3=priors, option4=f"{SIZE}:{SIZE}",
                            option5=f"{SIZE}:{SIZE}")),
             p.add(nns.make("tensor_sink", collect=True))]
    p.link_chain(*chain)
    p.start()
    try:
        label = getattr(filt.backend, "segment_label", None)
        lowered = chain[4].plugin._lowered is not None
        assert p.wait(300)
    finally:
        p.stop()
    return chain[-1].frames, (label, lowered, [n.name for n in chain])


def test_detection_slice_matches_jax(detection_files, monkeypatch):
    """The slice with segments on, through the port and through the JAX
    package (its Pallas NMS switch on, interpreted): equal object lists,
    prob within PROB_ATOL; and the port's host-decode run keeps the same
    objects."""
    monkeypatch.setenv("NNSTPU_SEGMENT_PALLAS_NMS", "1")
    jparams = js.init_params(jax.random.PRNGKey(0), num_labels=LABELS)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    want, _ = _detection_slice(jnns, JaxFilter(framework="jax", model=js.build(
        num_labels=LABELS, image_size=SIZE, dtype=jnp.float32, params=jparams)),
        detection_files, True)
    runs = {}
    for seg in (True, False):
        model = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, params=tree,
                         device="cpu")
        runs[seg], (label, lowered, names) = _detection_slice(
            tnns, TensorFilter(framework="torch", model=model), detection_files, seg,
            device="cpu")
        # with segments on, the converter and the decoder fold into the filter
        assert lowered is seg
        assert label == ("+".join([names[1], names[3], names[4]]) if seg else "")
    assert len(want) == len(runs[True]) == len(runs[False]) == FRAMES
    n_objects = 0
    for frames in runs.values():
        for g, w in zip(frames, want):
            go, wo = g.meta["objects"], w.meta["objects"]
            assert [(o.class_id, o.x, o.y, o.width, o.height, o.label) for o in go] == \
                [(o.class_id, o.x, o.y, o.width, o.height, o.label) for o in wo]
            np.testing.assert_allclose([o.prob for o in go], [o.prob for o in wo],
                                       rtol=0, atol=PROB_ATOL)
            assert tuple(g.tensor(0).shape) == np.asarray(w.tensor(0)).shape
            assert (g.pts, g.duration) == (w.pts, w.duration)
            n_objects += len(go)
    assert n_objects > 0


def test_lowered_detection_calls_the_kernel_wrapper(detection_files, monkeypatch):
    """With no NMS knob set, a segment-compiled tflite-ssd pipeline runs its
    NMS through the kernel's wrapper, once per frame (on the CPU tensors
    here the wrapper takes the plain version; on CUDA it launches)."""
    monkeypatch.delenv("NNSTPU_SEGMENT_PALLAS_NMS", raising=False)
    monkeypatch.delenv("NNSTPU_CONF", raising=False)
    calls = []
    wrapper = tnms.pallas_nms_keep

    def spy(*args):
        calls.append(args[0].shape[0])
        return wrapper(*args)

    monkeypatch.setattr(tnms, "pallas_nms_keep", spy)
    model = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, seed=0,
                     device="cpu")
    frames, (_, lowered, _) = _detection_slice(
        tnns, TensorFilter(framework="torch", model=model), detection_files, True,
        device="cpu")
    assert lowered and len(frames) == FRAMES
    assert calls == [min(ts.num_priors(SIZE), tbb.PRE_NMS_TOP_K)] * FRAMES


class TestConf:
    def test_env_over_ini_over_default(self, tmp_path):
        ini = tmp_path / "nns.ini"
        ini.write_text("[segment]\nenabled = true\n")
        assert not Conf(environ={}).get_bool("segment", "enabled")
        env = {"NNSTPU_CONF": str(ini)}
        assert Conf(environ=env).get_bool("segment", "enabled")
        env["NNSTPU_SEGMENT_ENABLED"] = "0"
        assert not Conf(environ=env).get_bool("segment", "enabled")
        assert Conf(environ={}).get("segment", "missing", "d") == "d"

    def test_nms_switch_is_not_ported(self):
        assert "pallas_nms" not in DEFAULTS["segment"]
        assert Conf(environ={}).get("segment", "pallas_nms") is None

    def test_bad_bool_raises(self):
        with pytest.raises(ValueError, match="not a boolean"):
            Conf(environ={"NNSTPU_SEGMENT_ENABLED": "maybe"}).get_bool("segment", "enabled")
