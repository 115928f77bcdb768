"""The port's image-labeling slice end to end, against the JAX pipeline.

``videotestsrc → tensor_converter → tensor_transform (normalize,
acceleration=pallas) → tensor_filter (MobileNet-v2, int8 head) →
tensor_decoder (image_labeling) → tensor_sink``, at a small size (width
0.35, 64x64, 10 classes, 8 frames).  The port runs on ``device="cpu"`` with
the JAX model's own params.  Also: the port runs with ``jax`` and
``nnstreamer_tpu`` blocked, and no file of it names either.
"""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JaxDataSrc
from nnstreamer_tpu.elements.testsrc import VideoTestSrc as JaxVideoTestSrc
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc, VideoTestSrc
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm

from conftest import cpu_subprocess_env

REPO = Path(__file__).resolve().parents[1]
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
SIZE, CLASSES, FRAMES = 64, 10, 8


@pytest.fixture(scope="module")
def labels_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels.txt"
    path.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    return str(path)


@pytest.fixture(scope="module")
def jax_model():
    return jm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                              int8_head=True)


def _run_slice(nns, filt, labels, sink_cls, **transform_kw):
    p = nns.Pipeline()
    src = p.add(nns.make("videotestsrc", num_buffers=FRAMES, width=SIZE, height=SIZE,
                         pattern="random", seed=3))
    conv = p.add(nns.make("tensor_converter"))
    norm = p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                          acceleration="pallas", **transform_kw))
    p.add(filt)
    dec = p.add(nns.make("tensor_decoder", mode="image_labeling", option1=labels))
    sink = p.add(sink_cls(collect=True))
    p.link_chain(src, conv, norm, filt, dec, sink)
    p.run(timeout=300)
    return sink.frames


def test_slice_matches_jax_pipeline(jax_model, labels_file):
    want = _run_slice(jnns, JaxFilter(framework="jax", model=jax_model), labels_file, JaxSink)
    model = tm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                               params=jax.tree_util.tree_map(np.asarray, jax_model.params),
                               int8_head=True, device="cpu")
    got = _run_slice(tnns, TensorFilter(framework="torch", model=model), labels_file,
                     TensorSink, device="cpu")
    assert len(got) == len(want) == FRAMES
    for g, w in zip(got, want):
        assert g.meta["label"] == w.meta["label"]
        assert g.meta["label_index"] == w.meta["label_index"]
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))
        assert (g.pts, g.duration) == (w.pts, w.duration)
        # the bf16 trunk may round differently in the two frameworks
        assert abs(g.meta["score"] - w.meta["score"]) <= 0.15


def test_build_quantized_model_in_pipeline(labels_file):
    """build_quantized's own random model (its own seed) through the slice."""
    model = tm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                               int8_head=True, device="cpu")
    frames = _run_slice(tnns, TensorFilter(framework="torch", model=model), labels_file,
                        TensorSink, device="cpu")
    assert [f.meta["label"] for f in frames] == [f"class_{f.meta['label_index']}" for f in frames]
    assert len(frames) == FRAMES


@pytest.mark.parametrize("pattern", ["smpte", "random", "black", "white"])
def test_videotestsrc_frames_bit_identical(pattern):
    kw = dict(num_buffers=3, width=33, height=17, pattern=pattern, seed=5)
    want = list(JaxVideoTestSrc(**kw).frames())
    got = list(VideoTestSrc(**kw).frames())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tensor(0).numpy(), w.tensor(0))
        assert (g.pts, g.duration) == (w.pts, w.duration)


def test_negotiated_specs_match(jax_model, labels_file):
    """Every pad of the port's slice negotiates the JAX pipeline's spec."""
    del labels_file

    def specs(nns, filt, **kw):
        p = nns.Pipeline()
        chain = [p.add(nns.make("videotestsrc", num_buffers=1, width=SIZE, height=SIZE)),
                 p.add(nns.make("tensor_converter")),
                 p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                                acceleration="pallas", **kw)),
                 p.add(filt)]
        p.add(nns.make("tensor_sink", name="out"))
        p.link_chain(*chain, "out")
        if hasattr(p, "auto_fuse"):
            p.auto_fuse = False  # compare the elements as linked
        p.start()
        p.wait(60)
        p.stop()
        return [(t.dtype, t.shape) for n in chain for t in n.src_pads["src"].spec.tensors]

    model = tm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                               int8_head=True, device="cpu")
    got = specs(tnns, TensorFilter(framework="torch", model=model), device="cpu")
    want = specs(jnns, JaxFilter(framework="jax", model=jax_model))
    assert got == want


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes", "nnstreamer_tpu"):
            sys.modules[name] = None  # any import of them now raises
        import nnstreamer_tpu_torch as nns
        from nnstreamer_tpu_torch.elements import aggregator, converter, sink, testsrc
        from nnstreamer_tpu_torch.elements.filter import TensorFilter
        from nnstreamer_tpu_torch.models import audio_cnn, mobilenet_v2
        from nnstreamer_tpu_torch.utils import checkpoint, props
        from nnstreamer_tpu_torch import conf
        from nnstreamer_tpu_torch.backends import custom, custom_so, torch_backend
        m = mobilenet_v2.build_quantized(num_classes={CLASSES}, width_mult=0.35,
                                         image_size={SIZE}, int8_head=True, device="cpu")
        p = nns.Pipeline()
        chain = [p.add(nns.make("videotestsrc", num_buffers=2, width={SIZE}, height={SIZE})),
                 p.add(nns.make("tensor_converter")),
                 p.add(nns.make("tensor_transform", mode="arithmetic",
                                option="{NORMALIZE}", acceleration="pallas", device="cpu")),
                 p.add(TensorFilter(framework="torch", model=m)),
                 p.add(nns.make("tensor_decoder", mode="image_labeling")),
                 p.add(nns.make("tensor_sink", collect=True))]
        p.link_chain(*chain)
        p.run(timeout=120)
        a = nns.parse_launch(
            "audiotestsrc num-buffers=8 samplesperbuffer=128 ! tensor_converter ! "
            "tensor_aggregator frames-out=4 frames-dim=1 ! tensor_transform "
            "mode=arithmetic option=typecast:float32,div:32768.0 acceleration=pallas "
            "device=cpu ! tensor_upload ! queue ! tensor_filter framework=torch name=f ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
        a["f"].model = audio_cnn.build(window=512, channels=(8, 8), device="cpu")
        words = []
        a["out"].connect("new-data", lambda f: words.append(f.meta["label"]))
        a.run(timeout=120)
        assert len(words) == 2 and nns.BFLOAT16.name == "bfloat16"
        filters = "nnstreamer_tpu_torch/examples/custom_filters"
        c = nns.parse_launch(
            "videotestsrc num-buffers=2 width=64 height=48 ! tensor_converter ! "
            f"tensor_filter framework=custom-python model={{filters}}/scaler.py custom=32x16 ! "
            f"tensor_filter framework=custom-python model={{filters}}/average.py ! "
            f"tensor_filter framework=custom-python model={{filters}}/passthrough.py ! "
            "tensor_sink name=out collect=true")
        c.run(timeout=60)
        assert [tuple(f.tensor(0).shape) for f in c["out"].frames] == [(1, 1, 3)] * 2
        from nnstreamer_tpu_torch.elements import collect, demux, merge, mux, repo, split, tee
        from nnstreamer_tpu_torch.models import lstm, posenet
        from nnstreamer_tpu_torch.decoders import pose
        from nnstreamer_tpu_torch.utils.checkpoint import checkpoint_pipeline, restore_pipeline
        import torch
        caps = nns.TensorsSpec(tensors=(nns.TensorSpec(dtype="float32", shape=(8,)),))
        r = nns.Pipeline()
        srcs = [r.add(repo.TensorRepoSrc(name=n, slot_index=i, caps=caps, device="cpu"))
                for i, n in ((40, "h"), (41, "c"))]
        srcs.append(r.add(nns.make("datasrc", "x", data=[torch.ones(8)] * 3)))
        m = r.add(nns.make("tensor_mux", "m", sync_mode="nosync"))
        for i, s_ in enumerate(srcs):
            r.link(s_, f"m.sink_{{i}}")
        r.link_chain(m, r.add(TensorFilter(framework="torch", name="f", model=lstm.build_cell(
            8, 8, device="cpu"))), r.add(nns.make("tensor_demux", "d")))
        r.link("d.src_0", r.add(nns.make("tee", "t")))
        r.link("t", r.add(repo.TensorRepoSink(name="hs", slot_index=40)))
        out = r.add(nns.make("tensor_sink", "out", collect=True))
        r.link("t", out)
        r.link("d.src_1", r.add(repo.TensorRepoSink(name="cs", slot_index=41)))
        r.run(timeout=60)
        assert len(out.frames) == 3
        g = nns.Pipeline()
        hm = posenet.build(image_size=32, params=posenet.init_tree(0, 0.35), fused_decode=True,
                           device="cpu")
        g.link_chain(g.add(nns.make("datasrc", data=[torch.zeros(32, 32, 3)])),
                     g.add(TensorFilter(framework="torch", model=hm)),
                     g.add(nns.make("tensor_decoder", mode="pose_estimation",
                                    option1="32:32", option2="2:2")),
                     g.add(nns.make("tensor_sink", "out", collect=True)))
        g.run(timeout=60)
        assert len(g["out"].frames[0].meta["pose"]) == 14
        assert not any(k in ("jax", "ml_dtypes") or k.startswith(("jax.", "nnstreamer_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("labels", [f.meta["label"] for f in chain[-1].frames])
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=cpu_subprocess_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"labels \['\d+', '\d+'\]", out.stdout), out.stdout


# The ini file both packages read (conf.py) is named after the JAX
# package; naming it names no module of that package.
INI_PATHS = re.compile(r"(\.config/nnstreamer_tpu/)?nnstreamer_tpu\.ini")


def test_no_port_file_names_jax():
    pattern = re.compile(r"import jax|from jax|import ml_dtypes|from ml_dtypes|nnstreamer_tpu[^_]")
    files = sorted((REPO / "nnstreamer_tpu_torch").rglob("*.py"))
    for ext in ("*.cu", "*.h", "*.hh"):
        files += sorted((REPO / "nnstreamer_tpu_torch").rglob(ext))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            line = INI_PATHS.sub("", line)
            assert not pattern.search(line), f"{f.relative_to(REPO)}:{i}: {line}"


def test_guard_covers_the_batching_modules():
    """The import guard above reads every file of the port: the batching
    slice's modules among them."""
    files = {f.relative_to(REPO).as_posix() for f in (REPO / "nnstreamer_tpu_torch").rglob("*.py")}
    assert {"nnstreamer_tpu_torch/elements/batch.py", "nnstreamer_tpu_torch/elements/dynbatch.py",
            "nnstreamer_tpu_torch/graph/warmup.py", "nnstreamer_tpu_torch/pool.py",
            "nnstreamer_tpu_torch/graph/residency.py"} <= files


def test_port_batching_leaves_the_reference_untouched():
    """Registering and running the port's tensor_batch and tensor_dynbatch,
    and making and resetting its default pool, changes neither the JAX
    package's element registry nor its default pool."""
    from nnstreamer_tpu import pool as jpool
    from nnstreamer_tpu.graph import registry as jreg
    from nnstreamer_tpu_torch import pool as tpool

    jpool.default_pool()
    factories, jdefault = dict(jreg._FACTORIES), jpool._default_pool
    p = tnns.parse_launch("tensor_mux name=m sync_mode=nosync ! tensor_batch ! tensor_unbatch ! "
                          "tensor_demux name=d datasrc name=a ! m.sink_0 datasrc name=b ! "
                          "m.sink_1 d.src_0 ! tensor_sink d.src_1 ! tensor_sink")
    p["a"].data = p["b"].data = [torch.zeros(3)] * 2
    p.run(timeout=20)
    q = tnns.parse_launch("datasrc name=s ! tensor_dynbatch max_batch=2 ! tensor_dynunbatch ! "
                          "tensor_sink")
    q["s"].data = [torch.zeros(3)] * 3
    q.run(timeout=20)
    tpool.default_pool()
    tpool.reset_default_pool()
    assert jreg._FACTORIES == factories
    assert all(jreg._FACTORIES[k] is v for k, v in factories.items())
    assert jpool._default_pool is jdefault
    for name in ("tensor_batch", "tensor_dynbatch"):
        assert jnns.make(name).__module__.startswith("nnstreamer_tpu.")
        assert tnns.make(name).__module__.startswith("nnstreamer_tpu_torch.")


def test_filter_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    filt = TensorFilter(framework="torch", model=TorchModel(apply=lambda p, x: x))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        filt.start()


def _run_both(make_src_data, *elements):
    """Run ``datasrc → elements... → tensor_sink`` in both packages; the
    port's elements run on the CPU."""
    outs = []
    for nns, datasrc, frame_cls in ((jnns, JaxDataSrc, jnns.Frame),
                                    (tnns, DataSrc, tnns.Frame)):
        p = nns.Pipeline()
        chain = [p.add(datasrc(data=make_src_data(nns, frame_cls)))]
        for name, props in elements:
            if nns is tnns and name == "tensor_transform":
                props = dict(props, device="cpu")
            chain.append(p.add(nns.make(name, **props)))
        chain.append(p.add(nns.make("tensor_sink", collect=True)))
        p.link_chain(*chain)
        p.run(timeout=60)
        outs.append(chain[-1].frames)
    return outs


def test_converter_batches_frames_like_jax():
    frames = [np.full((4, 5, 3), i, np.uint8) for i in range(4)]

    def data(nns, frame_cls):
        conv = np.asarray if nns is jnns else torch.from_numpy
        return [frame_cls.of(conv(f), pts=i * 10, duration=10) for i, f in enumerate(frames)]

    want, got = _run_both(data, ("tensor_converter", {"frames_per_tensor": 2}))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))
        assert (g.pts, g.duration) == (w.pts, w.duration)


def test_converter_strips_stride_like_jax():
    raw = np.random.default_rng(2).integers(0, 256, (3, 8, 3)).astype(np.uint8)

    def data(nns, frame_cls):
        video = nns.VideoSpec(format="RGB", width=6, height=3)
        x = raw if nns is jnns else torch.from_numpy(raw)
        return [frame_cls.of(x, media=video, stride=8, width=6)]

    want, got = _run_both(data, ("tensor_converter", {}))
    np.testing.assert_array_equal(got[0].tensor(0).numpy(), np.asarray(want[0].tensor(0)))
    assert tuple(got[0].tensor(0).shape) == (3, 6, 3)


def test_midstream_shape_change_renegotiates_like_jax():
    """A frame whose shape differs from the negotiated spec sends a caps
    event downstream first; the transform re-negotiates and goes on."""
    xs = [np.arange(4, dtype=np.float32), np.arange(6, dtype=np.float32)]

    def data(nns, frame_cls):
        return [x if nns is jnns else torch.from_numpy(x) for x in xs]

    want, got = _run_both(data, ("tensor_transform",
                                 {"mode": "arithmetic", "option": "mul:2.0,add:1"}))
    assert [tuple(f.tensor(0).shape) for f in got] == [(4,), (6,)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))


SO_SRC = r"""
#include "nns_custom_filter.h"
extern "C" int nns_get_input_spec(nns_tensors_spec *s) {
  s->num_tensors = 1; s->tensors[0].dtype = NNS_FLOAT32; s->tensors[0].rank = 1;
  s->tensors[0].dims[0] = 4; return 0;
}
extern "C" int nns_get_output_spec(nns_tensors_spec *s) { return nns_get_input_spec(s); }
extern "C" int nns_invoke(const void *const *in, const uint64_t *in_sz, void *const *out,
                          const uint64_t *out_sz) {
  for (int i = 0; i < 4; ++i) ((float *)out[0])[i] = ((const float *)in[0])[i] * 2.0f;
  return 0;
}
"""


def _framework_model(name, tmp_path):
    """A model of x * 2 on a (4,) float32 stream, in the form ``name`` takes."""
    from nnstreamer_tpu_torch.backends import custom

    if name == "torch":
        return TorchModel(apply=lambda p, x: x * 2, device="cpu")
    if name in ("torch-cpu", "custom"):
        return lambda x: x * 2
    if name == "custom-python":
        (tmp_path / "double.py").write_text(
            "class CustomFilter:\n"
            "    def set_input_spec(self, spec):\n        return spec\n"
            "    def invoke(self, x):\n        return x * 2\n")
        return str(tmp_path / "double.py")
    if name == "custom-easy":
        spec = tnns.TensorsSpec.of(tnns.TensorSpec(dtype=np.float32, shape=(4,)))
        custom.register_custom_easy("double", lambda x: x * 2, spec, spec)
        return "double"
    assert name == "custom-so"
    (tmp_path / "double.cc").write_text(SO_SRC)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC",
                    f"-I{REPO / 'nnstreamer_tpu_torch' / 'native'}", str(tmp_path / "double.cc"),
                    "-o", str(tmp_path / "libdouble.so")], check=True, capture_output=True)
    return str(tmp_path / "libdouble.so")


@pytest.mark.parametrize("name", ["torch", "torch-cpu", "custom", "custom-python", "custom-easy",
                                  "custom-so"])
def test_every_framework_opens_a_model_on_the_cpu(name, tmp_path):
    from nnstreamer_tpu_torch.backends import base, custom

    assert set(base._BUILTIN_MODULES) == {"torch", "torch-cpu", "custom", "custom-python",
                                          "custom-easy", "custom-so"}
    p = tnns.Pipeline()
    data = [torch.arange(4, dtype=torch.float32) + i for i in range(2)]
    src = p.add(tnns.make("datasrc", data=data))
    filt = p.add(tnns.make("tensor_filter", framework=name, model=_framework_model(name, tmp_path)))
    sink = p.add(tnns.make("tensor_sink", collect=True))
    p.link_chain(src, filt, sink)
    try:
        p.run(timeout=60)
    finally:
        custom.unregister_custom_easy("double")
    assert filt.backend.name == name
    for x, f in zip(data, sink.frames):
        assert torch.equal(f.tensor(0).cpu(), x * 2)
