"""The port's audio path against the JAX package's.

- ``models/layers.conv1d`` against ``jax.lax.conv_general_dilated`` with
  ``"SAME"`` padding in NWC/WIO, at stride 4 (an odd padding total puts
  the extra sample after) and stride 1;
- ``models/audio_cnn`` through ``params_from_jax``: the JAX model's own
  params from seed 0 in the port, logits against the JAX ``apply``;
- the audio launch string, ``audiotestsrc ! tensor_converter !
  tensor_aggregator ! tensor_transform (pallas) ! tensor_upload ! queue !
  tensor_filter ! tensor_decoder (image_labeling, 12 labels) ! tensor_sink``,
  run in both packages at small width (channels (8, 8), a 512-sample
  window, as ``examples/pipelines/audio_classify.py``): equal windows,
  equal labels, logits within tolerance.

Tolerances: in float32 the two frameworks sum the convs in other orders,
so logits agree to 1e-5 of the largest; in bf16 each layer rounds its
output to 8 significant bits, so a sum in another order may move a value
by an ulp and the logits may differ by up to 1/32 of the largest logit
(about 6 bf16 ulps there).  The top-1 label must be equal either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.models import audio_cnn as ja
from nnstreamer_tpu_torch.models import audio_cnn as ta
from nnstreamer_tpu_torch.models import layers as tl

CLASSES, WINDOW, CHANNELS, SPB = 12, 512, (8, 8), 128
BF16_REL = 1 / 32
F32_REL = 1e-5


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("length", [16000, 512, 511, 9, 3])
@pytest.mark.parametrize("stride", [4, 1])
def test_conv1d_same_padding_matches_lax(length, stride):
    rng = np.random.default_rng(length + stride)
    x = rng.standard_normal((2, length, 3)).astype(np.float32)
    w = rng.standard_normal((9, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride,), "SAME",
                                        dimension_numbers=("NWC", "WIO", "NWC")) + b
    params = {"w": torch.from_numpy(w.transpose(2, 1, 0).copy()), "b": torch.from_numpy(b)}
    got = tl.conv1d(params, torch.from_numpy(x).permute(0, 2, 1), stride=stride)
    got = got.permute(0, 2, 1).numpy()
    assert got.shape == want.shape == (2, -(-length // stride), 5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    return ja.init_params(jax.random.PRNGKey(0), CLASSES, CHANNELS)


@pytest.mark.parametrize("jdt,tdt,rel", [(jnp.float32, torch.float32, F32_REL),
                                         (jnp.bfloat16, torch.bfloat16, BF16_REL)])
@pytest.mark.parametrize("batch", [None, 3])
def test_audio_cnn_matches_jax_through_params_from_jax(jax_params, jdt, tdt, rel, batch):
    shape = (WINDOW, 1) if batch is None else (batch, WINDOW, 1)
    x = (np.random.default_rng(1).standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(ja.apply(jax_params, jnp.asarray(x), dtype=jdt))
    params = ta.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    got = ta.apply(params, torch.from_numpy(x), dtype=tdt)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, rel)


def test_build_keeps_the_reference_defaults():
    """12 classes, a 16000 x 1 float32 window, channels (32, 64, 64), width
    9, bf16: the port's build() declares what the JAX build() does."""
    got = ta.build(device="cpu")
    want = ja.build()
    (gt,), (wt,) = got.input_spec.tensors, want.input_spec.tensors
    assert (gt.dtype, gt.shape) == (wt.dtype, wt.shape) == (np.float32, (16000, 1))
    assert got.name == want.name == "audio_cnn_32x64x64"
    assert [tuple(c["w"].shape) for c in got.params["convs"]] == \
        [(32, 1, 9), (64, 32, 9), (64, 64, 9)]
    assert tuple(got.params["head"]["w"].shape) == (64, CLASSES)
    x = torch.zeros(16000, 1)
    assert tuple(got(x).shape) == (CLASSES,) and got(x).dtype == torch.float32
    tree = ta._init_tree(0, CLASSES, (32, 64, 64), ta.WIDTH, 1)
    assert torch.equal(ta.init_params(0, device="cpu")["convs"][0]["w"],
                       ta.params_from_jax(tree, device="cpu")["convs"][0]["w"])


@pytest.fixture(scope="module")
def labels_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels12.txt"
    path.write_text("\n".join(f"word_{i}" for i in range(CLASSES)))
    return str(path)


def _desc(nns, n_windows, decoder, labels):
    transform_device = " device=cpu" if nns is tnns else ""
    tail = (f"tensor_decoder mode=image_labeling option1={labels} ! " if decoder else "")
    return (f"audiotestsrc name=src num-buffers={n_windows * (WINDOW // SPB)} "
            f"samplesperbuffer={SPB} rate=16000 freq=440 ! tensor_converter ! "
            f"tensor_aggregator name=agg frames-out={WINDOW // SPB} frames-dim=1 ! "
            "tensor_transform mode=arithmetic option=typecast:float32,div:32768.0 "
            f"acceleration=pallas{transform_device} ! "
            "tensor_upload ! queue max-size-buffers=16 ! tensor_filter name=f "
            f"framework={'torch' if nns is tnns else 'jax'} ! {tail}tensor_sink name=out")


def _run(nns, model, decoder, labels, n_windows=4):
    got = []
    p = nns.parse_launch(_desc(nns, n_windows, decoder, labels))
    p["f"].model = model
    p["out"].connect("new-data", got.append)
    p.run(timeout=300)
    return got, p


@pytest.mark.parametrize("jdt,tdt,rel", [(jnp.float32, torch.float32, F32_REL),
                                         (jnp.bfloat16, torch.bfloat16, BF16_REL)])
def test_audio_launch_string_matches_jax_pipeline(jax_params, labels_file, jdt, tdt, rel):
    jax_model = ja.build(num_classes=CLASSES, window=WINDOW, channels=CHANNELS, dtype=jdt,
                         params=jax_params)
    model = ta.build(num_classes=CLASSES, window=WINDOW, channels=CHANNELS, dtype=tdt,
                     params=jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    want_labels, _ = _run(jnns, jax_model, True, labels_file)
    got_labels, p = _run(tnns, model, True, labels_file)
    # the normalize folded into the filter across upload and queue
    assert not any(type(n).__name__ == "TensorTransform" for n in p.nodes.values())
    assert len(got_labels) == len(want_labels) == 4
    for g, w in zip(got_labels, want_labels):
        assert (g.meta["label"], g.meta["label_index"]) == (w.meta["label"],
                                                           w.meta["label_index"])
        assert g.meta["label"].startswith("word_")
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))
        assert (g.pts, g.duration) == (w.pts, w.duration)
    want_logits, _ = _run(jnns, jax_model, False, labels_file)
    got_logits, _ = _run(tnns, model, False, labels_file)
    for g, w in zip(got_logits, want_logits):
        assert tuple(g.tensor(0).shape) == (CLASSES,) and g.tensor(0).dtype == torch.float32
        _close(g.tensor(0).numpy(), np.asarray(w.tensor(0)), rel)


def test_window_reaching_the_filter_is_the_reference_window(jax_params, labels_file):
    """The (512, 1) int16 windows the aggregator hands on towards the
    filter, in the launch string of each package: bitwise equal."""
    seen = []
    for nns, model in ((tnns, ta.build(num_classes=CLASSES, window=WINDOW, channels=CHANNELS,
                                       params=jax.tree_util.tree_map(np.asarray, jax_params),
                                       device="cpu")),
                       (jnns, ja.build(num_classes=CLASSES, window=WINDOW, channels=CHANNELS,
                                       params=jax_params))):
        windows = []
        p = nns.parse_launch(_desc(nns, 3, True, labels_file))
        p["f"].model = model
        agg = p["agg"]

        def spy(pad, frame, process=agg.process, windows=windows):
            out = process(pad, frame)
            windows.extend(np.asarray(f.tensor(0)).copy() for f in out or [])
            return out

        agg.process = spy
        p.run(timeout=120)
        seen.append(windows)
    got, want = seen
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int16 and g.shape == w.shape == (WINDOW, 1)
        np.testing.assert_array_equal(g, w)


def test_image_labeling_takes_twelve_labels_and_a_logit_vector(labels_file):
    logits = np.linspace(-1, 1, CLASSES).astype(np.float32)[::-1].copy()
    logits[7] = 5.0
    frames = []
    for nns in (tnns, jnns):
        p = nns.parse_launch(f"datasrc name=s ! tensor_decoder mode=image_labeling "
                             f"option1={labels_file} ! tensor_sink name=out collect=true")
        p["s"].data = [torch.from_numpy(logits) if nns is tnns else logits]
        p.run(timeout=60)
        frames.append(p["out"].frames[0])
    got, want = frames
    assert got.meta["label"] == want.meta["label"] == "word_7"
    assert got.meta["label_index"] == want.meta["label_index"] == 7
    assert got.meta["score"] == want.meta["score"] == 5.0
    np.testing.assert_array_equal(got.tensor(0).numpy(), np.asarray(want.tensor(0)))
