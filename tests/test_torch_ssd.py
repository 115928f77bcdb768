"""The port's SSD-MobileNet-v2 and ``bounding_boxes`` decoder against the JAX package's.

Small size: 96x96 input (204 anchors), 5 labels, float32 compute, the full
1.0 width.  The JAX model's own params go through ``params_from_jax``; its
forwards and its decoder's device stage run under ``jax.jit``, as the
pipeline runs them.  Raw tensors are fed to both decoders as the same
numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.decoders import bounding_boxes as jbb
from nnstreamer_tpu.models import ssd_mobilenet as js
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec
from nnstreamer_tpu.spec import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch.buffer import Frame as TFrame
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb
from nnstreamer_tpu_torch.models import ssd_mobilenet as ts
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

SIZE, LABELS = 96, 5
# float32 convs sum in another order in XLA and in PyTorch's CPU kernels;
# over the trunk's 20-odd layers that stays below 1e-5 of the largest
# output (3.4e-6 seen), so 1e-4 of it is the bound.
MODEL_RTOL = 1e-4
# The JAX package's prior decode runs under jit, where XLA on the CPU
# contracts a multiply and an add into one FMA; the port rounds twice.  The
# geometry (values up to ~20) may differ by a few float32 ulps: 4 ulps of 1.0.
GEOM_ATOL = 4 * 2.0 ** -23
# exp and sigmoid are different implementations in XLA and in PyTorch
# (and numpy): a detection's prob may differ by a few ulps of 1.0.
PROB_ATOL = 1e-6


@pytest.fixture(scope="module")
def jax_params():
    return js.init_params(jax.random.PRNGKey(0), num_labels=LABELS)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return ts.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")


@pytest.fixture(scope="module")
def raw(jax_params):
    """The JAX model's raw (boxes, scores) on one frame, as numpy."""
    x = np.random.default_rng(0).uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)
    boxes, scores = jax.jit(lambda v: js.apply(jax_params, v, dtype=jnp.float32))(x)
    return x, np.array(boxes), np.array(scores)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssd")
    labels = d / "labels.txt"
    labels.write_text("\n".join(["background"] + [f"object_{i}" for i in range(1, LABELS)]))
    priors = ts.write_priors_file(str(d / "priors.txt"), image_size=SIZE)
    return str(labels), priors


@pytest.mark.parametrize("size", [300, 224, 96, 64])
def test_grids_and_priors_exact(size):
    assert ts.feature_grids(size) == js.feature_grids(size)
    assert ts.num_priors(size) == js.num_priors(size)
    np.testing.assert_array_equal(ts.generate_priors(size), js.generate_priors(size))
    assert ts.NUM_PRIORS == js.NUM_PRIORS == 1917


def test_params_from_jax_layout(jax_params, port_params):
    assert port_params["num_labels"] == LABELS
    for key in ("box_heads", "cls_heads"):
        for got, want in zip(port_params[key], jax_params[key]):
            np.testing.assert_array_equal(got["w"].numpy(),
                                          np.asarray(want["w"]).transpose(3, 2, 0, 1))
    assert len(port_params["extras"]) == 4
    assert len(port_params["blocks"]) == 17


def test_init_params_shaped_like_jax(jax_params):
    mine = ts.init_params(seed=0, num_labels=LABELS, device="cpu")
    theirs = ts.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape) if hasattr(t, "shape") else t,
                                    (mine, theirs))
    assert shapes[0] == shapes[1]
    again = ts.init_params(seed=0, num_labels=LABELS, device="cpu")
    assert torch.equal(again["cls_heads"][0]["w"], mine["cls_heads"][0]["w"])


def test_float32_apply_matches(raw, port_params):
    x, jboxes, jscores = raw
    boxes, scores = ts.apply(port_params, torch.from_numpy(x), dtype=torch.float32)
    assert tuple(boxes.shape) == (ts.num_priors(SIZE), 4) == jboxes.shape
    assert tuple(scores.shape) == (ts.num_priors(SIZE), LABELS) == jscores.shape
    for got, want in ((boxes.numpy(), jboxes), (scores.numpy(), jscores)):
        assert np.abs(got - want).max() <= MODEL_RTOL * np.abs(want).max()
    batched = ts.apply(port_params, torch.from_numpy(x)[None], dtype=torch.float32)
    assert torch.equal(batched[0][0], boxes)


def test_decode_topk_matches_jit(raw):
    _, boxes, scores = raw
    priors = js.generate_priors(SIZE)
    for k in (1, 37, 100, ts.num_priors(SIZE)):
        want = np.asarray(jax.jit(lambda b, s: js.decode_topk(b, s, priors, k=k))(boxes, scores))
        got = ts.decode_topk(torch.from_numpy(boxes), torch.from_numpy(scores), priors,
                             k=k).numpy()
        assert got.shape == want.shape == (k, 6)
        # the same anchors in the same order: class exact, score exact here
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=PROB_ATOL)
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=GEOM_ATOL)


def test_decode_topk_ties_take_the_lower_index():
    """Equal best scores (common with bf16 logits): lax.top_k puts the
    lower anchor index first; the port's stable sort must too."""
    rng = np.random.default_rng(4)
    n = ts.num_priors(SIZE)
    scores = np.zeros((n, LABELS), np.float32)
    scores[:, 1] = rng.choice([-1.0, 0.5, 2.0], n).astype(np.float32)
    boxes = rng.standard_normal((n, 4)).astype(np.float32)
    priors = js.generate_priors(SIZE)
    want = np.asarray(jax.jit(lambda b, s: js.decode_topk(b, s, priors, k=100))(boxes, scores))
    got = ts.decode_topk(torch.from_numpy(boxes), torch.from_numpy(scores), priors,
                         k=100).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_ATOL)


def test_rank_anchors_is_lax_top_k():
    """The decode head's ranking, with ties: the indices ``lax.top_k`` picks
    from the same best scores, in its order, and each anchor's scores by
    class the reference's sigmoid (atol PROB_ATOL)."""
    rng = np.random.default_rng(5)
    n = ts.num_priors(SIZE)
    scores = rng.choice([-1.0, 0.5, 2.0, 20.0], (n, LABELS)).astype(np.float32)
    want_s = np.asarray(jax.nn.sigmoid(jnp.asarray(scores[:, 1:])))
    _, want_i = jax.lax.top_k(jnp.asarray(want_s.max(axis=-1)), 100)
    by_class, best, top_i = ts.rank_anchors(torch.from_numpy(scores), 100)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(by_class.numpy(), want_s, rtol=0, atol=PROB_ATOL)
    assert torch.equal(best, by_class.amax(dim=-1))


def test_build_specs():
    model = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, device="cpu")
    n = ts.num_priors(SIZE)
    assert [t.shape for t in model.output_spec.tensors] == [(n, 4), (n, LABELS)]
    assert model.input_spec.tensors[0].shape == (SIZE, SIZE, 3)
    fused = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, seed=1,
                     fused_decode=32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (SIZE, SIZE, 3))
                         .astype(np.float32))
    det = fused(x)
    assert tuple(det.shape) == (32, 6) == fused.output_spec.tensors[0].shape
    assert bool(torch.isfinite(det).all())
    assert torch.all(det[:-1, 5] >= det[1:, 5])


def test_int8_build_and_fused_decode_match_jax(jax_params):
    """``build(int8=True)`` on float params takes the float path in both
    packages; ``build_quantized(fused_decode=K)`` decodes the int8
    detector's output on the device: float32 compute, detections within
    the int8 trunk's drift (test_torch_quant.py) of the JAX package's, the
    same classes."""
    from nnstreamer_tpu_torch.ops import quant as tq

    x = np.random.default_rng(2).uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    flag = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, params=tree,
                    int8=True, device="cpu")
    plain = ts.build(num_labels=LABELS, image_size=SIZE, dtype=torch.float32, params=tree,
                     device="cpu")
    for a, b in zip(flag(torch.from_numpy(x)), plain(torch.from_numpy(x))):
        assert torch.equal(a, b)
    port = ts.build_quantized(num_labels=LABELS, image_size=SIZE, dtype=torch.float32,
                              params=tree, fused_decode=16, device="cpu")
    ref = js.build_quantized(num_labels=LABELS, image_size=SIZE, dtype=jnp.float32,
                             params=jax_params, fused_decode=16)
    assert isinstance(port.params["extras"][0]["conv"]["w"], tq.QuantizedWeight)
    got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(ref.fn())(jnp.asarray(x)))
    assert got.shape == want.shape == (16, 6)
    np.testing.assert_allclose(got, want, atol=0.05)
    np.testing.assert_array_equal(got[:4, 4], want[:4, 4])


def _objects(frame):
    return [(o.class_id, o.x, o.y, o.width, o.height, o.label) for o in frame.meta["objects"]]


def _probs(frame):
    return np.array([o.prob for o in frame.meta["objects"]])


def _decode_both(options, arrays):
    outs = []
    for mod, frame_cls, conv in ((jbb, JFrame, np.asarray), (tbb, TFrame, torch.from_numpy)):
        plugin = mod.BoundingBoxes()
        plugin.init(options)
        outs.append(plugin.decode(frame_cls.of(*[conv(a) for a in arrays]), None))
    return outs


def _assert_same_frames(got, want):
    assert _objects(got) == _objects(want)
    assert len(_objects(want)) > 0
    np.testing.assert_array_equal(_probs(got), _probs(want))
    np.testing.assert_array_equal(got.tensor(0).numpy(), np.asarray(want.tensor(0)))


def test_tflite_ssd_host_decode_matches(raw, files):
    _, boxes, scores = raw
    labels, priors = files
    want, got = _decode_both(["tflite-ssd", labels, priors, "160:120", f"{SIZE}:{SIZE}"],
                             [boxes, scores])
    _assert_same_frames(got, want)
    assert tuple(got.tensor(0).shape) == (120, 160, 4)


def test_fused_ssd_host_decode_matches(raw):
    _, boxes, scores = raw
    det = np.array(jax.jit(lambda b, s: js.decode_topk(b, s, js.generate_priors(SIZE),
                                                         k=64))(boxes, scores))
    want, got = _decode_both(["fused-ssd", "", "", f"{SIZE}:{SIZE}", f"{SIZE}:{SIZE}"], [det])
    _assert_same_frames(got, want)


def test_tf_ssd_host_decode_matches():
    rng = np.random.default_rng(9)
    n = 12
    lo = rng.uniform(0, 0.5, (n, 2)).astype(np.float32)
    arrays = [np.array([10], np.float32), rng.integers(1, LABELS, n).astype(np.float32),
              rng.uniform(0, 1, n).astype(np.float32),
              np.concatenate([lo, lo + rng.uniform(0.05, 0.5, (n, 2))], 1).astype(np.float32)]
    want, got = _decode_both(["tf-ssd", "", "", "64:48", "300:300"], arrays)
    _assert_same_frames(got, want)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("submode", ["tflite-ssd", "fused-ssd"])
def test_device_stage_matches_jax(raw, files, monkeypatch, submode, pallas):
    """The lowered decode + NMS against the JAX package's, jitted, on the
    same raw tensors, with the JAX package's Pallas NMS switch off and on
    (the port has no switch: it always calls its kernel's wrapper); then
    the lowered host tail against the full host decode of the port
    itself."""
    monkeypatch.setenv("NNSTPU_SEGMENT_PALLAS_NMS", "1" if pallas else "0")
    _, boxes, scores = raw
    labels, priors = files
    if submode == "tflite-ssd":
        arrays = [boxes, scores]
    else:
        arrays = [np.array(jax.jit(lambda b, s: js.decode_topk(
            b, s, js.generate_priors(SIZE), k=64))(boxes, scores))]
    options = [submode, labels, priors, f"{SIZE}:{SIZE}", f"{SIZE}:{SIZE}"]
    jplug, tplug = jbb.BoundingBoxes(), tbb.BoundingBoxes()
    jplug.init(options)
    tplug.init(options)
    jfn, jspec = jplug.device_stage(JTensorsSpec(tensors=tuple(
        JTensorSpec(dtype=np.float32, shape=a.shape) for a in arrays)))
    tfn, tspec = tplug.device_stage(TensorsSpec(tensors=tuple(
        TensorSpec(dtype=np.float32, shape=a.shape) for a in arrays)))
    assert tspec.tensors[0].shape == jspec.tensors[0].shape
    want = np.asarray(jax.jit(lambda *xs: jfn(xs, jnp)[0])(*arrays))
    got = tfn(tuple(torch.from_numpy(a) for a in arrays))[0].numpy()
    np.testing.assert_array_equal(got[:, :5], want[:, :5])
    np.testing.assert_array_equal(got[:, 5] > 0, want[:, 5] > 0)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=PROB_ATOL)
    kept = got[:, 5] >= tbb.DETECTION_THRESHOLD
    assert kept.any() and (~kept).any()

    host = tplug.decode(TFrame.of(*[torch.from_numpy(a) for a in arrays]), None)
    tplug.set_lowered(tspec)
    lowered = tplug.decode(TFrame.of(torch.from_numpy(got)), None)
    assert _objects(lowered) == _objects(host)
    np.testing.assert_allclose(_probs(lowered), _probs(host), rtol=0, atol=PROB_ATOL)


def test_tf_ssd_never_lowers():
    plugin = tbb.BoundingBoxes()
    plugin.init(["tf-ssd"])
    spec = TensorsSpec(tensors=tuple(TensorSpec(dtype=np.float32, shape=s)
                                     for s in [(1,), (10,), (10,), (10, 4)]))
    assert plugin.device_stage(spec) is None


def test_px_rule_matches():
    for v in np.random.default_rng(2).uniform(-1, 2, 1000).astype(np.float32):
        assert tbb.px(v, 300) == jbb.px(v, 300)
        dev = tbb._px_device(torch.tensor([v]), 300)
        assert float(dev[0]) == tbb.px(v, 300)
