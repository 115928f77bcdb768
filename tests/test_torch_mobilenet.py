"""The port's MobileNet-v2 against the JAX package's.

Small size (width 0.35, 64x64 input, 10 classes).  The JAX model's own
params go through ``params_from_jax``; inputs are numpy arrays from fixed
seeds.  The JAX forwards run under ``jax.jit``, as the filter backend runs
them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import layers as jl
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.ops import pallas_kernels as jk
from nnstreamer_tpu.ops import quant as jq
from nnstreamer_tpu_torch.models import layers as tl
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.ops.quant import QuantizedWeight, quantize_activations

KW = dict(num_classes=10, width_mult=0.35, image_size=64)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def float_model():
    m = jm.build(**KW, dtype=jnp.float32)
    return m, tm.params_from_jax(_numpy_tree(m.params), "cpu")


@pytest.fixture(scope="module")
def int8_head_model():
    m = jm.build_quantized(**KW, int8_head=True)
    return m, tm.params_from_jax(_numpy_tree(m.params), "cpu")


def test_params_from_jax_layout(int8_head_model):
    jax_model, params = int8_head_model
    stem = params["stem"]["conv"]["w"]
    assert isinstance(stem, QuantizedWeight)
    jstem = jax_model.params["stem"]["conv"]["w"]
    np.testing.assert_array_equal(stem.q.numpy(), np.asarray(jstem.q).transpose(3, 2, 0, 1))
    assert tuple(stem.scale.shape) == (stem.q.shape[0], 1, 1, 1)
    dw = params["blocks"][1]["depthwise"]["conv"]["w"].q
    c = dw.shape[0]
    assert tuple(dw.shape) == (c, 1, 3, 3)
    head = params["classifier"]["w"]
    assert tuple(head.q.shape) == (1280, 10) and tuple(head.scale.shape) == (1, 10)
    block = params["blocks"][1]
    assert block["stride"] == 2 and block["residual"] is False
    assert isinstance(params["blocks"][2]["residual"], bool)


def test_float32_apply_matches(float_model):
    """f32 end to end: convs sum in another order (oneDNN vs XLA), which
    moves logits of magnitude ~5 by ~1e-5; held to 1e-4."""
    jax_model, params = float_model
    fwd = jax.jit(lambda x: jm.apply(jax_model.params, x, dtype=jnp.float32))
    for x in _inputs(0):
        want = np.asarray(fwd(x))
        got = tm.apply(params, torch.from_numpy(x), dtype=torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bfloat16_apply_top1(float_model):
    """bf16 compute: each layer rounds to 8 significant bits, and XLA keeps
    some intermediates in f32 that PyTorch rounds; logits of magnitude ~5
    drift by up to ~0.07.  Top-1 must match; logits within 0.15."""
    jax_model, params = float_model
    fwd = jax.jit(lambda x: jm.apply(jax_model.params, x, dtype=jnp.bfloat16))
    for x in _inputs(0, n=4):
        want = np.asarray(fwd(x))
        got = tm.apply(params, torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == (10,)
        assert np.argmax(got) == np.argmax(want)
        np.testing.assert_allclose(got, want, atol=0.15)


def test_int8_head_model_top1(int8_head_model):
    """build_quantized(int8_head=True): bf16 trunk over int8 weights
    dequantized in bf16, then the int8 head.  Same bf16 drift as above."""
    jax_model, params = int8_head_model
    fwd = jax.jit(lambda x: jax_model.apply(jax_model.params, x))
    xs = _inputs(10, n=4)
    for x in xs:
        want = np.asarray(fwd(x))
        got = tm.apply_quantized_int8_head(params, torch.from_numpy(x)).numpy()
        assert np.argmax(got) == np.argmax(want)
        np.testing.assert_allclose(got, want, atol=0.15)
    batch = np.stack(xs)
    got_b = tm.apply_quantized_int8_head(params, torch.from_numpy(batch)).numpy()
    assert got_b.shape == (4, 10)
    assert np.array_equal(np.argmax(got_b, 1), np.argmax(np.asarray(fwd(batch)), 1))


def test_int8_head_on_identical_features(int8_head_model):
    """The head fed the same float32 features: the int8 activations and
    their scale are exact, and the logits agree within the epilogue bound
    of test_torch_kernels (XLA fuses acc*s + b into one multiply-add)."""
    jax_model, params = int8_head_model
    feats = (np.random.default_rng(3).standard_normal((3, 1280)) * 2).astype(np.float32)
    jhead = jax_model.params["classifier"]

    @jax.jit
    def jax_head(f):
        q, s = jq.quantize_activations(f)
        return q, s, jk.int8_matmul(q, jhead["w"].q, s, jhead["w"].scale.reshape(1, -1),
                                    jhead["b"])

    jq8, js, want = (np.asarray(a) for a in jax_head(feats))
    q, s = quantize_activations(torch.from_numpy(feats))
    np.testing.assert_array_equal(q.numpy(), jq8)
    assert s.numpy() == js
    got = tm.int8_head(params["classifier"], torch.from_numpy(feats)).numpy()
    acc = jq8.astype(np.int64) @ np.asarray(jhead["w"].q).astype(np.int64)
    prod = acc.astype(np.float32) * (js * np.asarray(jhead["w"].scale).reshape(1, -1))
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(prod)) + np.spacing(np.abs(got)))


def test_params_from_jax_keeps_act_scale_a_float():
    """A calibrated ``act_scale`` stays a Python float: a tensor there would
    be read back to the host by every int8 conv, inside the capture too."""
    tree = jm.build_quantized(**KW, dtype=jnp.float32, int8_convs=True, static_scales=True,
                              calib_samples=1).params
    params = tm.params_from_jax(_numpy_tree(tree), "cpu")
    scale = params["blocks"][2]["expand"]["conv"]["act_scale"]
    assert type(scale) is float and scale == float(tree["blocks"][2]["expand"]["conv"]["act_scale"])
    assert torch.is_tensor(params["blocks"][2]["expand"]["bn"]["scale"])


def test_quantize_params_matches_jax():
    tree = _numpy_tree(jm.init_params(jax.random.PRNGKey(1), 10, 0.35))
    port = tm.build_quantized(**KW, params=tree, int8_head=True, device="cpu").params
    ref = jm.build_quantized(**KW, params=jm.init_params(jax.random.PRNGKey(1), 10, 0.35),
                             int8_head=True).params
    for path in (("stem", "conv"), ("head", "conv")):
        a, b = port[path[0]][path[1]]["w"], ref[path[0]][path[1]]["w"]
        np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(a.scale.numpy().reshape(-1), np.asarray(b.scale).reshape(-1))
    np.testing.assert_array_equal(port["classifier"]["w"].q.numpy(),
                                  np.asarray(ref["classifier"]["w"].q))


def test_init_params_seeded_and_shaped_like_jax():
    a = tm.init_params(5, num_classes=10, width_mult=0.35, device="cpu")
    b = tm.init_params(5, num_classes=10, width_mult=0.35, device="cpu")
    c = tm.init_params(6, num_classes=10, width_mult=0.35, device="cpu")
    ref = tm.params_from_jax(_numpy_tree(jm.init_params(jax.random.PRNGKey(0), 10, 0.35)), "cpu")
    flat = lambda p: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree_util.tree_map(lambda t: t.numpy() if torch.is_tensor(t) else t, p))
    for x, y, r in zip(flat(a), flat(b), flat(ref)):
        assert np.shape(x) == np.shape(r)
        np.testing.assert_array_equal(x, y)
    assert not torch.equal(a["classifier"]["w"], c["classifier"]["w"])


@pytest.mark.parametrize("size,stride,groups", [(8, 2, 1), (7, 2, 1), (8, 1, 4), (9, 2, 4)])
def test_conv_same_padding(size, stride, groups):
    """XLA's SAME puts the odd pad pixel after: (0, 1) for a 3x3 stride-2
    conv on an even input."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4 // groups, 4)).astype(np.float32)
    want = np.asarray(jl.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride,
                                groups=groups))
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = tl.conv2d({"w": tw}, torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride,
                    groups=groups).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.build(**KW)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.build_quantized(**KW, int8_head=True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.init_params(0, 10, 0.35)
