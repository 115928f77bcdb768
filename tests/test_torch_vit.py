"""The port's ViT and byte-level text classifier against the JAX package's.

``models/vit.py`` (``patchify``, ``build``, ``build_quantized``) and
``models/text_classifier.py``, on the JAX package's own params
(``params_from_jax`` of its tree), the JAX model compiled as its backend
compiles it.  In bfloat16 the JAX side is compiled with
``xla_allow_excess_precision=False``, so that every bfloat16 value is
rounded where the port rounds it.  Small size: 32x32 images, patch 8,
d_model 64, 4 heads, 2 layers, 10 classes; text of 32 bytes.

Tolerances: float32 logits within 1e-5 of the largest; strict bfloat16
logits within 2^-6 of the largest (the port's matmuls, tanh-GELU and
reductions round at other steps than XLA's), with the same top-1.  Also
a ViT launch string on the CPU end to end, and the checkpoint builder
(``builder=vit`` with ``dtype=bfloat16`` given as a string).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.models import text_classifier as jtc
from nnstreamer_tpu.models import vit as jv
from nnstreamer_tpu.utils import checkpoint as jckpt
from nnstreamer_tpu_torch.backends.torch_backend import TorchCpuBackend
from nnstreamer_tpu_torch.models import text_classifier as ttc
from nnstreamer_tpu_torch.models import vit as tv
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

VIT = dict(num_classes=10, image_size=32, patch=8, d_model=64, n_heads=4, n_layers=2)
TEXT = dict(num_classes=4, seq_len=32, d_model=32, n_heads=4, n_layers=2)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}
STRICT_BF16 = {"xla_allow_excess_precision": False}
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _compiled(model, x):
    return jax.jit(model.fn()).lower(jnp.asarray(x)).compile(STRICT_BF16)


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"max error {err} > {rel} x {scale}"
    assert np.argmax(got, -1).tolist() == np.argmax(want, -1).tolist()


def _images(seed, n, size=VIT["image_size"]):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (size, size, 3)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 32, 48, 3), (16, 16, 1)])
def test_patchify_bitwise(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jv.patchify(jnp.asarray(x), 8))
    np.testing.assert_array_equal(tv.patchify(torch.from_numpy(x), 8).numpy(), want)


def test_patchify_refuses_a_ragged_image():
    with pytest.raises(ValueError, match="not divisible"):
        tv.patchify(torch.zeros(30, 32, 3), 8)


class TestVit:
    @pytest.mark.parametrize("dt", sorted(DTYPES))
    def test_vit_matches_reference(self, dt):
        jdt, tdt, rel = DTYPES[dt]
        jm = jv.build(**VIT, dtype=jdt)
        tm = tv.build(**VIT, dtype=tdt, params=_np(jm.params), device="cpu")
        for x in _images(2, 3):
            want = np.asarray(_compiled(jm, x)(jnp.asarray(x)))
            got = tm(torch.from_numpy(x))
            assert got.dtype == torch.float32 and got.shape == (VIT["num_classes"],)
            _close(got.numpy(), want, rel)

    def test_batched_vit_matches_reference(self):
        jm = jv.build(**VIT, batch=3, dtype=jnp.float32)
        tm = tv.build(**VIT, batch=3, dtype=torch.float32, params=_np(jm.params), device="cpu")
        x = np.stack(_images(3, 3))
        want = np.asarray(jax.jit(jm.fn())(x))
        _close(tm(torch.from_numpy(x)).numpy(), want, 1e-5)
        assert tuple(tm.output_spec.tensors[0].shape) == (3, VIT["num_classes"])

    def test_w8a8_vit_matches_reference(self):
        """The int8 leaves bit for bit; the logits within 1/32 of the
        largest (an int8 activation one rounding apart flips a step, see
        ``test_torch_transformer.py``) with the same top-1."""
        jm = jv.build_quantized(**VIT, dtype=jnp.float32)
        tree = _np(jv.build(**VIT, dtype=jnp.float32).params)
        tm = tv.build_quantized(**VIT, dtype=torch.float32, params=tree, device="cpu")
        np.testing.assert_array_equal(tm.params["blocks"][0]["qkv"]["w"].q.numpy(),
                                      np.asarray(jm.params["blocks"][0]["qkv"]["w"].q))
        assert tm.name.endswith("_q8")
        for x in _images(4, 2):
            want = np.asarray(jax.jit(jm.fn())(x))
            _close(tm(torch.from_numpy(x)).numpy(), want, 1 / 32)

    def test_port_seeded_tree_has_the_reference_layout(self):
        """init_tree draws the port's own weights (numpy-seeded) in the JAX
        package's layout: the same keys and shapes."""
        mine = tv.init_tree(0, **VIT)
        ref = _np(jv.build(**VIT).params)
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
            assert np.shape(a) == np.shape(b)

    def test_vit_b16_widths(self):
        """ViT-B/16's tree at 224x224 (196 tokens of 768 values, 12 layers,
        MLP 3072) and its FLOPs a frame from the shapes."""
        tree = tv.init_tree(0, num_classes=1000, image_size=224, patch=16, d_model=768,
                            n_heads=12, n_layers=12)
        assert tree["pos_embed"].shape == (196, 768) and len(tree["blocks"]) == 12
        assert tree["embed"]["w"].shape == (768, 768)
        assert tree["blocks"][0]["ff1"]["w"].shape == (768, 3072)
        assert tv.flops_per_frame() == (2 * 196 * 768 * 768 + 12 * (24 * 196 * 768 ** 2
                                        + 4 * 196 ** 2 * 768) + 2 * 196 * 768 * 1000)

    def test_checkpoint_builder_takes_dtype_as_a_string(self, tmp_path):
        """``model=<npz> custom=builder=vit,...,dtype=bfloat16``: the JAX
        package's checkpoint served by the port's builder, bfloat16 from
        the string."""
        jm = jv.build(**VIT, dtype=jnp.bfloat16)
        path = str(tmp_path / "vit.npz")
        jckpt.save_state(jm.params, path)
        custom = "builder=vit," + ",".join(f"{k}={v}" for k, v in VIT.items()) + \
            ",dtype=bfloat16"
        be = TorchCpuBackend()
        be.open(path, custom)
        be.reconfigure(TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(32, 32, 3))))
        assert be.model.params["blocks"][0]["qkv"]["w"].dtype == torch.bfloat16
        x = _images(5, 1)[0]
        want = np.asarray(_compiled(jm, x)(jnp.asarray(x)))
        _close(be.invoke((torch.from_numpy(x),))[0].numpy(), want, 2.0 ** -6)

    def test_launch_string_end_to_end(self, tmp_path):
        """``videotestsrc ! tensor_converter ! tensor_transform (normalize,
        pallas) ! tensor_upload ! queue ! tensor_filter (ViT, bfloat16) !
        tensor_decoder image_labeling ! tensor_sink`` on the CPU: each
        frame's label is the top-1 of the JAX forward of the same
        normalized frame, its score within 2^-6 of that forward's largest
        logit."""
        labels = tmp_path / "labels.txt"
        labels.write_text("\n".join(f"class_{i}" for i in range(VIT["num_classes"])))
        jm = jv.build(**VIT, dtype=jnp.bfloat16)
        model = tv.build(**VIT, dtype=torch.bfloat16, params=_np(jm.params), device="cpu")
        p = tnns.parse_launch(
            "videotestsrc name=src num-buffers=4 width=32 height=32 pattern=random seed=5 ! "
            f"tensor_converter ! tensor_transform mode=arithmetic option={NORMALIZE} "
            "acceleration=pallas device=cpu ! tensor_upload ! queue ! "
            "tensor_filter framework=torch name=f ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "tensor_sink name=out collect=true")
        p["f"].model = model
        p.run(timeout=120)
        frames = p["out"].frames
        assert len(frames) == 4
        for i, f in enumerate(frames):
            raw = p["src"]._make_frame(i).astype(np.float32)
            x = (raw + np.float32(-127.5)) / np.float32(127.5)
            want = np.asarray(_compiled(jm, x)(jnp.asarray(x)))
            assert f.meta["label_index"] == int(np.argmax(want))
            assert f.meta["label"] == f"class_{int(np.argmax(want))}"
            assert abs(f.meta["score"] - float(want.max())) <= 2.0 ** -6 * np.abs(want).max()

    def test_vit_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for build in (tv.build, tv.build_quantized, ttc.build):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                build()


class TestTextClassifier:
    def _text(self, seed, n_bytes, size=TEXT["seq_len"]):
        t = np.zeros(size, np.uint8)
        t[:n_bytes] = np.random.default_rng(seed).integers(1, 256, n_bytes)
        return t

    @pytest.mark.parametrize("dt", sorted(DTYPES))
    def test_text_classifier_matches_reference(self, dt):
        """Masked mean-pool over the non-null bytes; an all-null frame gives
        zero logits on both sides."""
        jdt, tdt, rel = DTYPES[dt]
        jm = jtc.build(**TEXT, dtype=jdt)
        tm = ttc.build(**TEXT, dtype=tdt, params=_np(jm.params), device="cpu")
        for n in (20, 32, 1):
            x = self._text(n, n)
            want = np.asarray(_compiled(jm, x)(jnp.asarray(x)))
            _close(tm(torch.from_numpy(x)).numpy(), want, rel)
        empty = np.zeros(TEXT["seq_len"], np.uint8)
        assert not tm(torch.from_numpy(empty)).any()
        assert not np.asarray(_compiled(jm, empty)(jnp.asarray(empty))).any()

    def test_batched_text_matches_reference(self):
        jm = jtc.build(**TEXT, batch=3, dtype=jnp.float32)
        tm = ttc.build(**TEXT, batch=3, dtype=torch.float32, params=_np(jm.params), device="cpu")
        x = np.stack([self._text(10 + i, 5 + 9 * i) for i in range(3)])
        want = np.asarray(jax.jit(jm.fn())(x))
        _close(tm(torch.from_numpy(x)).numpy(), want, 1e-5)
        assert tm.input_spec.tensors[0].dtype == np.uint8

    def test_port_seeded_tree_has_the_reference_layout(self):
        mine = ttc.init_tree(0, **TEXT)
        ref = _np(jtc.build(**TEXT).params)
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
            assert np.shape(a) == np.shape(b)
