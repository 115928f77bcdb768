"""The port's detect→crop→classify cascade against the JAX package's.

``crop_and_resize`` is held against ``nnstreamer_tpu.models.cascade``'s on
the same images and boxes (inputs in [-1, 1], float32, atol 1e-5): the
full image, an aligned unit-scale crop, degenerate and out-of-range boxes,
upsampling and antialiased downsampling.  ``build_detect_classify`` runs at
the JAX test's size (``num_labels=11, det_size=96, k=4, crop_size=32,
num_classes=16, width_mult=0.35``) on the reference's own params: in
float32 (jitted reference) within the stated tolerances, in bfloat16
(reference compiled with ``xla_allow_excess_precision=False``) with the
same boxes and top-1 labels, and over a batch of frames.  Last, the
cascade through ``parse_launch`` with the normalize folded into the
filter, on the plain ``fused_arith``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import cascade as jc
from nnstreamer_tpu_torch.models import cascade as tc

# crop_and_resize: the two packages sum the weight products in another
# order (and XLA contracts multiply-adds): 1.2e-7 seen on [-1, 1] inputs.
CROP_ATOL = 1e-5
# float32 cascade: the detector's outputs as in test_torch_ssd.py (3e-6 of
# the largest seen); the logits pass a second trunk over the resampled crops.
DET_ATOL = 1e-4
LOGIT_RTOL = 1e-3
SMALL = dict(num_labels=11, det_size=96, k=4, crop_size=32, num_classes=16, width_mult=0.35)


def _crop_pair(img, boxes, cs):
    want = np.asarray(jc.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), cs))
    got = tc.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), cs).numpy()
    return got, want


IMG = np.random.default_rng(0).uniform(-1, 1, (32, 40, 3)).astype(np.float32)
BOXES = {
    "full_image": [[0.0, 0.0, 1.0, 1.0]],
    "aligned_unit_scale": [[4 / 40, 8 / 32, 16 / 40, 16 / 32]],
    "degenerate": [[0.5, 0.5, 0.0, 0.0], [0.25, 0.75, -0.3, 1e-6]],
    "out_of_range": [[1.0, 1.0, 0.5, 0.5], [-0.2, 1.3, 0.4, -0.1], [0.9, -0.5, 2.0, 3.0]],
    "upsampling": [[0.1, 0.2, 0.1, 0.05], [0.3, 0.3, 0.25, 0.3]],
    "antialiased_downsampling": [[0.05, 0.1, 0.9, 0.8], [0.0, 0.0, 1.0, 0.5]],
}


class TestCropAndResize:
    @pytest.mark.parametrize("case", sorted(BOXES))
    @pytest.mark.parametrize("cs", [8, 16, 64])
    def test_against_reference(self, case, cs):
        boxes = np.asarray(BOXES[case], np.float32)
        got, want = _crop_pair(IMG, boxes, cs)
        assert got.shape == want.shape == (len(boxes), cs, cs, 3)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=CROP_ATOL)

    def test_aligned_unit_scale_is_the_slice(self):
        boxes = np.asarray(BOXES["aligned_unit_scale"], np.float32)
        got, _ = _crop_pair(IMG, boxes, 16)
        np.testing.assert_allclose(got[0], IMG[8:24, 4:20], rtol=0, atol=CROP_ATOL)

    def test_batched_equals_each_frame(self):
        imgs = np.random.default_rng(1).uniform(-1, 1, (3, 24, 24, 3)).astype(np.float32)
        boxes = np.random.default_rng(2).uniform(0, 1, (3, 5, 4)).astype(np.float32)
        got = tc.crop_and_resize(torch.from_numpy(imgs), torch.from_numpy(boxes), 12).numpy()
        assert got.shape == (3, 5, 12, 12, 3)
        for n in range(3):
            one = tc.crop_and_resize(torch.from_numpy(imgs[n]), torch.from_numpy(boxes[n]), 12)
            np.testing.assert_allclose(got[n], one.numpy(), rtol=0, atol=1e-6)
            want = np.asarray(jc.crop_and_resize(jnp.asarray(imgs[n]), jnp.asarray(boxes[n]), 12))
            np.testing.assert_allclose(got[n], want, rtol=0, atol=CROP_ATOL)


def _tree(model):
    return jax.tree_util.tree_map(np.asarray, model.params)


@pytest.fixture(scope="module")
def ref32():
    return jc.build_detect_classify(**SMALL, dtype=jnp.float32)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(3).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)


def _port(ref, dtype):
    return tc.build_detect_classify(**SMALL, dtype=dtype, params=_tree(ref), device="cpu")


def _check_dets_and_logits(got_d, got_l, want_d, want_l):
    """Boxes and scores within DET_ATOL, classes equal, logits within
    LOGIT_RTOL of the frame's largest logit, top-1 labels equal."""
    np.testing.assert_allclose(got_d[..., [0, 1, 2, 3, 5]], want_d[..., [0, 1, 2, 3, 5]],
                               rtol=0, atol=DET_ATOL)
    np.testing.assert_array_equal(got_d[..., 4], want_d[..., 4])
    scale = np.abs(want_l).max()
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=LOGIT_RTOL * scale)
    np.testing.assert_array_equal(got_l.argmax(-1), want_l.argmax(-1))


def _check_bf16_dets(got_d, want_d):
    """bfloat16 detections: the same classes; boxes and scores within 1/32
    relative and 1/64 absolute.  The two packages' bfloat16 convs sum in
    another order (ROADMAP C14), which moves a box a few bfloat16 steps
    (1/128 relative each) through the decode's exp."""
    np.testing.assert_array_equal(got_d[..., 4], want_d[..., 4])
    np.testing.assert_allclose(got_d, want_d, rtol=1 / 32, atol=1 / 64)


class TestCascadeModel:
    def test_params_from_jax(self, ref32):
        p = tc.params_from_jax(_tree(ref32), device="cpu")
        assert set(p) == {"det", "cls"}
        assert p["det"]["num_labels"] == 11
        w = np.asarray(ref32.params["cls"]["classifier"]["w"])
        np.testing.assert_array_equal(p["cls"]["classifier"]["w"].numpy(), w)

    def test_float32_against_reference(self, ref32, frames):
        port = _port(ref32, torch.float32)
        fn = jax.jit(lambda a: ref32.apply(ref32.params, a))
        for x in frames:
            want_d, want_l = (np.asarray(o) for o in fn(x))
            with torch.inference_mode():
                got_d, got_l = (o.numpy() for o in port(torch.from_numpy(x)))
            assert got_d.shape == (4, 6) and got_l.shape == (4, 16)
            _check_dets_and_logits(got_d, got_l, want_d, want_l)

    def test_bfloat16_top1_labels(self, frames):
        ref = jc.build_detect_classify(**SMALL, dtype=jnp.bfloat16)
        port = _port(ref, torch.bfloat16)
        fn = jax.jit(lambda a: ref.apply(ref.params, a)).lower(frames[0]).compile(
            {"xla_allow_excess_precision": False})
        for x in frames:
            want_d, want_l = (np.asarray(o) for o in fn(x))
            with torch.inference_mode():
                got_d, got_l = (o.numpy() for o in port(torch.from_numpy(x)))
            np.testing.assert_array_equal(got_d[:, 4], want_d[:, 4])
            _check_bf16_dets(got_d, want_d)
            np.testing.assert_array_equal(got_l.argmax(-1), want_l.argmax(-1))

    def test_batched_is_one_batch_and_equals_each_frame(self, ref32, frames):
        port = _port(ref32, torch.float32)
        calls = []
        mobilenet = tc.mobilenet_v2.apply

        def counting(params, x, **kw):
            calls.append(tuple(x.shape))
            return mobilenet(params, x, **kw)

        tc.mobilenet_v2.apply = counting
        try:
            with torch.inference_mode():
                got_d, got_l = (o.numpy() for o in port(torch.from_numpy(frames)))
        finally:
            tc.mobilenet_v2.apply = mobilenet
        assert calls == [(8, 32, 32, 3)]  # the 2 x 4 crops in one classifier call
        assert got_d.shape == (2, 4, 6) and got_l.shape == (2, 4, 16)
        want = jax.jit(lambda a: ref32.apply(ref32.params, a))(frames)
        _check_dets_and_logits(got_d, got_l, np.asarray(want[0]), np.asarray(want[1]))
        for n in range(2):
            with torch.inference_mode():
                d, l = port(torch.from_numpy(frames[n]))
            np.testing.assert_allclose(got_d[n], d.numpy(), rtol=0, atol=DET_ATOL)
            np.testing.assert_allclose(got_l[n], l.numpy(), rtol=0,
                                       atol=LOGIT_RTOL * np.abs(l.numpy()).max())

    def test_rank_checked(self, ref32):
        port = _port(ref32, torch.float32)
        with pytest.raises(ValueError, match="rank"):
            port(torch.zeros(96, 96))


NORMALIZE = "typecast:float32,add:-127.5,div:127.5"


class TestCascadeThroughLaunch:
    def test_normalize_folds_and_matches_the_plain_chain(self, ref32, tmp_path, monkeypatch):
        """The cascade from a checkpoint named in a launch string, the
        normalize folded into its filter: each frame's outputs equal the
        model run on the plain ``fused_arith`` of the same frame, bit for
        bit, and the reference pipeline's within the stated tolerances."""
        import nnstreamer_tpu as jnns
        import nnstreamer_tpu_torch as nns
        from nnstreamer_tpu_torch.elements.transform import _bind_chain, _parse_arith_ops
        from nnstreamer_tpu_torch.ops import kernels as K
        from nnstreamer_tpu_torch.utils.checkpoint import save_state

        monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")
        ckpt = str(tmp_path / "cascade.npz")
        save_state(_tree(ref32), ckpt)
        rng = np.random.default_rng(4)
        imgs = [rng.integers(0, 256, (96, 96, 3), dtype=np.uint8) for _ in range(3)]
        custom = ("builder=cascade:build_detect_classify,num_labels=11,det_size=96,k=4,"
                  "crop_size=32,num_classes=16,width_mult=0.35")
        desc = (f"datasrc name=s ! tensor_transform mode=arithmetic option={NORMALIZE} "
                "acceleration=pallas device=cpu ! tensor_filter framework=torch name=f "
                f"model={ckpt} custom={custom} ! tensor_sink name=out collect=true")
        p = nns.parse_launch(desc)
        p["s"].data = [torch.from_numpy(x) for x in imgs]
        p.start()
        try:
            assert p.wait(120)
            model = p["f"].backend.model  # open until the stop
        finally:
            p.stop()
        assert not any(type(n).__name__ == "TensorTransform" for n in p.nodes.values())
        got = [tuple(o.numpy() for o in f.tensors) for f in p["out"].frames]
        assert len(got) == 3
        ops = _bind_chain(_parse_arith_ops(NORMALIZE), np.dtype(np.uint8))
        for (d, l), x in zip(got, imgs):
            with torch.inference_mode():
                wd, wl = model(K.fused_arith_plain(torch.from_numpy(x), ops))
            np.testing.assert_array_equal(d, wd.numpy())
            np.testing.assert_array_equal(l, wl.numpy())
        jp = jnns.parse_launch(
            f"datasrc name=s ! tensor_transform mode=arithmetic option={NORMALIZE} "
            "acceleration=pallas ! tensor_filter framework=jax name=f ! "
            "tensor_sink name=out collect=true")
        jp["s"].data = imgs
        jp["f"].model = jc.build_detect_classify(**SMALL, dtype=jnp.bfloat16,
                                                 det_params=ref32.params["det"],
                                                 cls_params=ref32.params["cls"])
        jp.run(timeout=300)
        for (d, l), f in zip(got, jp["out"].frames):
            want_d, want_l = (np.asarray(t) for t in f.tensors)
            _check_bf16_dets(d, want_d)
            np.testing.assert_array_equal(l.argmax(-1), want_l.argmax(-1))
