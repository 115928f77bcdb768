"""The port's pose path (BASELINE.md config 3) against the JAX package's:
``models/posenet.py`` (heatmaps, the fused keypoint decode, the int8 model),
the ``pose_estimation`` decoder in both input forms with labels, and the
pose pipeline from a launch string with the model named by it.

The JAX models are compiled as its backend compiles them and, for a bitwise
comparison, with ``xla_allow_excess_precision=False`` (as
``tests/test_torch_quant.py`` does).  Then every step but the convs is
equal bit for bit, the sigmoid included (``models/layers.py::sigmoid``),
and a bfloat16 conv lane differs only where the two float32 sums, added in
another order, round to either side of a bfloat16 tie (ROADMAP C14,
``TestSummationOrder``, at 96x96, 128x128 and the full 224x224 width 1.0).
At 128x128 no such lane survives to the heatmaps, which are then equal bit
for bit.  float32 convs: heatmaps within 5e-5.  Against the default
compile (excess precision), a float model's keypoint is the reference's
wherever its channel's top-1 margin exceeds 0.02, and its score is within
0.02; the int8 model's is held to the strict compile's, exactly.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.decoders import pose as jpose
from nnstreamer_tpu.models import posenet as jp
from nnstreamer_tpu.utils import checkpoint as jckpt
from nnstreamer_tpu_torch.decoders import pose as tpose
from nnstreamer_tpu_torch.elements.decoder import known_decoders
from nnstreamer_tpu_torch.models import posenet as tp

SIZE = 128
STRICT = {"xla_allow_excess_precision": False}
JOINTS = ["top", "neck", "r_shoulder", "r_elbow", "r_wrist", "l_shoulder", "l_elbow",
          "l_wrist", "r_hip", "r_knee", "r_ankle", "l_hip", "l_knee", "l_ankle"]
MARGIN = 0.02


@pytest.fixture(scope="module")
def tree():
    return jp.init_params(jax.random.PRNGKey(0), width_mult=0.35)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _strict(model):
    fn = jax.jit(model.fn())
    cache = {}

    def call(x):
        x = jnp.asarray(x)
        if x.shape not in cache:
            cache[x.shape] = fn.lower(x).compile(STRICT)
        return np.asarray(cache[x.shape](x))
    return call


def _frames(n=2, size=SIZE):
    rng = np.random.default_rng(7)
    return [rng.uniform(-1, 1, (size, size, 3)).astype(np.float32) for _ in range(n)]


class TestPoseNet:
    @pytest.mark.parametrize("quantized", [False, True])
    def test_bfloat16_heatmaps_bitwise(self, tree, quantized):
        build_j = jp.build_quantized if quantized else jp.build
        build_t = tp.build_quantized if quantized else tp.build
        ref = _strict(build_j(image_size=SIZE, params=tree))
        port = build_t(image_size=SIZE, params=_np(tree), device="cpu")
        assert tuple(port.output_spec.tensors[0].shape) == (8, 8, 14)
        for x in _frames():
            got = port(torch.from_numpy(x)).numpy()
            assert got.shape == (8, 8, 14) and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref(x))

    @pytest.mark.parametrize("quantized", [False, True])
    def test_float32_heatmaps_close(self, tree, quantized):
        build_j = jp.build_quantized if quantized else jp.build
        build_t = tp.build_quantized if quantized else tp.build
        ref = _strict(build_j(image_size=SIZE, params=tree, dtype=jnp.float32))
        port = build_t(image_size=SIZE, params=_np(tree), dtype=torch.float32, device="cpu")
        for x in _frames():
            np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), ref(x), rtol=0,
                                       atol=5e-5)

    def test_fused_decode_bitwise_and_batched(self, tree):
        ref = _strict(jp.build(image_size=SIZE, params=tree, fused_decode=True, batch=2))
        port = tp.build(image_size=SIZE, params=_np(tree), fused_decode=True, batch=2,
                        device="cpu")
        x = np.stack(_frames())
        got = port(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 14, 3)
        np.testing.assert_array_equal(got, ref(x))

    def test_int8_head_pads_to_the_gemm(self, tree):
        """The 1x1 head has N = 14 columns: the int8 product pads them to a
        multiple of 8 (16), and the 14 heatmaps come back."""
        port = tp.build_quantized(image_size=SIZE, params=_np(tree), device="cpu")
        prep = port.params["head"]["int8"]
        assert prep.cout == 14 and prep.w_mat.shape[1] == 16
        assert tp.grid_size(224) == 14

    def test_seeded_tree_has_the_reference_layout(self):
        mine, ref = tp.init_tree(0), _np(jp.init_params(jax.random.PRNGKey(0)))  # width 1.0
        assert len(mine["blocks"]) == len(ref["blocks"]) == 13
        assert mine["head"]["w"].shape == ref["head"]["w"].shape == (1, 1, 96, 14)
        assert tp.init_tree(0, 0.35)["head"]["w"].shape == (1, 1, 32, 14)
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda a: a, ref))


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_conv(call, cache={}):
    """The JAX package's bfloat16 conv (``lax.conv_general_dilated``, NHWC
    and HWIO as ``models/layers.py::conv2d`` lays them out), compiled
    strictly, on the operands of a conv the port recorded."""
    pad = call["padding"] if isinstance(call["padding"], tuple) else (call["padding"],) * 2
    key = (tuple(call["x"].shape), tuple(call["w"].shape), call["stride"], pad, call["groups"])
    if key not in cache:
        fn = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
            x, w, (call["stride"],) * 2, [(pad[0], pad[0]), (pad[1], pad[1])],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=call["groups"]))
        x = jnp.zeros([call["x"].shape[i] for i in (0, 2, 3, 1)], jnp.bfloat16)
        w = jnp.zeros([call["w"].shape[i] for i in (2, 3, 1, 0)], jnp.bfloat16)
        cache[key] = fn.lower(x, w).compile(STRICT)
    x = jnp.asarray(call["x"].float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
    w = jnp.asarray(call["w"].float().permute(2, 3, 1, 0).numpy()).astype(jnp.bfloat16)
    y = np.array(cache[key](x, w).astype(jnp.float32))
    return torch.from_numpy(y).to(torch.bfloat16).permute(0, 3, 1, 2)


def _forced(size, width, frame):
    """The port's bfloat16 heatmaps fed the JAX package's conv outputs (each
    computed on the port's own operands), the reference's heatmaps, and the
    convs: the port's output of each beside the reference's (``ref``)."""
    tree = jp.init_params(jax.random.PRNGKey(0), width_mult=width)
    port = tp.build(image_size=size, params=_np(tree), device="cpu")

    def reference(i, call):
        call["ref"] = _jax_conv(call)
        return call["ref"]

    x = _frames(frame + 1, size)[frame]
    hm, calls = SMOKE.conv_calls(torch, lambda: port(torch.from_numpy(x)), reference)
    want = _strict(jp.build(image_size=size, params=tree))(x)
    return hm.numpy(), want, calls, port(torch.from_numpy(x)).numpy()


SMOKE = _smoke()


class TestSummationOrder:
    """Where the bfloat16 heatmaps differ (ROADMAP C14): a conv's float32
    sum, which the port (oneDNN) and the reference (XLA) add in another
    order, lands within float32 rounding of a bfloat16 tie and rounds to the
    other side; from there the difference spreads.  Everything else is
    equal bit for bit: fed the reference's conv outputs, the port's
    heatmaps are the reference's, and every lane of every conv of both lies
    within ``chip_smoke.accumulation_bounds`` of its exact sum."""

    @pytest.mark.parametrize("size,width,lanes", [(96, 0.35, 3), (128, 0.35, 3),
                                                  (224, 1.0, 38)])
    def test_only_the_convs_summation_order_differs(self, size, width, lanes):
        """``lanes``: the conv lanes where the two orders round apart, each
        by one bfloat16 step (at 224x224 width 1.0 the port's lane is the
        nearer to the exact sum in 20 of the 38, the reference's in 16)."""
        hm, want, calls, _ = _forced(size, width, 0)
        np.testing.assert_array_equal(hm, want)
        assert len(calls) == 40  # stem, 12 expand, 13 depthwise, 13 project, head
        apart = 0
        for call in calls:
            assert SMOKE.conv_lanes_outside(torch, call) == 0
            assert SMOKE.conv_lanes_outside(torch, call, call["ref"]) == 0
            diff = call["out"] != call["ref"]
            steps = (call["out"][diff].view(torch.int16).int()
                     - call["ref"][diff].view(torch.int16).int()).abs()
            assert (steps == 1).all()
            apart += int(diff.sum())
        assert apart == lanes

    def test_roadmap_c14_pinned(self):
        """C14's input: width 0.35 at 96x96, seed 0, the first frame of
        ``_frames``.  Three conv lanes round apart; the residual adds absorb
        two (block 3's project, the 9th conv, and block 11's, the 33rd).  The
        one that stays is in block 10's depthwise conv (the 29th): its exact
        sum, 1.91015637..., lies one float32 ulp above the tie 1.91015625;
        the reference's order reaches it and rounds up, oneDNN's reaches the
        tie and rounds to even, down.  Run free, the heatmaps then differ in
        157 of 504 values (by at most 0.015625); the keypoints agree."""
        hm, want, calls, free = _forced(96, 0.35, 0)
        diffs = [(i, tuple(int(v) for v in lane))
                 for i, c in enumerate(calls) for lane in torch.nonzero(c["out"] != c["ref"])]
        assert diffs == [(8, (0, 4, 1, 14)), (28, (0, 65, 4, 3)), (32, (0, 29, 1, 0))]
        call = calls[28]
        assert call["groups"] == call["x"].shape[1] == 144
        mine, ref = float(call["out"][0, 65, 4, 3]), float(call["ref"][0, 65, 4, 3])
        assert (mine, ref) == (1.90625, 1.9140625)
        xd = call["x"].double()[:, 65:66]
        exact = float(torch.nn.functional.conv2d(
            xd, call["w"].double()[65:66], padding=call["padding"])[0, 0, 4, 3])
        assert 0 < exact - 1.91015625 <= 2.0 ** -23
        assert (free != want).sum() == 157 and np.abs(free - want).max() == 0.015625
        np.testing.assert_array_equal(free.reshape(-1, 14).argmax(0),
                                      want.reshape(-1, 14).argmax(0))


class TestDecodeKeypoints:
    @pytest.mark.parametrize("kind", ["random", "ties", "flat", "batched"])
    def test_against_jax_and_numpy(self, kind):
        """Ties take the first cell in row-major order in all three."""
        rng = np.random.default_rng(5)
        hm = rng.random((14, 14, 14)).astype(np.float32)
        if kind == "ties":  # two equal maxima per channel, the later one first in x
            hm[:] = np.float32(0.25)
            for k in range(14):
                hm[k, 13 - k, k] = hm[13 - k, k, k] = np.float32(0.75)
        elif kind == "flat":
            hm[:] = np.float32(0.5)
        elif kind == "batched":
            hm = rng.random((3, 7, 9, 14)).astype(np.float32)
        got = tp.decode_keypoints(torch.from_numpy(hm)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jp.decode_keypoints(jnp.asarray(hm))))
        flat = hm.reshape(-1, hm.shape[-3] * hm.shape[-2], 14)
        idx = flat.argmax(axis=1)
        ys, xs = np.unravel_index(idx, hm.shape[-3:-1])
        np.testing.assert_array_equal(got.reshape(-1, 14, 3)[..., 0], xs)
        np.testing.assert_array_equal(got.reshape(-1, 14, 3)[..., 1], ys)
        if kind == "flat":
            assert not got[..., :2].any()


def _decode_both(x, **options):
    """The pose decoder of each package on the same tensor: (overlay,
    keypoints) from a one-frame pipeline."""
    out = []
    for nns, t in ((tnns, torch.from_numpy(x)), (jnns, x)):
        p = nns.Pipeline()
        src = p.add(nns.make("datasrc", data=[t]))
        dec = p.add(nns.make("tensor_decoder", mode="pose_estimation", **options))
        sink = p.add(nns.make("tensor_sink", "out", collect=True))
        p.link_chain(src, dec, sink)
        p.run(timeout=30)
        f = sink.frames[0]
        out.append((np.asarray(f.tensor(0)), f.meta["pose"]))
    return out


class TestDecoder:
    def test_keypoint_argmax_and_skeleton(self):
        grid = np.zeros((16, 16, 14), np.float32)
        for k in range(14):
            grid[k, k, k] = 1.0
        (canvas, kps), (want, wkps) = _decode_both(grid, option1="64:64", option2="16:16")
        assert kps == wkps and [(x, y) for x, y, _ in kps] == [(k, k) for k in range(14)]
        assert canvas.shape == (64, 64, 4) and canvas.dtype == np.uint8
        np.testing.assert_array_equal(canvas, want)
        assert canvas[0, 0, 3] == 255 and canvas[4, 4, 3] == 255

    @pytest.mark.parametrize("form", ["heatmaps", "fused"])
    def test_overlay_with_labels_bitwise(self, tmp_path, form):
        labels = tmp_path / "joints.txt"
        labels.write_text("\n".join(JOINTS[:12]))  # two joints fall back to their index
        rng = np.random.default_rng(9)
        if form == "heatmaps":
            x = rng.random((14, 14, 14)).astype(np.float32)
        else:
            x = np.concatenate([rng.integers(0, 14, (14, 2)), rng.random((14, 1))],
                               axis=1).astype(np.float32)
        (canvas, kps), (want, wkps) = _decode_both(
            x, option1="224:224", option2="14:14", option3=str(labels))
        assert kps == wkps and len(kps) == 14
        np.testing.assert_array_equal(canvas, want)
        assert (canvas[..., 3] > 0).sum() > 500  # the labels are drawn

    def test_specs_and_registration(self):
        assert "pose_estimation" in known_decoders()
        assert tpose.EDGES == jpose.EDGES and len(tpose.EDGES) == 13
        with pytest.raises(tnns.NegotiationError, match="grid size"):
            p = tnns.Pipeline()
            src = p.add(tnns.make("datasrc", data=[torch.zeros(14, 3)]))
            dec = p.add(tnns.make("tensor_decoder", mode="pose_estimation"))
            p.link_chain(src, dec, p.add(tnns.make("tensor_sink")))
            p.start()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, tree):
    path = str(tmp_path_factory.mktemp("pose") / "posenet.npz")
    jckpt.save_state(tree, path)
    return path


POSE = ("datasrc name=s ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 acceleration=pallas{dev} ! "
        "tensor_filter framework={fw} name=f model={path} "
        "custom=builder=posenet:{builder},image_size=128{extra} ! "
        "tensor_decoder mode=pose_estimation option1=128:128 option2=8:8 option3={joints} ! "
        "tensor_sink name=out collect=true")


@pytest.mark.parametrize("builder,extra", [("build", ",fused_decode=1"), ("build", ""),
                                           ("build_quantized", "")])
def test_launch_string_matches_reference(checkpoint, tmp_path, monkeypatch, builder, extra):
    """Config 3's string with the model named in it, on the CPU in both
    packages: the builder's ``custom=`` keys reach it; the keypoints equal
    a direct build's on the normalized frames, bit for bit, and the JAX
    pipeline's where the margin allows (module docstring)."""
    monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")
    joints = tmp_path / "joints.txt"
    joints.write_text("\n".join(JOINTS))
    frames = [np.random.default_rng(i).integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
              for i in range(3)]
    kw = dict(path=checkpoint, builder=builder, extra=extra, joints=joints)
    p = tnns.parse_launch(POSE.format(dev=" device=cpu", fw="torch", **kw))
    p["s"].data = [torch.from_numpy(f) for f in frames]
    p.run(timeout=300)
    q = jnns.parse_launch(POSE.format(dev="", fw="jax", **kw))
    q["s"].data = frames
    q.run(timeout=300)
    build = getattr(tp, builder)
    direct = build(image_size=SIZE, params=jckpt.load_state(checkpoint), device="cpu",
                   **({"fused_decode": True} if extra else {}))
    ref = (jp.build_quantized if builder == "build_quantized" else jp.build)(
        image_size=SIZE, params=jckpt.load_state(checkpoint))
    for f, got, want in zip(frames, p["out"].frames, q["out"].frames):
        norm = (f.astype(np.float32) - np.float32(127.5)) * np.float32(1 / np.float32(127.5))
        out = direct(torch.from_numpy(norm)).numpy()
        kps = out if extra else tp.decode_keypoints(torch.from_numpy(out)).numpy()
        assert got.meta["pose"] == [(int(x), int(y), float(s)) for x, y, s in kps]
        assert got.tensor(0).shape == (SIZE, SIZE, 4) and len(want.meta["pose"]) == 14
        if builder == "build_quantized":
            # the int8 quantize amplifies excess precision (scores move by
            # up to 0.13): the strict compile's keypoints, exactly
            strict = _strict(ref)(norm)
            want_kps = jp.decode_keypoints(jnp.asarray(strict))
            assert got.meta["pose"] == [(int(x), int(y), float(s)) for x, y, s in
                                        np.asarray(want_kps)]
            continue
        hm = np.asarray(jax.jit(ref.fn())(jnp.asarray(norm))).reshape(-1, 14)
        top2 = np.sort(hm, axis=0)[-2:]
        for k, ((gx, gy, gs), (wx, wy, ws)) in enumerate(zip(got.meta["pose"],
                                                             want.meta["pose"])):
            assert abs(gs - ws) <= MARGIN
            if top2[1, k] - top2[0, k] > MARGIN:
                assert (gx, gy) == (wx, wy)
