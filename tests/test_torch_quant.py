"""The port's full-int8 trunk against the JAX package's (ROADMAP item 7).

``ops/quant.py`` (activation quantization per tensor, per sample and per
row, the static quantize, weight quantization in the port's layout, the
int8 product on ``torch._int_mm``, calibration) and
``models/layers.py::conv2d_int8`` are held to the JAX package bit for bit;
the full-int8 MobileNet-v2 (dynamic and static scales, with the int8 head)
and the int8 SSD run on the same params in both.  Small size: width 0.35,
64x64 and 10 classes; SSD at 96x96 with 5 labels.  The JAX functions run
under ``jax.jit`` with the params closed over, as its backend runs them
(``JaxModel.fn``), so XLA sees each static scale as a constant.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.models import layers as jl
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.models import ssd_mobilenet as js
from nnstreamer_tpu.models import audio_cnn as jaudio
from nnstreamer_tpu.ops import quant as jq
from nnstreamer_tpu.utils import checkpoint as jckpt
from nnstreamer_tpu_torch.models import audio_cnn as taudio
from nnstreamer_tpu_torch.models import layers as tl
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.models import ssd_mobilenet as ts
from nnstreamer_tpu_torch.ops import quant as tq

KW = dict(num_classes=10, width_mult=0.35, image_size=64)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The JAX package compiled as the port computes bfloat16: XLA's default
# keeps an intermediate in float32 where the next op converts it to float32
# anyway ("excess precision"); in the full-int8 trunk that is the sum of a
# residual block, which feeds the next block's int8 quantize unrounded.
STRICT_BF16 = {"xla_allow_excess_precision": False}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_fn(model, strict=False):
    """The JAX model's function as its backend compiles it, params closed
    over; with ``strict`` every bfloat16 value rounded as the port rounds."""
    fn = jax.jit(model.fn())
    cache = {}

    def call(x):
        x = jnp.asarray(x)
        key = (x.shape, x.dtype)
        if key not in cache:
            cache[key] = fn.lower(x).compile(STRICT_BF16 if strict else None)
        out = cache[key](x)
        return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)

    return call


def _frames(seed, n=4, size=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (size, size, 3)).astype(np.float32) for _ in range(n)]


def _act_scales(tree, out=None):
    """Every ``act_scale`` of a params tree, dict keys in sorted order."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        if "act_scale" in tree:
            out.append(tree["act_scale"])
        for k in sorted(tree):
            _act_scales(tree[k], out)
    elif isinstance(tree, list):
        for v in tree:
            _act_scales(v, out)
    return out


class TestQuantize:
    @pytest.mark.parametrize("axes", [None, (1, 2, 3), (-1,)])
    @pytest.mark.parametrize("dt", sorted(DTYPES))
    def test_quantize_activations_matches_reference(self, dt, axes):
        """int8 values and scales bit for bit, per tensor, per sample and per
        row; in bfloat16 the scale is ``amax / 127`` rounded to bfloat16."""
        jdt, tdt = DTYPES[dt]
        x = (np.random.default_rng(1).standard_normal((3, 5, 6, 8)) * 4).astype(np.float32)
        x[1] = 0.0  # an all-zero sample: scale 1.0
        xj = jnp.asarray(x).astype(jdt)
        qj, sj = (np.asarray(a) for a in
                  jax.jit(lambda v: jq.quantize_activations(v, axes=axes))(xj))
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
        qt, st = tq.quantize_activations(xt, axes=axes)
        np.testing.assert_array_equal(qt.numpy(), qj)
        assert st.dtype == torch.float32
        np.testing.assert_array_equal(st.numpy().reshape(np.shape(sj)), sj)

    def test_quantize_static_is_the_closed_over_reciprocal(self):
        """With the scale closed over, XLA turns ``x / s`` into ``x *
        f32(1/s)``, which the port computes; passed as an argument the
        division stays one.  The quotients differ on thousands of values,
        the int8 values where a quotient sits next to a half."""
        x = (np.random.default_rng(2).standard_normal(100_000) * 3).astype(np.float32)
        s = 0.0123456789
        s32 = jnp.asarray(s, jnp.float32)
        closed = np.asarray(jax.jit(lambda v: jq.quantize_static(v, s32))(x))
        got = tq.quantize_static(torch.from_numpy(x), s).numpy()
        np.testing.assert_array_equal(got, closed)
        argued = np.asarray(jax.jit(jq.quantize_static)(x, s32))
        np.testing.assert_array_equal(argued, np.clip(np.round(x / np.float32(s)), -127, 127)
                                      .astype(np.int8))
        quotients = np.asarray(jax.jit(lambda v: v / s32)(x)), np.asarray(jax.jit(jnp.divide)(x, s32))
        np.testing.assert_array_equal(quotients[0], x * np.float32(tq.static_inverse(s)))
        assert np.count_nonzero(quotients[0] != quotients[1]) > 5000

    def test_quantize_model_matches_reference_per_channel(self):
        """The port's layout (OIHW, depthwise (C,1,3,3), (out, in, width),
        (cin, cout)): the q and scale of the JAX package's HWIO ``axis=-1``
        quantization of the same weights, bit for bit."""
        tree = _np(jm.init_params(jax.random.PRNGKey(3), 10, 0.35))
        port = tq.quantize_model(tm.build(**KW, params=tree, device="cpu")).params
        ref = jq.quantize_params(jm.init_params(jax.random.PRNGKey(3), 10, 0.35))
        pairs = [(port["stem"]["conv"]["w"], ref["stem"]["conv"]["w"]),
                 (port["blocks"][3]["depthwise"]["conv"]["w"], ref["blocks"][3]["depthwise"]["conv"]["w"]),
                 (port["head"]["conv"]["w"], ref["head"]["conv"]["w"])]
        for a, b in pairs:
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q).transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(a.scale.numpy().reshape(-1), np.asarray(b.scale).reshape(-1))
        np.testing.assert_array_equal(port["classifier"]["w"].q.numpy(),
                                      np.asarray(ref["classifier"]["w"].q))
        np.testing.assert_array_equal(port["classifier"]["w"].scale.numpy(),
                                      np.asarray(ref["classifier"]["w"].scale))
        assert port["blocks"][3]["stride"] == 2 and torch.is_tensor(port["classifier"]["b"])
        # a 1-D conv kernel: (width, in, out) in the JAX package
        audio = _np(jaudio.init_params(jax.random.PRNGKey(0), 12))
        tw = taudio.params_from_jax(audio, "cpu")["convs"][1]["w"]
        q = tq.quantize_model(tnns.backends.torch_backend.TorchModel(
            apply=None, params={"w": tw}, device="cpu")).params["w"]
        jw = jq.quantize_weight(audio["convs"][1]["w"])
        np.testing.assert_array_equal(q.q.numpy(), np.asarray(jw.q).transpose(2, 1, 0))
        np.testing.assert_array_equal(q.scale.numpy().reshape(-1), np.asarray(jw.scale).reshape(-1))

    def test_quantize_params_matches_reference(self):
        tree = _np(jm.init_params(jax.random.PRNGKey(4), 10, 0.35))
        port = tq.quantize_params(tree)
        ref = jq.quantize_params(jm.init_params(jax.random.PRNGKey(4), 10, 0.35))
        for path in (("stem", "conv"), ("head", "conv")):
            a, b = port[path[0]][path[1]]["w"], ref[path[0]][path[1]]["w"]
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
            np.testing.assert_array_equal(a.scale.numpy(), np.asarray(b.scale))
        w = port["head"]["conv"]["w"]
        np.testing.assert_array_equal(tq.dequantize(w).numpy(),
                                      np.asarray(jq.dequantize(ref["head"]["conv"]["w"])))

    @pytest.mark.parametrize("shape", [(5, 64), (2, 3, 40)])
    def test_matmul_int8_matches_reference(self, shape):
        """Per-row scales, int32 accumulation, the float32 epilogue: bit for
        bit."""
        rng = np.random.default_rng(5)
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        w = rng.standard_normal((shape[-1], 36)).astype(np.float32)
        jw = jq.quantize_weight(w)
        want = np.asarray(jax.jit(lambda v: jq.matmul_int8(v, jw))(x))
        got = tq.matmul_int8(torch.from_numpy(x), tq.quantize_weight(w)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("m,k,n", [(1, 27, 12), (4, 2880, 546), (9, 72, 273), (49, 320, 1280),
                                       (17, 8, 8)])
    def test_int_mm_pads_to_the_cuda_rules(self, m, k, n):
        """M > 16 and K, N multiples of 8 (cuBLASLt's int8 GEMM), on every
        device: the stem's K = 27, SSD's 3x3, 2x2 and 1x1 grids and its
        heads' N = 12, 273, 546; exact against an int64 product."""
        rng = np.random.default_rng(m + k + n)
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        w = tq.int8_weight_matrix(b)
        mp, kp, np_ = tq.mm_shape(m, k, n)
        assert mp > 16 and kp % 8 == 0 and np_ % 8 == 0 and tuple(w.shape) == (kp, np_)
        assert w.stride() == (1, kp)  # column-major
        got = tq.int_mm(a, w)
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, np_)
        assert torch.equal(got[:, :n], (a.long() @ b.long()).int())
        assert not got[:, n:].any()


CONV_CASES = [(1, 16, 24, 8, 1), (1, 24, 8, 5, 1), (3, 3, 16, 9, 2), (3, 3, 16, 8, 2),
              (3, 8, 12, 7, 1), (3, 8, 12, 6, 1), (3, 16, 24, 6, 2)]


class TestConv2dInt8:
    @pytest.mark.parametrize("dt", sorted(DTYPES))
    @pytest.mark.parametrize("static", [False, True])
    @pytest.mark.parametrize("k,cin,cout,size,stride", CONV_CASES)
    def test_int8_values_accumulators_and_output_bitwise(self, k, cin, cout, size, stride,
                                                         static, dt):
        """1x1, 3x3 at stride 1 and 2, odd and even sizes (an even input at
        stride 2 pads (0, 1)), Cin = 3: the int8 activations, the int32
        accumulators and the output in ``dt`` equal the JAX package's
        ``conv2d_int8`` jitted with the params closed over."""
        jdt, tdt = DTYPES[dt]
        rng = np.random.default_rng(size * 10 + k + cin)
        w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
        x = (rng.standard_normal((2, size, size, cin)) * 2).astype(np.float32)
        jp = {"w": jq.quantize_weight(w)}
        if static:
            jp["act_scale"] = float(np.abs(x).max() / 127.0 * 0.8)  # some values clip
        xj = jnp.asarray(x).astype(jdt)
        want = np.asarray(jax.jit(lambda v: jl.conv2d_int8(jp, v, stride=stride, dtype=jdt))(xj)
                          .astype(jnp.float32))
        tp = tm.params_from_jax({k_: _np(v) for k_, v in jp.items()}, "cpu")
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
        got = tl.conv2d(tp, xt, stride=stride, dtype=tdt, int8=True)
        assert got.dtype == tdt and tuple(got.shape) == (2, cout, -(-size // stride), -(-size // stride))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), want)
        if static:
            s = jp["act_scale"]
            qj = np.asarray(jax.jit(lambda v: jq.quantize_static(v, jnp.asarray(s, jnp.float32)))(xj))
            qt = tq.quantize_static(xt, s)
        else:
            qj = np.asarray(jax.jit(lambda v: jq.quantize_activations(v, axes=(1, 2, 3))[0])(xj))
            qt = tq.quantize_activations(xt, axes=(1, 2, 3))[0]
        np.testing.assert_array_equal(qt.permute(0, 2, 3, 1).numpy(), qj)
        accj = np.asarray(jax.jit(lambda q: lax.conv_general_dilated(
            q, jp["w"].q, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32))(jnp.asarray(qj)))
        prep = tl.int8_conv_operands(tp)
        a, ho, wo = tl._im2col(qt, k, k, stride, prep.w_mat.shape[0])
        acc = tq.int_mm(a, prep.w_mat)[:, :cout].reshape(2, ho, wo, cout)
        np.testing.assert_array_equal(acc.numpy(), accj)

    def test_one_by_one_conv_makes_no_copy(self):
        x = torch.randn(1, 8, 5, 5).to(memory_format=torch.channels_last)
        q = tq.quantize_static(x, 0.05)
        a, _, _ = tl._im2col(q, 1, 1, 1, 8)
        assert a.data_ptr() == q.data_ptr()

    def test_grouped_and_float_weights_take_the_float_path(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((1, 4, 6, 6)).astype(np.float32))
        dw = {"w": tq.quantize_weight(rng.standard_normal((4, 1, 3, 3)), axis=0)}
        want = tl.conv2d(dw, x, groups=4)
        assert torch.equal(tl.conv2d(dw, x, groups=4, int8=True), want)
        assert "int8" not in dw and "act_scale" not in dw
        fw = {"w": torch.from_numpy(rng.standard_normal((4, 4, 1, 1)).astype(np.float32))}
        assert torch.equal(tl.conv2d(fw, x, int8=True), tl.conv2d(fw, x))

    def test_operands_prepared_once_and_again_for_a_new_scale(self):
        rng = np.random.default_rng(1)
        p = {"w": tq.quantize_weight(rng.standard_normal((8, 4, 1, 1)), axis=0), "act_scale": 0.1}
        tl.prepare_int8(p)
        first = p["int8"]
        x = torch.from_numpy(rng.standard_normal((1, 4, 3, 3)).astype(np.float32))
        tl.conv2d_int8(p, x)
        assert p["int8"] is first and first.rescale is not None
        p["act_scale"] = 0.2
        tl.conv2d_int8(p, x)
        assert p["int8"] is not first and p["int8"].act_scale == 0.2


class TestCalibration:
    @staticmethod
    def _conv(seed=0):
        rng = np.random.default_rng(seed)
        w = rng.standard_normal((1, 1, 3, 8)).astype(np.float32)
        return {"w": tq.quantize_weight(w.transpose(3, 2, 0, 1), axis=0)}, w

    def test_every_int8_conv_annotated_with_the_reference_scales(self):
        """Calibrated on the same frames from the same params, every
        ungrouped conv (stem, 16 expand, 17 project, head: 35) records a
        scale, equal to the JAX package's (rtol 0: both calibrate eagerly in
        float32, op by op)."""
        tree = jm.init_params(jax.random.PRNGKey(0), 10, 0.35)
        kw = dict(**KW, dtype=jnp.float32, int8_convs=True, static_scales=True, calib_samples=3)
        ref = jm.build_quantized(**kw, params=tree)
        port = tm.build_quantized(**{**kw, "dtype": torch.float32}, params=_np(tree), device="cpu")
        a, b = _act_scales(ref.params), _act_scales(port.params)
        assert len(a) == len(b) == 35
        assert all(isinstance(s, float) for s in b)
        np.testing.assert_allclose(b, a, rtol=0)
        assert port.params["blocks"][1]["expand"]["conv"]["int8"].act_scale == \
            port.params["blocks"][1]["expand"]["conv"]["act_scale"]
        assert "act_scale" not in port.params["blocks"][1]["depthwise"]["conv"]

    def test_calibrating_scale_is_the_eager_division(self):
        """ROADMAP C11: inside ``calibration()`` the scale is ``amax / 127``,
        a true division, as the JAX package's eager calibration computes it
        (400 float32 (1,16,16,8) samples, normals times 0.1 to 20, numpy
        seed 0: the product with ``1/127`` differed on 16); outside, the
        product with the reciprocal that XLA compiles the division into."""
        rng = np.random.default_rng(0)
        xs = [(rng.standard_normal((1, 16, 16, 8)) * rng.uniform(0.1, 20)).astype(np.float32)
              for _ in range(400)]

        def port_scales():
            return np.array([float(tq.quantize_activations(
                torch.from_numpy(x).permute(0, 3, 1, 2), axes=(1, 2, 3))[1].reshape(()))
                for x in xs], np.float32)

        eager = np.array([float(np.asarray(jq.quantize_activations(
            jnp.asarray(x), axes=(1, 2, 3))[1]).reshape(())) for x in xs], np.float32)
        with tq.calibration():
            np.testing.assert_array_equal(port_scales(), eager)
        jitted = jax.jit(lambda v: jq.quantize_activations(v, axes=(1, 2, 3))[1])
        compiled = np.array([float(np.asarray(jitted(jnp.asarray(x))).reshape(())) for x in xs],
                            np.float32)
        np.testing.assert_array_equal(port_scales(), compiled)
        assert np.count_nonzero(eager != compiled) == 16

    def test_full_size_calibration_matches_the_reference(self):
        """ROADMAP C11 on a model: float32 MobileNet-v2 1.0 at 224x224 with
        1001 classes and the default four calibration samples, from the same
        params.  At most 4 of the 35 scales differ, where the float convs'
        summation order moves an activation's maximum (the product with
        ``1/127`` made it 8, one of them by 1.5%); each within 1.5%."""
        tree = jm.init_params(jax.random.PRNGKey(0), 1001, 1.0)
        kw = dict(num_classes=1001, width_mult=1.0, image_size=224, int8_convs=True,
                  static_scales=True)
        ref = jm.build_quantized(**kw, params=tree, dtype=jnp.float32)
        port = tm.build_quantized(**kw, params=_np(tree), dtype=torch.float32, device="cpu")
        a, b = np.array(_act_scales(ref.params)), np.array(_act_scales(port.params))
        assert len(a) == len(b) == 35
        assert np.count_nonzero(a != b) <= 4
        np.testing.assert_allclose(b, a, rtol=0.015)

    def test_calib_data_drives_the_scales(self):
        tree = _np(jm.init_params(jax.random.PRNGKey(0), 10, 0.35))
        kw = dict(**KW, int8_convs=True, static_scales=True, params=tree, device="cpu")
        small = tm.build_quantized(**kw)
        big = tm.build_quantized(**kw, calib_data=[np.full((64, 64, 3), 50.0, np.float32)])
        assert big.params["stem"]["conv"]["act_scale"] > small.params["stem"]["conv"]["act_scale"] * 10
        with pytest.raises(ValueError, match="empty"):
            tm.build_quantized(**kw, calib_data=[])

    def test_calibration_runs_on_a_cpu_copy_and_writes_back(self, monkeypatch):
        params, _ = self._conv()
        seen = []
        samples = [np.full((1, 3, 4, 4), 0.5, np.float32)]

        def fwd(p, x):
            seen.append((p is params, x.device.type))
            return tl.conv2d_int8(p, x)

        tq.calibrate_static_scales(fwd, params, samples)
        assert seen == [(False, "cpu")]
        assert params["act_scale"] == pytest.approx(0.5 / 127.0)
        tq.calibrate_static_scales(fwd, params, samples, device=None)
        assert seen[-1] == (True, "cpu")

    def test_concurrent_inference_survives_calibration(self):
        """The flag is thread-local: another thread's int8 conv takes its own
        path and its params gain no scale."""
        params, _ = self._conv()
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 3, 4, 4)).astype(np.float32))
        entered, release, seen = threading.Event(), threading.Event(), []

        def calibrator():
            with tq.calibration():
                seen.append(tq.is_calibrating())
                entered.set()
                release.wait(30)

        t = threading.Thread(target=calibrator)
        t.start()
        try:
            assert entered.wait(30)
            assert tq.is_calibrating() is False
            assert tuple(tl.conv2d_int8(params, x).shape) == (1, 8, 4, 4)
            assert "act_scale" not in params
        finally:
            release.set()
            t.join(timeout=30)
        assert seen == [True]

    def test_context_restores_nested_state(self):
        assert tq.is_calibrating() is False
        with tq.calibration():
            with tq.calibration():
                assert tq.is_calibrating() is True
            assert tq.is_calibrating() is True
        assert tq.is_calibrating() is False

    def test_zero_sample_does_not_pin_scale(self):
        params, _ = self._conv(3)
        zero = np.zeros((1, 3, 4, 4), np.float32)
        real = np.full((1, 3, 4, 4), 0.5, np.float32)
        tq.calibrate_static_scales(lambda p, a: tl.conv2d_int8(p, a), params, [zero, real])
        assert params["act_scale"] == pytest.approx(0.5 / 127.0)

    def test_all_zero_calibration_still_floors(self):
        params, _ = self._conv(3)
        zero = np.zeros((1, 3, 4, 4), np.float32)
        tq.calibrate_static_scales(lambda p, a: tl.conv2d_int8(p, a), params, [zero, zero])
        assert params["act_scale"] == 1.0

    def test_mid_calibration_zero_scale_never_divides(self):
        params, _ = self._conv(5)
        params["act_scale"] = 0.0
        x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (1, 3, 4, 4)).astype(np.float32))
        out = tl.conv2d_int8(params, x)
        assert torch.isfinite(out).all()
        assert torch.equal(out, tl.conv2d_int8({"w": params["w"]}, x))


@pytest.fixture(scope="module")
def float_tree():
    return jm.init_params(jax.random.PRNGKey(0), 10, 0.35)


TIERS = {"dynamic": dict(int8_convs=True),
         "static": dict(int8_convs=True, static_scales=True),
         "static_int8_head": dict(int8_convs=True, static_scales=True, int8_head=True)}


class TestMobileNet:
    @pytest.mark.parametrize("tier", sorted(TIERS))
    def test_float32_trunk_matches_reference(self, float_tree, tier):
        """float32 compute, the port calibrating on its own: the float convs
        (depthwise) sum in another order and agree to ~1e-6, which now and
        then moves a value across a rounding step of the next int8
        quantize; one int8 step moves the logits (about 4 in size) by about
        0.01.  Logits within 0.05, top-1 equal."""
        kw = dict(**KW, **TIERS[tier])
        ref = _ref_fn(jm.build_quantized(**kw, params=float_tree, dtype=jnp.float32))
        port = tm.build_quantized(**kw, params=_np(float_tree), dtype=torch.float32, device="cpu")
        for x in _frames(0):
            want, got = ref(x), port(torch.from_numpy(x)).numpy()
            assert np.argmax(got) == np.argmax(want)
            np.testing.assert_allclose(got, want, atol=0.05)

    @pytest.mark.parametrize("tier", sorted(TIERS))
    def test_bfloat16_trunk_matches_reference(self, float_tree, tier):
        """bfloat16 compute, the JAX package's calibrated params carried
        across by ``params_from_jax`` (act_scale stays a float): bit for bit
        against the JAX model compiled to round every bfloat16 value
        (``xla_allow_excess_precision=False``).  Against its default compile
        the logits move by up to 0.7 (of about 6), because XLA keeps the sum
        of a residual block in float32 where it feeds the next block's int8
        quantize, and a value that crosses a rounding step moves a whole
        int8 step; top-1 equal wherever the reference's top-1 margin is
        above 1.4, twice that drift."""
        kw = dict(**KW, **TIERS[tier])
        jmodel = jm.build_quantized(**kw, params=float_tree)
        carried = {k: v for k, v in kw.items() if k != "static_scales"}
        port = tm.build_quantized(**carried, params=_np(jmodel.params), device="cpu")
        assert _act_scales(port.params) == _act_scales(_np(jmodel.params))
        strict, default = _ref_fn(jmodel, strict=True), _ref_fn(jmodel)
        for x in _frames(1):
            got = port(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, strict(x))
            want = default(x)
            np.testing.assert_allclose(got, want, atol=0.7)
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > 1.4:
                assert np.argmax(got) == np.argmax(want)

    def test_own_calibration_matches_carried(self, float_tree):
        """Calibrated by the port (on the CPU, bfloat16) from the same
        params and frames: the same scales and logits as the JAX package's
        calibration carried across."""
        kw = dict(**KW, **TIERS["static"])
        jmodel = jm.build_quantized(**kw, params=float_tree)
        own = tm.build_quantized(**kw, params=_np(float_tree), device="cpu")
        assert _act_scales(own.params) == _act_scales(_np(jmodel.params))
        strict = _ref_fn(jmodel, strict=True)
        x = _frames(2, n=1)[0]
        np.testing.assert_array_equal(own(torch.from_numpy(x)).numpy(), strict(x))

    @pytest.mark.parametrize("tier", ["dynamic", "static"])
    def test_batch_composition_independence(self, float_tree, tier):
        """Per-sample (or static) scales: a frame's logits do not depend on
        the frame it is batched with, an outlier 100 times as large."""
        port = tm.build_quantized(**KW, **TIERS[tier], params=_np(float_tree), device="cpu",
                                  dtype=torch.float32)
        rng = np.random.default_rng(11)
        x = rng.random((1, 64, 64, 3)).astype(np.float32)
        outlier = rng.random((1, 64, 64, 3)).astype(np.float32) * 100.0
        alone = port(torch.from_numpy(x))[0]
        paired = port(torch.from_numpy(np.concatenate([x, outlier])))[0]
        np.testing.assert_allclose(paired.numpy(), alone.numpy(), rtol=1e-5, atol=1e-5)


class TestSsd:
    def test_int8_ssd_matches_reference(self):
        """``ssd_mobilenet.build_quantized``: every ungrouped conv (stem,
        blocks, extras, both heads; dynamic per-sample scales) int8, the
        weights quantized in the port's layout.  Boxes and scores bit for
        bit against the JAX model compiled as the port rounds bfloat16
        (see TestMobileNet).  Against its default compile the scores move by
        up to 2.7 (of about 20) for the reason TestMobileNet names, held to
        4; the best detection's anchor and class are equal wherever the best
        score leads the next by more than 8."""
        tree = js.init_params(jax.random.PRNGKey(0), 5)
        ref = js.build_quantized(num_labels=5, image_size=96, params=tree)
        port = ts.build_quantized(num_labels=5, image_size=96, params=_np(tree), device="cpu")
        assert port.name == ref.name == "ssd_mobilenet_v2_q8"
        head = port.params["cls_heads"][5]
        assert isinstance(head["w"], tq.QuantizedWeight) and head["int8"].w_mat.shape[1] == 32
        strict, default = _ref_fn(ref, strict=True), _ref_fn(ref)
        for x in _frames(3, n=2, size=96):
            gb, gs = (t.numpy() for t in port(torch.from_numpy(x)))
            sb, ss = strict(x)
            np.testing.assert_array_equal(gb, sb)
            np.testing.assert_array_equal(gs, ss)
            _, dsc = default(x)
            np.testing.assert_allclose(gs, dsc, atol=4)
            top2 = np.sort(dsc[:, 1:], axis=None)[-2:]
            if top2[1] - top2[0] > 8:
                best = np.unravel_index(np.argmax(dsc[:, 1:]), dsc[:, 1:].shape)
                assert np.unravel_index(np.argmax(gs[:, 1:]), gs[:, 1:].shape) == best


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q8") / "mobilenet_v2.npz")
    jckpt.save_state(jm.init_params(jax.random.PRNGKey(0), 10, 0.35), path)
    return path


CONFIG_1Q = ("datasrc name=s ! tensor_transform mode=arithmetic "
             "option=typecast:float32,add:-127.5,div:127.5 acceleration=pallas{dev} ! "
             "tensor_filter framework={fw} name=f model={path} "
             "custom=builder=mobilenet_v2:build_quantized,int8_convs=1,static_scales=1,"
             "calib_samples=2,num_classes=10,width_mult=0.35,image_size=64 ! "
             "tensor_sink name=out collect=true")


def test_config_1q_launch_string_labels_match_reference(checkpoint, monkeypatch):
    """The flagship's launch string on the CPU in both packages, the same
    checkpoint and frames: the builder's ``custom=`` keys reach it, the
    model calibrates when the filter opens, and the labels are the JAX
    pipeline's wherever its top-1 margin is above 1.4 (the bfloat16 drift
    of TestMobileNet); the logits equal a direct build's, bit for bit."""
    monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")
    frames = [np.random.default_rng(i).integers(0, 256, (64, 64, 3)).astype(np.uint8)
              for i in range(4)]
    p = tnns.parse_launch(CONFIG_1Q.format(dev=" device=cpu", fw="torch", path=checkpoint))
    p["s"].data = [torch.from_numpy(f) for f in frames]
    models = []
    p["out"].connect("new-data", lambda frame: models.append(p["f"].backend.model))
    p.run(timeout=300)
    model = models[0]
    assert model.name == "mobilenet_v2_q8_0.35_64"
    assert len(_act_scales(model.params)) == 35
    q = jnns.parse_launch(CONFIG_1Q.format(dev="", fw="jax", path=checkpoint))
    q["s"].data = frames
    q.run(timeout=300)
    direct = tm.build_quantized(**KW, int8_convs=True, static_scales=True, calib_samples=2,
                                params=jckpt.load_state(checkpoint), device="cpu")
    assert _act_scales(direct.params) == _act_scales(model.params)
    for f, got, want in zip(frames, p["out"].frames, q["out"].frames):
        got, want = got.tensor(0).numpy(), np.asarray(want.tensor(0))
        norm = (f.astype(np.float32) - np.float32(127.5)) * np.float32(1 / np.float32(127.5))
        np.testing.assert_array_equal(got, direct(torch.from_numpy(norm)).numpy())
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 1.4:
            assert np.argmax(got) == np.argmax(want)
