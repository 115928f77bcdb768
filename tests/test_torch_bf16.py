"""bfloat16 streams through the port's ``tensor_transform``, against the
JAX package's, in all three accelerations.

``pallas`` (the ``fused_arith`` kernel, its plain version on the CPU) and
``true`` (the plain chain) round every bfloat16 step as XLA does; ``false``
is the JAX element's numpy rule on ``ml_dtypes``' bfloat16, which the port
runs without ``ml_dtypes``: float32 values, and a cast to bfloat16 that
rounds to nearest even.  Each case runs one pipeline per package on the same
bits, and the outputs must agree bit for bit (any NaN equals any NaN), with
the same negotiated dtype.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.testsrc import DataSrc as JaxDataSrc
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.ops import kernels as K

J_BF16 = np.dtype(ml_dtypes.bfloat16)
ACCELS = ["pallas", True, False]


def _bf16_frame(seed, shape=(6, 10, 3)):
    v = (np.random.default_rng(seed).standard_normal(shape) * 200).astype(np.float32)
    v.flat[:8] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, 3e38, -7.0]
    return K.bf16_bits(v)


def _run(nns, src_cls, frame, **props):
    p = nns.Pipeline()
    src = p.add(src_cls(data=[frame]))
    tr = p.add(nns.make("tensor_transform", **props))
    sink = p.add(nns.make("tensor_sink", collect=True))
    p.link_chain(src, tr, sink)
    p.run(timeout=60)
    return sink.frames[0].tensors[0], tr.src_pads["src"].spec.tensors[0].dtype.name


def _values(a) -> np.ndarray:
    """float32 values of a bfloat16 output (torch or ml_dtypes), else the
    array itself."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return K.bf16_value(a.view(torch.int16).numpy().view(np.uint16))
        return a.numpy()
    a = np.asarray(a)
    return K.bf16_value(a.view(np.uint16)) if a.dtype == J_BF16 else a


def _check(bits_or_array, accel, exact=True, **props):
    """Both packages on the same input; ``bits_or_array`` is uint16 bits
    (a bfloat16 stream) or a numpy array of another dtype.  ``exact=False``:
    within 1e-5 (stand's mean and std, reductions summed in another order,
    as ``tests/test_torch_transform.py`` compares them)."""
    x = np.asarray(bits_or_array)
    if x.dtype == np.uint16:
        jx, tx = x.view(J_BF16), torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        jx, tx = x, torch.from_numpy(x)
    want, want_dt = _run(jnns, JaxDataSrc, jx, acceleration=accel, **props)
    got, got_dt = _run(tnns, DataSrc, tx, acceleration=accel, device="cpu", **props)
    assert got_dt == want_dt
    g, w = _values(got), _values(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    if not exact:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        return got_dt
    nan = np.isnan(w) if w.dtype.kind == "f" else np.zeros(w.shape, bool)
    np.testing.assert_array_equal(np.isnan(g) if g.dtype.kind == "f" else nan, nan)
    np.testing.assert_array_equal(g[~nan].view(np.uint8), w[~nan].view(np.uint8))
    return got_dt


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("option", [
    "add:0.1,mul:3.3,sub:7",
    "div:7",
    "typecast:float32,add:-127.5,div:127.5",
    "mul:2,add:1",
    "typecast:int16,add:3",
    "typecast:uint8",
    "typecast:float16,mul:0.25",
    "add:100000,typecast:int32",
])
def test_bf16_stream_arithmetic(option, accel):
    _check(_bf16_frame(1), accel, mode="arithmetic", option=option)


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("dtype,option", [
    (np.uint8, "typecast:bfloat16,add:-127.5,div:127.5"),
    (np.uint8, "typecast:float32,add:-127.5,div:127.5,typecast:bfloat16"),
    (np.int16, "typecast:bfloat16,mul:0.5"),
    (np.int32, "typecast:bfloat16"),
    (np.float32, "typecast:bfloat16,add:1,div:3"),
    (np.float32, "add:1.5,typecast:bfloat16,mul:3"),
])
def test_into_bf16(dtype, option, accel):
    rng = np.random.default_rng(2)
    if np.dtype(dtype).kind == "f":
        x = (rng.standard_normal((5, 7, 3)) * 1000).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(max(info.min, -2 ** 31), info.max, (5, 7, 3), endpoint=True).astype(dtype)
    if dtype == np.int32:  # two roundings through float32: 2**24 + 2**16 + 1 -> 2**24
        x.flat[:3] = [2 ** 24 + 2 ** 16 + 1, 2 ** 31 - 1, 2 ** 25 + 2 ** 17 + 1]
    assert _check(x, accel, mode="arithmetic", option=option) == "bfloat16"


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("mode,option", [("typecast", "float32"), ("typecast", "int8"),
                                         ("typecast", "uint32"), ("clamp", "-1.5:2"),
                                         ("clamp", "-1:0"), ("clamp", "-0.0:100")])
def test_bf16_elementwise_modes(mode, option, accel):
    _check(_bf16_frame(3), accel, mode=mode, option=option)


@pytest.mark.parametrize("accel", [True, False])
@pytest.mark.parametrize("mode,option", [("transpose", "1:0:2:3"), ("dimchg", "0:2"),
                                         ("stand", "default"), ("stand", "default:per-channel")])
def test_bf16_layout_modes(mode, option, accel):
    v = (np.random.default_rng(4).standard_normal((6, 10, 3)) * 50).astype(np.float32)
    _check(K.bf16_bits(v), accel, exact=not (mode == "stand" and accel), mode=mode,
           option=option)


def test_host_rule_is_float32_rounded_once():
    """The claim the host rule stands on, held against ``ml_dtypes``: on a
    bfloat16 array an op with a Python literal gives float32 (computed on
    the float32 values, the literal a float32), and a cast to bfloat16
    rounds the float32 to nearest even, an int or a double going through
    float32 first."""
    v = K.bf16_value(_bf16_frame(5))
    b = v.astype(J_BF16)
    for lit in (2, 0.1, 300, -3.5):
        for f in (np.add, np.subtract, np.multiply, np.divide):
            with np.errstate(all="ignore"):
                got, want = f(v, lit), f(b, lit)
            assert want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    w = np.random.default_rng(6).standard_normal(4096) * 1e3
    np.testing.assert_array_equal(K.bf16_round(w.astype(np.float32)),
                                  w.astype(J_BF16).astype(np.float32))
    i = np.array([2 ** 24 + 2 ** 16 + 1, 2 ** 31 - 1, -(2 ** 25 + 2 ** 17 + 1)], np.int32)
    np.testing.assert_array_equal(K.bf16_round(i.astype(np.float32)),
                                  i.astype(J_BF16).astype(np.float32))


def test_bf16_normalize_folds_into_the_filter():
    """The normalize to bfloat16, folded into a filter (``pallas``): the
    filter's function gives the unfused transform's bits."""
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel

    frames = [np.random.default_rng(i).integers(0, 256, (4, 4, 3)).astype(np.uint8)
              for i in range(3)]
    outs = []
    for fuse in (True, False):
        p = tnns.parse_launch(
            "datasrc name=s ! tensor_transform mode=arithmetic "
            "option=typecast:bfloat16,add:-127.5,div:127.5 acceleration=pallas device=cpu ! "
            "tensor_filter framework=torch name=f ! tensor_sink name=out collect=true")
        p.auto_fuse = fuse
        p["s"].data = [torch.from_numpy(f) for f in frames]
        p["f"].model = TorchModel(apply=lambda params, x: x * 2, device="cpu")
        p.run(timeout=60)
        outs.append([f.tensor(0) for f in p["out"].frames])
        assert any(type(n).__name__ == "TensorTransform" for n in p.nodes.values()) != fuse
    for a, b in zip(*outs):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
