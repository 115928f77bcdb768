"""The port's NMS (``nnstreamer_tpu_torch/ops/nms.py``) against the JAX package's.

The port's plain ``nms_keep`` and its kernel wrapper ``pallas_nms_keep``
on CPU tensors must give keep masks bitwise equal to the JAX package's
``pallas_nms_keep`` (Pallas, interpret mode) and ``nms_keep`` on the same
score-ordered integer boxes, and the port's host ``nms()`` must keep the
same boxes as the JAX package's.  Tests marked ``cuda`` hold the CUDA
kernel against the plain version on the card and skip here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.decoders import bounding_boxes as jbb
from nnstreamer_tpu.ops import nms as jnms
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb
from nnstreamer_tpu_torch.ops import nms as tnms
from nnstreamer_tpu_torch.ops.kernels import KERNELS


def _random_boxes(rng, k, span=60):
    x = rng.integers(0, span, k).astype(np.float32)
    y = rng.integers(0, span, k).astype(np.float32)
    w = rng.integers(1, span // 2, k).astype(np.float32)
    h = rng.integers(1, span // 2, k).astype(np.float32)
    probs = 0.5 + 0.5 * rng.random(k).astype(np.float32)
    order = np.argsort(-probs, kind="stable")
    return tuple(a[order] for a in (x, y, w, h, probs))


def _cases(k):
    """(name, x, y, w, h, valid) score-ordered cases at K = k."""
    rng = np.random.default_rng(k)
    x, y, w, h, probs = _random_boxes(rng, k)
    ones = np.ones(k, np.float32)
    same = (np.full(k, 10, np.float32), np.full(k, 12, np.float32),
            np.full(k, 20, np.float32), np.full(k, 30, np.float32))
    zero_w = w.copy()
    zero_w[::2] = 0
    return [
        ("random", x, y, w, h, probs >= 0.6),
        ("all-invalid", x, y, w, h, np.zeros(k, bool)),
        ("identical", *same, np.ones(k, bool)),
        ("zero-area", x, y, zero_w, h, np.ones(k, bool)),
        ("unit", x, y, ones, ones, np.ones(k, bool)),
    ]


def _port(fn, x, y, w, h, valid):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, w, h, valid))).numpy()


@pytest.mark.parametrize("k", [1, 7, 100, 128, 129, 300])
def test_keep_mask_bitwise_against_jax(k):
    for name, x, y, w, h, valid in _cases(k):
        jargs = tuple(jnp.asarray(a) for a in (x, y, w, h, valid))
        want = np.asarray(jnms.pallas_nms_keep(*jargs, interpret=True))
        np.testing.assert_array_equal(np.asarray(jnms.nms_keep(*jargs)), want, err_msg=name)
        np.testing.assert_array_equal(_port(tnms.nms_keep, x, y, w, h, valid), want,
                                      err_msg=name)
        np.testing.assert_array_equal(_port(tnms.pallas_nms_keep, x, y, w, h, valid), want,
                                      err_msg=name)
        assert want.dtype == np.bool_


def test_suppression_matrix_bitwise_against_jax():
    x, y, w, h, _ = _random_boxes(np.random.default_rng(0), 64)
    want = np.asarray(jnms.suppression_matrix(*(jnp.asarray(a) for a in (x, y, w, h))))
    got = tnms.suppression_matrix(*(torch.from_numpy(a) for a in (x, y, w, h))).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_areas_above_2_24_follow_float32_rounding():
    """Boxes whose pixel areas pass 2**24: float32 rounding decides the
    verdicts, and the port's op order must round as the JAX package's."""
    rng = np.random.default_rng(3)
    k = 64
    x = rng.integers(0, 2000, k).astype(np.float32)
    y = rng.integers(0, 2000, k).astype(np.float32)
    w = rng.integers(4000, 9000, k).astype(np.float32)
    h = rng.integers(4000, 9000, k).astype(np.float32)
    assert (w.astype(np.float64) * h > 2 ** 24).all()
    valid = np.ones(k, bool)
    want = np.asarray(jnms.nms_keep(*(jnp.asarray(a) for a in (x, y, w, h, valid))))
    np.testing.assert_array_equal(_port(tnms.nms_keep, x, y, w, h, valid), want)
    np.testing.assert_array_equal(_port(tnms.pallas_nms_keep, x, y, w, h, valid), want)


def test_invalid_rows_never_survive_nor_suppress():
    args = [torch.tensor([10.0, 10.0]), torch.tensor([10.0, 10.0]),
            torch.tensor([20.0, 20.0]), torch.tensor([20.0, 20.0])]
    assert tnms.nms_keep(*args, torch.tensor([True, True])).tolist() == [True, False]
    assert tnms.nms_keep(*args, torch.tensor([False, True])).tolist() == [False, True]


@pytest.mark.parametrize("seed", range(8))
def test_host_nms_matches_jax(seed):
    """The port's host nms() keeps the JAX package's boxes, in order, and
    its device nms_keep keeps the same (areas here are far below 2**24)."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(5, 80))
    x, y, w, h, probs = _random_boxes(rng, k)

    def objs(mod):
        return [mod.DetectedObject(int(i % 3), int(x[i]), int(y[i]), int(w[i]), int(h[i]),
                                   float(probs[i])) for i in range(k)]

    def key(o):
        return (o.class_id, o.x, o.y, o.width, o.height, o.prob)

    want = [key(o) for o in jbb.nms(objs(jbb), pre_top_k=None)]
    assert [key(o) for o in tbb.nms(objs(tbb), pre_top_k=None)] == want
    assert [key(o) for o in tbb.nms(objs(tbb))] == [key(o) for o in jbb.nms(objs(jbb))]
    keep = _port(tnms.nms_keep, x, y, w, h, np.ones(k, bool))
    assert [key(o) for o, kp in zip(objs(tbb), keep) if kp] == want
    for a, b in zip(objs(tbb)[:10], objs(tbb)[10:20]):
        assert tbb.iou(a, b) == jbb.iou(jbb.DetectedObject(**vars(a)),
                                        jbb.DetectedObject(**vars(b)))


def test_host_nms_caps_candidates_like_jax():
    rng = np.random.default_rng(11)
    x, y, w, h, probs = _random_boxes(rng, 250, span=400)
    got = tbb.nms([tbb.DetectedObject(1, int(a), int(b), int(c), int(d), float(p))
                   for a, b, c, d, p in zip(x, y, w, h, probs)])
    want = jbb.nms([jbb.DetectedObject(1, int(a), int(b), int(c), int(d), float(p))
                    for a, b, c, d, p in zip(x, y, w, h, probs)])
    assert [vars(o) for o in got] == [vars(o) for o in want]
    assert len(want) <= tbb.PRE_NMS_TOP_K


def test_the_kernel_wrapper_is_counted():
    assert tnms.pallas_nms_keep in KERNELS


def test_wrapper_checks_operands():
    good = [torch.zeros(4), torch.zeros(4), torch.full((4,), 10.0), torch.full((4,), 10.0),
            torch.ones(4, dtype=torch.bool)]
    assert tnms.pallas_nms_keep(*good).tolist() == [True, False, False, False]
    with pytest.raises(TypeError):
        tnms.pallas_nms_keep(*good[:4], torch.ones(4))
    with pytest.raises(TypeError):
        tnms.pallas_nms_keep(good[0].double(), *good[1:])
    with pytest.raises(ValueError, match="1-D"):
        tnms.pallas_nms_keep(torch.zeros(5), *good[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tnms.pallas_nms_keep(torch.zeros(8)[::2], *good[1:])
    with pytest.raises(TypeError):
        tnms.pallas_nms_keep(np.zeros(4, np.float32), *good[1:])


def test_non_cpu_tensor_never_takes_plain_path(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called")

    monkeypatch.setattr(tnms, "nms_keep", boom)
    args = [torch.zeros(4, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="unsupported device"):
        tnms.pallas_nms_keep(*args, torch.ones(4, dtype=torch.bool, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 100, 128, 129, 1000, 4096])
def test_cuda_kernel_matches_plain(cuda_device, k):
    for name, *arrays in _cases(k):
        dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in arrays]
        before = tnms.pallas_nms_keep.launches
        got = tnms.pallas_nms_keep(*dev)
        assert tnms.pallas_nms_keep.launches == before + 1
        assert torch.equal(got, tnms.nms_keep(*dev)), name


@pytest.mark.cuda
def test_cuda_kernel_raises_above_its_limit(cuda_device):
    k = tnms.MAX_K + 1
    args = [torch.zeros(k, device=cuda_device) for _ in range(4)]
    with pytest.raises(ValueError, match="at most"):
        tnms.pallas_nms_keep(*args, torch.ones(k, dtype=torch.bool, device=cuda_device))
