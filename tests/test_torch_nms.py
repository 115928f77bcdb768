"""The port's NMS (``nnstreamer_tpu_torch/ops/nms.py``) against the JAX package's.

The port's plain ``nms_keep`` and its kernel wrapper ``pallas_nms_keep``
on CPU tensors must give keep masks bitwise equal to the JAX package's
``pallas_nms_keep`` (Pallas, interpret mode) and ``nms_keep`` on the same
score-ordered integer boxes, and the port's host ``nms()`` must keep the
same boxes as the JAX package's.  Tests marked ``cuda`` hold the CUDA
kernel against the plain version on the card and skip here.  The CUDA
kernel's design (packed suppression bits, then a walk in 32-row chunks by
one warp) is modelled by ``suppression_bits`` / ``bit_walk_keep``, held
here bitwise against the plain version and the Pallas kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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


def _special_boxes(k, seed, nan_rows, zero_rows, big_rows):
    """Score-ordered integer boxes at K = k with some NaN, zero-area and
    >2**24-area rows mixed in, and about 20% invalid rows."""
    rng = np.random.default_rng(seed)
    x, y, w, h, _ = _random_boxes(rng, k)
    big = rng.random(k) < big_rows
    x[big] = rng.integers(0, 3000, big.sum())
    y[big] = rng.integers(0, 3000, big.sum())
    w[big] = rng.integers(4100, 9000, big.sum())
    h[big] = rng.integers(4100, 9000, big.sum())
    zero = rng.random(k) < zero_rows
    (w if seed % 2 else h)[zero] = 0
    nan = rng.random(k) < nan_rows
    cols = rng.integers(0, 4, k)
    for c, a in enumerate((x, y, w, h)):
        a[nan & (cols == c)] = np.nan
    return x, y, w, h, rng.random(k) < 0.8


_FRACTIONS = st.sampled_from([0.0, 0.05, 0.3])
_BOX_CASES = dict(k=st.integers(1, 300), seed=st.integers(0, 2 ** 31),
                  nan_rows=_FRACTIONS, zero_rows=_FRACTIONS, big_rows=_FRACTIONS)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(**_BOX_CASES)
def test_bit_walk_model_bitwise_against_plain(k, seed, nan_rows, zero_rows, big_rows):
    """The kernel's packed bits and chunked one-warp walk keep exactly the
    rows the plain greedy pass keeps, NaN and >2**24 areas included."""
    arrays = _special_boxes(k, seed, nan_rows, zero_rows, big_rows)
    x, y, w, h, valid = (torch.from_numpy(a) for a in arrays)
    bits = tnms.suppression_bits(x, y, w, h)
    assert bits.shape == (k, -(-k // 32)) and bits.dtype == np.uint32
    np.testing.assert_array_equal(tnms.bit_walk_keep(bits, valid),
                                  tnms.nms_keep(x, y, w, h, valid).numpy())


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(**_BOX_CASES)
def test_bit_walk_model_bitwise_against_pallas(k, seed, nan_rows, zero_rows, big_rows):
    arrays = _special_boxes(k, seed, nan_rows, zero_rows, big_rows)
    want = np.asarray(jnms.pallas_nms_keep(*(jnp.asarray(a) for a in arrays), interpret=True))
    x, y, w, h, valid = (torch.from_numpy(a) for a in arrays)
    got = tnms.bit_walk_keep(tnms.suppression_bits(x, y, w, h), valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port(tnms.pallas_nms_keep, *arrays), want)


def test_suppression_bits_layout():
    """Word c of row i holds columns 32c..32c+31, bit b for column 32c+b,
    set only above the diagonal; nothing past K."""
    x, y, w, h, _ = _random_boxes(np.random.default_rng(5), 70)
    args = [torch.from_numpy(a) for a in (x, y, w, h)]
    bits = tnms.suppression_bits(*args)
    sup = tnms.suppression_matrix(*args).numpy()
    unpacked = ((bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(70, -1)
    assert not unpacked[:, 70:].any()
    np.testing.assert_array_equal(unpacked[:, :70].astype(bool), np.triu(sup, 1))
    assert np.triu(sup, 1).any()


@pytest.mark.parametrize("k", [1, 6, 7, 8, 31, 32, 33, 100, 255, 1000, 1279, 1280])
def test_bit_tasks_cover_the_diagonal_and_above_once(k):
    """The first phase's tasks: every (column byte, row) with a column of
    the byte above the row exactly once, and nothing else; consecutive
    tasks are consecutive rows of one column byte, except where a column
    byte ends."""
    cb, row = tnms.bit_tasks(k)
    nb = 4 * -(-k // 32)
    want = {(c, i) for c in range(nb) for i in range(k) if 8 * c + 7 > i}
    got = list(zip(cb.tolist(), row.tolist()))
    assert len(got) == len(set(got)) and set(got) == want
    steps = (np.diff(row) == 1) & (np.diff(cb) == 0)
    assert steps.sum() == len(got) - 1 - (np.diff(cb) != 0).sum()


def test_bit_branch_limit_follows_the_shared_memory_layout():
    """BITS_MAX_K is the largest K whose bit layout fits the 227 KB a block
    may use, and the CUDA source names the same limits."""
    k = tnms.BITS_MAX_K
    assert k == 1280
    assert tnms.bits_smem_bytes(k) <= tnms.SMEM_LIMIT < tnms.bits_smem_bytes(k + 1)
    assert tnms.bits_smem_bytes(100) == 16 * 100 + 4 * 100 + 4 * (100 * 4 + 32) + 4 * 4
    src = (Path(tnms.__file__).resolve().parent.parent / "csrc" / "nms_keep.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBitsMaxK"]) == tnms.BITS_MAX_K
    assert int(consts["kMaxK"]) == tnms.MAX_K
    assert int(consts["kSmemLimit"]) == tnms.SMEM_LIMIT


def test_wrapper_accepts_views_with_a_storage_offset():
    """A contiguous view that starts one element into its storage is
    element-aligned, and the kernel reads element by element: accepted."""
    x, y, w, h, probs = _random_boxes(np.random.default_rng(9), 40)
    valid = probs >= 0.6
    views = []
    for a in (x, y, w, h, valid):
        t = torch.zeros(41, dtype=torch.from_numpy(a).dtype)
        t[1:] = torch.from_numpy(a)
        views.append(t[1:])
    assert views[0].storage_offset() == 1 and views[4].storage_offset() == 1
    np.testing.assert_array_equal(tnms.pallas_nms_keep(*views).numpy(),
                                  _port(tnms.nms_keep, x, y, w, h, valid))


def test_wrapper_refuses_a_view_not_aligned_to_its_element():
    """A float32 tensor can start at an odd address (a buffer imported at a
    byte offset); the kernel's float loads need element alignment."""
    good = [torch.zeros(4), torch.zeros(4), torch.full((4,), 10.0), torch.full((4,), 10.0),
            torch.ones(4, dtype=torch.bool)]
    odd = torch.frombuffer(bytearray(17), dtype=torch.float32, offset=1, count=4)
    assert odd.data_ptr() % 4 != 0 and odd.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        tnms.pallas_nms_keep(odd, *good[1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 100, 128, 129, 1000, 1280, 1281, 4096, 8192])
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
