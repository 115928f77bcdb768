"""The port's ``tensor_crop`` against the JAX package's.

Each case runs the same frames and region tensors (numpy, from fixed
seeds) through both elements, each in its own pipeline (two ``datasrc``s
into ``crop.raw`` and ``crop.info``, a sink), and holds the port's output
frames bit for bit to the reference's: static and dynamic modes, the
empty-region sentinel, clamping, row-vector regions, float regions
truncated toward zero, and the negotiation errors.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from nnstreamer_tpu import Pipeline as JPipeline
from nnstreamer_tpu.elements.crop import TensorCrop as JCrop
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JDataSrc
from nnstreamer_tpu.graph.node import NegotiationError as JNegotiationError
from nnstreamer_tpu_torch import Pipeline
from nnstreamer_tpu_torch.elements.crop import TensorCrop
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.node import NegotiationError
from nnstreamer_tpu_torch.spec import TensorSpec


def _run(pkg, images, regions, **props):
    P, Src, Crop, Sink = pkg
    got = []
    p = P()
    raw = p.add(Src(name="raw_src", data=images, rate=Fraction(10)))
    info = p.add(Src(name="info_src", data=regions, rate=Fraction(10)))
    crop = p.add(Crop(name="c", **props))
    sink = p.add(Sink(name="out"))
    sink.connect("new-data", got.append)
    p.link(raw, "c.raw")
    p.link(info, "c.info")
    p.link(crop, sink)
    p.run(timeout=60)
    return got


JAX = (JPipeline, JDataSrc, JCrop, JSink)
PORT = (Pipeline, DataSrc, TensorCrop, TensorSink)


def _both(images, regions, **props):
    """Both packages' output frames, the port's checked against the
    reference's: the same count, tensors, pts and region counts."""
    want = _run(JAX, images, regions, **props)
    got = _run(PORT, [torch.from_numpy(x) for x in images],
               [torch.from_numpy(r) for r in regions], **props)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pts == w.pts and g.meta["tensor_crop"] == w.meta["tensor_crop"]
        assert len(g.tensors) == len(w.tensors)
        for a, b in zip(g.tensors, w.tensors):
            assert isinstance(a, torch.Tensor)
            b = np.asarray(b)
            assert a.dtype == torch.from_numpy(b).dtype and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), b)
    return got


def _img(h=8, w=8, dtype=np.uint8):
    return np.arange(h * w * 3).astype(dtype).reshape(h, w, 3)


def _rand(seed, h=12, w=10):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


class TestStatic:
    def test_stacks_constant_size(self):
        got = _both([_img()], [np.array([[1, 2, 3, 2], [4, 0, 3, 2]], np.int32)],
                    size="3:2", num=2)
        assert tuple(got[0].tensor(0).shape) == (2, 2, 3, 3)

    def test_pads_missing_regions(self):
        got = _both([_img()], [np.array([[0, 0, 9, 9]], np.int32)], size="4:4", num=3)
        assert not got[0].tensor(0)[1:].any()

    @pytest.mark.parametrize("region", [[7, 7, 4, 4], [-3, 9, 1, 1], [100, -100, 2, 2]])
    def test_clamps_out_of_range(self, region):
        _both([_img()], [np.array([region], np.int32)], size="4:4", num=1)

    def test_crop_larger_than_the_frame(self):
        _both([_img(4, 4)], [np.array([[1, 1, 2, 2]], np.int32)], size="6:5", num=1)

    def test_sentinel_rows_skipped(self):
        regions = np.array([[2, 2, 0, 0], [1, 1, 2, 2], [0, 0, -1, 3]], np.int32)
        got = _both([_img()], [regions], size="2:2", num=2)
        assert got[0].meta["tensor_crop"]["regions"] == 1

    def test_more_regions_than_slots(self):
        regions = np.random.default_rng(5).integers(-2, 12, (7, 4)).astype(np.int32)
        _both([_rand(4)], [regions], size="3:3", num=3)

    def test_float_regions_truncated(self):
        regions = np.array([[1.9, 2.7, 3.2, 2.99], [-0.6, 0.4, 0.9, 4.0]], np.float32)
        _both([_rand(6)], [regions], size="3:2", num=2)

    def test_several_frames_float_pixels(self):
        imgs = [np.random.default_rng(i).standard_normal((9, 11, 3)).astype(np.float32)
                for i in range(3)]
        regions = [np.random.default_rng(10 + i).integers(0, 9, (2, 4)).astype(np.int32)
                   for i in range(3)]
        _both(imgs, regions, size="4:3", num=2)


class TestDynamic:
    def test_variable_shapes(self):
        got = _both([_img()], [np.array([[0, 0, 2, 3], [3, 3, 4, 2]], np.int32)])
        assert [tuple(t.shape) for t in got[0].tensors] == [(3, 2, 3), (2, 4, 3)]

    def test_clips_and_drops_empty(self):
        got = _both([_img()], [np.array([[6, 6, 5, 5], [9, 9, 2, 2]], np.int32)])
        assert len(got[0].tensors) == 1

    def test_row_vector_region(self):
        _both([_img()], [np.array([1, 1, 2, 2], np.int32)])

    def test_all_empty_round_dropped(self):
        got = _both([_img(), _img()], [np.array([[0, 0, 0, 0]], np.int32),
                                       np.array([[1, 1, 2, 2]], np.int32)])
        assert len(got) == 1

    def test_num_limits_the_crops(self):
        regions = np.random.default_rng(7).integers(0, 6, (5, 4)).astype(np.int32) + [0, 0, 1, 1]
        _both([_rand(8)], [regions.astype(np.int32)], num=2)

    def test_crop_of_a_bfloat16_region_tensor(self):
        """A bfloat16 region tensor (the reference's ml_dtypes bfloat16)
        truncates as its float32 values do."""
        import ml_dtypes

        regions = np.array([[1.5, 2.75, 3.25, 2.5]], np.float32)
        want = _run(JAX, [_img()], [regions.astype(ml_dtypes.bfloat16)])
        got = _run(PORT, [torch.from_numpy(_img())],
                   [torch.from_numpy(regions).to(torch.bfloat16)])
        np.testing.assert_array_equal(got[0].tensor(0).numpy(), np.asarray(want[0].tensor(0)))


class TestNegotiation:
    def test_bad_raw_rank(self):
        with pytest.raises(JNegotiationError):
            _run(JAX, [np.zeros((4, 4), np.uint8)], [np.array([[0, 0, 2, 2]], np.int32)])
        with pytest.raises(NegotiationError):
            _run(PORT, [torch.zeros((4, 4), dtype=torch.uint8)],
                 [torch.tensor([[0, 0, 2, 2]], dtype=torch.int32)])

    def test_bad_region_width(self):
        for pkg, regions, err in ((JAX, np.zeros((2, 3), np.int32), JNegotiationError),
                                  (PORT, torch.zeros((2, 3), dtype=torch.int32),
                                   NegotiationError)):
            img = _img() if pkg is JAX else torch.from_numpy(_img())
            with pytest.raises(err):
                _run(pkg, [img], [regions])

    @pytest.mark.parametrize("props", [dict(size="3x2", num=1), dict(size="3:2"),
                                       dict(size="0:2", num=1), dict(num=-1)])
    def test_bad_props(self, props):
        with pytest.raises(ValueError):
            JCrop(**props)
        with pytest.raises(ValueError):
            TensorCrop(**props)

    def test_static_spec(self):
        specs = []
        for P, Src, Crop, Sink in (JAX, PORT):
            p = P()
            raw = p.add(Src(data=[_img()], rate=Fraction(10)))
            info = p.add(Src(data=[np.array([[0, 0, 4, 4]], np.int32)], rate=Fraction(10)))
            crop = p.add(Crop(name="c", size="4:4", num=2))
            sink = p.add(Sink(name="out"))
            p.link(raw, "c.raw")
            p.link(info, "c.info")
            p.link(crop, sink)
            p.negotiate()
            specs.append(crop.src_pads["src"].spec.tensors[0])
        assert specs[1] == TensorSpec(np.uint8, (2, 4, 4, 3))
        assert str(specs[1]) == str(specs[0])

    def test_from_a_launch_string(self):
        """``tensor_crop`` by name, pads named in the string."""
        import nnstreamer_tpu_torch as nns

        p = nns.parse_launch("tensor_crop name=c size=2:2 num=1 ! tensor_sink name=out "
                             "collect=true datasrc name=r ! c.raw datasrc name=i ! c.info")
        p["r"].data = [torch.from_numpy(_img())]
        p["i"].data = [torch.tensor([[1, 1, 2, 2]], dtype=torch.int32)]
        p.run(timeout=60)
        np.testing.assert_array_equal(p["out"].frames[0].tensor(0)[0].numpy(), _img()[1:3, 1:3])
