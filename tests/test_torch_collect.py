"""The port's multi-input core against the JAX package's: request pads,
``tensor_mux`` in every sync mode, ``tensor_merge``, ``tensor_demux``,
``tensor_split`` and ``tee``.

Each case builds the same graph in both packages from one function, feeds
it the same numpy frames (torch tensors on the CPU in the port) and holds
every sink's frames to the reference's: the count, each frame's pts and
duration, and its tensors bit for bit.  The cases mirror the reference's
``tests/test_elements.py`` (mux, merge, demux, split).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements import (demux as jdemux, merge as jmerge, mux as jmux,
                                     sink as jsink, split as jsplit, tee as jtee,
                                     testsrc as jsrc)
from nnstreamer_tpu_torch.buffer import SECOND, Frame as TFrame
from nnstreamer_tpu_torch.elements import (demux as tdemux, merge as tmerge, mux as tmux,
                                           sink as tsink, split as tsplit, tee as ttee,
                                           testsrc as tsrc)

DUR = SECOND // 30

JAX = SimpleNamespace(Pipeline=jnns.Pipeline, DataSrc=jsrc.DataSrc, Sink=jsink.TensorSink,
                      Mux=jmux.TensorMux, Merge=jmerge.TensorMerge, Demux=jdemux.TensorDemux,
                      Split=jsplit.TensorSplit, Tee=jtee.Tee, NegotiationError=jnns.NegotiationError,
                      frame=lambda *a, **k: JFrame.of(*a, **k))
PORT = SimpleNamespace(Pipeline=tnns.Pipeline, DataSrc=tsrc.DataSrc, Sink=tsink.TensorSink,
                       Mux=tmux.TensorMux, Merge=tmerge.TensorMerge, Demux=tdemux.TensorDemux,
                       Split=tsplit.TensorSplit, Tee=ttee.Tee,
                       NegotiationError=tnns.NegotiationError,
                       frame=lambda *a, **k: TFrame.of(*(torch.from_numpy(np.array(x))
                                                         for x in a), **k))


def _host(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _run(pkg, build):
    p, sinks = build(pkg)
    p.run(timeout=20)
    return {name: [(f.pts, f.duration, [_host(t) for t in f.tensors]) for f in s.frames]
            for name, s in sinks.items()}


def _check(build):
    got, want = _run(PORT, build), _run(JAX, build)
    assert got.keys() == want.keys()
    for name in want:
        assert len(got[name]) == len(want[name]) > 0, name
        for (gp, gd, gt), (wp, wd, wt) in zip(got[name], want[name]):
            assert (gp, gd) == (wp, wd)
            assert len(gt) == len(wt)
            for g, w in zip(gt, wt):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    return got


def _streams(*streams):
    """A graph of one DataSrc per stream into a collect element, then a sink."""
    def build(pkg, element):
        p = pkg.Pipeline()
        node = p.add(element(pkg))
        for i, frames in enumerate(streams):
            src = p.add(pkg.DataSrc(name=f"s{i}", data=[pkg.frame(*f[0], **f[1]) for f in frames]))
            p.link(src, f"{node.name}.sink_{i}")
        sink = p.add(pkg.Sink(name="out", collect=True))
        p.link(node, sink)
        return p, {"out": sink}
    return build


def _ts(arrays, dur=DUR, step=1):
    return [((a,), dict(pts=i * step * dur, duration=step * dur)) for i, a in enumerate(arrays)]


class TestMux:
    def test_nosync_pairs(self):
        a = _ts([np.full((2,), i, np.int32) for i in range(3)])
        b = _ts([np.full((3,), 10 + i, np.int32) for i in range(3)])
        build = _streams(a, b)
        got = _check(lambda pkg: build(pkg, lambda k: k.Mux(sync_mode="nosync")))
        assert len(got["out"]) == 3 and len(got["out"][0][2]) == 2

    def test_slowest_waits_for_laggard(self):
        a = _ts([np.full((1,), i, np.int32) for i in range(6)])
        b = _ts([np.full((1,), 100 + i, np.int32) for i in range(3)], step=2)
        build = _streams(a, b)
        got = _check(lambda pkg: build(pkg, lambda k: k.Mux(sync_mode="slowest")))
        assert 3 <= len(got["out"]) <= 4

    def test_basepad_follows_base_timestamps(self):
        a = _ts([np.full((1,), i, np.int32) for i in range(3)])
        b = _ts([np.full((1,), 100 + i, np.int32) for i in range(3)])
        build = _streams(a, b)
        got = _check(lambda pkg: build(pkg, lambda k: k.Mux(sync_mode="basepad",
                                                             sync_option="0")))
        assert [int(f[2][0][0]) for f in got["out"]] == [0, 1, 2]

    def test_basepad_tolerance_keeps_pad_count_stable(self):
        a = _ts([np.full((1,), i, np.int32) for i in range(3)])
        b = [((np.full((1,), 100, np.int32),), dict(pts=0, duration=DUR)),
             ((np.full((1,), 101, np.int32),), dict(pts=50 * DUR, duration=DUR))]
        build = _streams(a, b)
        got = _check(lambda pkg: build(pkg, lambda k: k.Mux(sync_mode="basepad",
                                                             sync_option=f"0:{DUR}")))
        assert all(len(f[2]) == 2 for f in got["out"])
        assert int(got["out"][1][2][1][0]) == 100

    def test_three_pads_in_pad_order_with_mixed_specs(self):
        rng = np.random.default_rng(0)
        a = _ts([rng.standard_normal((2,)).astype(np.float32) for _ in range(4)])
        b = _ts([rng.integers(0, 255, (4, 4)).astype(np.uint8) for _ in range(4)])
        c = _ts([rng.integers(-9, 9, (3,)).astype(np.int16) for _ in range(4)])
        build = _streams(a, b, c)
        _check(lambda pkg: build(pkg, lambda k: k.Mux(sync_mode="nosync")))

    def test_eos_of_one_pad_ends_the_stream(self):
        a = _ts([np.full((1,), i, np.int32) for i in range(5)])
        b = _ts([np.full((1,), 10 + i, np.int32) for i in range(2)])
        build = _streams(a, b)
        got = _check(lambda pkg: build(pkg, lambda k: k.Mux(sync_mode="nosync")))
        assert len(got["out"]) == 2

    def test_spec_concatenation(self):
        def build(pkg):
            p = pkg.Pipeline()
            mux = p.add(pkg.Mux(sync_mode="nosync"))
            for i, a in enumerate([np.zeros((2,), np.float32), np.zeros((4, 4), np.uint8)]):
                p.link(p.add(pkg.DataSrc(name=f"s{i}", data=[pkg.frame(a)])), f"{mux.name}.sink_{i}")
            sink = p.add(pkg.Sink(name="out", collect=True))
            p.link(mux, sink)
            return p, sink

        for pkg in (PORT, JAX):
            p, sink = build(pkg)
            p.run(timeout=10)
            spec = sink.sink_pads["sink"].spec
            assert spec.num_tensors == 2 and spec.tensors[0].dtype == np.float32
            assert spec.tensors[1].shape == (4, 4)

    def test_mux_hands_on_the_tensors_it_collected(self):
        """No copy: the muxed frame holds the very tensors the pads gave."""
        x = torch.arange(4, dtype=torch.float32)
        p = tnns.Pipeline()
        mux = p.add(tmux.TensorMux(sync_mode="nosync"))
        p.link(p.add(tsrc.DataSrc(name="s0", data=[TFrame.of(x)])), f"{mux.name}.sink_0")
        sink = p.add(tsink.TensorSink(collect=True))
        p.link(mux, sink)
        p.run(timeout=10)
        assert sink.frames[0].tensor(0) is x


class TestMerge:
    @pytest.mark.parametrize("option,shapes", [("0", [(4, 2), (4, 3)]), ("1", [(2, 4), (3, 4)]),
                                               ("2", [(1, 2, 3), (2, 2, 3)])])
    def test_linear_concat(self, option, shapes):
        rng = np.random.default_rng(int(option))
        arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        build = _streams(*[_ts([a]) for a in arrays])
        _check(lambda pkg: build(pkg, lambda k: k.Merge(mode="linear", option=option,
                                                        sync_mode="nosync")))

    def test_slowest_merge_of_two_rates(self):
        a = _ts([np.full((2, 1), i, np.float32) for i in range(6)])
        b = _ts([np.full((2, 2), 100 + i, np.float32) for i in range(3)], step=2)
        build = _streams(a, b)
        _check(lambda pkg: build(pkg, lambda k: k.Merge(option="0", sync_mode="slowest")))

    @pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
    def test_rank_mismatch_fails(self, pkg):
        p = pkg.Pipeline()
        merge = p.add(pkg.Merge(option="0", sync_mode="nosync"))
        for i, shape in enumerate([(2, 2), (2, 2, 2)]):
            src = p.add(pkg.DataSrc(name=f"m{i}", data=[pkg.frame(np.zeros(shape, np.float32))]))
            p.link(src, f"{merge.name}.sink_{i}")
        p.link(merge, p.add(pkg.Sink()))
        with pytest.raises(pkg.NegotiationError):
            p.start()
        p.stop()


def _fan_out(element, frames, n_out):
    def build(pkg):
        p = pkg.Pipeline()
        src = p.add(pkg.DataSrc(data=[pkg.frame(*f[0], **f[1]) for f in frames]))
        node = p.add(element(pkg))
        p.link(src, node)
        sinks = {}
        for i in range(n_out):
            sinks[f"o{i}"] = p.add(pkg.Sink(name=f"o{i}", collect=True))
            p.link(f"{node.name}.src_{i}", sinks[f"o{i}"])
        return p, sinks
    return build


class TestDemux:
    def test_split_tensors_to_pads(self):
        rng = np.random.default_rng(1)
        frames = [(tuple(rng.standard_normal((i + 1,)).astype(np.float32) for i in range(3)),
                   dict(pts=k * DUR, duration=DUR)) for k in range(3)]
        _check(_fan_out(lambda k: k.Demux(), frames, 3))

    def test_tensorpick(self):
        rng = np.random.default_rng(2)
        frames = [(tuple(rng.standard_normal((3,)).astype(np.float32) for _ in range(3)), {})]
        got = _check(_fan_out(lambda k: k.Demux(tensorpick="2,0"), frames, 2))
        np.testing.assert_array_equal(got["o0"][0][2][0], frames[0][0][2])


class TestSplit:
    @pytest.mark.parametrize("seg,pick,n", [("3:4:1,3:4:3", "", 2), ("1:4:4,2:4:4", "", 2),
                                            ("3:4:1,3:4:1,3:4:2", "2,0", 2)])
    def test_tensorseg(self, seg, pick, n):
        x = np.random.default_rng(3).integers(0, 255, (4, 4, 3)).astype(np.uint8)
        _check(_fan_out(lambda k: k.Split(tensorseg=seg, tensorpick=pick),
                        [((x,), dict(pts=0, duration=DUR))], n))


class TestTee:
    def test_every_branch_gets_the_frame(self):
        frames = _ts([np.full((2,), i, np.int16) for i in range(4)])
        got = _check(_fan_out(lambda k: k.Tee(), frames, 3))
        assert len(got["o2"]) == 4

    def test_no_copy(self):
        x = torch.ones(3)
        p = tnns.Pipeline()
        src = p.add(tsrc.DataSrc(data=[TFrame.of(x)]))
        tee = p.add(ttee.Tee())
        p.link(src, tee)
        sinks = [p.add(tsink.TensorSink(name=f"b{i}", collect=True)) for i in range(2)]
        for s in sinks:
            p.link(tee, s)
        p.run(timeout=10)
        assert all(s.frames[0].tensor(0) is x for s in sinks)


class TestRequestPads:
    @pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
    def test_request_rule(self, pkg):
        """An unnamed link takes the first unlinked pad, else a new
        ``kind_N``; a named one is made on demand; an element without
        request pads refuses both."""
        mux, demux = pkg.Mux(), pkg.Demux()
        first = mux.get_sink_pad()
        assert first.name == "sink_0" and mux.get_sink_pad() is first  # still unlinked
        pkg.DataSrc(data=[pkg.frame(np.zeros(1))]).get_src_pad().link(first)
        assert mux.get_sink_pad().name == "sink_1"
        assert mux.get_sink_pad("sink_7").name == "sink_7"
        assert set(mux.sink_pads) == {"sink_0", "sink_1", "sink_7"}
        assert demux.get_src_pad("src_1").name == "src_1"
        sink = pkg.Sink()
        with pytest.raises(ValueError):
            sink.get_sink_pad("other")
        assert type(mux).REQUEST_SINK_PADS and not type(mux).REQUEST_SRC_PADS
        assert type(demux).REQUEST_SRC_PADS and not type(demux).LANE_BLOCKING

    def test_launch_string_links_request_pads(self):
        desc = ("tensor_mux name=m sync-mode=nosync ! tensor_demux name=d "
                "d.src_1 ! tensor_sink name=b collect=true "
                "d.src_0 ! tensor_sink name=a collect=true")
        for pkg, parse in ((PORT, tnns.parse_launch), (JAX, jnns.parse_launch)):
            p = parse(desc)
            assert set(p["m"].src_pads) == {"src"} and set(p["d"].src_pads) == {"src_1", "src_0"}


def test_mux_round_links_the_spans_of_its_frames():
    """With the span tracer on, each mux round's frame gets a span of its
    own whose parents are the spans of the frames it collected
    (``obs/spans.merge_context``), as in the JAX package."""
    from nnstreamer_tpu_torch.obs import hooks, spans

    def build(pkg, obs_spans):
        p = pkg.Pipeline()
        mux = p.add(pkg.Mux(sync_mode="nosync"))
        for i in range(2):
            src = p.add(pkg.DataSrc(name=f"s{i}", data=[pkg.frame(np.full((2,), i, np.int32))
                                                        for _ in range(3)]))
            p.link(src, f"{mux.name}.sink_{i}")
        sink = p.add(pkg.Sink(name="out", collect=True))
        p.link(mux, sink)
        p.attach_tracer("spans")
        p.run(timeout=20)
        return [(f.meta[obs_spans.META_KEY], f.meta[obs_spans.PARENTS_KEY]) for f in sink.frames]

    from nnstreamer_tpu.obs import spans as jspans
    try:
        got = build(PORT, spans)
        want = build(JAX, jspans)
    finally:
        hooks.clear()
        spans.reset()
    assert len(got) == len(want) == 3
    for (ctx, parents), (wctx, wparents) in zip(got, want):
        assert len(parents) == len(wparents) == 2
        assert ctx[0] == parents[0][0] and wctx[0] == wparents[0][0]  # the first's trace
        assert ctx[1] not in {s for _, s in parents}  # a span of its own
