"""The port's ``tensor_aggregator`` against the JAX package's.

Each case runs ``datasrc ! tensor_aggregator ! tensor_sink`` in both
packages on the same frames: every window must be bitwise equal, with the
same timestamps, and both packages must negotiate the same output spec.
No arithmetic is involved, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.aggregator import TensorAggregator as JaxAggregator
from nnstreamer_tpu.elements.testsrc import AudioTestSrc as JaxAudioTestSrc
from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator
from nnstreamer_tpu_torch.elements.testsrc import AudioTestSrc
from nnstreamer_tpu_torch.spec import dtype_name


def _frames(shape, n, dtype=np.int16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1000, 1000, shape).astype(dtype) for _ in range(n)]


def _run(nns, agg, arrays, rate=100):
    p = nns.Pipeline()
    conv = (lambda a: torch.from_numpy(a.copy())) if nns is tnns else np.asarray
    src = p.add(nns.make("datasrc", data=[conv(a) for a in arrays], rate=rate))
    p.add(agg)
    sink = p.add(nns.make("tensor_sink", collect=True))
    p.link_chain(src, agg, sink)
    p.run(timeout=60)
    return sink.frames, agg.src_pads["src"].spec


def _check(shape, n, **props):
    arrays = _frames(shape, n)
    got, got_spec = _run(tnns, TensorAggregator(**props), arrays)
    want, want_spec = _run(jnns, JaxAggregator(**props), arrays)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))
        assert (g.pts, g.duration) == (w.pts, w.duration)
    (gt,), (wt,) = got_spec.tensors, want_spec.tensors
    assert (dtype_name(gt.dtype), gt.shape, got_spec.rate) == \
        (dtype_name(wt.dtype), wt.shape, want_spec.rate)
    return got


@pytest.mark.parametrize("props", [
    dict(frames_out=10, frames_dim=1),                      # the audio path's window
    dict(frames_out=4, frames_flush=1, frames_dim=1),       # sliding, overlap 3
    dict(frames_out=4, frames_flush=2, frames_dim=1),
    dict(frames_in=4, frames_out=6, frames_dim=1),          # 4 units per buffer
    dict(frames_in=2, frames_out=3, frames_flush=1, frames_dim=1),
    dict(frames_out=3, frames_dim=0),                       # along the channels
    dict(frames_out=5),                                     # dim 3: a new leading axis
    dict(frames_out=2, frames_flush=5, frames_dim=1),       # flush more than out
    dict(frames_out=1, frames_dim=1),
], ids=str)
def test_windows_match_reference(props):
    _check((16, 2), 23, **props)


def test_audio_window_from_audiotestsrc_matches_reference():
    """The audio path: 1600-sample S16LE blocks, 10 to a 16000-sample window
    (frames-dim=1 is the sample axis of (1600, 1))."""
    outs = []
    for nns, src_cls, agg_cls in ((tnns, AudioTestSrc, TensorAggregator),
                                  (jnns, JaxAudioTestSrc, JaxAggregator)):
        p = nns.Pipeline()
        src = p.add(src_cls(num_buffers=25, samplesperbuffer=1600, rate=16000, freq=440))
        conv = p.add(nns.make("tensor_converter"))
        agg = p.add(agg_cls(frames_out=10, frames_dim=1))
        sink = p.add(nns.make("tensor_sink", collect=True))
        p.link_chain(src, conv, agg, sink)
        p.run(timeout=60)
        outs.append(sink.frames)
    got, want = outs
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.tensor(0).shape) == (16000, 1) and g.tensor(0).dtype == torch.int16
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))
        assert (g.pts, g.duration) == (w.pts, w.duration)


@pytest.mark.parametrize("props,shape,match", [
    (dict(frames_in=3, frames_out=2, frames_dim=1), (16, 2), "not divisible"),
    (dict(frames_in=2, frames_out=2), (16, 2), "frames-in>1"),
])
def test_negotiation_refusals_match_reference(props, shape, match):
    for nns, cls in ((tnns, TensorAggregator), (jnns, JaxAggregator)):
        with pytest.raises(Exception, match=match):
            _run(nns, cls(**props), _frames(shape, 2))


@pytest.mark.parametrize("props", [dict(frames_in=0), dict(frames_out=0),
                                   dict(frames_flush=-1)])
def test_bad_counts_raise(props):
    with pytest.raises(ValueError, match=">= 1"):
        TensorAggregator(**props)


def test_state_round_trip_resumes_the_window():
    """A checkpoint taken mid-window and loaded into a fresh element (or the
    reference's state, numpy arrays) gives the windows of an unbroken run."""
    arrays = _frames((4, 1), 10)
    props = dict(frames_out=4, frames_flush=2, frames_dim=1)
    whole, _ = _run(tnns, TensorAggregator(**props), arrays)

    first = TensorAggregator(**props)
    head, _ = _run(tnns, first, arrays[:5])
    state = first.state_dict()
    assert all(isinstance(u, torch.Tensor) for u in state["window"])
    for loaded_state in (state, _reference_state(arrays[:5], props)):
        second = TensorAggregator(**props)
        second.load_state(loaded_state)
        tail, _ = _run(tnns, second, arrays[5:])
        got = [f.tensor(0).numpy() for f in head + tail]
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w.tensor(0).numpy())


def _reference_state(arrays, props):
    agg = JaxAggregator(**props)
    _run(jnns, agg, arrays)
    return agg.state_dict()


def test_parse_launch_properties():
    p = tnns.parse_launch("datasrc name=s ! tensor_aggregator name=a frames-out=2 "
                          "frames-flush=1 frames-dim=0 concat=false ! tensor_sink")
    a = p["a"]
    assert (a.frames_out, a.frames_flush, a.nns_dim, a.concat) == (2, 1, 0, False)
    with pytest.raises(ValueError, match="bad boolean"):
        tnns.parse_launch("datasrc ! tensor_aggregator concat=maybe ! tensor_sink")
