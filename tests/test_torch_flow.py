"""The port's flow control and taps against the JAX package's.

Case for case with the JAX package's ``tests/test_tensor_if.py``, the
``tensor_rate`` cases of ``test_crop_rate.py``, ``test_sparse.py`` and
``test_debug.py``, the same seeded numpy frames through each package
(``datasrc ! <element> ! tensor_sink``), on the CPU, compared bit for bit:

- ``tensor_if`` on every ``compared-value`` at a threshold equal to the
  reference's reduced value, under ``>=``, ``>`` and ``==``, in float32,
  bfloat16, float16 and two integer dtypes, NaN included: the same frames
  pass and the same value rides in ``meta["tensor_if"]`` (ROADMAP's trap
  1: float32's mean is numpy's pairwise sum, bfloat16's the ``ml_dtypes``
  sequential one, and neither is ``torch.mean``'s);
- ``tensor_rate``: outputs, pts, durations and the four counters, and the
  ``rate_drop`` / ``rate_dup`` hooks;
- the sparse pair: the encoded tensors bit for bit, round trips with NaN,
  ``-0.0`` (dropped, decoding as ``+0.0``: trap 2) and the all-zero frame,
  each package decoding the other's frames after a hop that drops meta,
  and the decoder's refusals;
- ``tensor_debug``: records, counters, checksums (uint64 byte sums) and
  ``stats``, and the frame handed on as the same object;
- the segment planner's ``"control branch"`` cut at ``tensor_if``;
- the capture -> replay pipeline at a small width (MobileNet-v2 0.35,
  96x96, the int8 head, the reference's own weights): captured by both
  packages to byte-identical files, replayed by the port from the protobuf
  capture and from ``tensor_load`` on the plain kernels, and by the
  reference from ``tensor_load``; labels, gate and rate counts and output
  pts equal.  Logits differ by bf16 summation order only (ROADMAP C14);
  the gate's threshold is held at least LOGIT_TOL from every frame's max.
"""

import logging
import math

import numpy as np
import pytest
import torch

import jax
import ml_dtypes

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.obs import hooks as jhooks
from nnstreamer_tpu_torch.buffer import NONE_TS, Frame
from nnstreamer_tpu_torch.elements.tensor_if import bfloat16_mean
from nnstreamer_tpu_torch.graph import segments
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.obs import hooks as thooks

SIZE, CLASSES, WIDTH = 96, 10, 0.35
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
# C14: the bf16 trunk sums in another order in the two frameworks; this
# model's logits on these frames move by up to 0.0707 between them
LOGIT_TOL = 0.09


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t):
    """A port tensor (or a reference array) as the reference's numpy array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(t)


def bits(t):
    if isinstance(t, torch.Tensor):
        flat = t.detach().reshape(-1).contiguous()
        return flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def run_both(element, frames, **props):
    """The same frames (numpy, or (tensors, pts, duration) tuples) through
    ``datasrc ! element ! tensor_sink`` in each package: (node, frames out)
    of the reference and of the port."""
    out = []
    for pkg, conv, F in ((jnns, np.asarray, JFrame), (tnns, to_torch, Frame)):
        items = []
        for f in frames:
            if isinstance(f, tuple):
                tensors, pts, dur = f
                items.append(F(tensors=tuple(conv(t) for t in tensors), pts=pts, duration=dur))
            else:
                items.append(conv(f))
        p = pkg.Pipeline()
        src = p.add(pkg.make("datasrc", data=items))
        node = p.add(pkg.make(element, **props))
        sink = p.add(pkg.make("tensor_sink", collect=True))
        p.link_chain(src, node, sink)
        p.run(timeout=60)
        out.append((node, sink.frames))
    return out


def same_frames(ref, port, meta_keys=()):
    assert len(port) == len(ref)
    for r, g in zip(ref, port):
        assert (g.pts, g.duration) == (r.pts, r.duration)
        assert [bits(t) for t in g.tensors] == [bits(t) for t in r.tensors]
        for k in meta_keys:
            assert g.meta.get(k) == r.meta.get(k), k


# -- tensor_if --------------------------------------------------------------

def _if_array(dtype, kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1001).astype(np.float32)
    if kind == "nan":
        x[17] = np.nan
    elif kind == "negzero":
        x = np.array([-0.0, -0.0, 0.0, -0.0], np.float32)
    elif kind == "wide":
        x = (x * 1e4).astype(np.float32)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    if dtype in ("int32", "uint8"):
        return np.abs(x * 50).astype(dtype)
    return x.astype(dtype)


IF_VALUES = ("max", "min", "mean", "abs-max", "element:3")


IF_CASES = [(dtype, kind) for dtype in ("float32", "bfloat16", "float16", "int32", "uint8")
            for kind in ("normal", "wide", "nan")
            if not (kind == "nan" and dtype in ("int32", "uint8"))]  # no integer NaN


@pytest.mark.parametrize("dtype,kind", IF_CASES)
@pytest.mark.parametrize("cv", IF_VALUES)
def test_tensor_if_on_the_reduced_value(dtype, cv, kind):
    x = _if_array(dtype, kind)
    ref_node = jnns.make("tensor_if", compared_value=cv)
    want = ref_node._reduce(np.asarray(x))
    port_value = tnns.make("tensor_if", compared_value=cv).value(to_torch(x))
    assert (math.isnan(port_value) and math.isnan(want)) or port_value == want
    frames = [x, x]
    for op in (">=", ">", "=="):
        (jn, jf), (tn, tf) = run_both("tensor_if", frames, compared_value=cv, op=op,
                                      threshold=want)
        assert (tn.passed, tn.dropped) == (jn.passed, jn.dropped)
        for g, r in zip(tf, jf):
            gv, rv = g.meta["tensor_if"]["value"], r.meta["tensor_if"]["value"]
            assert (math.isnan(gv) and math.isnan(rv)) or gv == rv
            assert g.meta["tensor_if"]["result"] == r.meta["tensor_if"]["result"]
        if kind != "nan":
            assert tn.passed == (2 if op != ">" else 0)


def test_trap_1_the_means_torch_would_give_differ():
    """ROADMAP trap 1's probe: torch.mean is not the reference's mean (1001
    seed-0 normals, a classifier's logits)."""
    x = np.random.default_rng(0).standard_normal(1001).astype(np.float32)
    assert float(x.mean()) == -0.04679757356643677
    assert float(torch.from_numpy(x).mean()) == -0.046797581017017365
    assert tnns.make("tensor_if", compared_value="mean").value(torch.from_numpy(x)) == \
        -0.04679757356643677
    b = x.astype(ml_dtypes.bfloat16)
    assert float(b.mean()) == -0.047119140625
    assert bfloat16_mean(to_torch(b)) == -0.047119140625
    assert float(to_torch(b).mean()) == -0.046875


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [1, 2, 3, 1001, 9000])
def test_bfloat16_mean_is_ml_dtypes(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 300) + rng.uniform(-3, 3))
    b = x.astype(np.float32).astype(ml_dtypes.bfloat16)
    assert bfloat16_mean(to_torch(b)) == float(b.mean())


def test_tensor_if_negative_zeros_and_spellings():
    x = _if_array("float32", "negzero")
    (jn, jf), (tn, tf) = run_both("tensor_if", [x], compared_value="mean", op="==",
                                  threshold=0.0)
    assert tn.passed == jn.passed == 1
    assert math.copysign(1, tf[0].meta["tensor_if"]["value"]) == \
        math.copysign(1, jf[0].meta["tensor_if"]["value"])
    frames = [np.array([v], np.float32) for v in (0.2, 0.9, 0.1, 0.8)]
    for props in (dict(then="drop", else_="pass"), {"then": "drop", "else": "pass"}):
        (jn, jf), (tn, tf) = run_both("tensor_if", frames, compared_value="max", op=">",
                                      threshold=0.5, **props)
        same_frames(jf, tf, ("tensor_if",))
        assert (tn.passed, tn.dropped) == (jn.passed, jn.dropped) == (2, 2)


def test_tensor_if_second_tensor_and_launch_string():
    frames = [((np.zeros(4, np.float32), np.array([s], np.float32)), i, 1)
              for i, s in enumerate((0.9, 0.1, 0.7))]
    (jn, jf), (tn, tf) = run_both("tensor_if", frames, compared_value="max", threshold=0.5,
                                  tensor=1)
    same_frames(jf, tf, ("tensor_if",))
    assert [f.pts for f in tf] == [0, 2]
    got = {}
    for name, pkg, conv in (("j", jnns, np.asarray), ("t", tnns, to_torch)):
        p = pkg.parse_launch("datasrc name=s ! tensor_if name=cond compared-value=mean op=< "
                             "threshold=0.0 then=pass else=drop ! tensor_sink name=out "
                             "collect=true")
        p["s"].data = [conv(np.array([v], np.float32)) for v in (-1.0, 1.0, -2.0)]
        p.run(timeout=60)
        got[name] = [bits(f.tensor(0)) for f in p["out"].frames]
    assert got["t"] == got["j"] and len(got["t"]) == 2


@pytest.mark.parametrize("props,err", [
    (dict(op="=>"), ValueError), (dict(then="keep"), ValueError),
    (dict(compared_value="median"), ValueError), (dict(compared_value="element:-1"), ValueError),
    (dict(tensor=-1), ValueError), (dict(elsewise="drop"), TypeError)])
def test_tensor_if_refusals_equal_the_references(props, err):
    with pytest.raises(err):
        jnns.make("tensor_if", **props)
    with pytest.raises(err):
        tnns.make("tensor_if", **props)


@pytest.mark.parametrize("props,match", [(dict(tensor=2), "tensor=2"),
                                         (dict(compared_value="element:4"), "out of range")])
def test_tensor_if_negotiation_refusals(props, match):
    for pkg, conv in ((jnns, np.asarray), (tnns, to_torch)):
        p = pkg.Pipeline()
        src = p.add(pkg.make("datasrc", data=[conv(np.zeros(4, np.float32))]))
        p.link_chain(src, p.add(pkg.make("tensor_if", **props)), p.add(pkg.make("tensor_sink")))
        with pytest.raises(Exception, match=match):
            p.run(timeout=30)


def test_tensor_if_cuts_the_segment_as_a_control_branch():
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    p = tnns.Pipeline()
    src = p.add(tnns.make("datasrc", data=[torch.ones(4)]))
    tif = p.add(tnns.make("tensor_if", threshold=0.0))
    filt = p.add(tnns.make("tensor_filter", framework="torch", model=TorchModel(
        apply=lambda params, x: x * 2, device="cpu",
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(4,))))))
    tif2 = p.add(tnns.make("tensor_if", threshold=0.0))
    p.link_chain(src, tif, filt, tif2, p.add(tnns.make("tensor_sink")))
    plan = {pl.filter: pl for pl in segments.plan_segments(p)}[filt.name]
    assert not plan.folds
    assert (tif.name, "control branch") in plan.cuts
    assert (tif2.name, "control branch") in plan.cuts


# -- tensor_rate ------------------------------------------------------------

def _stamped(n, fps):
    dur = 1_000_000_000 // fps
    return [((np.array([i], np.int32),), i * dur, dur) for i in range(n)]


MS = 1_000_000
RATE_CASES = {
    "downsample": (_stamped(10, 30), dict(framerate="10/1")),
    "upsample": (_stamped(4, 10), dict(framerate="30/1")),
    "eos_flush": (_stamped(2, 5), dict(framerate="10/1")),
    "identity": (_stamped(5, 10), dict(framerate="10/1")),
    "throttle_off": (_stamped(10, 30), dict(framerate="10/1", throttle=False)),
    "throttle_off_string": (_stamped(10, 30), dict(framerate="10/1", throttle="false")),
    "gap_dup_most_recent": ([((np.array([v], np.int32),), t * MS, 33 * MS)
                             for v, t in ((0, 0), (1, 40), (2, 210))], dict(framerate="10/1")),
    "unstamped": ([np.array([i], np.int32) for i in range(5)], dict(framerate="10/1")),
    "fraction": (_stamped(30, 30), dict(framerate="20/3")),
    "decimal": (_stamped(12, 25), dict(framerate="12.5")),
    "jitter": ([((np.array([i], np.int32),), t * MS, 17 * MS)
                for i, t in enumerate((0, 15, 18, 70, 71, 140, 300, 301, 302, 480))],
               dict(framerate="20/1")),
}


@pytest.mark.parametrize("case", sorted(RATE_CASES))
def test_tensor_rate_equals_the_references(case):
    frames, props = RATE_CASES[case]
    (jn, jf), (tn, tf) = run_both("tensor_rate", frames, **props)
    same_frames(jf, tf)
    assert (tn.in_frames, tn.out_frames, tn.dup, tn.drop) == \
        (jn.in_frames, jn.out_frames, jn.dup, jn.drop)


def test_tensor_rate_fires_its_hooks_as_the_reference():
    counts = {}
    for name, hooks in (("j", jhooks), ("t", thooks)):
        seen = {"rate_drop": 0, "rate_dup": 0}

        def on(kind):
            def cb(node):
                seen[kind] += 1
            return cb

        cbs = {k: on(k) for k in seen}
        for k, cb in cbs.items():
            hooks.connect(k, cb)
        try:
            frames, props = RATE_CASES["jitter"]
            pkg = jnns if name == "j" else tnns
            conv = np.asarray if name == "j" else to_torch
            F = JFrame if name == "j" else Frame
            p = pkg.Pipeline()
            src = p.add(pkg.make("datasrc", data=[F(tensors=tuple(conv(t) for t in ts), pts=pts,
                                                    duration=d) for ts, pts, d in frames]))
            p.link_chain(src, p.add(pkg.make("tensor_rate", **props)),
                         p.add(pkg.make("tensor_sink")))
            p.run(timeout=60)
        finally:
            for k, cb in cbs.items():
                hooks.disconnect(k, cb)
        counts[name] = seen
    assert counts["t"] == counts["j"] and counts["t"]["rate_drop"] and counts["t"]["rate_dup"]


@pytest.mark.parametrize("framerate", ["0/1", "abc", "-5/1", "1/0"])
def test_tensor_rate_refusals_equal_the_references(framerate):
    with pytest.raises(ValueError):
        jnns.make("tensor_rate", framerate=framerate)
    with pytest.raises(ValueError):
        tnns.make("tensor_rate", framerate=framerate)


def test_tensor_rate_negotiates_its_rate():
    from fractions import Fraction

    p = tnns.Pipeline()
    src = p.add(tnns.make("datasrc", data=[torch.zeros(1)], rate=Fraction(30)))
    rate = p.add(tnns.make("tensor_rate", framerate="15/1"))
    p.link_chain(src, rate, p.add(tnns.make("tensor_sink")))
    p.negotiate()
    assert rate.src_pads["src"].spec.rate == Fraction(15)


def test_tensor_rate_hands_on_the_same_tensors():
    frames = _stamped(2, 5)
    p = tnns.Pipeline()
    x = [to_torch(ts[0]) for ts, _, _ in frames]
    src = p.add(tnns.make("datasrc", data=[Frame(tensors=(t,), pts=pts, duration=d)
                                           for t, (_, pts, d) in zip(x, frames)]))
    sink = p.add(tnns.make("tensor_sink", collect=True))
    p.link_chain(src, p.add(tnns.make("tensor_rate", framerate="10/1")), sink)
    p.run(timeout=60)
    assert [f.tensor(0) is x[i] for f, i in zip(sink.frames, (0, 0, 1, 1))] == [True] * 4


# -- the sparse pair --------------------------------------------------------

SPARSE_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "int64", "uint64",
                 "float32", "float64", "float16", "bfloat16")


def _sparse_input(dtype, kind, shape=(6, 7)):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape) * 10
    x[rng.random(shape) < 0.8] = 0
    if kind == "all_zero":
        x[:] = 0
    if dtype in ("float32", "float64", "float16", "bfloat16") and kind == "specials":
        x.flat[3] = np.nan
        x.flat[4] = -0.0
        x.flat[5] = np.inf
        x.flat[6] = -np.inf
    if dtype == "bfloat16":
        return x.astype(np.float32).astype(ml_dtypes.bfloat16)
    if dtype.startswith("u"):
        x = np.abs(x)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
@pytest.mark.parametrize("kind", ["sparse", "all_zero", "specials"])
def test_sparse_encoding_equals_the_references(dtype, kind):
    x = _sparse_input(dtype, kind)
    (jn, jf), (tn, tf) = run_both("tensor_sparse_enc", [x, x], )
    same_frames(jf, tf)
    assert (tn.frames_in, tn.bytes_in, tn.bytes_out) == (jn.frames_in, jn.bytes_in, jn.bytes_out)
    # each package decodes the other's frames, after a hop that drops meta
    for enc_frames, pkg, conv in ((jf, tnns, to_torch), (tf, jnns, np.asarray)):
        p = pkg.Pipeline()
        src = p.add(pkg.make("datasrc", data=[pkg.Frame(tensors=tuple(
            conv(to_numpy(t)) for t in f.tensors)) for f in enc_frames]))
        sink = p.add(pkg.make("tensor_sink", collect=True))
        p.link_chain(src, p.add(pkg.make("tensor_sparse_dec")), sink)
        p.run(timeout=60)
        want = np.where(np.asarray(x) == 0, np.zeros_like(np.asarray(x)), np.asarray(x))
        assert [bits(f.tensor(0)) for f in sink.frames] == [bits(want)] * 2


def test_trap_2_negative_zero_dropped_nan_kept():
    x = np.array([-0.0, np.nan, 0.0, 1.5, -0.0], np.float32)
    (_, jf), (_, tf) = run_both("tensor_sparse_enc", [x])
    header, idx, vals = tf[0].tensors
    assert idx.tolist() == [1, 3] and math.isnan(float(vals[0])) and float(vals[1]) == 1.5
    (_, jd), (_, td) = run_both("tensor_sparse_dec", [(jf[0].tensors, 0, 1)])
    assert bits(td[0].tensor(0)) == bits(jd[0].tensor(0))
    assert math.copysign(1, float(td[0].tensor(0)[0])) == 1.0


def test_sparse_round_trip_keeps_meta_and_timing():
    x = _sparse_input("float32", "sparse")
    got = {}
    for name, pkg, conv, F in (("j", jnns, np.asarray, JFrame), ("t", tnns, to_torch, Frame)):
        p = pkg.parse_launch("datasrc name=s ! tensor_sparse_enc ! queue ! tensor_sparse_dec ! "
                             "tensor_sink name=out collect=true")
        p["s"].data = [F(tensors=(conv(x),), pts=7, duration=3, meta={"k": 1})]
        p.run(timeout=60)
        (f,) = p["out"].frames
        got[name] = (bits(f.tensor(0)), f.pts, f.duration, f.meta.get("k"))
    assert got["t"] == got["j"]


@pytest.mark.parametrize("case", ["short_header", "bad_code", "bad_shape", "count_mismatch",
                                  "out_of_range", "negative_index"])
def test_sparse_decoder_refusals_equal_the_references(case):
    header = np.array([0, 8, 2, 3], np.int64)
    idx = np.array([0, 4], np.int64)
    vals = np.array([1.0, 2.0], np.float32)
    if case == "short_header":
        header = np.array([0], np.int64)
    elif case == "bad_code":
        header = np.array([0, 99, 2, 3], np.int64)
    elif case == "bad_shape":
        header = np.array([0, 8, 2, 0], np.int64)
    elif case == "count_mismatch":
        vals = np.array([1.0], np.float32)
    elif case == "out_of_range":
        idx = np.array([0, 6], np.int64)
    else:
        idx = np.array([-1, 4], np.int64)
    for pkg, conv in ((jnns, np.asarray), (tnns, to_torch)):
        p = pkg.Pipeline()
        src = p.add(pkg.make("datasrc", data=[pkg.Frame(tensors=(conv(header), conv(idx),
                                                                  conv(vals)))]))
        p.link_chain(src, p.add(pkg.make("tensor_sparse_dec")), p.add(pkg.make("tensor_sink")))
        with pytest.raises(Exception):
            p.run(timeout=30)


def test_sparse_negotiation_refusals():
    for pkg, conv in ((jnns, np.asarray), (tnns, to_torch)):
        p = pkg.Pipeline()
        src = p.add(pkg.make("datasrc", data=[pkg.Frame(tensors=(conv(np.zeros(2, np.float32)),)
                                                        * 2)]))
        p.link_chain(src, p.add(pkg.make("tensor_sparse_enc")), p.add(pkg.make("tensor_sink")))
        with pytest.raises(Exception, match="per-tensor"):
            p.run(timeout=30)
        p = pkg.Pipeline()
        src = p.add(pkg.make("datasrc", data=[conv(np.zeros(2, np.float32))]))
        p.link_chain(src, p.add(pkg.make("tensor_sparse_dec")), p.add(pkg.make("tensor_sink")))
        with pytest.raises(Exception, match="header, indices, values"):
            p.run(timeout=30)


# -- tensor_debug -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8", "int64", "float16"])
def test_tensor_debug_records_equal_the_references(dtype):
    rng = np.random.default_rng(3)
    frames = []
    for i in range(10):
        x = (rng.standard_normal((3, 4)) * 50).astype(np.float32)
        x = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x.astype(dtype)
        frames.append(((x, np.float32(i)), i * 100_000_000 if i != 4 else NONE_TS, NONE_TS))
    (jn, jf), (tn, tf) = run_both("tensor_debug", frames, capacity=4, checksum=True)
    same_frames(jf, tf)
    js, ts = jn.stats(), tn.stats()
    assert ts == js
    assert ts["frames"] == 10 and len(ts["last"]) == 4 and "fps_from_pts" in ts


def test_tensor_debug_passes_the_same_objects_and_logs(caplog):
    frames = [Frame(tensors=(torch.arange(2, dtype=torch.float32),), pts=i) for i in range(3)]
    p = tnns.Pipeline()
    src = p.add(tnns.make("datasrc", data=frames))
    dbg = p.add(tnns.make("tensor_debug", name="d", console=True, checksum="true"))
    sink = p.add(tnns.make("tensor_sink", collect=True))
    p.link_chain(src, dbg, sink)
    with caplog.at_level(logging.INFO, logger="nnstreamer_tpu_torch.debug"):
        p.run(timeout=60)
    assert all(a is b for a, b in zip(sink.frames, frames))
    msgs = [r.getMessage() for r in caplog.records if r.name == "nnstreamer_tpu_torch.debug"]
    assert any("#1" in m and "float32(2,)" in m and "sum=(191,)" in m for m in msgs)


@pytest.mark.parametrize("props", [dict(capacity=0), dict(checksum="maybe")])
def test_tensor_debug_refusals_equal_the_references(props):
    with pytest.raises(ValueError):
        jnns.make("tensor_debug", **props)
    with pytest.raises(ValueError):
        tnns.make("tensor_debug", **props)


# -- capture -> replay at a small width --------------------------------------

@pytest.fixture(scope="module")
def models():
    jmodel = jm.build_quantized(num_classes=CLASSES, width_mult=WIDTH, image_size=SIZE,
                                int8_head=True)
    tmodel = tm.build_quantized(num_classes=CLASSES, width_mult=WIDTH, image_size=SIZE,
                                params=jax.tree_util.tree_map(np.asarray, jmodel.params),
                                int8_head=True, device="cpu")
    return jmodel, tmodel


def _capture(pkg, tmp, n):
    pb, nns_file = tmp / f"{pkg.__name__}.pb", tmp / f"{pkg.__name__}.nns"
    p = pkg.parse_launch(
        f"videotestsrc num-buffers={n} width={SIZE} height={SIZE} pattern=random seed=7 ! "
        f"tensor_converter ! tee name=t t. ! queue ! tensor_decoder mode=protobuf ! "
        f"filesink location={pb} t. ! queue ! tensor_demux ! tensor_save location={nns_file} "
        "t. ! queue ! tensor_sink name=orig collect=true")
    p.run(timeout=120)
    return pb, nns_file, p["orig"].frames


def _replay(pkg, head, model, threshold, labels, **kw):
    dev = " device=cpu" if pkg is tnns else ""
    p = pkg.parse_launch(
        f"{head} ! tensor_debug name=tap0 checksum=true capacity=64 ! tensor_transform "
        f"mode=arithmetic option={NORMALIZE} acceleration=pallas{dev} ! tensor_upload ! queue ! "
        f"tensor_filter framework={'torch' if pkg is tnns else 'jax'} name=f ! "
        "tensor_debug name=tap1 capacity=64 ! tee name=lt lt. ! queue ! tensor_sink name=lg "
        f"collect=true lt. ! tensor_if name=gate compared-value=max op=> threshold={threshold!r} ! "
        "tensor_rate name=rate framerate=20/1 ! "
        f"tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out collect=true")
    p["f"].model = model
    p.run(timeout=300)
    return p


def test_capture_then_replay_equals_the_reference(models, tmp_path):
    jmodel, tmodel = models
    n = 16
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    jpb, jnns_file, _ = _capture(jnns, tmp_path, n)
    tpb, tnns_file, orig = _capture(tnns, tmp_path, n)
    assert tpb.read_bytes() == jpb.read_bytes()
    assert tnns_file.read_bytes() == jnns_file.read_bytes()
    # the gate's threshold: in the middle of the widest gap between the
    # reference's maxima (the extremes left out), LOGIT_TOL or more from each
    ref_lg = _replay(jnns, f"tensor_load location={jnns_file}", jmodel, 1e9, labels)
    maxima = sorted(float(np.asarray(f.tensor(0)).max()) for f in ref_lg["lg"].frames)
    gap, threshold = max((b - a, (a + b) / 2) for a, b in zip(maxima[1:-2], maxima[2:-1]))
    assert gap / 2 > LOGIT_TOL, maxima
    ref = _replay(jnns, f"tensor_load location={jnns_file}", jmodel, threshold, labels)
    for head in (f"filesrc location={tpb} ! tensor_converter input-format=protobuf",
                 f"tensor_load location={tnns_file}"):
        got = _replay(tnns, head, tmodel, threshold, labels)
        assert got["f"].backend.stats["replays"] == 0  # the CPU: eager, no capture
        assert got["tap0"].frames == n
        assert [r["checksum"][0] for r in got["tap0"].stats()["last"]] == \
            [int(f.tensor(0).to(torch.int64).sum()) for f in orig]
        for g, r in zip(got["lg"].frames, ref["lg"].frames):
            np.testing.assert_allclose(g.tensor(0).numpy(), np.asarray(r.tensor(0)),
                                       atol=LOGIT_TOL, rtol=0)
        assert (got["gate"].passed, got["gate"].dropped) == \
            (ref["gate"].passed, ref["gate"].dropped)
        assert 0 < got["gate"].passed < n
        rate = got["rate"]
        assert (rate.in_frames, rate.out_frames, rate.dup, rate.drop) == \
            (ref["rate"].in_frames, ref["rate"].out_frames, ref["rate"].dup, ref["rate"].drop)
        assert [(f.pts, f.meta["label_index"]) for f in got["out"].frames] == \
            [(f.pts, f.meta["label_index"]) for f in ref["out"].frames]


def test_protobuf_replay_into_a_fused_filter_captures_at_its_first_frame(models, tmp_path):
    """The converter's protobuf output names no geometry: the fused filter
    waits for its first frame (the reference refuses this at negotiation),
    or :meth:`warm_spec` gives it the geometry before the stream starts."""
    _, tmodel = models
    pb, _, _ = _capture(tnns, tmp_path, 3)
    desc = (f"filesrc location={pb} ! tensor_converter input-format=protobuf ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas "
            "device=cpu ! tensor_upload ! queue ! tensor_filter framework=torch name=f ! "
            "tensor_sink name=out collect=true")
    calls = []

    def capture(fn, spec, device):
        calls.append(tuple(spec.tensors[0].shape))
        return None

    p = tnns.parse_launch(desc)
    p["f"].model = tmodel
    p["f"].backend.capture = capture
    p.start()
    try:
        assert calls == [] and p["f"].backend.output_spec().tensors[0].shape == (CLASSES,)
        assert p.wait(120)
    finally:
        p.stop()
    assert calls == [(SIZE, SIZE, 3)] and len(p["out"].frames) == 3
    # warm_spec before the first frame: the stream then only replays
    q = tnns.parse_launch(desc.replace("tensor_upload", "tensor_upload name=u"))
    q["f"].model = tmodel
    q["f"].backend.capture = capture
    calls.clear()
    gate = q["u"]._lock
    gate.acquire()
    try:
        q.start()
        from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

        q["f"].warm_spec(TensorsSpec.of(TensorSpec(np.uint8, (SIZE, SIZE, 3))))
        assert calls == [(SIZE, SIZE, 3)]
    finally:
        gate.release()
    try:
        assert q.wait(120)
    finally:
        q.stop()
    assert calls == [(SIZE, SIZE, 3)] and q["f"].backend.stats["hits"] == 0
    assert len(q["out"].frames) == 3
    # the reference cannot negotiate the same string
    jp = jnns.parse_launch(desc.replace("torch", "jax").replace(" device=cpu", ""))
    jp["f"].model = models[0]
    with pytest.raises(Exception):
        jp.run(timeout=120)
