"""The port's stream capture and replay against the JAX package's.

Case for case with the JAX package's ``tests/test_interop_protobuf.py``,
``test_file_io.py`` and ``test_save_load.py``, on the same seeded numpy
inputs, all on the CPU and all bitwise:

- the protobuf codec: the port's own proto3 encoder writes the bytes of the
  reference's ``encode_frame`` (protobuf's ``SerializeToString``) for every
  dtype (bfloat16 too), 0-d and zero-sized tensors, names, and pts that is
  absent, zero, large or negative (a negative pts is "no timestamp" and is
  not written); each side decodes the other's bytes; the port's parser
  takes what protobuf's takes (an unpacked ``shape``, unknown fields of
  every wire type, fields out of order, a negative int64 pts) and refuses
  what it refuses;
- ``tensor_decoder mode=protobuf`` and ``tensor_converter
  input-format=protobuf``: the same capture file from both packages, each
  package's replay of it, the converter's refusals;
- ``filesrc`` / ``filesink``: chunks, the dropped partial tail,
  ``num-buffers``, ``.npy`` files, byte-identical captures;
- ``tensor_save`` / ``tensor_load``: ``NNSTPU1`` files byte for byte the
  reference's, read across, truncated tails, and the ``TypeError`` of a
  meta value JSON cannot hold (a source's ``VideoSpec``, in both);
- ``direct_video``: the format it names and the tensor it hands on.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import ml_dtypes
from google.protobuf.message import DecodeError

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements import save_load as jsl
from nnstreamer_tpu.interop import decode_frame as jdecode
from nnstreamer_tpu.interop import encode_frame as jencode
from nnstreamer_tpu.interop import tensor_frame_pb2 as pb
from nnstreamer_tpu_torch.buffer import NONE_TS, Frame
from nnstreamer_tpu_torch.elements import save_load as tsl
from nnstreamer_tpu_torch.interop import decode_frame, encode_frame
from nnstreamer_tpu_torch.interop.protobuf_codec import _varint

DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "int64", "uint64",
          "float32", "float64", "float16", "bfloat16")


def ref_array(rng, dtype, shape):
    """A seeded array in the reference's dtype (ml_dtypes' for bfloat16)."""
    x = rng.standard_normal(shape) * 100
    if dtype == "bfloat16":
        return x.astype(np.float32).astype(ml_dtypes.bfloat16)
    return x.astype(dtype)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(t):
    """The bytes of a port (torch) or a reference (numpy) tensor."""
    if isinstance(t, torch.Tensor):
        flat = t.detach().reshape(-1).contiguous()
        return flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def same_tensor(port, ref):
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    want = "bfloat16" if ref.dtype == ml_dtypes.bfloat16 else ref.dtype.name
    assert tnns.dtype_name(port.dtype) == want
    assert bits(port) == bits(ref)


def pair(tensors, **kw):
    """The same frame in each package."""
    return (JFrame(tensors=tuple(np.asarray(t) for t in tensors), **kw),
            Frame(tensors=tuple(to_torch(t) for t in tensors), **kw))


# -- the codec --------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 4), (), (1,), (5, 0)])
def test_encode_bytes_equal_the_references(dtype, shape):
    rng = np.random.default_rng(19)
    ref, port = pair([ref_array(rng, dtype, shape)], pts=33_333_333, duration=33_333_333)
    want = jencode(ref)
    assert encode_frame(port) == want
    # each side decodes the other's bytes to the same frame
    got = decode_frame(want)
    back = jdecode(encode_frame(port))
    same_tensor(got.tensor(0), back.tensor(0))
    same_tensor(got.tensor(0), ref.tensor(0))
    assert (got.pts, got.duration) == (back.pts, back.duration) == (33_333_333, 33_333_333)


@pytest.mark.parametrize("pts,duration", [(NONE_TS, NONE_TS), (0, 0), (-5, 7),
                                          (2 ** 62, 1), (123, NONE_TS)])
def test_timing_presence_equals_the_references(pts, duration):
    ref, port = pair([np.arange(3, dtype=np.float32)], pts=pts, duration=duration)
    want = jencode(ref)
    assert encode_frame(port) == want
    got, back = decode_frame(want), jdecode(want)
    assert (got.pts, got.duration) == (back.pts, back.duration)


@pytest.mark.parametrize("names,meta_names", [
    (("boxes", "scores"), None), (None, ("a", "b")), (("", "b"), None), (None, None),
    (("ünï", "x"), None)])
def test_names_equal_the_references(names, meta_names):
    meta = {"tensor_names": meta_names} if meta_names else {}
    tensors = [np.zeros((2,), np.float32), np.arange(4, dtype=np.int64)]
    ref = JFrame(tensors=tuple(tensors), meta=dict(meta))
    port = Frame(tensors=tuple(to_torch(t) for t in tensors), meta=dict(meta))
    want = jencode(ref, names=names)
    assert encode_frame(port, names=names) == want
    assert decode_frame(want).meta == jdecode(want).meta


def test_multi_tensor_frame_round_trips(rng):
    tensors = [ref_array(rng, d, (3, 2)) for d in ("float32", "bfloat16", "int64")]
    ref, port = pair(tensors, pts=9)
    want = jencode(ref)
    assert encode_frame(port) == want
    for a, b in zip(decode_frame(want).tensors, tensors):
        same_tensor(a, b)


def _tensor_msg(parts):
    return b"".join(parts)


def _field(num, wt, payload):
    if wt == 2:
        return _varint(num << 3 | 2) + _varint(len(payload)) + payload
    return _varint(num << 3 | wt) + payload


@pytest.mark.parametrize("case", [
    "unpacked_shape", "unknown_varint", "unknown_fixed64", "unknown_fixed32",
    "unknown_len", "unknown_group", "unknown_in_tensor", "out_of_order", "negative_pts",
    "repeated_pts_last_wins", "wrong_wire_type_is_unknown", "mixed_packed_unpacked"])
def test_parser_accepts_what_protobuf_accepts(case):
    data = np.arange(6, dtype=np.float32).tobytes()
    name = _field(1, 2, b"t0")
    dtype = _field(2, 2, b"float32")
    packed = _field(3, 2, _varint(2) + _varint(3))
    unpacked = _field(3, 0, _varint(2)) + _field(3, 0, _varint(3))
    payload = _field(4, 2, data)
    tensor = name + dtype + packed + payload
    tail = b""
    if case == "unpacked_shape":
        tensor = name + dtype + unpacked + payload
    elif case == "mixed_packed_unpacked":
        tensor = name + dtype + _field(3, 0, _varint(2)) + _field(3, 2, _varint(3)) + payload
    elif case == "unknown_in_tensor":
        tensor = name + _field(9, 0, _varint(300)) + dtype + packed + payload
    elif case == "out_of_order":
        tensor = payload + packed + dtype + name
    elif case == "wrong_wire_type_is_unknown":
        tensor = name + dtype + packed + payload + _field(2, 0, _varint(1))
    msg = _field(1, 2, tensor)
    if case == "unknown_varint":
        tail = _field(15, 0, _varint(7))
    elif case == "unknown_fixed64":
        tail = _field(16, 1, b"\x01" * 8)
    elif case == "unknown_fixed32":
        tail = _field(17, 5, b"\x02" * 4)
    elif case == "unknown_len":
        tail = _field(18, 2, b"future")
    elif case == "unknown_group":
        tail = _varint(19 << 3 | 3) + _field(1, 0, _varint(5)) + _varint(19 << 3 | 4)
    elif case == "negative_pts":
        tail = _field(2, 0, _varint(-5)) + _field(3, 0, _varint(-(2 ** 40)))
    elif case == "repeated_pts_last_wins":
        tail = _field(2, 0, _varint(5)) + _field(2, 0, _varint(8))
    raw = msg + tail if case != "out_of_order" else tail + msg
    want = jdecode(raw)
    got = decode_frame(raw)
    assert (got.pts, got.duration) == (want.pts, want.duration)
    assert got.meta == want.meta
    assert len(got.tensors) == len(want.tensors) == 1
    same_tensor(got.tensor(0), want.tensor(0))


@pytest.mark.parametrize("case", ["payload_short", "payload_long", "bad_dtype",
                                  "truncated_body", "truncated_varint", "bad_utf8",
                                  "field_zero", "stray_end_group"])
def test_parser_refuses_what_the_reference_refuses(case):
    good = jencode(JFrame(tensors=(np.zeros((4,), np.float32),), pts=3))
    msg = pb.TensorFrame()
    msg.ParseFromString(good)
    if case == "payload_short":
        msg.tensors[0].data = msg.tensors[0].data[:-2]
        raw = msg.SerializeToString()
    elif case == "payload_long":
        msg.tensors[0].data = msg.tensors[0].data + b"\0"
        raw = msg.SerializeToString()
    elif case == "bad_dtype":
        msg.tensors[0].dtype = "complex64"
        raw = msg.SerializeToString()
    elif case == "truncated_body":
        raw = good[:-7]
    elif case == "truncated_varint":
        raw = good[:-1] + b"\x80"
    elif case == "bad_utf8":
        raw = _field(1, 2, _field(1, 2, b"\xff\xfe") + _field(2, 2, b"float32"))
    elif case == "field_zero":
        raw = good + _varint(0 << 3 | 0) + b"\x01"
    else:
        raw = good + _varint(7 << 3 | 4)
    with pytest.raises((ValueError, DecodeError)):
        jdecode(raw)
    with pytest.raises(ValueError):
        decode_frame(raw)


# -- the decoder and the converter ------------------------------------------

def _capture(pkg, frames, path):
    p = pkg.parse_launch(f"datasrc name=s ! tensor_decoder mode=protobuf ! "
                         f"filesink location={path}")
    p["s"].data = frames
    p.run(timeout=60)


def _replay(pkg, path, num_tensors=1):
    p = pkg.parse_launch(f"filesrc location={path} ! tensor_converter input-format=protobuf "
                         f"num-tensors={num_tensors} ! tensor_sink name=out collect=true")
    p.run(timeout=60)
    return p["out"].frames


def test_capture_files_equal_and_replay_across(rng, tmp_path):
    tensors = [[ref_array(rng, "float32", (3, 4)), np.array([i], np.int32)] for i in range(5)]
    jf = [JFrame(tensors=tuple(t), pts=i * 10, duration=10) for i, t in enumerate(tensors)]
    tf = [Frame(tensors=tuple(to_torch(x) for x in t), pts=i * 10, duration=10)
          for i, t in enumerate(tensors)]
    jpath, tpath = tmp_path / "j.pb", tmp_path / "t.pb"
    _capture(jnns, jf, jpath)
    _capture(tnns, tf, tpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    got, want = _replay(tnns, jpath, 2), _replay(jnns, tpath, 2)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g.pts, g.duration) == (w.pts, w.duration)
        for a, b in zip(g.tensors, w.tensors):
            same_tensor(a, b)


def test_videotestsrc_capture_equals_the_references(tmp_path):
    out = {}
    for name, pkg in (("j", jnns), ("t", tnns)):
        path = tmp_path / f"{name}.pb"
        pkg.parse_launch(f"videotestsrc num-buffers=3 width=16 height=8 pattern=random seed=7 ! "
                         f"tensor_converter ! tensor_decoder mode=protobuf ! "
                         f"filesink location={path}").run(timeout=60)
        out[name] = path.read_bytes()
    assert out["t"] == out["j"]


def test_transport_timing_wins_where_valid(tmp_path):
    """A live transport restamps: the incoming frame's valid pts wins."""
    msg = jencode(JFrame(tensors=(np.zeros(2, np.float32),), pts=5, duration=6))
    buf = np.frombuffer(len(msg).to_bytes(8, "little") + msg, np.uint8)
    got = {}
    for name, pkg in (("j", jnns), ("t", tnns)):
        p = pkg.parse_launch("datasrc name=s ! tensor_converter input-format=protobuf ! "
                             "tensor_sink name=out collect=true")
        p["s"].data = [pkg.Frame(tensors=(buf.copy() if name == "j" else torch.from_numpy(
            buf.copy()),), pts=100, duration=NONE_TS)]
        p.run(timeout=60)
        got[name] = [(f.pts, f.duration) for f in p["out"].frames]
    assert got["t"] == got["j"] == [(100, 6)]


@pytest.mark.parametrize("props,match", [
    (dict(input_format="msgpack"), "input-format"),
    (dict(input_format="protobuf", input_dim="4"), "mutually exclusive"),
    (dict(input_format="protobuf", frames_per_tensor=4), "frames-per-tensor"),
    (dict(input_format="protobuf", input_type="float32"), "input-type"),
    (dict(num_tensors=2), "num-tensors"),
    (dict(input_format="protobuf", num_tensors=0), "num-tensors"),
])
def test_converter_refusals_equal_the_references(props, match):
    with pytest.raises(ValueError, match=match):
        jnns.make("tensor_converter", **props)
    with pytest.raises(ValueError, match=match):
        tnns.make("tensor_converter", **props)


@pytest.mark.parametrize("cut,match", [(3, "truncated protobuf message"),
                                        ("prefix", "truncated length prefix")])
def test_truncated_stream_raises_as_the_references(cut, match):
    msg = jencode(JFrame(tensors=(np.zeros(4, np.float32),)))
    buf = len(msg).to_bytes(8, "little") + msg
    buf = buf[:-cut] if cut != "prefix" else buf + b"\x01\x02"
    for pkg, arr in ((jnns, np.frombuffer(buf, np.uint8).copy()),
                     (tnns, torch.frombuffer(bytearray(buf), dtype=torch.uint8))):
        p = pkg.parse_launch("datasrc name=s ! tensor_converter input-format=protobuf ! "
                             "tensor_sink name=out")
        p["s"].data = [arr]
        with pytest.raises(Exception, match=match):
            p.run(timeout=30)


def test_tensor_count_mismatch_raises_as_the_references():
    msg = jencode(JFrame(tensors=(np.zeros(2, np.float32), np.zeros(2, np.float32))))
    buf = len(msg).to_bytes(8, "little") + msg
    for pkg, arr in ((jnns, np.frombuffer(buf, np.uint8).copy()),
                     (tnns, torch.frombuffer(bytearray(buf), dtype=torch.uint8))):
        p = pkg.parse_launch("datasrc name=s ! tensor_converter input-format=protobuf "
                             "num-tensors=3 ! tensor_sink name=out")
        p["s"].data = [arr]
        with pytest.raises(Exception, match="carries 2 tensors"):
            p.run(timeout=30)


def test_protobuf_converter_is_not_a_trivial_converter():
    from nnstreamer_tpu_torch.graph.segments import _trivial_converter

    assert not _trivial_converter(tnns.make("tensor_converter", input_format="protobuf"))
    assert _trivial_converter(tnns.make("tensor_converter"))


# -- filesrc / filesink -----------------------------------------------------

def _run_file(pkg, desc):
    p = pkg.parse_launch(desc + " ! tensor_sink name=out collect=true")
    p.run(timeout=60)
    return [[bits(t) for t in f.tensors] for f in p["out"].frames], p["out"].frames


@pytest.mark.parametrize("props", ["", "blocksize=30", "blocksize=10 num-buffers=4",
                                   "blocksize=256", "blocksize=1000"])
def test_filesrc_chunks_equal_the_references(tmp_path, props):
    path = tmp_path / "raw.bin"
    path.write_bytes(bytes(range(256)) * 4)
    want, _ = _run_file(jnns, f"filesrc location={path} {props}")
    got, frames = _run_file(tnns, f"filesrc location={path} {props}")
    assert got == want
    assert all(f.tensor(0).dtype == torch.uint8 for f in frames)


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_filesrc_npy_equals_the_references(tmp_path, rng, dtype):
    path = tmp_path / "x.npy"
    np.save(path, ref_array(rng, dtype, (4, 6)))
    want, _ = _run_file(jnns, f"filesrc location={path}")
    got, frames = _run_file(tnns, f"filesrc location={path}")
    assert got == want and tuple(frames[0].tensor(0).shape) == (4, 6)


def test_filesink_capture_equals_the_references(tmp_path, rng):
    data = [ref_array(rng, d, (3, 5)) for d in ("float32", "int64", "bfloat16", "uint8")]
    out = {}
    for name, pkg in (("j", jnns), ("t", tnns)):
        path = tmp_path / f"{name}.raw"
        p = pkg.parse_launch(f"datasrc name=s ! filesink name=k location={path}")
        p["s"].data = [(x if name == "j" else to_torch(x)) for x in data[:1]] * 3
        p.run(timeout=60)
        out[name] = (path.read_bytes(), p["k"].num_frames)
    assert out["t"] == out["j"]
    # every dtype's bytes, bfloat16 among them
    sink = tnns.make("filesink", location=str(tmp_path / "all.raw"))
    sink.start()
    sink.process(None, Frame(tensors=tuple(to_torch(x) for x in data)))
    sink.stop()
    assert (tmp_path / "all.raw").read_bytes() == b"".join(bits(x) for x in data)


@pytest.mark.parametrize("element,props", [("filesrc", {}), ("filesink", {}),
                                           ("tensor_save", {}), ("tensor_load", {})])
def test_location_required_as_in_the_reference(element, props):
    with pytest.raises(ValueError, match="location"):
        jnns.make(element, **props)
    with pytest.raises(ValueError, match="location"):
        tnns.make(element, **props)


# -- tensor_save / tensor_load ---------------------------------------------

def _frames(rng):
    return [
        ([ref_array(rng, "float32", (2, 3)), ref_array(rng, "bfloat16", (4,))],
         dict(pts=0, duration=10, meta={})),
        ([ref_array(rng, "int64", ())], dict(pts=10, duration=NONE_TS,
                                              meta={"label": "x", "score": 0.5, "ids": [1, 2]})),
        ([ref_array(rng, "uint16", (1, 1, 2))],
         dict(pts=NONE_TS, duration=NONE_TS,
              meta={"boxes": np.arange(8, dtype=np.int64).reshape(2, 4),
                    "w": np.float32(1.5), "nested": {"a": [1, None, True]}})),
        ([ref_array(rng, "float16", (3,)), ref_array(rng, "int8", (2, 2))],
         dict(pts=2 ** 40, duration=1, meta={"tensor_names": ["a", "b"]})),
    ]


def _write(mod, frames, torch_side):
    f = io.BytesIO()
    f.write(mod.MAGIC)
    for tensors, kw in frames:
        tensors = [to_torch(t) if torch_side else np.asarray(t) for t in tensors]
        meta = {k: (to_torch(v) if torch_side and isinstance(v, np.ndarray) else v)
                for k, v in kw["meta"].items()}
        fr = (Frame if torch_side else JFrame)(tensors=tuple(tensors), pts=kw["pts"],
                                               duration=kw["duration"], meta=meta)
        mod.write_frame(f, fr)
    return f.getvalue()


def test_nnstpu1_files_equal_the_references(rng, tmp_path):
    frames = _frames(rng)
    want = _write(jsl, frames, torch_side=False)
    assert _write(tsl, frames, torch_side=True) == want
    path = tmp_path / "s.nnstpu"
    path.write_bytes(want)
    got, ref = list(tsl.read_frames(str(path))), list(jsl.read_frames(str(path)))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert (g.pts, g.duration) == (r.pts, r.duration)
        for a, b in zip(g.tensors, r.tensors):
            same_tensor(a, b)
        assert set(g.meta) == set(r.meta)
        for k, v in r.meta.items():
            if isinstance(v, np.ndarray):
                same_tensor(g.meta[k], v)
            else:
                assert g.meta[k] == v


@pytest.mark.parametrize("cut", [1, 7, 20, "header"])
def test_truncated_tail_loses_the_last_frame_only(rng, tmp_path, cut):
    raw = _write(jsl, _frames(rng), torch_side=False)
    raw = raw + b'{"pts": 5, "tens' if cut == "header" else raw[:-cut]
    path = tmp_path / "s.nnstpu"
    path.write_bytes(raw)
    got, want = list(tsl.read_frames(str(path))), list(jsl.read_frames(str(path)))
    assert len(got) == len(want) == (4 if cut == "header" else 3)


def test_bad_magic_raises_as_the_reference(tmp_path):
    path = tmp_path / "x"
    path.write_bytes(b"NOTMAGIC\n")
    for mod in (jsl, tsl):
        with pytest.raises(ValueError, match="NNSTPU1"):
            list(mod.read_frames(str(path)))


@pytest.mark.parametrize("bad", [object(), {1, 2}, b"bytes"])
def test_unserializable_meta_raises_type_error_in_both(bad):
    for mod, fr in ((jsl, JFrame(tensors=(np.zeros(2),), meta={"bad": bad})),
                    (tsl, Frame(tensors=(torch.zeros(2),), meta={"bad": bad}))):
        with pytest.raises(TypeError, match="meta"):
            mod.write_frame(io.BytesIO(), fr)


def test_a_sources_media_meta_is_refused_in_both(tmp_path):
    """videotestsrc's frames carry their VideoSpec in meta: straight after
    the converter, tensor_save refuses them in both packages; a hop that
    makes new frames (tensor_demux) takes the meta off."""
    for pkg in (jnns, tnns):
        p = pkg.parse_launch("videotestsrc num-buffers=2 width=8 height=8 ! tensor_converter ! "
                             f"tensor_save location={tmp_path / 'a.nns'}")
        with pytest.raises(Exception, match="not serializable"):
            p.run(timeout=30)
    out = {}
    for name, pkg in (("j", jnns), ("t", tnns)):
        path = tmp_path / f"{name}.nns"
        pkg.parse_launch("videotestsrc num-buffers=3 width=8 height=8 pattern=random ! "
                         f"tensor_converter ! tensor_demux ! tensor_save location={path}"
                         ).run(timeout=30)
        out[name] = path.read_bytes()
    assert out["t"] == out["j"]


@pytest.mark.parametrize("num_buffers", [-1, 0, 2, 5, 9])
def test_load_replays_as_the_reference(rng, tmp_path, num_buffers):
    frames = [np.full((4,), i, np.float32) for i in range(5)]
    path = tmp_path / "stream.nns"
    p = jnns.parse_launch(f"datasrc name=s ! tensor_save name=k location={path}")
    p["s"].data = frames
    p.run(timeout=60)
    assert p["k"].num_frames == 5
    want, _ = _run_file(jnns, f"tensor_load location={path} num-buffers={num_buffers}")
    got, tf = _run_file(tnns, f"tensor_load location={path} num-buffers={num_buffers}")
    assert got == want and len(got) == (5 if num_buffers < 0 else min(num_buffers, 5))
    spec = tnns.make("tensor_load", location=str(path)).output_spec()
    assert spec.tensors[0].shape == (4,) and tnns.dtype_name(spec.tensors[0].dtype) == "float32"


def test_save_through_the_port_loads_in_the_reference(tmp_path):
    path = tmp_path / "p.nns"
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    p = tnns.parse_launch(f"datasrc name=s ! tensor_save name=k location={path}")
    p["s"].data = [x, x + 1]
    p.run(timeout=60)
    with open(path, "rb") as f:
        f.readline()
        header = json.loads(f.readline())
    assert header["tensors"] == [{"dtype": "bfloat16", "shape": [2, 3]}]
    got = [np.asarray(f.tensor(0)) for f in jsl.read_frames(str(path))]
    assert [g.dtype for g in got] == [np.dtype(ml_dtypes.bfloat16)] * 2
    assert bits(got[1]) == bits(x + 1)


def test_empty_stream_refused_as_in_the_reference(tmp_path):
    path = tmp_path / "empty.nns"
    path.write_bytes(tsl.MAGIC)
    for pkg in (jnns, tnns):
        with pytest.raises(ValueError, match="empty tensor stream"):
            pkg.make("tensor_load", location=str(path)).output_spec()


# -- direct_video -----------------------------------------------------------

@pytest.mark.parametrize("shape,option,fmt", [
    ((4, 6), "", "GRAY8"), ((4, 6, 3), "", "RGB"), ((4, 6, 4), "", "RGBA"),
    ((4, 6, 3), "BGR", "BGR"), ((4, 6, 3), "NV12", "RGB")])
def test_direct_video_equals_the_references(rng, shape, option, fmt):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = {}
    for name, pkg in (("j", jnns), ("t", tnns)):
        opt = f" option1={option}" if option else ""
        p = pkg.parse_launch(f"datasrc name=s ! tensor_decoder mode=direct_video{opt} ! "
                             "tensor_sink name=out collect=true")
        p["s"].data = [x if name == "j" else torch.from_numpy(x.copy())]
        p.run(timeout=60)
        (f,) = p["out"].frames
        m = f.meta["media"]
        got[name] = (m.format, m.width, m.height, bits(f.tensor(0)))
    assert got["t"] == got["j"] and got["t"][0] == fmt


@pytest.mark.parametrize("dtype,shape", [("float32", (4, 6, 3)), ("uint8", (4, 6, 2)),
                                         ("uint8", (2, 4, 6, 3))])
def test_direct_video_refusals_equal_the_references(dtype, shape):
    for pkg in (jnns, tnns):
        p = pkg.parse_launch("datasrc name=s ! tensor_decoder mode=direct_video ! "
                             "tensor_sink name=out")
        x = np.zeros(shape, dtype)
        p["s"].data = [x if pkg is jnns else torch.from_numpy(x)]
        with pytest.raises(Exception, match="direct_video"):
            p.run(timeout=30)


def test_launch_strings_name_every_new_element():
    for name in ("filesrc", "filesink", "tensor_save", "tensor_load", "tensor_debug",
                 "tensor_if", "tensor_rate", "tensor_sparse_enc", "tensor_sparse_dec",
                 "tensor_src_iio"):
        assert name in tnns.known_elements()
    from nnstreamer_tpu_torch.elements.decoder import known_decoders

    assert {"protobuf", "direct_video"} <= known_decoders()
    assert os.path.basename(tsl.__file__) == "save_load.py"
