"""The port's ``tensor_src_iio`` against the JAX package's, over the fake
sysfs trees of the reference's ``tests/test_iio.py``.

Each case builds the same tree twice (the element writes to it: channel
enables, the trigger, the frequency, the ring buffer), runs the JAX
package's element on one and the port's on the other, and compares the
frames bit for bit (values, pts, durations, tensor count) and the files
the element wrote.  Poll and one-shot modes, continuous mode over a file
and over a FIFO fed by a writer thread, the type-string parser and the
channel decode (endian swap, shift, mask, sign extension) on every
storage width, trigger and frequency setup, ``merge_channels`` and the
refusals.  All on the CPU: frames are float32 host tensors.
"""

import os
import struct
import threading

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements import iio_src as jiio
from nnstreamer_tpu_torch.elements import iio_src as tiio

from test_iio import _pack_scan_frame, make_buffered_device, make_device


def bits(t):
    if isinstance(t, torch.Tensor):
        return t.contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def run(pkg, **props):
    p = pkg.Pipeline()
    src = p.add(pkg.make("tensor_src_iio", **props))
    sink = p.add(pkg.make("tensor_sink", collect=True))
    p.link_chain(src, sink)
    p.run(timeout=60)
    return [([bits(t) for t in f.tensors], f.pts, f.duration) for f in sink.frames]


def poll_tree(base):
    make_device(base, 0, "fake_accel", {"accel_x": (100, 0.5, None),
                                        "accel_y": (200, 0.5, 10),
                                        "accel_z": (-50, None, None)})
    make_device(base, 1, "fake_gyro", {"anglvel_x": (7, None, None)})
    return base


def buffered_tree(base):
    make_buffered_device(base, 0, "buf_accel",
                         {"accel_x": (0, 0, "le:s12/16>>4", 0.5, None),
                          "accel_y": (0, 1, "le:s12/16>>4", 0.5, 8.0),
                          "timestamp": (0, 2, "le:s64/64", None, None)},
                         triggers=("sysfstrig0", "hrtimer1"), freqs="10 100 1000")
    return base


def sysfs(base):
    """Every file of the tree and its text."""
    out = {}
    for root, _, files in os.walk(base):
        for f in files:
            path = os.path.join(root, f)
            out[os.path.relpath(path, base)] = open(path).read()
    return out


def both(tmp_path, make_tree, props, data=None):
    """Run each package's element on a tree of its own; (frames, sysfs) of
    the reference and of the port."""
    out = []
    for name, pkg in (("j", jnns), ("t", tnns)):
        base = make_tree(tmp_path / name / "iio_devices")
        kw = dict(props, base_dir=str(base))
        if data is not None:
            devs = tmp_path / name / "devnodes"
            devs.mkdir()
            (devs / "iio:device0").write_bytes(data)
            kw["dev_dir"] = str(devs)
        out.append((run(pkg, **kw), sysfs(base)))
    return out


@pytest.mark.parametrize("props", [
    dict(device="fake_accel", num_buffers=3), dict(device_number=1, num_buffers=5),
    dict(num_buffers=2), dict(device_number=1, num_buffers=3, frequency=100.0),
    dict(mode="one-shot", device="fake_accel"),
    dict(device="fake_accel", num_buffers=2, merge_channels=False),
    dict(device="fake_accel", num_buffers=1, frequency=30.0)])
def test_poll_modes_equal_the_references(tmp_path, props):
    (jf, js), (tf, ts) = both(tmp_path, poll_tree, props)
    assert tf == jf and ts == js and tf


SCANS = _pack_scan_frame(100, -200, 7) + _pack_scan_frame(-300, 50, 8) + \
    _pack_scan_frame(2047, -2048, -1)


@pytest.mark.parametrize("props", [
    dict(channels="auto", buffer_capacity=4, frequency=100.0, num_buffers=3),
    dict(buffer_capacity=16, num_buffers=1),
    dict(trigger="hrtimer1", num_buffers=1), dict(trigger_number=0, num_buffers=1),
    dict(frequency=100.0, num_buffers=2), dict(merge_channels=False, num_buffers=3),
    dict(merge_channels="false", num_buffers=1), dict(num_buffers=-1)])
def test_continuous_mode_equals_the_references(tmp_path, props):
    props = dict(props, mode="continuous", device="buf_accel")
    if props.get("merge_channels") == "false":
        # a launch string's "false": the JAX element takes bool("false"),
        # True, and merges; the port parses it (ROADMAP, reference properties)
        (jf, _), (tf, _) = both(tmp_path, buffered_tree, props, SCANS)
        assert len(jf[0][0]) == 1 and len(tf[0][0]) == 3
        return
    (jf, js), (tf, ts) = both(tmp_path, buffered_tree, props, SCANS)
    assert tf == jf and ts == js and tf


def test_custom_mode_uses_only_enabled(tmp_path):
    def tree(base):
        buffered_tree(base)
        (base / "iio:device0" / "scan_elements" / "in_accel_x_en").write_text("1\n")
        return base

    (jf, js), (tf, ts) = both(tmp_path, tree, dict(mode="continuous", device="buf_accel",
                                                   channels="custom", num_buffers=1),
                              struct.pack("<h", 25 << 4))
    assert tf == jf and ts == js
    assert np.frombuffer(tf[0][0][0], np.float32).tolist() == [12.5]


def test_malformed_channel_disabled_in_auto_mode(tmp_path):
    def tree(base):
        buffered_tree(base)
        scan = base / "iio:device0" / "scan_elements"
        (scan / "in_broken_en").write_text("0\n")
        (scan / "in_broken_index").write_text("9\n")
        (scan / "in_broken_type").write_text("garbage\n")
        return base

    (jf, js), (tf, ts) = both(tmp_path, tree, dict(mode="continuous", device="buf_accel",
                                                   num_buffers=1), _pack_scan_frame(4, 2, 1))
    assert tf == jf and ts == js
    assert np.frombuffer(tf[0][0][0], np.float32).tolist() == [2.0, 5.0, 1.0]


def test_fifo_with_a_writer_thread(tmp_path):
    got = []
    for name, pkg in (("j", jnns), ("t", tnns)):
        base = buffered_tree(tmp_path / name / "iio_devices")
        devs = tmp_path / name / "devnodes"
        devs.mkdir()
        fifo = devs / "iio:device0"
        os.mkfifo(fifo)

        def writer():
            with open(fifo, "wb") as f:
                for i in range(4):
                    f.write(_pack_scan_frame(i * 10, i, i))
                    f.flush()

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        got.append(run(pkg, mode="continuous", device="buf_accel", num_buffers=4,
                       poll_timeout=5000, base_dir=str(base), dev_dir=str(devs)))
        t.join(timeout=10)
    assert got[1] == got[0] and len(got[1]) == 4


def test_poll_timeout_ends_the_stream(tmp_path):
    for name, pkg in (("j", jnns), ("t", tnns)):
        base = buffered_tree(tmp_path / name / "iio_devices")
        devs = tmp_path / name / "devnodes"
        devs.mkdir()
        fifo = devs / "iio:device0"
        os.mkfifo(fifo)
        keep = os.open(fifo, os.O_RDWR)
        try:
            assert run(pkg, mode="continuous", device="buf_accel", num_buffers=2,
                       poll_timeout=200, base_dir=str(base), dev_dir=str(devs)) == []
        finally:
            os.close(keep)


TYPES = ["le:s12/16>>4", "be:u32/32", "be:u8/16>>0", "le:s16/16", "le:u16/16",
         "be:s16/16", "le:s24/32>>8", "be:s24/32>>8", "le:s64/64", "le:u64/64",
         "be:s64/64", "le:s1/8", "le:u3/8>>5", "be:s10/16>>6", "le:s32/32",
         "xe:s12/16>>4", "le:q12/16>>4", "le:s0/16", "le:s20/16", "le:s12/16>>16",
         "garbage", "", " le:s12/16 "]


@pytest.mark.parametrize("type_str", TYPES)
def test_type_strings_and_channel_decode_equal_the_references(type_str):
    j, t = jiio.parse_type_string("x", type_str), tiio.parse_type_string("x", type_str)
    assert (j is None) == (t is None)
    if j is None:
        return
    keys = ("big_endian", "is_signed", "used_bits", "storage_bits", "shift", "storage_bytes")
    assert [getattr(t, k) for k in keys] == [getattr(j, k) for k in keys]
    rng = np.random.default_rng(len(type_str))
    for ch in (j, t):
        ch.scale, ch.offset, ch.location = 0.5, 3.0, 1
    for _ in range(64):
        raw = bytes([0x5A]) + rng.integers(0, 256, j.storage_bytes, dtype=np.uint8).tobytes()
        assert t.decode(raw) == j.decode(raw)
    for edge in (b"\xff", b"\x00", b"\x80", b"\x7f"):
        raw = b"\x00" + edge * j.storage_bytes
        assert t.decode(raw) == j.decode(raw)


@pytest.mark.parametrize("layout", [("le:s16/16", "le:s32/32"),
                                    ("le:s8/8", "le:s16/16", "le:s64/64", "le:u8/8"),
                                    ("be:u32/32", "le:s8/8", "le:s8/8", "le:s32/32")])
def test_scan_frame_layout_equals_the_references(layout):
    sizes = []
    for mod in (jiio, tiio):
        chans = [mod.parse_type_string(f"c{i}", s) for i, s in enumerate(layout)]
        for i, c in enumerate(chans):
            c.index = len(chans) - 1 - i  # the kernel orders by index, not by name
        size = mod.assign_locations(chans)
        sizes.append((size, [c.location for c in chans]))
    assert sizes[1] == sizes[0]


@pytest.mark.parametrize("case", ["missing_base", "unknown_name", "no_channels",
                                  "unknown_trigger", "bad_frequency", "custom_malformed",
                                  "no_scan_elements"])
def test_refusals_equal_the_references(tmp_path, case):
    errors = []
    for name, mod in (("j", jiio), ("t", tiio)):
        base = tmp_path / name / "iio_devices"
        props = dict(base_dir=str(base), dev_dir=str(tmp_path))
        if case == "missing_base":
            pass
        elif case == "unknown_name":
            poll_tree(base)
            props["device"] = "no_such_sensor"
        elif case == "no_channels":
            dev = base / "iio:device0"
            dev.mkdir(parents=True)
            (dev / "name").write_text("bare\n")
        elif case == "no_scan_elements":
            poll_tree(base)
            props["mode"] = "continuous"
        else:
            buffered_tree(base)
            props.update(mode="continuous", device="buf_accel")
            if case == "unknown_trigger":
                props["trigger"] = "nope"
            elif case == "bad_frequency":
                props["frequency"] = 7.0
            else:
                scan = base / "iio:device0" / "scan_elements"
                (scan / "in_broken_en").write_text("1\n")
                (scan / "in_broken_index").write_text("9\n")
                (scan / "in_broken_type").write_text("garbage\n")
                props["channels"] = "custom"
        src = mod.TensorSrcIIO(**props)
        with pytest.raises(Exception) as info:
            src.start()
        src.stop()
        errors.append(type(info.value))
    assert errors[1] is errors[0]


def test_buffer_disabled_when_the_open_fails(tmp_path):
    enables = []
    for name, mod in (("j", jiio), ("t", tiio)):
        base = buffered_tree(tmp_path / name / "iio_devices")
        src = mod.TensorSrcIIO(mode="continuous", device="buf_accel", num_buffers=1,
                               base_dir=str(base), dev_dir=str(tmp_path / "missing"))
        with pytest.raises(OSError):
            src.start()
        src.stop()
        enables.append((base / "iio:device0" / "buffer" / "enable").read_text())
    assert enables == ["0", "0"]


@pytest.mark.parametrize("props", [dict(mode="stream"), dict(channels="some")])
def test_bad_properties_equal_the_references(props):
    with pytest.raises(ValueError):
        jnns.make("tensor_src_iio", **props)
    with pytest.raises(ValueError):
        tnns.make("tensor_src_iio", **props)


def test_values_track_sysfs_updates(tmp_path):
    seen = {}
    for name, mod in (("j", jiio), ("t", tiio)):
        base = poll_tree(tmp_path / name / "iio_devices")
        raw = base / "iio:device1" / "in_anglvel_x_raw"
        vals = []

        class Probe(mod.TensorSrcIIO):
            def frames(self):
                for i, frame in enumerate(super().frames()):
                    vals.append(float(frame.tensors[0][0]))
                    raw.write_text(f"{10 * (i + 2)}\n")
                    yield frame

        pkg = jnns if name == "j" else tnns
        p = pkg.Pipeline()
        p.link_chain(p.add(Probe(device_number=1, num_buffers=3, base_dir=str(base))),
                     p.add(pkg.make("tensor_sink")))
        p.run(timeout=30)
        seen[name] = vals
    assert seen["t"] == seen["j"] == [7.0, 20.0, 30.0]


def test_launch_string_and_aggregated_window(tmp_path):
    got = {}
    for name, pkg in (("j", jnns), ("t", tnns)):
        base = poll_tree(tmp_path / name / "iio_devices")
        p = pkg.parse_launch(f"tensor_src_iio device=fake_accel num-buffers=4 base-dir={base} ! "
                             "tensor_aggregator frames-in=1 frames-out=2 frames-flush=2 "
                             "frames-dim=0 ! tensor_sink name=out collect=true")
        p.run(timeout=30)
        got[name] = [(bits(f.tensor(0)), tuple(f.tensor(0).shape)) for f in p["out"].frames]
    assert got["t"] == got["j"] and got["t"][0][1] == (6,)
    spec = tnns.make("tensor_src_iio", device="fake_accel",
                     base_dir=str(tmp_path / "t" / "iio_devices"))
    spec.start()
    assert spec.output_spec().tensors[0].shape == (3,)
