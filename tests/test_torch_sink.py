"""The port's ``tensor_sink`` signals and ``fakesink``, beside the JAX
package's elements on the same stream."""

import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns


def _run(nns, sink_desc, n=5, connect=()):
    arrays = [np.full((2, 3), i, np.float32) for i in range(n)]
    p = nns.parse_launch(f"datasrc name=s ! {sink_desc}")
    p["s"].data = [torch.from_numpy(a) if nns is tnns else a for a in arrays]
    for signal, cb in connect:
        p["out"].connect(signal, cb)
    p.run(timeout=60)
    return p["out"]


@pytest.mark.parametrize("nns", [tnns, jnns], ids=["port", "reference"])
def test_new_data_and_eos_signals(nns):
    got, ends = [], []
    sink = _run(nns, "tensor_sink name=out", connect=[
        ("new-data", lambda f: got.append(float(np.asarray(f.tensor(0))[0, 0]))),
        ("eos", lambda: ends.append(len(got)))])
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0] and ends == [5]
    assert sink.num_frames == 5 and sink.frames == []  # collect is off
    assert sink.wait_eos(0)


def test_callbacks_run_in_order_with_the_constructor_callback():
    order = []
    p = tnns.Pipeline()
    src = p.add(tnns.make("datasrc", data=[torch.zeros(1)] * 2))
    sink = p.add(tnns.make("tensor_sink", collect="true",
                           callback=lambda f: order.append("ctor")))
    sink.connect("new-data", lambda f: order.append("connected"))
    p.link_chain(src, sink)
    p.run(timeout=60)
    assert order == ["ctor", "connected"] * 2 and len(sink.frames) == 2


@pytest.mark.parametrize("nns", [tnns, jnns], ids=["port", "reference"])
def test_unknown_signal_raises(nns):
    with pytest.raises(ValueError, match="unknown signal"):
        nns.make("tensor_sink").connect("new-frame", print)


def test_signal_rate_limits_callbacks_not_the_count():
    got = []
    sink = _run(tnns, "tensor_sink name=out signal-rate=1 collect=true", n=20,
                connect=[("new-data", got.append)])
    assert sink.num_frames == 20
    assert len(got) == len(sink.frames) == 1  # 20 frames well inside one second


def test_wait_eos_blocks_until_the_stream_ends():
    p = tnns.parse_launch("videotestsrc num-buffers=3 width=4 height=4 framerate=20/1 "
                          "is-live=true ! tensor_sink name=out")
    sink = p["out"]
    p.start()
    try:
        assert not sink.wait_eos(0.01)
        assert sink.wait_eos(30)
        assert sink.num_frames == 3
    finally:
        p.stop()


@pytest.mark.parametrize("value,want", [("true", True), ("0", False), (True, True)])
def test_bool_properties(value, want):
    sink = tnns.make("tensor_sink", sync=value, collect=value)
    assert sink.sync is want and sink.collect is want
    with pytest.raises(ValueError, match="bad boolean"):
        tnns.make("tensor_sink", sync="ture")


@pytest.mark.parametrize("nns", [tnns, jnns], ids=["port", "reference"])
def test_fakesink_counts_and_drops(nns):
    sink = _run(nns, "fakesink name=out sync=false", n=7)
    assert sink.num_frames == 7 and not hasattr(sink, "frames")


def test_eos_callback_runs_once_per_run():
    ends = []
    lock = threading.Lock()

    def on_eos():
        with lock:
            ends.append(time.monotonic())

    p = tnns.parse_launch("datasrc name=s ! tensor_sink name=out")
    p["s"].data = [torch.zeros(1)]
    p["out"].connect("eos", on_eos)
    p.run(timeout=60)
    p.run(timeout=60)
    assert len(ends) == 2
