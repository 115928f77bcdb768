"""The port's warmup phase (``graph/warmup.py``) against the JAX package's,
after ``tests/test_compile_ahead.py::TestWarmupPhase``.

There is no card here, so the filter's backend gets a capture function of
``capture_graph``'s signature (``TorchBackend.capture``, as in
``test_torch_compile_ahead.py``) that logs each capture's geometry and
runs the function eagerly.  The cases: the plan names the same items as
the reference's for the same pipeline; with ``[compile] warmup`` on,
every bucket of ``tensor_dynbatch`` is captured before PLAYING and none
after, whatever buckets the frames then bring; off by default; the
explicit ``Pipeline.warmup``; and a fused filter's negotiated wrapper
reinstalled after the buckets were captured with their own.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.jax_backend import JaxModel
from nnstreamer_tpu.graph import warmup as jwarmup
from nnstreamer_tpu.spec import TensorSpec as JSpec, TensorsSpec as JSpecs
from nnstreamer_tpu_torch.backends import torch_backend as tb
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend, TorchModel
from nnstreamer_tpu_torch.graph import warmup as twarmup
from nnstreamer_tpu_torch.obs import hooks
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

D = 4


class FakeCapture:
    """Logs each capture's input shapes and the pipeline's state then;
    the entry runs the function eagerly."""

    def __init__(self):
        self.log = []
        self.pipeline = None

    def __call__(self, fn, in_spec, device):
        state = self.pipeline.state if self.pipeline is not None else None
        self.log.append((tuple(tuple(t.shape) for t in in_spec.tensors), state))
        fn(*[torch.zeros(t.shape) for t in in_spec.tensors])
        return _Eager(fn)


class _Eager:
    warmup_calls, capture_s, warmup_s = 1, 0.0, 0.0

    def __init__(self, fn):
        self.fn = fn

    def run(self, xs):
        return tb._as_tuple(self.fn(*xs))


def _desc(fw, transform="", max_batch=8):
    return (f"datasrc name=s ! tensor_dynbatch name=dyn max_batch={max_batch} ! {transform}"
            f"tensor_filter framework={fw} name=f ! tensor_dynunbatch ! tensor_sink name=out")


def _port(transform="", capture=None, max_batch=8):
    p = tnns.parse_launch(_desc("torch", transform, max_batch))
    p["s"].data = [torch.full((D,), float(i)) for i in range(24)]
    p["f"].model = TorchModel(apply=lambda w, x: x * 3.0, device="cpu", name="triple",
                              input_spec=TensorsSpec.of(TensorSpec(np.float32, (None, D))))
    if capture is not None:
        p["f"].backend.capture = capture
        capture.pipeline = p
    return p


@pytest.mark.parametrize("max_batch", [1, 2, 4, 8, 16])
def test_plan_names_the_reference_items(max_batch):
    """The plan is the ladder up to ``max_batch``, item for item the
    reference's."""
    p = _port(max_batch=max_batch)
    p.start()
    try:
        ours = [(n, label) for n, label, _ in twarmup.collect_plan(p)]
    finally:
        p.stop()
    j = jnns.parse_launch(_desc("jax", max_batch=max_batch))
    j["s"].data = [np.full((D,), float(i), np.float32) for i in range(4)]
    j["f"].model = JaxModel(apply=lambda w, x: x * 3.0,
                            input_spec=JSpecs.of(JSpec(dtype=np.float32, shape=(None, D))))
    j.start()
    try:
        theirs = [(n, label) for n, label, _ in jwarmup.collect_plan(j)]
    finally:
        j.stop()
    assert ours == theirs == [("dyn", f"bucket{1 << i}") for i in range(max_batch.bit_length())]


def test_every_bucket_captured_before_playing_and_none_after(monkeypatch):
    monkeypatch.setenv("NNSTPU_COMPILE_WARMUP", "1")
    cap = FakeCapture()
    p = _port(capture=cap)
    seen = []

    def on_warmup(*a):
        seen.append(a[1:4])

    hooks.connect("warmup", on_warmup)
    got = []
    p["out"].connect("new-data", lambda f: got.append(float(f.tensor(0)[0])))
    try:
        p.run(timeout=60)
    finally:
        hooks.disconnect("warmup", on_warmup)
    shapes = [s for s, _ in cap.log]
    # negotiation captures bucket 1; warmup finds it and captures 2, 4, 8
    assert shapes == [((1, D),), ((2, D),), ((4, D),), ((8, D),)]
    assert all(state == "NULL" for _, state in cap.log)  # all before PLAYING
    assert [c["label"] for c in p.warmup_report["compiled"]] == \
        [f"bucket{b}" for b in (1, 2, 4, 8)]
    assert seen[-1] == ("", "", 4)  # the phase's closing hook
    assert got == [3.0 * i for i in range(24)]
    be = p["f"].backend
    assert be.stats["captures"] == 4 and be._cache_size >= 5


def test_off_by_default():
    cap = FakeCapture()
    p = _port(capture=cap)
    held, frames = threading.Event(), p["s"].frames

    def held_frames():  # no frame, so no bucket captured, before the phase ran
        held.wait(30)
        yield from frames()

    p["s"].frames = held_frames
    p.start()
    try:
        assert p.warmup_report is None and [s for s, _ in cap.log] == [((1, D),)]
        report = p.warmup()  # the explicit phase, while PLAYING
    finally:
        held.set()
        p.stop()
    assert report["items"] == 4 and report is p.warmup_report
    assert report["workers"] == 1  # one capture at a time on the card
    assert [s for s, _ in cap.log][1:] == [((2, D),), ((4, D),), ((8, D),)]
    with pytest.raises(tnns.PipelineError):
        p.warmup()  # stopped: no negotiated specs


def test_warm_compile_keeps_the_active_entry():
    be = TorchBackend()
    be.capture = FakeCapture()
    be.open(TorchModel(apply=lambda w, x: x + 1, device="cpu",
                       input_spec=TensorsSpec.of(TensorSpec(np.float32, (None, D)))))
    be.reconfigure(TensorsSpec.of(TensorSpec(np.float32, (1, D))))
    active, expected = be._entry, be._expected
    be.ensure_cache_capacity(3)
    be.warm_compile(TensorsSpec.of(TensorSpec(np.float32, (4, D))))
    assert be._entry is active and be._expected == expected
    assert list(be._graphs.values())[-1] is active  # still the most recent
    be.warm_compile(TensorsSpec.of(TensorSpec(np.float32, (4, D))))  # a hit
    assert be.stats["captures"] == 2 and be.stats["hits"] == 1


def test_fused_filter_reinstalls_its_negotiated_wrapper(monkeypatch):
    """The normalize folds into the filter; each bucket is captured with
    the wrapper built for it, and the negotiated one is active again
    after the phase: frames of every bucket come out normalized."""
    monkeypatch.setenv("NNSTPU_COMPILE_WARMUP", "1")
    cap = FakeCapture()
    p = _port("tensor_transform mode=arithmetic option=add:-1.0,mul:2.0 device=cpu ! ", cap)
    got = []
    p["out"].connect("new-data", lambda f: got.append(float(f.tensor(0)[0])))
    p.run(timeout=60)
    assert [s for s, _ in cap.log] == [((1, D),), ((2, D),), ((4, D),), ((8, D),)]
    assert got == [(i - 1.0) * 2.0 * 3.0 for i in range(24)]
    assert not any(type(n).__name__ == "TensorTransform" for n in p.nodes.values())


def test_a_failing_capture_fails_the_start(monkeypatch):
    """No warmup failure is swallowed: a bucket that cannot be captured
    fails the start, as a negotiation capture does."""
    monkeypatch.setenv("NNSTPU_COMPILE_WARMUP", "1")

    class Refuses(FakeCapture):
        def __call__(self, fn, in_spec, device):
            if in_spec.tensors[0].shape[0] == 4:
                raise RuntimeError("operation not permitted when stream is capturing")
            return super().__call__(fn, in_spec, device)

    p = _port(capture=Refuses())
    with pytest.raises(tnns.NegotiationError, match="cannot be captured"):
        p.start()
    assert p.state != "PLAYING"


def test_reference_warms_the_same_ladder(monkeypatch):
    """The JAX package's own phase on the same pipeline compiles the same
    four buckets (its report's labels)."""
    monkeypatch.setenv("NNSTPU_COMPILE_WARMUP", "1")
    j = jnns.parse_launch(_desc("jax"))
    j["s"].data = [np.full((D,), float(i), np.float32) for i in range(6)]
    j["f"].model = JaxModel(apply=lambda w, x: x * jnp.float32(3.0),
                            input_spec=JSpecs.of(JSpec(dtype=np.float32, shape=(None, D))))
    j.run(timeout=120)
    p = _port(capture=FakeCapture())
    p.run(timeout=60)
    assert [c["label"] for c in p.warmup_report["compiled"]] == \
        [c["label"] for c in j.warmup_report["compiled"]]
