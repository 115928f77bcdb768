"""The port's ``tensor_dynbatch`` / ``tensor_dynunbatch`` against the JAX
package's, case by case after ``tests/test_dynbatch.py``.

Coalescing is made deterministic with a doubling backend whose first
invoke blocks and a source that holds its frames back until that invoke
has begun: the first batch is frame 0 alone, and every other frame is
queued before the backend lets go.  The bucket sequence then equals the
reference's exactly, and so do the frames (the doubling is exact).  The
last case runs config 1d's graph (``datasrc → tensor_dynbatch →
normalize → tensor_upload ! queue → tensor_filter → tensor_dynunbatch``)
with the normalize folded into the filter in both packages, on
MobileNet-v2 width 0.35 at 96x96 with a ``(None, 96, 96, 3)`` input,
float32: each frame's logits within 1e-4 of the reference's (the convs'
summation order), whatever batches the frames went in.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.base import FilterBackend as JBackend
from nnstreamer_tpu.backends.jax_backend import JaxModel
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements import dynbatch as jdyn
from nnstreamer_tpu.elements import filter as jfilter, queue as jqueue, sink as jsink
from nnstreamer_tpu.elements import testsrc as jsrc, upload as jupload
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.spec import TensorSpec as JSpec, TensorsSpec as JSpecs
from nnstreamer_tpu_torch.backends.base import FilterBackend as TBackend
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.buffer import Frame as TFrame
from nnstreamer_tpu_torch.elements import dynbatch as tdyn
from nnstreamer_tpu_torch.elements import filter as tfilter, queue as tqueue, sink as tsink
from nnstreamer_tpu_torch.elements import testsrc as tsrc, upload as tupload
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.spec import TensorSpec as TSpec, TensorsSpec as TSpecs


def _double(base, spec_cls, specs_cls, host):
    class BlockingDouble(base):
        """Doubles its (batch, d) input; with ``block``, the first invoke
        waits until released."""

        name = "blocking-double"

        def __init__(self, d=4, block=True):
            self.d = d
            self.release = threading.Event()
            self.entered = threading.Event()
            self.batch_sizes = []
            self._first = block

        def open(self, model, custom=""):
            pass

        def input_spec(self):
            return specs_cls.of(spec_cls(dtype=np.float32, shape=(None, self.d)))

        def reconfigure(self, in_spec):
            t = in_spec.tensors[0]
            return specs_cls.of(spec_cls(dtype=np.float32, shape=tuple(t.shape)))

        def invoke(self, tensors):
            self.entered.set()
            if self._first:
                self._first = False
                assert self.release.wait(30), "the test never released the backend"
            x = host(tensors[0])
            self.batch_sizes.append(x.shape[0])
            return (x * 2.0,)

    return BlockingDouble


def _held_source(base):
    class HeldSource(base):
        """Frame 0, then the rest once the filter has begun its first
        invoke; ``done`` is set once every frame has been pushed."""

        def __init__(self, data, backend):
            super().__init__(data=data)
            self.backend = backend
            self.done = threading.Event()

        def frames(self):
            for i, f in enumerate(super().frames()):
                if i == 1:
                    assert self.backend.entered.wait(30)
                yield f
            self.done.set()

    return HeldSource


JAX = SimpleNamespace(
    Pipeline=jnns.Pipeline, parse=jnns.parse_launch, DynBatch=jdyn.DynBatch,
    DynUnbatch=jdyn.DynUnbatch, bucket=jdyn._bucket, Filter=jfilter.TensorFilter,
    Sink=jsink.TensorSink, DataSrc=jsrc.DataSrc, Upload=jupload.TensorUpload,
    Queue=jqueue.Queue, Spec=JSpec, Specs=JSpecs,
    Double=_double(JBackend, JSpec, JSpecs, np.asarray), Held=_held_source(jsrc.DataSrc),
    frame=lambda x, **k: JFrame.of(x, **k), arr=lambda x: x, host=np.asarray,
    model=lambda fn, d: JaxModel(apply=lambda p, x: fn(x),
                                 input_spec=JSpecs.of(JSpec(dtype=np.float32, shape=(None, d)))))
PORT = SimpleNamespace(
    Pipeline=tnns.Pipeline, parse=tnns.parse_launch, DynBatch=tdyn.DynBatch,
    DynUnbatch=tdyn.DynUnbatch, bucket=tdyn._bucket, Filter=tfilter.TensorFilter,
    Sink=tsink.TensorSink, DataSrc=tsrc.DataSrc, Upload=tupload.TensorUpload,
    Queue=tqueue.Queue, Spec=TSpec, Specs=TSpecs,
    Double=_double(TBackend, TSpec, TSpecs, lambda t: t), Held=_held_source(tsrc.DataSrc),
    frame=lambda x, **k: TFrame.of(torch.from_numpy(x), **k), arr=torch.from_numpy,
    host=lambda t: t.numpy(),
    model=lambda fn, d: TorchModel(apply=lambda p, x: fn(x), device="cpu",
                                   input_spec=TSpecs.of(TSpec(dtype=np.float32, shape=(None, d)))))


def _blocked_run(pkg, n_frames, max_batch):
    be = pkg.Double()
    frames = [pkg.frame(np.full((4,), i, np.float32), pts=i * 100, duration=100)
              for i in range(n_frames)]
    got = []
    p = pkg.Pipeline()
    src = p.add(pkg.Held(frames, be))
    dyn = p.add(pkg.DynBatch(max_batch=max_batch))
    filt = p.add(pkg.Filter(framework="blocking-double", backend=be))
    unb = p.add(pkg.DynUnbatch())
    sink = p.add(pkg.Sink())
    sink.connect("new-data", got.append)
    p.link_chain(src, dyn, filt, unb, sink)
    p.start()
    try:
        assert src.done.wait(30)
        be.release.set()
        assert p.wait(60)
    finally:
        be.release.set()
        p.stop()
    return be, dyn, [(f.pts, f.duration, pkg.host(f.tensor(0))) for f in got]


def test_bucket_rounding():
    for pkg in (JAX, PORT):
        assert [pkg.bucket(n, 8) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 8]
        assert pkg.bucket(7, 4) == 4


@pytest.mark.parametrize("max_batch", [1, 2, 4, 8, 16, 32])
def test_bucket_ladder_matches_the_reference(max_batch):
    """Every pile-up size up to twice ``max_batch`` lands in the
    reference's bucket: a power of two, at least the pile-up, at most
    ``max_batch``."""
    for n in range(1, 2 * max_batch + 2):
        b = tdyn._bucket(n, max_batch)
        assert b == jdyn._bucket(n, max_batch)
        assert b & (b - 1) == 0 and b == min(max_batch, max(b, n)) and b <= max_batch


@pytest.mark.parametrize("n_frames,max_batch,buckets", [
    (9, 8, [1, 8]), (23, 4, [1, 4, 4, 4, 4, 4, 2]), (6, 8, [1, 8])])
def test_coalescing_under_a_blocking_double(n_frames, max_batch, buckets):
    """Frame 0 alone, then the pile-up in power-of-two buckets padded by
    repeating the last frame: the same buckets in both packages; every
    frame out once, in order, doubled, with its pts and duration."""
    runs = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        be, dyn, out = _blocked_run(pkg, n_frames, max_batch)
        runs[name] = (be.batch_sizes, dyn.batches_emitted, dyn.frames_in, out)
    assert runs["port"][:3] == runs["jax"][:3]
    sizes, emitted, frames_in, out = runs["port"]
    assert sizes == buckets and emitted == len(buckets) < frames_in == n_frames
    assert [(pts, dur) for pts, dur, _ in out] == [(i * 100, 100) for i in range(n_frames)]
    for i, (_, _, x) in enumerate(out):
        np.testing.assert_array_equal(x, np.full((4,), 2.0 * i, np.float32))
    for (gp, gd, g), (wp, wd, w) in zip(out, runs["jax"][3]):
        assert (gp, gd) == (wp, wd)
        np.testing.assert_array_equal(g, w)


def test_per_frame_meta_survives_batching():
    """Each frame's meta rides in ``meta["dynbatch"]`` and comes back on
    its own frame, with its pts, in both packages."""
    results = []
    for pkg in (PORT, JAX):
        dyn = pkg.DynBatch(max_batch=4)
        dyn.configure({"sink": pkg.Specs(tensors=(pkg.Spec(np.float32, (4,)),))})
        frames = [pkg.frame(np.full((4,), i, np.float32), pts=i, stream_id=i, tag=f"f{i}")
                  for i in range(3)]
        emitted = []
        dyn.push = emitted.append
        dyn._emit_batch(frames)
        assert len(emitted) == 1
        batched = emitted[0]
        assert tuple(batched.tensors[0].shape) == (4, 4)  # padded to the bucket
        assert batched.meta["dynbatch"]["meta"] == [f.meta for f in frames]
        unb = pkg.DynUnbatch()
        unb.configure({"sink": pkg.Specs(tensors=(pkg.Spec(np.float32, (None, 4)),))})
        out = unb.process(None, batched)
        results.append([(f.pts, f.meta, pkg.host(f.tensor(0)).tolist()) for f in out])
    assert results[0] == results[1]
    assert [m for _, m, _ in results[0]] == [{"stream_id": i, "tag": f"f{i}"} for i in range(3)]


def test_unblocked_stream_is_batch_one_and_exact():
    for pkg in (PORT, JAX):
        be = pkg.Double(block=False)
        frames = [pkg.frame(np.full((4,), i, np.float32), pts=i) for i in range(6)]
        got = []
        p = pkg.Pipeline()
        src = p.add(pkg.DataSrc(data=frames))
        dyn = p.add(pkg.DynBatch(max_batch=8))
        filt = p.add(pkg.Filter(framework="blocking-double", backend=be))
        unb = p.add(pkg.DynUnbatch())
        sink = p.add(pkg.Sink())
        sink.connect("new-data", lambda f: got.append(pkg.host(f.tensor(0))))
        p.link_chain(src, dyn, filt, unb, sink)
        p.run(timeout=60)
        assert len(got) == 6
        for i, a in enumerate(got):
            np.testing.assert_array_equal(a, np.full((4,), 2.0 * i, np.float32))


def test_parse_launch_spelling():
    outs = []
    for pkg in (PORT, JAX):
        got = []
        p = pkg.parse("datasrc name=s ! tensor_dynbatch max_batch=4 ! "
                      f"tensor_filter framework={'torch' if pkg is PORT else 'jax'} name=f ! "
                      "tensor_dynunbatch ! tensor_sink name=out")
        p["s"].data = [pkg.arr(np.full((3,), i, np.float32)) for i in range(5)]
        p["f"].model = pkg.model(lambda x: x + 1.0, 3)
        p["out"].connect("new-data", lambda f: got.append(pkg.host(f.tensor(0))))
        p.run(timeout=60)
        outs.append(np.stack(got))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][4], np.full((3,), 5.0, np.float32))


def test_midstream_renegotiation_through_dynbatch():
    """A frame shape that changes mid-stream renegotiates the batched spec
    downstream (a caps event handled on the worker): both packages give
    the sums of (4,) frames, then of (2, 3) frames."""
    outs = []
    for pkg in (PORT, JAX):
        if pkg is PORT:
            model = TorchModel(apply=lambda p, x: x.reshape(x.shape[0], -1).sum(dim=1),
                               device="cpu")
        else:
            model = JaxModel(apply=lambda p, x: x.reshape(x.shape[0], -1).sum(axis=1))
        a = [pkg.frame(np.full((4,), i, np.float32), pts=i) for i in range(3)]
        b = [pkg.frame(np.full((2, 3), 10.0 + i, np.float32), pts=3 + i) for i in range(3)]
        got = []
        p = pkg.Pipeline()
        src = p.add(pkg.DataSrc(data=a + b))
        dyn = p.add(pkg.DynBatch(max_batch=4))
        filt = p.add(pkg.Filter(framework="torch" if pkg is PORT else "jax", model=model))
        unb = p.add(pkg.DynUnbatch())
        sink = p.add(pkg.Sink())
        sink.connect("new-data", lambda f: got.append(float(pkg.host(f.tensor(0)))))
        p.link_chain(src, dyn, filt, unb, sink)
        p.run(timeout=120)
        outs.append(got)
    assert outs[0] == outs[1] == [0.0, 4.0, 8.0] + [6 * (10.0 + i) for i in range(3)]


def test_non_power_of_two_max_batch_rejected():
    for pkg in (PORT, JAX):
        with pytest.raises(ValueError, match="power of two"):
            pkg.DynBatch(max_batch=6)


def test_dynbatch_then_upload_and_queue():
    """dynbatch → upload → queue → filter: every frame through, doubled,
    in order, in both packages."""
    for pkg in (PORT, JAX):
        frames = [pkg.frame(np.full((4,), i, np.float32), pts=i) for i in range(10)]
        got = []
        p = pkg.Pipeline()
        src = p.add(pkg.DataSrc(data=frames))
        dyn = p.add(pkg.DynBatch(max_batch=4))
        up = p.add(pkg.Upload())
        q = p.add(pkg.Queue(max_size_buffers=8))
        filt = p.add(pkg.Filter(framework="torch" if pkg is PORT else "jax",
                                model=pkg.model(lambda x: x * 2.0, 4)))
        unb = p.add(pkg.DynUnbatch())
        sink = p.add(pkg.Sink())
        sink.connect("new-data", lambda f: got.append(pkg.host(f.tensor(0))))
        p.link_chain(src, dyn, up, q, filt, unb, sink)
        p.run(timeout=120)
        assert len(got) == 10
        for i, a in enumerate(got):
            np.testing.assert_array_equal(a, np.full((4,), 2.0 * i, np.float32))


SIZE, CLASSES, WIDTH = 96, 16, 0.35
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"


def test_config1d_graph_matches_the_reference():
    """Config 1d's graph, the normalize after dynbatch folded into the
    filter in both packages (the reference runs this form as well as
    bench's, with the normalize inside the model): 12 frames, each frame's
    logits within 1e-4 of the reference's and in pts order."""
    tree = tm.init_tree(0, CLASSES, WIDTH)
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(12)]
    poly = (None, SIZE, SIZE, 3)
    jparams = jm.build(CLASSES, WIDTH, SIZE, dtype=jnp.float32, params=tree).params
    jmodel = JaxModel(apply=lambda p, x: jm.apply(p, x, dtype=jnp.float32), params=jparams,
                      input_spec=JSpecs.of(JSpec(dtype=np.float32, shape=poly)))
    tparams = tm.build(CLASSES, WIDTH, SIZE, dtype=torch.float32, params=tree,
                       device="cpu").params
    tmodel = TorchModel(apply=lambda p, x: tm.apply(p, x, dtype=torch.float32), params=tparams,
                        input_spec=TSpecs.of(TSpec(dtype=np.float32, shape=poly)),
                        output_spec=TSpecs.of(TSpec(dtype=np.float32, shape=(None, CLASSES))),
                        device="cpu")
    outs = {}
    for name, pkg, model in (("port", PORT, tmodel), ("jax", JAX, jmodel)):
        dev = " device=cpu" if pkg is PORT else ""
        p = pkg.parse("datasrc name=s ! tensor_dynbatch max_batch=8 ! "
                      f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas"
                      f"{dev} ! tensor_upload ! queue ! tensor_filter "
                      f"framework={'torch' if pkg is PORT else 'jax'} name=f ! "
                      "tensor_dynunbatch ! tensor_sink name=out")
        p["s"].data = [pkg.arr(x) for x in frames]
        p["f"].model = model
        got = []
        p["out"].connect("new-data", lambda f, got=got, pkg=pkg: got.append(
            (f.pts, pkg.host(f.tensor(0)))))
        p.run(timeout=120)
        assert not any(type(n).__name__ == "TensorTransform" for n in p.nodes.values()), name
        outs[name] = got
    assert [pts for pts, _ in outs["port"]] == [pts for pts, _ in outs["jax"]]
    assert len(outs["port"]) == 12
    for (_, g), (_, w) in zip(outs["port"], outs["jax"]):
        assert g.shape == w.shape == (CLASSES,)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
