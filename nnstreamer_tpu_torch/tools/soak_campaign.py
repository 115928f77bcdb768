"""Randomized soak campaign: many short randomized pipelines, exactness
checked on every frame.

The port's counterpart of the JAX package's ``tools/soak_campaign.py``,
with its topology templates on the port's elements and models.  A failure
prints the seed and the line that repeats it::

    python -m nnstreamer_tpu_torch.tools.soak_campaign --seed N --device cpu

Templates (one drawn at random an iteration):
  linear        src -> [upload+queue | dynbatch | both] -> filter -> sink
  tee           src -> tee -> (queued filter) x 2..3 branches
  mux           src x K -> mux -> batch -> filter -> unbatch -> demux -> sink x K
  trainer       (x, y) stream into tensor_trainer, the loss must stay finite
  renegotiation mid-stream shape changes through random chains
  valve         event-driven valve close/reopen; order and exactness held
  interrupt     pipeline.stop() from another thread mid-stream (30 s bound)
  query         NNSQ offload: a QueryServer and 1 to 3 client pipelines
  tensor_if     value gating: exactly the frames the predicate passes
  crop          tensor_crop regions against numpy slices
  rate          tensor_rate's slotted timeline and counters
  sparse        tensor_sparse_enc -> dec round trips
  continuous_batching  ContinuousBatcher under churn against the decode loop

The JAX package's ``repo`` template (an LSTM recurrence through repo slots,
driven by ``bench.py``'s ``run_lstm_recurrence_fps``) is not here: the port
has no counterpart of ``bench.py`` yet.

``--device`` (``cuda`` by default, ``cpu`` on request) is where the filters,
models and servers run.  ``--lockdep`` runs the campaign under the port's
lockdep (the process starts again with ``NNSTPU_LOCKDEP=1``, so the lock
sites of the package's own import are tracked too); a lock-order cycle then
fails the campaign, and the report's counts are printed.  The last line of
standard output is one JSON object: iterations, failures, the failing seeds,
and the lockdep counts.

Usage: ``python -m nnstreamer_tpu_torch.tools.soak_campaign [--minutes 10]
[--base-seed N] [--seed N] [--device cpu] [--lockdep]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

DEVICE = "cuda"


def _np(t):
    """A tensor (on any device) or array as a numpy array."""
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _model(fn, input_spec=None, params=None):
    from ..backends.torch_backend import TorchModel

    return TorchModel(apply=lambda p, *xs: fn(p, *xs), params=params,
                      input_spec=input_spec, device=DEVICE)


def _full(shape, value):
    import torch

    return torch.full(shape, float(value), dtype=torch.float32)


def run_linear(rng):
    from .. import Pipeline
    from ..buffer import Frame
    from ..elements.dynbatch import DynBatch, DynUnbatch
    from ..elements.filter import TensorFilter
    from ..elements.queue import Queue
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc
    from ..elements.upload import TensorUpload

    n = int(rng.integers(20, 120))
    d = int(rng.integers(2, 16))
    scale = float(rng.uniform(0.5, 3.0))
    use_upload = bool(rng.integers(0, 2))
    use_dyn = bool(rng.integers(0, 2))
    frames = [Frame.of(_full((d,), i), pts=i) for i in range(n)]
    model = _model(lambda p, x: x * scale)
    got = []
    p = Pipeline()
    chain = [p.add(DataSrc(data=frames))]
    if use_dyn:
        chain.append(p.add(DynBatch(max_batch=int(2 ** rng.integers(1, 4)))))
    if use_upload:
        chain.append(p.add(TensorUpload()))
        chain.append(p.add(Queue(max_size_buffers=8)))
    chain.append(p.add(TensorFilter(framework="torch", model=model)))
    if use_dyn:
        chain.append(p.add(DynUnbatch()))
    sink = p.add(TensorSink())
    sink.connect("new-data", lambda f: got.append(_np(f.tensor(0))))
    chain.append(sink)
    p.link_chain(*chain)
    p.run(timeout=120)
    assert len(got) == n, f"linear: {len(got)}/{n} frames"
    for i, a in enumerate(got):
        np.testing.assert_allclose(a, np.float32(i) * np.float32(scale), rtol=1e-5,
                                   err_msg=f"frame {i}")


def run_tee(rng):
    from .. import Pipeline
    from ..buffer import Frame
    from ..elements.filter import TensorFilter
    from ..elements.queue import Queue
    from ..elements.sink import TensorSink
    from ..elements.tee import Tee
    from ..elements.testsrc import DataSrc

    n = int(rng.integers(20, 100))
    branches = int(rng.integers(2, 4))
    frames = [Frame.of(_full((4,), i), pts=i) for i in range(n)]
    got = [[] for _ in range(branches)]
    p = Pipeline()
    src = p.add(DataSrc(data=frames))
    tee = p.add(Tee())
    p.link(src, tee)
    for b in range(branches):
        q = p.add(Queue(max_size_buffers=int(rng.integers(2, 16))))
        f = p.add(TensorFilter(framework="torch",
                               model=_model(lambda pp, x, b=b: x + float(b))))
        s = p.add(TensorSink())
        s.connect("new-data", lambda fr, b=b: got[b].append(_np(fr.tensor(0))))
        p.link(tee, q)
        p.link_chain(q, f, s)
    p.run(timeout=120)
    for b in range(branches):
        assert len(got[b]) == n, f"tee branch {b}: {len(got[b])}/{n}"
        for i, a in enumerate(got[b]):
            np.testing.assert_allclose(a, i + b, rtol=1e-5)


def run_mux(rng):
    from .. import Pipeline, make
    from ..elements.batch import TensorBatch, TensorUnbatch
    from ..elements.demux import TensorDemux
    from ..elements.filter import TensorFilter
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    k = int(rng.integers(2, 5))
    per = int(rng.integers(10, 40))
    d = int(rng.integers(2, 8))
    got = {s: [] for s in range(k)}
    p = Pipeline()
    mux = p.add(make("tensor_mux", sync_mode="nosync"))
    for s in range(k):
        src = p.add(DataSrc(data=[_full((d,), 100.0 * s + t) for t in range(per)],
                            name=f"s{s}"))
        p.link(src, f"{mux.name}.sink_{s}")
    batch = p.add(TensorBatch())
    filt = p.add(TensorFilter(framework="torch", model=_model(lambda pp, x: x * 2.0)))
    unb = p.add(TensorUnbatch())
    demux = p.add(TensorDemux())
    p.link_chain(mux, batch, filt, unb, demux)
    for s in range(k):
        sink = p.add(TensorSink(name=f"o{s}"))
        sink.connect("new-data", lambda fr, s=s: got[s].append(_np(fr.tensor(0))))
        p.link(f"{demux.name}.src_{s}", sink)
    p.run(timeout=120)
    for s in range(k):
        assert len(got[s]) == per, f"mux stream {s}: {len(got[s])}/{per}"
        for t, a in enumerate(got[s]):
            np.testing.assert_allclose(a, 2.0 * (100.0 * s + t), rtol=1e-5)


def run_trainer(rng):
    import torch

    from .. import Pipeline
    from ..buffer import Frame
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc
    from ..elements.trainer import TensorTrainer
    from ..spec import TensorSpec, TensorsSpec

    n = int(rng.integers(10, 40))
    d = int(rng.integers(2, 8))
    b = int(rng.integers(1, 4)) * 2
    w = rng.standard_normal((d, 2)).astype(np.float32)
    frames = []
    for i in range(n):
        x = rng.standard_normal((b, d)).astype(np.float32)
        frames.append(Frame.of(torch.from_numpy(x), torch.from_numpy(x @ w), pts=i))
    model = _model(lambda p, x: x @ p,
                   params=torch.zeros((d, 2), dtype=torch.float32, device=DEVICE),
                   input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(b, d))))
    curve = []
    p = Pipeline()
    src = p.add(DataSrc(data=frames))
    tr = p.add(TensorTrainer(model=model, loss="mse", optimizer="adam,lr=0.05"))
    sink = p.add(TensorSink())
    sink.connect("new-data", lambda f: curve.append(float(_np(f.tensor(0)))))
    p.link_chain(src, tr, sink)
    p.run(timeout=120)
    assert len(curve) == n and all(np.isfinite(v) for v in curve)


def run_renegotiation(rng):
    """Shape changes mid-stream through a random chain: caps events must
    renegotiate every hop (queue workers, the dynbatch worker, the backend's
    captures) without loss or reorder."""
    from .. import Pipeline
    from ..buffer import Frame
    from ..elements.dynbatch import DynBatch, DynUnbatch
    from ..elements.filter import TensorFilter
    from ..elements.queue import Queue
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    phases = int(rng.integers(2, 5))
    per = int(rng.integers(8, 30))
    use_q = bool(rng.integers(0, 2))
    use_dyn = bool(rng.integers(0, 2))
    frames, expect, seq = [], [], 0
    for _ in range(phases):
        shape = tuple(int(rng.integers(2, 5)) for _ in range(int(rng.integers(1, 3))))
        for _ in range(per):
            frames.append(Frame.of(_full(shape, seq), pts=seq))
            expect.append(float(seq) * int(np.prod(shape)))
            seq += 1
    model = _model(lambda p, x: (x.reshape(x.shape[0], -1).sum(dim=1) if use_dyn
                                 else x.reshape(-1).sum()[None]))
    got = []
    p = Pipeline()
    chain = [p.add(DataSrc(data=frames))]
    if use_dyn:
        chain.append(p.add(DynBatch(max_batch=4)))
    if use_q:
        chain.append(p.add(Queue(max_size_buffers=8)))
    chain.append(p.add(TensorFilter(framework="torch", model=model)))
    if use_dyn:
        chain.append(p.add(DynUnbatch()))
    sink = p.add(TensorSink())
    sink.connect("new-data", lambda f: got.append(float(_np(f.tensor(0)).reshape(()))))
    chain.append(sink)
    p.link_chain(*chain)
    p.run(timeout=120)
    assert len(got) == seq, f"reneg: {len(got)}/{seq}"
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def run_valve_selector(rng):
    """Flow control under load: a valve toggled mid-stream drops a known
    span; the frames that pass stay exact and ordered."""
    import threading

    from .. import Pipeline, make
    from ..buffer import Frame
    from ..elements.queue import Queue
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    n = int(rng.integers(50, 150))
    frames = [Frame.of(_full((4,), i), pts=i) for i in range(n)]
    got = []
    p = Pipeline()
    src = p.add(DataSrc(data=frames))
    valve = p.add(make("valve"))
    q = p.add(Queue(max_size_buffers=8))
    sink = p.add(TensorSink())
    # event-driven toggling: close the valve after the 5th delivered frame,
    # reopen after a few ms; deliveries 1 to 5 are guaranteed through
    close_at = 5
    reopened = threading.Event()

    def on_frame(f):
        got.append(int(_np(f.tensor(0))[0]))
        if len(got) == close_at and not reopened.is_set():
            valve.drop = True
            threading.Timer(0.01, lambda: (setattr(valve, "drop", False),
                                           reopened.set())).start()

    sink.connect("new-data", on_frame)
    p.link_chain(src, valve, q, sink)
    p.run(timeout=120)
    assert got[:close_at] == list(range(close_at)), got[:close_at]
    assert all(b > a for a, b in zip(got, got[1:])), "reorder/dup past valve"
    assert len(got) >= close_at, f"only {len(got)} frames passed the valve"


def run_interrupt(rng):
    """Mid-stream stop: a busy pipeline (queues, a filter, dynbatch) is
    stopped from another thread while frames are in flight; stop() must
    return promptly (the hunt is for shutdown deadlocks)."""
    import threading

    from .. import Pipeline
    from ..buffer import Frame
    from ..elements.dynbatch import DynBatch, DynUnbatch
    from ..elements.filter import TensorFilter
    from ..elements.queue import Queue
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    n = 2000  # more than will ever drain before the stop
    frames = [Frame.of(_full((8,), i), pts=i) for i in range(n)]
    p = Pipeline()
    chain = [p.add(DataSrc(data=frames))]
    if rng.integers(0, 2):
        chain.append(p.add(DynBatch(max_batch=4)))
        chain.append(p.add(Queue(max_size_buffers=4)))
        chain.append(p.add(TensorFilter(framework="torch",
                                        model=_model(lambda pp, x: x * 2.0))))
        chain.append(p.add(DynUnbatch()))
    else:
        chain.append(p.add(Queue(max_size_buffers=4)))
        chain.append(p.add(TensorFilter(framework="torch",
                                        model=_model(lambda pp, x: x * 2.0))))
    sink = p.add(TensorSink())
    chain.append(sink)
    p.link_chain(*chain)
    p.start()
    time.sleep(float(rng.uniform(0.01, 0.15)))
    done = threading.Event()

    def stopper():
        p.stop()
        done.set()

    # daemon: if stop() truly wedges, the blocked thread must not keep the
    # campaign process alive past its final summary
    th = threading.Thread(target=stopper, daemon=True)
    th.start()
    th.join(timeout=30)
    assert done.is_set(), "pipeline.stop() deadlocked (>30s)"


def run_query(rng):
    """NNSQ offload under churn: an in-process QueryServer and 1 to 3 client
    pipelines (threads), exact a stream; random shapes exercise the
    server's per-spec backend cache."""
    import threading

    from .. import Pipeline
    from ..elements.query import QueryServer, TensorQueryClient
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc
    from ..spec import TensorSpec, TensorsSpec

    n_clients = int(rng.integers(1, 4))
    per = int(rng.integers(5, 25))
    out_spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=None))
    model = _model(lambda p, x: x * 2.0)
    # half the runs batch across clients (rank >= 1 frames: a batch dim)
    batch = int(rng.choice([0, 0, 2, 4]))
    with QueryServer(framework="torch", model=model, batch=batch,
                     batch_window_ms=float(rng.uniform(0.5, 10.0)), device=DEVICE) as srv:
        results = {}

        def client(k, shape):
            frames = [_full(shape, 100 * k + i) for i in range(per)]
            got = []
            p = Pipeline()
            src = p.add(DataSrc(data=frames))
            cli = p.add(TensorQueryClient(port=srv.port, out_spec=out_spec, device=DEVICE))
            sink = p.add(TensorSink())
            sink.connect("new-data", lambda f: got.append(_np(f.tensor(0))))
            p.link_chain(src, cli, sink)
            p.run(timeout=120)
            results[k] = got

        shapes = [tuple(int(rng.integers(2, 5)) for _ in range(int(rng.integers(1, 3))))
                  for _ in range(n_clients)]
        ts = [threading.Thread(target=client, args=(k, shapes[k])) for k in range(n_clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    for k in range(n_clients):
        assert len(results.get(k, [])) == per, f"client {k} incomplete"
        for i, a in enumerate(results[k]):
            np.testing.assert_allclose(a, 2.0 * (100 * k + i), rtol=1e-5)


def run_tensor_if(rng):
    """Value gating under load: the surviving frames are exactly those the
    predicate passes."""
    import torch

    from .. import Pipeline
    from ..elements.sink import TensorSink
    from ..elements.tensor_if import TensorIf
    from ..elements.testsrc import DataSrc

    n = int(rng.integers(20, 80))
    thr = float(rng.uniform(0.2, 0.8))
    vals = rng.uniform(0.0, 1.0, n).astype(np.float32)
    got = []
    p = Pipeline()
    src = p.add(DataSrc(data=[torch.tensor([v], dtype=torch.float32) for v in vals]))
    tif = p.add(TensorIf(compared_value="max", op=">", threshold=thr))
    sink = p.add(TensorSink())
    sink.connect("new-data", lambda f: got.append(float(_np(f.tensor(0))[0])))
    p.link_chain(src, tif, sink)
    p.run(timeout=120)
    want = [float(v) for v in vals if v > thr]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tif.passed == len(want) and tif.dropped == n - len(want)


def run_crop(rng):
    """tensor_crop's static mode under random regions: every crop of the
    (K,H,W,C) stack equals its numpy slice (zero-padded past the region
    count, coordinates clamped into the frame)."""
    from fractions import Fraction

    import torch

    from .. import Pipeline
    from ..elements.crop import TensorCrop
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    n = int(rng.integers(5, 20))
    H = W = int(rng.integers(16, 48))
    cw, ch = int(rng.integers(4, 12)), int(rng.integers(4, 12))
    K = int(rng.integers(1, 4))
    imgs = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(n)]
    # at least one row (the spec layer refuses 0-sized dims); zero-area
    # sentinel rows (w/h <= 0, "no detection") are mixed in on purpose
    regs = []
    for _ in range(n):
        r = rng.integers(-4, max(W, H) + 4, (int(rng.integers(1, K + 2)), 4)).astype(np.int32)
        for i in range(len(r)):
            if rng.uniform() < 0.2:
                r[i, 2 + int(rng.integers(0, 2))] = -int(rng.integers(0, 3))
        regs.append(r)
    got = []
    p = Pipeline()
    raw = p.add(DataSrc(data=[torch.from_numpy(i) for i in imgs], rate=Fraction(30)))
    info = p.add(DataSrc(data=[torch.from_numpy(r) for r in regs], rate=Fraction(30)))
    crop = p.add(TensorCrop(name="c", size=f"{cw}:{ch}", num=K))
    sink = p.add(TensorSink())
    sink.connect("new-data", got.append)
    p.link(raw, "c.raw")
    p.link(info, "c.info")
    p.link(crop, sink)
    p.run(timeout=120)
    assert len(got) == n
    for img, r, f in zip(imgs, regs, got):
        out = _np(f.tensor(0))
        assert out.shape == (K, ch, cw, 3)
        valid = [row for row in r if row[2] > 0 and row[3] > 0][:K]
        assert f.meta["tensor_crop"]["regions"] == len(valid)
        for i, row in enumerate(valid):
            x, y = int(row[0]), int(row[1])
            x = max(0, min(x, W - cw)) if W >= cw else 0
            y = max(0, min(y, H - ch)) if H >= ch else 0
            want = np.zeros((ch, cw, 3), np.uint8)
            src_sl = img[y:y + ch, x:x + cw]
            want[:src_sl.shape[0], :src_sl.shape[1]] = src_sl
            np.testing.assert_array_equal(out[i], want)
        for i in range(len(valid), K):
            assert not out[i].any()


def run_rate(rng):
    """tensor_rate on a random in/out rate pair: the output timeline is
    exactly slotted, the counters balance, down-sampling never duplicates
    and up-sampling never drops."""
    import torch

    from .. import Pipeline
    from ..buffer import Frame
    from ..elements.rate import TensorRate
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    n = int(rng.integers(10, 60))
    fin = int(rng.integers(5, 60))
    fout = int(rng.integers(5, 60))
    dur = 1_000_000_000 // fin
    frames = [Frame.of(torch.tensor([i], dtype=torch.int32), pts=i * dur, duration=dur)
              for i in range(n)]
    got = []
    p = Pipeline()
    src = p.add(DataSrc(data=frames))
    rate = p.add(TensorRate(framerate=f"{fout}/1"))
    sink = p.add(TensorSink())
    sink.connect("new-data", got.append)
    p.link_chain(src, rate, sink)
    p.run(timeout=120)
    period = 1_000_000_000 // fout
    slots = [f.pts // period for f in got]
    assert slots == sorted(set(slots)), "output slots must be strictly increasing"
    assert all(f.pts % period == 0 for f in got)
    assert rate.in_frames == n
    assert rate.out_frames == len(got) == rate.in_frames - rate.drop + rate.dup
    if fout <= fin:
        assert rate.dup == 0
    if fout >= fin:
        assert rate.drop == 0
    vals = [int(_np(f.tensor(0))[0]) for f in got]
    assert vals == sorted(vals)  # duplication repeats, never reorders


def run_sparse(rng):
    """tensor_sparse_enc -> dec round trips, exact, on random shapes, dtypes
    and densities (all-zero and fully dense frames included), with a queue
    between the halves half the time."""
    import torch

    from .. import Pipeline, make
    from ..buffer import Frame
    from ..elements.queue import Queue
    from ..elements.sink import TensorSink
    from ..elements.testsrc import DataSrc

    n = int(rng.integers(5, 40))
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 12)) for _ in range(rank))
    dtype = rng.choice([np.float32, np.int32, np.uint8])
    frames = []
    for i in range(n):
        x = np.zeros(shape, dtype)
        # 1 in 5 frames hits an exact extreme, so the empty and fully dense
        # encoder paths really run
        r = int(rng.integers(0, 5))
        density = 0.0 if r == 0 else 1.0 if r == 1 else float(rng.uniform(0, 1))
        k = int(round(x.size * density))
        if k:
            pos = rng.choice(x.size, size=k, replace=False)
            x.reshape(-1)[pos] = rng.integers(1, 100, k).astype(dtype)
        frames.append(Frame.of(torch.from_numpy(x), pts=i))
    got = []
    p = Pipeline()
    chain = [p.add(DataSrc(data=[f.with_tensors((f.tensor(0).clone(),)) for f in frames]))]
    chain.append(p.add(make("tensor_sparse_enc")))
    if rng.integers(0, 2):
        chain.append(p.add(Queue(max_size_buffers=4)))
    chain.append(p.add(make("tensor_sparse_dec")))
    sink = p.add(TensorSink())
    sink.connect("new-data", got.append)
    chain.append(sink)
    p.link_chain(*chain)
    p.run(timeout=120)
    assert len(got) == n
    for f, out in zip(frames, got):
        np.testing.assert_array_equal(_np(out.tensor(0)), _np(f.tensor(0)))
        assert out.pts == f.pts


def run_continuous_batching(rng):
    """ContinuousBatcher under random membership churn: random capacity and
    stream lengths, staggered joins and leaves, starvation, slot reuse;
    every stream's outputs match the single-sequence decode loop."""
    import torch

    from ..models import transformer
    from ..serving import ContinuousBatcher

    kw = dict(t_max=12, d_in=4, n_out=3, d_model=16, n_heads=2, n_layers=1)
    capacity = int(rng.integers(1, 5))
    n_streams = int(rng.integers(1, capacity + 3))  # more streams than slots
    lengths = [int(rng.integers(1, 9)) for _ in range(n_streams)]
    streams = [[rng.standard_normal(kw["d_in"]).astype(np.float32) for _ in range(n)]
               for n in lengths]
    got = [[] for _ in streams]
    with ContinuousBatcher(capacity=capacity, seed=int(rng.integers(4)), device=DEVICE,
                           **kw) as eng:
        pending = list(range(n_streams))
        live = {}  # stream index -> (session, position)
        while pending or live:
            if pending and len(live) < capacity and rng.random() < 0.7:
                k = pending.pop(0)
                live[k] = (eng.open_session(timeout=30), 0)
            if not live:
                continue
            # a random live stream advances one step; the others starve
            k = list(live)[int(rng.integers(0, len(live)))]
            sess, i = live[k]
            sess.feed(streams[k][i])
            got[k].append(_np(sess.get(timeout=60)))
            if i + 1 >= lengths[k]:
                sess.close()
                del live[k]
            else:
                live[k] = (sess, i + 1)
        params = eng.params
    dev = torch.device(DEVICE)
    for k, xs in enumerate(streams):
        cache = transformer.init_decode_cache(kw["n_layers"], kw["d_model"], kw["t_max"],
                                              device=dev)
        pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        for i, x in enumerate(xs):
            y, cache, pos = transformer.decode_step(params, torch.from_numpy(x).to(dev),
                                                    cache, pos)
            np.testing.assert_allclose(got[k][i], _np(y), rtol=1e-4, atol=1e-4)


TEMPLATES = [run_linear, run_tee, run_mux, run_trainer, run_renegotiation,
             run_valve_selector, run_interrupt, run_query, run_tensor_if, run_crop,
             run_rate, run_sparse, run_continuous_batching]


def pick(seed: int):
    """The template a seed draws, and its generator (positioned after the draw)."""
    rng = np.random.default_rng(seed)
    return TEMPLATES[int(rng.integers(0, len(TEMPLATES)))], rng


def repro_line(seed: int, device: str) -> str:
    return (f"python -m nnstreamer_tpu_torch.tools.soak_campaign --seed {seed} "
            f"--device {device}")


def lockdep_counts() -> dict:
    from ..analysis import lockdep

    rep = lockdep.report()
    return {"installed": rep["installed"], "sites": rep["sites"], "edges": rep["edges"],
            "cycles": len(rep["cycles"]), "blocked": len(rep["blocked"]),
            "blocking_calls": len(rep["blocking_calls"]), "suppressed": rep["suppressed"]}


def campaign(seconds: float, base_seed: int, device: str, out=sys.stdout) -> dict:
    """Run seeds ``base_seed``, ``base_seed + 1``, ... until ``seconds``
    have passed (at least one); a failing seed prints its repro line."""
    t_end = time.monotonic() + seconds
    i = 0
    failed = []
    by_template = {}
    while i == 0 or time.monotonic() < t_end:
        seed = base_seed + i
        fn, rng = pick(seed)
        by_template[fn.__name__] = by_template.get(fn.__name__, 0) + 1
        t0 = time.monotonic()
        try:
            fn(rng)
            print(f"[{i}] {fn.__name__} seed={seed} OK {time.monotonic() - t0:.3f} s",
                  file=out, flush=True)
        except Exception:  # noqa: BLE001 - counted, printed, and the campaign goes on
            failed.append(seed)
            print(f"[{i}] {fn.__name__} seed={seed} FAILED; repro: "
                  f"{repro_line(seed, device)}", file=out, flush=True)
            traceback.print_exc(file=out)
        i += 1
    return {"iterations": i, "failures": len(failed), "failed_seeds": failed,
            "templates": by_template}


def main(argv=None) -> int:
    global DEVICE

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=10.0,
                    help="the campaign's wall-time bound")
    ap.add_argument("--seed", type=int, default=None,
                    help="run this one seed's template (the repro)")
    ap.add_argument("--base-seed", type=int, default=None,
                    help="first seed of the campaign (default: the clock)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lockdep", action="store_true",
                    help="run under the port's lockdep; a lock-order cycle fails the run")
    args = ap.parse_args(argv)

    from ..analysis import lockdep

    if args.lockdep and not lockdep.installed():
        # start again with lockdep on from the package's first import
        env = dict(os.environ, NNSTPU_LOCKDEP="1")
        os.execve(sys.executable, [sys.executable, "-m", __spec__.name, *argv], env)
    DEVICE = args.device
    import torch

    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("soak_campaign: no CUDA GPU (pass --device cpu to run on the host)",
              file=sys.stderr)
        return 2
    print(f"soak_campaign: device {DEVICE}"
          + (f" ({torch.cuda.get_device_name(0)})" if DEVICE == "cuda" else ""), flush=True)

    if args.seed is not None:  # one-iteration repro
        fn, rng = pick(args.seed)
        print(f"repro seed={args.seed}: {fn.__name__}", flush=True)
        fn(rng)
        print("OK")
        res = {"iterations": 1, "failures": 0, "failed_seeds": [],
               "templates": {fn.__name__: 1}}
    else:
        base = args.base_seed if args.base_seed is not None else int(time.time())
        res = campaign(args.minutes * 60, base, DEVICE)
    res["device"] = DEVICE
    res["lockdep"] = lockdep_counts() if lockdep.installed() else None
    if lockdep.installed():
        print(lockdep.format_report(), flush=True)
    print(f"campaign done: {res['iterations']} iterations, {res['failures']} failures",
          flush=True)
    print(json.dumps(res, sort_keys=True), flush=True)
    if res["failures"] or (res["lockdep"] and res["lockdep"]["cycles"]):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
