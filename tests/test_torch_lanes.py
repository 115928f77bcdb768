"""The port's dispatcher lanes against the JAX package's, in one process.

Case for case with ``tests/test_lanes.py``: with ``[dispatch] lanes`` > 0
a pipeline delivers what thread mode delivers, in the same order, with the
same span rows, the same recovery ledger and the same watchdog verdicts,
while running on a small lane pool; ``lanes=0`` keeps thread mode.  Each
case runs the same graph through both packages.

``NNSTPU_DISPATCH_LANES`` and ``NNSTPU_DISPATCH_BLOCK_MS`` are read by both
packages; the tests set them with ``monkeypatch`` only.  No case is timed:
each waits on a condition with a generous timeout, and each leaves no
``lane:*``, helper (``src:*``, ``queue:*``, ``dynbatch:*``) or
``watchdog:*`` thread behind.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu import faults as jfaults
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements.dynbatch import DynBatch as JDynBatch
from nnstreamer_tpu.elements.dynbatch import DynUnbatch as JDynUnbatch
from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.elements.queue import Queue as JQueue
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JDataSrc
from nnstreamer_tpu.graph import lanes as jlanes
from nnstreamer_tpu.graph.node import SourceNode as JSourceNode
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.obs import hooks as jhooks
from nnstreamer_tpu.obs import spans as jspans
from nnstreamer_tpu.obs.metrics import REGISTRY as JREGISTRY
from nnstreamer_tpu.obs.watchdog import PipelineWatchdog as JWatchdog
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec
from nnstreamer_tpu.spec import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch import faults as tfaults
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements.dynbatch import DynBatch, DynUnbatch
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.queue import Queue
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph import lanes as tlanes
from nnstreamer_tpu_torch.graph.node import SourceNode
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.obs import hooks as thooks
from nnstreamer_tpu_torch.obs import spans as tspans
from nnstreamer_tpu_torch.obs.metrics import REGISTRY as TREGISTRY
from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

F32 = np.float32
RUN_TIMEOUT = 120
THREAD_PREFIXES = ("lane:", "src:", "queue:", "dynbatch:", "watchdog:")


class Pkg:
    """One package's surface, so each case runs the same graph in both."""

    def __init__(self, nns, faults, lanes, hooks, spans, registry, frame, datasrc, queue,
                 filt, sink, dynbatch, dynunbatch, source, watchdog, ts, tss):
        self.nns, self.faults, self.lanes, self.hooks = nns, faults, lanes, hooks
        self.spans, self.REGISTRY, self.Frame, self.DataSrc = spans, registry, frame, datasrc
        self.Queue, self.TensorFilter, self.TensorSink = queue, filt, sink
        self.DynBatch, self.DynUnbatch, self.SourceNode = dynbatch, dynunbatch, source
        self.PipelineWatchdog = watchdog
        self.vec4 = tss.of(ts(dtype=F32, shape=(4,)))


JAX = Pkg(jnns, jfaults, jlanes, jhooks, jspans, JREGISTRY, JFrame, JDataSrc, JQueue, JFilter,
          JSink, JDynBatch, JDynUnbatch, JSourceNode, JWatchdog, JTensorSpec, JTensorsSpec)
PORT = Pkg(tnns, tfaults, tlanes, thooks, tspans, TREGISTRY, Frame, DataSrc, Queue, TensorFilter,
           TensorSink, DynBatch, DynUnbatch, SourceNode, PipelineWatchdog, TensorSpec,
           TensorsSpec)
BOTH = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]


def _leftover_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.startswith(THREAD_PREFIXES))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    yield
    for pkg in (JAX, PORT):
        pkg.faults.deactivate()
        pkg.hooks.clear()
        pkg.spans.reset()
    deadline = time.monotonic() + 10
    while _leftover_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _leftover_threads() == []


def _vec(i):
    return np.full(4, float(i), F32)


def _value(frame):
    return float(np.asarray(frame.tensor(0)).reshape(-1)[0])


def _chain(pkg, n=32, name="lp", queue_size=16):
    got = []
    p = pkg.nns.Pipeline(name=name)
    src = p.add(pkg.DataSrc(data=[_vec(i) for i in range(n)], name="s"))
    q = p.add(pkg.Queue(max_size_buffers=queue_size, name="q"))
    f = p.add(pkg.TensorFilter(framework="custom", model=lambda x: x * 2.0, name="f"))
    sink = p.add(pkg.TensorSink(callback=got.append, name="out"))
    p.link_chain(src, q, f, sink)
    return p, got


# -- configuration ------------------------------------------------------------

@pytest.mark.parametrize("value,want", [("0", 0), ("off", 0), ("3", 3), ("1", 1),
                                        ("auto", max(1, min(4, os.cpu_count() or 1))),
                                        (None, 0)])
def test_configured_lanes_parsing(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("NNSTPU_DISPATCH_LANES", raising=False)
    else:
        monkeypatch.setenv("NNSTPU_DISPATCH_LANES", value)
    assert tlanes.configured_lanes() == jlanes.configured_lanes() == want


@pytest.mark.parametrize("pkg", BOTH)
def test_lanes_zero_keeps_thread_mode(monkeypatch, pkg):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "0")
    p, got = _chain(pkg, name="lz")
    p.start()
    try:
        assert p._lanes is None
        assert any(t.name == "src:s" for t in p.threads)
        assert any(t.name == "queue:q" for t in p.threads)
        assert p.wait(RUN_TIMEOUT)
        assert "lanes" not in p.stats()
    finally:
        p.stop()
    assert [_value(f) for f in got] == [2.0 * i for i in range(32)]


def test_lane_mode_runs_on_lane_pool(monkeypatch):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    results = {}
    for pkg in (JAX, PORT):
        p, got = _chain(pkg, name="lm")
        p.start()
        try:
            assert p._lanes is not None and p._lanes.nlanes == 2
            assert not any(t.name.startswith(("src:", "queue:")) for t in p.threads)
            st = p.stats()["lanes"]
            assert st["lanes"] == 2 and st["tasks"] == 2 and st["promoted"] == []
            assert sorted(t.name for t in threading.enumerate()
                          if t.name.startswith("lane:")) == ["lane:0", "lane:1"]
            assert p.wait(RUN_TIMEOUT)
        finally:
            p.stop()
        assert p._lanes is None  # released at stop
        results[pkg] = [_value(f) for f in got]
    assert results[PORT] == results[JAX] == [2.0 * i for i in range(32)]


# -- equivalence --------------------------------------------------------------

def _run_topology(pkg, topology, n=40):
    got = []
    p = pkg.nns.Pipeline(name=f"leq_{topology}")
    host = torch.from_numpy if pkg is PORT else np.asarray  # the port batches tensors
    src = p.add(pkg.DataSrc(data=[pkg.Frame.of(host(_vec(i)), pts=i) for i in range(n)],
                            name="s"))
    if topology == "dynbatch":
        db = p.add(pkg.DynBatch(max_batch=4, name="db"))
        f = p.add(pkg.TensorFilter(framework="custom", model=lambda x: x + 1.0, name="f"))
        p.link_chain(src, db, f, p.add(pkg.DynUnbatch(name="un")),
                     p.add(pkg.TensorSink(callback=got.append, name="out")))
    else:
        q = p.add(pkg.Queue(max_size_buffers=8, name="q"))
        f = p.add(pkg.TensorFilter(framework="custom", model=lambda x: x + 1.0, name="f"))
        p.link_chain(src, q, f, p.add(pkg.TensorSink(callback=got.append, name="out")))
    p.run(timeout=RUN_TIMEOUT)
    return p, [(f.pts, _value(f)) for f in got]


@pytest.mark.parametrize("topology", ["queue", "dynbatch"])
@pytest.mark.parametrize("nlanes", ["1", "2", "4"])
def test_order_and_values_equal_in_both(monkeypatch, nlanes, topology):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", nlanes)
    jp, want = _run_topology(JAX, topology)
    tp, got = _run_topology(PORT, topology)
    assert got == want == [(i, i + 1.0) for i in range(40)]
    if topology == "dynbatch":
        assert tp["db"].batches_emitted >= 1 and tp["db"].frames_in == 40


@pytest.mark.parametrize("pkg", BOTH)
def test_single_lane_backpressure_no_deadlock(monkeypatch, pkg):
    """A full bounded queue on one lane is backpressure (the producer
    drains inline), never a deadlock."""
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "1")
    p, got = _chain(pkg, n=64, name="lbp", queue_size=2)
    p.run(timeout=RUN_TIMEOUT)
    assert [_value(f) for f in got] == [2.0 * i for i in range(64)]


@pytest.mark.parametrize("pkg", BOTH)
def test_leaky_queue_drops_still_counted(monkeypatch, pkg):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "1")
    drops = []
    pkg.hooks.connect("queue_drop", lambda node, reason: drops.append((node.name, reason)))
    got = []
    p = pkg.nns.Pipeline(name="lleak")
    src = p.add(pkg.DataSrc(data=[_vec(i) for i in range(50)], name="s"))
    q = p.add(pkg.Queue(max_size_buffers=2, leaky="downstream", name="ql"))
    slow = p.add(pkg.TensorFilter(framework="custom",
                                  model=lambda x: (time.sleep(0.002), x)[1], name="f"))
    p.link_chain(src, q, slow, p.add(pkg.TensorSink(callback=got.append, name="out")))
    p.run(timeout=RUN_TIMEOUT)
    # one lane runs the source's quantum before the drain: the queue of two
    # drops the oldest of every slice's pushes
    assert q.dropped > 0
    assert q.dropped == len([d for d in drops if d == ("ql", "downstream")])
    assert len(got) + q.dropped == 50
    values = [_value(f) for f in got]
    assert values == sorted(values) and values[-1] == 49.0


# -- span parity --------------------------------------------------------------

def _span_rows(pkg):
    p, got = _chain(pkg, n=8, name="lsp")
    p.attach_tracer("spans")
    p.run(timeout=RUN_TIMEOUT)
    assert len(got) == 8
    doc = pkg.spans.chrome_trace(p.flight_snapshot())
    rows = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    starts = {e["id"]: e for e in doc["traceEvents"] if e.get("ph") == "s"}
    cross = [e for e in doc["traceEvents"] if e.get("ph") == "f" and e["id"] in starts
             and starts[e["id"]]["tid"] != e["tid"]]
    nested = any(a["tid"] == b["tid"] and a["name"] == "f" and b["name"] == "out"
                 and a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"] + 1e-6
                 for a in xs for b in xs)
    by_row = {}
    for e in xs:
        by_row.setdefault(rows[e["tid"]], set()).add((e["name"], e["cat"]))
    return set(rows.values()), by_row, bool(cross), nested


def test_logical_rows_flows_and_lane_track(monkeypatch):
    """A lane run's flight snapshot renders thread mode's logical rows
    (``src:s``, ``queue:q``) with the dispatch spans on them, flows across
    the queue hop and nested dispatches, plus a ``lane:<n>`` track of task
    slices: the same in both packages."""
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    want = _span_rows(JAX)
    names, by_row, cross, nested = _span_rows(PORT)
    assert {"src:s", "queue:q"} <= names
    assert any(n.startswith("lane:") for n in names)
    assert {n for n, _ in by_row["queue:q"]} >= {"f", "out"}
    lane_rows = [r for r in by_row if r.startswith("lane:")]
    assert all(cat == "lane" for r in lane_rows for _, cat in by_row[r])
    assert {n for r in lane_rows for n, _ in by_row[r]} & {"src:s", "queue:q"}
    assert cross and nested
    # the logical rows carry the same spans in both packages
    assert {r: v for r, v in by_row.items() if not r.startswith("lane:")} == \
        {r: v for r, v in want[1].items() if not r.startswith("lane:")}
    assert {n for n in names if not n.startswith("lane:")} == \
        {n for n in want[0] if not n.startswith("lane:")}
    assert (cross, nested) == want[2:]


def test_flight_record_row_is_the_logical_tid():
    """The flight recorder's rings are per OS thread, named at first use;
    the row of a record is set_tid's name, never the ring's."""
    tspans.enable()
    try:
        seen = []

        def body():
            prev = tspans.set_tid("queue:q")
            tspans.record_instant("inside", trace=(0, 0))
            tspans.set_tid(prev)
            tspans.record_instant("after", trace=(0, 0))
            seen.append(threading.current_thread().name)

        t = threading.Thread(target=body, name="lane:7")
        t.start()
        t.join()
        recs = {r[4]: r[3] for r in tspans.snapshot() if r[4] in ("inside", "after")}
        assert recs == {"inside": "queue:q", "after": "lane:7"} and seen == ["lane:7"]
    finally:
        tspans.reset()


# -- blocking boundaries ------------------------------------------------------

def _blocking_src(pkg, n=6):
    class BlockingSrc(pkg.SourceNode):
        LANE_BLOCKING = True

        def output_spec(self):
            return pkg.vec4

        def frames(self):
            for i in range(n):
                if self.stopped:
                    return
                yield pkg.Frame.of(_vec(i), pts=i)

    return BlockingSrc(name="bsrc")


def _sleepy_src(pkg, n=24, sleep_s=0.005):
    class SleepySrc(pkg.SourceNode):
        def output_spec(self):
            return pkg.vec4

        def frames(self):
            for i in range(n):
                if self.stopped:
                    return
                time.sleep(sleep_s)
                yield pkg.Frame.of(_vec(i), pts=i)

    return SleepySrc(name="ssrc")


def _promotions_total(pkg, pipeline, reason):
    c = pkg.REGISTRY.get("nnstpu_lane_promotions_total")
    if c is None:
        return 0
    return sum(v.value for k, v in c.children() if k[0] == pipeline and k[1] == reason)


@pytest.mark.parametrize("pkg", BOTH)
def test_hinted_source_promotes_to_helper(monkeypatch, pkg):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    promotions = []
    pkg.hooks.connect("lane_promote", lambda pl, task, reason: promotions.append((task, reason)))
    got = []
    p = pkg.nns.Pipeline(name=f"lhint_{pkg.nns.__name__}")
    p.link(p.add(_blocking_src(pkg)), p.add(pkg.TensorSink(callback=got.append, name="out")))
    before = _promotions_total(pkg, p.name, "hint")
    p.start()
    try:
        st = p._lanes.stats()
        assert st["promoted"] == ["src:bsrc"] and st["helpers"] == 1, st
        assert p.wait(RUN_TIMEOUT)
    finally:
        p.stop()
    assert [f.pts for f in got] == list(range(6))
    assert promotions == [("src:bsrc", "hint:ok")]
    assert _promotions_total(pkg, p.name, "hint") == before + 1


@pytest.mark.parametrize("pkg", BOTH)
def test_measured_blocking_source_promotes(monkeypatch, pkg):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    monkeypatch.setenv("NNSTPU_DISPATCH_BLOCK_MS", "2")
    promotions = []
    pkg.hooks.connect("lane_promote", lambda pl, task, reason: promotions.append((task, reason)))
    got = []
    p = pkg.nns.Pipeline(name="lmeas")
    p.link(p.add(_sleepy_src(pkg)), p.add(pkg.TensorSink(callback=got.append, name="out")))
    p.run(timeout=RUN_TIMEOUT)
    assert [f.pts for f in got] == list(range(24))
    assert promotions == [("src:ssrc", "measured:ok")]


@pytest.mark.parametrize("live,promoted", [(True, ["src:cam"]), (False, [])])
def test_live_videotestsrc_is_a_blocking_boundary(monkeypatch, live, promoted):
    """A live videotestsrc sleeps to keep its framerate: hinted to a
    helper at start in both packages; a non-live one stays on the lanes."""
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    seen = {}
    for pkg in (JAX, PORT):
        p = pkg.nns.parse_launch(
            f"videotestsrc name=cam num-buffers=4 width=8 height=8 framerate=200/1 "
            f"is-live={'true' if live else 'false'} ! tensor_converter ! "
            "tensor_sink name=out collect=true")
        p.start()
        try:
            seen[pkg] = p.stats()["lanes"]["promoted"]
            assert p.wait(RUN_TIMEOUT)
        finally:
            p.stop()
        assert [f.pts for f in p["out"].frames] == [i * 5_000_000 for i in range(4)]
    assert seen[PORT] == seen[JAX] == promoted


def test_appsrc_declares_a_blocking_boundary():
    from nnstreamer_tpu.elements.app import AppSrc as JAppSrc
    from nnstreamer_tpu_torch.elements.app import AppSrc

    assert AppSrc.LANE_BLOCKING is JAppSrc.LANE_BLOCKING is True


@pytest.mark.parametrize("pkg", BOTH)
def test_segment_hint_overrides_the_class_flag(monkeypatch, pkg):
    """An instance ``lane_blocking`` wins over ``LANE_BLOCKING`` either way
    (the segment planner's decoder hints)."""
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "1")
    p, _ = _chain(pkg, n=1, name="lseg")
    rt = pkg.lanes.LaneRuntime(p, 1)
    q = p["q"]
    assert rt._segment_blocking(p["s"]) is False
    p["out"].lane_blocking = True
    assert rt._segment_blocking(q) is True
    # the source's segment stops at the queue, the next boundary
    assert rt._segment_blocking(p["s"]) is False
    p["out"].lane_blocking = None
    type(p["f"]).LANE_BLOCKING = True
    try:
        p["f"].lane_blocking = False
        assert rt._segment_blocking(q) is False
    finally:
        del type(p["f"]).LANE_BLOCKING


def test_decoder_hint_follows_its_lowering(monkeypatch):
    """Segment compilation sets the decoder's hint: off while the argmax
    runs in the filter's program (so the queue's drain stays on the lanes),
    the user's value again after stop."""
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    model = tm.build_quantized(num_classes=10, width_mult=0.35, image_size=32, int8_head=True,
                               device="cpu")
    p = tnns.parse_launch(
        "videotestsrc num-buffers=2 width=32 height=32 ! tensor_converter ! queue name=q ! "
        f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas device=cpu ! "
        "tensor_filter framework=torch name=f ! tensor_decoder name=d mode=image_labeling ! "
        "tensor_sink name=out collect=true")
    p["f"].model = model
    p.segment_compile = True
    p.start()
    try:
        hint = vars(p["d"]).get("lane_blocking")
        promoted = p.stats()["lanes"]["promoted"]
        assert p.wait(RUN_TIMEOUT)
    finally:
        p.stop()
    assert hint is False and promoted == []
    assert "lane_blocking" not in vars(p["d"]) and len(p["out"].frames) == 2


# -- the six lane series ------------------------------------------------------

LANE_SERIES = ("nnstpu_lane_tasks_total", "nnstpu_lane_steals_total",
               "nnstpu_lane_handoffs_total", "nnstpu_lane_ready_depth",
               "nnstpu_lane_busy_fraction", "nnstpu_lane_promotions_total")


def test_lane_series_populate(monkeypatch):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    for pkg in (JAX, PORT):
        p, got = _chain(pkg, n=16, name="lmx")
        p.run(timeout=RUN_TIMEOUT)
        assert len(got) == 16
    for name in LANE_SERIES:
        mine, theirs = TREGISTRY.get(name), JREGISTRY.get(name)
        assert mine is not None and theirs is not None, name
        assert (type(mine).__name__, mine.help, tuple(mine.labelnames)) == \
            (type(theirs).__name__, theirs.help, tuple(theirs.labelnames))
    tasks = [v.value for k, v in TREGISTRY.get("nnstpu_lane_tasks_total").children()
             if k[0] == "lmx"]
    assert tasks and sum(tasks) > 0
    assert any(k[0] == "lmx" for k, _ in TREGISTRY.get("nnstpu_lane_ready_depth").children())


# -- recovery under lanes -----------------------------------------------------

def _stall_once_src(pkg):
    class StallOnceSrc(pkg.SourceNode):
        def __init__(self):
            super().__init__("cam")
            self.runs = 0

        def output_spec(self):
            return pkg.vec4

        def frames(self):
            self.runs += 1
            yield pkg.Frame.of(np.zeros(4, F32), pts=0)
            if self.runs == 1:
                self._stop_evt.wait()  # stall until restarted
                return
            for i in range(1, 5):
                yield pkg.Frame.of(_vec(i), pts=i)

    return StallOnceSrc()


def _watchdog_restart(pkg):
    got = []
    p = pkg.nns.Pipeline(name="lwd")
    src = p.add(_stall_once_src(pkg))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link(src, sink)
    wd = p.attach_tracer(pkg.PipelineWatchdog(interval_s=0.05, stall_s=0.2, recover=True))
    p.start()
    try:
        assert p.wait(timeout=RUN_TIMEOUT)
    finally:
        p.stop()
    return src.runs, got, p.recovery_stats(), wd.summary()


def test_watchdog_restarts_stalled_source(monkeypatch):
    """A source blocked inside frames() holds its lane; the watchdog sees
    the stall (task mid-slice, no source_push), and restart_source retires
    the stale task and arms a fresh one."""
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    jruns, jgot, jrec, _ = _watchdog_restart(JAX)
    runs, got, rec, summ = _watchdog_restart(PORT)
    assert runs == jruns == 2
    assert got == jgot == [0, 0, 1, 2, 3, 4]
    assert rec == jrec == {"actions": {"restart_source": 1}}
    assert summ["recoveries"] == 1 and summ["recover"] is True


def _wedged_queue(pkg, n=40):
    pkg.faults.install("queue_wedge@lq:after=1,ms=1500")
    got = []
    p = pkg.nns.Pipeline(name="lwq")
    src = p.add(pkg.DataSrc(data=[pkg.Frame.of(_vec(i), pts=i) for i in range(n)], name="s"))
    q = p.add(pkg.Queue(max_size_buffers=200, name="lq"))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link_chain(src, q, sink)
    p.attach_tracer(pkg.PipelineWatchdog(interval_s=0.05, stall_s=0.2, recover=True))
    p.run(timeout=RUN_TIMEOUT)
    return got, p.recovery_stats(), q.dropped


@pytest.mark.parametrize("pkg", BOTH)
def test_wedged_queue_drained(monkeypatch, pkg):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    got, rec, dropped = _wedged_queue(pkg)
    assert rec["actions"].get("drain_queue", 0) >= 1
    assert len(got) + rec["shed_total"] == 40 and rec["shed_total"] == dropped > 0
    assert got == sorted(got) and got[0] == 0


def _restart_ledger(pkg, n=60):
    eng = pkg.faults.install("seed=9;invoke_raise@f:every=10")
    got = []
    p = pkg.nns.Pipeline(name="lrp")
    src = p.add(pkg.DataSrc(data=[pkg.Frame.of(_vec(i), pts=i) for i in range(n)], name="s"))
    q = p.add(pkg.Queue(max_size_buffers=16, name="q"))
    f = p.add(pkg.TensorFilter(framework="custom", model=lambda x: x * 2.0, name="f"))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append((fr.pts, _value(fr))))
    p.link_chain(src, q, f, sink)
    p.set_restart_policy("f", mode="restart", backoff_ms=1, max_restarts=100, window_s=60.0)
    p.run(timeout=RUN_TIMEOUT)
    return got, p.recovery_stats(), dict(eng.injections)


def test_restart_policy_ledger_balances(monkeypatch):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    want, jrec, jinj = _restart_ledger(JAX)
    got, rec, inj = _restart_ledger(PORT)
    assert inj == jinj == {"invoke_raise": 6}
    assert rec == jrec
    assert rec["actions"]["restart_node"] == 6
    assert got == want and len(got) + rec["shed_total"] == 60


# -- lifecycle ----------------------------------------------------------------

@pytest.mark.parametrize("pkg", BOTH)
def test_stop_mid_stream_and_restart(monkeypatch, pkg):
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    got = []
    p = pkg.nns.Pipeline(name="lcyc")
    src = p.add(pkg.DataSrc(data=[_vec(i) for i in range(2000)], name="s"))
    q = p.add(pkg.Queue(max_size_buffers=8, name="q"))
    p.link_chain(src, q, p.add(pkg.TensorSink(callback=got.append, name="out")))
    p.start()
    deadline = time.monotonic() + 60
    while not got and time.monotonic() < deadline:
        time.sleep(0.001)
    p.stop()  # mid-stream: the lanes and their tasks end cleanly
    assert p._lanes is None and got
    assert not any(t.name.startswith("lane:") and t.is_alive() for t in threading.enumerate())
    n1 = len(got)
    src.data = [_vec(i) for i in range(16)]
    p.start()  # a fresh start builds a fresh runtime
    try:
        assert p._lanes is not None
        assert p.wait(RUN_TIMEOUT)
    finally:
        p.stop()
    if pkg is JAX:
        # the JAX package leaves a stopped source's stop event set, so its
        # second start ends the stream at once (its own case asserts only >=)
        assert len(got) >= n1
        return
    assert len(got) == n1 + 16
    assert [_value(f) for f in got[n1:]] == [float(i) for i in range(16)]


# -- slice 1 at a small width under lanes=2 -----------------------------------

NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
SIZE, CLASSES, FRAMES = 64, 10, 8


def _slice(nns, labels, model, device_kw=""):
    p = nns.parse_launch(
        f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} pattern=random seed=3 ! "
        f"tensor_converter ! tensor_transform mode=arithmetic option={NORMALIZE} "
        f"acceleration=pallas{device_kw} ! tensor_upload ! queue max-size-buffers=4 ! "
        f"tensor_filter framework={'torch' if nns is tnns else 'jax'} name=f ! "
        f"tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out collect=true")
    p["f"].model = model
    logits = []
    p["f"].push = (lambda push: lambda frame, pad_name=None: (
        logits.append((frame.pts, np.asarray(frame.tensor(0)).copy())), push(frame, pad_name)))(
            p["f"].push)
    p.run(timeout=300)
    return p["out"].frames, logits, p


def test_slice_under_lanes_matches_jax(monkeypatch, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    jmodel = jm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                                int8_head=True)
    model = tm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                               params=jax.tree_util.tree_map(np.asarray, jmodel.params),
                               int8_head=True, device="cpu")
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "0")
    _, thread_logits, _ = _slice(tnns, labels, model, " device=cpu")
    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", "2")
    want, jlogits, _ = _slice(jnns, labels, jmodel)
    got, logits, p = _slice(tnns, labels, model, " device=cpu")
    assert p._lanes is None and p.state == "STOPPED"
    assert len(got) == len(want) == FRAMES
    assert [f.pts for f in got] == [f.pts for f in want] == sorted(f.pts for f in got)
    assert [f.meta["label_index"] for f in got] == [f.meta["label_index"] for f in want]
    for (pts, g), (jpts, w) in zip(logits, jlogits):
        assert pts == jpts
        # the bf16 trunk may round differently in the two frameworks
        # (tests/test_torch_mobilenet.py's tolerance)
        np.testing.assert_allclose(g, w, atol=0.15)
    # the port's logits under the lanes equal its thread mode's bit for bit
    assert [pts for pts, _ in logits] == [pts for pts, _ in thread_logits]
    assert all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
               for (_, a), (_, b) in zip(logits, thread_logits))
    assert isinstance(got[0].tensor(0), torch.Tensor)
