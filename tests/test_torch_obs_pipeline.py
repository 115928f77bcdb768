"""The port's tracers, spans, ``Pipeline.stats`` and ``Pipeline.to_dot``
against the JAX package's, on the CPU.

One launch string, ``videotestsrc num-buffers=16 ! tensor_converter !
tensor_transform (normalize) ! queue ! tensor_filter (MobileNet-v2 width
0.35, 32x32, 10 classes, the JAX model's own params) ! tensor_decoder !
tensor_sink``, runs through both packages with the ``latency``, ``stats``,
``drops``, ``copies`` and ``spans`` tracers attached; the port runs with
``device=cpu``.  ``stats()`` has the same keys and per-element frame
counts, the latency tracer the same count, each frame the same ordered
spans (names and categories), and ``to_dot()`` the same text.  Two
differences are named where they show: the JAX package records its
negotiation compile as a span on a ``warmup`` track (the port captures its
graphs during negotiation with no span: its device lane is not ported),
and the copies the upload stages (the port stages every host frame it
moves to the card, the JAX package only a strided one).

The rest holds the hook sites and the pipeline's observability surface to
the reference's behaviour: leaky-queue accounting, the env-driven tracers
and scrape endpoint, dot and flight dumps, profiling through the conf,
the segment hook, ``merge_context``, the Chrome trace and the waterfall.
"""

import collections
import json
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.elements.queue import Queue as JaxQueue
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JaxDataSrc
from nnstreamer_tpu.elements.upload import TensorUpload as JaxUpload
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.obs import hooks as jhooks
from nnstreamer_tpu.obs import spans as jspans
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.queue import Queue
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.elements.upload import TensorUpload
from nnstreamer_tpu_torch.graph.pipeline import PipelineError
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.obs import export, hooks, spans
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.obs.tracers import StatsTracer
from nnstreamer_tpu_torch.utils import profiling

SIZE, CLASSES, FRAMES = 32, 10, 16
TRACERS = ("latency", "stats", "drops", "copies", "spans")
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
SLICE = (
    "videotestsrc name=src num-buffers={n} width={size} height={size} pattern=random "
    "seed=3 ! tensor_converter name=conv ! "
    "tensor_transform name=tr mode=arithmetic option=" + NORMALIZE + " acceleration=pallas ! "
    "queue name=q max-size-buffers=16 ! tensor_filter framework=jax name=f ! "
    "tensor_decoder name=dec mode=image_labeling ! tensor_sink name=out collect=true"
)


def port_string(desc: str) -> str:
    desc = desc.replace("framework=jax", "framework=torch")
    return re.sub(r"(tensor_transform)(\s)", r"\1 device=cpu\2", desc)


@pytest.fixture(autouse=True)
def _reset_port_obs():
    """The port's process-global obs state, reset as ``tests/conftest.py``
    resets the JAX package's; the flight recorder also before the test, in
    case a test of another file left records in it on this worker."""
    spans.reset()
    yield
    hooks.clear()
    spans.reset()
    profiling.reset()
    profiling.enable(False)
    export.shutdown_server()
    with export._stats_lock:
        export._stats_providers.clear()


@pytest.fixture(scope="module")
def models():
    jax_model = jm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                                   int8_head=True)
    port_model = tm.build_quantized(
        num_classes=CLASSES, width_mult=0.35, image_size=SIZE, int8_head=True,
        params=jax.tree_util.tree_map(np.asarray, jax_model.params), device="cpu")
    return jax_model, port_model


def _run_both(models, desc, tracers=TRACERS, seg=None):
    jax_model, port_model = models
    runs = []
    for pkg, d, model in ((jnns, desc, jax_model), (tnns, port_string(desc), port_model)):
        p = pkg.parse_launch(d)
        p["f"].model = model
        if seg is not None:
            p.segment_compile = seg
        for name in tracers:
            p.attach_tracer(name)
        p.run(timeout=300)
        runs.append((p, p.flight_snapshot()))
    return runs


def _frame_spans(records):
    """Per frame (trace id), its spans and instants in start order, as
    (name, category); frames in the order of their first record."""
    by_trace = collections.defaultdict(list)
    for r in records:
        if r[0] in ("X", "i") and r[6]:
            by_trace[r[6]].append(r)
    return [[(r[4], r[5]) for r in sorted(recs, key=lambda r: r[1])]
            for recs in sorted(by_trace.values(), key=lambda recs: min(r[1] for r in recs))]


def test_traced_slice_matches_reference(models):
    (jp, jrec), (tp, trec) = _run_both(models, SLICE.format(n=FRAMES, size=SIZE))
    js, ts = jp.stats(), tp.stats()
    assert set(ts) == set(js) == {"tracers"}
    assert set(ts["tracers"]) == set(js["tracers"]) == set(TRACERS)
    per_element = {k: v["frames"] for k, v in ts["tracers"]["stats"].items()}
    assert per_element == {k: v["frames"] for k, v in js["tracers"]["stats"].items()}
    assert per_element == {"src": FRAMES, "conv": FRAMES, "q": FRAMES, "f": FRAMES,
                           "dec": FRAMES}
    assert {k: v["bytes"] for k, v in ts["tracers"]["stats"].items()} == \
        {k: v["bytes"] for k, v in js["tracers"]["stats"].items()}
    lat, jlat = ts["tracers"]["latency"], js["tracers"]["latency"]
    assert set(lat) == set(jlat) == {"src->out"}
    assert lat["src->out"]["count"] == jlat["src->out"]["count"] == FRAMES > 0
    assert ts["tracers"]["drops"] == js["tracers"]["drops"] == {}
    # no upload in this string: neither package copies on the host
    assert ts["tracers"]["copies"] == js["tracers"]["copies"]
    # the JAX package's one extra record: its negotiation compile, a span on
    # a "warmup" track outside every frame's trace
    extra = collections.Counter((r[3], r[0], r[4], r[5]) for r in jrec) \
        - collections.Counter((r[3], r[0], r[4], r[5]) for r in trec)
    assert extra == collections.Counter({("warmup", "X", "compile", "compile"): 1})
    frames = _frame_spans(trec)
    assert frames == _frame_spans(jrec)
    assert len(frames) == FRAMES and frames[0] == [
        ("src.push", "source"), ("conv", "dispatch"), ("f", "dispatch"), ("dec", "dispatch"),
        ("out", "dispatch")]
    assert tp.to_dot() == jp.to_dot()
    assert [f.meta["label"] for f in tp["out"].frames] == \
        [f.meta["label"] for f in jp["out"].frames]


def test_chrome_trace_and_waterfall_match_reference(models):
    (jp, jrec), (tp, trec) = _run_both(models, SLICE.format(n=4, size=SIZE),
                                       tracers=("spans",))
    doc = json.loads(json.dumps(spans.chrome_trace(trec, process_name="obs")))
    jdoc = jspans.chrome_trace(jrec, process_name="obs")
    phases = collections.Counter(e["ph"] for e in doc["traceEvents"])
    jphases = collections.Counter(e["ph"] for e in jdoc["traceEvents"])
    # the reference's compile span and its "warmup" thread row
    assert phases + collections.Counter({"X": 1, "M": 1}) == jphases
    assert phases["s"] == phases["f"] == 4  # one flow per frame, across the queue
    threads = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert threads == {"src:src", "queue:q"}
    assert spans.waterfall(trec).count("trace ") == jspans.waterfall(jrec).count("trace ") == 4


class TestLeakyQueue:
    """Frames in = frames out + drops, in both packages, whichever end leaks."""

    @pytest.mark.parametrize("leaky", ["downstream", "upstream"])
    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_frames_in_equal_frames_out_plus_drops(self, pkg, leaky):
        n = 40
        data = [np.full((4,), i, np.float32) for i in range(n)]
        got = []

        def slow(frame):
            time.sleep(0.005)
            got.append(frame)

        if pkg == "port":
            p = tnns.Pipeline(name="leak")
            src = p.add(DataSrc(data=[torch.from_numpy(x) for x in data], name="s"))
            q = p.add(Queue(max_size_buffers=2, leaky=leaky, name="q"))
            sink = p.add(TensorSink(callback=slow, name="out"))
        else:
            p = jnns.Pipeline(name="leak")
            src = p.add(JaxDataSrc(data=data, name="s"))
            q = p.add(JaxQueue(max_size_buffers=2, leaky=leaky, name="q"))
            sink = p.add(JaxSink(callback=slow, name="out"))
        p.link_chain(src, q, sink)
        for name in ("stats", "drops"):
            p.attach_tracer(name)
        p.run(timeout=60)
        tr = p.stats()["tracers"]
        frames_in = tr["stats"]["s"]["frames"]
        drops = tr["drops"].get("q", {}).get(f"queue_{leaky}", 0)
        assert frames_in == n
        assert drops == q.dropped > 0
        assert frames_in == len(got) + drops


def test_upload_copies_differ_by_design():
    """The JAX package's upload copies a strided host frame into a staging
    buffer and sends a contiguous one as it is; the port's copies every
    host frame it moves to the card into a pinned slot (one ``copy`` a
    tensor; ``tests/test_torch_upload_wait.py`` counts them on the card)
    and, on the CPU, moves nothing.  Each package's tracer reports its own
    truth: here 3 copies in the JAX package's run, none in the port's."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    frames = [x.T, np.ascontiguousarray(x.T), x.T, x.T]  # three strided
    counts = {}
    for pkg, src, up, sink in (
            ("jax", JaxDataSrc(data=frames, name="s"), JaxUpload(name="u"), JaxSink(name="out")),
            ("port", DataSrc(data=[torch.from_numpy(np.asarray(f)) for f in frames], name="s"),
             TensorUpload(name="u"), TensorSink(name="out"))):
        p = (jnns if pkg == "jax" else tnns).Pipeline(name="up")
        p.link_chain(*p.add(src, up, sink))
        if pkg == "port":
            up._target_device = lambda: torch.device("cpu")
        p.attach_tracer("copies")
        p.run(timeout=60)
        counts[pkg] = p.stats()["tracers"]["copies"]
    assert counts["jax"]["elements"]["u"]["copies"] == 3
    assert counts["jax"]["frames"] == counts["port"]["frames"] == 4
    assert counts["port"]["elements"] == {} and counts["port"]["bytes_per_frame"] == 0.0


def _simple(pkg, name="obs_test"):
    """The reference's ``simple_pipeline``: five frames through a custom
    filter that doubles them."""
    data = [np.full(4, i, np.float32) for i in range(5)]
    if pkg is tnns:
        p = tnns.Pipeline(name=name)
        src = p.add(DataSrc(data=[torch.from_numpy(d) for d in data], name="s"))
        filt = p.add(TensorFilter(framework="custom", model=lambda x: x * 2, name="double"))
        sink = p.add(TensorSink(name="out"))
    else:
        p = jnns.Pipeline(name=name)
        src = p.add(JaxDataSrc(data=data, name="s"))
        filt = p.add(JaxFilter(framework="custom", model=lambda x: x * 2, name="double"))
        sink = p.add(JaxSink(name="out"))
    p.link_chain(src, filt, sink)
    return p


class TestConfActivation:
    def test_env_driven_tracers(self, monkeypatch):
        """The reference's case (``tests/test_observability.py``)."""
        monkeypatch.setenv("NNSTPU_TRACERS", "latency;stats")
        stats = {}
        for pkg in (tnns, jnns):
            p = _simple(pkg)
            p.run(timeout=30)
            tr = p.stats()["tracers"]
            assert set(tr) == {"latency", "stats"}
            (key, s), = tr["latency"].items()
            assert s["count"] == 5
            p.run(timeout=30)  # a second run attaches no duplicate
            assert [t.name for t in p.tracers] == ["latency", "stats"]
            stats[pkg.__name__] = {k: v["frames"] for k, v in tr["stats"].items()}
        assert stats["nnstreamer_tpu_torch"] == stats["nnstreamer_tpu"]

    def test_scrape_endpoint_serves_exposition(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TRACERS", "latency;stats")
        monkeypatch.setenv("NNSTPU_METRICS_PORT", "0")  # ephemeral bind
        p = _simple(tnns, name="scraped")
        p.run(timeout=30)
        server = export._server
        assert server is not None
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode("utf-8")
        assert 'nnstpu_e2e_latency_ms_count{pipeline="scraped",src=' in body
        assert "nnstpu_element_frames_total" in body
        url = server.url.replace("/metrics", "/stats.json")
        with urllib.request.urlopen(url, timeout=10) as resp:
            doc = json.loads(resp.read())
        assert doc["scraped"]["tracers"]["latency"] and doc["health"]["status"] == "ok"

    def test_conf_enables_profiling_and_stats(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_COMMON_ENABLE_PROFILING", "true")
        profiling.record("not_in_this_pipeline", 123)
        p = _simple(tnns)
        p.run(timeout=30)
        stats = p.stats()
        assert stats["double"]["count"] == 5 and stats["double"]["p50_ms"] >= 0
        assert "not_in_this_pipeline" not in stats and "tracers" not in stats


class TestDumps:
    def test_playing_and_stopped_dots(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NNSTPU_COMMON_DUMP_DOT_DIR", str(tmp_path))
        _simple(tnns).run(timeout=30)
        for state in ("PLAYING", "STOPPED"):
            dot = (tmp_path / f"obs_test.{state}.dot").read_text()
            assert "digraph" in dot and "double" in dot

    def test_stopped_dump_annotated_with_live_stats(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NNSTPU_COMMON_DUMP_DOT_DIR", str(tmp_path))
        p = tnns.Pipeline(name="dot_ann")
        src = p.add(DataSrc(data=[torch.zeros(4) for _ in range(5)], name="s"))
        q = p.add(Queue(max_size_buffers=8, name="q"))
        p.link_chain(src, q, p.add(TensorSink(name="out")))
        p.attach_tracer(StatsTracer(registry=MetricsRegistry()))
        p.run(timeout=30)
        dot = (tmp_path / "dot_ann.STOPPED.dot").read_text()
        assert "5 frames" in dot and "depth" in dot, dot

    def test_error_dumps_dot_and_flight(self, tmp_path, monkeypatch):
        """A filter that raises mid-stream: the same hooks in both packages
        (state changes, the error), the ERROR dot, and the span recorder
        dumped as a Chrome trace."""
        monkeypatch.setenv("NNSTPU_COMMON_DUMP_DOT_DIR", str(tmp_path))
        monkeypatch.setenv("NNSTPU_OBS_FLIGHT_DUMP_DIR", str(tmp_path))
        monkeypatch.setenv("NNSTPU_TRACERS", "spans")

        def boom(x):
            if float(x.max()) > 0:  # negotiation probes with zeros
                raise RuntimeError("dot crash")
            return x

        seen = {}
        for pkg, bus in ((tnns, hooks), (jnns, jhooks)):
            got = seen[pkg.__name__] = []
            bus.connect("error", lambda p, n, e, got=got: got.append((n.name, type(e).__name__)))
            bus.connect("state_change", lambda p, a, b, got=got: got.append((a, b)))
            if pkg is tnns:
                p = tnns.Pipeline(name="dot_err")
                src = p.add(DataSrc(data=[torch.ones(4)], name="s"))
                filt = p.add(TensorFilter(framework="custom", model=boom, name="f"))
                sink = p.add(TensorSink(name="out"))
            else:
                p = jnns.Pipeline(name="dot_err_ref")
                src = p.add(JaxDataSrc(data=[np.ones(4, np.float32)], name="s"))
                filt = p.add(JaxFilter(framework="custom", model=boom, name="f"))
                sink = p.add(JaxSink(name="out"))
            p.link_chain(src, filt, sink)
            with pytest.raises(pkg.PipelineError, match="dot crash"):
                p.run(timeout=30)
            bus.clear()
        assert seen["nnstreamer_tpu_torch"] == seen["nnstreamer_tpu"]
        assert seen["nnstreamer_tpu_torch"][:2] == [("NULL", "PLAYING"), ("PLAYING", "ERROR")]
        assert (tmp_path / "dot_err.ERROR.dot").exists()
        doc = json.loads((tmp_path / "dot_err.error.trace.json").read_text())
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"pipeline_error", "f"} <= names


def test_hook_sites_fire_as_in_the_reference(models, tmp_path):
    """Every hook the port emits on the segment-compiled slice, in both
    packages: the same points with the same counts, and the same segment
    install and restore."""
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    desc = SLICE.format(n=4, size=SIZE).replace("mode=image_labeling",
                                                f"mode=image_labeling option1={labels}")
    counts, segments = {}, {}
    for bus, pkg in ((jhooks, "jax"), (hooks, "port")):
        seen = collections.Counter()
        segs = []
        for point in ("pad_push", "dispatch_enter", "dispatch_exit", "queue_push",
                      "queue_pop", "source_push", "source_spawn", "state_change",
                      "device_dispatch"):
            bus.connect(point, lambda *a, point=point: seen.update([point]))
        bus.connect("segment", lambda *a: segs.append(a))
        jax_model, port_model = models
        p = (jnns.parse_launch(desc) if pkg == "jax" else tnns.parse_launch(port_string(desc)))
        p["f"].model = jax_model if pkg == "jax" else port_model
        p.segment_compile = True
        p.run(timeout=300)
        bus.clear()
        counts[pkg], segments[pkg] = dict(seen), segs
    assert counts["port"] == counts["jax"]
    assert counts["port"]["device_dispatch"] == 4 and counts["port"]["source_spawn"] == 1
    assert segments["port"] == segments["jax"]
    assert [s[4] for s in segments["port"]] == ["install", "restore"]


def test_tracer_attached_while_playing_and_detached():
    p = tnns.Pipeline(name="live")
    data = [torch.full((4,), float(i)) for i in range(200)]
    src = p.add(DataSrc(data=data, name="s"))
    got = []

    def slow(frame):
        time.sleep(0.001)
        got.append(frame)

    p.link_chain(src, p.add(TensorSink(callback=slow, name="out")))
    p.start()
    try:
        tr = p.attach_tracer("stats")
        assert tr.active and hooks.enabled
        p.wait(60)
    finally:
        p.stop()
    assert not tr.active and not hooks.enabled
    assert 0 < tr.summary()["s"]["frames"] <= 200
    p.detach_tracer(tr)
    assert p.tracers == [] and "tracers" not in p.stats()


def test_failed_start_leaves_no_hook_connected():
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    p = tnns.Pipeline(name="bad")
    p.link_chain(*p.add(  # int64 has no kernel: negotiation fails
        DataSrc(data=[torch.zeros(3, dtype=torch.int64)], name="s"),
        TensorTransform(device="cpu", mode="arithmetic", option="add:1", acceleration="pallas"),
        TensorSink(name="out")))
    p.attach_tracer("latency")
    with pytest.raises(tnns.NegotiationError):
        p.start()
    assert hooks.enabled is False


def test_merge_context_matches_reference():
    """Only ``tensor_mux`` and ``tensor_dynbatch`` call it in the JAX
    package, neither of them ported yet: the same two frames, one with a
    flow pending from another thread, merged in both packages."""
    import threading

    out = {}
    for mod, frame_cls in ((spans, tnns.Frame), (jspans, jnns.Frame)):
        mod.reset()
        mod.enable()
        frames = [frame_cls.of(np.zeros(2, np.float32)) for _ in range(3)]
        for f in frames[:2]:
            f.meta[mod.META_KEY] = mod.new_context()
        frames[0].meta[mod.META_KEY][2:] = [7, "elsewhere"]  # a pending flow
        meta = {}
        worker = threading.Thread(target=mod.merge_context, args=(frames, meta, "batch"),
                                  name="merger")
        worker.start()
        worker.join(10)
        recs = mod.snapshot()
        ctx = meta[mod.META_KEY]
        parents = meta[mod.PARENTS_KEY]
        first = frames[0].meta[mod.META_KEY]
        out[mod.__name__] = dict(
            records=[(r[0], r[3], r[4], r[5], r[8] == parents[0][1]) for r in recs],
            parents=[p == (f.meta[mod.META_KEY][0], f.meta[mod.META_KEY][1])
                     for p, f in zip(parents, frames)],
            trace=ctx[0] == first[0], fresh=ctx[1] not in (p[1] for p in parents),
            flow_closed=first[2:] == [0, None])
        mod.disable()
        meta = {}
        mod.merge_context(frames, meta, "batch")  # disabled: stamps nothing
        assert meta == {}
        mod.reset()
    assert out["nnstreamer_tpu_torch.obs.spans"] == out["nnstreamer_tpu.obs.spans"]
    assert out["nnstreamer_tpu.obs.spans"]["records"] == [
        ("f", "merger", "frame", "dataflow", False), ("i", "merger", "batch", "coalesce", True)]
