"""The port's device lane and utilization lane against the JAX package's.

The pure functions of ``obs/util.py`` give the reference's results on
seeded random intervals and costs; the ``device`` tracer on a CPU pipeline
leaves one ``device_exec`` span a dispatch and the reference tracer's
metric families; the capture accounting agrees with the backend's
``stats``.  Every test stops its tracers, so no reaper thread or collector
outlives it.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JDataSrc
from nnstreamer_tpu.obs import util as jutil
from nnstreamer_tpu.obs.device import DeviceTracer as JDeviceTracer
from nnstreamer_tpu.obs.metrics import MetricsRegistry as JRegistry
from nnstreamer_tpu_torch import conf as tconf
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend, TorchModel
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.node import Node
from nnstreamer_tpu_torch.obs import device as tdevice
from nnstreamer_tpu_torch.obs import hooks, spans
from nnstreamer_tpu_torch.obs import util as tutil
from nnstreamer_tpu_torch.obs.device import DeviceTracer, device_memory_snapshot, oldest_inflight
from nnstreamer_tpu_torch.obs.export import render_text
from nnstreamer_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_obs():
    yield
    hooks.clear()
    spans.reset()
    tutil.clear_costs()
    tutil.reset_wire_health()
    tdevice.reset_peak_watermarks()
    assert tdevice._event_timing == 0
    assert not any(t.name == "device:cuda" and t.is_alive() for t in threading.enumerate())


def _wait_for(cond, timeout=10.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _intervals(rng, n=40):
    starts = rng.integers(0, 10_000, n)
    lens = rng.integers(-5, 800, n)
    return [(int(s), int(s + d)) for s, d in zip(starts, lens)]


# -- pure functions against the reference ------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_interval_math_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ivs = _intervals(rng)
    assert tutil.merge_intervals(ivs) == jutil.merge_intervals(ivs)
    for t0, t1 in [(0, 10_000), (2_000, 3_000), (500, 500), (9_000, 12_000)]:
        assert tutil.busy_fraction(ivs, t0, t1) == jutil.busy_fraction(ivs, t0, t1)
    for gap in (1, 50, 400):
        assert tutil.idle_gaps(ivs, gap) == jutil.idle_gaps(ivs, gap)
        assert tutil.idle_gaps(ivs, gap, 0, 12_000) == jutil.idle_gaps(ivs, gap, 0, 12_000)
    assert tutil.idle_gaps([], 5, 0, 100) == jutil.idle_gaps([], 5, 0, 100)


@pytest.mark.parametrize("seed", range(6))
def test_roofline_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        flops = [None, 0, float(rng.uniform(1e6, 1e12))][int(rng.integers(0, 3))]
        nbytes = [None, 0, float(rng.uniform(1e3, 1e10))][int(rng.integers(0, 3))]
        dur = float(rng.choice([0.0, -1.0, rng.uniform(1e-6, 1.0)]))
        peaks = (float(rng.uniform(1, 1000)), float(rng.uniform(10, 4000)))
        assert tutil.roofline(flops, nbytes, dur, *peaks) == \
            jutil.roofline(flops, nbytes, dur, *peaks)


@pytest.mark.parametrize("seed", range(3))
def test_device_usage_equals_reference(seed):
    rng = np.random.default_rng(200 + seed)
    t, j = tutil.DeviceUsage(cap=16), jutil.DeviceUsage(cap=16)
    for s, e in _intervals(rng, 60):
        dev = f"cuda:{int(rng.integers(0, 2))}"
        t.add(dev, s, e)
        j.add(dev, s, e)
    assert t.devices() == j.devices()
    for dev in t.devices():
        assert t.intervals(dev) == j.intervals(dev)
    for window in (500, 5_000, 50_000):
        assert t.busy_fractions(window, 11_000) == j.busy_fractions(window, 11_000)


def test_cost_registry_equals_reference():
    for util in (tutil, jutil):
        util.clear_costs()
        util.register_cost("a", flops=2e9, bytes=4e6, bucket=1, model="m")
        util.register_cost("b", flops=0, bytes=None)
    try:
        assert tutil.cost_of("a") == jutil.cost_of("a")
        assert tutil.cost_of("b") == jutil.cost_of("b")
        assert tutil.cost_of("zz") is None and tutil.cost_of(None) is None
        assert tutil.cost_entries() == jutil.cost_entries()
    finally:
        jutil.clear_costs()


def test_wire_health_publish_equals_reference():
    reg_t, reg_j = MetricsRegistry(), JRegistry()
    health = {"put_150k_ms": 7.25, "dispatch_ms": 0.031}
    try:
        got = tutil.publish_wire_health(health, registry=reg_t)
        want = jutil.publish_wire_health(health, registry=reg_j)
        assert got["regime"] == want["regime"] == "slow"
        assert tutil.last_wire_health()["put_150k_ms"] == 7.25
        families = {m.name: (m.kind, m.labelnames) for m in reg_t.collect()}
        assert families == {m.name: (m.kind, m.labelnames) for m in reg_j.collect()}
        assert tutil.wire_regime(1.0) == jutil.wire_regime(1.0) == "fast"
        assert tutil.wire_regime(None) == "unknown"
    finally:
        jutil.reset_wire_health()


def test_probe_wire_health_needs_the_card():
    with pytest.raises(RuntimeError):
        tutil.probe_wire_health(n=1, device="cpu")


# -- peaks ---------------------------------------------------------------------


def test_peaks_by_device_name():
    assert tutil.peak_tflops(H100) == 989.0
    assert tutil.peak_gbs(H100) == 3350.0
    # no card, or a card not listed: the host row
    assert tutil.peak_tflops("cpu") == 0.5 and tutil.peak_gbs("cpu") == 40.0
    assert tutil.peak_tflops() == 0.5  # this process has no card
    ridge = tutil.roofline(1.0, 1.0, 1.0, tutil.peak_tflops(H100), tutil.peak_gbs(H100))["ridge"]
    assert ridge == round(989e12 / 3350e9, 3)


def test_peak_resolution_order(monkeypatch, tmp_path):
    ini = tmp_path / "nnstreamer_tpu.ini"
    ini.write_text("[obs]\npeak_tflops = 400\npeak_gbs = 2000\n")
    monkeypatch.setattr(tconf.conf, "_explicit_ini", str(ini))
    tconf.conf.refresh()
    try:
        assert tutil.peak_tflops(H100) == 400.0  # ini over the default
        assert tutil.peak_gbs(H100) == 2000.0
        monkeypatch.setenv("NNSTPU_PEAK_TFLOPS", "123.5")  # env over the ini
        # a malformed env value falls through to the card's default, as in
        # the JAX package
        monkeypatch.setenv("NNSTPU_PEAK_GBS", "bogus")
        assert tutil.peak_tflops(H100) == 123.5
        assert tutil.peak_gbs(H100) == 3350.0
        assert jutil.peak_gbs("tpu") == jutil.PEAK_GBS_DEFAULTS["tpu"]
    finally:
        monkeypatch.undo()
        tconf.conf.refresh()
    assert tutil.peak_tflops(H100) == 989.0


# -- the tracer on a CPU pipeline --------------------------------------------


def _chain(nns, datasrc, filt, sink, n, tracer):
    got = []
    p = nns.Pipeline(name="devlane")
    src = p.add(datasrc(data=[np.full(4, i, np.float32) for i in range(n)], name="s"))
    f = p.add(filt(framework="custom", model=lambda x: x * 2, name="f"))
    out = p.add(sink(name="out"))
    out.connect("new-data", got.append)
    p.link_chain(src, f, out)
    p.attach_tracer(tracer)
    p.run(timeout=60)
    return p, got


def test_device_exec_span_per_dispatch():
    reg = MetricsRegistry()
    tracer = DeviceTracer(registry=reg)
    p, got = _chain(tnns, DataSrc, TensorFilter, TensorSink, 6, tracer)
    assert len(got) == 6
    summ = tracer.summary()
    assert summ["dispatches"] == summ["completed"] == 6 and summ["dropped"] == 0
    assert summ["by_element"]["f"]["count"] == 6
    assert summ["by_device"]["cpu:0"]["count"] == 6
    assert summ["by_device"]["cpu:0"]["mfu"] is None  # no capture on the CPU: no cost
    doc = json.loads(json.dumps(spans.chrome_trace(spans.snapshot())))
    execs = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"] == "device_exec"]
    assert len(execs) == 6
    assert {e["args"]["element"] for e in execs} == {"f"}
    assert all("device_ms" not in e["args"] for e in execs)  # host outputs: no event pair
    text = render_text(reg)
    assert 'nnstpu_device_dispatches_total{pipeline="devlane",element="f"} 6' in text
    assert p["f"]._device_events is None
    assert oldest_inflight() is None
    assert not tdevice.event_timing()


def test_metric_families_equal_reference():
    reg_t, reg_j = MetricsRegistry(), JRegistry()
    _chain(tnns, DataSrc, TensorFilter, TensorSink, 3, DeviceTracer(registry=reg_t))
    jtracer = JDeviceTracer(registry=reg_j)
    _chain(jnns, JDataSrc, JFilter, JSink, 3, jtracer)
    assert _wait_for(lambda: jtracer.summary()["completed"] == 3)

    def families(reg):
        return {m.name: (m.kind, tuple(m.labelnames)) for m in reg.collect()}

    assert families(reg_t) == families(reg_j)
    assert "nnstpu_device_exec_seconds" in families(reg_t)


class _BlockingEvent:
    """A dispatch's end event whose completion the test controls."""

    def __init__(self, release):
        self._release = release

    def synchronize(self):
        self._release.wait()


def test_probe_queue_overflow_counted():
    reg = MetricsRegistry()
    p = tnns.Pipeline(name="ovf")
    node = p.add(Node(name="f"))
    tracer = DeviceTracer(registry=reg, capacity=1)
    p._tracers.append(tracer)
    tracer.start(p)
    release = threading.Event()
    frame = Frame.of(np.zeros(4, np.float32))
    t0 = time.perf_counter_ns()
    node._device_events = (None, _BlockingEvent(release))
    try:
        # the first probe: the reaper pops it and blocks on its event
        hooks.emit("device_dispatch", node, frame, (torch.zeros(4),), t0)
        assert _wait_for(lambda: tracer.summary()["inflight"] == 0)
        hooks.emit("device_dispatch", node, frame, (torch.zeros(4),), t0)  # fills the bound
        for _ in range(2):
            hooks.emit("device_dispatch", node, frame, (torch.zeros(4),), t0)
        summ = tracer.summary()
        assert summ["dropped"] == 2 and summ["dispatches"] == 2
        assert oldest_inflight() == (t0, "f")
        release.set()
        assert _wait_for(lambda: tracer.summary()["completed"] == 2)
        assert oldest_inflight() is None
        assert 'nnstpu_device_probe_dropped_total{pipeline="ovf"} 2' in render_text(reg)
    finally:
        release.set()
        tracer.stop()


def test_busy_fraction_while_playing_and_decay_after_stop(monkeypatch):
    env = dict(tconf.conf._environ, NNSTPU_OBS_BUSY_WINDOW_S="0.3")
    monkeypatch.setattr(tconf.conf, "_environ", env)
    reg = MetricsRegistry()
    tracer = DeviceTracer(registry=reg)
    seen = []
    p = tnns.Pipeline(name="busydecay")
    src = p.add(DataSrc(data=[np.zeros(4, np.float32)] * 4, name="s"))
    f = p.add(TensorFilter(framework="custom", model=lambda x: x, name="f"))
    out = p.add(TensorSink(name="out"))
    out.connect("new-data", lambda fr: seen.append(fr))
    p.link_chain(src, f, out)
    p.attach_tracer(tracer)
    p.start()
    try:
        assert p.wait(timeout=60)
        assert _wait_for(lambda: tracer.summary()["completed"] == 4)
        reg.collect()
        gauge = reg.get("nnstpu_device_busy_fraction")
        (_, child), = gauge.children()
        assert 0.0 < child.value <= 1.0
    finally:
        p.stop()

    def decayed():
        reg.collect()
        return all(c.value == 0.0 for _, c in gauge.children())

    assert _wait_for(decayed, timeout=5.0)

    def removed():
        reg.collect()  # the decay collector removes itself once its window has passed
        return tracer._busy_decay_handle is None

    assert _wait_for(removed, timeout=10.0)
    assert all(c.value == 0.0 for _, c in gauge.children())


def test_memory_snapshot_empty_on_cpu():
    assert device_memory_snapshot() == {}
    reg = MetricsRegistry()
    handle = tdevice.register_memory_gauges(reg)
    try:
        reg.collect()
        assert not reg.get("nnstpu_device_memory_bytes").children()
    finally:
        reg.remove_collector(handle)


# -- capture accounting -------------------------------------------------------


class _Entry:
    warmup_calls = 1
    capture_s = warmup_s = 0.0

    def __init__(self, fn, flops):
        self.fn = fn
        self.flops = flops
        self.static_out = (torch.zeros(4),)

    def run(self, xs):
        return (self.fn(*xs),)


def _capture(fn, in_spec, device):
    return _Entry(fn, flops=8.0 * in_spec.tensors[0].shape[0])


def _counts(result):
    metric = REGISTRY.get("nnstpu_compile_total")
    if metric is None:
        return 0
    for labels, child in metric.children():
        if labels == (result,):
            return child.value
    return 0


def test_compile_counters_equal_backend_stats():
    before = {r: _counts(r) for r in ("hit", "miss", "evict")}
    events = []
    hooks.connect("compile", lambda *a: events.append(a[2]))
    p = tnns.Pipeline(name="compiles")
    tracer = DeviceTracer(registry=MetricsRegistry())
    p._tracers.append(tracer)
    tracer.start(p)
    try:
        w = torch.full((1,), 2.0)
        model = TorchModel(apply=lambda params, x: x * params, params=w, device="cpu",
                           name="acc", input_spec=TensorsSpec.of(
                               TensorSpec(dtype=np.float32, shape=(None,))))
        be = TorchBackend()
        be.capture = _capture
        be.open(model, "compile_cache=1")

        def spec(n):
            return TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(n,)))

        be.reconfigure(spec(4))  # miss
        key4 = be.cost_key()
        be.reconfigure(spec(4))  # hit
        be.reconfigure(spec(6))  # miss, evicts (4,)
        key6 = be.cost_key()
    finally:
        tracer.stop()
    stats = be.stats
    assert (stats["captures"], stats["hits"], stats["evictions"]) == (2, 1, 1)
    summ = tracer.summary()["compiles"]
    assert summ == {"hit": stats["hits"], "miss": stats["captures"],
                    "evict": stats["evictions"], "persist_hit": 0}
    assert events == ["miss", "hit", "evict", "miss"]  # the reference's order
    assert {r: _counts(r) - before[r] for r in before} == {"hit": 1, "miss": 2, "evict": 1}
    # each capture's cost: its FLOPs and parameter + input + output bytes
    assert tutil.cost_of(key4)["flops"] == 32.0 and tutil.cost_of(key6)["flops"] == 48.0
    assert tutil.cost_of(key6)["bytes"] == 4 + 6 * 4 + 4 * 4
    assert key4 != key6


def test_capture_graph_counts_flops_of_its_first_warmup_call(monkeypatch):
    """``capture_graph`` counts the FLOPs of one call over the first eager
    warm-up call (the capture itself needs the card: stubbed here)."""
    from nnstreamer_tpu_torch.backends import torch_backend as tb

    calls = []

    def fake_capture_calls(fn, device, warmup_calls):
        for _ in range(warmup_calls):
            calls.append(fn())
        return "graph", fn(), 0.0, 0.0

    monkeypatch.setattr(tb, "capture_calls", fake_capture_calls)
    w = torch.randn(16, 8)
    spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(3, 16)))
    entry = tb.capture_graph(lambda x: x @ w, spec, torch.device("cpu"), warmup_calls=3)
    assert entry.flops == 2 * 3 * 16 * 8
    assert len(calls) == 3
