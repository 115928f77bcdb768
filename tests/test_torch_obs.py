"""The port's hook bus, metrics, profiling and exposition against the JAX
package's ``obs``.

The same seeded numpy samples go through both packages' pure functions
(``quantile_rank``, ``summarize_ns``, ``histogram_deltas``,
``histogram_quantile``, ``parse_buckets``, ``parse_tracer_names``) and must
give equal results; two registries fed the same observations must render
the same Prometheus text byte for byte; the hook table must be the
reference's, point for point.  The bus, the registry, profiling and the
scrape endpoint are then exercised on the port alone, as the reference's
``tests/test_observability.py`` exercises its own.  JAX stays on the CPU
(``tests/conftest.py``); nothing here needs a card.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import export as jexport
from nnstreamer_tpu.obs import hooks as jhooks
from nnstreamer_tpu.obs import metrics as jmetrics
from nnstreamer_tpu.obs import tracers as jtracers
from nnstreamer_tpu.utils import profiling as jprofiling
from nnstreamer_tpu_torch import Frame, obs
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.graph.node import Node
from nnstreamer_tpu_torch.obs import export, hooks, metrics, spans, tracers
from nnstreamer_tpu_torch.obs.export import MetricsServer, render_text
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _reset_port_obs():
    """The port's process-global obs state, reset as ``tests/conftest.py``
    resets the JAX package's."""
    yield
    hooks.clear()
    spans.reset()
    profiling.reset()
    profiling.enable(False)
    export.shutdown_server()
    for lock, providers in ((export._health_lock, export._health_providers),
                            (export._degraded_lock, export._degraded_providers),
                            (export._warming_lock, export._warming_providers),
                            (export._stats_lock, export._stats_providers)):
        with lock:
            providers.clear()
    with jexport._degraded_lock:
        jexport._degraded_providers.clear()
    with jexport._warming_lock:
        jexport._warming_providers.clear()


def _samples(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.lognormal(13, 1.2, n).astype(np.int64)]


# -- the hook table ------------------------------------------------------------


def test_hook_signatures_equal_the_reference():
    assert hooks.HOOK_SIGNATURES == jhooks.HOOK_SIGNATURES
    assert list(hooks.HOOK_SIGNATURES) == list(jhooks.HOOK_SIGNATURES)
    assert hooks.HOOKS == jhooks.HOOKS


class TestHookBus:
    def test_enabled_tracks_connections(self):
        assert hooks.enabled is False
        seen = []
        hooks.connect("pad_push", seen.append)
        assert hooks.enabled is True
        hooks.emit("pad_push", "x")  # nnslint: disable=hooks
        assert seen == ["x"]
        hooks.disconnect("pad_push", seen.append)
        assert hooks.enabled is False

    def test_connect_is_idempotent_and_clear_detaches(self):
        seen = []
        hooks.connect("queue_pop", lambda n, d: seen.append(d))
        fn = seen.append
        hooks.connect("rate_drop", fn)
        hooks.connect("rate_drop", fn)
        hooks.emit("rate_drop", 1)
        assert seen == [1]
        hooks.clear()
        assert hooks.enabled is False
        hooks.emit("rate_drop", 2)
        assert seen == [1]

    def test_unknown_hook_rejected(self):
        with pytest.raises(ValueError, match="unknown hook"):
            hooks.connect("nope", lambda: None)

    def test_raising_callback_is_detached_not_fatal(self):
        def bad(*a):
            raise RuntimeError("boom")

        hooks.connect("error", bad)
        hooks.emit("error", None, None, None)  # must not raise
        assert hooks.enabled is False  # bad callback auto-detached

    def test_disabled_hot_loop_overhead(self):
        """The reference's guard (``tests/test_observability.py``): with no
        tracer attached the hook gates add no measurable per-frame cost.
        2000 frames through a 3-node chain; the bound is generous (100 us
        a frame): it catches a regression to unconditional emission, not
        scheduler noise."""
        assert hooks.enabled is False
        a, b = Node(), Node()
        sink = TensorSink()
        ap = a.add_src_pad()
        b.add_sink_pad()
        bp = b.add_src_pad()
        ap.link(b.sink_pads["sink"])
        bp.link(sink.sink_pads["sink"])
        frame = Frame.of(torch.zeros((4,), dtype=torch.float32))
        n = 2000
        ap.push(frame)  # warm signature binding
        t0 = time.perf_counter_ns()
        for _ in range(n):
            ap.push(frame)
        per_frame_ns = (time.perf_counter_ns() - t0) / n
        assert per_frame_ns < 100_000, f"disabled hook bus costs {per_frame_ns:.0f} ns/frame"


# -- the pure functions, against the reference's --------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_quantile_rank_and_summarize_ns_match(seed, n):
    s = sorted(_samples(seed, n))
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert metrics.quantile_rank(s, q) == jmetrics.quantile_rank(s, q)
    assert profiling.summarize_ns(s) == jprofiling.summarize_ns(s)


def test_quantile_rank_of_nothing_raises_in_both():
    for mod in (metrics, jmetrics):
        with pytest.raises(ValueError, match="empty"):
            mod.quantile_rank([], 0.5)


@pytest.mark.parametrize("seed", range(4))
def test_histogram_deltas_and_quantile_match(seed):
    rng = np.random.default_rng(seed)
    buckets = (0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 25.0)
    regs = [MetricsRegistry(), jmetrics.MetricsRegistry()]
    hs = [r.histogram("lat_ms", "l", labelnames=("el",), buckets=buckets) for r in regs]
    prevs = [{}, {}]
    for window in range(3):
        for v, el in zip(rng.exponential(2.0, 200), rng.integers(0, 3, 200)):
            for h in hs:
                h.observe(float(v), el=f"e{el}")
        got = [m.histogram_deltas(h, prev, label_filter={"el": "e1"} if window else None)
               for m, h, prev in zip((metrics, jmetrics), hs, prevs)]
        assert got[0] == got[1] and got[0]
        for q in (0.5, 0.9, 0.99, 1.0):
            assert metrics.histogram_quantile(q, got[0]) == jmetrics.histogram_quantile(q, got[1])
    assert metrics.histogram_quantile(0.5, []) == jmetrics.histogram_quantile(0.5, []) == 0.0
    assert metrics.histogram_deltas(None, {}) == []


@pytest.mark.parametrize("value", ["", "  ", "0.1, 1; 10", "5,1,5,0.25", "1e-3;2.5e3",
                                   "3", "7;7;7"])
def test_parse_buckets_matches(value):
    assert metrics.parse_buckets(value) == jmetrics.parse_buckets(value)


def test_parse_buckets_refuses_words_in_both():
    for mod in (metrics, jmetrics):
        with pytest.raises(ValueError):
            mod.parse_buckets("1,fast")


@pytest.mark.parametrize("value", ["latency;stats", " latency, drops ", "", ";;",
                                   "latency;stats;drops;copies;spans", "spans,"])
def test_parse_tracer_names_matches(value):
    assert tracers.parse_tracer_names(value) == jtracers.parse_tracer_names(value)


@pytest.mark.parametrize("env,want", [(None, metrics.LATENCY_BUCKETS_MS), ("1,10", (1.0, 10.0)),
                                      ("nonsense", metrics.LATENCY_BUCKETS_MS)])
def test_configured_latency_buckets_match(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("NNSTPU_METRICS_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("NNSTPU_METRICS_BUCKETS", env)
    with pytest.warns(UserWarning) if env == "nonsense" else _no_warning():
        got = metrics.configured_latency_buckets()
    assert got == want
    with pytest.warns(UserWarning) if env == "nonsense" else _no_warning():
        assert jmetrics.configured_latency_buckets() == got


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("env", [{}, {"NNSTPU_TRACERS": "latency;stats"},
                                 {"NNSTPU_COMMON_TRACERS": "drops"},
                                 {"NNSTPU_METRICS_PORT": "0"},
                                 {"NNSTPU_COMMON_METRICS_PORT": "9464"}])
def test_configured_tracers_and_port_match(monkeypatch, env):
    from nnstreamer_tpu import obs as jobs

    for name in ("NNSTPU_TRACERS", "NNSTPU_COMMON_TRACERS", "NNSTPU_METRICS_PORT",
                 "NNSTPU_COMMON_METRICS_PORT"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert obs.configured_tracers() == jobs.configured_tracers()
    assert obs.configured_metrics_port() == jobs.configured_metrics_port()


# -- the registry and its exposition ---------------------------------------------


def _feed(reg, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    c = reg.counter("nnstpu_element_frames_total", "Frames pushed out of each element src pad",
                    labelnames=("pipeline", "element", "pad"))
    g = reg.gauge("nnstpu_queue_depth", "Frame-queue occupancy (buffers currently queued)",
                  labelnames=("pipeline", "element"))
    h = reg.histogram("nnstpu_e2e_latency_ms",
                      "End-to-end per-frame source->sink latency (milliseconds)",
                      labelnames=("pipeline", "src", "sink"))
    for i in range(50):
        c.inc(1, pipeline="p", element=f"e{i % 3}", pad="src")
        g.set(int(rng.integers(0, 17)), pipeline="p", element="q")
        h.observe(float(rng.exponential(3.0)), pipeline="p", src="s", sink='o"ut\n')
    reg.counter("plain_total", "no labels").inc(2.5)
    reg.gauge("big").set(1e16)
    reg.gauge("nan").set(float("nan"))


def test_render_text_matches_the_reference_byte_for_byte():
    port, ref = MetricsRegistry(), jmetrics.MetricsRegistry()
    _feed(port)
    _feed(ref)
    assert render_text(port) == jexport.render_text(ref)
    assert render_text(MetricsRegistry()) == jexport.render_text(jmetrics.MetricsRegistry()) == ""


def test_exposition_golden():
    """The reference's golden (``tests/test_observability.py``), on the
    port's registry."""
    reg = MetricsRegistry()
    reg.counter("nns_frames_total", "Frames seen", labelnames=("element",)).inc(5, element="q0")
    reg.gauge("nns_depth", "Queue depth").set(2)
    h = reg.histogram("nns_lat_ms", "Latency", buckets=(1.0, 2.5))
    h.observe(0.5)
    h.observe(2.0)
    h.observe(9.75)
    expected = "\n".join([
        '# HELP nns_depth Queue depth',
        '# TYPE nns_depth gauge',
        'nns_depth 2',
        '# HELP nns_frames_total Frames seen',
        '# TYPE nns_frames_total counter',
        'nns_frames_total{element="q0"} 5',
        '# HELP nns_lat_ms Latency',
        '# TYPE nns_lat_ms histogram',
        'nns_lat_ms_bucket{le="1"} 1',
        'nns_lat_ms_bucket{le="2.5"} 2',
        'nns_lat_ms_bucket{le="+Inf"} 3',
        'nns_lat_ms_sum 12.25',
        'nns_lat_ms_count 3',
    ]) + "\n"
    assert render_text(reg) == expected


class TestMetricsRegistry:
    def test_counter_gauge_labels(self):
        reg = MetricsRegistry()
        c = reg.counter("c_total", "help", labelnames=("el",))
        c.inc(2, el="a")
        c.labels(el="a").inc()
        assert c.labels(el="a").value == 3
        with pytest.raises(ValueError, match="labels"):
            c.inc(1)
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("c_total")
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("d").inc(-1)

    def test_histogram_buckets_and_rebucketing(self):
        reg = MetricsRegistry()
        h = reg.histogram("h_ms", buckets=(1.0, 5.0))
        for v in (0.5, 3.0, 100.0):
            h.observe(v)
        assert h.labels().snapshot() == ([(1.0, 1), (5.0, 2), (float("inf"), 3)], 103.5, 3)
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("h_ms", buckets=(2.0,))

    def test_collector_runs_at_collect_time_and_a_bad_one_is_logged(self):
        reg = MetricsRegistry()
        state = {"v": 1}
        reg.add_collector(lambda: reg.gauge("live").set(state["v"]))
        bad = reg.add_collector(lambda: 1 / 0)
        assert "live 1" in render_text(reg)
        state["v"] = 42
        assert "live 42" in render_text(reg)
        reg.remove_collector(bad)
        reg.reset()
        assert render_text(reg) == ""

    def test_exemplars_carry_the_span_context(self):
        reg = MetricsRegistry()
        h = reg.histogram("x_ms", buckets=(1.0,))
        spans.enable()
        tok = spans.span_begin(trace_id=0xABC)
        h.observe(0.5)
        spans.span_end(tok, "work")
        h.observe(3.0)  # outside any span: no exemplar
        text = render_text(reg, exemplars=True)
        assert 'x_ms_bucket{le="1"} 1 # {trace_id="abc"} 0.5 ' in text
        assert 'x_ms_bucket{le="+Inf"} 2\n' in text


# -- profiling -------------------------------------------------------------------


def test_profiling_records_and_summarizes():
    assert profiling.enabled() is False
    with profiling.profiled():
        assert profiling.enabled() is True
    assert profiling.enabled() is False
    for ns in _samples(5, 9):
        profiling.record("f", ns)
        jprofiling.record("f", ns)
    assert profiling.stats() == jprofiling.stats()
    hist = metrics.REGISTRY.get("nnstpu_node_invoke_latency_ms")
    assert hist.labels(node="f").count >= 9
    profiling.reset()
    assert profiling.stats() == {}


def test_block_outputs_on_host_tensors_returns_at_once():
    """A CPU tensor is done when returned: nothing to wait for (on the card
    ``tests/test_torch_compile_ahead.py`` holds the wait to the replay)."""
    profiling.block_outputs((torch.ones(3), np.zeros(2)))
    profiling.block_outputs(())


# -- the scrape endpoint ---------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read().decode("utf-8")


def test_metrics_server_endpoints():
    reg = MetricsRegistry()
    reg.counter("hits_total").inc(3)
    export.register_stats("p", lambda: {"f": {"count": 2}})
    export.register_stats("bad", lambda: 1 / 0)
    with MetricsServer(port=0, registry=reg) as srv:
        base = f"http://{srv.host}:{srv.port}"
        assert srv.url == base + "/metrics"
        for path in ("/metrics", "/"):
            status, ctype, body = _get(base + path)
            assert status == 200 and ctype.startswith("text/plain") and "hits_total 3" in body
        status, _, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body) == {"status": "ok", "failures": {},
                                                      "degraded": {}}
        status, _, body = _get(base + "/stats.json")
        doc = json.loads(body)
        assert status == 200 and doc["p"] == {"f": {"count": 2}}
        assert doc["bad"]["error"].startswith("ZeroDivisionError")
        assert doc["health"]["status"] == "ok"
        status, _, body = _get(base + "/alerts")
        assert status == 200 and json.loads(body) == {"objectives": {}, "firing": []}
        status, _, body = _get(base + "/trace.json")  # the collector's feed
        assert status == 200 and {"process", "pid", "clock_ns", "records"} <= set(json.loads(body))
        status, _, body = _get(base + "/trace.json?clock=1")
        assert status == 200 and set(json.loads(body)) == {"process", "pid", "clock_ns"}
        assert _get(base + "/nope")[0] == 404
        export.register_health("wd", lambda: (False, "queue q wedged"))
        status, _, body = _get(base + "/healthz")
        assert status == 503 and json.loads(body)["failures"] == {"wd": "queue q wedged"}
    assert srv._thread is None


@pytest.mark.parametrize("providers", [
    {}, {"degraded": {"be": "cpu fallback"}}, {"warming": {"f": "2 of 5 geometries"}},
    {"health": {"wd": (False, "")}, "degraded": {"be": "x"}},
    {"health": {"wd": (True, "")}, "warming": {"f": ""}},
    {"health": {"bad": None}}])
def test_health_document_matches_the_reference(providers):
    def fn(v):
        if v is None:
            return lambda: 1 / 0
        return lambda: v

    for mod in (export, jexport):
        for kind, reg in (("health", mod.register_health), ("degraded", mod.register_degraded),
                          ("warming", mod.register_warming)):
            for name, v in providers.get(kind, {}).items():
                reg(name, fn(v))
    got, want = export.health_document(), jexport.health_document()
    for mod in (export, jexport):
        for name in providers.get("health", {}):
            mod.unregister_health(name)
    assert got == want


def test_ensure_server_is_a_process_singleton():
    a = export.ensure_server(0)
    b = export.ensure_server(0)
    assert a is b and a._thread.name == "nnstpu-metrics" and a._thread.daemon
    assert _get(a.url)[0] == 200
    export.shutdown_server()
    assert export._server is None
