"""The port's pipeline watchdog and circuit breaker against the JAX
package's, in one process.

Case for case with ``tests/test_device_obs.py::TestWatchdog`` and
``tests/test_faults.py::TestWatchdogRecovery``: a stalled source flips
``/healthz`` to 503 and writes the stall dump, a wedged queue and an
overdue device dispatch are judged, a posted error marks the pipeline
unhealthy, recovery flips everything back and resets the budget, the
escalation budget caps attempts per target, and an overdue device trips
the circuit breakers.  Where a scenario is deterministic both packages run
it and their ledgers are compared.

No test sets ``NNSTPU_TRACERS`` or an ``NNSTPU_OBS_*`` variable (the JAX
package reads the same names): a conf-driven case gives the port's
``conf`` a copy of the environment.  No case is timed: each waits on a
condition with a generous timeout, and each stops its tracers and leaves
no ``watchdog:*`` or reaper thread behind.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu import faults as jfaults
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements.queue import Queue as JQueue
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JDataSrc
from nnstreamer_tpu.graph.node import SourceNode as JSourceNode
from nnstreamer_tpu.obs import hooks as jhooks
from nnstreamer_tpu.obs import spans as jspans
from nnstreamer_tpu.obs.watchdog import PipelineWatchdog as JWatchdog
from nnstreamer_tpu.sched import breaker as jbreaker
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec
from nnstreamer_tpu.spec import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch import conf as tconf
from nnstreamer_tpu_torch import faults as tfaults
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.queue import Queue
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.node import Node, SourceNode
from nnstreamer_tpu_torch.graph.pipeline import PipelineError
from nnstreamer_tpu_torch.obs import export as texport
from nnstreamer_tpu_torch.obs import hooks, spans
from nnstreamer_tpu_torch.obs import util as tutil
from nnstreamer_tpu_torch.obs.device import DeviceTracer, oldest_inflight
from nnstreamer_tpu_torch.obs.export import MetricsServer, health_snapshot, render_text
from nnstreamer_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from nnstreamer_tpu_torch.obs.tracers import make_tracer
from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog
from nnstreamer_tpu_torch.sched import breaker as tbreaker
from nnstreamer_tpu_torch.sched.breaker import BreakerOpenError, CircuitBreaker, trip_all
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

F32 = np.float32


def _leftover_threads():
    return sorted(t.name for t in threading.enumerate() if t.is_alive() and t.name.startswith(
        ("watchdog:", "device:", "lane:", "src:", "queue:")))


@pytest.fixture(autouse=True)
def _clean():
    yield
    for f in (jfaults, tfaults):
        f.deactivate()
    for h in (jhooks, hooks):
        h.clear()
    for s in (jspans, spans):
        s.reset()
    tutil.reset_wire_health()
    deadline = time.monotonic() + 10
    while _leftover_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _leftover_threads() == []


def _wait_for(cond, timeout=30.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


class Pkg:
    def __init__(self, nns, faults, hooks, frame, datasrc, queue, sink, source, watchdog, ts,
                 tss):
        self.nns, self.faults, self.hooks, self.Frame = nns, faults, hooks, frame
        self.DataSrc, self.Queue, self.TensorSink, self.SourceNode = datasrc, queue, sink, source
        self.PipelineWatchdog = watchdog
        self.vec4 = tss.of(ts(dtype=F32, shape=(4,)))


JAX = Pkg(jnns, jfaults, jhooks, JFrame, JDataSrc, JQueue, JSink, JSourceNode, JWatchdog,
          JTensorSpec, JTensorsSpec)
PORT = Pkg(tnns, tfaults, hooks, Frame, DataSrc, Queue, TensorSink, SourceNode,
           PipelineWatchdog, TensorSpec, TensorsSpec)


def _frames(pkg, n):
    return [pkg.Frame.of(np.full(4, float(i), F32), pts=i) for i in range(n)]


class _StallingSrc(SourceNode):
    """One frame, then blocks (a source wedged in its own iterator)."""

    def output_spec(self):
        return PORT.vec4

    def frames(self):
        yield Frame.of(np.zeros(4, F32), pts=0)
        self._stop_evt.wait()


class _BlockingEvent:
    """A CUDA event stand-in whose synchronize waits for the test."""

    def __init__(self, release):
        self._release = release

    def synchronize(self):
        self._release.wait()


# -- detection: TestWatchdog --------------------------------------------------

def test_stalled_source_flips_healthz_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setattr(tconf.conf, "_environ",
                        {**os.environ, "NNSTPU_OBS_FLIGHT_DUMP_DIR": str(tmp_path)})
    reg = MetricsRegistry()
    health_events = []
    hooks.connect("health", lambda *a: health_events.append(a))
    p = tnns.Pipeline(name="wd_src")
    src = p.add(_StallingSrc(name="cam"))
    p.link(src, p.add(TensorSink(name="out")))
    wd = p.attach_tracer(PipelineWatchdog(registry=reg, interval_s=0.03, stall_s=0.1))
    with MetricsServer(port=0, registry=reg) as ms:
        p.start()
        try:
            assert _wait_for(lambda: not wd.summary()["healthy"])
            summ = wd.summary()
            assert any("stalled_source:cam" in r for r in summ["reasons"]), summ
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                urllib.request.urlopen(f"http://{ms.host}:{ms.port}/healthz", timeout=10)
            assert exc_info.value.code == 503
            body = json.loads(exc_info.value.read().decode())
            assert body["status"] == "unhealthy"
            assert "stalled_source:cam" in body["failures"]["wd_src"]
            assert 'nnstpu_health{pipeline="wd_src"} 0' in render_text(reg)
            assert 'nnstpu_watchdog_stalls_total{pipeline="wd_src",kind="stalled_source"} 1' \
                in render_text(reg)
            dump = tmp_path / "wd_src.stall.trace.json"
            assert dump.exists()
            doc = json.loads(dump.read_text())
            assert any(e.get("name") == "watchdog_unhealthy" for e in doc["traceEvents"])
            assert any(ev[0] is p and ev[1] is False and "stalled_source:cam" in ev[2]
                       for ev in health_events)
        finally:
            p.stop()
    # stopping unregisters the provider: /healthz recovers
    healthy, failures = health_snapshot()
    assert healthy and "wd_src" not in failures


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_wedged_queue_detected_and_recovers(pkg):
    reg = None if pkg is JAX else MetricsRegistry()
    p = pkg.nns.Pipeline(name="wd_q")
    q = p.add(pkg.Queue(max_size_buffers=8, name="q0"))
    kw = {} if reg is None else {"registry": reg}
    wd = pkg.PipelineWatchdog(interval_s=0.03, stall_s=0.08, queue_depth=2, **kw)
    p._tracers.append(wd)
    wd.start(p)
    p.state = "PLAYING"  # the monitor judges a PLAYING graph only
    try:
        pkg.hooks.emit("queue_push", q, 3)  # deep, and no pop comes
        assert _wait_for(lambda: not wd.summary()["healthy"])
        assert any("wedged_queue:q0: depth 3" in r for r in wd.summary()["reasons"])
        assert wd.health()[0] is False
        pkg.hooks.emit("queue_pop", q, 0)  # a pop clears the wedge
        assert _wait_for(lambda: wd.summary()["healthy"])
        summ = wd.summary()
        assert summ["transitions"] == 2 and summ["queues"] == 1 and summ["checks"] >= 2
        if reg is not None:
            assert 'nnstpu_health{pipeline="wd_q"} 1' in render_text(reg)
    finally:
        p.state = "STOPPED"
        wd.stop()


def test_overdue_device_dispatch_detected():
    """A dispatch whose completion the device tracer has not observed
    within the deadline makes the pipeline unhealthy; its completion
    makes it healthy again."""
    reg = MetricsRegistry()
    p = tnns.Pipeline(name="wd_dev")
    node = p.add(Node(name="f"))
    release = threading.Event()
    node._device_events = (None, _BlockingEvent(release))
    dev = DeviceTracer(registry=reg, capacity=4)
    p._tracers.append(dev)
    dev.start(p)
    wd = PipelineWatchdog(registry=reg, interval_s=0.03, stall_s=60.0, device_deadline_s=0.05)
    p._tracers.append(wd)
    wd.start(p)
    p.state = "PLAYING"
    try:
        hooks.emit("device_dispatch", node, Frame.of(np.zeros(4, F32)), (np.zeros(4, F32),),
                   time.perf_counter_ns())
        assert _wait_for(lambda: not wd.summary()["healthy"])
        assert oldest_inflight()[1] == "f"
        assert any(r.startswith("overdue_device:f: dispatch executing for")
                   for r in wd.summary()["reasons"])
        release.set()
        assert _wait_for(lambda: wd.summary()["healthy"])
        assert oldest_inflight() is None
    finally:
        release.set()
        p.state = "STOPPED"
        wd.stop()
        dev.stop()


def _boom_run(pkg, filt):
    p = pkg.nns.Pipeline(name="wd_err")
    src = p.add(pkg.DataSrc(data=[np.ones(4, F32)], name="s"))
    p.link_chain(src, p.add(filt), p.add(pkg.TensorSink(name="out")))
    wd = p.attach_tracer(pkg.PipelineWatchdog(interval_s=0.05))
    with pytest.raises(Exception):
        p.run(timeout=60)
    return wd.summary()


def test_pipeline_error_marks_unhealthy():
    from nnstreamer_tpu.elements.filter import TensorFilter as JFilter

    def boom(x):
        if float(np.max(np.asarray(x))) > 0:  # negotiation probes with zeros
            raise RuntimeError("wd crash")
        return x

    want = _boom_run(JAX, JFilter(framework="custom", model=boom, name="f"))
    got = _boom_run(PORT, TensorFilter(framework="custom", model=boom, name="f"))
    assert not got["healthy"] and not want["healthy"]
    assert [r.split(":")[:2] for r in got["reasons"]] == \
        [r.split(":")[:2] for r in want["reasons"]]
    assert any(r.startswith("error:") and "wd crash" in r for r in got["reasons"])
    assert set(got) == set(want)


# -- recovery: TestWatchdogRecovery -------------------------------------------

def _stall_once_src(pkg):
    class OneStallSrc(pkg.SourceNode):
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
                yield pkg.Frame.of(np.full(4, float(i), F32), pts=i)

    return OneStallSrc()


def _restart_run(pkg):
    got = []
    p = pkg.nns.Pipeline(name="faults_wd_src")
    src = p.add(_stall_once_src(pkg))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link(src, sink)
    wd = p.attach_tracer(pkg.PipelineWatchdog(interval_s=0.05, stall_s=0.2, recover=True))
    p.start()
    try:
        assert p.wait(timeout=60)
    finally:
        p.stop()
    return src.runs, got, p.recovery_stats(), wd.summary()


def test_restarts_stalled_source():
    jruns, jgot, jrec, jsum = _restart_run(JAX)
    runs, got, rec, summ = _restart_run(PORT)
    assert runs == jruns == 2  # the watchdog restarted the source
    assert got == jgot == [0, 0, 1, 2, 3, 4]  # the restarted stream flowed
    assert rec == jrec == {"actions": {"restart_source": 1}}
    assert summ["recoveries"] == jsum["recoveries"] == 1


def _drain_run(pkg, n=40):
    pkg.faults.install("queue_wedge@qw:after=1,ms=1500")  # a one-shot wedge
    got = []
    p = pkg.nns.Pipeline(name="faults_wd_queue")
    src = p.add(pkg.DataSrc(data=_frames(pkg, n)))
    q = p.add(pkg.Queue(max_size_buffers=200, name="qw"))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link_chain(src, q, sink)
    p.attach_tracer(pkg.PipelineWatchdog(interval_s=0.05, stall_s=0.2, recover=True))
    p.start()
    try:
        assert p.wait(timeout=60)
    finally:
        p.stop()
    return got, p.recovery_stats(), q.dropped


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_drains_wedged_queue(pkg):
    got, rec, dropped = _drain_run(pkg)
    assert rec["actions"].get("drain_queue", 0) >= 1
    # delivered + typed sheds == offered
    assert len(got) + rec["shed_total"] == 40 and rec["shed_total"] == dropped > 0
    assert got == sorted(got)


def _budget_run(pkg, budget, reg=None):
    """A queue that stays wedged (no pop ever comes, and recover_queue on
    a queue that never started finds nothing to drain): the watchdog
    escalates ``budget`` times, no more; a pop recovers and resets the
    budget, and a second wedge escalates ``budget`` times again."""
    p = pkg.nns.Pipeline(name="wd_budget")
    q = p.add(pkg.Queue(max_size_buffers=8, name="q0"))
    kw = {} if reg is None else {"registry": reg}
    wd = pkg.PipelineWatchdog(interval_s=0.02, stall_s=0.05, queue_depth=1, recover=True,
                              recover_budget=budget, **kw)
    p._tracers.append(wd)
    wd.start(p)
    p.state = "PLAYING"
    try:
        pkg.hooks.emit("queue_push", q, 5)
        assert _wait_for(lambda: wd.summary()["recoveries"] == budget)
        checks = wd.summary()["checks"]
        assert _wait_for(lambda: wd.summary()["checks"] >= checks + 5)  # five more ticks
        first = (wd.summary()["recoveries"], p.recovery_stats())
        pkg.hooks.emit("queue_pop", q, 0)
        assert _wait_for(lambda: wd.summary()["healthy"])
        pkg.hooks.emit("queue_push", q, 5)
        assert _wait_for(lambda: wd.summary()["recoveries"] == 2 * budget)
        checks = wd.summary()["checks"]
        assert _wait_for(lambda: wd.summary()["checks"] >= checks + 5)
        second = (wd.summary()["recoveries"], p.recovery_stats(), wd.summary()["transitions"])
    finally:
        p.state = "STOPPED"
        wd.stop()
    return first, second


def test_escalation_budget_caps_and_resets():
    reg = MetricsRegistry()
    want = _budget_run(JAX, 2)
    got = _budget_run(PORT, 2, reg)
    assert got == want
    assert got[0] == (2, {"actions": {"drain_queue": 2}})
    assert got[1] == (4, {"actions": {"drain_queue": 4}}, 3)


def test_overdue_device_trips_breakers():
    br = CircuitBreaker(failure_threshold=3, reset_timeout_s=60)
    assert br.state == "closed"
    n = trip_all(reason="test")
    assert n >= 1
    assert br.state == "open" and br.forced_trips == 1
    with pytest.raises(BreakerOpenError) as exc_info:
        br.allow()
    assert exc_info.value.code == "UNAVAILABLE" == jbreaker.CODE_UNAVAILABLE
    # tripping again while open restarts the timeout, no double count
    br.trip()
    assert br.trips == 1 and br.forced_trips == 2


def test_overdue_device_escalation_records_breaker_trip():
    """The watchdog's overdue-device verdict under ``recover`` trips every
    live breaker and records ``breaker_trip ok`` on the recovery counter."""
    records = []
    hooks.connect("recovery", lambda *a: records.append(a))
    br = CircuitBreaker(failure_threshold=3, reset_timeout_s=60)
    p = tnns.Pipeline(name="wd_trip")
    node = p.add(Node(name="f"))
    release = threading.Event()
    node._device_events = (None, _BlockingEvent(release))
    dev = DeviceTracer(capacity=4)
    p._tracers.append(dev)
    dev.start(p)
    wd = PipelineWatchdog(interval_s=0.03, stall_s=60.0, device_deadline_s=0.05, recover=True,
                          recover_budget=1)
    p._tracers.append(wd)
    wd.start(p)
    p.state = "PLAYING"
    try:
        hooks.emit("device_dispatch", node, Frame.of(np.zeros(4, F32)), (np.zeros(4, F32),),
                   time.perf_counter_ns())
        assert _wait_for(lambda: br.stats()["state"] == "open")
        assert _wait_for(lambda: records)
        assert records[0][:4] == ("wd_trip", "breaker_trip", "f", "ok")
        counter = REGISTRY.get("nnstpu_recovery_total")
        assert any(k == ("wd_trip", "breaker_trip", "ok") and c.value == 1
                   for k, c in counter.children())
        release.set()
        assert _wait_for(lambda: wd.summary()["healthy"])
        assert wd.summary()["recoveries"] == 1
    finally:
        release.set()
        p.state = "STOPPED"
        wd.stop()
        dev.stop()


# -- the breaker against the reference ----------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_trace(mod, seed, steps=400):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    br = mod.CircuitBreaker(failure_threshold=3, reset_timeout_s=2.0, half_open_max=2,
                            clock=clock)
    out = []
    for _ in range(steps):
        clock.t += float(rng.choice([0.1, 0.5, 1.5]))
        before = br.state
        op = rng.integers(0, 10)
        if op == 0:
            br.trip("test")
            out.append((before, "trip", br.state))
            continue
        try:
            br.allow()
        except mod.BreakerOpenError as exc:
            out.append((before, "refused", br.state, round(exc.retry_after_s, 9)))
            continue
        if rng.random() < 0.45:
            br.record_failure()
            out.append((before, "failure", br.state))
        else:
            br.record_success()
            out.append((before, "success", br.state))
    return out, br.stats()


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_breaker_state_sequence_equals_reference(seed):
    want = _breaker_trace(jbreaker, seed)
    got = _breaker_trace(tbreaker, seed)
    assert got == want
    assert {step[0] for step in got[0]} == {"closed", "open", "half_open"}


def test_breaker_registry_is_weak():
    import gc

    br = CircuitBreaker()
    assert br in tbreaker.all_breakers()
    del br
    gc.collect()
    before = len(tbreaker.all_breakers())
    assert trip_all() == before


def test_breaker_rejects_bad_arguments():
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError):
        CircuitBreaker(reset_timeout_s=0)


# -- configuration and the readouts -------------------------------------------

def test_profile_auto_raises_naming_item_12(monkeypatch, tmp_path):
    """``[obs] profile_auto``, which raised while ``obs/profiler.py`` was not
    ported: a dispatch far beyond the noise band of its capture's device
    time makes the watchdog bank one ``trigger="watchdog"`` capture."""
    from nnstreamer_tpu_torch.obs import profiler

    monkeypatch.setattr(tconf.conf, "_environ", {
        **os.environ, "NNSTPU_OBS_PROFILE_AUTO": "true",
        "NNSTPU_OBS_PROFILE_AUTO_SECONDS": "0.1", "NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S": "600",
        "NNSTPU_OBS_PROFILE_MIN_SAMPLES": "8", "NNSTPU_OBS_PROFILE_DIR": str(tmp_path)})
    profiler.reset_gallery()
    p = tnns.Pipeline(name="wd_prof")
    src = p.add(_stall_once_src(PORT))
    p.link(src, p.add(TensorSink(name="out")))
    reg = MetricsRegistry()
    wd = PipelineWatchdog(registry=reg, interval_s=0.05, stall_s=60)
    p.attach_tracer(wd)
    p.start()
    try:
        assert wd._profile_detector is not None
        for _ in range(12):  # a steady baseline, then one dispatch 50x slower
            hooks.emit("device_exec", "wd_prof", "f", "cuda:0", 0, 1_000_000,
                       {"cost_key": "wd:00000000000d"})
        hooks.emit("device_exec", "wd_prof", "f", "cuda:0", 0, 50_000_000,
                   {"cost_key": "wd:00000000000d"})
        assert _wait_for(lambda: wd.summary()["profile_auto"]["captures"] >= 1, timeout=60)
        for _ in range(3):  # later verdicts fall inside the cooldown
            hooks.emit("device_exec", "wd_prof", "f", "cuda:0", 0, 50_000_000,
                       {"cost_key": "wd:00000000000d"})
        time.sleep(0.3)
    finally:
        p.stop()
        profiler.reset_gallery()
    assert wd.summary()["profile_auto"]["captures"] == 1
    assert wd.summary()["profile_auto"]["verdicts"] >= 1
    last = profiler.last_capture()
    assert last["trigger"] == "watchdog" and last["pipeline"] == "wd_prof"
    assert 'nnstpu_profile_captures_total{trigger="watchdog",outcome="ok"} 1' in \
        render_text(reg)
    assert "wd_prof" not in health_snapshot()[1]


def test_conf_driven_attach_and_knobs(monkeypatch):
    env = {**os.environ, "NNSTPU_TRACERS": "watchdog", "NNSTPU_OBS_WATCHDOG_INTERVAL": "0.05",
           "NNSTPU_OBS_WATCHDOG_STALL_S": "0.2", "NNSTPU_OBS_WATCHDOG_RECOVER": "true",
           "NNSTPU_OBS_WATCHDOG_RECOVER_BUDGET": "2"}
    monkeypatch.setattr(tconf.conf, "_environ", env)
    import nnstreamer_tpu_torch.obs as tobs

    monkeypatch.setattr(tobs, "configured_tracers",
                        lambda: tobs.parse_tracer_names(env["NNSTPU_TRACERS"]))
    assert isinstance(make_tracer("watchdog"), PipelineWatchdog)
    got = []
    p = tnns.Pipeline(name="wd_conf")
    src = p.add(_stall_once_src(PORT))
    sink = p.add(TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link(src, sink)
    p.start()
    try:
        wd = next(t for t in p.tracers if t.name == "watchdog")
        assert (wd._interval, wd._stall, wd._recover, wd._recover_budget) == (0.05, 0.2, True, 2)
        assert (wd._depth_threshold, wd._device_deadline, wd._wire_probe_s) == (1, 30.0, 0.0)
        assert p.wait(timeout=60)
    finally:
        p.stop()
    assert got == [0, 0, 1, 2, 3, 4]
    assert p.stats()["tracers"]["watchdog"]["recoveries"] == 1


def test_wire_probe_on_its_cadence_and_summary(monkeypatch):
    monkeypatch.setattr(tconf.conf, "_environ",
                        {**os.environ, "NNSTPU_OBS_WATCHDOG_WIRE_PROBE_S": "0.01"})
    calls = []

    def fake_probe(n=20, nbytes=150_528, device="cuda"):
        calls.append(n)
        return {"put_150k_ms": 0.25, "dispatch_ms": 0.5}

    monkeypatch.setattr(tutil, "probe_wire_health", fake_probe)
    reason = {"r": "backend on reduced capability"}
    texport.register_degraded("wd_wire.f", lambda: reason["r"])
    reg = MetricsRegistry()
    p = tnns.Pipeline(name="wd_wire")
    wd = PipelineWatchdog(registry=reg, interval_s=0.02)
    p._tracers.append(wd)
    wd.start(p)
    p.state = "PLAYING"
    try:
        assert _wait_for(lambda: len(calls) >= 2)
        summ = wd.summary()
        assert summ["wire"]["put_150k_ms"] == 0.25 and summ["wire"]["regime"] == "fast"
        assert 'nnstpu_wire_put_ms{addr="local"} 0.25' in render_text(reg)
        assert summ["degraded"] == {"wd_wire.f": "backend on reduced capability"}
        assert set(calls) == {4}
        assert summ["healthy"]
    finally:
        p.state = "STOPPED"
        wd.stop()
        texport.unregister_degraded("wd_wire.f")
    assert set(wd.summary()) == {"healthy", "reasons", "checks", "transitions", "sources",
                                 "queues", "recover", "recoveries", "wire"}


def test_stop_joins_the_monitor_and_unregisters():
    p = tnns.Pipeline(name="wd_stop")
    wd = PipelineWatchdog(interval_s=0.02)
    wd.start(p)
    assert any(t.name == "watchdog:wd_stop" for t in threading.enumerate())
    assert "wd_stop" in texport._health_providers
    wd.stop()
    assert not any(t.name == "watchdog:wd_stop" for t in threading.enumerate())
    assert "wd_stop" not in texport._health_providers
    wd.stop()  # idempotent


def test_error_in_thread_mode_fails_the_run():
    def boom(x):
        if float(np.max(np.asarray(x))) > 0:
            raise RuntimeError("wd crash")
        return x

    p = tnns.Pipeline(name="wd_err2")
    p.link_chain(p.add(DataSrc(data=[np.ones(4, F32)], name="s")),
                 p.add(TensorFilter(framework="custom", model=boom, name="f")),
                 p.add(TensorSink(name="out")))
    wd = p.attach_tracer("watchdog")
    with pytest.raises(PipelineError):
        p.run(timeout=60)
    assert wd.health()[0] is False
