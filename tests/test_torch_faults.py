"""The port's self-healing runtime against the JAX package's, in one process.

The same fault spec parses to the same rules and replays the same seeded
decisions in both packages; the same pipeline under the same spec delivers
the same frames and leaves the same ``recovery_stats()``.  The faults are
installed programmatically in each package and deactivated after every
test: no test sets ``NNSTPU_FAULTS``, ``NNSTPU_RECOVERY_POLICY`` or
``NNSTPU_TRACERS``, which both packages read.
"""

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
from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.elements.queue import Queue as JQueue
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JDataSrc
from nnstreamer_tpu.graph.node import SourceNode as JSourceNode
from nnstreamer_tpu.graph.pipeline import RestartPolicy as JRestartPolicy
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec
from nnstreamer_tpu.spec import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch import conf as tconf
from nnstreamer_tpu_torch import faults as tfaults
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend, TorchModel
from nnstreamer_tpu_torch.buffer import Event, Frame
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.queue import Queue
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.node import SourceNode
from nnstreamer_tpu_torch.graph.pipeline import PipelineError, RestartPolicy
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.obs import hooks as thooks
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

F32 = np.float32


@pytest.fixture(autouse=True)
def _clean_chaos():
    yield
    jfaults.deactivate()
    tfaults.deactivate()
    thooks.clear()


# Both packages' surfaces, side by side: (package, faults, Frame, DataSrc,
# TensorFilter, TensorSink, Queue, SourceNode, spec classes).
class Pkg:
    def __init__(self, nns, faults, frame, datasrc, filt, sink, queue, source, ts, tss):
        self.nns, self.faults, self.Frame, self.DataSrc = nns, faults, frame, datasrc
        self.TensorFilter, self.TensorSink, self.Queue, self.SourceNode = filt, sink, queue, source
        self.TensorSpec, self.TensorsSpec = ts, tss


JAX = Pkg(jnns, jfaults, JFrame, JDataSrc, JFilter, JSink, JQueue, JSourceNode,
          JTensorSpec, JTensorsSpec)
PORT = Pkg(tnns, tfaults, Frame, DataSrc, TensorFilter, TensorSink, Queue, SourceNode,
           TensorSpec, TensorsSpec)


def _frames(pkg, n):
    return [pkg.Frame.of(np.full(4, float(i), F32), pts=i) for i in range(n)]


def _value(frame):
    return [float(v) for v in np.asarray(frame.tensor(0)).reshape(-1)]


# -- spec grammar and determinism -------------------------------------------

GRAMMAR = [
    "seed=7;invoke_raise@f:every=5;socket_drop@server:rate=0.1,count=3;"
    "queue_wedge@q0:after=10,ms=250",
    "invoke_raise:after=3",
    "compile_raise:count=1",
    "seed=3;invoke_delay@f:rate=0.3,ms=1;device_stall:every=7,ms=2;worker_kill:rate=0.5;"
    "partition@w1:after=2,ms=10;migrate_abort:count=2;spawn_fail:every=2;scale_flap:rate=0.2",
]
BAD = ["not_a_kind:rate=0.1", "invoke_raise:bogus=1", "invoke_raise", "invoke_raise:rate=1.5"]


def _rule_tuple(r):
    return (r.kind, r.target, r.rate, r.every, r.after, r.count, r.ms)


@pytest.mark.parametrize("spec", GRAMMAR)
def test_parse_spec_equal_rules(spec):
    jseed, jrules = jfaults.parse_spec(spec)
    tseed, trules = tfaults.parse_spec(spec)
    assert jseed == tseed
    assert [_rule_tuple(r) for r in trules] == [_rule_tuple(r) for r in jrules]


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_in_both(spec):
    with pytest.raises(ValueError):
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError):
        tfaults.parse_spec(spec)


def test_grammar_kinds_and_points_equal():
    assert tfaults.POINT_OF == jfaults.POINT_OF
    assert tfaults.DEFAULT_MS == jfaults.DEFAULT_MS


@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_equal_seed_equal_decisions(seed):
    spec = (f"seed={seed};invoke_raise@f:rate=0.2;invoke_delay@f:rate=0.3,ms=1;"
            "socket_drop:rate=0.15;queue_wedge@q:every=7,after=3;compile_raise:rate=0.5,count=40")
    j, t = jfaults.ChaosEngine(spec), tfaults.ChaosEngine(spec)
    points = [("backend_invoke", "f"), ("nnsq_send", "nnsq.server"), ("queue_wedge", "q"),
              ("backend_compile", "torch:m"), ("backend_invoke", "other")]
    for eng in (j, t):
        for i in range(1000):
            point, name = points[i % len(points)]
            eng.decide(point, name)
    assert t.log and t.log == j.log
    assert t.injections == j.injections
    assert t.stats()["rules"] == j.stats()["rules"]


# -- the same pipeline in both packages --------------------------------------


def _run_chain(pkg, spec, model, n=20, policy=None, expect_error=False):
    """``datasrc`` of ``n`` frames → custom filter ``f`` → sink under
    ``spec``; returns (delivered values, recovery_stats, injections,
    pipeline)."""
    eng = pkg.faults.install(spec)
    got = []
    p = pkg.nns.Pipeline(name="faults_parity")
    src = p.add(pkg.DataSrc(data=_frames(pkg, n)))
    filt = p.add(pkg.TensorFilter(framework="custom", model=model, name="f"))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(_value(fr)))
    p.link_chain(src, filt, sink)
    if policy is not None:
        p.set_restart_policy("f", **policy)
    if expect_error:
        with pytest.raises(Exception):
            p.run(timeout=120)
    else:
        p.run(timeout=120)
    return got, p.recovery_stats(), dict(eng.injections), p


CASES = {
    "restart": dict(spec="invoke_raise@f:every=5",
                    policy=dict(mode="restart", backoff_ms=1, backoff_cap_ms=5, max_restarts=100)),
    "restart_seeded": dict(spec="seed=9;invoke_raise@f:rate=0.3",
                           policy=dict(mode="restart", backoff_ms=0, max_restarts=100)),
    "quarantine_matching": dict(spec="invoke_raise@f:after=5",
                                policy=dict(mode="quarantine-passthrough")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_pipeline_same_recovery(case):
    kw = CASES[case]
    want, jrec, jinj, _ = _run_chain(JAX, kw["spec"], lambda x: x * 2 + 1, policy=kw["policy"])
    got, trec, tinj, p = _run_chain(PORT, kw["spec"], lambda x: x * 2 + 1, policy=kw["policy"])
    assert got == want and len(got) < 20
    assert trec == jrec and tinj == jinj
    assert len(got) + trec["shed_total"] == 20
    assert p.stats()["recovery"] == trec
    assert p.state == "STOPPED" and p._error is None


def test_quarantine_with_differing_specs_sheds():
    spec, policy = "invoke_raise@f:after=4", dict(mode="quarantine-passthrough")
    want, jrec, _, _ = _run_chain(JAX, spec, lambda x: x[:2] * 3, n=12, policy=policy)
    got, trec, _, p = _run_chain(PORT, spec, lambda x: x[:2] * 3, n=12, policy=policy)
    assert got == want == [[3.0 * i, 3.0 * i] for i in range(4)]
    assert trec == jrec
    assert trec["shed_total"] == 8 and trec["quarantined"] == ["f"]
    assert p["f"]._quarantined and not p["f"]._quarantine_passthrough


def test_storm_escalates_in_both():
    spec = "invoke_raise@f:every=1"
    policy = dict(mode="restart", backoff_ms=1, backoff_cap_ms=2, max_restarts=3, window_s=60)
    _, jrec, _, jp = _run_chain(JAX, spec, lambda x: x, n=10, policy=policy, expect_error=True)
    _, trec, _, tp = _run_chain(PORT, spec, lambda x: x, n=10, policy=policy, expect_error=True)
    assert trec == jrec and trec["actions"]["restart_node"] == 3
    assert tp.state == jp.state == "STOPPED"
    with pytest.raises(PipelineError):
        tp.wait(0)  # the storm's fault is the pipeline's error
    assert isinstance(tp._error, tfaults.InjectedFault)


def test_fail_pipeline_halts_in_both():
    spec = "invoke_raise@f:after=2"
    want, jrec, _, _ = _run_chain(JAX, spec, lambda x: x, n=8,
                                  policy=dict(mode="fail-pipeline"), expect_error=True)
    got, trec, _, p = _run_chain(PORT, spec, lambda x: x, n=8,
                                 policy=dict(mode="fail-pipeline"), expect_error=True)
    assert got == want == [[float(i)] * 4 for i in range(2)]
    assert trec == jrec == {}
    assert isinstance(p._error, tfaults.InjectedFault)


def _flaky_source(pkg):
    vec4 = pkg.TensorsSpec.of(pkg.TensorSpec(dtype=F32, shape=(4,)))

    class FlakySrc(pkg.SourceNode):
        def __init__(self):
            super().__init__("flaky")
            self.runs = 0

        def output_spec(self):
            return vec4

        def frames(self):
            self.runs += 1
            if self.runs == 1:
                yield pkg.Frame.of(np.zeros(4, F32), pts=0)
                raise RuntimeError("camera hiccup")
            for i in range(1, 4):
                yield pkg.Frame.of(np.full(4, float(i), F32), pts=i)

    return FlakySrc()


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_source_restart_policy_reenters_frames(pkg):
    got = []
    p = pkg.nns.Pipeline(name="faults_src_restart")
    src = p.add(_flaky_source(pkg))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link(src, sink)
    p.set_restart_policy("flaky", mode="restart", backoff_ms=1)
    p.run(timeout=120)
    assert got == [0, 1, 2, 3]
    assert p.recovery_stats() == {"actions": {"restart_source": 1}}


def _stalling_source(pkg):
    vec4 = pkg.TensorsSpec.of(pkg.TensorSpec(dtype=F32, shape=(4,)))

    class OneStallSrc(pkg.SourceNode):
        def __init__(self):
            super().__init__("cam")
            self.runs = 0

        def output_spec(self):
            return vec4

        def frames(self):
            self.runs += 1
            yield pkg.Frame.of(np.zeros(4, F32), pts=0)
            if self.runs == 1:
                self._stop_evt.wait()  # stall until restarted
                return
            for i in range(1, 5):
                yield pkg.Frame.of(np.full(4, float(i), F32), pts=i)

    return OneStallSrc()


def _restart_stalled(pkg):
    got = []
    p = pkg.nns.Pipeline(name="faults_restart_source")
    src = p.add(_stalling_source(pkg))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link(src, sink)
    p.start()
    try:
        deadline = time.monotonic() + 30
        while not got and time.monotonic() < deadline:
            time.sleep(0.005)
        assert p.source_alive("cam")
        assert p.restart_source("cam")
        assert p.wait(timeout=60)
    finally:
        p.stop()
    return got, p.recovery_stats(), src.runs


def test_restart_source_replaces_stalled_thread():
    want = _restart_stalled(JAX)
    got = _restart_stalled(PORT)
    assert got == want
    assert got[0] == [0, 0, 1, 2, 3, 4] and got[2] == 2
    assert got[1] == {"actions": {"restart_source": 1}}
    assert not any(t.name == "src:cam" for t in threading.enumerate())


def _recover_wedged(pkg, n=20):
    pkg.faults.install("queue_wedge@qw:count=1,ms=3000")  # one wedge, before the first pop
    got = []
    p = pkg.nns.Pipeline(name="faults_recover_queue")
    src = p.add(pkg.DataSrc(data=_frames(pkg, n)))
    q = p.add(pkg.Queue(max_size_buffers=200, name="qw"))
    sink = p.add(pkg.TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link_chain(src, q, sink)
    p.start()
    try:
        deadline = time.monotonic() + 30
        # every frame and the EOS wait behind the wedged worker
        while len(q._q) < n + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(q._q) == n + 1
        drained = p.recover_queue("qw")
        assert p.wait(timeout=60)
    finally:
        p.stop()
    return got, drained, q.dropped, p.recovery_stats()


def test_recover_queue_drains_backlog_keeps_eos():
    want = _recover_wedged(JAX)
    got = _recover_wedged(PORT)
    assert got == want
    delivered, drained, dropped, rec = got
    assert delivered == [] and drained == dropped == 20
    assert rec == {"actions": {"drain_queue": 1}, "shed_frames": {"qw": 20}, "shed_total": 20}


def test_queue_recover_unit():
    q = Queue(max_size_buffers=32, name="qr")
    q._ensure_queue()
    for i in range(5):
        q._q.push(Frame.of(np.zeros(2, F32), pts=i))
    q._q.push(Event.eos())
    drained, threads = q.recover()
    assert drained == 5 and q.dropped == 5
    assert len(q._q) == 1  # the EOS survived, in place
    assert len(threads) == 1  # no live worker: a fresh one is handed back
    status, item = q._q.pop(0)
    assert isinstance(item, Event) and item.kind == "eos"
    q._q.shutdown()


# -- the policy object and the conf default ---------------------------------


@pytest.mark.parametrize("cls", [JRestartPolicy, RestartPolicy], ids=["jax", "port"])
def test_unknown_mode_rejected(cls):
    with pytest.raises(ValueError):
        cls("reboot-the-universe")


def test_policy_lookup_order():
    p = tnns.Pipeline(name="faults_lookup")
    p.set_restart_policy("*", mode="quarantine-passthrough")
    p.set_restart_policy("f", mode="restart")
    assert p.restart_policy_for("f").mode == "restart"
    assert p.restart_policy_for("g").mode == "quarantine-passthrough"
    assert tnns.Pipeline().restart_policy_for("f") is None  # fail-pipeline


def test_conf_default_policy_and_spec(monkeypatch):
    # the port's conf alone sees these (os.environ stays as it is)
    env = dict(tconf.conf._environ, NNSTPU_RECOVERY_POLICY="restart",
               NNSTPU_RECOVERY_BACKOFF_MS="1", NNSTPU_FAULTS_SPEC="seed=5;invoke_raise@f:every=4")
    monkeypatch.setattr(tconf.conf, "_environ", env)
    monkeypatch.delenv("NNSTPU_FAULTS", raising=False)
    got = []
    p = tnns.Pipeline(name="faults_conf")
    src = p.add(DataSrc(data=_frames(PORT, 8)))
    filt = p.add(TensorFilter(framework="custom", model=lambda x: x, name="f"))
    sink = p.add(TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(fr.pts))
    p.link_chain(src, filt, sink)
    p.run(timeout=120)  # no explicit policy: conf supplies "restart"
    eng = tfaults.engine()
    assert eng is not None and eng.injections["invoke_raise"] == 2
    assert got == [0, 1, 2, 4, 5, 6]
    assert p.recovery_stats()["actions"]["restart_node"] == 2
    assert RestartPolicy.from_conf().backoff_ms == 1.0


# -- compile_raise: no CPU fallback -----------------------------------------


class CountingCapture:
    """A capture function for the CPU (``TorchBackend.capture``): eager
    entries, each capture logged."""

    def __init__(self):
        self.log = []

    def __call__(self, fn, in_spec, device):
        self.log.append(tuple(tuple(t.shape) for t in in_spec.tensors))
        return _EagerEntry(fn)


class _EagerEntry:
    warmup_calls = 0
    capture_s = warmup_s = 0.0
    flops = None

    def __init__(self, fn):
        self.fn = fn

    def run(self, xs):
        out = self.fn(*xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _compile_chain(policy, n=5):
    vec4 = TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,)))
    model = TorchModel(apply=lambda p_, x: x * 3.0, input_spec=vec4, name="degrade_me",
                       device="cpu")
    backend = TorchBackend()
    backend.capture = CountingCapture()
    got = []
    p = tnns.Pipeline(name="faults_compile")
    src = p.add(DataSrc(data=_frames(PORT, n)))
    filt = p.add(TensorFilter(model=model, backend=backend, name="f"))
    sink = p.add(TensorSink(name="out"))
    sink.connect("new-data", lambda fr: got.append(_value(fr)[0]))
    p.link_chain(src, filt, sink)
    if policy is not None:
        p.set_restart_policy("f", **policy)
    return p, backend, got


def test_compile_raise_fails_the_pipeline_without_a_policy():
    eng = tfaults.install("compile_raise:count=1")
    p, backend, got = _compile_chain(None)
    with pytest.raises(tfaults.InjectedFault):
        p.start()
    p.stop()
    assert eng.injections == {"compile_raise": 1}
    assert backend.capture.log == [] and backend.stats["captures"] == 0
    assert got == [] and p.recovery_stats() == {}
    assert not hasattr(backend, "_degraded")  # there is no CPU degradation state


def test_compile_raise_restarts_the_node():
    eng = tfaults.install("compile_raise:count=1")
    p, backend, got = _compile_chain(dict(mode="restart", backoff_ms=1))
    p.run(timeout=120)
    assert eng.injections == {"compile_raise": 1}
    assert got == [3.0 * i for i in range(5)]  # every frame, through the capture
    assert backend.capture.log == [((4,),)] and backend.stats["replays"] == 5
    assert p.recovery_stats() == {"actions": {"restart_node": 1}}


def test_restart_recaptures_each_time():
    """A restart closes the backend (its captures go) and captures the
    negotiated geometry again: one capture at start and one a restart."""
    eng = tfaults.install("invoke_raise@f:every=4")
    p, backend, got = _compile_chain(dict(mode="restart", backoff_ms=1), n=16)
    p.run(timeout=120)
    assert eng.injections == {"invoke_raise": 4}
    assert got == [3.0 * i for i in range(16) if (i + 1) % 4]
    assert backend.capture.log == [((4,),)] * 5
    assert backend.stats["captures"] == 5 and backend.stats["replays"] == 12
    assert p.recovery_stats()["actions"] == {"restart_node": 4}


# -- slice 1 at a small width under restart ----------------------------------

NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
SIZE, CLASSES, FRAMES = 64, 10, 9


def _slice_under_restart(nns, faults, filt, labels, sink_cls, **transform_kw):
    eng = faults.install("invoke_raise@f:every=4")
    p = nns.Pipeline(name="faults_slice")
    src = p.add(nns.make("videotestsrc", num_buffers=FRAMES, width=SIZE, height=SIZE,
                         pattern="random", seed=3))
    conv = p.add(nns.make("tensor_converter"))
    norm = p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                          acceleration="pallas", **transform_kw))
    p.add(filt)
    dec = p.add(nns.make("tensor_decoder", mode="image_labeling", option1=labels))
    sink = p.add(sink_cls(collect=True))
    p.link_chain(src, conv, norm, filt, dec, sink)
    p.set_restart_policy(filt, mode="restart", backoff_ms=1, max_restarts=10)
    p.run(timeout=300)
    return sink.frames, p.recovery_stats(), dict(eng.injections)


def test_slice_under_restart_matches_jax(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    jmodel = jm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                                int8_head=True)
    want, jrec, jinj = _slice_under_restart(jnns, jfaults, JFilter(framework="jax", model=jmodel,
                                                                   name="f"),
                                            str(labels), JSink)
    model = tm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                               params=jax.tree_util.tree_map(np.asarray, jmodel.params),
                               int8_head=True, device="cpu")
    got, trec, tinj = _slice_under_restart(tnns, tfaults,
                                           TensorFilter(framework="torch", model=model, name="f"),
                                           str(labels), TensorSink, device="cpu")
    assert tinj == jinj == {"invoke_raise": 2}
    assert trec == jrec == {"actions": {"restart_node": 2}, "shed_frames": {"f": 2},
                            "shed_total": 2}
    assert len(got) == len(want) == FRAMES - 2
    for g, w in zip(got, want):
        assert g.pts == w.pts
        assert g.meta["label_index"] == w.meta["label_index"]
        # the bf16 trunk may round differently in the two frameworks
        # (tests/test_torch_mobilenet.py's tolerance)
        assert abs(g.meta["score"] - w.meta["score"]) <= 0.15
    assert isinstance(got[0].tensor(0), torch.Tensor)
