"""The port's partitioner against the JAX package's, on the CPU.

Case for case with the planner, edge-probe, deployment and repartition
monitor cases of the JAX package's ``tests/test_partition.py``.  The
planner cases run both packages' ``plan_partition`` on the same cost model
and wire record and hold the plans equal: the same cut, scores and
attribution, and the same fingerprint.  The deployment cases run the port's
in-process :class:`FleetWorker` on the ``fragment`` backend with
``device="cpu"``; a split run's frames must equal the unsplit pipeline's
exactly (partitioning adds no numerics), through two seeded socket drops on
the edge.  One case runs the server fragment in a worker process
(``SubprocFragmentWorker``, ``--device cpu``) and redeploys it through the
monitor, as ``chip_smoke.py`` does on the card.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nnstreamer_tpu import partition as jpart
from nnstreamer_tpu.obs import costmodel as jcostmodel
from nnstreamer_tpu.obs import util as jutil

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch import faults
from nnstreamer_tpu_torch.elements.query import QueryServer
from nnstreamer_tpu_torch.graph.parse import ParseError
from nnstreamer_tpu_torch.obs import costmodel as tcostmodel
from nnstreamer_tpu_torch.obs import spans
from nnstreamer_tpu_torch.obs import util as tutil
from nnstreamer_tpu_torch.obs.collector import attribute_trace
from nnstreamer_tpu_torch.obs.spans import SpanTracer
from nnstreamer_tpu_torch.partition import (
    PartitionDeployment,
    RepartitionMonitor,
    SubprocFragmentWorker,
    card_peaks,
    plan_partition,
    probe_edge_health,
    subproc_worker_factory,
)
from nnstreamer_tpu_torch.partition import planner as tplanner
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32


@pytest.fixture(autouse=True)
def _clean_partition_state():
    yield
    faults.deactivate()
    tutil.reset_wire_health()
    jutil.reset_wire_health()
    spans.disable()
    spans.reset()


DESC = ("videotestsrc num-buffers=6 pattern=smpte width=4 height=4 ! "
        "tensor_converter name=conv ! "
        "tensor_transform mode=arithmetic option=mul:2.0 name=scale ! "
        "tensor_transform mode=arithmetic option=add:1.0 name=bias ! "
        "tensor_sink name=out collect=true")

# the same chain for the port's runs: its transform runs on the card unless
# asked for the CPU
TDESC = DESC.replace("name=scale", "name=scale device=cpu").replace(
    "name=bias", "name=bias device=cpu")

PEAKS = {"client": {"tflops": 0.1}, "server": {"tflops": 1.0}}
FAST_WIRE = {"put_150k_ms": 0.5, "dispatch_ms": 0.2}
SLOW_WIRE = {"put_150k_ms": 50.0, "dispatch_ms": 5.0}
CPU_PROPS = {"device": "cpu", "request_timeout": "30"}


def _leg(mean_us, count=5, m2=400.0):
    return {"count": count, "mean_us": float(mean_us), "m2": float(m2)}


def _cost_model(scale_us=4000.0, stage_key=tcostmodel.stage_key):
    """The reference's pricing fixture: conv cheap (no profile, 2x wire
    bytes if it moves), scale/bias heavy with a flops profile the 10x
    faster server roofline scales by 0.1."""
    sk = stage_key
    return {
        "schema": 1,
        "stages": {
            sk("pl", "conv"): {"legs": {"device_exec": _leg(100.0)}, "runs": [],
                               "copy_bytes_per_frame": 301_056.0},
            sk("pl", "scale"): {"legs": {"device_exec": _leg(scale_us)}, "runs": [],
                                "flops_per_frame": 1e9, "copy_bytes_per_frame": 150_528.0},
            sk("pl", "bias"): {"legs": {"device_exec": _leg(3000.0)}, "runs": [],
                               "flops_per_frame": 1e9, "copy_bytes_per_frame": 150_528.0},
        },
    }


def _plans(wire=FAST_WIRE, cm=None, addr="127.0.0.1:0", peaks=PEAKS, desc=DESC):
    """The port's plan and the JAX package's, on the same inputs."""
    cm = cm or _cost_model()
    ours = plan_partition(desc, pipeline="pl", addr=addr, edge="edge0", cost_model=cm,
                          wire_health=wire, peaks=peaks)
    theirs = jpart.plan_partition(desc, pipeline="pl", addr=addr, edge="edge0",
                                  cost_model=cm, wire_health=wire, peaks=peaks)
    return ours, theirs


def _plan(wire=FAST_WIRE, cm=None, addr="127.0.0.1:0", desc=DESC):
    return _plans(wire, cm, addr, desc=desc)[0]


def _same(ours, theirs):
    assert json.dumps(ours.to_dict(), sort_keys=True) == json.dumps(theirs.to_dict(),
                                                                   sort_keys=True)
    assert ours.fingerprint == theirs.fingerprint


# -- the planner ------------------------------------------------------------


class TestPlanner:
    def test_reproducible_and_pinned(self):
        """Same inputs -> byte-identical plan, in both packages; the chosen
        cut and its attribution are the reference test's."""
        p1, p2 = _plan(), _plan()
        assert p1 == p2
        assert p1.fingerprint and p1.fingerprint == p2.fingerprint
        _same(*_plans())
        assert p1.cut == 2
        assert p1.regime == "fast"
        assert p1.chosen.total_us == pytest.approx(2000.0)
        assert p1.chosen.client_us == pytest.approx(100.0)
        assert p1.chosen.server_us == pytest.approx(700.0)
        assert p1.chosen.transfer_us == pytest.approx(1200.0)
        assert [s.cut for s in p1.scores] == [None, 1, 2, 3]
        assert p1.score_for(None).total_us == pytest.approx(7100.0)
        assert [(n, p) for n, p, _ in p1.chosen.stages] == [
            ("conv", "client"), ("scale", "server"), ("bias", "server")]

    def test_unprobed_wire_never_chosen(self):
        ours, theirs = _plans(wire=None)
        _same(ours, theirs)
        assert ours.cut is None
        assert ours.regime == "unknown"
        for s in ours.scores:
            if s.cut is not None:
                assert s.transfer_us == float("inf")

    def test_slow_wire_keeps_everything_local(self):
        ours, theirs = _plans(wire=SLOW_WIRE)
        _same(ours, theirs)
        assert ours.cut is None and ours.regime == "slow"

    def test_empty_cost_model_ties_break_all_local(self):
        cm = {"schema": 1, "stages": {}}
        ours, theirs = _plans(cm=cm, peaks=None)
        _same(ours, theirs)
        assert ours.cut is None

    def test_too_short_chain_raises(self):
        with pytest.raises(ParseError, match="cannot partition"):
            plan_partition("videotestsrc ! tensor_sink", pipeline="p",
                           addr="a", cost_model={"schema": 1, "stages": {}})

    def test_stage_keys_and_costs_match_the_reference(self):
        assert tcostmodel.stage_key("pl", "f", 4, 2) == jcostmodel.stage_key("pl", "f", 4, 2)
        entry = _cost_model()["stages"][tcostmodel.stage_key("pl", "scale")]
        assert tplanner.stage_cost_us(entry) == jpart.stage_cost_us(entry) == 4000.0
        assert tplanner._placement_scale(entry, PEAKS) == pytest.approx(0.1)

    def test_default_wire_record_is_the_published_one(self):
        """``wire_health=None`` reads the record published for ``addr``."""
        tutil.publish_wire_health(dict(FAST_WIRE), addr="10.0.0.1:9")
        jutil.publish_wire_health(dict(FAST_WIRE), addr="10.0.0.1:9")
        cm = _cost_model()
        ours = plan_partition(DESC, pipeline="pl", addr="10.0.0.1:9", edge="edge0",
                              cost_model=cm, peaks=PEAKS)
        theirs = jpart.plan_partition(DESC, pipeline="pl", addr="10.0.0.1:9", edge="edge0",
                                      cost_model=cm, peaks=PEAKS)
        _same(ours, theirs)
        assert ours.cut == 2 and ours.put_150k_ms == 0.5

    def test_card_peaks_are_the_cards_never_a_tpus(self):
        """The placement scale's peaks come from the port's table, keyed on
        the card's name; a card not listed (or the host) is the host row."""
        h100 = card_peaks("NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3")
        assert h100["server"] == {"tflops": 989.0, "gbs": 3350.0}
        assert h100["client"] == h100["server"]
        assert card_peaks("cpu", "cpu")["client"] == {"tflops": 0.5, "gbs": 40.0}
        # equal peaks on both sides: every stage costs what it measured
        ours, theirs = _plans(peaks=h100)
        _same(ours, theirs)
        assert all(s[2] == tplanner.stage_cost_us(
            _cost_model()["stages"][tcostmodel.stage_key("pl", s[0])])
            for s in ours.score_for(1).stages)


# -- edge probing and deployment --------------------------------------------


class TestProbeEdgeHealth:
    def test_probe_over_live_server(self):
        with QueryServer(framework="custom", model=lambda x: x, device="cpu") as srv:
            spec = TensorsSpec.of(TensorSpec(dtype=F32, shape=(4,)))
            health = probe_edge_health("127.0.0.1", srv.port, spec, n=3)
        assert health["put_150k_ms"] > 0
        assert health["dispatch_ms"] > 0
        # a sub-reference payload reports the raw round trip (latency-bound)
        assert health["put_150k_ms"] == health["dispatch_ms"]

    def test_large_payload_scales_to_the_reference(self):
        with QueryServer(framework="custom", model=lambda x: x, device="cpu") as srv:
            spec = TensorsSpec.of(TensorSpec(dtype=F32, shape=(224, 224, 3)))
            health = probe_edge_health("127.0.0.1", srv.port, spec, n=2)
        assert health["put_150k_ms"] == pytest.approx(
            health["dispatch_ms"] * 150_528 / (224 * 224 * 3 * 4), abs=2e-3)


def _run(desc):
    p = tnns.parse_launch(desc)
    p.run(timeout=120)
    return [np.asarray(f.tensor(0)) for f in p["out"].frames]


class TestDeployment:
    def test_all_local_plan_is_a_noop_deploy(self):
        plan = _plan(wire=SLOW_WIRE, desc=TDESC)
        dep = PartitionDeployment(plan, device="cpu").start()
        try:
            assert dep.worker is None and dep.addr is None
            assert dep.client_launch() == TDESC
            spec = TensorsSpec.of(TensorSpec(dtype=np.uint8, shape=(4, 4, 3)))
            assert dep.register_edge(spec) is None
        finally:
            dep.stop()

    def test_split_runs_exact_with_hop_leg_and_chaos_ledger(self):
        """The deployed split reproduces the unsplit pipeline's frames
        exactly, through two seeded socket drops on the split edge, and each
        frame's trace carries the ``hop:edge0`` leg."""
        want = _run(TDESC.replace("num-buffers=6", "num-buffers=8"))
        assert len(want) == 8

        spans.enable(4096)
        plan = _plan(desc=TDESC)
        assert plan.split
        dep = PartitionDeployment(
            plan, device="cpu",
            client_props=dict(CPU_PROPS, retries="2", retry_backoff_ms="5")).start()
        try:
            spec = TensorsSpec.of(TensorSpec(dtype=np.uint8, shape=(4, 4, 3)))
            dep.register_edge(spec)
            assert dep.addr in tutil.wire_health_by_addr()
            assert dep.addr in tutil.wire_edges()

            eng = faults.install("socket_drop@server:every=3,count=2")
            launch = dep.client_launch().replace("num-buffers=6", "num-buffers=8")
            pipe = tnns.parse_launch(launch)
            pipe.attach_tracer(SpanTracer())
            pipe.run(timeout=120)
            got = [np.asarray(f.tensor(0)) for f in pipe["out"].frames]
            assert len(got) == 8
            for w, g in zip(want, got):
                np.testing.assert_array_equal(w, g)
            assert eng.injections["socket_drop"] == 2
            assert pipe[f"qc_{plan.edge}"].retries_total == 2

            by_trace = {}
            for r in spans.snapshot():
                if r[0] == spans.PH_COMPLETE and r[6]:
                    by_trace.setdefault(r[6], []).append(r)
            hop_traces = [t for t, recs in by_trace.items()
                          if any(r[4] == "nnsq_rtt" and isinstance(r[9], dict)
                                 and r[9].get("edge") == "edge0" for r in recs)]
            assert len(hop_traces) >= 8
            for t in hop_traces:
                legs = attribute_trace(by_trace[t])
                assert legs["hop:edge0"] >= 0.0
        finally:
            dep.stop()
        assert dep.addr is None and not tutil.wire_edges()

    def test_warming_gate_waits_for_the_worker(self):
        """The gate polls the worker's probe until it reports ``ok``; a worker
        that never does times out and is stopped."""
        class Slow:
            host, query_port, name = "127.0.0.1", 1, "slow"

            def __init__(self):
                self.calls, self.stopped = 0, False

            def start(self):
                return self

            def probe(self):
                self.calls += 1
                return "ok" if self.calls >= 3 else "warming:capture-ahead warmup"

            def stop(self):
                self.stopped = True

        made = []
        dep = PartitionDeployment(_plan(desc=TDESC), warm_timeout_s=5.0,
                                  worker_factory=lambda *a: made.append(Slow()) or made[-1])
        dep.start()
        assert dep.worker is made[0] and made[0].calls == 3

        class Never(Slow):
            def probe(self):
                return "warming:capture-ahead warmup"

        dep = PartitionDeployment(_plan(desc=TDESC), warm_timeout_s=0.1,
                                  worker_factory=lambda *a: made.append(Never()) or made[-1])
        with pytest.raises(TimeoutError, match="not servable"):
            dep.start()
        assert made[-1].stopped

    def test_entry_points_default_to_the_card(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        dep = PartitionDeployment(_plan(desc=TDESC))
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            dep.start()


# -- the repartition monitor ------------------------------------------------


class TestRepartitionMonitor:
    def _deploy(self, tmp_path, monkeypatch, cm=None):
        cm = cm or _cost_model()
        path = tmp_path / "COST_MODEL.json"
        path.write_text(json.dumps(cm))
        monkeypatch.setenv("NNSTPU_OBS_COSTMODEL_PATH", str(path))
        plan = _plan(cm=cm, desc=TDESC)
        assert plan.cut == 2
        dep = PartitionDeployment(plan, device="cpu").start()
        # a fixed edge record: a real loopback probe's regime depends on timing
        tutil.publish_wire_health(dict(FAST_WIRE), addr=dep.addr)
        return dep, path

    def test_regime_flip_exactly_one_redeploy(self, tmp_path, monkeypatch):
        dep, _ = self._deploy(tmp_path, monkeypatch)
        try:
            mon = RepartitionMonitor(dep, peaks=PEAKS)
            assert mon.evaluate_once() is None  # steady state: no churn
            old_worker = dep.worker
            assert old_worker is not None

            tutil.publish_wire_health(dict(SLOW_WIRE), addr=dep.addr)
            reason = mon.evaluate_once()
            assert reason and "regime flip" in reason
            # the slow edge prices every split out: all-local, through the
            # migrate-first drain, exactly once
            assert dep.plan.cut is None
            assert dep.worker is None
            assert dep.redeploys == 1
            assert old_worker.stats()["draining"] and old_worker.stats()["killed"]
            assert mon.evaluate_once() is None  # the baseline advanced
            assert mon.triggers == 1
        finally:
            dep.stop()

    def test_cost_drift_replans_without_churn(self, tmp_path, monkeypatch):
        """A drifted stage cost re-plans; an unchanged cut re-prices the
        baseline but never restarts the worker."""
        dep, path = self._deploy(tmp_path, monkeypatch)
        try:
            mon = RepartitionMonitor(dep, peaks=PEAKS)
            assert mon.evaluate_once() is None
            worker = dep.worker
            path.write_text(json.dumps(_cost_model(scale_us=8000.0)))
            reason = mon.evaluate_once()
            assert reason and "drift" in reason and "scale" in reason
            assert dep.plan.cut == 2
            assert dep.redeploys == 0 and dep.worker is worker
            assert dep.plan.chosen.server_us == pytest.approx(1100.0)
            assert mon.evaluate_once() is None  # re-priced: the drift is consumed
        finally:
            dep.stop()

    def test_watchdog_cadence_reprobes_registered_edges(self):
        """The edge's registered prober runs on the watchdog's wire cadence
        and publishes under the edge's address (the local probe needs the
        card and fails here without flagging anything)."""
        from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog

        calls = []
        tutil.register_wire_edge("10.0.0.2:7", lambda: calls.append(1) or dict(SLOW_WIRE))
        wd = PipelineWatchdog.__new__(PipelineWatchdog)
        wd._wire_probe_s, wd._last_wire_probe, wd._registry = 0.001, 0.0, None
        wd._probe_wire()
        assert calls == [1]
        assert tutil.wire_health_by_addr()["10.0.0.2:7"]["regime"] == "slow"
        assert tutil._wire_stats()["edges"]["10.0.0.2:7"]["put_150k_ms"] == 50.0
        tutil.unregister_wire_edge("10.0.0.2:7")
        assert "10.0.0.2:7" not in tutil.wire_edges()


def test_subprocess_fragment_worker_split_and_redeploy(tmp_path, monkeypatch):
    """The server fragment in a worker process (``--device cpu``): the
    warming gate, a real edge probe, frames equal to the unsplit run, and a
    regime flip that redeploys all-local through the worker's SIGTERM drain;
    the worker process exits 0."""
    path = tmp_path / "COST_MODEL.json"
    path.write_text(json.dumps(_cost_model()))
    monkeypatch.setenv("NNSTPU_OBS_COSTMODEL_PATH", str(path))
    want = _run(TDESC)
    log = open(tmp_path / "worker.log", "w", encoding="utf-8")
    plan = _plan(desc=TDESC)
    dep = PartitionDeployment(
        plan, warm_timeout_s=60.0, client_props=CPU_PROPS,
        worker_factory=subproc_worker_factory(device="cpu", stderr=log,
                                              line_timeout_s=120.0)).start()
    try:
        worker = dep.worker
        assert isinstance(worker, SubprocFragmentWorker) and worker.probe() == "ok"
        health = dep.register_edge(TensorsSpec.of(TensorSpec(dtype=np.uint8, shape=(4, 4, 3))))
        assert health["dispatch_ms"] > 0 and health["regime"] in ("fast", "slow")
        got = _run(dep.client_launch())
        assert len(got) == len(want) == 6
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        # pin the deployed plan to the measured edge, then flip it
        tutil.publish_wire_health(dict(FAST_WIRE), addr=dep.addr)
        dep.plan = dataclasses.replace(dep.plan, regime="fast")
        mon = RepartitionMonitor(dep, peaks=PEAKS)
        assert mon.evaluate_once() is None
        tutil.publish_wire_health(dict(SLOW_WIRE), addr=dep.addr)
        assert "regime flip" in mon.evaluate_once()
        assert dep.redeploys == 1 and dep.worker is None and dep.plan.cut is None
        assert worker.returncode == 0
        assert _run(dep.client_launch()) is not None
        assert mon.evaluate_once() is None and mon.triggers == 1
    finally:
        dep.stop()
        log.close()


def test_partition_imports_no_jax():
    code = ("import sys\n"
            "for n in ('jax', 'jaxlib', 'nnstreamer_tpu'):\n"
            "    sys.modules[n] = None\n"
            "import nnstreamer_tpu_torch.partition as p\n"
            "from nnstreamer_tpu_torch.partition import deploy, monitor, planner\n"
            "print(p.plan_partition.__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "nnstreamer_tpu_torch.partition.planner"
