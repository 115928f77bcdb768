"""The port's cluster observability (``obs/costmodel.py``, ``obs/slo.py``,
``obs/collector.py``, ``obs/forensics.py``) against the JAX package's.

Same inputs, equal outputs, on the CPU: the cost model's Welford legs, its
pooled merges and the ``COST_MODEL.json`` documents of the same stage
snapshots and run ids (equal as JSON but for the write times, and each
package reading and merging into the other's file), a tracer fed the same
hook-bus emissions; the SLO grammar, the burn-rate engine's alert documents
and hook transitions over the same metric sequence, and ``merge_alerts``;
the collector's ``attribute_trace``, ``federate_metrics``,
``estimate_clock_offset`` (on a scripted clock) and merged trace joins;
forensics' leg folding, its cost-model baselines, an engine's verdicts over
the same trace stream, and the capture gallery's keep and eviction.
"""

import itertools
import json
import os

import numpy as np
import pytest

from nnstreamer_tpu.obs import collector as jcol
from nnstreamer_tpu.obs import costmodel as jcm
from nnstreamer_tpu.obs import forensics as jfor
from nnstreamer_tpu.obs import hooks as jhooks
from nnstreamer_tpu.obs import slo as jslo
from nnstreamer_tpu.obs import spans as jspans
from nnstreamer_tpu.obs.metrics import MetricsRegistry as JRegistry
from nnstreamer_tpu_torch.obs import collector as tcol
from nnstreamer_tpu_torch.obs import costmodel as tcm
from nnstreamer_tpu_torch.obs import forensics as tfor
from nnstreamer_tpu_torch.obs import hooks as thooks
from nnstreamer_tpu_torch.obs import slo as tslo
from nnstreamer_tpu_torch.obs import spans as tspans
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry as TRegistry

MS = 1e6


def _strip_times(doc):
    """A cost-model document without its write times."""
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items() if k != "updated_at"}
    return doc


# -- the cost model -----------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_leg_stats_pool_and_band_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    a_vals, b_vals = rng.normal(100, 10, 40), rng.normal(140, 25, 25)
    out = {}
    for name, cm in (("jax", jcm), ("torch", tcm)):
        a, b = cm.LegStat(), cm.LegStat()
        for v in a_vals:
            a.add(float(v), 0.2)
        for v in b_vals:
            b.add(float(v), 0.35)
        pooled = cm.combine_legs(a.snapshot(), b.snapshot())
        out[name] = dict(a=a.snapshot(), b=b.snapshot(), pooled=pooled,
                         std=cm.leg_std_us(pooled), band=cm.leg_band_us(pooled),
                         band_tight=cm.leg_band_us(pooled, 2.0, 0.05, 1.0),
                         empty=cm.combine_legs({}, a.snapshot()),
                         key=cm.stage_key("p", "f", 4, 2))
    assert out["torch"] == out["jax"]


def _snap(pipeline, node, mean, count=10, bucket=4):
    return {"pipeline": pipeline, "node": node, "bucket": bucket, "mesh": 1,
            "flops_per_frame": 1.5e9, "bytes_per_frame": 2.0e6,
            "legs": {"dispatch": {"count": count, "mean_us": mean, "m2": 90.0, "ewma_us": mean},
                     "device_exec": {"count": count, "mean_us": mean / 2, "m2": 30.0,
                                     "ewma_us": mean / 2}}}


def test_merge_cost_model_documents_are_the_references(tmp_path):
    """Runs over the history bound, a re-merged run replacing its own, two
    stages: the merged documents are equal as JSON but for write times."""
    paths = {"jax": str(tmp_path / "j.json"), "torch": str(tmp_path / "t.json")}
    for name, cm in (("jax", jcm), ("torch", tcm)):
        for i in range(cm.MAX_RUNS + 2):
            stages = {cm.stage_key("p", "f", 4, 1): _snap("p", "f", 100.0 + i),
                      cm.stage_key("p", "g", 8, 1): _snap("p", "g", 50.0 + 2 * i, bucket=8)}
            cm.merge_cost_model(stages, f"run{i:02d}", paths[name])
        cm.merge_cost_model({cm.stage_key("p", "f", 4, 1): _snap("p", "f", 7.0, count=3)},
                            f"run{cm.MAX_RUNS + 1:02d}", paths[name])
    docs = {k: _strip_times(json.load(open(p))) for k, p in paths.items()}
    assert docs["torch"] == docs["jax"]
    f = docs["torch"]["stages"][tcm.stage_key("p", "f", 4, 1)]
    assert len(f["runs"]) == tcm.MAX_RUNS and f["legs"]["dispatch"]["count"] == 33
    assert tcm.SCHEMA_VERSION == jcm.SCHEMA_VERSION


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_and_merges_the_others_file(writer, tmp_path):
    path = str(tmp_path / "COST_MODEL.json")
    first, second = (jcm, tcm) if writer == "jax" else (tcm, jcm)
    first.merge_cost_model({first.stage_key("p", "f", 4, 1): _snap("p", "f", 100.0)}, "a", path)
    read = second.load_cost_model(path)
    assert _strip_times(read) == _strip_times(first.load_cost_model(path))
    second.merge_cost_model({second.stage_key("p", "f", 4, 1): _snap("p", "f", 200.0)}, "b",
                            path)
    both = first.load_cost_model(path)
    pooled = both["stages"][first.stage_key("p", "f", 4, 1)]["legs"]["dispatch"]
    assert pooled["count"] == 20 and pooled["mean_us"] == pytest.approx(150.0)
    # and a reference-pooled view over it: identical in both packages
    assert jfor.baselines_from_cost_model(both, "p") == tfor.baselines_from_cost_model(both, "p")


class _Pipe:
    def __init__(self, name):
        self.name = name
        self._leaves = set()


class _Node:
    def __init__(self, name, pipeline):
        self.name = name
        self.pipeline = pipeline


class _Item:
    tensors = ()


def _drive_tracer(cm, hooks, monkeypatch):
    """The same hook-bus emissions into one package's CostModelTracer, on a
    scripted clock; returns its summary and stage snapshots."""
    clock = itertools.count(1_000_000, 250_000)
    monkeypatch.setattr(cm, "now_ns", lambda: next(clock))
    pipe = _Pipe("cmpar")
    f, q = _Node("f", pipe), _Node("q", pipe)
    tr = cm.CostModelTracer(registry=(JRegistry if cm is jcm else TRegistry)(), alpha=0.3)
    tr.start(pipe)
    try:
        for i in range(6):
            hooks.emit("queue_push", q, i)
            hooks.emit("queue_pop", q, i)
            hooks.emit("dispatch_exit", f, None, _Item(), 1000 * (i + 3))
            hooks.emit("device_exec", "cmpar", "f", "cpu:0", 0, 2000 * (i + 1),
                       {"bucket": 4, "mesh": 1, "flops": 3e9, "bytes": 1e6})
        hooks.emit("queue_drop", q, "upstream")
        hooks.emit("queue_push", q, 0)  # swallowed by the upstream drop
        hooks.emit("queue_pop", q, 0)   # a pop that overtook its push
        hooks.emit("queue_push", q, 0)
        hooks.emit("copy", f, 150528, 1)
        summary = tr.summary()
        snaps = tr.stage_snapshots()
    finally:
        for hook, fn in list(tr._conns):
            hooks.disconnect(hook, fn)
        tr._conns.clear()
        with cm._live_lock:
            cm._live.pop("cmpar", None)
    summary.pop("run_id")
    return summary, snaps


def test_tracer_fed_the_same_hooks_gives_the_references_model(monkeypatch):
    got = {"jax": _drive_tracer(jcm, jhooks, monkeypatch),
           "torch": _drive_tracer(tcm, thooks, monkeypatch)}
    assert got["torch"] == got["jax"]
    summary, snaps = got["torch"]
    legs = summary["stages"]["f"]["legs"]
    assert legs["device_exec"]["count"] == 6 and legs["dispatch"]["count"] == 6
    assert summary["stages"]["q"]["legs"]["queue_wait"]["count"] == 7
    assert tcm.stage_key("cmpar", "f", 4, 1) in snaps


# -- the SLO engine -----------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "e2e:<50ms@0.999; tenantA:{tenant=A,pipeline=p}<25ms@0.99;dev:nnstpu_device_ms{}<7.5ms@0.9",
    "", " ; ", "x:{pipeline=fleet-d}<100ms@0.99",
])
def test_objective_grammar_is_the_references(spec):
    got = {k: [(o.name, o.spec(), o.budget) for o in m.parse_objectives(spec)]
           for k, m in (("jax", jslo), ("torch", tslo))}
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("bad", ["no-colon<50ms@0.9x", "e2e:<50ms@1.5", "e2e:<0ms@0.9",
                                 "e2e:{tenant}<50ms@0.9", "<50ms@0.9", "e2e:50ms@0.9"])
def test_malformed_objectives_fail_alike(bad):
    msgs = {}
    for k, m in (("jax", jslo), ("torch", tslo)):
        with pytest.raises(ValueError, match="objective") as ei:
            m.parse_objectives(bad)
        msgs[k] = str(ei.value)
    assert msgs["torch"] == msgs["jax"]


def _burn_run(slo, hooks, reg_cls):
    reg = reg_cls()
    h = reg.histogram("nnstpu_e2e_latency_ms", "e2e", labelnames=("pipeline", "src", "sink"),
                      buckets=(10.0, 50.0, 100.0))
    eng = slo.SloEngine(objectives=[slo.Objective("e2e", 50.0, 0.9),
                                    slo.Objective("a", 10.0, 0.99, labels={"pipeline": "a"})],
                        registry=reg, fast_window_s=10.0, slow_window_s=60.0, fast_burn=5.0,
                        slow_burn=2.0, eval_interval_s=0.0)
    seen = []
    on_alert = lambda *a: seen.append(a)  # noqa: E731
    hooks.connect("alert", on_alert)
    try:
        docs = []
        plan = [(0.0, 20, 5.0, "p"), (5.0, 20, 500.0, "p"), (7.0, 5, 30.0, "a"),
                (20.0, 3, 500.0, "a"), (100.0, 5, 5.0, "p"), (200.0, 0, 0.0, "p")]
        for now, n, value, pipe in plan:
            for _ in range(n):
                h.labels(pipeline=pipe, src="t", sink="k").observe(value)
            docs.append(eng.alerts_document(now=now, force=True))
            docs.append(eng.degraded_reason())
        return docs, seen
    finally:
        hooks.disconnect("alert", on_alert)


def test_burn_rate_alerts_over_the_same_metric_sequence():
    got = {"jax": _burn_run(jslo, jhooks, JRegistry),
           "torch": _burn_run(tslo, thooks, TRegistry)}
    assert got["torch"] == got["jax"]
    docs, seen = got["torch"]
    assert docs[2]["firing"] == ["e2e"] and docs[-2]["firing"] == []
    assert [s[1] for s in seen if s[0] == "e2e"] == ["firing", "resolved"]


def _worker_doc(good, total, firing, target=0.9):
    burn = ((total - good) / total) / (1 - target) if total else 0.0
    return {"objectives": {"e2e": {
        "metric": "nnstpu_e2e_latency_ms", "labels": {}, "bound_ms": 50.0, "target": target,
        "state": "firing" if firing else "ok", "severity": "page" if firing else "",
        "transitions": 1 if firing else 0,
        "windows": {"fast": {"window_s": 10.0, "good": good, "total": total,
                             "burn": round(burn, 4), "threshold": 5.0},
                    "slow": {"window_s": 60.0, "good": good, "total": total,
                             "burn": round(burn, 4), "threshold": 2.0}}}},
        "firing": ["e2e"] if firing else []}


@pytest.mark.parametrize("docs", [
    {"w0": _worker_doc(0, 100, True), "w1": _worker_doc(100, 100, False)},
    {"w0": _worker_doc(40, 100, False), "w1": _worker_doc(40, 100, False)},
    {"w0": _worker_doc(100, 100, False)},
    {"w0": _worker_doc(0, 0, False), "w1": {"objectives": {}, "firing": []}},
])
def test_merge_alerts_is_the_references(docs):
    assert tcol.merge_alerts(docs) == jcol.merge_alerts(docs)


# -- the collector ------------------------------------------------------------


def _rec(ts, dur, name, trace_id, span_id, parent=0, tid="t0", cat="span", args=None):
    return ("X", ts, dur, tid, name, cat, trace_id, span_id, parent, args)


RECORD_SETS = {
    "full": [_rec(0, 100, "nnsq_rtt", 1, 1), _rec(5, 80, "nnsq_route", 1, 2, 1),
             _rec(10, 60, "nnsq_serve", 1, 3, 2), _rec(12, 20, "sched_wait", 1, 4, 3),
             _rec(40, 30, "device_invoke", 1, 5, 3), _rec(45, 22, "device_exec", 1, 6, 3),
             _rec(30, 7, "device_idle", 1, 7, 3)],
    "no_envelope": [_rec(0, 100, "nnsq_rtt", 1, 1), _rec(12, 20, "sched_wait", 1, 2),
                    _rec(40, 30, "device_invoke", 1, 3)],
    "edges": [_rec(0, 100, "nnsq_rtt", 1, 1, args={"edge": "edge0"}),
              _rec(10, 60, "nnsq_serve", 1, 2, 1), _rec(0, 50, "nnsq_rtt", 1, 3,
                                                         args={"edge": "edge1"}),
              _rec(20, 10, "slot_wait", 1, 4, 2)],
    "serve_only": [_rec(0, 40, "nnsq_serve", 9, 1), _rec(1, 30, "device_exec", 9, 2, 1)],
}


@pytest.mark.parametrize("case", sorted(RECORD_SETS))
def test_attribute_trace_is_the_references(case):
    recs = RECORD_SETS[case]
    assert tcol.attribute_trace(recs) == jcol.attribute_trace(recs)
    legs = tcol.attribute_trace(recs)
    assert tfor.verdict_legs_us(legs) == jfor.verdict_legs_us(legs)


EXPOSITIONS = {
    "w0": ("# HELP nnstpu_x_total x\n# TYPE nnstpu_x_total counter\n"
           'nnstpu_x_total{k="a"} 3\nnnstpu_x_total{k="b"} 1\n'
           "# HELP nnstpu_h_ms h\n# TYPE nnstpu_h_ms histogram\n"
           'nnstpu_h_ms_bucket{le="1"} 2 # {trace_id="ab"} 0.5 1.0\n'
           "nnstpu_h_ms_sum 1.5\nnnstpu_h_ms_count 2\n"),
    "w1": ("# HELP nnstpu_x_total x\n# TYPE nnstpu_x_total counter\n"
           'nnstpu_x_total{k="a"} 5\nnnstpu_bare 7\n# a comment\n\n'),
    'w"2': "nnstpu_plain 1\n",
}


@pytest.mark.parametrize("label", ["worker", "pod"])
def test_federate_metrics_is_the_references(label):
    assert tcol.federate_metrics(EXPOSITIONS, label) == jcol.federate_metrics(EXPOSITIONS, label)


def test_clock_offset_estimate_on_a_scripted_clock(monkeypatch):
    """Both estimators on the same scripted local and remote clocks: the
    same best probe, offset and round trip."""
    out = {}
    for name, col, sp in (("jax", jcol, jspans), ("torch", tcol, tspans)):
        local = iter([0, 900, 2000, 2100, 5000, 5600, 9000, 9950, 12000, 12300])
        remote = iter([70_500, 72_000, 75_310, 79_500, 82_100])
        monkeypatch.setattr(sp, "now_ns", lambda: next(local))
        out[name] = col.estimate_clock_offset(lambda: next(remote), samples=5)
    assert out["torch"] == out["jax"] == (69_950, 100)


def test_merged_trace_joins_are_the_references():
    """Two sources, one skewed by a known offset: the same join index and
    the same hop flows in both packages' collectors."""
    client = [_rec(1000, 500, "nnsq_rtt", 0xA, 1, tid="c"),
              _rec(1010, 480, "nnsq_route", 0xA, 2, 1, tid="r")]
    worker = [_rec(51_020, 400, "nnsq_serve", 0xA, 3, 2, tid="w"),
              _rec(51_030, 300, "device_exec", 0xA, 4, 3, tid="d"),
              _rec(51_500, 10, "nnsq_serve", 0xB, 5, 0, tid="w")]
    out = {}
    for name, col in (("jax", jcol), ("torch", tcol)):
        c = col.TraceCollector()
        c.add_source(col.TraceSource("client", lambda: {"records": client, "pid": 1}))
        src = c.add_source(col.TraceSource("w0", lambda: {"records": worker, "pid": 2}))
        src.offset_ns = 50_000
        got = c.collect()
        index = c.spans_by_trace(got)
        legs = {tid: col.attribute_trace(recs) for tid, recs in index.items()}
        merged = c.chrome_trace(got)
        hops = [e for e in merged["traceEvents"] if e.get("name") == "nnsq_hop"]
        out[name] = dict(index=index, legs=legs, hops=len(hops))
    assert out["torch"]["index"] == out["jax"]["index"]
    assert out["torch"]["legs"] == out["jax"]["legs"]
    assert out["torch"]["index"][0xA][2][1] == 1020  # aligned by the offset
    assert out["torch"]["legs"][0xA]["wire"] == 20.0


def test_trace_document_shape_is_the_references():
    tspans.enable()
    try:
        tdoc, jdoc = tcol.trace_document(), jcol.trace_document()
        assert set(tdoc) == set(jdoc) and set(tcol.trace_document(True)) == {
            "process", "pid", "clock_ns"}
    finally:
        tspans.disable()


# -- tail forensics -----------------------------------------------------------


@pytest.mark.parametrize("pipeline", ["", "p", "absent"])
def test_cost_model_baselines_are_the_references(pipeline):
    doc = {"stages": {
        "a": {"pipeline": "p", "legs": {"device_exec": {"count": 100, "mean_us": 10_000.0,
                                                        "m2": 5e5},
                                        "dispatch": {"count": 50, "mean_us": 300.0, "m2": 10.0},
                                        "queue_wait": {"count": 7, "mean_us": 20.0, "m2": 1.0}}},
        "b": {"pipeline": "q", "legs": {"device_exec": {"count": 10, "mean_us": 500.0,
                                                        "m2": 40.0},
                                        "wire": {"count": 3, "mean_us": 90.0, "m2": 2.0},
                                        "unknown_leg": {"count": 1, "mean_us": 1.0}}}}}
    assert (tfor.baselines_from_cost_model(doc, pipeline)
            == jfor.baselines_from_cost_model(doc, pipeline))


def _stream(rng):
    """A seeded trace stream: inliers around 10 ms, a few device and queue
    outliers with their joined records."""
    out = []
    for i in range(60):
        tid = 0x100 + i
        if i in (20, 33, 47):
            dev = 80.0 + i
            recs = [_rec(0, int(100 * MS), "nnsq_rtt", tid, 1),
                    _rec(0, int(95 * MS), "nnsq_serve", tid, 2, 1),
                    _rec(0, int(2 * MS), "sched_wait", tid, 3, 2),
                    _rec(0, int(dev * MS), "device_invoke", tid, 4, 2)]
            out.append((tid, 100 * MS, recs))
        elif i in (25, 51):
            recs = [_rec(0, int(120 * MS), "nnsq_rtt", tid, 1),
                    _rec(0, int(110 * MS), "nnsq_serve", tid, 2, 1),
                    _rec(0, int(100 * MS), "sched_wait", tid, 3, 2)]
            out.append((tid, 120 * MS, recs))
        else:
            total = float(rng.normal(10.0, 0.5)) * MS
            recs = [_rec(0, int(total), "nnsq_rtt", tid, 1),
                    _rec(0, int(total * 0.9), "nnsq_serve", tid, 2, 1),
                    _rec(0, int(total * 0.6), "device_invoke", tid, 3, 2)]
            out.append((tid, total, recs))
    return out


def test_engine_verdicts_over_the_same_stream(tmp_path):
    doc = {"stages": {"s": {"pipeline": "p", "legs": {
        "device_exec": {"count": 100, "mean_us": 6000.0, "m2": 1e5}}}}}
    out = {}
    for name, fr, reg in (("jax", jfor, JRegistry), ("torch", tfor, TRegistry)):
        stream = _stream(np.random.default_rng(3))
        eng = fr.ForensicsEngine(pipeline="p", registry=reg(), cost_model=doc,
                                 gallery_dir=str(tmp_path / name), keep=2, max_bytes=0,
                                 min_samples=16)
        verdicts = []
        for tid, total, recs in stream:
            v = eng.score_trace(tid, total, records=recs)
            if v is not None:
                v.pop("captured_at")
                v["capture"] = os.path.basename(v.get("capture") or "")
                verdicts.append(v)
        summ = eng.summary()
        summ["gallery"].pop("dir")
        out[name] = dict(verdicts=verdicts, summary=summ,
                         kept=sorted(os.listdir(str(tmp_path / name))))
    assert out["torch"] == out["jax"]
    r = out["torch"]
    assert r["summary"]["outliers"] == {"device": 3, "queue_wait": 2}
    assert len(r["kept"]) == 2 and r["summary"]["gallery"]["evicted"] == 3


@pytest.mark.parametrize("keep,max_bytes", [(3, 0), (1, 0), (100, 400)])
def test_gallery_keep_and_eviction_are_the_references(keep, max_bytes, tmp_path):
    out = {}
    for name, fr in (("jax", jfor), ("torch", tfor)):
        g = fr._Gallery(str(tmp_path / name), keep=keep, max_bytes=max_bytes)
        paths = [g.add({"pipeline": "p", "trace_id": f"{i:x}", "total_ms": ms,
                        "verdict": "device"}, {"traceEvents": []})
                 for i, ms in enumerate([50.0, 10.0, 90.0, 30.0, 70.0, 20.0])]
        summ = g.summary()
        summ.pop("dir")
        out[name] = dict(paths=[os.path.basename(p) if p else None for p in paths],
                         summary=summ, kept=sorted(os.listdir(str(tmp_path / name))))
        g2 = fr._Gallery(str(tmp_path / name), keep=keep, max_bytes=max_bytes)
        out[name]["rescanned"] = g2.summary()["entries"]
    assert out["torch"] == out["jax"]
