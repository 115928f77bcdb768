"""The port's load generator (``nnstreamer_tpu_torch/tools/loadgen.py``)
against the JAX package's ``tools/loadgen.py``, on the CPU.

The offered-load profiles' ``rate_fn`` and the drawn open-loop arrival
schedules are equal bit for bit for the same seed and profile, and so is a
load session's merged plan; replay files parse to the same plan; the report
math (ceil-rank percentiles, the SLO checks) and the default payloads are
the reference's; and the ``ci-slo`` scenario runs on an in-process fleet of
the port with an exact ledger.  No latency or rate is asserted: the run's
checks are its accounting.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from nnstreamer_tpu.obs import spans as jspans
from nnstreamer_tpu_torch.obs import spans as tspans
from nnstreamer_tpu_torch.tools import loadgen as tlg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_loadgen",
                                               os.path.join(ROOT, "tools", "loadgen.py"))
jlg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jlg)

PROFILES = {
    "constant": dict(kind="constant", rate=100.0),
    "ramp": dict(kind="ramp", lo=5.0, hi=100.0),
    "spike": dict(kind="spike", rate=5.0, peak=200.0, at=0.5, width=0.2),
    "spike_edge": dict(kind="spike", rate=10.0, peak=50.0, at=0.9, width=0.3),
    "diurnal": dict(kind="diurnal", rate=28.0, amp=0.9, periods=1),
    "diurnal2": dict(kind="diurnal", rate=30.0, amp=0.8, periods=2),
    "zero": dict(kind="constant", rate=0.0),
}


@pytest.fixture(autouse=True)
def _fresh_spans():
    tspans.reset()
    jspans.reset()
    yield
    tspans.reset()
    jspans.reset()


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_rate_fn_is_the_references(name):
    tf, tpeak = tlg.rate_fn(PROFILES[name])
    jf, jpeak = jlg.rate_fn(PROFILES[name])
    ts = np.linspace(0.0, 1.0, 97)
    assert tpeak == jpeak
    assert [tf(float(t)) for t in ts] == [jf(float(t)) for t in ts]


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_arrival_schedules_are_equal_bit_for_bit(name, seed):
    got = tlg.gen_arrivals(PROFILES[name], 5.0, seed)
    want = jlg.gen_arrivals(PROFILES[name], 5.0, seed)
    assert got == want
    assert got == sorted(got) and all(0.0 <= t < 5.0 for t in got)


def test_unknown_profile_fails_alike():
    for lg in (tlg, jlg):
        with pytest.raises(ValueError, match="unknown profile kind"):
            lg.rate_fn(dict(kind="sawtooth"))


TENANTS = [dict(name="flood", workload="vision", profile=PROFILES["constant"]),
           dict(name="cam", workload="ssd_cascade", profile=PROFILES["ramp"]),
           dict(name="mic", workload="lstm_window", profile=PROFILES["spike"])]


@pytest.mark.parametrize("seed", [3, 7])
def test_session_plan_is_the_references(seed):
    t = tlg.LoadGen(("127.0.0.1", 1), TENANTS, 2.5, seed=seed).schedule()
    j = jlg.LoadGen(("127.0.0.1", 1), TENANTS, 2.5, seed=seed).schedule()
    assert t == j and len(t) > 100


def test_replay_file_parses_to_the_references_plan(tmp_path):
    path = tmp_path / "replay.json"
    path.write_text(json.dumps([
        {"t": 0.2, "tenant": "cam", "workload": "vision"},
        {"t": 0.1, "tenant": "flood", "workload": "vision"},
        {"t": "0.05", "tenant": "cam", "workload": "vision"},
        {"t": 0.3, "tenant": "ghost", "workload": "vision"},
    ]))
    t_entries, j_entries = tlg.load_replay(str(path)), jlg.load_replay(str(path))
    assert t_entries == j_entries
    t = tlg.LoadGen(("127.0.0.1", 1), TENANTS, 1.0).schedule(t_entries)
    j = jlg.LoadGen(("127.0.0.1", 1), TENANTS, 1.0).schedule(j_entries)
    assert t == j and [a for a, _, _ in t] == [0.05, 0.1, 0.2]


@pytest.mark.parametrize("vals", [list(range(1, 101)), [5.0], [], [3.0, 1.0, 2.0, 9.0] * 7])
def test_percentiles_and_summaries_are_the_references(vals):
    s = sorted(vals)
    for q in (0.5, 0.9, 0.99, 0.999):
        assert tlg.pct(s, q) == jlg.pct(s, q)
    ns = [v * 1e6 for v in vals]
    assert tlg.summarize_ms(ns) == jlg.summarize_ms(ns)


REPORTS = {
    "failing": (
        {"tenants": {"good": {"well_behaved": True, "offered": 10, "ok": 8, "typed_total": 2,
                              "transport": 0, "latency_ms": {"p99_ms": 900.0}},
                     "flood": {"well_behaved": False, "offered": 10, "ok": 10,
                               "typed_total": 0, "transport": 0,
                               "latency_ms": {"p99_ms": 1.0}}},
         "ledger": {"exact": False, "client": {"sent": 20, "ok": 18, "typed": 2,
                                               "transport": 3}}},
        dict(well_behaved_p99_ms=500.0, well_behaved_goodput_min=0.95, flood_shed_min=1,
             ledger_exact=True, max_transport_errors=0)),
    "fleet": (
        {"tenants": {}, "ledger": {"exact": True, "client": {"transport": 0}},
         "fleet": {"min": 1, "max": 3, "final": 1, "spawn_ledger_exact": True}},
        dict(max_fleet=3, min_fleet=1)),
    "sessions": (
        {"tenants": {}, "ledger": {"exact": True, "client": {"transport": 0}},
         "decode_sessions": {"total": 4, "completed": 3, "broken": 1, "shed": 0}},
        dict(stateful_goodput_min=1.0, max_broken_sessions=0)),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_slo_checks_are_the_references(case):
    report, slo = REPORTS[case]
    assert tlg.check_slo(report, slo) == jlg.check_slo(report, slo)


@pytest.mark.parametrize("name", ["vision", "ssd_cascade", "lstm_window", "vit", "audio_cnn",
                                  "text_classifier", "decode"])
def test_workload_payloads_are_the_references(name):
    tw, jw = tlg.WORKLOADS[name](), jlg.WORKLOADS[name]()
    assert (tw.kind, tw.chain, tw.prompt_len, tw.burst, tw.steps, tw.gap_ms) == \
        (jw.kind, jw.chain, jw.prompt_len, jw.burst, jw.steps, jw.gap_ms)
    for seq in (0, 3, 11):
        for a, b in zip(tw.frames(seq), jw.frames(seq)):
            np.testing.assert_array_equal(a[0], b[0])


def test_scenario_matrix_is_the_references():
    assert sorted(tlg.SCENARIOS) == sorted(jlg.SCENARIOS)
    for name, sc in tlg.SCENARIOS.items():
        ref = jlg.SCENARIOS[name]
        assert sc["tenants"] == ref["tenants"] and sc.get("slo") == ref.get("slo")
        assert sc["duration_s"] == ref["duration_s"]


def test_ci_slo_scenario_ledger_on_the_ports_fleet():
    """The CI gate's scenario on an in-process fleet of the port (two
    workers, DRR at the door and in each worker): every request accounted
    on both sides of the wire, the router's ledger exact, nothing lost to
    transport, the flood tenant's refusals typed."""
    report = tlg.run_scenario("ci-slo", seed=7, duration_s=1.5, device="cpu")
    led = report["ledger"]
    assert led["client_exact"] and led["router_exact"] and led["exact"], led
    assert led["client"]["transport"] == 0
    rt = led["router"]
    assert rt["offered"] == rt["delivered"] + rt["shed_total"]
    assert set(rt["tenants"]) == {"flood", "tenant-a", "tenant-b", "tenant-c"}
    assert set(report["tenants"]["flood"]["typed"]) <= {"OVERLOAD"}
    assert report["attribution"]["joined"] > 0
    assert report["server"]["workers"]["lg-ci-slo-w0"]["device"] == "cpu"
