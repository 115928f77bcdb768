"""The port's tools against the JAX package's, on the CPU: perfdiff,
the custom-filter generator and the soak campaign, and the soak tests.

- perfdiff (``nnstreamer_tpu_torch/tools/perfdiff.py``): the JAX package's
  ``TestPerfdiff`` cases (``tests/test_costmodel.py``) on both packages'
  perfdiff, the same verdicts; a self-compare of a ``COST_MODEL.json`` the
  port's own tracer wrote is ``flat``; the ladder is read only from files
  named on the command line.
- codegen (``tools/codegen_custom_filter.py``): the generated filter loads
  in the port's ``custom-python`` backend and runs, numpy and torch
  bodies, with the outputs of the JAX package's generated filter.
- soak_campaign: a seed's template runs on the CPU, a failing seed prints
  its one-line repro, and ``--lockdep`` reports the lock-order counts.
- The JAX package's ``tests/test_soak.py`` cases on the port: the mixed
  topology with mid-stream renegotiation and the seeded chaos soak, each
  under threads and under the dispatcher lanes, and the fleet churn soak.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs.metrics import MetricsRegistry as JRegistry
from tools import codegen_custom_filter as jcodegen
from tools import perfdiff as jperfdiff

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch import faults
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.tools import codegen_custom_filter as codegen
from nnstreamer_tpu_torch.tools import perfdiff, soak_campaign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- perfdiff -----------------------------------------------------------------


def _doc_with(mean, count=20, m2=2000.0):
    legs = {"dispatch": {"count": count, "mean_us": mean, "m2": m2}}
    return {"schema": 1, "stages": {
        "p|f|b4|mesh1": {"pipeline": "p", "node": "f", "legs": legs}}}


def _same_verdicts(base, cur):
    ours = perfdiff.diff_cost_models(base, cur)
    assert ours == jperfdiff.diff_cost_models(base, cur)
    return ours


class TestPerfdiff:
    def test_self_compare_is_flat(self):
        doc = _doc_with(1000.0)
        verdicts = _same_verdicts(doc, doc)
        assert [v["verdict"] for v in verdicts] == ["flat"]
        assert perfdiff.overall_verdict(verdicts) == "flat"

    def test_regressed_names_the_leg(self):
        (v,) = _same_verdicts(_doc_with(1000.0), _doc_with(2000.0))
        assert v["verdict"] == "regressed" and v["leg"] == "dispatch"
        reg = MetricsRegistry()
        rep = perfdiff.report([v], registry=reg)
        assert rep["verdict"] == "regressed"
        assert rep["regressed_legs"] == {"dispatch": 1}
        assert dict(reg.get("nnstpu_perf_regression_total").children())[("dispatch",)].value == 1
        jrep = jperfdiff.report([dict(v)], registry=JRegistry())
        assert {k: rep[k] for k in ("verdict", "compared", "flat", "improved", "regressed")} == \
            {k: jrep[k] for k in ("verdict", "compared", "flat", "improved", "regressed")}

    def test_improved_and_noise_band(self):
        (v,) = _same_verdicts(_doc_with(1000.0), _doc_with(500.0))
        assert v["verdict"] == "improved"
        noisy = _doc_with(1000.0, count=20, m2=1_000_000.0)
        (v,) = _same_verdicts(noisy, _doc_with(1500.0))
        assert v["verdict"] == "flat"

    def test_ladder_bank_verdicts(self):
        base = {"cell1": {"mfu": 0.10}, "cell2": {"mfu": 0.10},
                "cell3": {"mfu": 0.10}, "unmeasured": {"mfu": None}}
        cur = {"cell1": {"mfu": 0.101}, "cell2": {"mfu": 0.05},
               "cell3": {"mfu": 0.20}, "unmeasured": {"mfu": None}}
        verdicts = perfdiff.diff_ladder_banks(base, cur)
        assert verdicts == jperfdiff.diff_ladder_banks(base, cur)
        assert {v["key"]: v["verdict"] for v in verdicts} == {
            "cell1": "flat", "cell2": "regressed", "cell3": "improved"}

    def test_cli_self_compare_exits_zero_flat(self, tmp_path, capsys):
        path = tmp_path / "cm.json"
        path.write_text(json.dumps(_doc_with(1000.0)))
        assert perfdiff.main(["--baseline", str(path), "--current", str(path), "--json"]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["verdict"] == "flat" and rep["compared"] == 1

    def test_cli_strict_exits_nonzero_on_regression(self, tmp_path):
        b, c = tmp_path / "b.json", tmp_path / "c.json"
        b.write_text(json.dumps(_doc_with(1000.0)))
        c.write_text(json.dumps(_doc_with(4000.0)))
        assert perfdiff.main(["--baseline", str(b), "--current", str(c)]) == 0
        assert perfdiff.main(["--baseline", str(b), "--current", str(c), "--strict"]) == 1

    def test_ladder_only_from_named_files(self, tmp_path, capsys):
        """No default path: without both bank files no ladder cell is
        compared, and the source names no TPU cache."""
        path = tmp_path / "cm.json"
        path.write_text(json.dumps(_doc_with(1000.0)))
        bank = tmp_path / "bank.json"
        bank.write_text(json.dumps({"mfu_ladder": {"c": {"mfu": 0.1}}}))
        perfdiff.main(["--baseline", str(path), "--current", str(path), "--json",
                       "--bank-baseline", str(bank)])
        assert json.loads(capsys.readouterr().out)["compared"] == 1
        perfdiff.main(["--baseline", str(path), "--current", str(path), "--json",
                       "--bank-baseline", str(bank), "--bank-current", str(bank)])
        assert json.loads(capsys.readouterr().out)["compared"] == 2
        with open(perfdiff.__file__, encoding="utf-8") as fh:
            assert "BENCH_TPU_CACHE" not in fh.read()

    def test_self_compare_of_the_ports_own_cost_model(self, tmp_path, monkeypatch, capsys):
        """A COST_MODEL.json the port's costmodel tracer wrote from a real
        run compares flat against itself."""
        path = tmp_path / "COST_MODEL.json"
        monkeypatch.setenv("NNSTPU_OBS_COSTMODEL_PATH", str(path))
        p = tnns.parse_launch("videotestsrc num-buffers=12 width=8 height=8 ! "
                              "tensor_converter name=conv ! queue name=q ! "
                              "tensor_transform mode=arithmetic option=mul:2.0 name=t "
                              "device=cpu ! tensor_sink name=out")
        p.name = "soakcm"
        from nnstreamer_tpu_torch.obs.costmodel import CostModelTracer

        p.attach_tracer(CostModelTracer(registry=MetricsRegistry()))
        p.run(timeout=60)
        assert path.exists()
        assert perfdiff.main(["--baseline", str(path), "--current", str(path), "--json"]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["verdict"] == "flat" and rep["compared"] >= 2
        assert {v["key"].split("|")[1] for v in rep["verdicts"]} >= {"conv", "q"}


# -- the custom-filter generator ---------------------------------------------


@pytest.mark.parametrize("use_torch", [False, True], ids=["numpy", "torch"])
def test_generated_filter_loads_and_runs(tmp_path, use_torch, monkeypatch):
    """The port's skeleton loads in the port's custom-python backend and
    passes its input through to the declared output (cut to 6 values, cast
    to float32), as the JAX package's skeleton does in its own backend."""
    import nnstreamer_tpu as jnns

    args = ["passy", "--input", "4:3", "--input-type", "uint8", "--output", "6",
            "--output-type", "float32", "-o", str(tmp_path)]
    path = codegen.main(args + (["--torch"] if use_torch else []))
    src = open(path, encoding="utf-8").read()
    assert "nnstreamer_tpu_torch.backends.custom" in src and "jax" not in src
    assert ("import torch" in src) == use_torch
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jpath = jcodegen.main(["passy"] + args[1:-1] + [str(jdir)])
    data = [np.arange(12, dtype=np.uint8).reshape(4, 3) + i for i in range(3)]

    p = tnns.parse_launch(f"datasrc name=src ! tensor_filter framework=custom-python "
                          f"model={path} ! tensor_sink name=out collect=true")
    p["src"].data = [torch.from_numpy(d) for d in data]
    p.run(timeout=60)
    got = [f.tensor(0).numpy() for f in p["out"].frames]
    jp = jnns.parse_launch(f"datasrc name=src ! tensor_filter framework=custom-python "
                           f"model={jpath} ! tensor_sink name=out collect=true")
    jp["src"].data = data
    jp.run(timeout=60)
    want = [np.asarray(f.tensor(0)) for f in jp["out"].frames]
    assert len(got) == len(want) == 3
    for g, w, d in zip(got, want, data):
        assert g.dtype == np.float32 and g.shape == (6,)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d.ravel()[:6].astype(np.float32))


# -- the soak campaign --------------------------------------------------------


def _soak(*args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.tools.soak_campaign",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=timeout)


class TestSoakCampaign:
    @pytest.mark.parametrize("seed", [1, 7, 22])
    def test_a_seed_runs_on_the_cpu(self, seed, monkeypatch):
        monkeypatch.setattr(soak_campaign, "DEVICE", "cpu")
        fn, rng = soak_campaign.pick(seed)
        assert fn in soak_campaign.TEMPLATES
        fn(rng)

    def test_every_template_runs_on_the_cpu(self, monkeypatch):
        monkeypatch.setattr(soak_campaign, "DEVICE", "cpu")
        seen = {}
        seed = 0
        while len(seen) < len(soak_campaign.TEMPLATES) and seed < 500:
            fn, rng = soak_campaign.pick(seed)
            if fn.__name__ not in seen:
                fn(rng)
                seen[fn.__name__] = seed
            seed += 1
        assert len(seen) == len(soak_campaign.TEMPLATES)
        assert "run_repo" not in seen  # needs bench.py's counterpart (ROADMAP)

    def test_failing_seed_prints_its_repro(self, monkeypatch):
        import io

        monkeypatch.setattr(soak_campaign, "DEVICE", "cpu")

        def broken(rng):
            raise AssertionError("frame 3 differs")

        monkeypatch.setattr(soak_campaign, "TEMPLATES", [broken])
        out = io.StringIO()
        res = soak_campaign.campaign(0.0, 41, "cpu", out=out)
        assert res["failures"] == 1 and res["failed_seeds"] == [41]
        text = out.getvalue()
        assert ("repro: python -m nnstreamer_tpu_torch.tools.soak_campaign --seed 41 "
                "--device cpu") in text
        assert "frame 3 differs" in text

    def test_cli_seed_repro_and_lockdep_campaign(self):
        res = _soak("--seed", "3", "--device", "cpu")
        assert res.returncode == 0, res.stderr
        assert "repro seed=3" in res.stdout and "\nOK\n" in res.stdout
        res = _soak("--base-seed", "22", "--minutes", "0.05", "--device", "cpu", "--lockdep")
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        last = json.loads(res.stdout.strip().splitlines()[-1])
        assert last["failures"] == 0 and last["iterations"] >= 1
        assert last["lockdep"]["installed"] and last["lockdep"]["cycles"] == 0
        assert last["lockdep"]["sites"] > 10
        assert "lockdep: " in res.stdout

    def test_cli_refuses_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        res = _soak("--minutes", "0.02")
        assert res.returncode == 2 and "no CUDA GPU" in res.stderr


# -- the JAX package's soak tests on the port ---------------------------------


def _model(fn):
    return TorchModel(apply=lambda p, x: fn(x), device="cpu")


@pytest.mark.parametrize("lanes", ["0", "2"], ids=["threads", "lanes"])
def test_soak_mixed_topology_with_renegotiation(lanes, monkeypatch):
    from nnstreamer_tpu_torch.elements.dynbatch import DynBatch, DynUnbatch
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.queue import Queue
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.tee import Tee
    from nnstreamer_tpu_torch.elements.testsrc import DataSrc
    from nnstreamer_tpu_torch.elements.upload import TensorUpload

    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", lanes)
    n_phase = 300
    shapes = [(4,), (2, 3), (4,)]
    frames, seq = [], 0
    for shape in shapes:
        for _ in range(n_phase):
            frames.append(Frame.of(torch.full(shape, float(seq)), pts=seq))
            seq += 1
    total = len(frames)
    batched = _model(lambda x: x.reshape(x.shape[0], -1).sum(dim=1))
    single = _model(lambda x: x.reshape(-1).sum()[None])
    got_a, got_b = [], []
    p = tnns.Pipeline()
    src = p.add(DataSrc(data=frames))
    tee = p.add(Tee())
    dyn = p.add(DynBatch(max_batch=4))
    up = p.add(TensorUpload())
    qa = p.add(Queue(max_size_buffers=32))
    fa = p.add(TensorFilter(framework="torch", model=batched))
    unb = p.add(DynUnbatch())
    sa = p.add(TensorSink(name="a"))
    sa.connect("new-data", lambda f: got_a.append(float(f.tensor(0))))
    qb = p.add(Queue(max_size_buffers=32))
    fb = p.add(TensorFilter(framework="torch", model=single))
    sb = p.add(TensorSink(name="b"))
    sb.connect("new-data", lambda f: got_b.append(float(f.tensor(0)[0])))
    p.link(src, tee)
    p.link(tee, dyn)
    p.link_chain(dyn, up, qa, fa, unb, sa)
    p.link(tee, qb)
    p.link_chain(qb, fb, sb)
    p.run(timeout=600)

    def golden(i):
        return float(i) * int(np.prod(shapes[min(i // n_phase, 2)]))

    assert len(got_a) == total and len(got_b) == total
    for i in range(total):
        assert got_a[i] == golden(i), (i, got_a[i], golden(i))
        assert got_b[i] == golden(i), (i, got_b[i], golden(i))


@pytest.mark.parametrize("lanes", ["0", "2"], ids=["threads", "lanes"])
def test_chaos_soak_seeded_fault_injection(lanes, monkeypatch):
    """A seeded fault mix over N frames with a restart policy on the filter:
    the pipeline ends healthy, delivered + typed sheds == offered, recovery
    actions match the injected raises one for one, and the same seed
    replays the same injections, under both scheduling substrates."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.queue import Queue
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.testsrc import DataSrc

    monkeypatch.setenv("NNSTPU_DISPATCH_LANES", lanes)
    n = 400
    spec = "seed=1234;invoke_raise@f:rate=0.03;invoke_delay@f:rate=0.02,ms=1"
    eng = faults.install(spec)
    try:
        got = []
        p = tnns.Pipeline(name="chaos_soak")
        src = p.add(DataSrc(data=[Frame.of(torch.full((4,), float(i)), pts=i)
                                  for i in range(n)]))
        q = p.add(Queue(max_size_buffers=64, name="qsoak"))
        filt = p.add(TensorFilter(framework="custom", model=lambda x: x * 2.0, name="f"))
        sink = p.add(TensorSink(name="out"))
        sink.connect("new-data", lambda fr: got.append((fr.pts, float(fr.tensor(0)[0]))))
        p.link_chain(src, q, filt, sink)
        p.set_restart_policy("f", mode="restart", backoff_ms=1, backoff_cap_ms=4,
                             max_restarts=1000, window_s=300.0)
        p.run(timeout=600)
        raises = eng.injections.get("invoke_raise", 0)
        assert raises > 0 and eng.injections.get("invoke_delay", 0) > 0, eng.stats()
        assert p.state == "STOPPED" and p._error is None
        rec = p.recovery_stats()
        assert rec["actions"]["restart_node"] == raises
        assert rec["shed_total"] == raises
        assert len(got) + rec["shed_total"] == n
        assert [pts for pts, _ in got] == sorted(pts for pts, _ in got)
        for pts, val in got:
            assert val == 2.0 * pts, (pts, val)
        replay = faults.ChaosEngine(spec)
        for _ in range(n):
            replay.decide("backend_invoke", "f")
        assert replay.log == eng.log and replay.injections == eng.injections
    finally:
        faults.deactivate()


def test_fleet_chaos_soak_worker_churn():
    """Seeded worker churn (kill -> restart, partition -> heal) under
    stateless query traffic and stateful decode sessions through two
    routers: every client outcome typed, delivered + typed-shed == offered
    exactly, and the seed replays the same churn schedule."""
    from nnstreamer_tpu_torch.elements.query import QueryError, recv_tensors, send_tensors
    from nnstreamer_tpu_torch.fleet import FleetWorker, Membership, Router
    from nnstreamer_tpu_torch.fleet.chaos import FleetChaos, InProcHandle

    spec = ("seed=77;worker_kill@q:rate=0.08;partition@q:rate=0.06,ms=200;"
            "worker_kill@d1:after=6")
    eng = faults.install(spec)
    workers, infos = {}, {}
    qm = Membership(heartbeat_s=0.04, suspect_misses=2, death_misses=3,
                    breaker_failures=2, breaker_reset_s=0.15)
    for i in range(3):
        w = FleetWorker(name=f"q{i}", model=lambda x: x * 2.0, device="cpu").start()
        workers[w.name] = w
        infos[w.name] = qm.add("127.0.0.1", w.query_port, probe=w.probe, worker_id=w.name)
    dm = Membership(heartbeat_s=0.04, suspect_misses=2, death_misses=3,
                    breaker_failures=2, breaker_reset_s=0.15)
    engine_cfg = dict(capacity=2, t_max=8, d_in=4, n_out=4, d_model=16, n_heads=2,
                      n_layers=1)
    for i in range(2):
        w = FleetWorker(name=f"d{i}", engine=dict(engine_cfg), device="cpu").start()
        workers[w.name] = w
        infos[w.name] = dm.add("127.0.0.1", w.decode_port, probe=w.probe, worker_id=w.name)
    qm.start()
    dm.start()
    qr = Router(qm, port=0, route_retries=4, retry_backoff_ms=1, retry_backoff_cap_ms=10,
                request_timeout=15.0).start()
    dr = Router(dm, port=0, stateful=True, route_retries=2, retry_backoff_ms=1,
                request_timeout=15.0).start()
    chaos = FleetChaos({n: InProcHandle(workers[n], infos[n]) for n in workers})
    stop = threading.Event()
    ledger = {"offered": 0, "delivered": 0, "typed": 0, "untyped": []}
    dledger = {"steps": 0, "delivered": 0, "typed": 0, "untyped": []}
    lock = threading.Lock()

    def q_request(val):
        s = socket.create_connection(("127.0.0.1", qr.port), timeout=15)
        s.settimeout(15)
        try:
            send_tensors(s, (np.full(4, val, np.float32),), 0)
            outs, _ = recv_tensors(s)
            return float(np.asarray(outs[0])[0])
        finally:
            s.close()

    def q_client():
        i = 0
        while not stop.is_set():
            i += 1
            with lock:
                ledger["offered"] += 1
            try:
                assert q_request(float(i)) == 2.0 * i
                with lock:
                    ledger["delivered"] += 1
            except QueryError:
                with lock:
                    ledger["typed"] += 1
            except Exception as exc:  # noqa: BLE001 - the ledger's untyped bucket
                with lock:
                    ledger["untyped"].append(repr(exc))
            time.sleep(0.008)

    def d_client():
        s = None
        while not stop.is_set():
            with lock:
                dledger["steps"] += 1
            try:
                if s is None:
                    s = socket.create_connection(("127.0.0.1", dr.port), timeout=15)
                    s.settimeout(15)
                send_tensors(s, (np.zeros(4, np.float32),), 0)
                outs, _ = recv_tensors(s)
                assert np.asarray(outs[0]).shape == (4,)
                with lock:
                    dledger["delivered"] += 1
            except (QueryError, ConnectionError, OSError):
                with lock:
                    dledger["typed"] += 1
                if s is not None:
                    s.close()
                    s = None
            except Exception as exc:  # noqa: BLE001 - the ledger's untyped bucket
                with lock:
                    dledger["untyped"].append(repr(exc))
            time.sleep(0.01)
        if s is not None:
            s.close()

    ths = ([threading.Thread(target=q_client) for _ in range(3)]
           + [threading.Thread(target=d_client) for _ in range(2)])
    try:
        for t in ths:
            t.start()
        killed_at = {}
        for tick in range(30):
            chaos.tick()
            for name, w in workers.items():
                if w._killed and name.startswith("q") and name not in killed_at:
                    killed_at[name] = tick
            for name, t0 in list(killed_at.items()):
                if tick - t0 >= 5:
                    workers[name].restart()
                    del killed_at[name]
            time.sleep(0.05)
        for name, w in workers.items():
            if w._killed and name.startswith("q"):
                w.restart()
        time.sleep(0.3)
        for i in range(5):
            assert q_request(1000.0 + i) == 2.0 * (1000.0 + i)
    finally:
        stop.set()
        for t in ths:
            t.join(timeout=30)
    try:
        assert [w for w, k in chaos.applied if k == "worker_kill"], chaos.applied
        assert ledger["untyped"] == []
        assert ledger["offered"] == ledger["delivered"] + ledger["typed"]
        assert ledger["delivered"] > 0
        assert dledger["untyped"] == []
        assert dledger["steps"] == dledger["delivered"] + dledger["typed"]
        for r in (qr, dr):
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                st = r.stats()
                if st["offered"] == st["delivered"] + st["shed_total"]:
                    break
                time.sleep(0.02)
            assert st["offered"] == st["delivered"] + st["shed_total"], st
        replay = faults.ChaosEngine(spec)
        for name in chaos.consults:
            replay.decide("fleet", name)
        assert replay.log == eng.log and replay.injections == eng.injections
    finally:
        qr.stop()
        dr.stop()
        qm.stop()
        dm.stop()
        for w in workers.values():
            try:
                w.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        faults.deactivate()
