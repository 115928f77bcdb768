"""The port's QoS scheduling and admission control (``sched/``) against the
JAX package's.

Case for case with the JAX package's ``tests/test_sched.py``: the dispatch
policies, per-tenant admission with typed shedding on the NNSQ wire,
deadline-expired drop, the circuit breaker with half-open probing, the
``[sched]`` conf activation, and both serving front doors (``QueryServer``
and ``DecodeServer``, on the CPU) with the port's metrics exposition.
``TestReferenceParity`` runs the same seeded sequences through both
packages' policies, admission controllers and gates and compares every
decision.
"""

import socket
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.conf import Conf
from nnstreamer_tpu_torch.elements.query import (
    QueryExpiredError,
    QueryOverloadError,
    QueryServer,
    QueryUnavailableError,
    recv_tensors,
    send_error,
    send_tensors,
)
from nnstreamer_tpu_torch.obs.export import render_text
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.sched import (
    AdmissionController,
    BreakerOpenError,
    CircuitBreaker,
    DrrPolicy,
    OverloadError,
    PriorityGate,
    Scheduler,
    SchedItem,
    from_conf,
    make_policy,
)


def _pair():
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    return a, b


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- policies ---------------------------------------------------------------


class TestPolicies:
    def test_fifo_preserves_arrival_order(self):
        p = make_policy("fifo")
        for i in range(5):
            p.push(SchedItem(f"c{i}", payload=i))
        assert [p.pop().payload for _ in range(5)] == [0, 1, 2, 3, 4]
        assert p.pop() is None

    def test_strict_priority_then_fifo_within_level(self):
        p = make_policy("prio")
        p.push(SchedItem("a", priority=0, payload="a0"))
        p.push(SchedItem("b", priority=5, payload="b0"))
        p.push(SchedItem("b", priority=5, payload="b1"))
        p.push(SchedItem("c", priority=1, payload="c0"))
        assert [p.pop().payload for _ in range(4)] == ["b0", "b1", "c0", "a0"]

    def test_edf_earliest_deadline_first_none_last(self):
        p = make_policy("edf")
        p.push(SchedItem("a", deadline=3.0, payload=3))
        p.push(SchedItem("b", deadline=1.0, payload=1))
        p.push(SchedItem("c", deadline=None, payload=None))
        p.push(SchedItem("d", deadline=2.0, payload=2))
        assert [p.pop().payload for _ in range(4)] == [1, 2, 3, None]

    def test_drr_heavy_client_cannot_monopolize(self):
        """Equal quanta: a client pushing cost-4 groups gets ~1/4 the
        dispatches of cost-1 clients — fair by cost, not by count."""
        p = DrrPolicy(quantum=2.0)
        for _ in range(8):
            p.push(SchedItem("heavy", cost=4.0))
        for _ in range(8):
            p.push(SchedItem("light", cost=1.0))
        first8 = [p.pop().client for _ in range(8)]
        # light's 8 cost-1 items all clear while heavy got at most 1 in
        assert first8.count("light") >= 6, first8

    def test_drr_weights_scale_share(self):
        p = DrrPolicy(quantum=1.0, weights={"b": 3.0})
        for _ in range(8):
            p.push(SchedItem("a", cost=1.0))
            p.push(SchedItem("b", cost=1.0))
        first8 = [p.pop().client for _ in range(8)]
        assert first8.count("b") == 6 and first8.count("a") == 2, first8

    def test_drr_deficits_snapshot(self):
        p = DrrPolicy(quantum=2.0)
        p.push(SchedItem("a", cost=5.0))
        assert p.pop().client == "a"  # accumulates rounds of credit
        assert p.deficits()["a"] == 0.0  # emptied client forfeits credit

    def test_unknown_policy_is_loud(self):
        with pytest.raises(ValueError, match="unknown scheduling policy"):
            make_policy("lottery")


# -- admission --------------------------------------------------------------


class TestAdmission:
    def test_per_tenant_queue_bound(self):
        adm = AdmissionController(max_queue=2)
        adm.try_admit("t1")
        adm.try_admit("t1")
        with pytest.raises(OverloadError) as ei:
            adm.try_admit("t1")
        assert ei.value.reason == "queue_full" and ei.value.code == "OVERLOAD"
        adm.try_admit("t2")  # other tenants unaffected
        adm.release("t1")
        adm.try_admit("t1")  # released capacity readmits

    def test_token_bucket_rate_limit(self):
        clk = FakeClock()
        adm = AdmissionController(max_queue=100, rate=1.0, burst=2.0,
                                  clock=clk)
        adm.try_admit("t")
        adm.try_admit("t")
        with pytest.raises(OverloadError) as ei:
            adm.try_admit("t")
        assert ei.value.reason == "rate"
        clk.advance(1.0)  # one token refills
        adm.try_admit("t")
        with pytest.raises(OverloadError):
            adm.try_admit("t")

    def test_deadline_stamping(self):
        clk = FakeClock(100.0)
        adm = AdmissionController(deadline_ms=250.0, clock=clk)
        assert adm.try_admit("t") == pytest.approx(100.25)
        assert AdmissionController(clock=clk).try_admit("t") is None

    def test_item_expiry(self):
        it = SchedItem("c", deadline=10.0)
        assert not it.expired(9.9) and it.expired(10.1)
        assert not SchedItem("c").expired(1e9)


# -- circuit breaker --------------------------------------------------------


class TestBreaker:
    def test_trips_after_consecutive_failures_and_success_resets(self):
        br = CircuitBreaker(failure_threshold=3, reset_timeout_s=10,
                            clock=FakeClock())
        for _ in range(2):
            br.record_failure()
        br.record_success()  # streak broken
        for _ in range(2):
            br.record_failure()
        assert br.state == "closed"
        br.record_failure()
        assert br.state == "open" and br.trips == 1
        with pytest.raises(BreakerOpenError, match="circuit breaker"):
            br.allow()

    def test_half_open_probe_success_closes(self):
        clk = FakeClock()
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                            clock=clk)
        br.record_failure()
        assert br.state == "open"
        clk.advance(5.0)
        assert br.state == "half_open"
        assert br.call(lambda: 42) == 42  # the probe
        assert br.state == "closed"

    def test_half_open_probe_failure_reopens(self):
        clk = FakeClock()
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                            clock=clk)
        br.record_failure()
        clk.advance(5.0)
        with pytest.raises(ZeroDivisionError):
            br.call(lambda: 1 / 0)
        assert br.state == "open" and br.trips == 2
        with pytest.raises(BreakerOpenError):
            br.allow()

    def test_half_open_limits_concurrent_probes(self):
        clk = FakeClock()
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=1.0,
                            half_open_max=1, clock=clk)
        br.record_failure()
        clk.advance(1.0)
        br.allow()  # the one probe slot
        with pytest.raises(BreakerOpenError):
            br.allow()


# -- slot gate --------------------------------------------------------------


class TestPriorityGate:
    def test_grants_in_priority_order(self):
        gate = PriorityGate(max_waiting=8)
        lock = threading.Lock()
        available = [0]
        order = []

        def try_grant():
            with lock:
                if available[0] > 0:
                    available[0] -= 1
                    return object()
            return None

        def waiter(name, prio):
            gate.acquire(prio, try_grant, timeout=20)
            order.append(name)

        threads = []
        for name, prio in (("low", 1), ("high", 5), ("mid", 3)):
            t = threading.Thread(target=waiter, args=(name, prio))
            t.start()
            threads.append(t)
            time.sleep(0.05)  # all three parked before any grant
        for _ in range(3):
            with lock:
                available[0] += 1
            time.sleep(0.2)
        for t in threads:
            t.join(timeout=20)
        assert order == ["high", "mid", "low"]

    def test_full_waiting_room_sheds_typed(self):
        gate = PriorityGate(max_waiting=1)
        started = threading.Event()

        def parked():
            started.set()
            with pytest.raises(TimeoutError):
                gate.acquire(0, lambda: None, timeout=0.5)

        t = threading.Thread(target=parked)
        t.start()
        started.wait(5)
        time.sleep(0.05)
        with pytest.raises(OverloadError) as ei:
            gate.acquire(0, lambda: None, timeout=1)
        assert ei.value.reason == "waiters_full"
        t.join(timeout=10)
        # the room drained: a grantable acquire succeeds again
        assert gate.acquire(0, lambda: "slot", timeout=1) == "slot"


# -- conf activation --------------------------------------------------------


class TestConfActivation:
    def test_unconfigured_means_no_scheduler(self):
        assert from_conf(conf=Conf(environ={})) is None

    def test_env_knobs_build_the_scheduler(self):
        conf = Conf(environ={
            "NNSTPU_SCHED_POLICY": "drr",
            "NNSTPU_SCHED_QUANTUM": "4",
            "NNSTPU_SCHED_RATE": "5",
            "NNSTPU_SCHED_DEADLINE_MS": "100",
            "NNSTPU_SCHED_BREAKER_FAILURES": "3",
            "NNSTPU_SCHED_PRIORITIES": "10.0.0.5=7,edge=2",
        })
        reg = MetricsRegistry()
        sch = from_conf("q", conf=conf, registry=reg)
        try:
            assert isinstance(sch.policy, DrrPolicy)
            assert sch.policy.quantum == 4.0
            assert sch.admission.rate == 5.0
            assert sch.admission.deadline_ms == 100.0
            assert sch.breaker.failure_threshold == 3
            assert sch.priority_for("10.0.0.5:4242") == 7
            assert sch.priority_for("edge") == 2
            assert sch.priority_for("stranger") == 0
        finally:
            sch.close()

    def test_server_consults_conf(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_SCHED_POLICY", "fifo")
        srv = QueryServer(device="cpu", framework="custom", model=lambda x: x)
        assert srv.scheduler is not None and srv._own_sched
        srv.scheduler.close()
        monkeypatch.delenv("NNSTPU_SCHED_POLICY")
        assert QueryServer(device="cpu", framework="custom",
                           model=lambda x: x).scheduler is None


# -- NNSQ wire error codes (satellite: error-frame round trip) --------------


class TestWireErrorCodes:
    def _roundtrip(self, code):
        a, b = _pair()
        try:
            send_error(a, "server said no", code=code)
            return self._recv(b)
        finally:
            a.close()
            b.close()

    @staticmethod
    def _recv(sock):
        try:
            recv_tensors(sock)
        except Exception as exc:  # noqa: BLE001 — the exception IS the result
            return exc
        raise AssertionError("error frame did not raise")

    def test_overload_code_raises_typed(self):
        exc = self._roundtrip("OVERLOAD")
        assert isinstance(exc, QueryOverloadError)
        assert "server said no" in str(exc)

    def test_expired_is_an_overload_subtype(self):
        exc = self._roundtrip("EXPIRED")
        assert isinstance(exc, QueryExpiredError)
        assert isinstance(exc, QueryOverloadError)

    def test_unavailable_code(self):
        assert isinstance(self._roundtrip("UNAVAILABLE"),
                          QueryUnavailableError)

    def test_plain_error_stays_runtimeerror(self):
        a, b = _pair()
        try:
            send_error(a, "backend exploded")
            exc = self._recv(b)
            assert type(exc) is RuntimeError  # legacy peers unaffected
            assert "backend exploded" in str(exc)
        finally:
            a.close()
            b.close()

    def test_unknown_code_stays_runtimeerror(self):
        a, b = _pair()
        try:
            send_error(a, "[WAT] novel failure")
            assert type(self._recv(b)) is RuntimeError
        finally:
            a.close()
            b.close()


# -- QueryServer integration ------------------------------------------------


def _query(port, tensors, pts=0):
    """One synchronous request on a fresh connection."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        send_tensors(s, tensors, pts)
        return recv_tensors(s)
    finally:
        s.close()


class TestQueryServerSched:
    def test_shed_raises_typed_not_hangs(self):
        """Overload beyond admission limits = typed wire rejection on a
        live connection; the backend never sees the shed request."""
        invoked = []

        def model(x):
            invoked.append(1)
            time.sleep(0.2)
            return x * 2.0

        reg = MetricsRegistry()
        sch = Scheduler("fifo", admission=AdmissionController(max_queue=1),
                        name="q", registry=reg)
        with QueryServer(device="cpu", framework="custom", model=model,
                         scheduler=sch) as srv:
            outcomes = []

            def client():
                try:
                    out, _ = _query(srv.port, (np.ones((4,), np.float32),))
                    outcomes.append("ok")
                except QueryOverloadError:
                    outcomes.append("shed")

            threads = [threading.Thread(target=client) for _ in range(3)]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert time.monotonic() - t0 < 20  # nobody hung
            assert sorted(outcomes) == ["ok", "shed", "shed"]
            st = srv.stats()["sched"]
            assert st["admission"]["shed_queue_full"] == 2
        sch.close()

    def test_deadline_expired_dropped_before_dispatch(self):
        served = []

        def model(x):
            served.append(1)
            return x * 2.0

        reg = MetricsRegistry()
        sch = Scheduler(
            "edf",
            admission=AdmissionController(max_queue=8, deadline_ms=1.0),
            name="q", registry=reg)
        with QueryServer(device="cpu", framework="custom", model=model, batch=4,
                         batch_window_ms=120.0, scheduler=sch) as srv:
            with pytest.raises(QueryExpiredError):
                _query(srv.port, (np.ones((1, 4), np.float32),))
            assert not served  # dropped before the backend
            assert srv.stats()["sched"]["expired"] == 1
        text = render_text(reg)
        assert ('nnstpu_sched_expired_total'
                '{server="q",tenant="127.0.0.1"} 1') in text
        assert ('nnstpu_sched_shed_total'
                '{server="q",reason="expired",tenant="127.0.0.1"} 1') in text
        sch.close()

    def test_breaker_degrades_then_recovers(self):
        healthy = threading.Event()

        def model(x):
            if not healthy.is_set():
                raise ValueError("backend down")
            return x * 2.0

        reg = MetricsRegistry()
        sch = Scheduler(
            "fifo",
            breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.3),
            name="q", registry=reg)
        with QueryServer(device="cpu", framework="custom", model=model,
                         scheduler=sch) as srv:
            errs = []
            for _ in range(3):
                try:
                    _query(srv.port, (np.ones((4,), np.float32),))
                except Exception as exc:  # noqa: BLE001
                    errs.append(exc)
            # 2 real failures at full cost, then the breaker fails fast
            assert type(errs[0]) is RuntimeError
            assert isinstance(errs[2], QueryUnavailableError)
            healthy.set()
            time.sleep(0.35)  # open -> half-open
            out, _ = _query(srv.port, (np.ones((4,), np.float32),))
            np.testing.assert_allclose(out[0], 2.0)  # probe recovered it
            assert srv.scheduler.breaker.state == "closed"
        text = render_text(reg)
        assert 'nnstpu_sched_breaker_trips_total{server="q"} 1' in text
        assert 'nnstpu_sched_breaker_state{server="q"} 0' in text
        sch.close()

    def test_stats_and_exposition_carry_sched_metrics(self):
        reg = MetricsRegistry()
        sch = Scheduler("drr", admission=AdmissionController(max_queue=8),
                        name="qs", registry=reg)
        with QueryServer(device="cpu", framework="custom", model=lambda x: x * 2.0,
                         batch=2, batch_window_ms=2.0,
                         scheduler=sch) as srv:
            for i in range(4):
                out, _ = _query(srv.port,
                                (np.full((1, 4), float(i), np.float32),))
                np.testing.assert_allclose(out[0], 2.0 * i)
            st = srv.stats()
            assert st["sched"]["policy"] == "drr"
            assert st["sched"]["dispatched"] == 4
        text = render_text(reg)
        assert "nnstpu_sched_queue_wait_ms_bucket" in text
        assert 'nnstpu_sched_dispatched_total{server="qs"} 4' in text
        assert 'nnstpu_sched_queued{server="qs"} 0' in text
        sch.close()


class TestFairnessStress:
    """One slow, floody client must not starve the other streams'
    dispatch."""

    def test_drr_bounds_fast_client_latency_under_flood(self):
        SLOW_ROWS, FAST_N, FAST_CLIENTS = 24, 12, 7

        def model(x):
            # invoke cost proportional to rows: the slow tenant's big
            # groups are expensive, the fast streams' are cheap
            time.sleep(0.002 * x.shape[0])
            return x * 2.0

        def fast_once(port, i):
            t0 = time.monotonic()
            out, _ = _query(port, (np.full((1, 4), float(i), np.float32),))
            np.testing.assert_allclose(out[0], 2.0 * i)
            return time.monotonic() - t0

        def p99(xs):
            return sorted(xs)[max(0, int(np.ceil(0.99 * len(xs))) - 1)]

        def run_server(scheduler):
            return QueryServer(device="cpu", framework="custom", model=model, batch=8,
                               batch_window_ms=5.0, max_batch=64,
                               scheduler=scheduler)

        # solo baseline: one fast client, no contention
        with run_server(None) as srv:
            solo = [fast_once(srv.port, i) for i in range(FAST_N)]
        solo_p99 = p99(solo)

        reg = MetricsRegistry()
        sch = Scheduler("drr", quantum=8.0, name="fair", registry=reg)
        stop_flood = threading.Event()
        lat = {k: [] for k in range(FAST_CLIENTS)}
        failures = []

        def slow_flood():
            # floody tenant: several connections, each streaming big
            # requests back-to-back (one in flight per connection)
            conns = [socket.create_connection(("127.0.0.1", srv.port), timeout=30)
                     for _ in range(3)]
            try:
                while not stop_flood.is_set():
                    for s in conns:
                        send_tensors(
                            s, (np.ones((SLOW_ROWS, 4), np.float32),), 0)
                    for s in conns:
                        recv_tensors(s)
            except (ConnectionError, OSError):
                pass
            finally:
                for s in conns:
                    s.close()

        def fast_client(k):
            try:
                for i in range(FAST_N):
                    lat[k].append(fast_once(srv.port, i))
            except Exception as exc:  # noqa: BLE001
                failures.append((k, exc))

        with run_server(sch) as srv:
            flood = threading.Thread(target=slow_flood, daemon=True)
            flood.start()
            time.sleep(0.1)  # flood established before the fast streams
            threads = [threading.Thread(target=fast_client, args=(k,))
                       for k in range(FAST_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            stop_flood.set()
            flood.join(timeout=30)
        assert not failures, failures
        all_fast = [v for xs in lat.values() for v in xs]
        assert len(all_fast) == FAST_CLIENTS * FAST_N  # everyone completed
        contended_p99 = p99(all_fast)
        # bounded multiple of solo p99 (generous: CI hosts are noisy and
        # single-core; the unscheduled worst case is unbounded queueing
        # behind the flood, not a constant factor)
        bound = max(1.0, 25.0 * solo_p99)
        assert contended_p99 <= bound, (
            f"fast p99 {contended_p99:.3f}s vs solo {solo_p99:.3f}s "
            f"(bound {bound:.3f}s)")
        text = render_text(reg)
        assert "nnstpu_sched_queue_wait_ms_bucket" in text
        sch.close()


# -- DecodeServer integration ----------------------------------------------


def test_decode_server_slot_admission_sheds_typed():
    """Contended slots: a bounded waiting room with typed rejection —
    the third joiner is shed immediately, the queued one gets the slot
    when it frees (no connection ever parks un-replied)."""
    from nnstreamer_tpu_torch.serving import ContinuousBatcher, DecodeServer

    eng = ContinuousBatcher(capacity=1, t_max=8, d_in=4, n_out=2,
                            d_model=8, n_heads=2, n_layers=1, device="cpu")
    reg = MetricsRegistry()
    sch = Scheduler("prio", name="dec", max_waiting=1, registry=reg)
    srv = DecodeServer(eng, session_timeout=10.0, scheduler=sch, device="cpu").start()
    try:
        holder = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        send_tensors(holder, (np.zeros((4,), np.float32),), 1)
        recv_tensors(holder)  # slot taken

        outcomes = []

        def joiner(name):
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
            try:
                send_tensors(s, (np.zeros((4,), np.float32),), 1)
                try:
                    recv_tensors(s)
                    outcomes.append((name, "ok"))
                except QueryOverloadError:
                    outcomes.append((name, "shed"))
            finally:
                s.close()

        waiter = threading.Thread(target=joiner, args=("waiter",))
        waiter.start()
        time.sleep(0.3)  # parked in the gate
        shed = threading.Thread(target=joiner, args=("shed",))
        shed.start()
        shed.join(timeout=30)
        assert ("shed", "shed") in outcomes  # room full: immediate typed
        holder.close()  # frees the slot
        waiter.join(timeout=30)
        assert ("waiter", "ok") in outcomes
        gate = srv.stats()["sched"]["slot_gate"]
        assert gate["shed_full"] == 1 and gate["granted"] >= 2
    finally:
        srv.stop()
        eng.stop()
        sch.close()


# -- both packages on the same seeded sequences ------------------------------


class TestReferenceParity:
    @staticmethod
    def _items(mod, rng, n=40):
        clients = ["a", "b", "c", "d"]
        out = []
        for i in range(n):
            out.append(mod.SchedItem(
                clients[int(rng.integers(0, 4))], cost=float(rng.integers(1, 20)),
                priority=int(rng.integers(0, 3)),
                deadline=None if rng.random() < 0.3 else float(rng.random()),
                payload=i))
        return out

    @pytest.mark.parametrize("name", ["fifo", "prio", "edf", "drr"])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_policies_pop_in_the_reference_order(self, name, seed):
        import nnstreamer_tpu.sched.policy as jpolicy
        import nnstreamer_tpu_torch.sched.policy as tpolicy

        orders = []
        for mod in (jpolicy, tpolicy):
            rng = np.random.default_rng(seed)
            pol = mod.make_policy(name, quantum=6.0, weights={"b": 2.0})
            items = self._items(mod, rng)
            order = []
            for i, it in enumerate(items):
                pol.push(it)
                if i % 3 == 2:  # pops interleaved with pushes
                    order.append(pol.pop().payload)
            while len(pol):
                order.append(pol.pop().payload)
            orders.append((order, pol.deficits()))
        assert orders[0] == orders[1]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_admission_decides_as_the_reference(self, seed):
        import nnstreamer_tpu.sched.admission as jadm
        import nnstreamer_tpu_torch.sched.admission as tadm

        results = []
        for mod in (jadm, tadm):
            rng = np.random.default_rng(seed)
            clock = FakeClock()
            ac = mod.AdmissionController(max_queue=3, rate=20.0, burst=4.0,
                                         deadline_ms=50.0, clock=clock)
            held, trace = [], []
            for _ in range(200):
                clock.advance(float(rng.exponential(0.03)))
                tenant = f"t{int(rng.integers(0, 3))}"
                if held and rng.random() < 0.4:
                    ac.release(held.pop(int(rng.integers(0, len(held)))))
                try:
                    trace.append(("ok", ac.try_admit(tenant, float(rng.integers(1, 3)))))
                    held.append(tenant)
                except mod.OverloadError as exc:
                    trace.append((exc.reason, exc.code))
            results.append((trace, ac.stats()))
        assert results[0] == results[1]

    @pytest.mark.parametrize("seed", [0, 1])
    def test_breaker_states_follow_the_reference(self, seed):
        import nnstreamer_tpu.sched.breaker as jbr
        import nnstreamer_tpu_torch.sched.breaker as tbr

        traces = []
        for mod in (jbr, tbr):
            rng = np.random.default_rng(seed)
            clock = FakeClock()
            br = mod.CircuitBreaker(failure_threshold=3, reset_timeout_s=1.0,
                                    half_open_max=2, clock=clock)
            trace = []
            for _ in range(150):
                clock.advance(float(rng.exponential(0.2)))
                try:
                    br.allow()
                except mod.BreakerOpenError:
                    trace.append("shed")
                    continue
                if rng.random() < 0.5:
                    br.record_failure()
                else:
                    br.record_success()
                trace.append(br.state)
            traces.append((trace, {k: v for k, v in br.stats().items()
                                   if k != "forced_trips"}))
        assert traces[0] == traces[1]
