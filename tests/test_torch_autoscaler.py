"""The port's elastic fleet (``fleet/autoscaler.py``, ``fleet/supervisor.py``)
against the JAX package's, on the CPU.

Case for case with the JAX package's ``tests/test_autoscaler.py``: both
packages' :class:`Autoscaler` get the same :class:`FleetSignals` sequence
at the same fake ``now`` values (a stub supervisor that counts workers, or
an :class:`InProcWorkerFactory` fleet ticked explicitly), and the test
holds equal the desired count after each tick, the raw ``_plan`` on a grid
of signals, the ``ScaleEventLog`` (action, worker, detail, fleet size,
time), the controller's stats — hysteresis, cooldowns, flap damping, the
storm budget and its degraded ``/healthz`` reason, the forecast, and the
seeded ``spawn_fail`` and ``scale_flap`` faults.  Then the supervisor's
own mechanics in the port: respawn under a new incarnation and the
crash-loop quarantine with its reason, then release.  Last, where the port
repairs the JAX package (ROADMAP C21, C22), both run the same case and the
test holds each to its own outcome: a scale-down cancels a joining worker
and keeps the last routable one, and no worker joins before a probe of its
incarnation answers.

Every clock here is a fake one advanced by the test: nothing sleeps on a
controller thread, and no latency or rate is asserted.
"""

import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

from nnstreamer_tpu import faults as jfaults
from nnstreamer_tpu import fleet as jfleet
from nnstreamer_tpu.elements import query as jquery
from nnstreamer_tpu.obs import export as jexport
from nnstreamer_tpu_torch import faults as tfaults
from nnstreamer_tpu_torch import fleet as tfleet
from nnstreamer_tpu_torch.elements import query as tquery
from nnstreamer_tpu_torch.fleet.supervisor import QUARANTINED, READY
from nnstreamer_tpu_torch.obs import export as texport

VEC = (4,)
PKGS = {
    "jax": SimpleNamespace(fleet=jfleet, faults=jfaults, query=jquery, export=jexport, kw={}),
    "torch": SimpleNamespace(fleet=tfleet, faults=tfaults, query=tquery, export=texport,
                             kw={"device": "cpu"}),
}


class StubSupervisor:
    """Counts workers; never touches a socket (the JAX tests' stub)."""

    def __init__(self, pkg, clock, n=1):
        self.n = n
        self.seq = 0
        self.events = pkg.fleet.ScaleEventLog("stub", clock=clock)
        self.surfaces = []
        self.spawn_log, self.drain_log = [], []

    def tick(self):
        pass

    def worker_count(self, include_joining=True):
        return self.n

    def ready_count(self):
        return self.n

    def quarantined_count(self):
        return 0

    def draining_count(self):
        return 0

    def spawn_worker(self, wid=None, detail=""):
        self.seq += 1
        self.n += 1
        wid = wid or f"stub-w{self.seq}"
        self.spawn_log.append(wid)
        self.events.emit("spawn", wid, detail, fleet=self.n)
        return wid

    def pick_victim(self):
        return f"stub-w{self.seq}" if self.n else None

    def drain_worker(self, wid, detail="", blocking=False):
        self.n -= 1
        self.drain_log.append(wid)
        self.events.emit("drain", wid, detail, fleet=self.n)
        return True

    def stats(self):
        return {"spawns": len(self.spawn_log), "joined": len(self.spawn_log), "failed": 0,
                "quarantined": 0, "cancelled": 0, "pending": 0, "ledger_exact": True,
                "workers": {}}


BASE = dict(sweep=False, min_workers=1, max_workers=4, worker_rps=0.0, forecast=False,
            up_cooldown_s=1.0, down_cooldown_s=2.0, queue_wait_hi_ms=50.0,
            queue_wait_lo_ms=5.0, busy_hi=0.85, busy_lo=0.2, shed_hi=0.01, flap_window_s=30.0,
            flap_limit=3, storm_budget=3, storm_window_s=10.0)


def run_stub(pkg, name, signals, dts, n0=1, spec=None, health=False, **over):
    """Drive one controller of ``pkg`` over ``signals`` (FleetSignals kwargs
    a tick) with the fake clock advanced by ``dts``; returns what it did."""
    t = [1000.0]
    sup = StubSupervisor(pkg, lambda: t[0], n=n0)
    holder = {"sig": pkg.fleet.FleetSignals()}
    kw = dict(BASE)
    kw.update(over)
    eng = pkg.faults.install(spec) if spec else None
    a = pkg.fleet.Autoscaler(sup, lambda: holder["sig"], name=name, clock=lambda: t[0], **kw)
    try:
        sizes, docs = [], []
        for sig, dt in zip(signals, dts):
            holder["sig"] = pkg.fleet.FleetSignals(**sig)
            t[0] += dt
            a.tick()
            sizes.append(sup.n)
            if health:
                docs.append(pkg.export.health_document()["status"])
        st = a.stats()
        out = dict(sizes=sizes, events=a.events.snapshot(), spawns=sup.spawn_log,
                   drains=sup.drain_log, health=docs,
                   stats={k: st[k] for k in ("damped", "storm_reason", "last_decision",
                                             "forecast_rps", "fleet_size_min",
                                             "fleet_size_max", "ticks", "history_points")})
        if eng is not None:
            out["fault_log"] = list(eng.log)
        return out
    finally:
        a.stop()
        pkg.faults.deactivate()


SCENARIOS = {
    # a queue wait bouncing inside the (lo, hi) dead band: no action
    "hysteresis": dict(
        signals=[dict(queue_wait_p99_ms=6.0 + (i * 7) % 43, busy=0.5, offered_rps=10.0)
                 for i in range(40)], dts=[0.5] * 40),
    # one step up, then the up cooldown holds however loud the signal
    "up_cooldown": dict(
        signals=[dict(queue_wait_p99_ms=200.0)] * 13, dts=[0.1] + [0.5] * 12,
        up_cooldown_s=5.0, max_workers=5),
    # down only when every signal is idle, then the down cooldown, never below min
    "down": dict(
        signals=[dict(queue_wait_p99_ms=1.0, busy=0.5)] + [dict(queue_wait_p99_ms=1.0,
                                                               busy=0.05)] * 4,
        dts=[1.0, 1.0, 1.0, 4.1, 10.0], n0=3, down_cooldown_s=4.0),
    # past the spawn budget: a storm event and a degraded /healthz, then recovery
    "storm": dict(
        signals=[dict(queue_wait_p99_ms=500.0)] * 7, dts=[0.2] * 6 + [11.0],
        up_cooldown_s=0.0, max_workers=10, health=True),
    # alternating pressure: damped after flap_limit reversals
    "flap": dict(
        signals=[dict(queue_wait_p99_ms=500.0 if i % 2 == 0 else 0.5) for i in range(16)],
        dts=[0.5] * 16, up_cooldown_s=0.0, down_cooldown_s=0.0, flap_limit=3,
        flap_window_s=60.0, storm_budget=50),
    # the predictive leg scales up ahead of a ramp, queue wait still low
    "forecast": dict(
        signals=[dict(queue_wait_p99_ms=0.5, offered_rps=2.0 + 2.0 * i) for i in range(10)],
        dts=[1.0] * 10, forecast=True, forecast_horizon_s=5.0, history_window_s=60.0,
        worker_rps=10.0, up_cooldown_s=0.0),
    # the demand leg: measured load over per-worker capacity, then idle again
    "demand": dict(
        signals=[dict(offered_rps=r, queue_wait_p99_ms=0.5) for r in
                 (5, 5, 60, 60, 60, 60, 5, 5, 5, 5, 5, 5)],
        dts=[1.0] * 12, worker_rps=25.0, up_cooldown_s=0.0, down_cooldown_s=1.0),
    # the seeded scale_flap fault: absorbed by the damper, and replayable
    "scale_flap": dict(
        signals=[dict(queue_wait_p99_ms=10.0)] * 20, dts=[0.5] * 20,
        spec="seed=9;scale_flap@plan:every=2", up_cooldown_s=0.0, down_cooldown_s=0.0,
        flap_limit=2, flap_window_s=120.0, storm_budget=50),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_scenario_matches_the_reference(scenario):
    sc = dict(SCENARIOS[scenario])
    signals, dts = sc.pop("signals"), sc.pop("dts")
    name = f"as-{scenario}"
    got = {k: run_stub(pkg, name, signals, dts, **sc) for k, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    r = got["torch"]
    if scenario == "hysteresis":
        assert r["spawns"] == r["drains"] == [] and r["events"] == []
    elif scenario == "up_cooldown":
        assert r["sizes"][0] == 2 and r["sizes"][-1] == 3 and r["sizes"][9] == 2
    elif scenario == "down":
        assert r["sizes"] == [3, 2, 2, 1, 1]
    elif scenario == "storm":
        assert len(r["spawns"]) == 4 and [e["action"] for e in r["events"]].count("storm") == 1
        assert "degraded" in r["health"] and r["health"][-1] == "ok"
    elif scenario == "flap":
        assert any(e["action"] == "flap_damped" for e in r["events"])
        assert len(set(r["sizes"][-6:])) == 1
    elif scenario == "forecast":
        assert r["spawns"] and "forecast" in r["events"][0]["detail"]
    elif scenario == "demand":
        assert max(r["sizes"]) == 3 and r["sizes"][-1] == 1
    elif scenario == "scale_flap":
        assert r["fault_log"] and any(e["action"] == "flap_damped" for e in r["events"])


@pytest.mark.parametrize("sig", [
    dict(), dict(queue_wait_p99_ms=80.0), dict(shed_rate=0.2), dict(busy=0.95),
    dict(offered_rps=90.0), dict(queue_wait_p99_ms=1.0, busy=0.05),
    dict(queue_wait_p99_ms=1.0, busy=0.05, offered_rps=40.0),
    dict(queue_wait_p99_ms=20.0, busy=0.5, shed_rate=0.0),
])
@pytest.mark.parametrize("cur", [1, 2, 4])
def test_plan_is_the_reference_plan(sig, cur):
    """``_plan``'s raw desired count and reason on a grid of signals."""
    out = {}
    for k, pkg in PKGS.items():
        sup = StubSupervisor(pkg, lambda: 0.0, n=cur)
        kw = dict(BASE, worker_rps=30.0, max_workers=4)
        a = pkg.fleet.Autoscaler(sup, lambda: None, name=f"plan-{k}", clock=lambda: 0.0, **kw)
        try:
            out[k] = a._plan(pkg.fleet.FleetSignals(**sig), cur, 0.0)
        finally:
            a.stop()
    assert out["torch"] == out["jax"]


class LiveFleet:
    """In-process workers of one package behind its router, supervised and
    autoscaled on a fake clock; membership swept by the controller's tick."""

    def __init__(self, pkg, name, **over):
        self.pkg = pkg
        self.t = [5000.0]
        clock = lambda: self.t[0]  # noqa: E731
        self.membership = pkg.fleet.Membership(heartbeat_s=30.0)
        self.router = pkg.fleet.Router(self.membership, port=0, name=name, route_retries=4,
                                       retry_backoff_ms=1, retry_backoff_cap_ms=5).start()
        self.supervisor = pkg.fleet.Supervisor(
            pkg.fleet.InProcWorkerFactory(model=lambda x: x * 2.0, **pkg.kw),
            [pkg.fleet.Surface(self.membership, self.router)], name=name, clock=clock,
            events=pkg.fleet.ScaleEventLog(name, clock=clock),
            respawn_backoff_ms=0, crash_limit=3, crash_window_s=10.0, quarantine_s=5.0,
            spawn_timeout_s=30.0, drain_deadline_s=5.0)
        self.sig = {"sig": pkg.fleet.FleetSignals()}
        kw = dict(BASE, sweep=True, max_workers=3, up_cooldown_s=0.0, down_cooldown_s=0.0)
        kw.update(over)
        self.autoscaler = pkg.fleet.Autoscaler(self.supervisor, lambda: self.sig["sig"],
                                               name=name, clock=clock, **kw)

    def tick(self, dt=1.0, **sig):
        self.t[0] += dt
        self.sig["sig"] = self.pkg.fleet.FleetSignals(**sig)
        self.autoscaler.tick()
        self.supervisor.join_drains()

    def request(self, v):
        s = socket.create_connection(("127.0.0.1", self.router.port), timeout=15)
        s.settimeout(15)
        try:
            self.pkg.query.send_tensors(s, (np.full(VEC, v, np.float32),), 0)
            outs, _ = self.pkg.query.recv_tensors(s)
            return float(np.asarray(outs[0])[0])
        finally:
            s.close()

    def close(self):
        self.autoscaler.stop()
        self.supervisor.stop()
        self.router.stop()
        self.membership.stop()


def _events(fleet):
    return [(e["action"], e["worker"], e.get("fleet"), e["t"])
            for e in fleet.supervisor.events.snapshot()]


def test_live_fleet_ticks_match_the_reference():
    """An InProcWorkerFactory fleet under both packages' controllers: the
    same signals at the same ``now`` give the same workers, the same scale
    events and the same spawn ledger, and the fleet serves throughout."""

    def case(pkg):
        f = LiveFleet(pkg, f"live-{id(pkg)}")
        try:
            f.supervisor.spawn_worker(detail="floor")
            plan = ([dict(queue_wait_p99_ms=1.0, busy=0.5)] * 2
                    + [dict(queue_wait_p99_ms=200.0)] * 3
                    + [dict(queue_wait_p99_ms=20.0, busy=0.5)] * 2
                    + [dict(queue_wait_p99_ms=1.0, busy=0.05)] * 4)
            sizes, served = [], []
            for sig in plan:
                f.tick(**sig)
                sizes.append((f.supervisor.worker_count(), f.supervisor.ready_count()))
                served.append(f.request(len(sizes)))
            st = f.supervisor.stats()
            return dict(sizes=sizes, events=_events(f), served=served,
                        ledger={k: st[k] for k in ("spawns", "joined", "failed", "quarantined",
                                                   "pending", "ledger_exact")},
                        states=sorted((m.wid, m.state) for m in f.supervisor.managed()))
        finally:
            f.close()

    got = {k: case(pkg) for k, pkg in PKGS.items()}
    for k in ("jax", "torch"):  # the names carry each fleet's id: compare the rest
        got[k]["events"] = [(a, w.rsplit("-", 1)[-1], n, t) for a, w, n, t in got[k]["events"]]
        got[k]["states"] = [(w.rsplit("-", 1)[-1], s) for w, s in got[k]["states"]]
    assert got["torch"] == got["jax"]
    r = got["torch"]
    assert max(n for n, _ in r["sizes"]) == 3 and r["sizes"][-1] == (1, 1)
    assert r["served"] == [2.0 * (i + 1) for i in range(len(r["sizes"]))]
    assert r["ledger"]["ledger_exact"]


def test_spawn_fail_fault_degrades_identically():
    """A seeded ``spawn_fail`` on the second attempt: the attempt resolves
    failed, the next succeeds, the ledgers stay exact — in both packages
    alike."""

    def case(pkg):
        eng = pkg.faults.install("seed=3;spawn_fail@spawn:after=1")
        f = LiveFleet(pkg, "sf")
        try:
            w1 = f.supervisor.spawn_worker(detail="floor")
            w2 = f.supervisor.spawn_worker(detail="scale-up")
            w3 = f.supervisor.spawn_worker(detail="retry")
            for _ in range(2):
                f.membership.sweep()
                f.supervisor.tick()
            st = f.supervisor.stats()
            return dict(wids=[w1, w2, w3], actions=[e[0] for e in _events(f)],
                        fault_log=list(eng.log), ready=f.supervisor.ready_count(),
                        ledger={k: st[k] for k in ("spawns", "joined", "failed", "ledger_exact")},
                        served=f.request(5.0))
        finally:
            f.close()
            pkg.faults.deactivate()

    got = {k: case(pkg) for k, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    r = got["torch"]
    assert r["wids"][1] is None and r["ready"] == 2 and r["served"] == 10.0
    assert r["ledger"] == dict(spawns=3, joined=2, failed=1, ledger_exact=True)


class TestSupervisor:
    def test_kill_respawns_same_wid_new_incarnation(self):
        f = LiveFleet(PKGS["torch"], "resp")
        try:
            wid = f.supervisor.spawn_worker(detail="floor")
            f.tick(queue_wait_p99_ms=10.0)
            assert f.supervisor.get(wid).state == READY
            gen = f.membership.get(wid).generation
            nonce = f.supervisor.get(wid).handle.nonce
            f.supervisor.get(wid).handle.kill()
            for _ in range(2):
                f.tick(queue_wait_p99_ms=10.0)
            m = f.supervisor.get(wid)
            assert m.state == READY and m.restarts == 1 and m.handle.nonce != nonce
            assert f.membership.get(wid).generation == gen + 1
            assert len(f.supervisor.managed()) == 1
            assert f.request(3.0) == 6.0
            assert f.supervisor.stats()["ledger_exact"]
        finally:
            f.close()

    def test_crash_loop_quarantined_with_why_then_released(self):
        f = LiveFleet(PKGS["torch"], "crash", min_workers=1, max_workers=1)
        try:
            wid = f.supervisor.spawn_worker(detail="floor")
            f.tick(queue_wait_p99_ms=10.0)
            for _ in range(3):
                f.supervisor.get(wid).handle.kill()
                f.tick(0.5, queue_wait_p99_ms=10.0)
                f.tick(0.5, queue_wait_p99_ms=10.0)
            m = f.supervisor.get(wid)
            assert m.state == QUARANTINED
            snap = f.supervisor.stats()["workers"][wid]
            assert "crash loop" in snap["quarantine_reason"] and snap["quarantined_for_s"] > 0
            assert f.membership.get(wid).state == "down"
            st = f.supervisor.stats()
            assert st["quarantined"] == 1 and st["ledger_exact"]
            # the controller replaced the held-down capacity meanwhile
            (spare,) = [m.wid for m in f.supervisor.managed() if m.wid != wid]
            assert f.supervisor.get(spare).state == READY
            f.tick(6.0, queue_wait_p99_ms=10.0)  # past quarantine_s
            f.tick(0.5, queue_wait_p99_ms=10.0)
            assert f.supervisor.events.count("release") == 1
            assert f.supervisor.get(wid).restarts == 3
            # the release respawns it, over max_workers=1: the scale-down
            # cancels that joining respawn and keeps the serving spare
            # (ROADMAP C21; the JAX package drains the spare)
            drains = [e for e in f.supervisor.events.snapshot() if e["action"] == "drain"]
            assert [(e["worker"], e["detail"]) for e in drains] == [
                (wid, "cancelled while joining")]
            assert f.supervisor.get(spare).state == READY and f.supervisor.ready_count() == 1
            assert f.request(4.0) == 8.0
            st = f.supervisor.stats()
            assert st["cancelled"] == 1 and st["ledger_exact"]
        finally:
            f.close()

    def test_a_spawn_in_flight_is_never_ready(self):
        """A spawn still running on another thread has registered nothing:
        a concurrent supervision pass leaves it joining (no join before the
        worker exists, no second join after)."""
        import threading

        f = LiveFleet(PKGS["torch"], "inflight")
        release = threading.Event()
        inner = f.supervisor.factory

        class SlowFactory:
            def spawn(self, wid):
                release.wait(15)
                return inner.spawn(wid)

        f.supervisor.factory = SlowFactory()
        try:
            t = threading.Thread(target=f.supervisor.spawn_worker)
            t.start()
            deadline = time.monotonic() + 15
            while not f.supervisor.managed() and time.monotonic() < deadline:
                time.sleep(0.01)
            f.supervisor.tick()
            assert f.supervisor.ready_count() == 0 and f.supervisor.joined == 0
            release.set()
            t.join(15)
            for _ in range(2):
                f.membership.sweep()
                f.supervisor.tick()
            st = f.supervisor.stats()
            assert st["joined"] == 1 and st["ledger_exact"]
            assert f.supervisor.events.count("join") == 1
        finally:
            release.set()
            f.close()


def test_scale_down_cancels_a_joining_worker_not_the_last_routable_one():
    """A spike's scale-up still warming when the load falls back: the port's
    scale-down drains that joining worker and the floor keeps serving; the
    JAX package drains the floor, its only routable worker (ROADMAP C21)."""

    def case(pkg):
        f = LiveFleet(pkg, f"c21-{pkg.fleet.__name__}")
        try:
            floor = f.supervisor.spawn_worker(detail="floor")
            f.tick(queue_wait_p99_ms=10.0)
            f.tick(queue_wait_p99_ms=200.0)  # the spike: one more worker
            (spawned,) = [m.wid for m in f.supervisor.managed() if m.wid != floor]
            f.supervisor.get(spawned).handle.worker._warming = True  # still capturing
            f.tick(queue_wait_p99_ms=1.0, busy=0.05)  # the spike is over
            drains = [(e["worker"], e["detail"]) for e in f.supervisor.events.snapshot()
                      if e["action"] == "drain"]
            out = dict(floor=floor, spawned=spawned, drains=drains,
                       ready=f.supervisor.ready_count(),
                       states={m.wid: m.state for m in f.supervisor.managed()},
                       ledger={k: f.supervisor.stats()[k]
                               for k in ("spawns", "joined", "ledger_exact")})
            if pkg is PKGS["torch"]:
                out["served"] = f.request(3.0)
                out["cancelled"] = f.supervisor.stats()["cancelled"]
                out["spawned_drained"] = f.supervisor.get(spawned).handle.worker._draining
            return out
        finally:
            f.close()

    ref, got = case(PKGS["jax"]), case(PKGS["torch"])
    # the reference: the floor drained, the fleet left with nothing routable
    assert [w for w, _ in ref["drains"]] == [ref["floor"]] and ref["ready"] == 0
    assert ref["states"][ref["spawned"]] == "joining"
    # the port: the joining worker cancelled, the floor never touched
    ((drained, detail),) = got["drains"]
    assert drained == got["spawned"] and detail.startswith("idle: ")
    assert detail.endswith("; cancelled while joining")
    assert got["states"] == {got["floor"]: READY, got["spawned"]: "removed"}
    assert got["ready"] == 1 and got["served"] == 6.0 and got["spawned_drained"]
    assert got["cancelled"] == 1
    assert got["ledger"] == dict(spawns=2, joined=1, ledger_exact=True)


def test_the_last_ready_worker_stays_while_a_respawn_is_pending():
    """One worker ready and one dead with its respawn backed off: the scale-down
    finds no victim (draining the ready one would leave nothing routable);
    the JAX package names the ready one."""
    victims = {}
    for k, pkg in PKGS.items():
        f = LiveFleet(pkg, f"last-{k}")
        try:
            a = f.supervisor.spawn_worker(detail="floor")
            b = f.supervisor.spawn_worker(detail="second")
            f.tick(queue_wait_p99_ms=10.0)
            f.supervisor.respawn_backoff_ms = 60_000.0
            f.supervisor.get(b).handle.kill()
            f.tick(queue_wait_p99_ms=10.0)
            assert f.supervisor.get(b).state == "dead"
            victims[k] = (f.supervisor.pick_victim(), a)
            if k == "torch":
                f.tick(queue_wait_p99_ms=1.0, busy=0.05)  # idle: the plan wants one fewer
                assert f.supervisor.get(a).state == READY
                assert f.supervisor.events.count("drain") == 0
                assert f.request(2.0) == 4.0
        finally:
            f.close()
    assert victims["jax"][0] == victims["jax"][1]
    assert victims["torch"][0] is None


def test_no_join_before_a_probe_of_the_incarnation():
    """A spawned worker's roster entry reads ``unprobed`` until a probe
    answers: a supervision pass with no sweep before it joins nothing, a
    router picks nothing; the JAX package's entry reads up and joins
    (ROADMAP C22).  Its first probe's ``warming`` holds the join off."""
    joined = {}
    for k, pkg in PKGS.items():
        f = LiveFleet(pkg, f"c22-{k}")
        try:
            wid = f.supervisor.spawn_worker(detail="floor")
            f.supervisor.tick()
            joined[k] = (f.supervisor.get(wid).state, f.membership.get(wid).state)
            if k == "torch":
                with pytest.raises(tfleet.NoWorkerAvailable):
                    f.membership.pick()
                f.supervisor.get(wid).handle.worker._warming = True
                f.membership.sweep()
                f.supervisor.tick()
                assert (f.supervisor.get(wid).state, f.membership.get(wid).state) == (
                    "joining", "warming")
                f.supervisor.get(wid).handle.worker._warming = False
                f.membership.sweep()
                f.supervisor.tick()
                assert f.supervisor.get(wid).state == READY
                assert f.request(1.5) == 3.0
        finally:
            f.close()
    assert joined == {"jax": (READY, "up"), "torch": ("joining", "unprobed")}
