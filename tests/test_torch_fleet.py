"""The port's fleet tier against the JAX package's, on the CPU.

Case for case with the JAX package's ``tests/test_fleet.py``: stateless
failover and re-route, membership (suspect versus dead, degraded, the
breaker), graceful drain, sticky sessions, live migration on a planned
drain, and the seeded chaos schedule.  Where the JAX fleet runs the same
case, both packages run it here on in-process workers (``BUILTIN``-style
custom models, ``device="cpu"`` for the port) with the same inputs and the
same seeded fault spec, and the test holds them equal: the replies, the
router ledger (``offered``, ``delivered``, ``shed`` by reason,
``rerouted``), the per-worker dispatch counts, the membership states after
each explicit ``sweep()``, and the decode streams (exact within a package
against an undisturbed run; within 1e-5 across packages, whose float
arithmetic differs).  Then the wire: the JAX package's stock
``tensor_query_client`` against the port's router, and the reverse.  Two
cases run ``python -m nnstreamer_tpu_torch.fleet worker`` as subprocesses.

Nothing here waits on a heartbeat thread: membership is driven by explicit
``sweep()`` calls, every socket binds 127.0.0.1:0, every blocking wait has
a deadline of 10 s or more, and no latency or rate is asserted.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu import faults as jfaults
from nnstreamer_tpu import fleet as jfleet
from nnstreamer_tpu.elements import query as jquery
from nnstreamer_tpu.fleet import chaos as jchaos
from nnstreamer_tpu.fleet import repo as jrepo
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu_torch import faults as tfaults
from nnstreamer_tpu_torch import fleet as tfleet
from nnstreamer_tpu_torch.elements import query as tquery
from nnstreamer_tpu_torch.fleet import chaos as tchaos
from nnstreamer_tpu_torch.fleet import repo as trepo
from nnstreamer_tpu_torch.fleet.supervisor import SpawnError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = (4,)
WAIT_S = 15.0

ENGINE_KW = dict(t_max=16, d_in=4, n_out=4, d_model=16, n_heads=2, n_layers=1)
JTREE = jt.init_params(jax.random.PRNGKey(0), ENGINE_KW["d_model"], ENGINE_KW["n_heads"],
                       ENGINE_KW["n_layers"], 4 * ENGINE_KW["d_model"], ENGINE_KW["d_in"],
                       ENGINE_KW["n_out"])
TREE = jax.tree_util.tree_map(np.asarray, JTREE)

PKGS = {
    "jax": SimpleNamespace(name="jax", fleet=jfleet, faults=jfaults, query=jquery,
                           chaos=jchaos, repo=jrepo, kw={}, repo_kw={},
                           engine=dict(capacity=2, params=JTREE, **ENGINE_KW)),
    "torch": SimpleNamespace(name="torch", fleet=tfleet, faults=tfaults, query=tquery,
                             chaos=tchaos, repo=trepo, kw={"device": "cpu"},
                             repo_kw={"device": "cpu"},
                             engine=dict(capacity=2, params=TREE, **ENGINE_KW)),
}


def _wait_for(fn, timeout=WAIT_S, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return fn()


def _counting_model(counts, name, factor=2.0, delay_s=0.0):
    def fn(x):
        # the custom backend infers its output spec with a zero dummy
        # forward: only real dispatches count
        if np.any(np.asarray(x)):
            counts[name] = counts.get(name, 0) + 1
            if delay_s:
                time.sleep(delay_s)
        return x * factor

    return fn


class RawClient:
    """A bare NNSQ socket (the same bytes in both packages)."""

    def __init__(self, pkg, port, timeout=WAIT_S):
        self.q = pkg.query
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        self.sock.settimeout(timeout)

    def request(self, arrays, pts=0):
        self.q.send_tensors(self.sock, arrays, pts)
        return self.q.recv_tensors(self.sock)

    def recv(self):
        return self.q.recv_tensors(self.sock)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Fleet:
    """N in-process workers of one package + membership (explicit sweeps)
    + router."""

    def __init__(self, pkg, n=3, stateful=False, counts=None, worker_kwargs=None,
                 membership_kwargs=None, router_kwargs=None, prefix="w"):
        self.pkg = pkg
        self.counts = counts if counts is not None else {}
        # a breaker that never half-opens on its own: what a case sees does
        # not depend on how long it took
        mk = dict(heartbeat_s=30.0, suspect_misses=2, death_misses=4, breaker_failures=2,
                  breaker_reset_s=600.0)
        mk.update(membership_kwargs or {})
        self.membership = pkg.fleet.Membership(**mk)
        self.workers, self.infos = [], {}
        for i in range(n):
            name = f"{prefix}{i}"
            wk = dict(name=name, model=_counting_model(self.counts, name), **pkg.kw)
            wk.update(worker_kwargs or {})
            w = pkg.fleet.FleetWorker(**wk).start()
            self.workers.append(w)
            port = w.decode_port if stateful else w.query_port
            self.infos[name] = self.membership.add("127.0.0.1", port, probe=w.probe,
                                                   worker_id=name)
        rk = dict(route_retries=4, retry_backoff_ms=1, retry_backoff_cap_ms=5,
                  request_timeout=WAIT_S)
        rk.update(router_kwargs or {})
        self.router = pkg.fleet.Router(self.membership, port=0, stateful=stateful,
                                       **rk).start()

    def client(self):
        return RawClient(self.pkg, self.router.port)

    def sweep(self, n=1):
        for _ in range(n):
            self.membership.sweep()

    def states(self):
        return {w.id: w.state for w in self.membership.workers()}

    def ledger(self):
        st = self.router.stats()
        return dict(offered=st["offered"], delivered=st["delivered"], shed=st["shed"],
                    rerouted=st["rerouted"])

    def close(self):
        self.router.stop()
        self.membership.stop()
        for w in self.workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001 - already killed is fine
                pass


def both(case):
    """Run ``case(pkg)`` for each package; returns {name: its result}."""
    return {name: case(pkg) for name, pkg in PKGS.items()}


def _settled(fleet, n):
    # the router counts a delivery right after the reply bytes go out
    assert _wait_for(lambda: fleet.router.stats()["delivered"]
                     + fleet.router.stats()["shed_total"] >= n), fleet.router.stats()


# -- stateless failover ------------------------------------------------------


class TestStatelessFailover:
    def test_round_robin_spreads_and_results_exact(self):
        def case(pkg):
            f = Fleet(pkg)
            try:
                c = f.client()
                replies = []
                for i in range(12):
                    outs, pts = c.request((np.full(VEC, float(i + 1), np.float32),), pts=i)
                    replies.append((pts, np.asarray(outs[0]).tolist()))
                c.close()
                _settled(f, 12)
                return dict(replies=replies, counts=dict(f.counts), ledger=f.ledger())
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        r = got["torch"]
        assert r["replies"] == [(i, [2.0 * (i + 1)] * 4) for i in range(12)]
        assert sorted(r["counts"].values()) == [4, 4, 4]
        assert r["ledger"] == dict(offered=12, delivered=12, shed={}, rerouted=0)

    def test_worker_kill_transparent_reroute(self):
        def case(pkg):
            f = Fleet(pkg)
            try:
                f.workers[0].kill()  # membership has not noticed (no sweep)
                c = f.client()
                replies = [np.asarray(c.request((np.full(VEC, float(i), np.float32),))[0][0])
                           .tolist() for i in range(6)]
                c.close()
                _settled(f, 6)
                return dict(replies=replies, counts=dict(f.counts), ledger=f.ledger(),
                            failures=f.infos["w0"].failures)
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        r = got["torch"]
        assert r["replies"] == [[2.0 * i] * 4 for i in range(6)]
        assert r["ledger"]["shed"] == {} and r["ledger"]["rerouted"] >= 1
        assert "w0" not in r["counts"]

    def test_typed_worker_rejection_tries_next_worker(self):
        def case(pkg):
            f = Fleet(pkg)
            try:
                # w0 sheds typed [UNAVAILABLE] and keeps its socket open
                f.workers[0].query_server._draining = True
                c = f.client()
                replies = [np.asarray(c.request((np.full(VEC, float(i), np.float32),))[0][0])
                           .tolist() for i in range(6)]
                c.close()
                _settled(f, 6)
                return dict(replies=replies, counts=dict(f.counts), ledger=f.ledger())
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        assert got["torch"]["ledger"]["shed"] == {} and "w0" not in got["torch"]["counts"]

    def test_fleet_exhausted_typed_unavailable(self):
        def case(pkg):
            f = Fleet(pkg)
            try:
                for w in f.workers:
                    w.kill()
                f.sweep(4)  # death_misses=4: everyone DOWN
                c = f.client()
                with pytest.raises(pkg.query.QueryUnavailableError):
                    c.request((np.ones(VEC, np.float32),))
                c.close()
                _settled(f, 1)
                return dict(states=f.states(), ledger=f.ledger())
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        assert got["torch"]["ledger"] == dict(offered=1, delivered=0, shed={"unavailable": 1},
                                              rerouted=0)
        assert set(got["torch"]["states"].values()) == {"down"}

    def test_kill_mid_coalesced_group_rerouted_never_lost(self):
        """A worker dying with a half-assembled batch group: every member of
        the group is re-dispatched on the spare, never lost."""
        pkg = PKGS["torch"]
        counts = {}
        # a long batch window: the group is certainly pending when the kill lands
        f = Fleet(pkg, n=1, counts=counts, worker_kwargs=dict(batch=4, batch_window_ms=10000.0))
        try:
            spare = tfleet.FleetWorker(name="spare", model=_counting_model(counts, "spare"),
                                       device="cpu").start()
            f.workers.append(spare)
            results, errors = [], []

            def one(i):
                c = f.client()
                try:
                    outs, _ = c.request((np.full((1, 4), float(i + 1), np.float32),))
                    results.append((i, float(outs[0][0, 0])))
                except Exception as exc:  # noqa: BLE001 - asserted below
                    errors.append(exc)
                finally:
                    c.close()

            ths = [threading.Thread(target=one, args=(i,)) for i in range(2)]
            for t in ths:
                t.start()
            assert _wait_for(lambda: f.router.stats()["offered"] == 2)
            f.membership.add("127.0.0.1", spare.query_port, probe=spare.probe,
                             worker_id="spare")
            f.workers[0].kill()
            for t in ths:
                t.join(timeout=30)
            assert not errors, errors
            assert sorted(results) == [(0, 2.0), (1, 4.0)]
            assert counts.get("spare", 0) == 2
            assert f.router.stats()["rerouted"] >= 2
        finally:
            f.close()


# -- membership --------------------------------------------------------------


class TestMembership:
    def test_state_sequence_after_each_sweep(self):
        """Suspect versus dead, revival, degraded and warming: the states
        after each explicit sweep are the JAX package's."""

        def case(pkg):
            f = Fleet(pkg)
            try:
                seq = []
                info = f.infos["w1"]
                info.block_health = True  # heartbeat channel cut, data path alive
                for _ in range(4):
                    f.sweep()
                    seq.append(f.states())
                info.block_health = False
                f.workers[0].degraded_reason = "slow card"
                f.sweep()
                seq.append(f.states())
                f.workers[2]._warming = True
                f.sweep()
                seq.append(f.states())
                f.workers[2]._warming = False
                f.workers[0].degraded_reason = ""
                f.sweep()
                seq.append(f.states())
                snap = {w.id: {k: v for k, v in w.snapshot().items()
                               if k not in ("addr", "incarnation")}
                        for w in f.membership.workers()}
                return dict(seq=seq, snap=snap)
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        seq = got["torch"]["seq"]
        assert [s["w1"] for s in seq] == ["up", "suspect", "suspect", "down", "up", "up", "up"]
        assert seq[4]["w0"] == "degraded" and seq[5]["w2"] == "warming"
        assert got["torch"]["snap"]["w1"]["revivals"] == 1

    def test_heartbeat_loss_vs_death_no_duplicate_dispatch(self):
        """Partition is not a crash: a worker that misses heartbeats is
        SUSPECT (no new dispatch, nothing torn down) and an in-flight
        request on its live data path completes exactly once."""
        pkg = PKGS["torch"]
        counts = {}
        release = threading.Event()

        def held(x):
            if np.any(np.asarray(x)):
                counts["w0"] = counts.get("w0", 0) + 1
                release.wait(WAIT_S)  # the request stays in flight until released
            return x * 2.0

        f = Fleet(pkg, n=1, counts=counts, worker_kwargs=dict(model=held))
        try:
            info = f.infos["w0"]
            got = {}

            def one():
                c = f.client()
                try:
                    got["out"] = float(c.request((np.full(VEC, 3.0, np.float32),))[0][0][0])
                finally:
                    c.close()

            t = threading.Thread(target=one)
            t.start()
            assert _wait_for(lambda: counts.get("w0", 0) == 1)
            info.block_health = True
            f.sweep(2)  # suspect_misses=2
            assert info.state == "suspect"
            release.set()
            t.join(timeout=WAIT_S)
            assert got["out"] == 6.0
            c = f.client()
            with pytest.raises(tquery.QueryUnavailableError):
                c.request((np.ones(VEC, np.float32),))
            c.close()
            info.block_health = False
            f.sweep()
            assert info.state == "up" and info.misses == 0
            c = f.client()
            assert float(c.request((np.full(VEC, 4.0, np.float32),))[0][0][0]) == 8.0
            c.close()
            assert counts["w0"] == 2  # one invoke a delivered request
        finally:
            release.set()
            f.close()

    def test_degraded_worker_deprioritized_not_dropped(self):
        def case(pkg):
            f = Fleet(pkg)
            try:
                f.workers[0].degraded_reason = "slow card"
                f.sweep()
                c = f.client()
                for i in range(8):
                    c.request((np.full(VEC, float(i + 1), np.float32),))
                before = dict(f.counts)
                f.workers[1].kill()
                f.workers[2].kill()
                f.sweep(4)
                out = float(c.request((np.full(VEC, 9.0, np.float32),))[0][0][0])
                c.close()
                return dict(before=before, after=dict(f.counts), out=out,
                            reason=f.infos["w0"].degraded_reason, states=f.states())
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        r = got["torch"]
        assert "w0" not in r["before"] and r["after"]["w0"] == 1 and r["out"] == 18.0
        assert r["reason"] == "slow card"

    def test_flapping_worker_quarantined_by_breaker(self):
        def case(pkg):
            f = Fleet(pkg)
            try:
                # the query server dies, the probe keeps answering "ok"
                f.workers[0].query_server.kill()
                c = f.client()
                replies = [np.asarray(c.request((np.full(VEC, float(i), np.float32),))[0][0])
                           .tolist() for i in range(8)]
                c.close()
                _settled(f, 8)
                info = f.infos["w0"]
                return dict(replies=replies, state=info.state,
                            breaker=info.breaker.stats()["state"], failures=info.failures,
                            ledger=f.ledger(),
                            skips=f.membership.stats()["quarantine_skips"] > 0)
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        r = got["torch"]
        assert r["state"] == "up" and r["breaker"] == "open" and r["failures"] >= 2

    def test_breaker_quarantine_lifts_when_the_worker_serves_again(self):
        pkg = PKGS["torch"]
        f = Fleet(pkg, membership_kwargs=dict(breaker_reset_s=0.2))
        try:
            f.workers[0].query_server.kill()
            c = f.client()
            for i in range(8):
                c.request((np.full(VEC, float(i), np.float32),))
            c.close()
            info = f.infos["w0"]
            assert info.breaker.stats()["state"] == "open"
            f.workers[0].query_server = tquery.QueryServer(
                framework="custom", model=_counting_model(f.counts, "w0"),
                port=f.workers[0].query_port, device="cpu").start()

            def recovered():
                cc = f.client()
                try:
                    cc.request((np.ones(VEC, np.float32),))
                finally:
                    cc.close()
                return f.counts.get("w0", 0) >= 1

            assert _wait_for(recovered, interval=0.05)
        finally:
            f.close()

    @pytest.mark.parametrize("first", ["ok", "warming:capture-ahead warmup", "miss"])
    def test_a_spawned_entry_is_unprobed_until_its_first_probe(self, first):
        """``assume_up=False`` (a supervisor's spawn) or a rebind: no pick
        until a probe answers, then the probe's verdict (ROADMAP C22); a
        miss keeps it unprobed, and misses still make it suspect, then down."""
        m = tfleet.Membership(heartbeat_s=30.0, suspect_misses=2, death_misses=3)
        answer = {"status": first}

        def probe(_w):
            if answer["status"] == "miss":
                raise ConnectionError("no answer yet")
            return answer["status"]

        w = m.add("127.0.0.1", 1, probe=probe, worker_id="s", assume_up=False)
        assert w.state == "unprobed"
        with pytest.raises(tfleet.NoWorkerAvailable):
            m.pick()
        m.sweep()
        want = {"ok": "up", "warming:capture-ahead warmup": "warming", "miss": "unprobed"}
        assert w.state == want[first]
        if first == "ok":
            assert m.pick() is w
            m.rebind("s", "127.0.0.1", 2, probe=probe)  # a new incarnation
            assert w.state == "unprobed" and w.port == 2
            with pytest.raises(tfleet.NoWorkerAvailable):
                m.pick()
        elif first == "miss":
            m.sweep()
            assert w.state == "suspect"
            m.sweep()
            assert w.state == "down"
        answer["status"] = "ok"
        m.sweep()
        assert w.state == "up" and m.pick() is w
        assert m.add("127.0.0.1", 3, probe=probe, worker_id="static").state == "up"


# -- graceful drain ----------------------------------------------------------


class TestGracefulDrain:
    def test_worker_drain_is_draining_to_membership_and_goodbyes_typed(self):
        def case(pkg):
            f = Fleet(pkg, n=2)
            try:
                c = RawClient(pkg, f.workers[0].query_port)
                assert float(c.request((np.full(VEC, 1.0, np.float32),))[0][0][0]) == 2.0
                got = {}

                def parked():
                    try:
                        got["out"] = c.recv()
                    except Exception as exc:  # noqa: BLE001 - asserted below
                        got["exc"] = type(exc).__name__

                t = threading.Thread(target=parked)
                t.start()
                assert _wait_for(lambda: bool(f.workers[0].query_server._conns))
                clean = f.workers[0].drain(timeout=5.0)
                t.join(timeout=WAIT_S)
                c.close()
                probe = f.workers[0].probe()
                f.sweep()
                return dict(clean=clean, goodbye=got.get("exc"), probe=probe,
                            states=f.states())
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        assert got["torch"] == dict(clean=True, goodbye="QueryUnavailableError",
                                    probe="draining", states={"w0": "draining", "w1": "up"})

    def test_worker_without_a_gpu_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tfleet.FleetWorker(name="x")


# -- sticky sessions and live migration --------------------------------------


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(ENGINE_KW["d_in"]).astype(np.float32) for _ in range(n)]


class TestStickySessions:
    def test_session_sticky_and_exact(self):
        steps = _stream(3, 5)

        def case(pkg):
            f = Fleet(pkg, n=2, stateful=True,
                      worker_kwargs=dict(engine=dict(pkg.engine), model="x2"))
            try:
                c = f.client()
                outs, pts = c.request((np.zeros(ENGINE_KW["d_in"], np.float32),),
                                      pts=pkg.query.PROBE_PTS)
                probe_pinned = f.router.session_count()
                ys = [np.asarray(c.request((x,))[0][0]) for x in steps]
                pinned = [w for w in ("w0", "w1") if f.router.session_count(w)]
                c.close()
                assert _wait_for(lambda: f.router.session_count() == 0)
                return dict(probe_pinned=probe_pinned, pinned=pinned, ys=ys)
            finally:
                f.close()

        got = both(case)
        assert got["torch"]["probe_pinned"] == got["jax"]["probe_pinned"] == 0
        assert got["torch"]["pinned"] == got["jax"]["pinned"] and len(got["torch"]["pinned"]) == 1
        np.testing.assert_allclose(np.stack(got["torch"]["ys"]), np.stack(got["jax"]["ys"]),
                                   rtol=1e-5, atol=1e-5)

    def test_worker_kill_breaks_session_typed_fail_fast(self):
        def case(pkg):
            f = Fleet(pkg, n=2, stateful=True,
                      worker_kwargs=dict(engine=dict(pkg.engine), model="x2"))
            try:
                c = f.client()
                c.request((np.ones(ENGINE_KW["d_in"], np.float32),))
                pinned = next(w for w in ("w0", "w1") if f.router.session_count(w))
                next(w for w in f.workers if w.name == pinned).kill()
                with pytest.raises(pkg.query.QuerySessionBrokenError):
                    c.request((np.ones(ENGINE_KW["d_in"], np.float32),))
                c.close()
                c2 = f.client()
                out = c2.request((np.ones(ENGINE_KW["d_in"], np.float32),))[0][0]
                c2.close()
                return dict(broken=f.router.sessions_broken, shape=tuple(np.shape(out)))
            finally:
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"] == dict(broken=1, shape=(ENGINE_KW["n_out"],))

    def test_live_migration_on_drain_is_token_identical(self):
        """Two sessions, one a worker; drain_worker on one of them mid-stream
        moves its session through the repo server; every stream finishes
        exactly as an undisturbed run of the same package, and within 1e-5
        of the other package's."""
        prompts = [np.random.default_rng(10 + k).standard_normal(
            (3, ENGINE_KW["d_in"])).astype(np.float32) for k in range(2)]
        streams = [_stream(20 + k, 6) for k in range(2)]

        def run(pkg, drain):
            repo = pkg.repo.TensorRepoServer(port=0, **pkg.repo_kw).start()
            f = Fleet(pkg, n=2, stateful=True,
                      worker_kwargs=dict(engine=dict(pkg.engine), model="x2"),
                      router_kwargs=dict(repo_addr=f"127.0.0.1:{repo.port}"))
            try:
                cs = [f.client() for _ in range(2)]
                ys = [[np.asarray(c.request((p,))[0][0])] for c, p in zip(cs, prompts)]
                by = {w: f.router.session_count(w) for w in ("w0", "w1")}
                for i in range(6):
                    if drain and i == 3:
                        assert f.router.drain_worker("w0", deadline_s=WAIT_S) == 0
                    for k, c in enumerate(cs):
                        ys[k].append(np.asarray(c.request((streams[k][i],))[0][0]))
                st = f.router.stats()
                for c in cs:
                    c.close()
                return ys, by, dict(migrated=st["sessions_migrated"],
                                     broken=st["sessions_broken"],
                                     aborts=st["migration_aborts"],
                                     state_w0=f.membership.get("w0").state)
            finally:
                f.close()
                repo.stop()

        got = {}
        for name, pkg in PKGS.items():
            plain, _, _ = run(pkg, drain=False)
            moved, by, st = run(pkg, drain=True)
            assert by == {"w0": 1, "w1": 1}
            assert st == dict(migrated=1, broken=0, aborts={}, state_w0="down")
            for a, b in zip(plain, moved):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            got[name] = moved
        for a, b in zip(got["torch"], got["jax"]):
            np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=1e-5, atol=1e-5)


# -- the seeded chaos schedule -----------------------------------------------


class TestFleetChaos:
    SPEC = "seed=11;worker_kill@q1:after=3;partition@q2:after=6,ms=600000"

    def test_seeded_kill_partition_schedule(self):
        """The same spec and tick order kill and partition the same
        workers at the same ticks in both packages; every stateless request
        is delivered by re-route; the ledgers and the states after each
        tick's sweep are equal; the schedule replays from the seed."""

        def case(pkg):
            eng = pkg.faults.install(self.SPEC)
            f = Fleet(pkg, prefix="q", membership_kwargs=dict(death_misses=3))
            try:
                chaos = pkg.chaos.FleetChaos(
                    {w.name: pkg.chaos.InProcHandle(w, f.infos[w.name]) for w in f.workers})
                c = f.client()
                replies, states = [], []
                for tick in range(10):
                    chaos.tick()
                    f.sweep()
                    states.append(f.states())
                    for i in range(3):
                        x = float(tick * 3 + i + 1)
                        replies.append(float(c.request((np.full(VEC, x, np.float32),))
                                             [0][0][0]))
                c.close()
                _settled(f, 30)
                replay = pkg.faults.ChaosEngine(self.SPEC)
                for name in chaos.consults:
                    replay.decide("fleet", name)
                return dict(applied=chaos.applied, states=states, replies=replies,
                            ledger=f.ledger(), counts=dict(f.counts),
                            replayed=replay.log == eng.log)
            finally:
                pkg.faults.deactivate()
                f.close()

        got = both(case)
        assert got["torch"] == got["jax"]
        r = got["torch"]
        assert r["applied"] == [("q1", "worker_kill"), ("q2", "partition")]
        assert r["replies"] == [2.0 * (i + 1) for i in range(30)]
        assert r["ledger"]["delivered"] == 30 and r["ledger"]["shed"] == {}
        assert r["replayed"]
        assert r["states"][-1] == {"q0": "up", "q1": "down", "q2": "down"}


# -- the wire: each package's stock client against the other's router --------


@pytest.mark.parametrize("direction", ["jax_client_port_router", "port_client_jax_router"])
def test_stock_client_against_the_other_packages_router(direction):
    """The JAX package's ``tensor_query_client`` through the port's router
    (port workers), and the port's through the JAX package's router (JAX
    workers): the NNSQ wire is unchanged, the replies are the model's."""
    serve = PKGS["torch" if direction.startswith("jax") else "jax"]
    f = Fleet(serve, n=2, worker_kwargs=dict(model="x3"))
    xs = [np.full((2, 3), float(i + 1), np.float32) for i in range(6)]
    try:
        if direction.startswith("jax"):
            p = jnns.parse_launch(f"datasrc name=s ! tensor_query_client port={f.router.port} "
                                  "! tensor_sink name=out collect=true")
            p["s"].data = xs
        else:
            p = tnns.parse_launch(f"datasrc name=s ! tensor_query_client port={f.router.port} "
                                  "device=cpu ! tensor_sink name=out collect=true")
            p["s"].data = [tnns.buffer.Frame.of(x) for x in xs]
        p.run(timeout=60)
        got = [np.asarray(fr.tensor(0)) for fr in p["out"].frames]
    finally:
        f.close()
    assert len(got) == len(xs)
    for x, y in zip(xs, got):
        np.testing.assert_array_equal(y, x * 3.0)
    st = f.router.stats()
    assert st["offered"] == st["delivered"] and st["shed_total"] == 0


# -- the port's own surface: the serving scope and subprocess workers -------


def test_fragment_worker_scope_times_the_dispatch_on_the_request_trace(tmp_path, monkeypatch):
    """A worker serving slice 1's fragment (normalize, MobileNet-v2 0.35 at
    32x32 with the int8 head) with ``tracers="device;costmodel"``: the
    device lane's ``device_exec`` span joins the request's trace under the
    worker's ``nnsq_serve``, and ``stats()`` carries a non-empty cost model
    and its process's kernel launch counts."""
    from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
    from nnstreamer_tpu_torch.obs import costmodel, spans
    from nnstreamer_tpu_torch.ops.kernels import KERNELS
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("NNSTPU_OBS_COSTMODEL_AUTOSAVE", "false")
    ckpt = str(tmp_path / "m.npz")
    save_state(tm.init_tree(0, 10, 0.35), ckpt)
    frag = ("tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 "
            f"acceleration=pallas device=cpu ! tensor_filter framework=torch model={ckpt} "
            "custom=builder=mobilenet_v2:build_quantized,int8_head=1,num_classes=10,"
            "width_mult=0.35,image_size=32")
    spans.enable()
    w = tfleet.FleetWorker(name="frag", framework="fragment", model=frag, device="cpu",
                           tracers="device;costmodel").start()
    try:
        c = RawClient(PKGS["torch"], w.query_port)
        tid = spans.new_trace_id()
        x = np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        tquery.send_tensors(c.sock, (x,), 0, trace=(tid, 0))
        outs, _ = tquery.recv_tensors(c.sock)
        c.close()
        assert outs[0].shape[-1] == 10 and np.isfinite(outs[0]).all()

        def joined():
            recs = [r for r in spans.snapshot() if r[6] == tid and r[0] == spans.PH_COMPLETE]
            by = {r[4]: r for r in recs}
            return ("nnsq_serve" in by and "device_exec" in by
                    and by["device_exec"][8] == by["nnsq_serve"][7])

        assert _wait_for(joined)
        assert _wait_for(lambda: bool(w.stats().get("cost_model", {})
                                      .get("worker:frag", {}).get("stages")))
        st = w.stats()
        stages = st["cost_model"]["worker:frag"]["stages"]
        assert any("device_exec" in stage["legs"] for stage in stages.values()), stages
        assert set(st["kernels"]) == {k.__name__ for k in KERNELS} and st["device"] == "cpu"
    finally:
        w.stop()
        spans.disable()
        with costmodel._live_lock:
            costmodel._live.pop("worker:frag", None)


def test_warmup_failure_reaches_the_callback_and_keeps_warming(monkeypatch):
    """A failed capture-ahead calls ``on_warmup_error`` (the worker CLI exits
    there, so the spawn fails) and the worker never turns routable."""
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    def broken(self, spec):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(tquery.QueryServer, "warmup", broken)
    failed = threading.Event()
    w = tfleet.FleetWorker(name="bad", framework="custom", model="x2", device="cpu",
                           warmup_spec=TensorsSpec.of(TensorSpec(np.float32, (4,))),
                           on_warmup_error=lambda exc: failed.set()).start()
    try:
        assert failed.wait(WAIT_S)
        assert w.warmup_report["error"].startswith("RuntimeError")
        assert w.probe().startswith("warming")
    finally:
        w.stop()


def test_a_drain_while_warming_lets_the_capture_end_first(monkeypatch):
    """A scale-down drains a worker that is still capturing (a cancelled
    join): the drain waits out the warmup, inside its deadline, before the
    servers stop under it; the warmup ends clean."""
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    started, release = threading.Event(), threading.Event()
    real = tquery.QueryServer.warmup

    def slow(self, spec):
        started.set()
        release.wait(WAIT_S)
        return real(self, spec)

    monkeypatch.setattr(tquery.QueryServer, "warmup", slow)
    w = tfleet.FleetWorker(name="joining", framework="custom", model="x2", device="cpu",
                           warmup_spec=TensorsSpec.of(TensorSpec(np.float32, (4,))),
                           on_warmup_error=lambda exc: None).start()
    try:
        assert started.wait(WAIT_S)
        threading.Timer(0.2, release.set).start()
        assert w.drain(timeout=WAIT_S)
        assert not w._warmup_thread.is_alive()
        assert "error" not in w.warmup_report and "query" in w.warmup_report
        assert w.probe() == "draining"
    finally:
        release.set()
        w.stop()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def test_subprocess_worker_behind_the_port_router():
    """``python -m nnstreamer_tpu_torch.fleet worker --device cpu`` spawned
    by ``SubprocWorkerFactory``: membership probes its /healthz (incarnation
    nonce), the router serves through it, its /stats.json carries the kernel
    launch counts, and a drain exits 0."""
    m = tfleet.Membership(heartbeat_s=30.0)
    r = tfleet.Router(m, port=0).start()
    sup = tfleet.Supervisor(tfleet.SubprocWorkerFactory(["--model", "x3"], env=_env(),
                                                        device="cpu", line_timeout_s=120),
                            [tfleet.Surface(m, r)], name="sp", spawn_timeout_s=120)
    try:
        wid = sup.spawn_worker()
        assert wid is not None, sup.events.snapshot()

        def ready():
            m.sweep()
            sup.tick()
            return sup.ready_count() == 1

        assert _wait_for(ready, timeout=60, interval=0.05), sup.stats()
        handle = sup.get(wid).handle
        assert m.get(wid).incarnation == handle.nonce
        c = RawClient(PKGS["torch"], r.port)
        outs, _ = c.request((np.full((2, 2), 2.0, np.float32),))
        c.close()
        np.testing.assert_array_equal(outs[0], np.full((2, 2), 6.0, np.float32))
        with urllib.request.urlopen(f"http://{handle.ports['health_addr']}/stats.json",
                                    timeout=WAIT_S) as resp:
            st = json.loads(resp.read())[f"worker:{wid}"]
        assert st["device"] == "cpu" and st["kernels"]["fused_arith"] == 0
        assert sup.drain_worker(wid, blocking=True)
        assert handle.proc.returncode == 0
        assert sup.stats()["ledger_exact"]
    finally:
        sup.stop()
        r.stop()
        m.stop()


def test_subprocess_worker_without_a_gpu_fails_its_spawn():
    """No ``--device cpu`` and no GPU: the worker exits before its ports
    line, so the spawn fails typed."""
    f = tfleet.SubprocWorkerFactory(["--model", "x2"], env=_env(), line_timeout_s=120)
    with pytest.raises(SpawnError, match="no ports line"):
        f.spawn("nogpu")
