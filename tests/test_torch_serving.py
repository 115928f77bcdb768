"""The port's continuous-batching engine against the JAX package's.

``serving.py`` on the CPU (``device="cpu"``: the step runs eagerly; on the
card it is one CUDA graph): the counterparts of the JAX package's
``tests/test_serving.py`` (exactness, lifecycle, robustness, stop and
drain, prefill, W8A8; the TCP server and the sharded engine are not
ported) and of its engine-level snapshot tests (``tests/test_migration.py``),
plus the scrape gauges of ``register_engine``.

References: each stream's outputs are held to the JAX package's
single-stream ``decode_step`` loop on the same params within 1e-5 (absolute
and relative, as the JAX package holds its own engine), and to the JAX
engine run the same way; inside the port, a stream served among others is
bit for bit the same stream served alone in the same slot, since no
reduction crosses the slot axis.  Small size: t_max 16, d_in 8, n_out 4,
d_model 32, 4 heads, 2 layers.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.obs import export as jexport
from nnstreamer_tpu.obs.metrics import MetricsRegistry as JRegistry
from nnstreamer_tpu.ops import quant as jq
from nnstreamer_tpu.serving import ContinuousBatcher as JaxBatcher
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.obs import export as texport
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.serving import (_STOPPED, ContinuousBatcher, pack_session_snapshot,
                                          unpack_session_snapshot)

KW = dict(t_max=16, d_in=8, n_out=4, d_model=32, n_heads=4, n_layers=2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _tree(seed=0, d_in=KW["d_in"]):
    return jt.init_params(jax.random.PRNGKey(seed), KW["d_model"], KW["n_heads"],
                          KW["n_layers"], 4 * KW["d_model"], d_in, KW["n_out"])


TREE = jax.tree_util.tree_map(np.asarray, _tree(0))


def engine(capacity=2, tree=TREE, **over):
    return ContinuousBatcher(capacity=capacity, params=tree, device="cpu", **{**KW, **over})


def single_stream_outputs(tree, xs, window=False):
    """Reference: the JAX package's single-sequence decode_step loop."""
    cache = jt.init_decode_cache(KW["n_layers"], KW["d_model"], KW["t_max"])
    pos = jnp.zeros((1,), jnp.int32)
    step = jax.jit(lambda x, c, p: jt.decode_step(tree, x, c, p, window=window))
    outs = []
    for x in xs:
        y, cache, pos = step(jnp.asarray(x), cache, pos)
        outs.append(np.asarray(y))
    return outs


def stream_inputs(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(KW["d_in"]).astype(np.float32) for _ in range(n)]


def assert_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def alone(xs, slot, capacity, prompt=None, tree=TREE, **over):
    """One stream served alone through a port engine, in ``slot`` (the
    slots below it held by idle sessions)."""
    with engine(capacity, tree, **over) as eng:
        [eng.open_session() for _ in range(slot)]
        s = eng.open_session()
        assert s.slot == slot
        out = []
        if prompt is not None:
            s.prefill(prompt)
            out.append(s.get(timeout=30))
        for x in xs:
            s.feed(x)
            out.append(s.get(timeout=30))
    return out


class TestExactness:
    def test_staggered_joins_match_single_stream(self):
        lengths = {0: 6, 1: 4, 2: 5}
        streams = {k: stream_inputs(k, n) for k, n in lengths.items()}
        got = {k: [] for k in streams}
        slots = {}
        with engine(3) as eng:
            s0 = eng.open_session()
            for x in streams[0][:2]:      # stream 0 runs alone first
                s0.feed(x)
                got[0].append(s0.get(timeout=30))
            s1 = eng.open_session()       # stream 1 joins mid-flight
            for i in range(4):
                if 2 + i < lengths[0]:
                    s0.feed(streams[0][2 + i])
                s1.feed(streams[1][i])
                if 2 + i < lengths[0]:
                    got[0].append(s0.get(timeout=30))
                got[1].append(s1.get(timeout=30))
            s2 = eng.open_session()       # stream 2 joins after 1 finished
            s1.close()
            for x in streams[2]:
                s2.feed(x)
                got[2].append(s2.get(timeout=30))
            slots = {0: s0.slot, 1: s1.slot, 2: s2.slot}
            s0.close(), s2.close()
        for k, xs in streams.items():
            assert_close(got[k], single_stream_outputs(TREE, xs))
            for a, b in zip(got[k], alone(xs, slots[k], 3)):
                np.testing.assert_array_equal(a, b)

    def test_matches_the_jax_engine(self):
        """Two streams interleaved through both engines on the same params."""
        xs = {k: stream_inputs(200 + k, 5) for k in range(2)}
        outs = []
        for make in (lambda: engine(2), lambda: JaxBatcher(capacity=2, params=_tree(0), **KW)):
            got = {k: [] for k in xs}
            with make() as eng:
                ss = [eng.open_session() for _ in xs]
                for i in range(5):
                    for k, s in enumerate(ss):
                        s.feed(xs[k][i])
                    for k, s in enumerate(ss):
                        got[k].append(s.get(timeout=60))
            outs.append(got)
        for k in xs:
            assert_close(outs[0][k], outs[1][k])

    def test_starved_slot_state_is_untouched(self):
        with engine(2) as eng:
            a, b = eng.open_session(), eng.open_session()
            xb = stream_inputs(11, 2)
            b.feed(xb[0])
            got_b = [b.get(timeout=30)]
            for x in stream_inputs(10, 5):  # b starves while a streams
                a.feed(x)
                a.get(timeout=30)
            b.feed(xb[1])
            got_b.append(b.get(timeout=30))
        assert_close(got_b, single_stream_outputs(TREE, xb))
        for g, w in zip(got_b, alone(xb, 1, 2)):
            np.testing.assert_array_equal(g, w)

    def test_slot_reuse_has_no_state_leak(self):
        with engine(1) as eng:
            first = eng.open_session()
            for x in stream_inputs(20, 7):
                first.feed(x)
                first.get(timeout=30)
            first.close()
            second = eng.open_session()   # same slot, fresh stream
            xs = stream_inputs(21, 4)
            got = []
            for x in xs:
                second.feed(x)
                got.append(second.get(timeout=30))
        assert_close(got, single_stream_outputs(TREE, xs))

    def test_ring_window_streams_past_t_max(self):
        xs = stream_inputs(30, KW["t_max"] + 5)
        with engine(1, window=True) as eng:
            s = eng.open_session()
            got = []
            for x in xs:
                s.feed(x)
                got.append(s.get(timeout=30))
        assert all(np.isfinite(g).all() for g in got)
        assert_close(got, single_stream_outputs(TREE, xs, window=True))

    def test_plain_cache_saturates_to_nan_past_t_max(self):
        xs = stream_inputs(31, KW["t_max"] + 2)
        with engine(1) as eng:
            s = eng.open_session()
            got = []
            for x in xs:
                s.feed(x)
                got.append(s.get(timeout=30))
        assert all(np.isfinite(g).all() for g in got[:KW["t_max"]])
        assert all(np.isnan(g).all() for g in got[KW["t_max"]:])

    def test_shares_params_with_the_cell_builder(self):
        """One tree serves the repo-slot cell and the engine; the engine also
        takes the cell's own (port) params."""
        cell = tt.build_decode_cell(params=_tree(7), device="cpu", **KW)
        xs = stream_inputs(32, 3)
        with engine(2, tree=cell.params) as eng:
            s = eng.open_session()
            got = [s.get(timeout=30) for x in xs if s.feed(x) is None]
        assert_close(got, single_stream_outputs(_tree(7), xs))
        cache = torch.zeros(KW["n_layers"], 2, KW["t_max"], KW["d_model"])
        pos = torch.zeros(1, dtype=torch.int32)
        for g, x in zip(got, xs):
            y, cache, pos = cell(torch.from_numpy(x), cache, pos)
            np.testing.assert_allclose(g, y.numpy(), **TOL)


class TestLifecycle:
    def test_capacity_blocks_then_frees(self):
        with engine(1) as eng:
            a = eng.open_session()
            with pytest.raises(TimeoutError, match="capacity 1"):
                eng.open_session(timeout=0.05)
            a.close()
            b = eng.open_session(timeout=5)
            assert b.slot == a.slot

    def test_feed_validation(self):
        with engine(1) as eng:
            s = eng.open_session()
            with pytest.raises(ValueError, match="feed expects shape"):
                s.feed(np.zeros(3, np.float32))
            s.close()
            with pytest.raises(RuntimeError, match="closed"):
                s.feed(np.zeros(KW["d_in"], np.float32))

    def test_stop_unblocks_waiters(self):
        eng = engine(1)
        eng.open_session()
        err = {}

        def waiter():
            try:
                eng.open_session(timeout=10)
            except Exception as exc:  # noqa: BLE001
                err["e"] = exc

        t = threading.Thread(target=waiter)
        t.start()
        eng.stop()
        t.join(timeout=10)
        assert isinstance(err.get("e"), RuntimeError)

    def test_tick_batching_counters(self):
        with engine(4) as eng:
            sessions = [eng.open_session() for _ in range(4)]
            n = 5
            for k, s in enumerate(sessions):
                for x in stream_inputs(40 + k, n):
                    s.feed(x)
            for s in sessions:
                for _ in range(n):
                    s.get(timeout=30)
            assert eng.steps_total == 4 * n
            assert eng.ticks <= eng.steps_total

    def test_mesh_and_device_refusals(self, monkeypatch):
        with pytest.raises(NotImplementedError, match="item 13b"):
            ContinuousBatcher(capacity=4, devices=2, device="cpu", **KW)
        engine(1, devices=1).stop()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            ContinuousBatcher(capacity=1, **KW)


class TestRobustness:
    def test_feed_copies_the_callers_buffer(self):
        with engine(1) as eng:
            s = eng.open_session()
            buf = np.zeros(KW["d_in"], np.float32)
            vals = []
            for i in range(4):
                buf[:] = float(i + 1)
                vals.append(buf.copy())
                s.feed(buf)          # same buffer object every time
            got = [s.get(timeout=30) for _ in range(4)]
        assert_close(got, single_stream_outputs(TREE, vals))

    def test_engine_failure_surfaces_to_clients(self):
        eng = engine(1)
        try:
            s = eng.open_session()

            def boom(*a, **k):
                raise RuntimeError("step exploded")

            eng._step = boom
            s.feed(np.zeros(KW["d_in"], np.float32))
            with pytest.raises(RuntimeError, match="step exploded"):
                s.get(timeout=30)
            with pytest.raises(RuntimeError, match="engine stopped"):
                s.feed(np.zeros(KW["d_in"], np.float32))
        finally:
            eng.stop()

    def test_stop_wakes_a_blocked_get(self):
        eng = engine(1)
        s = eng.open_session()
        err = {}

        def waiter():
            try:
                s.get(timeout=60)
            except Exception as exc:  # noqa: BLE001
                err["e"] = exc

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.2)
        eng.stop()
        t.join(timeout=10)
        assert isinstance(err.get("e"), RuntimeError)

    def test_mismatched_checkpoint_rejected_at_build(self):
        with pytest.raises(ValueError, match="params expect d_in"):
            engine(1, tree=jax.tree_util.tree_map(np.asarray, _tree(0, d_in=KW["d_in"] // 2)))


class TestStopDrain:
    def test_gets_after_stop_raise_and_queued_outputs_drain(self):
        eng = engine(1)
        s = eng.open_session()
        xs = stream_inputs(70, 3)
        for x in xs:
            s.feed(x)
        got = [s.get(timeout=30) for _ in range(3)]
        eng.stop()
        for _ in range(3):
            with pytest.raises(RuntimeError, match="engine stopped"):
                s.get(timeout=5)
        assert_close(got, single_stream_outputs(TREE, xs))

    def test_output_delivered_behind_sentinel_is_not_lost(self):
        eng = engine(1)
        s = eng.open_session()
        eng.stop()
        rescued = np.full((KW["n_out"],), 7.0, np.float32)
        s._q_out.put(rescued)
        np.testing.assert_array_equal(s.get(timeout=10), rescued)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="engine stopped"):
                s.get(timeout=5)
        assert s._q_out.qsize() == 1
        assert s._q_out.get_nowait() is _STOPPED


class TestPrefill:
    def test_prefill_then_decode_matches_all_stepwise(self):
        xs = stream_inputs(90, 9)
        with engine(2) as eng:
            s = eng.open_session()
            s.prefill(np.stack(xs[:5]))
            got = [s.get(timeout=30)]
            for x in xs[5:]:
                s.feed(x)
                got.append(s.get(timeout=30))
            assert eng.prefill_tokens == 5
        want = single_stream_outputs(TREE, xs)
        assert_close(got, want[4:])

    def test_prompt_lengths_bucket_and_stay_exact(self):
        with engine(2) as eng:
            for n in (3, 5, 8):
                xs = stream_inputs(91 + n, n)
                s = eng.open_session()
                s.prefill(np.stack(xs))
                got = s.get(timeout=30)
                s.close()
                np.testing.assert_allclose(got, single_stream_outputs(TREE, xs)[-1], **TOL)
            assert sorted(eng._prefill_fns) == [4, 8]

    def test_midstream_prefill_restarts_the_context(self):
        with engine(1) as eng:
            s = eng.open_session()
            for x in stream_inputs(95, 6):
                s.feed(x)
                s.get(timeout=30)
            fresh = stream_inputs(96, 4)
            s.prefill(np.stack(fresh[:2]))
            got = [s.get(timeout=30)]
            for x in fresh[2:]:
                s.feed(x)
                got.append(s.get(timeout=30))
        assert_close(got, single_stream_outputs(TREE, fresh)[1:])

    def test_prefill_validation(self):
        with engine(1) as eng:
            s = eng.open_session()
            with pytest.raises(ValueError, match="prefill expects"):
                s.prefill(np.zeros((3, KW["d_in"] + 1), np.float32))
            with pytest.raises(ValueError, match="exceeds cache t_max"):
                s.prefill(np.zeros((KW["t_max"] + 1, KW["d_in"]), np.float32))

    def test_counters_consistent_across_prefill_and_steps(self):
        with engine(2) as eng:
            a, b = eng.open_session(), eng.open_session()
            a.prefill(np.stack(stream_inputs(99, 3)))
            a.get(timeout=30)
            for x in stream_inputs(100, 2):
                for s in (a, b):
                    s.feed(x)
                for s in (a, b):
                    s.get(timeout=30)
            assert eng.steps_total == a.steps + b.steps == 5
            assert eng.prefill_tokens == 3

    def test_prefill_composes_with_ring_window_streaming(self):
        n_prompt, n_more = 5, KW["t_max"] + 3
        xs = stream_inputs(110, n_prompt + n_more)
        with engine(1, window=True) as eng:
            s = eng.open_session()
            s.prefill(np.stack(xs[:n_prompt]))
            got = [s.get(timeout=30)]
            for x in xs[n_prompt:]:
                s.feed(x)
                got.append(s.get(timeout=30))
        assert all(np.isfinite(g).all() for g in got)
        assert_close(got, single_stream_outputs(TREE, xs, window=True)[n_prompt - 1:])

    def test_warmup_prefill_makes_every_bucket(self):
        with engine(1) as eng:
            report = eng.warmup_prefill()
            assert sorted(eng._prefill_fns) == [1, 2, 4, 8, 16]
            assert [c["label"] for c in report["compiled"]] == [
                "prefill_t1", "prefill_t2", "prefill_t4", "prefill_t8", "prefill_t16"]


class TestQuantizedServing:
    def test_engine_serves_w8a8_cell(self):
        """The reference's quantized tree served unchanged: the geometry is
        read from the int8 leaves; outputs within 1e-4 of the JAX
        single-stream loop, as the JAX package holds its own engine."""
        qtree = jq.quantize_params(_tree(12))
        xs = stream_inputs(120, 5)
        with engine(2, tree=jax.tree_util.tree_map(np.asarray, qtree)) as eng:
            assert isinstance(eng.params["embed"]["w"], tt.QuantizedWeight)
            s = eng.open_session()
            got = []
            for x in xs:
                s.feed(x)
                got.append(s.get(timeout=60))
        for g, w in zip(got, single_stream_outputs(qtree, xs)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_engine_stats_snapshot():
    with engine(2) as eng:
        st0 = eng.stats()
        assert st0["capacity"] == 2 and st0["free_slots"] == 2
        assert st0["active_sessions"] == 0 and st0["running"]
        s = eng.open_session()
        s.prefill(np.stack(stream_inputs(130, 3)))
        s.get(timeout=30)
        s.feed(stream_inputs(131, 1)[0])
        s.get(timeout=30)
        st = eng.stats()
        assert st["active_sessions"] == 1 and st["free_slots"] == 1
        assert st["steps_total"] == 2 and st["prefill_tokens"] == 3
        assert st["ticks"] == 2 and st["coalescing"] == 1.0
        assert st["slots"][s.slot] == {"occupied": True, "pos": 4, "steps": 2, "gated": False}
    assert eng.stats()["running"] is False


def test_stats_counters_never_torn_under_concurrent_reads():
    torn = []
    stop = threading.Event()
    with engine(2) as eng:

        def hammer():
            while not stop.is_set():
                st = eng.stats()
                if st["ticks"] != st["steps_total"]:
                    torn.append((st["ticks"], st["steps_total"]))

        readers = [threading.Thread(target=hammer) for _ in range(2)]
        for r in readers:
            r.start()
        with eng.open_session() as sess:
            sess.prefill(np.stack(stream_inputs(7, 4)))
            sess.get(timeout=30)
            for x in stream_inputs(8, 40):
                sess.feed(x)
                sess.get(timeout=30)
        stop.set()
        for r in readers:
            r.join(timeout=30)
        assert not torn, f"torn ticks/steps_total snapshots: {torn[:5]}"
        st = eng.stats()
        assert st["ticks"] == st["steps_total"] == 41


def test_register_engine_gauges_match_the_reference():
    """The same session history on both engines: the ``nnstpu_serving_*``
    lines of the two expositions are equal."""
    def drive(eng):
        s = eng.open_session()
        s.prefill(np.stack(stream_inputs(140, 3)))
        s.get(timeout=60)
        s.feed(stream_inputs(141, 1)[0])
        s.get(timeout=60)

    lines = []
    for make, registry, render in (
            (lambda: engine(2), MetricsRegistry(), texport.render_text),
            (lambda: JaxBatcher(capacity=2, params=_tree(0), **KW), JRegistry(),
             jexport.render_text)):
        with make() as eng:
            drive(eng)
            handle = eng.publish_metrics(registry=registry)
            text = render(registry)
            registry.remove_collector(handle)
        lines.append(sorted(ln for ln in text.splitlines() if "nnstpu_serving_" in ln))
    assert lines[0] == lines[1]
    assert "nnstpu_serving_ticks 2" in lines[0]
    assert "nnstpu_serving_prefill_tokens 3" in lines[0]


# -- checkpoint and restore (the engine level of the migration tests) -----------------

SNAP_KW = dict(t_max=8, d_in=4, n_out=4, d_model=16, n_heads=2, n_layers=1)
SNAP_TREE = jax.tree_util.tree_map(np.asarray, jt.init_params(
    jax.random.PRNGKey(0), 16, 2, 1, 64, 4, 4))


def snap_engine():
    return ContinuousBatcher(capacity=2, params=SNAP_TREE, device="cpu", **SNAP_KW)


def _prompt(seed=0, t=3):
    return np.random.RandomState(seed).rand(t, 4).astype(np.float32)


def _snap_steps(n, base=10):
    return [np.random.RandomState(base + i).rand(4).astype(np.float32) for i in range(n)]


def _control_run(prompt, steps):
    with snap_engine() as eng:
        sess = eng.open_session()
        sess.prefill(prompt)
        out = [sess.get(timeout=10)]
        for s in steps:
            sess.feed(s)
            out.append(sess.get(timeout=10))
    return out


@pytest.fixture(scope="module")
def engines():
    a, b = snap_engine(), snap_engine()
    yield a, b
    a.stop()
    b.stop()


class TestSnapshotRestore:
    def test_token_identical_across_engines(self, engines):
        a, b = engines
        prompt, steps = _prompt(), _snap_steps(6)
        ctl = _control_run(prompt, steps)
        sa = a.open_session()
        sa.prefill(prompt)
        out = [sa.get(timeout=10)]
        for s in steps[:3]:
            sa.feed(s)
            out.append(sa.get(timeout=10))
        snap = sa.snapshot()
        sa.close()
        sb = b.restore_session(unpack_session_snapshot(pack_session_snapshot(snap)))
        for s in steps[3:]:
            sb.feed(s)
            out.append(sb.get(timeout=10))
        sb.close()
        for i, (x, y) in enumerate(zip(ctl, out)):
            np.testing.assert_array_equal(x, y, err_msg=f"output {i}")
        assert a.stats()["sessions_migrated_out"] >= 1
        assert b.stats()["sessions_migrated_in"] >= 1

    def test_snapshot_mid_prefill_restores_position_t(self, engines):
        a, b = engines
        prompt, steps = _prompt(seed=3), _snap_steps(2, base=40)
        ctl = _control_run(prompt, steps)
        sa = a.open_session()
        sa.prefill(prompt)
        out = [sa.get(timeout=10)]
        snap = sa.snapshot()
        assert snap["pos"] == prompt.shape[0]
        sa.close()
        sb = b.restore_session(snap)
        assert sb.pos == prompt.shape[0]
        for s in steps:
            sb.feed(s)
            out.append(sb.get(timeout=10))
        sb.close()
        for x, y in zip(ctl, out):
            np.testing.assert_array_equal(x, y)
        sa = a.open_session()
        sa._gated = True  # a pending prefill travels in the snapshot's queue
        sa.prefill(prompt)
        snap2 = a.snapshot_session(sa)
        assert len(snap2["pending_in"]) == 1 and snap2["pending_in"][0][0] == "prefill"
        sa.close()
        sb = b.restore_session(unpack_session_snapshot(pack_session_snapshot(snap2)))
        got = [sb.get(timeout=10)]
        for s in steps:
            sb.feed(s)
            got.append(sb.get(timeout=10))
        sb.close()
        for x, y in zip(ctl, got):
            np.testing.assert_array_equal(x, y)

    def test_pending_outputs_redeliver_in_order(self, engines):
        a, b = engines
        prompt, steps = _prompt(seed=5), _snap_steps(3, base=60)
        ctl = _control_run(prompt, steps)
        sa = a.open_session()
        sa.prefill(prompt)
        sa.feed(steps[0])
        deadline = time.monotonic() + 10
        while sa._q_out.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = sa.snapshot()
        assert len(snap["pending_out"]) == 2
        sa.close()
        sb = b.restore_session(unpack_session_snapshot(pack_session_snapshot(snap)))
        got = [sb.get(timeout=10), sb.get(timeout=10)]
        for s in steps[1:]:
            sb.feed(s)
            got.append(sb.get(timeout=10))
        sb.close()
        for x, y in zip(ctl, got):
            np.testing.assert_array_equal(x, y)

    def test_abort_snapshot_rearms_in_place(self, engines):
        a, _ = engines
        prompt, steps = _prompt(seed=7), _snap_steps(2, base=80)
        ctl = _control_run(prompt, steps)
        sa = a.open_session()
        sa.prefill(prompt)
        out = [sa.get(timeout=10)]
        sa.feed(steps[0])
        snap = a.snapshot_session(sa)
        assert sa._gated
        a.abort_snapshot(sa, snap)
        assert not sa._gated
        out.append(sa.get(timeout=10))
        sa.feed(steps[1])
        out.append(sa.get(timeout=10))
        sa.close()
        for x, y in zip(ctl, out):
            np.testing.assert_array_equal(x, y)

    def test_geometry_mismatch_refused(self, engines):
        a, _ = engines
        sa = a.open_session()
        snap = sa.snapshot()
        sa.close()
        for key, val in (("d_in", 8), ("t_max", 16), ("window", True)):
            with pytest.raises(ValueError, match="geometry mismatch"):
                a.restore_session({**snap, key: val})
        with pytest.raises(ValueError, match="geometry mismatch"):
            a.restore_session({**snap, "cache": np.zeros((2, 2, 8, 16), np.float32)})
        s1, s2 = a.open_session(timeout=1), a.open_session(timeout=1)
        s1.close()
        s2.close()

    def test_snapshot_restores_on_the_jax_engine(self, engines):
        """The snapshot format is the reference's: a port snapshot, packed,
        continues on the JAX engine (within 1e-5) and back."""
        a, _ = engines
        prompt, steps = _prompt(seed=9), _snap_steps(4, base=90)
        ctl = _control_run(prompt, steps)
        sa = a.open_session()
        sa.prefill(prompt)
        out = [sa.get(timeout=10)]
        sa.feed(steps[0])
        out.append(sa.get(timeout=10))
        packed = pack_session_snapshot(sa.snapshot())
        sa.close()
        from nnstreamer_tpu.serving import pack_session_snapshot as jpack
        from nnstreamer_tpu.serving import unpack_session_snapshot as junpack

        jtree = jt.init_params(jax.random.PRNGKey(0), 16, 2, 1, 64, 4, 4)
        with JaxBatcher(capacity=2, params=jtree, **SNAP_KW) as j:
            sj = j.restore_session(junpack(packed))
            for s in steps[1:3]:
                sj.feed(s)
                out.append(sj.get(timeout=60))
            back = jpack(sj.snapshot())
        sb = a.restore_session(unpack_session_snapshot(back))
        sb.feed(steps[3])
        out.append(sb.get(timeout=10))
        sb.close()
        for x, y in zip(ctl, out):
            np.testing.assert_allclose(x, y, **TOL)

    def test_pack_unpack_validation(self, engines):
        a, _ = engines
        sa = a.open_session()
        snap = sa.snapshot()
        sa.close()
        packed = pack_session_snapshot(snap)
        rt = unpack_session_snapshot(packed)
        assert rt["pos"] == snap["pos"] and rt["t_max"] == snap["t_max"]
        np.testing.assert_array_equal(rt["cache"], snap["cache"])
        with pytest.raises(ValueError):
            unpack_session_snapshot(packed[:2])
        with pytest.raises(ValueError):
            unpack_session_snapshot((np.array([99], np.int64),) + packed[1:])
        with pytest.raises(RuntimeError, match="pending"):
            pack_session_snapshot({**snap, "pending_in": [np.zeros(4, np.float32)] * 13})
